"""Pin ShardedStructuredModel.step_stats to the IMPLEMENTATION.

step_stats feeds the deterministic structural scaling artifact
(tools/scaling.py) used as a regression sentinel and for the superstep
breakeven-latency attribution — so its collective counts must describe the
code, not a model of it. These tests count the ppermute primitives actually traced
into the per-step scan body for every (nonlinear, fb, tracers) slab
configuration and assert 2 * collective_pairs_per_step matches (each
halo exchange pair is one ppermute per direction, _with_halo).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpas_ocean.mesh import planar_hex_mesh
from mpas_ocean.mesh.mesh import Mesh
from mpas_ocean.mesh.vert_mesh import make_vertical_mesh
from mpas_ocean.models.shallow_water import PrognosticVars
from mpas_ocean.structured import StructuredModel
from mpas_ocean.structured.sharded import ShardedStructuredModel

NX = NY = 16
K = 2


@pytest.fixture(scope="module")
def setup():
    horz = planar_hex_mesh(NX, NY, 1000.0, f0=1e-4)
    vert = make_vertical_mesh(
        horz, n_vert_levels=K,
        resting_thickness=np.full((horz.n_cells, K), 10.0),
    )
    mesh = Mesh(horz=horz, vert=vert).to_device()
    sm = StructuredModel(mesh, NX, NY)
    prog = PrognosticVars(
        ssh=jnp.zeros(horz.n_cells),
        layer_thickness=jnp.full((horz.n_cells, K), 10.0),
        normal_velocity=jnp.zeros((horz.n_edges, K)),
    )
    # overlap=False -> the serial body, whose collective count equals the
    # overlap body's (same exchanges, different schedule)
    ssm = ShardedStructuredModel(
        sm.struct_mesh, devices=jax.devices()[:4], overlap=False
    )
    return sm, ssm, sm.to_struct(prog)


def _iter_sub(v):
    if hasattr(v, "jaxpr") and hasattr(v.jaxpr, "eqns"):
        yield v.jaxpr
    elif hasattr(v, "eqns"):
        yield v
    elif isinstance(v, (list, tuple)):
        for vv in v:
            yield from _iter_sub(vv)
    elif isinstance(v, dict):
        for vv in v.values():
            yield from _iter_sub(vv)


def _find_eqn(jaxpr, name):
    for eq in jaxpr.eqns:
        if eq.primitive.name == name:
            return eq
        for v in eq.params.values():
            for sub in _iter_sub(v):
                r = _find_eqn(sub, name)
                if r is not None:
                    return r
    return None


def _count_ppermute(jaxpr):
    n = 0
    stack = [jaxpr]
    while stack:
        j = stack.pop()
        for eq in j.eqns:
            if "ppermute" in eq.primitive.name:
                n += 1
            for v in eq.params.values():
                stack.extend(_iter_sub(v))
    return n


def _scan_body_ppermutes(ssm, local, dt, nonlinear, fb, n_steps=3, q=None):
    args = ssm._run_prep(local, nonlinear, None, None)

    def f(loc):
        return ssm._run_jit.__wrapped__(
            ssm, loc, *args, dt, n_steps, nonlinear, 0.0, 1.0, False, fb, q
        )

    closed = jax.make_jaxpr(f)(local)
    sm_eq = _find_eqn(closed.jaxpr, "shard_map")
    assert sm_eq is not None
    body = next(s for v in sm_eq.params.values() for s in _iter_sub(v))
    scan_eq = _find_eqn(body, "scan")
    assert scan_eq is not None
    scan_body = next(s for v in scan_eq.params.values() for s in _iter_sub(v))
    return _count_ppermute(scan_body)


@pytest.mark.parametrize("nonlinear,fb", [
    (False, False), (True, False), (False, True), (True, True),
])
def test_step_stats_pairs_match_traced_body(setup, nonlinear, fb):
    sm, ssm, st = setup
    local = ssm.scatter(st)
    traced = _scan_body_ppermutes(ssm, local, 10.0, nonlinear, fb)
    stats = ssm.step_stats(K, nonlinear=nonlinear, fb=fb)
    assert traced == 2 * stats["collective_pairs_per_step"], (
        f"step_stats says {stats['collective_pairs_per_step']} pairs/step "
        f"but the scan body traces {traced} ppermutes "
        f"({traced / 2} pairs) for nonlinear={nonlinear} fb={fb}"
    )


def test_fb_single_exchange_per_field(setup):
    """The fb slab body must exchange each field ONCE per step (2-padded
    carry); a regression to exchange-at-entry + exchange-at-exit doubles
    the count this pins."""
    sm, ssm, st = setup
    local = ssm.scatter(st)
    n_fields = 3
    traced = _scan_body_ppermutes(ssm, local, 10.0, False, True)
    assert traced == 2 * n_fields


@pytest.mark.parametrize("nonlinear,fb,q", [
    (False, False, 4), (True, False, 2), (False, True, 2), (True, True, 1),
])
def test_superstep_stats_match_traced_body(setup, nonlinear, fb, q):
    """The superstep body exchanges each field ONCE per q steps (reach*q
    halo rows in one ppermute pair per field) — step_stats(path=
    'superstep') must say n_fields/q pairs per step, and its redundant
    compute must be the shrinking window's reach*(q-1)/rows."""
    from mpas_ocean.structured.sharded import _reach

    sm, _, st = setup
    ssm = ShardedStructuredModel(sm.struct_mesh, devices=jax.devices()[:2])
    local = ssm.scatter(st)
    traced = _scan_body_ppermutes(ssm, local, 10.0, nonlinear, fb,
                                  n_steps=4, q=q)
    stats = ssm.step_stats(K, path="superstep", q=q, nonlinear=nonlinear,
                           fb=fb)
    assert traced == 2 * stats["collective_pairs_per_step"] * q
    assert stats["halo_rows"] == _reach(nonlinear, fb) * q
    assert stats["redundant_compute_frac"] == (
        _reach(nonlinear, fb) * (q - 1) / ssm.rows
    )

