"""Whole-rollout gradients of the lattice model (structured_rollout_diff).

The sqrt-checkpointed roll rollout must give the same gradients as plain
``jax.grad`` through the un-checkpointed roll scan (structured_run_loop)
AND as ``jax.grad`` through the general-mesh gather loop (ocn_run_loop),
for every subsystem the lattice runs: linear and nonlinear dynamics,
periodic and wall-masked lattices, wind/drag forcing, tracers and layered
stratification. The reference validates this reverse with Enzyme
(reference: test/enzyme/test_Enzyme_end2end.jl:78-92).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpas_ocean.forward.run_loop import ocn_run_loop
from mpas_ocean.mesh import planar_hex_mesh
from mpas_ocean.mesh.cull import cull_cells
from mpas_ocean.mesh.mesh import Mesh
from mpas_ocean.mesh.vert_mesh import make_vertical_mesh
from mpas_ocean.models.forcing import make_forcing
from mpas_ocean.models.shallow_water import PrognosticVars, update_ssh
from mpas_ocean.models.stratification import make_stratification
from mpas_ocean.models.tracers import make_tracers
from mpas_ocean.structured import StructuredModel, structured_rollout_diff
from mpas_ocean.structured.model import structured_run_loop

NX = NY = 8
K = 2
N_STEPS = 5  # sqrt chunking: b=2, a=2, rem=1
DT = 5.0

CONFIGS = [
    "linear", "linear_channel", "nonlinear", "nonlinear_channel",
    "tracers", "tracers_channel", "strat", "forced", "forced_channel",
    "forced_nonlinear",
]


def _case(config):
    """(mesh, StructuredModel, prog, kwargs) for one subsystem config; the
    kwargs use the unstructured layout (forcing) and are converted per
    path."""
    dc = 1000.0
    parent = planar_hex_mesh(NX, NY, dc, f0=1e-4, beta=1e-11)
    keep = None
    horz = parent
    if config.endswith("_channel"):
        y = np.asarray(parent.cells.y)
        keep = (y > 0.5 * dc) & (y < y.max() - 0.5 * dc)
        horz = cull_cells(parent, keep)
    depth = 100.0 if "nonlinear" in config else 10.0
    vert = make_vertical_mesh(
        horz, n_vert_levels=K,
        resting_thickness=np.full((horz.n_cells, K), depth),
    )
    mesh = Mesh(horz=horz, vert=vert).to_device()
    sm = (StructuredModel(mesh, NX, NY) if keep is None else
          StructuredModel(mesh, NX, NY, parent_horz=parent, keep_cells=keep))
    rng = np.random.default_rng(3)
    h = depth + 0.01 * rng.normal(size=(horz.n_cells, K))
    u = 0.01 * rng.normal(size=(horz.n_edges, K))
    u *= np.asarray(horz.edges.edge_mask)[:, None]
    prog = PrognosticVars(
        ssh=update_ssh(jnp.asarray(h), mesh),
        layer_thickness=jnp.asarray(h),
        normal_velocity=jnp.asarray(u),
    )
    kw = {}
    if "nonlinear" in config:
        kw["nonlinear"] = True
    if config.startswith("tracers"):
        x = np.asarray(horz.cells.x)
        prog = prog.replace(tracers=make_tracers(
            mesh, [10.0 + np.sin(2 * np.pi * x / (x.max() + dc)),
                   np.full(horz.n_cells, 35.0)]))
        kw["tracer_kappa"] = 5.0
    if config == "strat":
        kw["strat"] = make_stratification(1025.0 + np.linspace(0.0, 1.0, K))
    if config.startswith("forced"):
        kw["forcing"] = make_forcing(
            mesh, wind_stress_zonal=0.1, bottom_drag_linear=1e-4,
            bottom_drag_quadratic=1e-3, rayleigh=1e-5,
        )
    return mesh, sm, prog, kw


def _objective(out):
    j = jnp.sum(out.ssh ** 2) + jnp.sum(out.normal_velocity ** 2)
    if out.tracers is not None:
        j = j + jnp.sum(out.tracers ** 2)
    return j


def _struct_kw(sm, kw):
    kw = dict(kw)
    if "forcing" in kw:
        kw["forcing"] = sm.to_struct_forcing(kw["forcing"])
    return kw


def _diff_grads(sm, st, kw, dt):
    smesh = sm.struct_mesh

    def obj(s, t):
        return _objective(structured_rollout_diff(
            s, smesh, t, N_STEPS, kw.get("nonlinear", False),
            kw.get("tracer_kappa", 0.0), kw.get("tracer_upwind", 1.0),
            kw.get("strat"), kw.get("forcing"),
        ))

    return jax.value_and_grad(obj, argnums=(0, 1))(st, dt)


def _assert_tree_close(a, b, rtol=1e-9, atol=1e-12):
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("config", CONFIGS)
def test_rollout_diff_all_subsystems(config):
    """Checkpointed reverse == plain jax.grad through the roll scan, for
    the state AND dt (the objective values agree bitwise: same forward)."""
    _, sm, prog, kw = _case(config)
    st = sm.to_struct(prog)
    skw = _struct_kw(sm, kw)
    dt = jnp.asarray(DT)
    (j, (g_s, g_dt)) = _diff_grads(sm, st, skw, dt)

    def obj_roll(s, t):
        return _objective(structured_run_loop(s, sm.struct_mesh, t,
                                              N_STEPS, **skw))

    (jr, (r_s, r_dt)) = jax.value_and_grad(obj_roll, argnums=(0, 1))(st, dt)
    np.testing.assert_allclose(float(j), float(jr), rtol=1e-13)
    _assert_tree_close(g_s, r_s)
    np.testing.assert_allclose(float(g_dt), float(r_dt), rtol=1e-9)


@pytest.mark.parametrize("config", CONFIGS)
def test_rollout_diff_matches_gather_grad(config):
    """The lattice reverse, mapped back to mesh order, equals jax.grad of
    the general-mesh gather rollout (an independent formulation of the
    same physics) at f64 roundoff."""
    mesh, sm, prog, kw = _case(config)
    st = sm.to_struct(prog)
    _, (g_s, _) = _diff_grads(sm, st, _struct_kw(sm, kw), jnp.asarray(DT))

    def obj_gather(p):
        return _objective(ocn_run_loop(p, mesh, DT, N_STEPS, **kw))

    g_ref = jax.grad(obj_gather)(prog)
    # the lattice<->mesh maps are signed permutations (zero-embedding on
    # culled lattices), so from_struct is the transpose of to_struct
    g = sm.from_struct(g_s)
    # wall edges hold u = 0 by contract (to_struct pins them), so their
    # sensitivities are compared on free edges only
    live = np.asarray(mesh.edges.edge_mask)[:, None]
    for name in ("ssh", "layer_thickness", "normal_velocity", "tracers"):
        a, b = getattr(g, name), getattr(g_ref, name)
        if b is None:
            continue
        a, b = np.asarray(a), np.asarray(b)
        if name == "normal_velocity":
            a, b = a * live, b * live
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-10 * max(1.0, np.abs(b).max()))


@pytest.mark.parametrize("jit", [True, False])
def test_jitted_forced_gradient(jit):
    """grad w.r.t. state, dt AND forcing — under jit (the production calling
    convention: an optimization loop jits its update step, so the forcing
    arrives traced) and eagerly; both match the roll scan's gradient."""
    _, sm, prog, kw = _case("forced_channel")
    st = sm.to_struct(prog)
    f = sm.to_struct_forcing(kw["forcing"])
    smesh = sm.struct_mesh

    def obj_diff(s, t, fo):
        out = structured_rollout_diff(s, smesh, t, N_STEPS, False, 0.0, 1.0,
                                      None, fo)
        return jnp.sum(out.ssh ** 2)

    def obj_roll(s, t, fo):
        out = structured_run_loop(s, smesh, t, N_STEPS, forcing=fo)
        return jnp.sum(out.ssh ** 2)

    grad = jax.grad(obj_diff, argnums=(0, 1, 2))
    gd = (jax.jit(grad) if jit else grad)(st, jnp.asarray(DT), f)
    gr = jax.grad(obj_roll, argnums=(0, 1, 2))(st, jnp.asarray(DT), f)
    _assert_tree_close(gd[0], gr[0], rtol=1e-8)
    np.testing.assert_allclose(float(gd[1]), float(gr[1]), rtol=1e-8)
    _assert_tree_close(gd[2], gr[2], rtol=1e-8)
    assert float(jnp.abs(gd[2].wind_edge).max()) > 0


def test_rollout_diff_traced_dt():
    """dt may arrive as a tracer (jit over dt); the rollout runs and equals
    the concrete-dt scan."""
    _, sm, prog, _ = _case("linear")
    st = sm.to_struct(prog)
    smesh = sm.struct_mesh
    out = jax.jit(
        lambda s, t: structured_rollout_diff(s, smesh, t, N_STEPS)
    )(st, jnp.asarray(DT))
    _assert_tree_close(out, structured_run_loop(st, smesh, DT, N_STEPS),
                       rtol=0, atol=1e-14)
