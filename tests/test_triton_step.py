"""The Triton lattice-step kernel (structured/triton_step.py) and its route.

On the CPU the kernel runs in the Pallas interpreter against the roll
rollout (structured_run_loop) it replaces on the GPU; the `gpu`-marked test
compiles it for the card. ``StructuredModel.run`` routes only the linear
forward-Euler core on a GPU to it.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpas_ocean.mesh import planar_hex_mesh
from mpas_ocean.mesh.cull import cull_cells
from mpas_ocean.mesh.mesh import Mesh
from mpas_ocean.mesh.vert_mesh import make_vertical_mesh
from mpas_ocean.models.forcing import make_forcing
from mpas_ocean.models.shallow_water import PrognosticVars, update_ssh
from mpas_ocean.models.stratification import make_stratification
from mpas_ocean.models.tracers import make_tracers
from mpas_ocean.structured import StructuredModel
from mpas_ocean.structured import triton_step
from mpas_ocean.structured.model import structured_run_loop
from mpas_ocean.structured.triton_step import triton_run_loop

DT = 10.0


def _case(nx, k, dtype=np.float64, channel=False):
    """A random state on an nx x nx lattice (optionally a walled channel)."""
    dc = 1000.0
    parent = planar_hex_mesh(nx, nx, dc, f0=1e-4, beta=1e-11, dtype=dtype)
    keep, horz = None, parent
    if channel:
        y = np.asarray(parent.cells.y)
        keep = (y > 0.5 * dc) & (y < y.max() - 0.5 * dc)
        horz = cull_cells(parent, keep)
    vert = make_vertical_mesh(
        horz, n_vert_levels=k,
        resting_thickness=np.full((horz.n_cells, k), 10.0, dtype=dtype),
        dtype=dtype,
    )
    mesh = Mesh(horz=horz, vert=vert).to_device()
    sm = (StructuredModel(mesh, nx, nx) if keep is None else
          StructuredModel(mesh, nx, nx, parent_horz=parent, keep_cells=keep))
    rng = np.random.default_rng(7)
    h = (10.0 + 0.01 * rng.normal(size=(horz.n_cells, k))).astype(dtype)
    u = (0.01 * rng.normal(size=(horz.n_edges, k))).astype(dtype)
    u *= np.asarray(horz.edges.edge_mask, dtype)[:, None]
    prog = PrognosticVars(
        ssh=update_ssh(jnp.asarray(h), mesh),
        layer_thickness=jnp.asarray(h),
        normal_velocity=jnp.asarray(u),
    )
    return mesh, sm, prog


@pytest.mark.parametrize(
    "nx,k,dtype,channel,rtol",
    [
        (8, 5, np.float64, False, 1e-12),
        (8, 4, np.float64, True, 1e-12),
        (6, 3, np.float32, False, 1e-5),
    ],
    ids=["periodic-f64-k5", "channel-f64", "nx6-f32"],
)
def test_triton_step_matches_roll_interpret(nx, k, dtype, channel, rtol):
    """Interpret mode against the roll rollout: periodic and walled
    lattices, a level count that is padded (5 -> 8) and a row length whose
    column tile shrinks to divide it (6 -> 2)."""
    _, sm, prog = _case(nx, k, dtype, channel)
    st, smesh = sm.to_struct(prog), sm.struct_mesh
    ref = structured_run_loop(st, smesh, dtype(DT), 3)
    out = triton_run_loop(st, smesh, dtype(DT), 3, interpret=True)
    for a, b in zip(jax.tree.leaves(out), jax.tree.leaves(ref)):
        assert a.shape == b.shape and a.dtype == b.dtype
        scale = float(jnp.abs(b).max())
        assert float(jnp.abs(a - b).max()) <= rtol * scale


def test_triton_step_refuses_tracers():
    mesh, sm, prog = _case(8, 2)
    prog = prog.replace(tracers=make_tracers(
        mesh, [np.full(mesh.horz.n_cells, 35.0)]))
    with pytest.raises(ValueError, match="linear core only"):
        triton_run_loop(sm.to_struct(prog), sm.struct_mesh, DT, 1,
                        interpret=True)


def _ssh_energy(run, n_steps=3):
    return lambda s, m, dt: jnp.sum(run(s, m, dt, n_steps).ssh ** 2)


def _assert_trees_close(got, ref, rtol):
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        assert a.shape == b.shape and a.dtype == b.dtype
        scale = float(jnp.abs(b).max())
        assert float(jnp.abs(a - b).max()) <= rtol * scale


@pytest.mark.parametrize("mode", ["grad", "jvp", "grad-through-run"])
def test_triton_run_loop_derivatives_interpret(monkeypatch, mode):
    """The kernel rollout differentiates like the roll rollout: reverse
    mode in state, mesh and dt, forward mode in the state, and jax.grad
    through StructuredModel.run where it routes to the kernel."""
    _, sm, prog = _case(8, 5, channel=True)
    st, smesh = sm.to_struct(prog), sm.struct_mesh
    kernel = partial(triton_run_loop, interpret=True)
    if mode == "jvp":
        tan = jax.tree.map(jnp.ones_like, st)
        out, t_out = jax.jvp(lambda s: kernel(s, smesh, DT, 3), (st,), (tan,))
        ref, t_ref = jax.jvp(lambda s: structured_run_loop(s, smesh, DT, 3),
                             (st,), (tan,))
        _assert_trees_close((out, t_out), (ref, t_ref), 1e-12)
        return
    if mode == "grad":
        got = jax.grad(_ssh_energy(kernel), argnums=(0, 1, 2))(st, smesh, DT)
        ref = jax.grad(_ssh_energy(structured_run_loop),
                       argnums=(0, 1, 2))(st, smesh, DT)
    else:
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        monkeypatch.setattr(triton_step, "triton_run_loop", kernel)
        got = jax.grad(lambda s: jnp.sum(sm.run(s, DT, 3).ssh ** 2))(st)
        ref = jax.grad(_ssh_energy(structured_run_loop))(st, smesh, DT)
    _assert_trees_close(got, ref, 1e-12)


ROUTES = {
    "linear": ({}, True),
    "nonlinear": ({"nonlinear": True}, False),
    "rk4": ({"rk4": True}, False),
    "fb": ({"fb": True}, False),
    "forced": ({"forcing": "forcing"}, False),
    "strat": ({"strat": "strat"}, False),
    "tracers": ({"tracers": True}, False),
}


@pytest.mark.parametrize("backend", ["gpu", "cpu"])
@pytest.mark.parametrize("case", list(ROUTES))
def test_structured_run_routes_linear_fe_on_gpu(monkeypatch, case, backend):
    """StructuredModel.run sends only the linear forward-Euler core to the
    Triton kernel, and only on a GPU; every other case runs the roll
    stencils and gives the roll rollout's values."""
    mesh, sm, prog = _case(8, 2)
    kw, to_kernel = dict(ROUTES[case][0]), ROUTES[case][1] and backend == "gpu"
    if kw.pop("tracers", False):
        prog = prog.replace(tracers=make_tracers(
            mesh, [np.full(mesh.horz.n_cells, 35.0)]))
    if kw.get("forcing"):
        kw["forcing"] = sm.to_struct_forcing(
            make_forcing(mesh, wind_stress_zonal=0.1))
    if kw.get("strat"):
        kw["strat"] = make_stratification(np.array([1025.0, 1026.0]))
    calls = []
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    monkeypatch.setattr(triton_step, "triton_run_loop",
                        lambda *a, **k: calls.append(a) or "kernel")
    st = sm.to_struct(prog)
    out = sm.run(st, DT, 2, **kw)
    if to_kernel:
        assert out == "kernel" and len(calls) == 1
        return
    assert not calls
    ref = structured_run_loop(st, sm.struct_mesh, DT, 2, **kw)
    for a, b in zip(jax.tree.leaves(out), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (the Triton kernel has no CPU "
                    "lowering; its CPU tests run in interpret mode)")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_triton_step_compiled_matches_roll(gpu, dtype):
    """The kernel as compiled for the card against the roll rollout on the
    reference's headline configuration (the inertial-gravity-wave state at
    64x64 x 100 levels, 20 steps), with the chip smoke test's tolerances
    for it."""
    import chip_smoke

    mesh, prog, dt = chip_smoke.igw_lattice(64, 100, dtype)
    sm = StructuredModel(mesh, 64, 64)
    st, smesh = sm.to_struct(prog), sm.struct_mesh
    ref = structured_run_loop(st, smesh, dtype(dt), 20)
    out = triton_run_loop(st, smesh, dtype(dt), 20)
    name = np.dtype(dtype).name
    for f, attr in zip(chip_smoke.FIELDS,
                       ("ssh", "layer_thickness", "normal_velocity")):
        rtol = (chip_smoke.RTOL_F32[f] if dtype == np.float32
                else chip_smoke.RTOL_F64)
        chip_smoke.compare(f"triton vs roll {f}", getattr(out, attr),
                           getattr(ref, attr), rtol, name)


@pytest.mark.gpu
def test_structured_run_grad_matches_roll(gpu):
    """jax.grad through StructuredModel.run, which runs the compiled kernel
    forward on the card, against jax.grad of the roll rollout (IGW state,
    64x64 x 100 levels f64, 20 steps) at the f64 tolerance of the chip
    smoke test. The gradient is one vector over the three fields and is
    compared against its largest entry, as chip_smoke's --multi phase
    does (the ssh part alone is small)."""
    import chip_smoke

    mesh, prog, dt = chip_smoke.igw_lattice(64, 100, np.float64)
    sm = StructuredModel(mesh, 64, 64)
    st, smesh = sm.to_struct(prog), sm.struct_mesh
    got = jax.grad(lambda s: jnp.sum(sm.run(s, dt, 20).ssh ** 2))(st)
    ref = jax.grad(_ssh_energy(structured_run_loop, 20))(st, smesh, dt)
    attrs = ("ssh", "layer_thickness", "normal_velocity")
    scale = max(float(jnp.abs(getattr(ref, a)).max()) for a in attrs)
    for f, attr in zip(chip_smoke.FIELDS, attrs):
        chip_smoke.compare(f"grad through run vs roll {f}",
                           getattr(got, attr), getattr(ref, attr),
                           chip_smoke.RTOL_F64, "f64", scale=scale)
