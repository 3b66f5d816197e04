"""End-to-end integration tests: inertial gravity wave vs. analytic
solution (the reference's headline verification workflow,
src/compare.py:207-266), conservation, and stepper behavior."""

import jax
import numpy as np
import pytest

from mpas_ocean.forward.run_loop import (
    ocn_run_loop,
    ocn_run_loop_with_outputs,
)
from mpas_ocean.forward.time_integration import (
    ForwardEuler,
    RungeKutta4,
    ocn_timestep,
)
from mpas_ocean.models.shallow_water import PrognosticVars
from mpas_ocean.verification.inertial_gravity_wave import InertialGravityWave


@pytest.fixture(scope="module")
def igw_setup(igw_mesh):
    nx = 32
    dc = 10000.0e3 / nx
    igw = InertialGravityWave()
    ssh, h, u = igw.initial_state(igw_mesh)
    prog = PrognosticVars(
        ssh=jax.numpy.asarray(ssh),
        layer_thickness=jax.numpy.asarray(h),
        normal_velocity=jax.numpy.asarray(u),
    )
    # the reference's dt heuristic (init.jl:117-119):
    # dt = floor(2 * (mean(dc)/1e3) * mean(dc) / 200e3)
    dt = float(np.floor(2.0 * (dc / 1e3) * dc / 200e3))
    return igw, prog, dt


def _ssh_rmse(igw, mesh, ssh, t):
    xc = np.asarray(mesh.cells.x)
    yc = np.asarray(mesh.cells.y)
    exact = igw.exact_ssh(xc, yc, t)
    return float(np.sqrt(np.mean((np.asarray(ssh) - exact) ** 2)))


def test_igw_forward_euler_accuracy(igw_mesh, igw_setup):
    igw, prog, dt = igw_setup
    n = 10
    fin = ocn_run_loop(prog, igw_mesh, dt, n)
    rmse = _ssh_rmse(igw, igw_mesh, fin.ssh, n * dt)
    assert np.isfinite(np.asarray(fin.ssh)).all()
    # coarse 312 km test mesh: first-order FE + O(dx^2) spatial error
    assert rmse < 0.25 * igw.eta0


def test_igw_rk4_beats_forward_euler(igw_mesh, igw_setup):
    igw, prog, dt = igw_setup
    n = 10
    fe = ocn_run_loop(prog, igw_mesh, dt, n, ForwardEuler)
    rk = ocn_run_loop(prog, igw_mesh, dt, n, RungeKutta4)
    t = n * dt
    assert _ssh_rmse(igw, igw_mesh, rk.ssh, t) < _ssh_rmse(igw, igw_mesh, fe.ssh, t)


def test_volume_conservation(igw_mesh, igw_setup):
    """Total water volume sum(h * areaCell) is exactly conserved by the
    flux-form thickness equation."""
    _, prog, dt = igw_setup
    area = np.asarray(igw_mesh.cells.area_cell)
    v0 = float((np.asarray(prog.layer_thickness)[:, 0] * area).sum())
    fin = ocn_run_loop(prog, igw_mesh, dt, 10)
    v1 = float((np.asarray(fin.layer_thickness)[:, 0] * area).sum())
    assert abs(v1 - v0) < 1e-9 * abs(v0)


def test_ssh_consistency(igw_mesh, igw_setup):
    """ssh always equals column thickness minus resting thickness."""
    _, prog, dt = igw_setup
    fin = ocn_run_loop(prog, igw_mesh, dt, 5)
    expect = np.asarray(fin.layer_thickness).sum(1) - np.asarray(
        igw_mesh.vert.resting_thickness_sum
    )
    np.testing.assert_allclose(np.asarray(fin.ssh), expect, atol=1e-12)


def test_single_step_matches_loop(igw_mesh, igw_setup):
    _, prog, dt = igw_setup
    one = ocn_timestep(prog, igw_mesh, dt)
    loop = ocn_run_loop(prog, igw_mesh, dt, 1)
    np.testing.assert_allclose(
        np.asarray(one.normal_velocity), np.asarray(loop.normal_velocity), atol=0
    )


def test_outputs_variant(igw_mesh, igw_setup):
    _, prog, dt = igw_setup
    fin, outs = ocn_run_loop_with_outputs(prog, igw_mesh, dt, 6, 3)
    assert outs.ssh.shape[0] == 3
    np.testing.assert_allclose(np.asarray(outs.ssh[-1]), np.asarray(fin.ssh), atol=0)
    mid = ocn_run_loop(prog, igw_mesh, dt, 2)
    np.testing.assert_allclose(np.asarray(outs.ssh[0]), np.asarray(mid.ssh), atol=0)


def test_multilayer_consistency(mesh16_3l):
    """With identical per-layer ICs the layers stay identical, and layer 1
    matches a single-layer run (the reference integrates only k=1,
    SURVEY quirk 7.1 — this shows our full-depth integration agrees where
    the reference is defined)."""
    horz = mesh16_3l.horz
    xc = np.asarray(horz.cells.x)
    ssh0 = 0.1 * np.cos(2 * np.pi * xc / horz.lx)
    h0 = np.repeat(((ssh0 + 3.0) / 3.0)[:, None], 3, axis=1)
    prog = PrognosticVars(
        ssh=jax.numpy.asarray(ssh0),
        layer_thickness=jax.numpy.asarray(h0),
        normal_velocity=jax.numpy.zeros((horz.n_edges, 3)),
    )
    fin = ocn_run_loop(prog, mesh16_3l, 10.0, 5)
    h = np.asarray(fin.layer_thickness)
    np.testing.assert_allclose(h[:, 0], h[:, 1], rtol=1e-12)
    np.testing.assert_allclose(h[:, 0], h[:, 2], rtol=1e-12)


def test_igw_spatial_convergence():
    """Refining the mesh 2x must shrink the IGW ssh error by ~4x (TRiSK is
    second-order on uniform hex meshes) — the quantitative accuracy tier
    the reference only spot-checks with fixed golden norms."""
    import jax.numpy as jnp

    from mpas_ocean.forward.run_loop import ocn_run_loop
    from mpas_ocean.forward.time_integration import RungeKutta4
    from mpas_ocean.mesh import planar_hex_mesh
    from mpas_ocean.mesh.mesh import Mesh
    from mpas_ocean.mesh.vert_mesh import make_vertical_mesh
    from mpas_ocean.models.shallow_water import PrognosticVars
    from mpas_ocean.verification.inertial_gravity_wave import (
        InertialGravityWave,
    )

    t_end = 2000.0
    errors = {}
    for nx in (16, 32):
        dc = 10000.0e3 / nx
        horz = planar_hex_mesh(nx, nx, dc, f0=1e-4)
        igw = InertialGravityWave(lx=nx * dc / 1e3, f0=1e-4)
        vert = make_vertical_mesh(
            horz,
            n_vert_levels=1,
            resting_thickness=np.full((horz.n_cells, 1), igw.bottom_depth),
        )
        mesh = Mesh(horz=horz, vert=vert).to_device()
        ssh, h, u = igw.initial_state(horz)
        prog = PrognosticVars(
            ssh=jnp.asarray(ssh),
            layer_thickness=jnp.asarray(h),
            normal_velocity=jnp.asarray(u),
        )
        n = 20 * (nx // 16)  # halve dt with dx: temporal error shrinks too
        fin = ocn_run_loop(prog, mesh, t_end / n, n, RungeKutta4)
        exact = igw.exact_ssh(
            np.asarray(horz.cells.x), np.asarray(horz.cells.y), t_end
        )
        errors[nx] = float(np.sqrt(np.mean((np.asarray(fin.ssh) - exact) ** 2)))

    order = np.log2(errors[16] / errors[32])
    assert order > 1.5, (errors, order)
