"""Layered baroclinic (multi-layer) dynamics tests
(models/stratification.py).

The reference has no interacting levels at all — each of its K levels is an
independent barotropic copy (reference: pressure_gradient.jl:45-65) — so
the contract here is: (a) equal densities reduce EXACTLY to that behavior,
(b) the stratified dynamics reproduce the analytic baroclinic wave speeds,
(c) every execution path agrees to f64 roundoff.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpas_ocean.forward.run_loop import ocn_run_loop
from mpas_ocean.forward.time_integration import RungeKutta4
from mpas_ocean.mesh import planar_hex_mesh
from mpas_ocean.mesh.mesh import Mesh
from mpas_ocean.mesh.vert_mesh import make_vertical_mesh
from mpas_ocean.models.shallow_water import PrognosticVars, update_ssh
from mpas_ocean.models.stratification import (
    baroclinic_wave_speeds,
    make_stratification,
)

K = 3
DT = 10.0
RHO = [1024.0, 1025.5, 1026.0]


@pytest.fixture(scope="module")
def strat_setup(hex16):
    vert = make_vertical_mesh(hex16, n_vert_levels=K)
    mesh = Mesh(horz=hex16, vert=vert).to_device()
    rng = np.random.default_rng(11)
    nc, ne = hex16.n_cells, hex16.n_edges
    h0 = np.asarray(vert.resting_thickness) + 0.05 * rng.standard_normal((nc, K))
    u0 = 0.05 * rng.standard_normal((ne, K))
    prog = PrognosticVars(
        ssh=update_ssh(jnp.asarray(h0), mesh),
        layer_thickness=jnp.asarray(h0),
        normal_velocity=jnp.asarray(u0),
    )
    return mesh, prog, make_stratification(RHO)


def test_equal_densities_reduce_to_barotropic(strat_setup):
    """With rho_k all equal every reduced gravity vanishes and the
    stratified model IS the reference's barotropic stack."""
    mesh, prog, _ = strat_setup
    s_eq = make_stratification([1026.0] * K)
    a = ocn_run_loop(prog, mesh, DT, 10)
    b = ocn_run_loop(prog, mesh, DT, 10, strat=s_eq)
    np.testing.assert_allclose(
        np.asarray(a.normal_velocity), np.asarray(b.normal_velocity),
        atol=1e-15,
    )


def test_unstable_column_rejected():
    with pytest.raises(ValueError):
        make_stratification([1026.0, 1025.0])


def test_matrix_path_parity(strat_setup):
    from mpas_ocean.models.matrix_model import MatrixModel, matrix_run_loop

    mesh, prog, strat = strat_setup
    mm = MatrixModel.from_mesh(mesh, dtype=np.float64)
    a = ocn_run_loop(prog, mesh, DT, 10, strat=strat)
    b = matrix_run_loop(prog, mm, DT, 10, strat=strat)
    np.testing.assert_allclose(
        np.asarray(a.normal_velocity), np.asarray(b.normal_velocity),
        atol=1e-13,
    )


def test_roll_and_fused_path_parity(strat_setup):
    from mpas_ocean.structured.model import StructuredModel

    mesh, prog, strat = strat_setup
    sm = StructuredModel(mesh, 16, 16)
    st = sm.to_struct(prog)
    a = ocn_run_loop(prog, mesh, DT, 10, strat=strat)
    b = sm.from_struct(sm.run(st, DT, 10, strat=strat))
    np.testing.assert_allclose(
        np.asarray(a.normal_velocity), np.asarray(b.normal_velocity),
        atol=1e-13,
    )
    # RK4 on gather and roll
    a4 = ocn_run_loop(prog, mesh, DT, 5, method=RungeKutta4, strat=strat)
    b4 = sm.from_struct(sm.run(st, DT, 5, strat=strat, rk4=True))
    np.testing.assert_allclose(
        np.asarray(a4.normal_velocity), np.asarray(b4.normal_velocity),
        atol=1e-13,
    )


def test_sharded_parity(strat_setup):
    from mpas_ocean.parallel.shard_step import ShardedModel

    mesh, prog, strat = strat_setup
    sm = ShardedModel(mesh, devices=jax.devices())
    for kwargs in (dict(), dict(method=RungeKutta4), dict(nonlinear=True)):
        a = ocn_run_loop(prog, mesh, DT, 6, strat=strat, **kwargs)
        b = sm.gather(sm.run(sm.scatter(prog), DT, 6, strat=strat, **kwargs))
        np.testing.assert_allclose(
            np.asarray(a.normal_velocity), np.asarray(b.normal_velocity),
            atol=1e-13,
        )


def test_structured_sharded_parity(strat_setup):
    from mpas_ocean.structured.model import StructuredModel
    from mpas_ocean.structured.sharded import ShardedStructuredModel

    mesh, prog, strat = strat_setup
    sm = StructuredModel(mesh, 16, 16)
    st = sm.to_struct(prog)
    ref = sm.run(st, DT, 6, strat=strat)
    for overlap in (False, True):
        ssm = ShardedStructuredModel(
            sm.struct_mesh, devices=jax.devices(), overlap=overlap
        )
        out = ssm.gather(ssm.run(ssm.scatter(st), DT, 6, strat=strat))
        np.testing.assert_allclose(
            np.asarray(ref.normal_velocity), np.asarray(out.normal_velocity),
            atol=1e-13,
        )


def test_strat_gradient_flows_and_matches(strat_setup):
    """d(objective)/d(phi_weights) is nonzero and identical whether it flows
    through the checkpointed structured_rollout_diff or plain AD of the
    roll scan (a custom VJP once silently returned zeros here)."""
    from mpas_ocean.structured.model import (
        StructuredModel,
        structured_rollout_diff,
        structured_run_loop,
    )

    mesh, prog, strat = strat_setup
    sm = StructuredModel(mesh, 16, 16)
    st = sm.to_struct(prog)
    n = 5

    def f_diff(w):
        out = structured_rollout_diff(st, sm.struct_mesh, DT, n, False, 0.0,
                                      1.0, w)
        return jnp.sum(out.ssh ** 2)

    def f_roll(w):
        out = structured_run_loop(st, sm.struct_mesh, DT, n, strat=w)
        return jnp.sum(out.ssh ** 2)

    g1 = jax.grad(f_diff)(strat)
    g2 = jax.grad(f_roll)(strat)
    assert float(jnp.abs(g2.phi_weights).max()) > 0
    np.testing.assert_allclose(
        np.asarray(g1.phi_weights), np.asarray(g2.phi_weights), rtol=1e-10
    )


def test_two_layer_internal_wave_speed():
    """A standing baroclinic mode (interface tilted, surface flat) must
    oscillate at omega = c1*k with c1^2 = g' H1 H2/(H1+H2): run half a
    period with RK4 and check the mode amplitude has inverted. This is the
    physics the reference cannot represent at all."""
    from mpas_ocean.verification import InternalWave

    nx, dc = 32, 10000.0
    iw = InternalWave(lx=nx * dc / 1e3, amplitude=1.0)
    horz = planar_hex_mesh(nx, nx, dc, f0=0.0)
    vert = make_vertical_mesh(
        horz, n_vert_levels=2,
        resting_thickness=np.tile(np.array([iw.h1, iw.h2]), (horz.n_cells, 1)),
    )
    mesh = Mesh(horz=horz, vert=vert).to_device()
    strat = make_stratification(iw.densities())
    cs = baroclinic_wave_speeds(iw.densities(), [iw.h1, iw.h2])
    # mode speeds themselves: barotropic ~ sqrt(gH), baroclinic ~ the
    # reduced-gravity two-layer formula
    np.testing.assert_allclose(
        cs[0], np.sqrt(iw.g * (iw.h1 + iw.h2)), rtol=1e-3
    )
    np.testing.assert_allclose(
        cs[1], np.sqrt(iw.g_prime * iw.h1 * iw.h2 / (iw.h1 + iw.h2)),
        rtol=1e-3,
    )

    ssh, h, u = iw.initial_state(horz)
    prog = PrognosticVars(
        ssh=jnp.asarray(ssh),
        layer_thickness=jnp.asarray(h),
        normal_velocity=jnp.asarray(u),
    )
    dt = 100.0
    n_half = int(round(iw.period / 2 / dt))
    out = ocn_run_loop(prog, mesh, dt, n_half, method=RungeKutta4, strat=strat)
    # after half a period the standing mode must match the exact solution
    # with inverted amplitude
    x = np.asarray(horz.cells.x)
    basis = np.sin(iw.k * x)
    proj = lambda f: float(np.vdot(basis, f - iw.h1) / np.vdot(basis, basis))
    a0 = proj(h[:, 0])
    a1 = proj(np.asarray(out.layer_thickness[:, 0]))
    np.testing.assert_allclose(a1, -a0, rtol=0.05)
    exact = iw.exact_thickness(x, n_half * dt)
    rmse = float(np.sqrt(np.mean((np.asarray(out.layer_thickness) - exact) ** 2)))
    assert rmse < 0.05 * iw.amplitude


def test_driver_stratified_config(tmp_path):
    from mpas_ocean.forward.driver import ocn_run
    from mpas_ocean.tools import make_igw_case

    case = tmp_path / "strat_case"
    cfg = make_igw_case(case, nx=16, resolution_km=200.0, n_vert_levels=2,
                        duration_seconds=2000,
                        layer_densities=[1025.0, 1026.0])
    setup, prog = ocn_run(cfg)
    assert setup.strat is not None
    assert np.all(np.isfinite(np.asarray(prog.normal_velocity)))
    # levels must now DIFFER (the barotropic stack would keep them equal,
    # since the IGW initial state is level-replicated)
    du = np.abs(
        np.asarray(prog.normal_velocity[:, 0])
        - np.asarray(prog.normal_velocity[:, 1])
    ).max()
    assert du > 0


def test_density_count_mismatch_rejected(tmp_path):
    from mpas_ocean.forward.init import ocn_init
    from mpas_ocean.tools import make_igw_case

    case = tmp_path / "bad_strat_case"
    cfg = make_igw_case(case, nx=16, resolution_km=200.0, n_vert_levels=1,
                        duration_seconds=2000,
                        layer_densities=[1025.0, 1026.0])
    with pytest.raises(ValueError):
        ocn_init(cfg)
