"""Momentum forcing (wind stress, bottom drag, Rayleigh damping).

The reference recognizes this subsystem but ships it empty
(reference: src/ocn/ForcingVars.jl is an empty file); these tests pin the
implementation that fills it: exact single-step algebra, steady wind/drag
balance against the analytic fixed point, and agreement of the gather,
matrix and structured-roll execution paths at f64 roundoff.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpas_ocean.mesh import planar_hex_mesh
from mpas_ocean.mesh.mesh import Mesh
from mpas_ocean.mesh.vert_mesh import make_vertical_mesh
from mpas_ocean.models.forcing import RHO0, forcing_tendency, make_forcing
from mpas_ocean.models.shallow_water import (
    PrognosticVars,
    compute_diagnostics,
)
from mpas_ocean.forward.time_integration import (
    ForwardEuler,
    RungeKutta4,
    ocn_timestep,
)
from mpas_ocean.forward.run_loop import ocn_run_loop, ocn_run_loop_objective

NX = NY = 16
K = 2
H0 = 50.0


@pytest.fixture(scope="module")
def setup():
    horz = planar_hex_mesh(NX, NY, 5000.0, f0=1e-4)
    vert = make_vertical_mesh(
        horz, n_vert_levels=K, resting_thickness=np.full((horz.n_cells, K), H0)
    )
    mesh = Mesh(horz=horz, vert=vert).to_device()
    rng = np.random.default_rng(11)
    h = np.full((horz.n_cells, K), H0) + 0.05 * rng.normal(
        size=(horz.n_cells, K)
    )
    u = 0.05 * rng.normal(size=(horz.n_edges, K))
    prog = PrognosticVars(
        ssh=jnp.asarray(h.sum(1) - np.asarray(vert.resting_thickness_sum)),
        layer_thickness=jnp.asarray(h),
        normal_velocity=jnp.asarray(u),
    )
    return mesh, prog


def _full_forcing(mesh):
    return make_forcing(
        mesh,
        wind_stress_zonal=0.1,
        wind_stress_meridional=-0.05,
        bottom_drag_linear=1e-5,
        bottom_drag_quadratic=2e-3,
        rayleigh=1e-6,
    )


def test_forced_step_is_unforced_plus_dt_tendency(setup):
    """Forward Euler: step(forcing) - step(None) == dt * forcing_tendency
    evaluated at the initial state — pins both the wiring and the exact
    term-by-term algebra (wind on the top level, drag on the bottom,
    Rayleigh everywhere, closed/below-bathymetry levels untouched)."""
    mesh, prog = setup
    forcing = _full_forcing(mesh)
    dt = 30.0
    base = ocn_timestep(prog, mesh, dt, ForwardEuler)
    forced = ocn_timestep(prog, mesh, dt, ForwardEuler, forcing=forcing)

    diag = compute_diagnostics(prog, mesh)
    expected = dt * forcing_tendency(
        prog.normal_velocity, diag.layer_thickness_edge, forcing
    )
    np.testing.assert_allclose(
        np.asarray(forced.normal_velocity - base.normal_velocity),
        np.asarray(expected),
        rtol=0,
        atol=1e-14,
    )
    # thickness is not directly forced
    np.testing.assert_array_equal(
        np.asarray(forced.layer_thickness), np.asarray(base.layer_thickness)
    )


def test_wind_drag_steady_state_analytic():
    """Uniform zonal wind + quadratic bottom drag on a single-layer flat
    ocean at f=0: TRiSK divergence of a projected uniform vector field is
    exactly zero, so h stays flat and each edge independently relaxes to
    u* = sign(w) sqrt(|w|/Cd), w = (tau.n)/(rho0 Cd)... verified against
    the analytic fixed point per edge."""
    tau = 0.1
    cd = 2e-3
    horz = planar_hex_mesh(8, 8, 5000.0, f0=0.0)
    vert = make_vertical_mesh(
        horz, n_vert_levels=1, resting_thickness=np.full((horz.n_cells, 1), H0)
    )
    mesh = Mesh(horz=horz, vert=vert).to_device()
    forcing = make_forcing(mesh, wind_stress_zonal=tau, bottom_drag_quadratic=cd)
    prog = PrognosticVars(
        ssh=jnp.zeros(horz.n_cells),
        layer_thickness=jnp.full((horz.n_cells, 1), H0),
        normal_velocity=jnp.zeros((horz.n_edges, 1)),
    )
    # relaxation rate near the fixed point is 2 Cd u*/H ~ 1.25e-5 /s on the
    # slow (diagonal) edges: 3.2e6 s brings the transient below 1e-15
    out = ocn_run_loop(prog, mesh, 200.0, 16000, forcing=forcing)
    # h must stay exactly flat (uniform-vector divergence = 0 identically)
    np.testing.assert_allclose(
        np.asarray(out.layer_thickness), H0, rtol=0, atol=1e-8
    )
    wind_n = np.asarray(forcing.wind_edge)  # tau cos(theta) / rho0
    u_star = np.sign(wind_n) * np.sqrt(np.abs(wind_n) / cd)
    np.testing.assert_allclose(
        np.asarray(out.normal_velocity[:, 0]), u_star, rtol=1e-6, atol=1e-9
    )


def test_rayleigh_decay_exact_recurrence():
    """Pure Rayleigh damping of a geostrophically quiet state: with zero
    wind/drag/pressure terms the FE recurrence is u_{n+1} = (1 - r dt) u_n
    exactly; 50 steps must match to roundoff."""
    r = 1e-4
    horz = planar_hex_mesh(8, 8, 5000.0, f0=0.0)
    vert = make_vertical_mesh(
        horz, n_vert_levels=1, resting_thickness=np.full((horz.n_cells, 1), H0)
    )
    mesh = Mesh(horz=horz, vert=vert).to_device()
    forcing = make_forcing(mesh, rayleigh=r)
    # uniform-vector velocity field: divergence-free AND curl-free on the
    # TRiSK lattice, so the pressure/Coriolis dynamics stay exactly zero
    angle = np.asarray(horz.edges.angle_edge)
    u0 = 0.3 * np.cos(angle) + 0.1 * np.sin(angle)
    prog = PrognosticVars(
        ssh=jnp.zeros(horz.n_cells),
        layer_thickness=jnp.full((horz.n_cells, 1), H0),
        normal_velocity=jnp.asarray(u0[:, None]),
    )
    dt, n = 100.0, 50
    out = ocn_run_loop(prog, mesh, dt, n, forcing=forcing)
    np.testing.assert_allclose(
        np.asarray(out.normal_velocity[:, 0]),
        u0 * (1.0 - r * dt) ** n,
        rtol=1e-12,
        atol=1e-15,
    )


def test_forcing_path_equivalence(setup):
    """Gather, matrix/BSR and structured-roll paths agree at f64 roundoff
    with the full forcing stack on (the architecture invariant extends to
    every new physics term)."""
    from mpas_ocean.models.matrix_model import MatrixModel, matrix_run_loop
    from mpas_ocean.structured import StructuredModel

    mesh, prog = setup
    forcing = _full_forcing(mesh)
    dt, n = 30.0, 10

    ref = ocn_run_loop(prog, mesh, dt, n, forcing=forcing)

    mm = MatrixModel.from_mesh(mesh, dtype=np.float64)
    out_m = matrix_run_loop(prog, mm, dt, n, forcing=forcing)
    np.testing.assert_allclose(
        np.asarray(out_m.normal_velocity),
        np.asarray(ref.normal_velocity),
        rtol=0,
        atol=1e-12,
    )
    np.testing.assert_allclose(
        np.asarray(out_m.ssh), np.asarray(ref.ssh), rtol=0, atol=1e-11
    )

    sm = StructuredModel(mesh, NX, NY)
    sf = sm.to_struct_forcing(forcing)
    out_s = sm.from_struct(sm.run(sm.to_struct(prog), dt, n, forcing=sf))
    np.testing.assert_allclose(
        np.asarray(out_s.normal_velocity),
        np.asarray(ref.normal_velocity),
        rtol=0,
        atol=1e-12,
    )
    np.testing.assert_allclose(
        np.asarray(out_s.ssh), np.asarray(ref.ssh), rtol=0, atol=1e-11
    )


def test_forcing_rk4_and_nonlinear_compose(setup):
    """Forcing composes with RK4 and with the nonlinear dynamics: runs stay
    finite and differ from the unforced runs."""
    mesh, prog = setup
    forcing = _full_forcing(mesh)
    out = ocn_run_loop(
        prog, mesh, 30.0, 5, RungeKutta4, nonlinear=True, forcing=forcing
    )
    base = ocn_run_loop(prog, mesh, 30.0, 5, RungeKutta4, nonlinear=True)
    assert np.isfinite(np.asarray(out.normal_velocity)).all()
    assert (
        np.abs(np.asarray(out.normal_velocity - base.normal_velocity)).max()
        > 0
    )


def test_forcing_gradient_flows(setup):
    """The adjoint differentiates through the forcing terms (quadratic drag
    included: |u| has a well-defined subgradient a.e.)."""
    mesh, prog = setup
    forcing = _full_forcing(mesh)
    g = jax.grad(
        lambda p: ocn_run_loop_objective(p, mesh, 30.0, 5, forcing=forcing)
    )(prog)
    leaves = jax.tree.leaves(g)
    assert all(np.isfinite(np.asarray(x)).all() for x in leaves)
    assert any(np.abs(np.asarray(x)).max() > 0 for x in leaves)


def test_forcing_respects_bathymetry_masks():
    """On a variable-depth mesh the wind hits the first ACTIVE level and
    the drag the LAST active level; inactive levels stay exactly zero."""
    horz = planar_hex_mesh(8, 8, 5000.0, f0=0.0)
    k = 4
    rng = np.random.default_rng(3)
    max_lc = rng.integers(2, k + 1, size=horz.n_cells).astype(np.int32)
    rt = np.full((horz.n_cells, k), H0)
    lv = np.arange(k)[None, :]
    rt = np.where(lv < max_lc[:, None], rt, 0.0)
    vert = make_vertical_mesh(
        horz, n_vert_levels=k, resting_thickness=rt, max_level_cell=max_lc
    )
    mesh = Mesh(horz=horz, vert=vert).to_device()
    forcing = make_forcing(
        mesh, wind_stress_zonal=0.1, bottom_drag_quadratic=1e-3
    )
    top = np.asarray(forcing.top_mask)
    bot = np.asarray(forcing.bottom_mask)
    elm = np.asarray(mesh.vert.edge_level_mask)
    # one-hot inside the active range
    assert top.sum(1).max() == 1 and bot.sum(1).max() == 1
    assert ((top + bot) * (1 - elm)).max() == 0
    h = np.where(lv < max_lc[:, None], H0, 0.0)
    prog = PrognosticVars(
        ssh=jnp.zeros(horz.n_cells),
        layer_thickness=jnp.asarray(h),
        normal_velocity=jnp.zeros((horz.n_edges, k)),
    )
    out = ocn_run_loop(prog, mesh, 50.0, 20, forcing=forcing)
    u = np.asarray(out.normal_velocity)
    assert np.isfinite(u).all()
    # inactive levels never accelerate
    np.testing.assert_array_equal(u * (1 - elm), 0.0)
    # active top levels of open edges do
    emask = np.asarray(mesh.edges.edge_mask)
    wind = np.asarray(forcing.wind_edge)
    live = (np.abs(wind) > 1e-12) & (emask > 0)
    assert (np.abs(u[live]).max(initial=0.0)) > 0


def test_driver_forcing_config(tmp_path):
    """The namelist `forcing` section drives the whole config->driver->
    rollout chain, and the result differs from the unforced run."""
    from mpas_ocean.forward.driver import ocn_run
    from mpas_ocean.tools.cases import make_igw_case

    d_f = tmp_path / "forced"
    d_0 = tmp_path / "plain"
    d_f.mkdir(), d_0.mkdir()
    cfg_f = make_igw_case(
        d_f, nx=16, resolution_km=200.0, duration_seconds=4000,
        forcing={
            "config_wind_stress_zonal": 0.1,
            "config_bottom_drag_quadratic": 2.0e-3,
        },
    )
    cfg_0 = make_igw_case(d_0, nx=16, resolution_km=200.0,
                          duration_seconds=4000)
    setup_f, prog_f = ocn_run(cfg_f)
    assert setup_f.forcing is not None
    setup_0, prog_0 = ocn_run(cfg_0)
    assert setup_0.forcing is None
    assert np.isfinite(np.asarray(prog_f.normal_velocity)).all()
    assert (
        np.abs(np.asarray(prog_f.normal_velocity - prog_0.normal_velocity)).max()
        > 0
    )


@pytest.mark.parametrize("method_nl", [("fe", False), ("rk4", False),
                                       ("fe", True)])
def test_forcing_sharded_unstructured(setup, method_nl):
    """The cell-partitioned sharded path (ppermute halos) reproduces the
    global forced rollout at f64 roundoff — FE, RK4 (per-stage exchange)
    and nonlinear (derived-field exchange), forcing included. Overlap
    mini-stepping is bypassed with forcing on (the mini mesh carries no
    forcing fields) — the result must be identical either way."""
    from mpas_ocean.parallel import ShardedModel

    kind, nonlinear = method_nl
    method = RungeKutta4 if kind == "rk4" else ForwardEuler
    mesh, prog = setup
    forcing = _full_forcing(mesh)
    dt, n = 30.0, 6
    ref = ocn_run_loop(
        prog, mesh, dt, n, method, nonlinear=nonlinear, forcing=forcing
    )
    sm = ShardedModel(mesh, devices=jax.devices()[:4])
    out = sm.gather(
        sm.run(sm.scatter(prog), dt, n, method, nonlinear=nonlinear,
               forcing=forcing)
    )
    np.testing.assert_allclose(
        np.asarray(out.normal_velocity),
        np.asarray(ref.normal_velocity),
        rtol=0,
        atol=1e-12,
    )
    np.testing.assert_allclose(
        np.asarray(out.ssh), np.asarray(ref.ssh), rtol=0, atol=1e-11
    )


@pytest.mark.parametrize("nonlinear", [False, True])
def test_forcing_sharded_structured(setup, nonlinear):
    """The row-slab structured sharded path with forcing matches the global
    structured rollout at f64 roundoff (linear overlap schedule and the
    nonlinear derived-field rounds both carry the forcing terms)."""
    from mpas_ocean.structured import StructuredModel
    from mpas_ocean.structured.model import structured_run_loop
    from mpas_ocean.structured.sharded import ShardedStructuredModel

    mesh, prog = setup
    forcing = _full_forcing(mesh)
    sm = StructuredModel(mesh, NX, NY)
    sf = sm.to_struct_forcing(forcing)
    st = sm.to_struct(prog)
    dt, n = 30.0, 6
    ref = structured_run_loop(
        st, sm.struct_mesh, dt, n, nonlinear=nonlinear, forcing=sf
    )
    ssm = ShardedStructuredModel(sm.struct_mesh, devices=jax.devices()[:4])
    out = ssm.gather(
        ssm.run(ssm.scatter(st), dt, n, nonlinear=nonlinear, forcing=sf)
    )
    np.testing.assert_allclose(
        np.asarray(out.normal_velocity),
        np.asarray(ref.normal_velocity),
        rtol=0,
        atol=1e-12,
    )
    np.testing.assert_allclose(
        np.asarray(out.ssh), np.asarray(ref.ssh), rtol=0, atol=1e-11
    )


def test_forcing_pallas_rollout_diff_grad(setup):
    """structured_rollout_diff with forcing: gradients wrt the STATE and the
    FORCING (wind field + drag/Rayleigh coefficients) match jax.grad of
    the un-checkpointed roll rollout — the Forcing cotangent rides the
    checkpointed-roll reverse exactly."""
    from mpas_ocean.structured import StructuredModel, structured_rollout_diff
    from mpas_ocean.structured.model import structured_run_loop

    mesh, prog = setup
    forcing = _full_forcing(mesh)
    sm = StructuredModel(mesh, NX, NY)
    sf = sm.to_struct_forcing(forcing)
    st = sm.to_struct(prog)
    dt, n = 30.0, 5

    def obj_p(s, f):
        o = structured_rollout_diff(s, sm.struct_mesh, dt, n, False, 0.0,
                                    1.0, None, f)
        return jnp.sum(o.ssh**2)

    def obj_r(s, f):
        o = structured_run_loop(s, sm.struct_mesh, dt, n, forcing=f)
        return jnp.sum(o.ssh**2)

    gp_s, gp_f = jax.grad(obj_p, argnums=(0, 1))(st, sf)
    gr_s, gr_f = jax.grad(obj_r, argnums=(0, 1))(st, sf)
    np.testing.assert_allclose(
        np.asarray(gp_s.normal_velocity),
        np.asarray(gr_s.normal_velocity),
        rtol=0, atol=1e-11,
    )
    np.testing.assert_allclose(
        np.asarray(gp_f.wind_edge), np.asarray(gr_f.wind_edge),
        rtol=0, atol=1e-11,
    )
    for name in ("drag_linear", "drag_quadratic", "rayleigh"):
        np.testing.assert_allclose(
            np.asarray(getattr(gp_f, name)),
            np.asarray(getattr(gr_f, name)),
            rtol=1e-12, atol=0,
        )
