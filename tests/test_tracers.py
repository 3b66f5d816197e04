"""Tracer transport tests (models/tracers.py).

The reference stubs tracers out entirely (reference:
src/ocn/PrognosticVars.jl:20-26 — commented-out temperature/salinity
slots), so there is no reference behavior to match; these tests pin the
properties the scheme must have (consistency with continuity, conservation,
monotone upwinding, AD) and the framework's own invariant: every execution
path computes the same physics to f64 roundoff.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpas_ocean.forward.run_loop import ocn_run_loop
from mpas_ocean.forward.time_integration import (
    ForwardEuler,
    RungeKutta4,
    forward_euler_step,
)
from mpas_ocean.mesh import planar_hex_mesh
from mpas_ocean.mesh.cull import cull_cells
from mpas_ocean.mesh.mesh import Mesh
from mpas_ocean.mesh.vert_mesh import make_vertical_mesh
from mpas_ocean.models.shallow_water import PrognosticVars, update_ssh
from mpas_ocean.models.tracers import make_tracers, total_tracer_content

K = 2
DT = 50.0


@pytest.fixture(scope="module")
def tracer_setup(hex16):
    vert = make_vertical_mesh(hex16, n_vert_levels=K)
    mesh = Mesh(horz=hex16, vert=vert).to_device()
    rng = np.random.default_rng(7)
    nc, ne = hex16.n_cells, hex16.n_edges
    h0 = np.asarray(vert.resting_thickness) + 0.1 * rng.standard_normal((nc, K))
    u0 = 0.1 * rng.standard_normal((ne, K))
    x = np.asarray(hex16.cells.x)
    tr = make_tracers(mesh, [10.0 + np.sin(2 * np.pi * x / (x.max() + 1)),
                             35.0 + 0.0 * x])
    prog = PrognosticVars(
        ssh=update_ssh(jnp.asarray(h0), mesh),
        layer_thickness=jnp.asarray(h0),
        normal_velocity=jnp.asarray(u0),
        tracers=tr,
    )
    return mesh, prog


def test_uniform_tracer_stays_uniform(tracer_setup):
    """Consistency with continuity: T == const is a fixed point of the
    tracer equation for ANY flow (edge value = const, flux-form divergence
    telescopes against the thickness tendency)."""
    mesh, prog = tracer_setup
    out = ocn_run_loop(prog, mesh, DT, 20)
    sal = out.tracers[:, 1]
    np.testing.assert_allclose(np.asarray(sal), 35.0, rtol=1e-10)


def test_total_content_conserved(tracer_setup):
    """sum_c A_c (h T)_c is exactly conserved on a periodic mesh — advection
    AND diffusion are both in flux form."""
    mesh, prog = tracer_setup
    c0 = np.asarray(total_tracer_content(prog.tracers, prog.layer_thickness, mesh))
    for kwargs in (dict(), dict(tracer_upwind=0.0), dict(tracer_kappa=5.0),
                   dict(method=RungeKutta4, tracer_kappa=5.0)):
        out = ocn_run_loop(prog, mesh, DT, 10, **kwargs)
        c1 = np.asarray(
            total_tracer_content(out.tracers, out.layer_thickness, mesh)
        )
        np.testing.assert_allclose(c1, c0, rtol=1e-12)


def test_upwind_is_monotone(tracer_setup):
    """Full donor-cell upwinding creates no new tracer extrema (the blend's
    beta = 1 end is the monotone scheme; centered would overshoot). Run a
    window where the FE flow itself stays well-posed (h > 0, small CFL) —
    monotonicity is only defined there."""
    mesh, prog = tracer_setup
    t0 = np.asarray(prog.tracers[:, 0])
    out = ocn_run_loop(prog, mesh, 20.0, 30, tracer_upwind=1.0)
    assert float(out.layer_thickness.min()) > 0.0  # flow still physical
    t1 = np.asarray(out.tracers[:, 0])
    assert t1.max() <= t0.max() + 1e-9
    assert t1.min() >= t0.min() - 1e-9


def test_diffusion_dissipates_variance(tracer_setup):
    """With kappa > 0 and no flow, tracer spread decays while content is
    conserved (plain del2 heat equation on the mesh)."""
    mesh, prog = tracer_setup
    # a true rest state (flat h, u = 0) so ONLY diffusion acts on T
    h_rest = jnp.asarray(np.asarray(mesh.vert.resting_thickness))
    still = prog.replace(
        normal_velocity=jnp.zeros_like(prog.normal_velocity),
        layer_thickness=h_rest,
        ssh=update_ssh(h_rest, mesh),
    )
    out = ocn_run_loop(still, mesh, DT, 100, tracer_kappa=200.0)
    t0 = np.asarray(still.tracers[:, 0])
    t1 = np.asarray(out.tracers[:, 0])
    assert t1.var() < 0.8 * t0.var()
    # no flow => h unchanged, so the conserved content implies the
    # h-weighted concentration mean is conserved
    w = np.asarray(still.layer_thickness)
    np.testing.assert_allclose(
        (w * t1).sum(), (w * t0).sum(), rtol=1e-12
    )


def test_matrix_path_parity(tracer_setup):
    from mpas_ocean.models.matrix_model import MatrixModel, matrix_run_loop

    mesh, prog = tracer_setup
    mm = MatrixModel.from_mesh(mesh, dtype=np.float64)
    for kwargs in (dict(tracer_kappa=0.0, tracer_upwind=1.0),
                   dict(tracer_kappa=5.0, tracer_upwind=0.5)):
        a = ocn_run_loop(prog, mesh, DT, 10, **kwargs)
        b = matrix_run_loop(prog, mm, DT, 10, **kwargs)
        np.testing.assert_allclose(
            np.asarray(a.tracers), np.asarray(b.tracers), atol=2e-10
        )


def test_matrix_rk4_parity(tracer_setup):
    from mpas_ocean.models.matrix_model import MatrixModel, matrix_run_loop

    mesh, prog = tracer_setup
    mm = MatrixModel.from_mesh(mesh, dtype=np.float64)
    a = ocn_run_loop(prog, mesh, DT, 5, method=RungeKutta4, tracer_kappa=5.0)
    b = matrix_run_loop(prog, mm, DT, 5, rk4=True, tracer_kappa=5.0)
    np.testing.assert_allclose(
        np.asarray(a.tracers), np.asarray(b.tracers), atol=2e-10
    )


def test_roll_path_parity(tracer_setup):
    from mpas_ocean.structured.model import StructuredModel

    mesh, prog = tracer_setup
    sm = StructuredModel(mesh, 16, 16)
    for kwargs in (dict(tracer_kappa=0.0, tracer_upwind=1.0),
                   dict(tracer_kappa=5.0, tracer_upwind=0.5)):
        a = ocn_run_loop(prog, mesh, DT, 10, **kwargs)
        b = sm.from_struct(sm.run(sm.to_struct(prog), DT, 10, **kwargs))
        np.testing.assert_allclose(
            np.asarray(a.tracers), np.asarray(b.tracers), atol=2e-10
        )


def test_roll_nonlinear_parity(tracer_setup):
    from mpas_ocean.structured.model import StructuredModel

    mesh, prog = tracer_setup
    sm = StructuredModel(mesh, 16, 16)
    a = ocn_run_loop(prog, mesh, DT, 8, nonlinear=True, tracer_kappa=5.0)
    b = sm.from_struct(
        sm.run(sm.to_struct(prog), DT, 8, nonlinear=True, tracer_kappa=5.0)
    )
    np.testing.assert_allclose(
        np.asarray(a.tracers), np.asarray(b.tracers), atol=2e-10
    )


@pytest.fixture(scope="module")
def channel_setup(hex16):
    y = np.asarray(hex16.cells.y)
    keep = (y > y.min() + 1) & (y < y.max() - 1)
    ch = cull_cells(hex16, keep)
    vert = make_vertical_mesh(ch, n_vert_levels=K)
    mesh = Mesh(horz=ch, vert=vert).to_device()
    rng = np.random.default_rng(5)
    nc, ne = ch.n_cells, ch.n_edges
    h0 = np.asarray(vert.resting_thickness) + 0.1 * rng.standard_normal((nc, K))
    u0 = (0.1 * rng.standard_normal((ne, K))
          * np.asarray(ch.edges.edge_mask)[:, None])
    x = np.asarray(ch.cells.x)
    tr = make_tracers(mesh, [10.0 + np.sin(2 * np.pi * x / (x.max() + 1)),
                             35.0 + 0.0 * x])
    prog = PrognosticVars(
        ssh=update_ssh(jnp.asarray(h0), mesh),
        layer_thickness=jnp.asarray(h0),
        normal_velocity=jnp.asarray(u0),
        tracers=tr,
    )
    return mesh, keep, prog


def test_channel_walls_leak_nothing(channel_setup):
    """On a walled channel, content conservation holds (u = 0 and the
    masked diffusive flux carry nothing through walls) and a uniform
    tracer stays uniform."""
    mesh, _, prog = channel_setup
    c0 = np.asarray(total_tracer_content(prog.tracers, prog.layer_thickness, mesh))
    out = ocn_run_loop(prog, mesh, DT, 20, tracer_kappa=5.0)
    c1 = np.asarray(total_tracer_content(out.tracers, out.layer_thickness, mesh))
    np.testing.assert_allclose(c1, c0, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(out.tracers[:, 1]), 35.0, rtol=1e-10)


def test_channel_roll_parity(channel_setup, hex16):
    from mpas_ocean.structured.model import StructuredModel

    mesh, keep, prog = channel_setup
    sm = StructuredModel(mesh, 16, 16, parent_horz=hex16, keep_cells=keep)
    a = ocn_run_loop(prog, mesh, DT, 10, tracer_kappa=5.0)
    b = sm.from_struct(sm.run(sm.to_struct(prog), DT, 10, tracer_kappa=5.0))
    np.testing.assert_allclose(
        np.asarray(a.tracers), np.asarray(b.tracers), atol=2e-10
    )


def test_sharded_parity(tracer_setup):
    from mpas_ocean.parallel.shard_step import ShardedModel

    mesh, prog = tracer_setup
    sm = ShardedModel(mesh, devices=jax.devices())
    for kwargs in (dict(tracer_kappa=5.0),
                   dict(method=RungeKutta4, tracer_kappa=5.0),
                   dict(nonlinear=True, tracer_kappa=5.0)):
        a = ocn_run_loop(prog, mesh, DT, 6, **kwargs)
        b = sm.gather(sm.run(sm.scatter(prog), DT, 6, **kwargs))
        np.testing.assert_allclose(
            np.asarray(a.tracers), np.asarray(b.tracers), atol=1e-12
        )


def test_structured_sharded_parity(tracer_setup):
    from mpas_ocean.structured.model import StructuredModel
    from mpas_ocean.structured.sharded import ShardedStructuredModel

    mesh, prog = tracer_setup
    sm = StructuredModel(mesh, 16, 16)
    st = sm.to_struct(prog)
    ref = sm.run(st, DT, 6, tracer_kappa=5.0)
    for overlap in (False, True):
        ssm = ShardedStructuredModel(
            sm.struct_mesh, devices=jax.devices(), overlap=overlap
        )
        out = ssm.gather(ssm.run(ssm.scatter(st), DT, 6, tracer_kappa=5.0))
        np.testing.assert_allclose(
            np.asarray(ref.tracers), np.asarray(out.tracers), atol=1e-12
        )
    # nonlinear (derived-field round carries the flux the tracer step reads)
    ref_nl = sm.run(st, DT, 6, nonlinear=True, tracer_kappa=5.0)
    ssm = ShardedStructuredModel(sm.struct_mesh, devices=jax.devices())
    out_nl = ssm.gather(
        ssm.run(ssm.scatter(st), DT, 6, nonlinear=True, tracer_kappa=5.0)
    )
    np.testing.assert_allclose(
        np.asarray(ref_nl.tracers), np.asarray(out_nl.tracers), atol=1e-12
    )


def test_tracer_gradient_vs_fd(tracer_setup):
    """jax.grad of a tracer-based objective through the rollout matches
    central finite differences (the tier the reference runs through Enzyme
    for its ssh objective, test/enzyme/test_Enzyme_end2end.jl)."""
    mesh, prog = tracer_setup

    def objective(tr0):
        p = prog.replace(tracers=tr0)
        out = ocn_run_loop(p, mesh, DT, 5, tracer_kappa=5.0)
        return jnp.sum(out.tracers[:, 0] ** 2)

    g = jax.grad(objective)(prog.tracers)
    eps = 1e-4
    rng = np.random.default_rng(3)
    for _ in range(3):
        i = rng.integers(prog.tracers.shape[0])
        basis = np.zeros(prog.tracers.shape)
        basis[i, 0, 1] = 1.0
        fp = objective(prog.tracers + eps * basis)
        fm = objective(prog.tracers - eps * basis)
        fd = (float(fp) - float(fm)) / (2 * eps)
        np.testing.assert_allclose(float(g[i, 0, 1]), fd, rtol=1e-6, atol=1e-10)


def test_driver_tracer_config(tmp_path):
    """Config-driven tracers end to end: namelist `tracer_transport` section
    -> initial T/S read from the input stream -> advected in the rollout ->
    written to the output stream; a restart continues them exactly."""
    import shutil

    from mpas_ocean.forward.driver import ocn_run
    from mpas_ocean.infra.netcdf import read_netcdf
    from mpas_ocean.tools import make_igw_case

    case = tmp_path / "tracer_case"
    cfg = make_igw_case(case, nx=16, resolution_km=200.0,
                        duration_seconds=2000, tracers=True,
                        tracer_del2=10.0)
    setup, prog = ocn_run(cfg)
    assert setup.tracer_names == ("temperature", "salinity")
    assert setup.tracer_kappa == 10.0
    assert prog.tracers is not None and prog.tracers.shape[1] == 2
    np.testing.assert_allclose(np.asarray(prog.tracers[:, 1]), 35.0, rtol=1e-9)
    out = read_netcdf(str(case / "output.nc"))
    assert "temperature" in out and "salinity" in out
    np.testing.assert_allclose(
        np.asarray(out["temperature"][0]),
        np.asarray(prog.tracers[:, 0]),
        atol=1e-12,
    )

    # restart: half-run output feeds the restart stream; T/S continue
    shutil.copy(case / "output.nc", case / "restart.nc")
    cfg2 = make_igw_case(case, nx=16, resolution_km=200.0,
                         duration_seconds=4000, tracers=True,
                         tracer_del2=10.0)
    _, prog_full = ocn_run(cfg2)
    cfg3 = make_igw_case(case, nx=16, resolution_km=200.0,
                         duration_seconds=2000, tracers=True,
                         tracer_del2=10.0)
    text = open(cfg3).read().replace(
        "config_do_restart: false", "config_do_restart: true"
    )
    open(cfg3, "w").write(text)
    _, prog_restart = ocn_run(cfg3)
    np.testing.assert_allclose(
        np.asarray(prog_restart.tracers), np.asarray(prog_full.tracers),
        atol=1e-12,
    )


def test_driver_ad_writes_tracer_shadows(tmp_path):
    from mpas_ocean.forward.driver import ocn_run_with_ad
    from mpas_ocean.infra.netcdf import read_netcdf
    from mpas_ocean.tools import make_igw_case

    case = tmp_path / "tracer_ad_case"
    cfg = make_igw_case(case, nx=16, resolution_km=200.0,
                        duration_seconds=2000, tracers=True)
    _, final, d_prog, _ = ocn_run_with_ad(cfg, use_config_dt=True)
    out = read_netcdf(str(case / "output.nc"))
    assert "d_temperature" in out and "d_salinity" in out
    np.testing.assert_allclose(
        np.asarray(out["d_temperature"][0]),
        np.asarray(d_prog.tracers[:, 0]),
        atol=1e-12,
    )


def test_gradient_through_velocity(tracer_setup):
    """The tracer objective is sensitive to the FLOW: d(tracer RMS)/du0
    exists and matches FD — gradients flow through the sign() upwinding
    (piecewise-constant, zero derivative) without NaNs."""
    mesh, prog = tracer_setup

    def objective(u0):
        p = prog.replace(normal_velocity=u0)
        out = ocn_run_loop(p, mesh, DT, 5)
        return jnp.sum(out.tracers[:, 0] ** 2)

    g = jax.grad(objective)(prog.normal_velocity)
    assert np.all(np.isfinite(np.asarray(g)))
    eps = 1e-5
    i = 37
    basis = np.zeros(prog.normal_velocity.shape)
    basis[i, 0] = 1.0
    fd = (float(objective(prog.normal_velocity + eps * basis))
          - float(objective(prog.normal_velocity - eps * basis))) / (2 * eps)
    np.testing.assert_allclose(float(g[i, 0]), fd, rtol=1e-5, atol=1e-8)


def test_monitor_with_vector_tracer_metric(tracer_setup, tmp_path):
    """Two-tracer monitored runs: the (n, nT) tracer_content series flattens
    to one scalar column per tracer in the JSONL records (review finding:
    float() on the vector crashed the monitor at end of run)."""
    import json

    from mpas_ocean.forward.run_loop import ocn_run_loop_with_monitor
    from mpas_ocean.infra.monitor import check_health, write_jsonl

    mesh, prog = tracer_setup
    _, series = ocn_run_loop_with_monitor(prog, mesh, DT, 6, 3)
    path = tmp_path / "mon.jsonl"
    write_jsonl(path, jax.tree.map(np.asarray, series), DT, 3)
    recs = [json.loads(l) for l in open(path)]
    assert len(recs) == 2
    assert "tracer_content_0" in recs[0] and "tracer_content_1" in recs[0]
    # content conserved across samples
    np.testing.assert_allclose(
        recs[0]["tracer_content_1"], recs[1]["tracer_content_1"], rtol=1e-12
    )
    assert check_health(jax.tree.map(np.asarray, series)) == []


def test_monitor_reports_total_blowup():
    """A series that is NaN from the first sample must be reported (review
    finding: the all-NaN skip meant a full blow-up looked healthy)."""
    from mpas_ocean.infra.monitor import check_health

    series = {
        "volume": np.array([np.nan, np.nan]),
        "max_abs_u": np.array([np.nan, np.nan]),
        "pot_enstrophy": np.array([np.nan, np.nan]),  # deliberate placeholder
    }
    warnings = check_health(series)
    assert any("volume" in w for w in warnings)
    assert any("max_abs_u" in w for w in warnings)
    assert not any("pot_enstrophy" in w for w in warnings)
