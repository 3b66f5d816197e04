"""Forward-backward stepper tests (time_integration.ForwardBackward).

The scheme: h (and tracers) advance with the old flux, then u against the
NEW pressure gradient — neutrally stable for gravity waves (CFL ~ 2) where
the reference's only live stepper, plain forward Euler, is unconditionally
weakly unstable (reference: time_integration.jl:150-193)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpas_ocean.forward.run_loop import ocn_run_loop
from mpas_ocean.forward.time_integration import ForwardBackward
from mpas_ocean.mesh import planar_hex_mesh
from mpas_ocean.mesh.mesh import Mesh
from mpas_ocean.mesh.vert_mesh import make_vertical_mesh
from mpas_ocean.models.shallow_water import PrognosticVars, update_ssh
from mpas_ocean.models.stratification import make_stratification
from mpas_ocean.models.tracers import make_tracers

K = 2
DT = 10.0


@pytest.fixture(scope="module")
def fb_setup(hex16):
    vert = make_vertical_mesh(hex16, n_vert_levels=K)
    mesh = Mesh(horz=hex16, vert=vert).to_device()
    rng = np.random.default_rng(2)
    nc, ne = hex16.n_cells, hex16.n_edges
    h0 = np.asarray(vert.resting_thickness) + 0.05 * rng.standard_normal((nc, K))
    u0 = 0.05 * rng.standard_normal((ne, K))
    x = np.asarray(hex16.cells.x)
    tr = make_tracers(mesh, [10.0 + np.sin(2 * np.pi * x / (x.max() + 1)),
                             35.0 + 0.0 * x])
    prog = PrognosticVars(
        ssh=update_ssh(jnp.asarray(h0), mesh),
        layer_thickness=jnp.asarray(h0),
        normal_velocity=jnp.asarray(u0),
        tracers=tr,
    )
    return mesh, prog, make_stratification([1025.0, 1026.0])


@pytest.mark.parametrize("nonlinear", [False, True])
def test_fb_path_parity(fb_setup, nonlinear):
    """All four execution paths compute the same forward-backward physics
    (with tracers + stratification in play) at f64 roundoff."""
    from mpas_ocean.models.matrix_model import MatrixModel, matrix_run_loop
    from mpas_ocean.parallel.shard_step import ShardedModel
    from mpas_ocean.structured.model import StructuredModel

    mesh, prog, strat = fb_setup
    kw = dict(nonlinear=nonlinear, tracer_kappa=5.0, strat=strat)
    a = ocn_run_loop(prog, mesh, DT, 8, method=ForwardBackward, **kw)
    mm = MatrixModel.from_mesh(mesh, dtype=np.float64, nonlinear=nonlinear)
    b = matrix_run_loop(prog, mm, DT, 8, fb=True, **kw)
    sm = StructuredModel(mesh, 16, 16)
    st = sm.to_struct(prog)
    c = sm.from_struct(sm.run(st, DT, 8, fb=True, **kw))
    smd = ShardedModel(mesh, devices=jax.devices())
    e = smd.gather(
        smd.run(smd.scatter(prog), DT, 8, method=ForwardBackward, **kw)
    )
    for out in (b, c, e):
        np.testing.assert_allclose(
            np.asarray(a.normal_velocity), np.asarray(out.normal_velocity),
            atol=1e-13,
        )
        np.testing.assert_allclose(
            np.asarray(a.tracers), np.asarray(out.tracers), atol=1e-12
        )


def test_fb_gravity_wave_stability():
    """Pure gravity waves (f = 0): forward Euler blows up at CFL 0.3 within
    2000 steps; forward-backward stays bounded at CFL 0.7 — the scheme's
    whole point."""
    nx, dc, H = 32, 10000.0e3 / 32, 1000.0
    horz = planar_hex_mesh(nx, nx, dc, f0=0.0)
    vert = make_vertical_mesh(
        horz, n_vert_levels=1, resting_thickness=np.full((horz.n_cells, 1), H)
    )
    mesh = Mesh(horz=horz, vert=vert).to_device()
    x = np.asarray(horz.cells.x)
    ssh0 = np.sin(2 * np.pi * x / (nx * dc))
    prog = PrognosticVars(
        ssh=jnp.asarray(ssh0),
        layer_thickness=jnp.asarray((H + ssh0)[:, None]),
        normal_velocity=jnp.zeros((horz.n_edges, 1)),
    )
    c = np.sqrt(9.80616 * H)
    fe = ocn_run_loop(prog, mesh, 0.3 * dc / c, 2000)
    fb = ocn_run_loop(prog, mesh, 0.7 * dc / c, 2000, method=ForwardBackward)
    assert not np.isfinite(np.asarray(fe.ssh)).all()  # FE diverged
    assert np.isfinite(np.asarray(fb.ssh)).all()
    assert float(jnp.max(jnp.abs(fb.ssh))) < 2.0  # bounded (init amp 1)


def test_fb_conserves_volume_and_tracer_content(fb_setup):
    from mpas_ocean.models.tracers import total_tracer_content

    mesh, prog, _ = fb_setup
    area = mesh.cells.area_cell
    v0 = float(jnp.sum(prog.layer_thickness.sum(1) * area))
    c0 = np.asarray(total_tracer_content(prog.tracers, prog.layer_thickness, mesh))
    out = ocn_run_loop(prog, mesh, DT, 20, method=ForwardBackward,
                       tracer_kappa=5.0)
    v1 = float(jnp.sum(out.layer_thickness.sum(1) * area))
    c1 = np.asarray(total_tracer_content(out.tracers, out.layer_thickness, mesh))
    np.testing.assert_allclose(v1, v0, rtol=1e-13)
    np.testing.assert_allclose(c1, c0, rtol=1e-12)


def test_fb_gradient(fb_setup):
    mesh, prog, strat = fb_setup

    def obj(p):
        out = ocn_run_loop(p, mesh, DT, 5, method=ForwardBackward,
                           strat=strat)
        return jnp.sum(out.ssh ** 2)

    g = jax.grad(obj)(prog)
    assert np.all(np.isfinite(np.asarray(g.normal_velocity)))
    eps, i = 1e-5, 23
    basis = np.zeros(prog.normal_velocity.shape)
    basis[i, 0] = 1.0
    fd = (float(obj(prog.replace(normal_velocity=prog.normal_velocity + eps * basis)))
          - float(obj(prog.replace(normal_velocity=prog.normal_velocity - eps * basis)))) / (2 * eps)
    np.testing.assert_allclose(float(g.normal_velocity[i, 0]), fd,
                               rtol=1e-5, atol=1e-8)


def test_fb_driver_config(tmp_path):
    """config_time_integrator: ForwardBackward runs end to end."""
    from mpas_ocean.forward.driver import ocn_run
    from mpas_ocean.forward.time_integration import ForwardBackward as FB
    from mpas_ocean.tools import make_igw_case

    case = tmp_path / "fb_case"
    cfg = make_igw_case(case, nx=16, resolution_km=200.0,
                        duration_seconds=2000, integrator="ForwardBackward")
    setup, prog = ocn_run(cfg)
    assert setup.integrator is FB
    assert np.isfinite(np.asarray(prog.ssh)).all()
