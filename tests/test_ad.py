"""Adjoint tests: jax.grad vs central finite differences.

Mirrors the reference's Enzyme test tier (reference:
test/enzyme/test_Enzyme_Operators.jl — per-operator reverse/forward AD vs FD
at atol 1e-6 — and test/enzyme/test_Enzyme_end2end.jl — d(sum ssh^2)/d(state0)
through the full rollout at atol 1e-4/1e-2)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpas_ocean.forward.run_loop import ocn_run_loop_objective
from mpas_ocean.models.shallow_water import PrognosticVars
from mpas_ocean.ops import divergence_on_cell, gradient_on_edge
from mpas_ocean.verification.inertial_gravity_wave import InertialGravityWave


def _directional_fd(fn, x, v, eps):
    return (fn(x + eps * v) - fn(x - eps * v)) / (2 * eps)


@pytest.mark.parametrize("op_name", ["gradient", "divergence"])
def test_operator_adjoint_vs_fd(mesh16, op_name):
    """Reverse-mode gradient of a scalarized operator output matches central
    finite differences (reference atol 1e-6,
    test_Enzyme_Operators.jl:127,221)."""
    rng = np.random.default_rng(3)
    if op_name == "gradient":
        x = jnp.asarray(rng.normal(size=(mesh16.n_cells, 1)))
        w = jnp.asarray(rng.normal(size=(mesh16.n_edges, 1)))
        fn = lambda a: jnp.sum(gradient_on_edge(a, mesh16) * w)
    else:
        x = jnp.asarray(rng.normal(size=(mesh16.n_edges, 1)))
        w = jnp.asarray(rng.normal(size=(mesh16.n_cells, 1)))
        fn = lambda a: jnp.sum(divergence_on_cell(a, mesh16) * w)

    g = jax.grad(fn)(x)
    v = jnp.asarray(rng.normal(size=x.shape))
    fd = _directional_fd(fn, x, v, 1e-5)
    ad = jnp.sum(g * v)
    assert float(abs(ad - fd)) < 1e-6 * max(1.0, float(abs(fd)))


def test_operator_jvp_vs_fd(mesh16):
    """Forward mode too (the reference's forward Enzyme tests are partially
    broken, SURVEY section 0.5 — ours must work)."""
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.normal(size=(mesh16.n_cells, 1)))
    v = jnp.asarray(rng.normal(size=(mesh16.n_cells, 1)))
    f = lambda a: gradient_on_edge(a, mesh16)
    _, jv = jax.jvp(f, (x,), (v,))
    fd = (f(x + 1e-6 * v) - f(x - 1e-6 * v)) / 2e-6
    np.testing.assert_allclose(np.asarray(jv), np.asarray(fd), atol=1e-6)


@pytest.fixture(scope="module")
def igw_small(igw_mesh):
    igw = InertialGravityWave()
    ssh, h, u = igw.initial_state(igw_mesh)
    prog = PrognosticVars(
        ssh=jnp.asarray(ssh),
        layer_thickness=jnp.asarray(h),
        normal_velocity=jnp.asarray(u),
    )
    return prog


def test_end2end_gradient_vs_fd(igw_mesh, igw_small):
    """d(sum ssh^2)/d(layerThickness0, normalVelocity0) through an N-step
    rollout vs central FD (reference: test_Enzyme_end2end.jl:113-180,
    atol 1e-4 for d/dh and 1e-2 for d/du; directional-derivative form)."""
    prog = igw_small
    dt, n = 600.0, 5

    def obj(h0, u0):
        p = PrognosticVars(
            ssh=h0[:, 0] - igw_mesh.vert.resting_thickness_sum,
            layer_thickness=h0,
            normal_velocity=u0,
        )
        return ocn_run_loop_objective(p, igw_mesh, dt, n)

    gh, gu = jax.grad(obj, argnums=(0, 1))(
        prog.layer_thickness, prog.normal_velocity
    )
    assert np.isfinite(np.asarray(gh)).all()
    assert np.isfinite(np.asarray(gu)).all()

    rng = np.random.default_rng(5)
    vh = jnp.asarray(rng.normal(size=gh.shape))
    vu = jnp.asarray(rng.normal(size=gu.shape))

    eps = 1e-4
    fd_h = (
        obj(prog.layer_thickness + eps * vh, prog.normal_velocity)
        - obj(prog.layer_thickness - eps * vh, prog.normal_velocity)
    ) / (2 * eps)
    fd_u = (
        obj(prog.layer_thickness, prog.normal_velocity + eps * vu)
        - obj(prog.layer_thickness, prog.normal_velocity - eps * vu)
    ) / (2 * eps)

    ad_h = float(jnp.sum(gh * vh))
    ad_u = float(jnp.sum(gu * vu))
    assert ad_h == pytest.approx(float(fd_h), rel=1e-5)
    assert ad_u == pytest.approx(float(fd_u), rel=1e-5)


def test_gradient_through_rk4(igw_mesh, igw_small):
    from mpas_ocean.forward.time_integration import RungeKutta4

    g = jax.grad(
        lambda p: ocn_run_loop_objective(p, igw_mesh, 600.0, 3, RungeKutta4)
    )(igw_small)
    assert np.isfinite(np.asarray(g.normal_velocity)).all()
    assert float(jnp.linalg.norm(g.normal_velocity)) > 0
