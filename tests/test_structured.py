"""Structured hex fast path must agree with the unstructured reference path
to machine precision — operators and full rollouts."""

import jax.numpy as jnp
import numpy as np
import pytest

from mpas_ocean import ops
from mpas_ocean.forward.run_loop import ocn_run_loop
from mpas_ocean.mesh import planar_hex_mesh
from mpas_ocean.mesh.mesh import Mesh
from mpas_ocean.mesh.vert_mesh import make_vertical_mesh
from mpas_ocean.models.shallow_water import PrognosticVars
from mpas_ocean.structured import StructuredModel
from mpas_ocean.structured import model as SM

NX = NY = 16
K = 3


@pytest.fixture(scope="module")
def setup():
    horz = planar_hex_mesh(NX, NY, 1000.0, f0=1e-4, beta=1e-11)
    vert = make_vertical_mesh(
        horz, n_vert_levels=K, resting_thickness=np.full((horz.n_cells, K), 10.0)
    )
    mesh = Mesh(horz=horz, vert=vert).to_device()
    sm = StructuredModel(mesh, NX, NY)

    rng = np.random.default_rng(0)
    h = np.full((horz.n_cells, K), 10.0) + 0.01 * rng.normal(
        size=(horz.n_cells, K)
    )
    u = 0.01 * rng.normal(size=(horz.n_edges, K))
    ssh = h.sum(1) - np.asarray(vert.resting_thickness_sum)
    prog = PrognosticVars(
        ssh=jnp.asarray(ssh),
        layer_thickness=jnp.asarray(h),
        normal_velocity=jnp.asarray(u),
    )
    return mesh, sm, prog


def test_roundtrip(setup):
    mesh, sm, prog = setup
    back = sm.from_struct(sm.to_struct(prog))
    np.testing.assert_array_equal(np.asarray(back.ssh), np.asarray(prog.ssh))
    np.testing.assert_array_equal(
        np.asarray(back.normal_velocity), np.asarray(prog.normal_velocity)
    )


def test_operator_equivalence(setup):
    mesh, sm, prog = setup
    st = sm.to_struct(prog)
    lay = sm.layout
    m = sm.struct_mesh

    grad_u = np.asarray(ops.gradient_on_edge(prog.layer_thickness, mesh))
    grad_s = lay.edges_from_struct(
        np.asarray(SM.grad_on_edge(st.layer_thickness, m)), sign=True
    )
    np.testing.assert_allclose(grad_u, grad_s, atol=1e-15)

    div_u = np.asarray(ops.divergence_on_cell(prog.normal_velocity, mesh))
    div_s = lay.cells_from_struct(np.asarray(SM.div_on_cell(st.normal_velocity, m)))
    np.testing.assert_allclose(div_u, div_s, atol=1e-15)

    curl_u = np.asarray(ops.curl_on_vertex(prog.normal_velocity, mesh))
    curl_s = lay.vertices_from_struct(
        np.asarray(SM.curl_on_vertex(st.normal_velocity, m))
    )
    np.testing.assert_allclose(curl_u, curl_s, atol=1e-13)

    f_e = np.asarray(mesh.edges.f)[:, None]
    cor_u = np.asarray(
        ops.tangential_reconstruction(prog.normal_velocity * f_e, mesh)
    )
    cor_s = lay.edges_from_struct(
        np.asarray(SM.tangential_times_f(st.normal_velocity, m)), sign=True
    )
    np.testing.assert_allclose(cor_u, cor_s, atol=1e-16)


def test_rollout_equivalence(setup):
    mesh, sm, prog = setup
    ref = ocn_run_loop(prog, mesh, 5.0, 20)
    out = sm.from_struct(sm.run(sm.to_struct(prog), 5.0, 20))
    np.testing.assert_allclose(
        np.asarray(ref.ssh), np.asarray(out.ssh), atol=1e-13
    )
    np.testing.assert_allclose(
        np.asarray(ref.normal_velocity),
        np.asarray(out.normal_velocity),
        atol=1e-14,
    )
    np.testing.assert_allclose(
        np.asarray(ref.layer_thickness),
        np.asarray(out.layer_thickness),
        atol=1e-13,
    )


def test_rejects_non_hex_order():
    horz = planar_hex_mesh(8, 8, 1000.0)
    vert = make_vertical_mesh(horz, n_vert_levels=1)
    mesh = Mesh(horz=horz, vert=vert).to_device()
    with pytest.raises(ValueError):
        StructuredModel(mesh, 4, 16)  # wrong lattice dims


def test_rk4_rollout_equivalence(setup):
    """Roll-path RK4 (structured_rk4_step) matches the gather-path RK4
    stage for stage."""
    from mpas_ocean.forward.time_integration import RungeKutta4

    mesh, sm, prog = setup
    ref = ocn_run_loop(prog, mesh, 5.0, 10, method=RungeKutta4)
    out = sm.from_struct(sm.run(sm.to_struct(prog), 5.0, 10, rk4=True))
    np.testing.assert_allclose(
        np.asarray(ref.normal_velocity),
        np.asarray(out.normal_velocity),
        atol=1e-14,
    )
    np.testing.assert_allclose(
        np.asarray(ref.layer_thickness),
        np.asarray(out.layer_thickness),
        atol=1e-13,
    )


def test_rk4_nonlinear_rollout_equivalence(setup):
    from mpas_ocean.forward.time_integration import RungeKutta4

    mesh, sm, prog = setup
    ref = ocn_run_loop(prog, mesh, 5.0, 8, method=RungeKutta4, nonlinear=True)
    out = sm.from_struct(
        sm.run(sm.to_struct(prog), 5.0, 8, nonlinear=True, rk4=True)
    )
    np.testing.assert_allclose(
        np.asarray(ref.normal_velocity),
        np.asarray(out.normal_velocity),
        atol=1e-14,
    )
