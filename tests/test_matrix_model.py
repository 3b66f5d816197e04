"""BSR matrix formulation must agree with the gather-based operators and the
gather-based rollout (f64 on CPU, so agreement is to roundoff)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpas_ocean import ops
from mpas_ocean.forward.run_loop import ocn_run_loop
from mpas_ocean.mesh import planar_hex_mesh
from mpas_ocean.mesh.mesh import Mesh
from mpas_ocean.mesh.vert_mesh import make_vertical_mesh
from mpas_ocean.models.matrix_model import MatrixModel, matrix_run_loop
from mpas_ocean.models.shallow_water import PrognosticVars
from mpas_ocean.ops.bsr import bsr_matvec, trisk_matrices

NX = NY = 16
K = 3


@pytest.fixture(scope="module")
def setup():
    horz = planar_hex_mesh(NX, NY, 1000.0, f0=1e-4, beta=1e-11)
    vert = make_vertical_mesh(
        horz, n_vert_levels=K, resting_thickness=np.full((horz.n_cells, K), 10.0)
    )
    mesh = Mesh(horz=horz, vert=vert).to_device()

    rng = np.random.default_rng(3)
    h = np.full((horz.n_cells, K), 10.0) + 0.01 * rng.normal(size=(horz.n_cells, K))
    u = 0.01 * rng.normal(size=(horz.n_edges, K))
    ssh = h.sum(1) - np.asarray(vert.resting_thickness_sum)
    prog = PrognosticVars(
        ssh=jnp.asarray(ssh),
        layer_thickness=jnp.asarray(h),
        normal_velocity=jnp.asarray(u),
    )
    return mesh, prog


def test_bsr_operators_match_gather_operators(setup):
    mesh, prog = setup
    mats = trisk_matrices(mesh, dtype=np.float64)
    u, h = prog.normal_velocity, prog.layer_thickness

    np.testing.assert_allclose(
        np.asarray(bsr_matvec(mats["grad"], prog.ssh)),
        np.asarray(ops.gradient_on_edge(prog.ssh, mesh)),
        atol=1e-12,
    )
    np.testing.assert_allclose(
        np.asarray(bsr_matvec(mats["c2e"], h)),
        np.asarray(ops.interpolate_cell_to_edge(h, mesh)),
        atol=1e-12,
    )
    np.testing.assert_allclose(
        np.asarray(bsr_matvec(mats["div"], u)),
        np.asarray(ops.divergence_on_cell(u, mesh)),
        atol=1e-15,
    )
    np.testing.assert_allclose(
        np.asarray(bsr_matvec(mats["curl"], u)),
        np.asarray(ops.curl_on_vertex(u, mesh)),
        atol=1e-15,
    )
    f = mesh.horz.edges.f
    np.testing.assert_allclose(
        np.asarray(bsr_matvec(mats["corf"], u)),
        np.asarray(ops.tangential_reconstruction(u * f[:, None], mesh)),
        atol=1e-15,
    )


def test_matrix_rollout_matches_gather_rollout(setup):
    mesh, prog = setup
    mm = MatrixModel.from_mesh(mesh, dtype=np.float64)
    n = 10
    ref = ocn_run_loop(prog, mesh, 10.0, n)
    out = matrix_run_loop(prog, mm, 10.0, n)
    np.testing.assert_allclose(
        np.asarray(out.ssh), np.asarray(ref.ssh), atol=1e-11
    )
    np.testing.assert_allclose(
        np.asarray(out.layer_thickness),
        np.asarray(ref.layer_thickness),
        atol=1e-12,
    )
    np.testing.assert_allclose(
        np.asarray(out.normal_velocity),
        np.asarray(ref.normal_velocity),
        atol=1e-13,
    )


def test_matrix_rollout_differentiable(setup):
    mesh, prog = setup
    mm = MatrixModel.from_mesh(mesh, dtype=np.float64)

    def obj(p):
        out = matrix_run_loop(p, mm, 10.0, 3)
        return jnp.sum(out.ssh**2)

    g = jax.grad(obj)(prog)
    assert all(np.isfinite(np.asarray(x)).all() for x in jax.tree.leaves(g))
    assert float(jnp.abs(g.layer_thickness).max()) > 0


def test_matrix_rollout_on_sphere_matches_gather():
    """The matrix path must work on non-planar, variable-metric meshes."""
    from mpas_ocean.mesh.sphere import spherical_mesh

    horz = spherical_mesh(4)  # 162 cells
    vert = make_vertical_mesh(
        horz, n_vert_levels=1,
        resting_thickness=np.full((horz.n_cells, 1), 1000.0),
    )
    mesh = Mesh(horz=horz, vert=vert).to_device()
    rng = np.random.default_rng(11)
    h = np.full((horz.n_cells, 1), 1000.0) + rng.normal(size=(horz.n_cells, 1))
    u = 0.1 * rng.normal(size=(horz.n_edges, 1))
    prog = PrognosticVars(
        ssh=jnp.asarray(h.sum(1) - np.asarray(vert.resting_thickness_sum)),
        layer_thickness=jnp.asarray(h),
        normal_velocity=jnp.asarray(u),
    )
    mm = MatrixModel.from_mesh(mesh, dtype=np.float64)
    n = 5
    ref = ocn_run_loop(prog, mesh, 30.0, n)
    out = matrix_run_loop(prog, mm, 30.0, n)
    np.testing.assert_allclose(np.asarray(out.ssh), np.asarray(ref.ssh), atol=1e-10)
    np.testing.assert_allclose(
        np.asarray(out.normal_velocity),
        np.asarray(ref.normal_velocity),
        atol=1e-13,
    )


def test_matrix_del2_fold_matches_gather_del2(setup):
    """del2 folded into the Coriolis matrix == the gather path's repaired
    del2 tendency chain (f64)."""
    from mpas_ocean.forward.time_integration import forward_euler_step

    mesh, prog = setup
    nu = 50.0
    mm = MatrixModel.from_mesh(mesh, dtype=np.float64, del2_coeff=nu)
    out = matrix_run_loop(prog, mm, 10.0, 5)
    ref = prog
    for _ in range(5):
        ref = forward_euler_step(ref, mesh, 10.0, del2_coeff=nu)
    np.testing.assert_allclose(
        np.asarray(out.normal_velocity),
        np.asarray(ref.normal_velocity),
        atol=1e-13,
    )
    np.testing.assert_allclose(np.asarray(out.ssh), np.asarray(ref.ssh), atol=1e-11)


def test_del2_variable_bathymetry_paths_agree():
    """On a variable-bathymetry mesh (max_level_cell < K for some cells) the
    gather del2 must be level-masked: inactive edge-levels stay at exactly
    zero velocity and the gather and folded-matrix paths agree to roundoff."""
    from mpas_ocean.forward.time_integration import forward_euler_step

    horz = planar_hex_mesh(NX, NY, 1000.0, f0=1e-4)
    rng = np.random.default_rng(7)
    max_lc = rng.integers(1, K + 1, size=horz.n_cells).astype(np.int32)
    vert = make_vertical_mesh(
        horz,
        n_vert_levels=K,
        resting_thickness=np.full((horz.n_cells, K), 10.0),
        max_level_cell=max_lc,
    )
    mesh = Mesh(horz=horz, vert=vert).to_device()
    elm = np.asarray(vert.edge_level_mask)
    clm = np.asarray(vert.cell_level_mask)

    h = (np.full((horz.n_cells, K), 10.0)
         + 0.01 * rng.normal(size=(horz.n_cells, K))) * clm
    u = 0.01 * rng.normal(size=(horz.n_edges, K)) * elm
    prog = PrognosticVars(
        ssh=jnp.asarray((h * clm).sum(1) - np.asarray(vert.resting_thickness_sum)),
        layer_thickness=jnp.asarray(h),
        normal_velocity=jnp.asarray(u),
    )

    nu = 50.0
    ref = prog
    for _ in range(5):
        ref = forward_euler_step(ref, mesh, 10.0, del2_coeff=nu)
    # inactive edge-levels never accelerate
    u_fin = np.asarray(ref.normal_velocity)
    np.testing.assert_allclose(u_fin[elm == 0], 0.0, atol=0.0)

    mm = MatrixModel.from_mesh(mesh, dtype=np.float64, del2_coeff=nu)
    out = matrix_run_loop(prog, mm, 10.0, 5)
    np.testing.assert_allclose(
        np.asarray(out.normal_velocity), u_fin, atol=1e-13
    )
    np.testing.assert_allclose(np.asarray(out.ssh), np.asarray(ref.ssh), atol=1e-11)


def test_matrix_rk4_matches_gather_rk4(setup):
    from mpas_ocean.forward.time_integration import rk4_step

    mesh, prog = setup
    mm = MatrixModel.from_mesh(mesh, dtype=np.float64)
    out = matrix_run_loop(prog, mm, 10.0, 3, rk4=True)
    ref = prog
    for _ in range(3):
        ref = rk4_step(ref, mesh, 10.0)
    np.testing.assert_allclose(
        np.asarray(out.normal_velocity),
        np.asarray(ref.normal_velocity),
        atol=1e-13,
    )
    np.testing.assert_allclose(np.asarray(out.ssh), np.asarray(ref.ssh), atol=1e-11)
