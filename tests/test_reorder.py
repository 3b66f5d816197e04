"""Mesh renumbering (RCM cells + locality-sorted edges/vertices) must be
exactly equivariant, and must shrink the BSR footprint on irregular meshes."""

import jax.numpy as jnp
import numpy as np
import pytest

from mpas_ocean import ops
from mpas_ocean.forward.run_loop import ocn_run_loop
from mpas_ocean.mesh import planar_hex_mesh
from mpas_ocean.mesh.mesh import Mesh
from mpas_ocean.mesh.reorder import rcm_reorder
from mpas_ocean.mesh.sphere import spherical_mesh
from mpas_ocean.mesh.vert_mesh import make_vertical_mesh
from mpas_ocean.models.shallow_water import PrognosticVars
from mpas_ocean.ops.bsr import trisk_matrices


@pytest.fixture(scope="module")
def meshes():
    horz = planar_hex_mesh(16, 16, 1000.0, f0=1e-4)
    new, perm = rcm_reorder(horz)
    v0 = make_vertical_mesh(horz, 2)
    v1 = make_vertical_mesh(new, 2)
    return Mesh(horz=horz, vert=v0), Mesh(horz=new, vert=v1), perm


def test_operator_equivariance(meshes):
    m0, m1, perm = meshes
    rng = np.random.default_rng(0)
    u = rng.normal(size=(m0.n_edges, 2))
    h = rng.normal(size=(m0.n_cells, 2))

    d0 = np.asarray(ops.divergence_on_cell(jnp.asarray(u), m0))
    d1 = np.asarray(
        ops.divergence_on_cell(jnp.asarray(u[perm.edge_order]), m1)
    )
    np.testing.assert_array_equal(d1, d0[perm.cell_order])

    t0 = np.asarray(ops.tangential_reconstruction(jnp.asarray(u), m0))
    t1 = np.asarray(
        ops.tangential_reconstruction(jnp.asarray(u[perm.edge_order]), m1)
    )
    np.testing.assert_array_equal(t1, t0[perm.edge_order])

    g0 = np.asarray(ops.gradient_on_edge(jnp.asarray(h[:, 0]), m0))
    g1 = np.asarray(
        ops.gradient_on_edge(jnp.asarray(h[perm.cell_order, 0]), m1)
    )
    np.testing.assert_array_equal(g1, g0[perm.edge_order])

    c0 = np.asarray(ops.curl_on_vertex(jnp.asarray(u), m0))
    c1 = np.asarray(ops.curl_on_vertex(jnp.asarray(u[perm.edge_order]), m1))
    np.testing.assert_array_equal(c1, c0[perm.vertex_order])


def test_rollout_equivariance(meshes):
    m0, m1, perm = meshes
    rng = np.random.default_rng(1)
    h = 10.0 + 0.01 * rng.normal(size=(m0.n_cells, 2))
    u = 0.01 * rng.normal(size=(m0.n_edges, 2))
    rts = np.asarray(m0.vert.resting_thickness_sum)

    p0 = PrognosticVars(
        ssh=jnp.asarray(h.sum(1) - rts),
        layer_thickness=jnp.asarray(h),
        normal_velocity=jnp.asarray(u),
    )
    p1 = PrognosticVars(
        ssh=jnp.asarray((h.sum(1) - rts)[perm.cell_order]),
        layer_thickness=jnp.asarray(h[perm.cell_order]),
        normal_velocity=jnp.asarray(u[perm.edge_order]),
    )
    r0 = ocn_run_loop(p0, m0, 5.0, 5)
    r1 = ocn_run_loop(p1, m1, 5.0, 5)
    np.testing.assert_allclose(
        np.asarray(r1.ssh), np.asarray(r0.ssh)[perm.cell_order], atol=1e-13
    )
    np.testing.assert_allclose(
        np.asarray(r1.normal_velocity),
        np.asarray(r0.normal_velocity)[perm.edge_order],
        atol=1e-15,
    )


def test_rcm_shrinks_sphere_bsr():
    sph = spherical_mesh(6)  # 362 cells
    new, _ = rcm_reorder(sph)

    def total_bytes(horz):
        vert = make_vertical_mesh(horz, 1)
        mats = trisk_matrices(Mesh(horz=horz, vert=vert))
        return sum(m.nbytes for m in mats.values())

    assert total_bytes(new) < total_bytes(sph)
