"""Mesh-generator structural and geometric invariants."""

import numpy as np
import pytest

from mpas_ocean.mesh import planar_hex_mesh
from mpas_ocean.mesh.vert_mesh import make_vertical_mesh
from mpas_ocean.ops import tangential_reconstruction


def test_counts(hex16):
    n = 16 * 16
    assert hex16.n_cells == n
    assert hex16.n_edges == 3 * n
    assert hex16.n_vertices == 2 * n
    assert hex16.cells.max_edges == 6
    assert hex16.duals.vertex_degree == 3
    assert np.all(np.asarray(hex16.cells.n_edges_on_cell) == 6)
    assert np.all(np.asarray(hex16.edges.n_edges_on_edge) == 10)


def test_hex_geometry(hex16):
    dc = 1000.0
    np.testing.assert_allclose(
        np.asarray(hex16.cells.area_cell), np.sqrt(3) / 2 * dc**2, rtol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(hex16.duals.area_triangle), np.sqrt(3) / 4 * dc**2, rtol=1e-9
    )
    np.testing.assert_allclose(np.asarray(hex16.edges.dc_edge), dc, rtol=1e-12)
    np.testing.assert_allclose(
        np.asarray(hex16.edges.dv_edge), dc / np.sqrt(3), rtol=1e-9
    )
    # total area tiles the box exactly
    np.testing.assert_allclose(
        np.asarray(hex16.cells.area_cell).sum(), hex16.lx * hex16.ly, rtol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(hex16.duals.area_triangle).sum(), hex16.lx * hex16.ly, rtol=1e-9
    )


def test_kite_partitions(hex16):
    np.testing.assert_allclose(
        np.asarray(hex16.cells.kite_areas_on_cell).sum(1),
        np.asarray(hex16.cells.area_cell),
        rtol=1e-9,
    )
    np.testing.assert_allclose(
        np.asarray(hex16.duals.kite_areas_on_vertex).sum(1),
        np.asarray(hex16.duals.area_triangle),
        rtol=1e-9,
    )


def test_connectivity_consistency(hex16):
    coe = np.asarray(hex16.edges.cells_on_edge)
    eoc = np.asarray(hex16.cells.edges_on_cell)
    # every edge appears in both of its cells' edge lists
    for e in range(0, hex16.n_edges, 37):
        for c in coe[e]:
            assert e in eoc[c]
    # edge sign convention: -1 when the cell is cells_on_edge[0]
    sign = np.asarray(hex16.cells.edge_sign_on_cell)
    for c in range(0, hex16.n_cells, 17):
        for i, e in enumerate(eoc[c]):
            expect = -1.0 if coe[e, 0] == c else 1.0
            assert sign[c, i] == expect


def test_vertices_on_edge_orientation(hex16):
    """z_hat x normal must point from vertices_on_edge[0] to [1]."""
    voe = np.asarray(hex16.edges.vertices_on_edge)
    ang = np.asarray(hex16.edges.angle_edge)
    vx, vy = np.asarray(hex16.duals.x), np.asarray(hex16.duals.y)
    L = np.array([hex16.lx, hex16.ly])
    d = np.stack([vx[voe[:, 1]] - vx[voe[:, 0]], vy[voe[:, 1]] - vy[voe[:, 0]]], 1)
    d = d - L * np.round(d / L)
    t_hat = np.stack([-np.sin(ang), np.cos(ang)], 1)
    assert ((d * t_hat).sum(1) > 0).all()


def test_uniform_flow_tangential_reconstruction(hex16):
    """Thuburn weights must reconstruct a uniform flow's tangential
    component exactly on a uniform hex mesh."""
    ang = np.asarray(hex16.edges.angle_edge)
    V = np.array([3.0, -2.0])
    u = V[0] * np.cos(ang) + V[1] * np.sin(ang)
    t_exact = -V[0] * np.sin(ang) + V[1] * np.cos(ang)
    t_num = np.asarray(tangential_reconstruction(u[:, None], hex16))[:, 0]
    np.testing.assert_allclose(t_num, t_exact, atol=1e-12)


def test_coriolis_energy_neutrality(hex16):
    """TRiSK Coriolis does no work: sum_e A_e u_e (f u_perp)_e == 0 for
    constant f (the antisymmetry property of Ringler et al. 2010)."""
    rng = np.random.default_rng(0)
    u = rng.normal(size=hex16.n_edges)
    area_e = 0.5 * np.asarray(hex16.edges.dc_edge) * np.asarray(hex16.edges.dv_edge)
    f = np.asarray(hex16.edges.f)
    tend = np.asarray(tangential_reconstruction((u * f)[:, None], hex16))[:, 0]
    scale = np.sum(area_e * np.abs(u * tend))
    assert abs(np.sum(area_e * u * tend)) < 1e-12 * scale


def test_vertical_mesh_levels(hex16):
    vert = make_vertical_mesh(hex16, n_vert_levels=4)
    assert vert.n_vert_levels == 4
    assert np.all(np.asarray(vert.max_level_edge_top) == 4)
    assert np.all(np.asarray(vert.edge_level_mask) == 1.0)
    np.testing.assert_allclose(np.asarray(vert.resting_thickness_sum), 4.0)

    # partial column: one cell shallower
    max_lc = np.full(hex16.n_cells, 4, dtype=np.int32)
    max_lc[0] = 2
    vert = make_vertical_mesh(hex16, n_vert_levels=4, max_level_cell=max_lc)
    eoc = np.asarray(hex16.cells.edges_on_cell)[0]
    assert np.all(np.asarray(vert.max_level_edge_top)[eoc] == 2)
    assert np.asarray(vert.cell_level_mask)[0, 2:].sum() == 0


def test_bad_inputs():
    with pytest.raises(ValueError):
        planar_hex_mesh(8, 7, 1000.0)
    with pytest.raises(ValueError):
        planar_hex_mesh(2, 2, 1000.0)
