"""Periodic planar Voronoi/TRiSK mesh builder.

The reference consumes externally generated MPAS NetCDF meshes (reference:
src/infra/MPASMesh/HorzMesh.jl:334-355) and has no generator of its own; in a
zero-egress environment we generate meshes ourselves. Given any set of
generator points in a doubly periodic box, this module Delaunay-triangulates
the periodic plane, takes circumcenters as the dual (vertex) points, and
derives the complete MPAS-style field set: connectivity (cellsOnEdge,
edgesOnCell, verticesOnCell, cellsOnVertex, edgesOnVertex, verticesOnEdge,
cellsOnCell, edgesOnEdge), metrics (dcEdge, dvEdge, angleEdge, areaCell,
areaTriangle, kiteAreas), sign conventions (edgeSignOnCell/Vertex,
HorzMesh.jl:292-332), and the TRiSK tangential-velocity reconstruction
weights (weightsOnEdge) of Thuburn et al. 2009 / Ringler et al. 2010 —
the field inventory of the reference's legacy full mesh (src/infra/Mesh.jl).

Everything below is host-side NumPy executed once at setup; the output is a
`HorzMesh` pytree of padded dense arrays ready for the device.

Conventions (self-consistent, and matching MPAS where observable):
  * the edge normal points from cells_on_edge[:,0] to cells_on_edge[:,1];
    angle_edge is its angle vs. +x.
  * z_hat x normal points from vertices_on_edge[:,0] to vertices_on_edge[:,1].
  * edges_on_cell is CCW around the cell; vertices_on_cell[i] sits between
    edges_on_cell[i] and edges_on_cell[i+1 mod n].
  * cells_on_vertex / edges_on_vertex are CCW around the vertex.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import Delaunay

from .horz_mesh import DualCells, Edges, HorzMesh, PrimaryCells

__all__ = ["build_planar_trisk_mesh"]


def _wrap(d: np.ndarray, L: np.ndarray) -> np.ndarray:
    """Nearest-image displacement in a periodic box (componentwise)."""
    return d - L * np.round(d / L)


def _circumcenter(a, b, c):
    """Circumcenters of triangles given corner coords (..., 2) each."""
    ab = b - a
    ac = c - a
    d = 2.0 * (ab[..., 0] * ac[..., 1] - ab[..., 1] * ac[..., 0])
    ab2 = (ab**2).sum(-1)
    ac2 = (ac**2).sum(-1)
    ux = (ac[..., 1] * ab2 - ab[..., 1] * ac2) / d
    uy = (ab[..., 0] * ac2 - ac[..., 0] * ab2) / d
    return a + np.stack([ux, uy], axis=-1)


def _shoelace(poly: np.ndarray) -> np.ndarray:
    """Signed area of polygons given as (..., nverts, 2) coordinate arrays."""
    x = poly[..., 0]
    y = poly[..., 1]
    return 0.5 * (x * np.roll(y, -1, axis=-1) - np.roll(x, -1, axis=-1) * y).sum(-1)


def _group_by_first(keys: np.ndarray, order: np.ndarray, n_groups: int, width: int):
    """Group rows by integer ``keys``, sorting within each group by ``order``.

    Returns (counts, padded) where padded[g, :counts[g]] lists the row
    indices of group g in ascending ``order``; padding is 0.
    """
    perm = np.lexsort((order, keys))
    keys_s = keys[perm]
    counts = np.bincount(keys_s, minlength=n_groups)
    assert counts.max() <= width, (counts.max(), width)
    starts = np.concatenate([[0], np.cumsum(counts[:-1])])
    padded = np.zeros((n_groups, width), dtype=np.int64)
    slot = np.arange(len(keys_s)) - np.repeat(starts, counts)
    padded[keys_s, slot] = perm
    return counts, padded


def build_planar_trisk_mesh(
    points: np.ndarray,
    lx: float,
    ly: float,
    f0: float = 0.0,
    beta: float = 0.0,
    max_edges: int | None = None,
    dtype=np.float64,
) -> HorzMesh:
    """Build a complete TRiSK mesh from generator points in a periodic box.

    Args:
      points: (nCells, 2) generator points in [0, lx) x [0, ly).
      lx, ly: periodic box extents.
      f0, beta: Coriolis parameter f = f0 + beta * y evaluated at cells,
        vertices and edges.
      max_edges: padding width for per-cell arrays (default: observed max).
      dtype: floating dtype of all metric fields.
    """
    points = np.asarray(points, dtype=np.float64)
    n_cells = len(points)
    L = np.array([lx, ly], dtype=np.float64)
    if n_cells < 9:
        raise ValueError("need at least 9 generator points")

    # --- periodic Delaunay via 3x3 tiling -------------------------------
    offsets = np.array(
        [[ox, oy] for oy in (-1, 0, 1) for ox in (-1, 0, 1)], dtype=np.int64
    )
    tiled = (points[None, :, :] + (offsets[:, None, :] * L)).reshape(-1, 2)
    tri = Delaunay(tiled)
    simp = tri.simplices  # (M, 3) indices into tiled
    s_orig = simp % n_cells
    s_off = offsets[simp // n_cells]  # (M, 3, 2)

    # keep triangles touching the central copy; canonicalize so the
    # lexicographically-smallest (cell, offset) corner sits at offset (0,0)
    touches = (s_off == 0).all(-1).any(-1)
    s_orig = s_orig[touches]
    s_off = s_off[touches]

    # sort the 3 corners of each triangle by (cell id, ox, oy)
    corner_key = (
        s_orig.astype(np.int64) * 9
        + (s_off[..., 0] + 1) * 3
        + (s_off[..., 1] + 1)
    )
    corner_rank = np.argsort(corner_key, axis=1)
    s_orig = np.take_along_axis(s_orig, corner_rank, axis=1)
    s_off = np.take_along_axis(s_off, corner_rank[..., None], axis=1)
    # shift so the first (smallest) corner has offset 0
    s_off = s_off - s_off[:, :1, :]

    # dedupe canonical triangles
    tri_key = np.concatenate([s_orig, s_off.reshape(-1, 6)], axis=1)
    _, uniq_idx = np.unique(tri_key, axis=0, return_index=True)
    t_cells = s_orig[uniq_idx]  # (nVertices, 3) cell ids
    t_off = s_off[uniq_idx]  # (nVertices, 3, 2) integer offsets
    n_vertices = len(t_cells)

    # triangle corner coordinates in the canonical frame & circumcenters
    t_xy = points[t_cells] + t_off * L  # (nV, 3, 2)
    cc = _circumcenter(t_xy[:, 0], t_xy[:, 1], t_xy[:, 2])  # (nV, 2)
    vert_xy = cc - L * np.floor(cc / L)  # wrapped storage position
    area_triangle = np.abs(_shoelace(t_xy))

    # cells_on_vertex ordered CCW around the circumcenter
    ang = np.arctan2(t_xy[..., 1] - cc[:, None, 1], t_xy[..., 0] - cc[:, None, 0])
    ccw = np.argsort(ang, axis=1)
    cells_on_vertex = np.take_along_axis(t_cells, ccw, axis=1)

    # --- edges: dedupe triangle sides ----------------------------------
    # each triangle side = pair of (cell, offset); canonical anchor = the
    # smaller (cell, offset) member shifted to offset 0
    pair_i = np.array([[0, 1], [1, 2], [0, 2]])
    e_cells = t_cells[:, pair_i]  # (nV, 3, 2)
    e_offs = t_off[:, pair_i]  # (nV, 3, 2, 2)
    e_vert = np.broadcast_to(np.arange(n_vertices)[:, None], (n_vertices, 3))

    ec = e_cells.reshape(-1, 2)
    eo = e_offs.reshape(-1, 2, 2)
    ev = e_vert.reshape(-1)

    # order pair so the anchor (smaller key) is first
    k0 = ec[:, 0] * 9 + (eo[:, 0, 0] + 1) * 3 + (eo[:, 0, 1] + 1)
    k1 = ec[:, 1] * 9 + (eo[:, 1, 0] + 1) * 3 + (eo[:, 1, 1] + 1)
    swap = k1 < k0
    ec[swap] = ec[swap][:, ::-1]
    eo[swap] = eo[swap][:, ::-1]
    shift = eo[:, 0].copy()  # offset applied to bring anchor to 0
    eo = eo - shift[:, None, :]

    edge_key = np.concatenate([ec, eo.reshape(-1, 4)], axis=1)
    uniq_keys, edge_id, counts = np.unique(
        edge_key, axis=0, return_inverse=True, return_counts=True
    )
    assert (counts == 2).all(), "each edge must border exactly two triangles"
    n_edges = len(uniq_keys)

    cells_on_edge = uniq_keys[:, :2].astype(np.int64)  # anchor cell, other cell
    other_off = uniq_keys[:, 4:6].astype(np.float64)  # offset of second cell

    c1_xy = points[cells_on_edge[:, 0]]
    c2_xy = points[cells_on_edge[:, 1]] + other_off * L
    dvec = c2_xy - c1_xy
    dc_edge = np.linalg.norm(dvec, axis=1)
    angle_edge = np.arctan2(dvec[:, 1], dvec[:, 0])
    normal = dvec / dc_edge[:, None]
    mid = c1_xy + 0.5 * dvec
    edge_xy = mid - L * np.floor(mid / L)

    # the two adjacent triangles (vertices), each with its circumcenter
    # expressed in the canonical edge frame (undo the canonicalization shift)
    order = np.argsort(edge_id, kind="stable")
    inst_v = ev[order].reshape(n_edges, 2)
    inst_shift = shift[order].reshape(n_edges, 2, 2)
    vpos = cc[inst_v] - inst_shift * L  # (nEdges, 2, 2)

    # orient so z_hat x normal points v0 -> v1
    that = np.stack([-normal[:, 1], normal[:, 0]], axis=1)  # z x n
    along = ((vpos[:, 1] - vpos[:, 0]) * that).sum(-1)
    flip = along < 0
    inst_v[flip] = inst_v[flip][:, ::-1]
    vpos[flip] = vpos[flip][:, ::-1]
    vertices_on_edge = inst_v
    dv_edge = np.linalg.norm(vpos[:, 1] - vpos[:, 0], axis=1)
    if (dv_edge <= 0).any():
        raise ValueError("degenerate edge (coincident circumcenters)")

    # --- per-cell CCW edge cycle ---------------------------------------
    # incidence instances: (cell, edge, angle of cell->edge-midpoint)
    inc_cell = np.concatenate([cells_on_edge[:, 0], cells_on_edge[:, 1]])
    inc_edge = np.concatenate([np.arange(n_edges)] * 2)
    inc_disp = np.concatenate([0.5 * dvec, -0.5 * dvec])  # cell -> edge mid
    inc_ang = np.arctan2(inc_disp[:, 1], inc_disp[:, 0])

    ne_counts, inc_rows = _group_by_first(inc_cell, inc_ang, n_cells, 16)
    n_edges_on_cell = ne_counts.astype(np.int32)
    if max_edges is None:
        max_edges = int(ne_counts.max())
    assert ne_counts.max() <= max_edges
    slot_valid = np.arange(max_edges)[None, :] < ne_counts[:, None]

    inc_rows = inc_rows[:, :max_edges]
    edges_on_cell = np.where(slot_valid, inc_edge[inc_rows], 0)
    edge_mid_disp = np.where(
        slot_valid[..., None], inc_disp[inc_rows], 0.0
    )  # (nCells, maxEdges, 2) cell -> edge midpoint

    # neighbor across each edge slot
    on_first = (
        cells_on_edge[edges_on_cell, 0] == np.arange(n_cells)[:, None]
    )
    cells_on_cell = np.where(
        on_first, cells_on_edge[edges_on_cell, 1], cells_on_edge[edges_on_cell, 0]
    )
    cells_on_cell = np.where(slot_valid, cells_on_cell, 0)

    # vertices_on_cell[i] = vertex shared by edge slots i and i+1
    nxt = (np.arange(max_edges)[None, :] + 1) % np.maximum(
        n_edges_on_cell[:, None], 1
    )
    nxt = np.where(slot_valid, nxt, 0)
    e_a = edges_on_cell
    e_b = np.take_along_axis(edges_on_cell, nxt, axis=1)
    va = vertices_on_edge[e_a]  # (nCells, maxEdges, 2)
    vb = vertices_on_edge[e_b]
    match_00 = va[..., 0] == vb[..., 0]
    match_01 = va[..., 0] == vb[..., 1]
    match_10 = va[..., 1] == vb[..., 0]
    match_11 = va[..., 1] == vb[..., 1]
    a_uses_0 = match_00 | match_01
    shared = np.where(a_uses_0, va[..., 0], va[..., 1])
    n_match = (
        match_00.astype(int) + match_01 + match_10 + match_11
    )
    if (np.where(slot_valid, n_match, 1) != 1).any():
        raise ValueError(
            "ambiguous shared vertex between consecutive edges; "
            "mesh is too small for nearest-image construction"
        )
    vertices_on_cell = np.where(slot_valid, shared, 0)

    # --- cell geometry: area + kites -----------------------------------
    cell_xy = points  # (nCells, 2)
    vert_disp = _wrap(
        vert_xy[vertices_on_cell] - cell_xy[:, None, :], L
    )  # cell -> vertex_i
    # shoelace over the CCW vertex cycle, with variable vertex count: sum
    # cross products of consecutive valid vertices (wrapping to the first)
    nxt_v = np.take_along_axis(vert_disp, nxt[..., None], axis=1)
    cross = (
        vert_disp[..., 0] * nxt_v[..., 1] - nxt_v[..., 0] * vert_disp[..., 1]
    )
    area_cell = 0.5 * np.where(slot_valid, cross, 0.0).sum(1)
    if (area_cell <= 0).any():
        # the ascending-angle vertex sort guarantees CCW cycles, so a
        # non-positive area is a construction bug; silently flipping it
        # (abs) would leave the SIGNED kite areas below inconsistent with
        # it and corrupt the kite-weighted PV identities
        raise ValueError("non-CCW cell vertex cycle (non-positive area)")

    # kite_i: quad (0, mid_i, vertex_i, mid_{i+1}) in the cell frame.
    # SIGNED shoelace, not abs: on irregular meshes an obtuse Delaunay
    # triangle puts the circumcenter outside it and the kite quad folds —
    # the signed areas still tile the cell (and the triangle) EXACTLY,
    # which the PV / cell->vertex interpolation identities rely on
    # (sum of kites around a vertex == area_triangle). On uniform hex
    # lattices every kite is convex CCW, so signed == abs there.
    mid_i = edge_mid_disp
    mid_n = np.take_along_axis(edge_mid_disp, nxt[..., None], axis=1)
    zeros = np.zeros_like(mid_i)
    kite_poly = np.stack([zeros, mid_i, vert_disp, mid_n], axis=2)
    kite_areas_on_cell = _shoelace(kite_poly)
    kite_areas_on_cell = np.where(slot_valid, kite_areas_on_cell, 0.0)

    # --- vertex-frame arrays -------------------------------------------
    vinc_vert = np.concatenate([vertices_on_edge[:, 0], vertices_on_edge[:, 1]])
    vinc_edge = np.concatenate([np.arange(n_edges)] * 2)
    vinc_disp = _wrap(edge_xy[vinc_edge] - vert_xy[vinc_vert], L)
    vinc_ang = np.arctan2(vinc_disp[:, 1], vinc_disp[:, 0])
    vd_counts, vinc_rows = _group_by_first(vinc_vert, vinc_ang, n_vertices, 8)
    vertex_degree = int(vd_counts.max())
    assert (vd_counts == vertex_degree).all(), "mixed vertex degree"
    vinc_rows = vinc_rows[:, :vertex_degree]
    edges_on_vertex = vinc_edge[vinc_rows]

    # kite_areas_on_vertex aligned with cells_on_vertex: scatter from the
    # cell frame (cell c, slot i) -> (vertex v, slot j with cellsOnVertex==c)
    kite_areas_on_vertex = np.zeros((n_vertices, vertex_degree))
    flat_v = vertices_on_cell[slot_valid]
    flat_c = np.broadcast_to(
        np.arange(n_cells)[:, None], vertices_on_cell.shape
    )[slot_valid]
    flat_k = kite_areas_on_cell[slot_valid]
    cov = cells_on_vertex  # (nV, deg)
    match = cov[flat_v] == flat_c[:, None]  # (nInc, deg)
    assert (match.sum(1) == 1).all()
    slot_j = match.argmax(1)
    kite_areas_on_vertex[flat_v, slot_j] = flat_k

    # --- sign conventions (reference HorzMesh.jl:292-332) ---------------
    edge_sign_on_cell = np.where(
        slot_valid,
        np.where(on_first, -1.0, 1.0),
        0.0,
    )
    edge_sign_on_vertex = np.where(
        vertices_on_edge[edges_on_vertex, 0] == np.arange(n_vertices)[:, None],
        -1.0,
        1.0,
    )

    # --- TRiSK reconstruction weights (Thuburn 2009 / Ringler 2010) -----
    from .weights import trisk_weights

    max_edges2 = 2 * max_edges
    n_edges_on_edge, edges_on_edge, weights_on_edge = trisk_weights(
        cells_on_edge,
        dv_edge,
        dc_edge,
        n_edges_on_cell,
        edges_on_cell,
        vertices_on_cell,
        kite_areas_on_cell,
        area_cell,
    )

    # --- Coriolis fields -------------------------------------------------
    f_cell = f0 + beta * points[:, 1]
    f_vertex = f0 + beta * vert_xy[:, 1]
    f_edge = f0 + beta * edge_xy[:, 1]

    fdt = dtype
    cells = PrimaryCells(
        n_cells=n_cells,
        max_edges=max_edges,
        x=points[:, 0].astype(fdt),
        y=points[:, 1].astype(fdt),
        z=np.zeros(n_cells, dtype=fdt),
        f=f_cell.astype(fdt),
        area_cell=area_cell.astype(fdt),
        n_edges_on_cell=n_edges_on_cell.astype(np.int32),
        edges_on_cell=edges_on_cell.astype(np.int32),
        vertices_on_cell=vertices_on_cell.astype(np.int32),
        cells_on_cell=cells_on_cell.astype(np.int32),
        edge_sign_on_cell=edge_sign_on_cell.astype(fdt),
        edge_mask_on_cell=slot_valid.astype(fdt),
        kite_areas_on_cell=kite_areas_on_cell.astype(fdt),
    )
    duals = DualCells(
        n_vertices=n_vertices,
        vertex_degree=vertex_degree,
        x=vert_xy[:, 0].astype(fdt),
        y=vert_xy[:, 1].astype(fdt),
        z=np.zeros(n_vertices, dtype=fdt),
        f=f_vertex.astype(fdt),
        area_triangle=area_triangle.astype(fdt),
        edges_on_vertex=edges_on_vertex.astype(np.int32),
        cells_on_vertex=cells_on_vertex.astype(np.int32),
        edge_sign_on_vertex=edge_sign_on_vertex.astype(fdt),
        kite_areas_on_vertex=kite_areas_on_vertex.astype(fdt),
    )
    edges = Edges(
        n_edges=n_edges,
        max_edges2=max_edges2,
        x=edge_xy[:, 0].astype(fdt),
        y=edge_xy[:, 1].astype(fdt),
        z=np.zeros(n_edges, dtype=fdt),
        f=f_edge.astype(fdt),
        cells_on_edge=cells_on_edge.astype(np.int32),
        vertices_on_edge=vertices_on_edge.astype(np.int32),
        n_edges_on_edge=n_edges_on_edge,
        edges_on_edge=edges_on_edge.astype(np.int32),
        weights_on_edge=weights_on_edge.astype(fdt),
        dv_edge=dv_edge.astype(fdt),
        dc_edge=dc_edge.astype(fdt),
        angle_edge=angle_edge.astype(fdt),
        edge_mask=np.ones(n_edges, dtype=fdt),
    )
    return HorzMesh(cells=cells, duals=duals, edges=edges, lx=float(lx), ly=float(ly))
