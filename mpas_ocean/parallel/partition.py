"""Cell-domain decomposition with halo construction.

The reference declares MPI domain decomposition but never implements it
(MPI deps unused, SURVEY section 2.2); its ancestor project partitioned
cells across ranks with graph-partitioned halos. This module is the
equivalent's host-side half: partition the cells, build per-part
local meshes (owned elements first, then halo, then one reserved dump/pad
slot), remap connectivity to local indices, and precompute a static
all-gather-based exchange schedule that `shard_map` executes on device
(see shard_step.py).

Element ownership:
  * cell  -> its partition
  * edge  -> partition of cells_on_edge[:, 0]
  * vertex-> partition of cells_on_vertex[:, 0]
Every non-owned local element receives its prognostic values from its
owner's pack each step, so a 1-cell halo ring suffices: all tendencies are
computed on owned elements from owned+halo data (the widest stencil,
edgesOnEdge, reaches edges of the two adjacent cells — all local edges by
construction).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..mesh.horz_mesh import DualCells, Edges, HorzMesh, PrimaryCells
from ..mesh.mesh import Mesh
from ..mesh.vert_mesh import VerticalMesh

__all__ = ["partition_cells", "build_partition", "PartitionedMesh"]


def partition_cells(horz: HorzMesh, n_parts: int, method: str = "stripes") -> np.ndarray:
    """Assign each cell to a partition.

    "stripes": order cells by (y, x) and cut into equal contiguous chunks —
    near-optimal surface/volume for planar hex meshes and deterministic.
    "graph": balanced BFS graph growing over the cell adjacency (native C++
    when available, parallel/graph.py) — use for spherical or irregular
    meshes where coordinate stripes perform poorly.
    """
    n = horz.n_cells
    if method == "stripes":
        order = np.lexsort((np.asarray(horz.cells.x), np.asarray(horz.cells.y)))
        part = np.empty(n, dtype=np.int32)
        # equal-size contiguous chunks over the sorted order
        bounds = (np.arange(n, dtype=np.int64) * n_parts) // n
        part[order] = bounds.astype(np.int32)
        return part
    if method == "graph":
        from .graph import cell_adjacency_csr, greedy_partition

        xadj, adjncy = cell_adjacency_csr(horz)
        return greedy_partition(n, xadj, adjncy, n_parts).astype(np.int32)
    raise ValueError(f"unknown partition method {method!r}")


@dataclass
class PartitionedMesh:
    """Host-side partition product consumed by ShardedModel."""

    n_parts: int
    part_of_cell: np.ndarray  # (nCells,) global partition map

    # stacked local meshes: every array leaf has a leading (n_parts,) axis;
    # cell/edge/vertex axes padded to common sizes + 1 reserved pad slot
    local_mesh: Mesh

    # per-part element bookkeeping (host numpy)
    n_owned_cells: np.ndarray  # (P,)
    n_local_cells: np.ndarray  # (P,) owned + halo
    n_owned_edges: np.ndarray
    n_local_edges: np.ndarray
    n_owned_vertices: np.ndarray
    cell_gids: np.ndarray  # (P, Cpad) global cell id per local slot (pad: -1)
    edge_gids: np.ndarray  # (P, Epad)
    vertex_gids: np.ndarray  # (P, Vpad)

    # exchange schedule (stacked per part, device-ready int32):
    cell_send: np.ndarray  # (P, Sc) local slots to pack (pad: dump slot)
    cell_recv_flat: np.ndarray  # (P, Hc) flat index into allgathered packs
    cell_halo_slots: np.ndarray  # (P, Hc) local slots to overwrite (pad: dump)
    edge_send: np.ndarray  # (P, Se)
    edge_recv_flat: np.ndarray  # (P, He)
    edge_halo_slots: np.ndarray  # (P, He)


def _pad_rows(rows: list[np.ndarray], width: int, fill) -> np.ndarray:
    out = np.full((len(rows), width), fill, dtype=np.int64)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


def build_partition(
    mesh: Mesh, n_parts: int, part_of_cell: np.ndarray | None = None
) -> PartitionedMesh:
    horz, vert = mesh.horz, mesh.vert
    n_cells, n_edges, n_vertices = horz.n_cells, horz.n_edges, horz.n_vertices
    K = vert.n_vert_levels
    max_edges = horz.cells.max_edges
    max_edges2 = horz.edges.max_edges2
    vdeg = horz.duals.vertex_degree

    if part_of_cell is None:
        part_of_cell = partition_cells(horz, n_parts)
    part = np.asarray(part_of_cell, dtype=np.int32)

    coc = np.asarray(horz.cells.cells_on_cell)
    coc_mask = np.asarray(horz.cells.edge_mask_on_cell) > 0
    coe = np.asarray(horz.edges.cells_on_edge)
    cov = np.asarray(horz.duals.cells_on_vertex)
    eoc = np.asarray(horz.cells.edges_on_cell)
    eov = np.asarray(horz.duals.edges_on_vertex)

    edge_owner = part[coe[:, 0]]
    vertex_owner = part[cov[:, 0]]

    # --- per-part element lists --------------------------------------
    owned_cells, halo_cells, local_edge_list, local_vert_list = [], [], [], []
    owned_edge_counts, owned_vert_counts = [], []
    for p in range(n_parts):
        own = np.flatnonzero(part == p)
        # halo ring: neighbors of owned cells not owned by p
        nbrs = coc[own][coc_mask[own]]
        halo = np.unique(nbrs[part[nbrs] != p])
        owned_cells.append(own)
        halo_cells.append(halo)

        local_c = np.concatenate([own, halo])
        # all edges incident to any local cell, owned-first / stable order
        edges_p = np.unique(eoc[local_c][coc_mask[local_c]])
        own_e = edges_p[edge_owner[edges_p] == p]
        other_e = edges_p[edge_owner[edges_p] != p]
        local_edge_list.append(np.concatenate([own_e, other_e]))
        owned_edge_counts.append(len(own_e))

        # vertices with all three cells local (always includes owned ones)
        in_local = np.zeros(n_cells, dtype=bool)
        in_local[local_c] = True
        vset = np.unique(np.asarray(horz.cells.vertices_on_cell)[local_c][coc_mask[local_c]])
        complete = in_local[cov[vset]].all(axis=1)
        vset = vset[complete]
        own_v = vset[vertex_owner[vset] == p]
        other_v = vset[vertex_owner[vset] != p]
        local_vert_list.append(np.concatenate([own_v, other_v]))
        owned_vert_counts.append(len(own_v))

    n_owned_cells = np.array([len(a) for a in owned_cells])
    n_halo_cells = np.array([len(a) for a in halo_cells])
    n_local_cells = n_owned_cells + n_halo_cells
    n_local_edges = np.array([len(a) for a in local_edge_list])
    n_owned_edges = np.array(owned_edge_counts)
    n_local_verts = np.array([len(a) for a in local_vert_list])
    n_owned_vertices = np.array(owned_vert_counts)

    # +1 reserved dump/pad slot at the end of every element axis
    Cpad = int(n_local_cells.max()) + 1
    Epad = int(n_local_edges.max()) + 1
    Vpad = int(n_local_verts.max()) + 1

    cell_gids = _pad_rows(
        [np.concatenate([o, h]) for o, h in zip(owned_cells, halo_cells)], Cpad, -1
    )
    edge_gids = _pad_rows(local_edge_list, Epad, -1)
    vertex_gids = _pad_rows(local_vert_list, Vpad, -1)

    # --- global -> local lookup tables (per part) ---------------------
    # value = local slot, or the dump slot when not local to that part
    cell_l = np.full((n_parts, n_cells), Cpad - 1, dtype=np.int64)
    edge_l = np.full((n_parts, n_edges), Epad - 1, dtype=np.int64)
    vert_l = np.full((n_parts, n_vertices), Vpad - 1, dtype=np.int64)
    for p in range(n_parts):
        ids = cell_gids[p, : n_local_cells[p]]
        cell_l[p, ids] = np.arange(len(ids))
        ids = edge_gids[p, : n_local_edges[p]]
        edge_l[p, ids] = np.arange(len(ids))
        ids = vertex_gids[p, : n_local_verts[p]]
        vert_l[p, ids] = np.arange(len(ids))

    # --- exchange schedule -------------------------------------------
    # send packs: owned elements needed as halo by any other part
    cell_needed = [set() for _ in range(n_parts)]  # global ids each owner sends
    for p in range(n_parts):
        for g in halo_cells[p]:
            cell_needed[part[g]].add(int(g))
    edge_needed = [set() for _ in range(n_parts)]
    for p in range(n_parts):
        le = local_edge_list[p][n_owned_edges[p] :]  # non-owned local edges
        for g in le:
            edge_needed[edge_owner[g]].add(int(g))

    cell_send_g = [np.array(sorted(s), dtype=np.int64) for s in cell_needed]
    edge_send_g = [np.array(sorted(s), dtype=np.int64) for s in edge_needed]
    Sc = max(1, max(len(a) for a in cell_send_g))
    Se = max(1, max(len(a) for a in edge_send_g))

    # slot of a global id within its owner's send pack
    cell_pack_slot = np.full(n_cells, -1, dtype=np.int64)
    for q in range(n_parts):
        cell_pack_slot[cell_send_g[q]] = np.arange(len(cell_send_g[q]))
    edge_pack_slot = np.full(n_edges, -1, dtype=np.int64)
    for q in range(n_parts):
        edge_pack_slot[edge_send_g[q]] = np.arange(len(edge_send_g[q]))

    cell_send = _pad_rows(
        [cell_l[q, cell_send_g[q]] for q in range(n_parts)], Sc, Cpad - 1
    )
    edge_send = _pad_rows(
        [edge_l[q, edge_send_g[q]] for q in range(n_parts)], Se, Epad - 1
    )

    Hc = max(1, int(n_halo_cells.max()))
    n_halo_edges = n_local_edges - n_owned_edges
    He = max(1, int(n_halo_edges.max()))
    cell_recv_rows, cell_slot_rows, edge_recv_rows, edge_slot_rows = [], [], [], []
    for p in range(n_parts):
        hc = halo_cells[p]
        cell_recv_rows.append(part[hc].astype(np.int64) * Sc + cell_pack_slot[hc])
        cell_slot_rows.append(cell_l[p, hc])
        he = local_edge_list[p][n_owned_edges[p] :]
        edge_recv_rows.append(edge_owner[he].astype(np.int64) * Se + edge_pack_slot[he])
        edge_slot_rows.append(edge_l[p, he])
    cell_recv_flat = _pad_rows(cell_recv_rows, Hc, 0)
    cell_halo_slots = _pad_rows(cell_slot_rows, Hc, Cpad - 1)
    edge_recv_flat = _pad_rows(edge_recv_rows, He, 0)
    edge_halo_slots = _pad_rows(edge_slot_rows, He, Epad - 1)

    # --- build stacked local meshes ----------------------------------
    fdt = np.asarray(horz.cells.area_cell).dtype

    def gather_f(field, gids, pad_value=0.0):
        """Gather a global float field into (P, pad) rows."""
        field = np.asarray(field)
        out_shape = (n_parts, gids.shape[1]) + field.shape[1:]
        out = np.full(out_shape, pad_value, dtype=field.dtype)
        valid = gids >= 0
        out[valid] = field[gids[valid]]
        return out

    def remap(table, gids, conn, mask=None):
        """Remap global connectivity (nElem, w) into per-part local ids."""
        conn = np.asarray(conn)
        out = np.empty((n_parts,) + (gids.shape[1],) + conn.shape[1:], dtype=np.int32)
        for p in range(n_parts):
            g = np.where(gids[p] >= 0, gids[p], 0)
            out[p] = table[p, conn[g]]
        return out

    eoc_l = remap(edge_l, cell_gids, eoc)
    coc_l = remap(cell_l, cell_gids, coc)
    voc_l = remap(vert_l, cell_gids, np.asarray(horz.cells.vertices_on_cell))
    coe_l = remap(cell_l, edge_gids, coe)
    voe_l = remap(vert_l, edge_gids, np.asarray(horz.edges.vertices_on_edge))
    eoe_l = remap(edge_l, edge_gids, np.asarray(horz.edges.edges_on_edge))
    cov_l = remap(cell_l, vertex_gids, cov)
    eov_l = remap(edge_l, vertex_gids, eov)

    # poison detection: a remapped neighbor equal to the dump slot gets its
    # sign/weight/mask zeroed so reductions ignore it (only ever happens on
    # non-owned rows whose results are overwritten by exchange anyway)
    sign_c = gather_f(horz.cells.edge_sign_on_cell, cell_gids)
    mask_c = gather_f(horz.cells.edge_mask_on_cell, cell_gids)
    kite_c = gather_f(horz.cells.kite_areas_on_cell, cell_gids)
    sign_c = np.where(eoc_l == Epad - 1, 0.0, sign_c)
    mask_c = np.where(eoc_l == Epad - 1, 0.0, mask_c)
    w_e = gather_f(horz.edges.weights_on_edge, edge_gids)
    w_e = np.where(eoe_l == Epad - 1, 0.0, w_e)
    sign_v = gather_f(horz.duals.edge_sign_on_vertex, vertex_gids)
    sign_v = np.where(eov_l == Epad - 1, 0.0, sign_v)

    cells = PrimaryCells(
        n_cells=Cpad,
        max_edges=max_edges,
        x=gather_f(horz.cells.x, cell_gids),
        y=gather_f(horz.cells.y, cell_gids),
        z=gather_f(horz.cells.z, cell_gids),
        f=gather_f(horz.cells.f, cell_gids),
        area_cell=gather_f(horz.cells.area_cell, cell_gids, pad_value=1.0),
        n_edges_on_cell=gather_f(horz.cells.n_edges_on_cell, cell_gids, 0),
        edges_on_cell=eoc_l,
        vertices_on_cell=voc_l,
        cells_on_cell=coc_l,
        edge_sign_on_cell=sign_c,
        edge_mask_on_cell=mask_c,
        kite_areas_on_cell=kite_c,
    )
    duals = DualCells(
        n_vertices=Vpad,
        vertex_degree=vdeg,
        x=gather_f(horz.duals.x, vertex_gids),
        y=gather_f(horz.duals.y, vertex_gids),
        z=gather_f(horz.duals.z, vertex_gids),
        f=gather_f(horz.duals.f, vertex_gids),
        area_triangle=gather_f(horz.duals.area_triangle, vertex_gids, 1.0),
        edges_on_vertex=eov_l,
        cells_on_vertex=cov_l,
        edge_sign_on_vertex=sign_v,
        kite_areas_on_vertex=gather_f(horz.duals.kite_areas_on_vertex, vertex_gids),
    )
    edges = Edges(
        n_edges=Epad,
        max_edges2=max_edges2,
        x=gather_f(horz.edges.x, edge_gids),
        y=gather_f(horz.edges.y, edge_gids),
        z=gather_f(horz.edges.z, edge_gids),
        f=gather_f(horz.edges.f, edge_gids),
        cells_on_edge=coe_l,
        vertices_on_edge=voe_l,
        n_edges_on_edge=gather_f(horz.edges.n_edges_on_edge, edge_gids, 0),
        edges_on_edge=eoe_l,
        weights_on_edge=w_e,
        dv_edge=gather_f(horz.edges.dv_edge, edge_gids, 1.0),
        dc_edge=gather_f(horz.edges.dc_edge, edge_gids, 1.0),
        angle_edge=gather_f(horz.edges.angle_edge, edge_gids),
        edge_mask=gather_f(horz.edges.edge_mask, edge_gids),
    )
    local_horz = HorzMesh(
        cells=cells, duals=duals, edges=edges, lx=horz.lx, ly=horz.ly,
        on_sphere=horz.on_sphere, sphere_radius=horz.sphere_radius,
    )
    local_vert = VerticalMesh(
        n_vert_levels=K,
        min_level_cell=gather_f(vert.min_level_cell, cell_gids, 0),
        max_level_cell=gather_f(vert.max_level_cell, cell_gids, 0),
        max_level_edge_top=gather_f(vert.max_level_edge_top, edge_gids, 0),
        max_level_edge_bot=gather_f(vert.max_level_edge_bot, edge_gids, 0),
        max_level_vertex_top=gather_f(vert.max_level_vertex_top, vertex_gids, 0),
        max_level_vertex_bot=gather_f(vert.max_level_vertex_bot, vertex_gids, 0),
        resting_thickness=gather_f(vert.resting_thickness, cell_gids),
        resting_thickness_sum=gather_f(vert.resting_thickness_sum, cell_gids),
        cell_level_mask=gather_f(vert.cell_level_mask, cell_gids),
        edge_level_mask=gather_f(vert.edge_level_mask, edge_gids),
        vertex_level_mask=gather_f(vert.vertex_level_mask, vertex_gids),
        bottom_depth=gather_f(vert.bottom_depth, cell_gids),
        vert_coord_movement_weights=np.broadcast_to(
            np.asarray(vert.vert_coord_movement_weights), (n_parts, K)
        ).copy(),
    )

    return PartitionedMesh(
        n_parts=n_parts,
        part_of_cell=part,
        local_mesh=Mesh(horz=local_horz, vert=local_vert),
        n_owned_cells=n_owned_cells,
        n_local_cells=n_local_cells,
        n_owned_edges=n_owned_edges,
        n_local_edges=n_local_edges,
        n_owned_vertices=n_owned_vertices,
        cell_gids=cell_gids,
        edge_gids=edge_gids,
        vertex_gids=vertex_gids,
        cell_send=cell_send.astype(np.int32),
        cell_recv_flat=cell_recv_flat.astype(np.int32),
        cell_halo_slots=cell_halo_slots.astype(np.int32),
        edge_send=edge_send.astype(np.int32),
        edge_recv_flat=edge_recv_flat.astype(np.int32),
        edge_halo_slots=edge_halo_slots.astype(np.int32),
    )
