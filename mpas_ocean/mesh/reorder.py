"""Mesh element renumbering for memory locality.

Contiguous access pays on any accelerator: both the BSR operator path
(ops/bsr.py — matrix bytes scale with the block bandwidth) and the
domain-decomposed path
(parallel/ — contiguous halo blocks) want cells, edges and vertices numbered
so that mesh-adjacent elements are index-adjacent. Meshes read from MPAS
NetCDF files or built by generators have arbitrary numbering; this module
renumbers all three element sets consistently:

  * cells by reverse Cuthill-McKee on the cell adjacency graph
    (parallel/graph.py; native C++ when built, Python fallback), and
  * edges/vertices by their lowest adjacent (new) cell index,

and remaps every connectivity field. SURVEY "Hard parts": "sort/renumber
elements for locality (RCM or partition-block order)".

The reference has no equivalent (its kernels gather at original NetCDF
ordering).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from ..parallel.graph import cell_adjacency_csr, rcm_order
from .horz_mesh import HorzMesh

__all__ = ["MeshPermutation", "rcm_reorder", "reorder_horz_mesh"]


@dataclasses.dataclass(frozen=True)
class MeshPermutation:
    """new_to_old / old_to_new index maps for each element set.

    ``<set>_order[i]`` is the OLD index of new element i (use to permute
    per-element field arrays: ``field_new = field_old[order]``);
    ``<set>_inv[j]`` is the NEW index of old element j (use to remap
    connectivity values).
    """

    cell_order: np.ndarray
    edge_order: np.ndarray
    vertex_order: np.ndarray

    @property
    def cell_inv(self) -> np.ndarray:
        return _invert(self.cell_order)

    @property
    def edge_inv(self) -> np.ndarray:
        return _invert(self.edge_order)

    @property
    def vertex_inv(self) -> np.ndarray:
        return _invert(self.vertex_order)

    def permute_cell_field(self, x):
        return np.asarray(x)[self.cell_order]

    def permute_edge_field(self, x):
        return np.asarray(x)[self.edge_order]

    def permute_vertex_field(self, x):
        return np.asarray(x)[self.vertex_order]


def _invert(order: np.ndarray) -> np.ndarray:
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order), dtype=order.dtype)
    return inv


def _secondary_order(conn: np.ndarray, valid: np.ndarray, prim_inv: np.ndarray,
                     n: int) -> np.ndarray:
    """Order elements by their smallest adjacent (new) primary index."""
    mapped = np.where(valid, prim_inv[conn], np.iinfo(np.int64).max)
    key = mapped.min(axis=1)
    return np.argsort(key, kind="stable").astype(np.int64)


def rcm_reorder(horz: HorzMesh) -> tuple[HorzMesh, MeshPermutation]:
    """RCM-renumber a horizontal mesh; returns (new mesh, permutation)."""
    xadj, adjncy = cell_adjacency_csr(horz)
    cell_order = np.asarray(rcm_order(horz.n_cells, xadj, adjncy), dtype=np.int64)
    return reorder_horz_mesh(horz, cell_order), _make_perm(horz, cell_order)


def _make_perm(horz: HorzMesh, cell_order: np.ndarray) -> MeshPermutation:
    cell_inv = _invert(cell_order)

    coe = np.asarray(horz.edges.cells_on_edge, dtype=np.int64)
    edge_order = _secondary_order(
        coe, np.ones_like(coe, dtype=bool), cell_inv, horz.n_edges
    )

    cov = np.asarray(horz.duals.cells_on_vertex, dtype=np.int64)
    vertex_order = _secondary_order(
        cov, np.ones_like(cov, dtype=bool), cell_inv, horz.n_vertices
    )
    return MeshPermutation(
        cell_order=cell_order, edge_order=edge_order, vertex_order=vertex_order
    )


def reorder_horz_mesh(horz: HorzMesh, cell_order: np.ndarray) -> HorzMesh:
    """Renumber cells by ``cell_order`` (new_to_old) and edges/vertices by
    lowest-adjacent-cell, remapping every connectivity field."""
    perm = _make_perm(horz, np.asarray(cell_order, dtype=np.int64))
    c_ord, e_ord, v_ord = perm.cell_order, perm.edge_order, perm.vertex_order
    c_inv, e_inv, v_inv = perm.cell_inv, perm.edge_inv, perm.vertex_inv

    def npa(x):
        return np.asarray(x)

    cells = horz.cells
    new_cells = cells.replace(
        x=jnp.asarray(npa(cells.x)[c_ord]),
        y=jnp.asarray(npa(cells.y)[c_ord]),
        z=jnp.asarray(npa(cells.z)[c_ord]),
        f=jnp.asarray(npa(cells.f)[c_ord]),
        area_cell=jnp.asarray(npa(cells.area_cell)[c_ord]),
        n_edges_on_cell=jnp.asarray(npa(cells.n_edges_on_cell)[c_ord]),
        edges_on_cell=jnp.asarray(
            e_inv[npa(cells.edges_on_cell)][c_ord].astype(np.int32)
        ),
        vertices_on_cell=jnp.asarray(
            v_inv[npa(cells.vertices_on_cell)][c_ord].astype(np.int32)
        ),
        cells_on_cell=jnp.asarray(
            c_inv[npa(cells.cells_on_cell)][c_ord].astype(np.int32)
        ),
        edge_sign_on_cell=jnp.asarray(npa(cells.edge_sign_on_cell)[c_ord]),
        edge_mask_on_cell=jnp.asarray(npa(cells.edge_mask_on_cell)[c_ord]),
        kite_areas_on_cell=jnp.asarray(npa(cells.kite_areas_on_cell)[c_ord]),
    )

    duals = horz.duals
    new_duals = duals.replace(
        x=jnp.asarray(npa(duals.x)[v_ord]),
        y=jnp.asarray(npa(duals.y)[v_ord]),
        z=jnp.asarray(npa(duals.z)[v_ord]),
        f=jnp.asarray(npa(duals.f)[v_ord]),
        area_triangle=jnp.asarray(npa(duals.area_triangle)[v_ord]),
        edges_on_vertex=jnp.asarray(
            e_inv[npa(duals.edges_on_vertex)][v_ord].astype(np.int32)
        ),
        cells_on_vertex=jnp.asarray(
            c_inv[npa(duals.cells_on_vertex)][v_ord].astype(np.int32)
        ),
        edge_sign_on_vertex=jnp.asarray(npa(duals.edge_sign_on_vertex)[v_ord]),
        kite_areas_on_vertex=jnp.asarray(npa(duals.kite_areas_on_vertex)[v_ord]),
    )

    edges = horz.edges
    new_edges = edges.replace(
        x=jnp.asarray(npa(edges.x)[e_ord]),
        y=jnp.asarray(npa(edges.y)[e_ord]),
        z=jnp.asarray(npa(edges.z)[e_ord]),
        f=jnp.asarray(npa(edges.f)[e_ord]),
        cells_on_edge=jnp.asarray(
            c_inv[npa(edges.cells_on_edge)][e_ord].astype(np.int32)
        ),
        vertices_on_edge=jnp.asarray(
            v_inv[npa(edges.vertices_on_edge)][e_ord].astype(np.int32)
        ),
        n_edges_on_edge=jnp.asarray(npa(edges.n_edges_on_edge)[e_ord]),
        edges_on_edge=jnp.asarray(
            e_inv[npa(edges.edges_on_edge)][e_ord].astype(np.int32)
        ),
        weights_on_edge=jnp.asarray(npa(edges.weights_on_edge)[e_ord]),
        dv_edge=jnp.asarray(npa(edges.dv_edge)[e_ord]),
        dc_edge=jnp.asarray(npa(edges.dc_edge)[e_ord]),
        angle_edge=jnp.asarray(npa(edges.angle_edge)[e_ord]),
        edge_mask=jnp.asarray(npa(edges.edge_mask)[e_ord]),
    )

    return horz.replace(cells=new_cells, duals=new_duals, edges=new_edges)
