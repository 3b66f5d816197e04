"""Vertical mesh.

Counterpart of the reference's `VerticalMesh`
(reference: src/infra/MPASMesh/VertMesh.jl:3-17). Carries the per-column
level bounds plus precomputed *level masks* so the tendency kernels are
dense masked ops over a static (elem, level) rectangle instead of per-column
ragged loops.

Deliberate fix of a reference quirk: the reference initializes its
ActiveLevels edge/vertex indices to 1 regardless of nVertLevels
(VertMesh.jl:31-36), silently restricting every k-loop to a single layer
(SURVEY quirk 7.1). Here `max_level_edge_top` is derived properly as
min(maxLevelCell of the two adjacent cells) — the derivation the legacy
mesh performs in meshMinMaxLevel! (src/infra/Mesh.jl:277-336) — so
multi-layer runs integrate every active layer.
"""

from __future__ import annotations

import numpy as np
import jax

from ..utils.pytree import pytree_dataclass, static_field
from .horz_mesh import HorzMesh


@pytree_dataclass
class VerticalMesh:
    n_vert_levels: int = static_field()

    min_level_cell: jax.Array  # (nCells,) int32, 0-based first active level
    max_level_cell: jax.Array  # (nCells,) int32, 1-past-last active level
    # edge/vertex active-level bounds (legacy Mesh.jl maxLevelEdgeTop/Bot)
    max_level_edge_top: jax.Array  # (nEdges,) int32: min over adjacent cells
    max_level_edge_bot: jax.Array  # (nEdges,) int32: max over adjacent cells
    max_level_vertex_top: jax.Array  # (nVertices,) int32
    max_level_vertex_bot: jax.Array  # (nVertices,) int32

    # layer thickness at rest [m], (nCells, nVertLevels)
    resting_thickness: jax.Array
    # total resting water-column thickness, (nCells,)
    resting_thickness_sum: jax.Array

    # dense {0,1} activity masks, float dtype of resting_thickness.
    # These are the legacy inventory's cellMask/edgeMask/vertexMask
    # (reference: src/infra/Mesh.jl:120-127) in 0/1 dense form.
    cell_level_mask: jax.Array  # (nCells, nVertLevels)
    edge_level_mask: jax.Array  # (nEdges, nVertLevels): k < max_level_edge_top
    vertex_level_mask: jax.Array  # (nVertices, nVertLevels)

    # resting ocean depth at cell centers [m] (reference: src/infra/
    # Mesh.jl:43 bottomDepth); equals the resting column sum for the
    # flat-bottom configs this framework generates, read from file otherwise
    bottom_depth: jax.Array  # (nCells,)
    # layer weights for distributing SSH perturbations in z-star-style
    # moving vertical coordinates (reference: src/infra/Mesh.jl:49
    # vertCoordMovementWeights; MPAS default: uniform 1.0)
    vert_coord_movement_weights: jax.Array  # (nVertLevels,)

    # legacy-name aliases (reference: Mesh.jl:120-127)
    @property
    def cell_mask(self) -> jax.Array:
        return self.cell_level_mask

    @property
    def vertex_mask(self) -> jax.Array:
        return self.vertex_level_mask


def _masks(min_lev, max_lev, n_levels, dtype):
    k = np.arange(n_levels)[None, :]
    return ((k >= min_lev[:, None]) & (k < max_lev[:, None])).astype(dtype)


def make_vertical_mesh(
    horz: HorzMesh,
    n_vert_levels: int = 1,
    resting_thickness=None,
    min_level_cell=None,
    max_level_cell=None,
    dtype=np.float64,
    bottom_depth=None,
    vert_coord_movement_weights=None,
) -> VerticalMesh:
    """Construct a vertical mesh over ``horz``.

    Defaults reproduce the reference's unit-test constructor (a stacked
    column of unit thickness, VertMesh.jl:92-117); pass
    ``resting_thickness`` (nCells, nVertLevels) for real configs.
    """
    n_cells = horz.n_cells
    n_edges = horz.n_edges
    n_vertices = horz.n_vertices

    if min_level_cell is None:
        min_level_cell = np.zeros(n_cells, dtype=np.int32)
    if max_level_cell is None:
        max_level_cell = np.full(n_cells, n_vert_levels, dtype=np.int32)
    if resting_thickness is None:
        resting_thickness = np.ones((n_cells, n_vert_levels), dtype=dtype)
    resting_thickness = np.asarray(resting_thickness, dtype=dtype)
    if resting_thickness.shape != (n_cells, n_vert_levels):
        raise ValueError(
            f"resting_thickness shape {resting_thickness.shape} != "
            f"({n_cells}, {n_vert_levels})"
        )

    coe = np.asarray(horz.edges.cells_on_edge)
    max_lc = np.asarray(max_level_cell)
    min_lc = np.asarray(min_level_cell)
    max_level_edge_top = np.minimum(max_lc[coe[:, 0]], max_lc[coe[:, 1]])
    max_level_edge_bot = np.maximum(max_lc[coe[:, 0]], max_lc[coe[:, 1]])
    cov = np.asarray(horz.duals.cells_on_vertex)
    max_level_vertex_top = np.min(max_lc[cov], axis=1)
    max_level_vertex_bot = np.max(max_lc[cov], axis=1)

    min_le = np.maximum(min_lc[coe[:, 0]], min_lc[coe[:, 1]])
    min_lv = np.max(min_lc[cov], axis=1)

    if bottom_depth is None:
        # flat-rest configs: depth at rest = active resting column sum
        cmask = _masks(min_lc, max_lc, n_vert_levels, dtype)
        bottom_depth = (resting_thickness * cmask).sum(axis=1)
    if vert_coord_movement_weights is None:
        vert_coord_movement_weights = np.ones(n_vert_levels, dtype=dtype)

    return VerticalMesh(
        n_vert_levels=n_vert_levels,
        min_level_cell=min_lc.astype(np.int32),
        max_level_cell=max_lc.astype(np.int32),
        max_level_edge_top=max_level_edge_top.astype(np.int32),
        max_level_edge_bot=max_level_edge_bot.astype(np.int32),
        max_level_vertex_top=max_level_vertex_top.astype(np.int32),
        max_level_vertex_bot=max_level_vertex_bot.astype(np.int32),
        resting_thickness=resting_thickness,
        resting_thickness_sum=resting_thickness.sum(axis=1),
        cell_level_mask=_masks(min_lc, max_lc, n_vert_levels, dtype),
        edge_level_mask=_masks(min_le, max_level_edge_top, n_vert_levels, dtype),
        vertex_level_mask=_masks(min_lv, max_level_vertex_top, n_vert_levels, dtype),
        bottom_depth=np.asarray(bottom_depth, dtype=dtype),
        vert_coord_movement_weights=np.asarray(
            vert_coord_movement_weights, dtype=dtype
        ),
    )
