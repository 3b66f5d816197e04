"""Horizontal TRiSK mesh as immutable pytrees of padded, masked arrays.

Re-design of the reference's SoA mesh structs (reference:
src/infra/MPASMesh/HorzMesh.jl:45-162). Differences that matter for XLA:

  * connectivity is **0-based int32**, padded with index 0 — the reference
    uses 1-based arrays padded with 0 and skips padding with in-kernel
    branches (e.g. horizontal_advection_and_coriolis.jl:67). Here padding
    slots carry a *zero weight/sign/mask* instead, so gathers are branch-free
    and every reduction is a masked dense sum that vectorizes.
  * sign fields (`edge_sign_on_cell`, `edge_sign_on_vertex`,
    HorzMesh.jl:292-332) are stored as float with 0.0 on padded slots,
    fusing the sign and the validity mask into one multiplier.
  * element-major layout `(nElem, ...)`: neighbor axis and vertical-level
    axis trail, so levels are the contiguous innermost axis.

All dimension sizes are static aux data so `jit` sees fixed shapes.
"""

from __future__ import annotations

import numpy as np
import jax

from ..utils.pytree import pytree_dataclass, static_field


@pytree_dataclass
class PrimaryCells:
    """Voronoi (polygon) cells of the primary mesh."""

    n_cells: int = static_field()
    max_edges: int = static_field()

    # coordinates of cell centers
    x: jax.Array  # (nCells,)
    y: jax.Array
    z: jax.Array
    # Coriolis parameter at cell centers
    f: jax.Array  # (nCells,)

    area_cell: jax.Array  # (nCells,)

    n_edges_on_cell: jax.Array  # (nCells,) int32
    edges_on_cell: jax.Array  # (nCells, maxEdges) int32, 0-based, pad=0
    vertices_on_cell: jax.Array  # (nCells, maxEdges) int32
    cells_on_cell: jax.Array  # (nCells, maxEdges) int32
    # +/-1 on valid slots, 0.0 on padding; -1 when this cell is
    # cells_on_edge[:, 0] for that edge (outward normal convention,
    # HorzMesh.jl:297-307)
    edge_sign_on_cell: jax.Array  # (nCells, maxEdges) float
    # 1.0 valid / 0.0 padded neighbor slots
    edge_mask_on_cell: jax.Array  # (nCells, maxEdges) float
    # kite areas in the cell frame: kite_on_cell[c, i] is the area of the
    # quadrilateral (cell center, mid(edge_i), vertex_i, mid(edge_{i+1}))
    # where vertex_i sits between edge_i and edge_{i+1} (CCW). Covers the
    # legacy field inventory's kiteIndexOnCell role (reference:
    # src/infra/Mesh.jl:24-157) in cell-major layout.
    kite_areas_on_cell: jax.Array  # (nCells, maxEdges) float


@pytree_dataclass
class DualCells:
    """Delaunay triangle (dual) cells, one per mesh vertex."""

    n_vertices: int = static_field()
    vertex_degree: int = static_field()

    x: jax.Array  # (nVertices,)
    y: jax.Array
    z: jax.Array
    f: jax.Array  # Coriolis at vertices

    area_triangle: jax.Array  # (nVertices,)

    edges_on_vertex: jax.Array  # (nVertices, vertexDegree) int32
    cells_on_vertex: jax.Array  # (nVertices, vertexDegree) int32
    # +/-1 (0.0 pad): -1 when this vertex is vertices_on_edge[:, 0]
    # (HorzMesh.jl:311-332)
    edge_sign_on_vertex: jax.Array  # (nVertices, vertexDegree) float
    # kite areas aligned with cells_on_vertex (legacy Mesh.jl field
    # kiteAreasOnVertex)
    kite_areas_on_vertex: jax.Array  # (nVertices, vertexDegree) float


@pytree_dataclass
class Edges:
    """Edges of the primary mesh (velocity points)."""

    n_edges: int = static_field()
    max_edges2: int = static_field()  # width of the edges_on_edge axis

    x: jax.Array  # (nEdges,)
    y: jax.Array
    z: jax.Array
    f: jax.Array  # Coriolis at edges

    cells_on_edge: jax.Array  # (nEdges, 2) int32; normal points cell0 -> cell1
    vertices_on_edge: jax.Array  # (nEdges, 2) int32; z_hat x normal points v0 -> v1

    n_edges_on_edge: jax.Array  # (nEdges,) int32
    edges_on_edge: jax.Array  # (nEdges, maxEdges2) int32, pad=0
    # TRiSK tangential-reconstruction weights; 0.0 on padded slots so the
    # Coriolis gather needs no mask
    weights_on_edge: jax.Array  # (nEdges, maxEdges2) float

    dv_edge: jax.Array  # (nEdges,) dual-edge (vertex-to-vertex) length
    dc_edge: jax.Array  # (nEdges,) cell-to-cell distance
    angle_edge: jax.Array  # (nEdges,) angle of the edge normal vs. east

    # 1.0 for active edges, 0.0 for boundary-closed edges (u forced to 0).
    # All ones on periodic meshes; used by the Kelvin-wave style configs
    # (legacy field inventory: boundaryEdge/edgeMask, Mesh.jl:24-157).
    edge_mask: jax.Array  # (nEdges,)


@pytree_dataclass
class HorzMesh:
    """A 2-D TRiSK mesh: primary cells + dual cells + edges
    (HorzMesh.jl:45-49)."""

    cells: PrimaryCells
    duals: DualCells
    edges: Edges

    # Periodic planar extent (0.0 for spherical meshes); static metadata.
    lx: float = static_field()
    ly: float = static_field()
    on_sphere: bool = static_field(default=False)
    sphere_radius: float = static_field(default=0.0)

    @property
    def n_cells(self) -> int:
        return self.cells.n_cells

    @property
    def n_edges(self) -> int:
        return self.edges.n_edges

    @property
    def n_vertices(self) -> int:
        return self.duals.n_vertices

    def astype(self, dtype) -> "HorzMesh":
        """Cast all floating-point leaves to ``dtype`` (ints untouched)."""

        def cast(leaf):
            if np.issubdtype(np.asarray(leaf).dtype, np.floating):
                return np.asarray(leaf).astype(dtype)
            return leaf

        return jax.tree.map(cast, self)

    def to_device(self, sharding=None) -> "HorzMesh":
        """Move every leaf onto the default device (or given sharding)."""
        if sharding is None:
            return jax.tree.map(jax.numpy.asarray, self)
        return jax.device_put(self, sharding)
