"""Block-sparse (BSR) matmul formulation of the TRiSK stencil operators.

Each linear TRiSK operator (cell->edge interpolation, ssh gradient, flux
divergence, Coriolis/tangential reconstruction, curl) IS a sparse matrix
with static sparsity. This module stores it as dense 128x128 blocks over a
block-banded pattern and applies it with batched matmuls, so the
general-mesh step needs no per-element row gathers; the only remaining
gather moves whole (128, K)-row blocks. Whether this beats the gather
formulation (ops/operators.py) on a given device is a measurement: the
structural cost is within-block sparsity (~1.6% density) that no
dense-block schedule recovers. Meshes with lattice structure should use
structured/; this path is a general-mesh alternative.

Matrix entries mirror ops/operators.py exactly (same values, same padding
conventions — padded connectivity slots carry zero weight/sign and generate
no entries), which in turn mirror the reference's KernelAbstractions kernels
(reference: src/ocn/Operators.jl:12-222,
src/ocn/Tendencies/normalVelocity/horizontal_advection_and_coriolis.jl:50-75).

Mesh locality matters: the bandwidth of the block pattern (B = max distinct
input blocks per output block-row) scales the matrix bytes. Generated hex
meshes are row-major (B ~ 3-4); arbitrary NetCDF meshes should be RCM-
reordered first (native/mesh_preprocess.cpp).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.pytree import pytree_dataclass, static_field

__all__ = ["Bsr", "build_bsr", "bsr_matvec", "trisk_coo", "trisk_matrices"]


def trisk_coo(mesh) -> dict:
    """COO triplets of the step's linear TRiSK operators:
    ``{name: (rows, cols, vals, (n_out, n_in))}`` for grad / c2e / div /
    corf / curl. This is the SINGLE entry-level construction consumed by
    both trisk_matrices (the BSR path) and models/linear_matrix (the
    A^q composed operator), so a sign-convention or weights fix here
    propagates to every matrix-path consumer at once. Entries mirror
    ops/operators.py exactly (reference: src/ocn/Operators.jl:12-222,
    .../horizontal_advection_and_coriolis.jl:50-75); padded connectivity
    slots carry zero weight/sign so they generate zero-valued entries."""
    horz = mesh.horz if hasattr(mesh, "horz") else mesh
    cells, edges, duals = horz.cells, horz.edges, horz.duals
    nc, ne, nv = cells.n_cells, edges.n_edges, duals.n_vertices

    coe = np.asarray(edges.cells_on_edge)
    dc = np.asarray(edges.dc_edge, dtype=np.float64)
    dv = np.asarray(edges.dv_edge, dtype=np.float64)
    e_ids = np.arange(ne)

    # gradient and interpolation share the cells_on_edge pattern
    g_rows = np.concatenate([e_ids, e_ids])
    g_cols = np.concatenate([coe[:, 1], coe[:, 0]])

    # divergence: div_i = -(1/A_i) sum_s sign_{i,s} dv_e F_e
    eoc = np.asarray(cells.edges_on_cell)
    sign = np.asarray(cells.edge_sign_on_cell, dtype=np.float64)
    area = np.asarray(cells.area_cell, dtype=np.float64)
    c_ids = np.repeat(np.arange(nc), eoc.shape[1])

    # Coriolis: tend_e += sum_j w_{e,j} f[eoe_j] u[eoe_j]
    eoe = np.asarray(edges.edges_on_edge)
    w = np.asarray(edges.weights_on_edge, dtype=np.float64)
    f = np.asarray(edges.f, dtype=np.float64)
    r = np.repeat(e_ids, eoe.shape[1])

    # curl: zeta_v = (1/A_v) sum_j dc_e sign_{v,j} u_e
    eov = np.asarray(duals.edges_on_vertex)
    vsign = np.asarray(duals.edge_sign_on_vertex, dtype=np.float64)
    atri = np.asarray(duals.area_triangle, dtype=np.float64)
    v_ids = np.repeat(np.arange(nv), eov.shape[1])

    return {
        "grad": (g_rows, g_cols,
                 np.concatenate([1.0 / dc, -1.0 / dc]), (ne, nc)),
        "c2e": (g_rows, g_cols, np.full(2 * ne, 0.5), (ne, nc)),
        "div": (c_ids, eoc.ravel(),
                (-(sign * dv[eoc]) / area[:, None]).ravel(), (nc, ne)),
        "corf": (r, eoe.ravel(), (w * f[eoe]).ravel(), (ne, ne)),
        "curl": (v_ids, eov.ravel(),
                 (vsign * dc[eov] / atri[:, None]).ravel(), (nv, ne)),
    }


@pytree_dataclass
class Bsr:
    """One block-sparse matrix: y = A @ x with dense (bs_r, bs_c) blocks.

    Storage is banded-plus-overflow: every block-row stores `band` slots in
    the dense (nb_out, band, bs_r, bs_c) tensor, and the few block-rows wider
    than the band (e.g. periodic-wrap rows) spill their extra blocks into a
    block-COO overflow list — the band is chosen to minimize total bytes, so
    a handful of wide rows doesn't pad the whole matrix.

    Blocks may be rectangular: TRiSK stencils have 2-11 nonzeros per row, so
    the stored-entry count (which sets both the bytes streamed and the
    FLOPs spent per apply) shrinks as the block narrows, at the cost of
    smaller batched matmuls. (128, 128) is the default."""

    n_out: int = static_field()
    n_in: int = static_field()
    bs_r: int = static_field()
    bs_c: int = static_field()

    block_cols: jax.Array  # (nb_out, B) int32 — input block index per slot
    blocks: jax.Array  # (nb_out, B, bs_r, bs_c)
    ov_rows: jax.Array  # (M,) int32 — overflow output block index
    ov_cols: jax.Array  # (M,) int32 — overflow input block index
    ov_blocks: jax.Array  # (M, bs_r, bs_c)

    @property
    def bs(self) -> int:
        """Square-block size (back-compat; rejects rectangular blocks)."""
        if self.bs_r != self.bs_c:
            raise ValueError(
                f"Bsr.bs is only defined for square blocks; this matrix has "
                f"bs_r={self.bs_r}, bs_c={self.bs_c} — use bs_r/bs_c"
            )
        return self.bs_r

    @property
    def nb_out(self) -> int:
        return self.block_cols.shape[0]

    @property
    def band(self) -> int:
        return self.block_cols.shape[1]

    @property
    def n_overflow(self) -> int:
        return self.ov_rows.shape[0]

    @property
    def nbytes(self) -> int:
        return np.asarray(self.blocks).nbytes + np.asarray(self.ov_blocks).nbytes

    @property
    def density(self) -> float:
        """Fraction of stored block entries that are nonzero."""
        nnz = float(np.count_nonzero(np.asarray(self.blocks)))
        nnz += float(np.count_nonzero(np.asarray(self.ov_blocks)))
        return nnz / (self.blocks.size + self.ov_blocks.size + 1e-300)


def build_bsr(rows, cols, vals, n_out: int, n_in: int, bs: int = 128,
              dtype=np.float32, bs_r: int | None = None,
              bs_c: int | None = None) -> Bsr:
    """Assemble a Bsr from COO triplets (host-side, numpy).

    Duplicate (row, col) entries accumulate, matching the `+=` semantics of
    the stencil kernels they replace. `bs` sets square blocks; `bs_r`/`bs_c`
    override row/column block sizes independently.
    """
    bs_r = bs if bs_r is None else bs_r
    bs_c = bs if bs_c is None else bs_c
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.float64)
    keep = vals != 0.0
    rows, cols, vals = rows[keep], cols[keep], vals[keep]

    nbo = -(-n_out // bs_r)
    nbi = -(-n_in // bs_c)
    br, bc = rows // bs_r, cols // bs_c

    # distinct input blocks per output block-row, ordered by nnz count so
    # the widely-used blocks land in the banded slots
    from collections import Counter

    per_row: list[Counter] = [Counter() for _ in range(nbo)]
    for b, c in zip(br, bc):
        per_row[b][c] += 1
    widths = np.array([len(d) for d in per_row], dtype=np.int64)
    max_w = int(widths.max()) if len(widths) else 1

    # band minimizing effective cost. An overflow block costs ~4x a banded
    # block at run time (separate einsum + block scatter-add), so it only
    # pays for true outlier rows (e.g. periodic wraps), not the common case.
    best_band, best_cost = max(max_w, 1), None
    for cand in range(1, max(max_w, 1) + 1):
        cost = nbo * cand + 4 * int(np.maximum(widths - cand, 0).sum())
        if best_cost is None or cost < best_cost:
            best_band, best_cost = cand, cost
    band = best_band

    slot_of: list[dict[int, int]] = []
    ov_index: dict[tuple[int, int], int] = {}
    ov_rows, ov_cols = [], []
    for b, d in enumerate(per_row):
        ordered = [c for c, _ in d.most_common()]
        m = {c: i for i, c in enumerate(ordered[:band])}
        slot_of.append(m)
        for c in ordered[band:]:
            ov_index[(b, c)] = len(ov_rows)
            ov_rows.append(b)
            ov_cols.append(c)

    block_cols = np.zeros((nbo, band), dtype=np.int32)
    for b, m in enumerate(slot_of):
        for c, slot in m.items():
            block_cols[b, slot] = c

    blocks = np.zeros((nbo, band, bs_r, bs_c), dtype=np.float64)
    n_ov = len(ov_rows)
    ov_blocks = np.zeros((n_ov, bs_r, bs_c), dtype=np.float64)
    for b, c, r, co, v in zip(br, bc, rows % bs_r, cols % bs_c, vals):
        s = slot_of[b].get(c)
        if s is None:
            ov_blocks[ov_index[(b, c)], r, co] += v
        else:
            blocks[b, s, r, co] += v

    return Bsr(
        n_out=int(n_out),
        n_in=int(n_in),
        bs_r=int(bs_r),
        bs_c=int(bs_c),
        block_cols=jnp.asarray(block_cols),
        blocks=jnp.asarray(blocks.astype(dtype)),
        ov_rows=jnp.asarray(np.asarray(ov_rows, dtype=np.int32)),
        ov_cols=jnp.asarray(np.asarray(ov_cols, dtype=np.int32)),
        ov_blocks=jnp.asarray(ov_blocks.astype(dtype)),
    )


def bsr_matvec(A: Bsr, x: jnp.ndarray) -> jnp.ndarray:
    """y = A @ x for x of shape (n_in,) or (n_in, K)."""
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    k = x.shape[1]
    nbi = -(-A.n_in // A.bs_c)
    pad = nbi * A.bs_c - A.n_in
    if pad:
        x = jnp.concatenate([x, jnp.zeros((pad, k), x.dtype)], axis=0)
    xb = x.reshape(nbi, A.bs_c, k)
    xg = xb[A.block_cols]  # (nb_out, B, bs, K) — block-granular take
    # HIGHEST: an f32 product may otherwise run in TF32 on a GPU (about
    # three decimal digits), which the f32 path-parity tolerances exclude
    y = jnp.einsum(
        "obij,objk->oik", A.blocks.astype(x.dtype), xg,
        preferred_element_type=x.dtype,
        precision=jax.lax.Precision.HIGHEST,
    )
    if A.n_overflow:
        y2 = jnp.einsum(
            "mij,mjk->mik", A.ov_blocks.astype(x.dtype), xb[A.ov_cols],
            preferred_element_type=x.dtype,
            precision=jax.lax.Precision.HIGHEST,
        )
        y = y.at[A.ov_rows].add(y2)
    y = y.reshape(-1, k)[: A.n_out]
    return y[:, 0] if squeeze else y


def trisk_matrices(mesh, bs: int = 128, dtype=np.float32,
                   nonlinear: bool = False) -> dict:
    """Build the step's linear operators as Bsr matrices from a Mesh.

    Returns dict with keys:
      grad  (nEdges x nCells): (ssh[c2]-ssh[c1])/dc       [operators.py:44]
      c2e   (nEdges x nCells): 0.5 (h[c1]+h[c2])          [operators.py:84]
      div   (nCells x nEdges): outward-flux divergence    [operators.py:54]
      corf  (nEdges x nEdges): sum_j w_j f[eoe_j] u[eoe_j] [operators.py:91]
      curl  (nVertices x nEdges): circulation/areaTri     [operators.py:70]

    With ``nonlinear=True``, also the operators of the vector-invariant
    momentum equation (every nonlinearity is an ELEMENTWISE product between
    linear operator applications, so the whole nonlinear step stays
    matmuls):
      tang (nEdges x nEdges): weights-only tangential sum_j w_j x[eoe_j]
      c2v  (nVertices x nCells): kite-area average (partial-kite normalized)
      v2e  (nEdges x nVertices): endpoint mean
      ke   (nCells x nEdges): (dc dv / 4 A_c) applied to u^2
    """
    horz = mesh.horz if hasattr(mesh, "horz") else mesh
    cells, edges, duals = horz.cells, horz.edges, horz.duals
    nc, ne, nv = cells.n_cells, edges.n_edges, duals.n_vertices

    mats = {
        name: build_bsr(rows, cols, vals, n_out, n_in, bs, dtype)
        for name, (rows, cols, vals, (n_out, n_in)) in trisk_coo(mesh).items()
    }
    if not nonlinear:
        return mats

    coe = np.asarray(edges.cells_on_edge)
    dc = np.asarray(edges.dc_edge, dtype=np.float64)
    dv = np.asarray(edges.dv_edge, dtype=np.float64)
    e_ids = np.arange(ne)
    eoc = np.asarray(cells.edges_on_cell)
    area = np.asarray(cells.area_cell, dtype=np.float64)
    c_ids = np.repeat(np.arange(nc), eoc.shape[1])
    eoe = np.asarray(edges.edges_on_edge)
    w = np.asarray(edges.weights_on_edge, dtype=np.float64)
    r = np.repeat(e_ids, eoe.shape[1])

    # weights-only tangential reconstruction (models/shallow_water.py
    # pv_flux_tendency applies it to the thickness flux twice)
    mats["tang"] = build_bsr(r, eoe.ravel(), w.ravel(), ne, ne, bs, dtype)

    # kite-area cell->vertex average, normalized by the PARTIAL kite sum so
    # boundary vertices of culled meshes stay unbiased
    # (ops/operators.interpolate_cell_to_vertex)
    cov = np.asarray(duals.cells_on_vertex)
    kite = np.asarray(duals.kite_areas_on_vertex, dtype=np.float64)
    ksum = kite.sum(axis=1)
    ksum = np.where(ksum > 0, ksum, 1.0)
    mats["c2v"] = build_bsr(
        np.repeat(np.arange(nv), cov.shape[1]),
        cov.ravel(),
        (kite / ksum[:, None]).ravel(),
        nv, nc, bs, dtype,
    )

    # vertex->edge endpoint mean (ops/operators.interpolate_vertex_to_edge)
    voe = np.asarray(edges.vertices_on_edge)
    mats["v2e"] = build_bsr(
        np.concatenate([e_ids, e_ids]),
        np.concatenate([voe[:, 0], voe[:, 1]]),
        np.full(2 * ne, 0.5),
        ne, nv, bs, dtype,
    )

    # cell kinetic energy applied to u^2: KE_c = sum_e (dc dv/4)/A_c u_e^2
    # (models/shallow_water.kinetic_energy_on_cell); padded edges_on_cell
    # slots are zeroed via the edge mask-on-cell weights
    emoc = np.asarray(cells.edge_mask_on_cell, dtype=np.float64)
    ke_vals = (0.25 * dc[eoc] * dv[eoc]) * emoc / area[:, None]
    mats["ke"] = build_bsr(c_ids, eoc.ravel(), ke_vals.ravel(), nc, ne, bs, dtype)
    return mats


def del2_matrix_coo(mesh):
    """COO triplets of the del2 momentum operator, composed symbolically:

        del2 = Gdiv @ DIV - Gvort @ CURL   (nEdges x nEdges)

    where Gdiv takes cell divergence differences across the edge and Gvort
    takes vertex vorticity differences along it — exactly the repaired
    formulation in models/shallow_water.del2_tendency (the reference ships
    it dead and broken, normalVelocity/horizontal_momentum_mixing.jl:74-79).
    Because it is linear in u it can be FOLDED INTO the Coriolis matrix, so
    del2 mixing is free at run time on the matrix path.
    """
    from scipy import sparse

    horz = mesh.horz if hasattr(mesh, "horz") else mesh
    cells, edges, duals = horz.cells, horz.edges, horz.duals
    nc, ne, nv = cells.n_cells, edges.n_edges, duals.n_vertices
    dc = np.asarray(edges.dc_edge, dtype=np.float64)
    dv = np.asarray(edges.dv_edge, dtype=np.float64)
    coe = np.asarray(edges.cells_on_edge)
    voe = np.asarray(edges.vertices_on_edge)
    e_ids = np.arange(ne)

    # DIV (nc x ne) and CURL (nv x ne), same values as trisk_matrices
    eoc = np.asarray(cells.edges_on_cell)
    sign = np.asarray(cells.edge_sign_on_cell, dtype=np.float64)
    area = np.asarray(cells.area_cell, dtype=np.float64)
    DIV = sparse.coo_matrix(
        (
            (-(sign * dv[eoc]) / area[:, None]).ravel(),
            (np.repeat(np.arange(nc), eoc.shape[1]), eoc.ravel()),
        ),
        shape=(nc, ne),
    ).tocsr()
    eov = np.asarray(duals.edges_on_vertex)
    vsign = np.asarray(duals.edge_sign_on_vertex, dtype=np.float64)
    atri = np.asarray(duals.area_triangle, dtype=np.float64)
    CURL = sparse.coo_matrix(
        (
            (vsign * dc[eov] / atri[:, None]).ravel(),
            (np.repeat(np.arange(nv), eov.shape[1]), eov.ravel()),
        ),
        shape=(nv, ne),
    ).tocsr()

    # Gdiv (ne x nc): (div[c2] - div[c1]) / dc ; Gvort (ne x nv)
    Gdiv = sparse.coo_matrix(
        (
            np.concatenate([1.0 / dc, -1.0 / dc]),
            (np.concatenate([e_ids, e_ids]), np.concatenate([coe[:, 1], coe[:, 0]])),
        ),
        shape=(ne, nc),
    ).tocsr()
    Gvort = sparse.coo_matrix(
        (
            np.concatenate([1.0 / dv, -1.0 / dv]),
            (np.concatenate([e_ids, e_ids]), np.concatenate([voe[:, 1], voe[:, 0]])),
        ),
        shape=(ne, nv),
    ).tocsr()

    D2 = (Gdiv @ DIV - Gvort @ CURL).tocoo()
    return D2.row, D2.col, D2.data
