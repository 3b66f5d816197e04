"""LINEARIZED shallow-water dynamics on the BSR path, with exact
q-step operator composition (A^q superstepping).

Why this exists: when the matrix path is bound by per-matmul dispatch
overhead, the direct attack is FEWER, DENSER matmuls. The PRODUCTION
step cannot be
composed: its thickness flux is u * c2e(h), bilinear in the state
(models/matrix_model._matrix_tendencies), so no fixed matrix represents
two chained steps. The classical LINEARIZED shallow-water system (flux
u * H_edge with H the RESTING thickness — the small-perturbation regime
every wave verification case in this repo runs in, reference:
README.MD:12 "gravity and Coriolis terms only") IS one affine map per
step, and q of them compose into one precomputed operator applied once
per q steps: q-fold fewer dispatches for ~the same streamed bytes.

The affine algebra: with state z = [h; u] stacked (nCells+nEdges, K) and
E = ones(K, K) (the level sum that forms ssh), one forward-Euler
linearized step is

    T(z) = A z + (C z) E + b 1^T

      A = [[I, -dt DIV diag(He)], [0, I + dt CORF]]
      C = [[0, 0], [-g dt GRAD, 0]]          (ssh coupling across levels)
      b = [0; g dt GRAD rts]

Because E^2 = K E, maps of this form are CLOSED under composition:

    T2 . T1:  A = A2 A1,  C = A2 C1 + C2 A1 + K C2 C1,
              b = A2 b1 + K C2 b1 + b2

so A^q / C^q / b^q are computed ONCE host-side (scipy.sparse) and applied
as one BSR matmul + one single-column matvec per q steps. Composition is
exact in real arithmetic; in floating point it reassociates sums, so f32
results drift at roundoff scale per application (test-pinned).

The composed operator's band roughly doubles per q-doubling, so bytes
per step stay about flat while dispatches fall q-fold; which q pays, if
any, is a measurement on the device. The composed operator is also the
exact q-step propagator (useful for stability/normal-mode analysis).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import GRAVITY
from ..ops.bsr import Bsr, bsr_matvec, build_bsr, trisk_coo
from ..utils.pytree import pytree_dataclass, static_field
from .shallow_water import PrognosticVars

__all__ = [
    "LinearizedMatrixModel",
    "linearized_ref_loop",
    "linearized_run_loop",
]


def _linear_operators(mesh):
    """scipy.sparse forms of the linearized step's operators, built from
    the SAME COO triplets as the BSR path (ops/bsr.trisk_coo) — one
    entry-level construction, so a sign-convention or weights fix there
    propagates here instead of drifting between the two matrix paths."""
    from scipy import sparse

    coo = trisk_coo(mesh)

    def csr(name):
        rows, cols, vals, shape = coo[name]
        return sparse.coo_matrix((vals, (rows, cols)), shape=shape).tocsr()

    return csr("grad"), csr("div"), csr("corf")


@pytree_dataclass
class LinearizedMatrixModel:
    """Precomposed q-step linearized operator (A^q, C^q, b^q) as BSR."""

    n_cells: int = static_field()
    n_edges: int = static_field()
    q: int = static_field()

    A: Bsr  # (nc+ne) x (nc+ne) composed state operator
    # composed level-sum coupling: one step's C has only a (u, h) block,
    # but composition fills (h, h) and (u, u) too (A1 C1 and C1 A1
    # products), so the full square operator is stored; it acts on the
    # COLUMN SUM of the state and broadcasts back over levels
    C: Bsr  # (nc+ne) x (nc+ne)
    b: jax.Array  # (nc+ne,) composed affine term
    he: jax.Array  # (nEdges,) resting edge thickness (diagnostics)
    resting_thickness_sum: jax.Array  # (nCells,)

    @classmethod
    def from_mesh(cls, mesh, dt: float, q: int = 4, bs: int = 128,
                  dtype=np.float32) -> "LinearizedMatrixModel":
        """Compose q forward-Euler linearized steps. Requires a 'clean'
        linear configuration: resting edge thickness uniform across levels
        and no bathymetry/wall masks (the identical-per-level structure is
        what lets K levels share one operator; masked/level-dependent
        configurations should use MatrixModel instead)."""
        from scipy import sparse

        horz, vert = mesh.horz, mesh.vert
        nc, ne = horz.cells.n_cells, horz.edges.n_edges
        rt = np.asarray(vert.resting_thickness, dtype=np.float64)
        coe = np.asarray(horz.edges.cells_on_edge)
        he_k = 0.5 * (rt[coe[:, 0]] + rt[coe[:, 1]])  # (ne, K)
        if not np.allclose(he_k, he_k[:, :1]):
            raise ValueError(
                "A^q composition needs per-level-uniform resting "
                "thickness (one operator shared by all K levels)"
            )
        elm = np.asarray(vert.edge_level_mask)
        emask = np.asarray(horz.edges.edge_mask)
        clm = np.asarray(vert.cell_level_mask)
        if not (np.all(elm == 1.0) and np.all(emask == 1.0)
                and np.all(clm == 1.0)):
            raise ValueError(
                "A^q composition supports unmasked (full-depth, wall-free) "
                "meshes; use MatrixModel for masked configurations"
            )
        he = he_k[:, 0]
        K = rt.shape[1]
        rts = np.asarray(vert.resting_thickness_sum, dtype=np.float64)

        GRAD, DIV, CORF = _linear_operators(mesh)
        I_c = sparse.identity(nc, format="csr")
        I_e = sparse.identity(ne, format="csr")
        # one linearized FE step in (A, C, b) form
        A1 = sparse.bmat(
            [
                [I_c, -dt * (DIV @ sparse.diags(he))],
                [None, I_e + dt * CORF],
            ],
            format="csr",
        )
        C1_uh = (-GRAVITY * dt) * GRAD  # acts on rowsum(h), lands on u
        b1_u = GRAVITY * dt * (GRAD @ rts)

        def lift_C(c_uh):
            return sparse.bmat(
                [
                    [sparse.csr_matrix((nc, nc)), sparse.csr_matrix((nc, ne))],
                    [c_uh, sparse.csr_matrix((ne, ne))],
                ],
                format="csr",
            )

        A, C, b = A1, lift_C(C1_uh), np.concatenate([np.zeros(nc), b1_u])
        for _ in range(q - 1):
            # compose another T1 AFTER the accumulated map (T1 . T):
            # A <- A1 A ; C <- A1 C + C1 A + K C1 C ; b <- A1 b + K C1 b + b1
            C1 = lift_C(C1_uh)
            b1 = np.concatenate([np.zeros(nc), b1_u])
            C = (A1 @ C) + (C1 @ A) + K * (C1 @ C)
            b = A1 @ b + K * (C1 @ b) + b1
            A = A1 @ A
        A = A.tocoo()
        C = C.tocoo()
        n = nc + ne
        return cls(
            n_cells=nc,
            n_edges=ne,
            q=int(q),
            A=build_bsr(A.row, A.col, A.data, n, n, bs, dtype),
            C=build_bsr(C.row, C.col, C.data, n, n, bs, dtype),
            b=jnp.asarray(b.astype(dtype)),
            he=jnp.asarray(he.astype(dtype)),
            resting_thickness_sum=jnp.asarray(rts.astype(dtype)),
        )

    @property
    def nbytes(self) -> int:
        return self.A.nbytes + self.C.nbytes


@partial(jax.jit, static_argnames=("n_steps",))
def _linearized_ref_loop(prog: PrognosticVars, mm, he, dt,
                         n_steps: int) -> PrognosticVars:
    """Step-by-step linearized rollout on the ordinary MatrixModel
    operators (flux = u * He with He = c2e(resting thickness))."""

    def body(p, _):
        h, u = p.layer_thickness, p.normal_velocity
        flux = u * he[:, None]
        tend_h = -bsr_matvec(mm.div, flux) * mm.cell_level_mask
        grad_ssh = bsr_matvec(mm.grad, p.ssh)
        tend_u = (-GRAVITY * grad_ssh[:, None]
                  + bsr_matvec(mm.corf, u)) * mm.edge_mask_lv
        h_new = h + dt * tend_h
        u_new = u + dt * tend_u
        ssh = (h_new * mm.cell_level_mask).sum(axis=1) \
            - mm.resting_thickness_sum
        return PrognosticVars(ssh=ssh, layer_thickness=h_new,
                              normal_velocity=u_new), None

    out, _ = jax.lax.scan(body, prog, length=n_steps)
    return out


def linearized_ref_loop(prog, mesh, dt, n_steps, dtype=np.float64):
    """Convenience: build the MatrixModel + resting He and run the
    step-by-step linearized rollout (the A^q parity reference)."""
    from .matrix_model import MatrixModel

    mm = MatrixModel.from_mesh(mesh, dtype=dtype)
    rt = np.asarray(mesh.vert.resting_thickness, dtype=np.float64)
    coe = np.asarray(mesh.horz.edges.cells_on_edge)
    he = jnp.asarray(
        (0.5 * (rt[coe[:, 0]] + rt[coe[:, 1]]))[:, 0].astype(dtype)
    )
    return _linearized_ref_loop(prog, mm, he, dtype(dt), n_steps)


@partial(jax.jit, static_argnames=("n_supersteps",))
def linearized_run_loop(prog: PrognosticVars, lmm: LinearizedMatrixModel,
                        n_supersteps: int) -> PrognosticVars:
    """n_supersteps applications of the composed q-step operator: per
    application ONE (nc+ne)-row BSR matmul over K columns + one
    single-column matvec for the level-sum (ssh) coupling + the affine
    term — q timesteps of linearized dynamics in ~1/q the dispatches of
    the step-by-step path."""
    nc = lmm.n_cells

    def body(z, _):
        y = bsr_matvec(lmm.A, z)
        zsum = z.sum(axis=1)  # the E (level-sum) coupling
        y = y + (bsr_matvec(lmm.C, zsum) + lmm.b)[:, None]
        return y, None

    z0 = jnp.concatenate([prog.layer_thickness, prog.normal_velocity])
    z, _ = jax.lax.scan(body, z0, length=n_supersteps)
    h = z[:nc]
    return PrognosticVars(
        ssh=h.sum(axis=1) - lmm.resting_thickness_sum,
        layer_thickness=h,
        normal_velocity=z[nc:],
    )
