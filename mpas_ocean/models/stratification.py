"""Layered (isopycnal) stratification: multi-layer baroclinic dynamics.

The reference integrates K vertical levels that never interact — every
level feels the same -g grad(ssh) surface pressure gradient (reference:
src/ocn/Tendencies/normalVelocity/pressure_gradient.jl:45-65), so its
"levels" are K independent copies of the barotropic problem. This module
upgrades the column to a REAL stacked-isopycnal model: each layer k carries
a density rho_k, and its pressure gradient is the gradient of the layer's
Montgomery potential

    Phi_k = g eta - sum_{l<k} g'_{lk} h_l,      g'_{lk} = g (rho_k - rho_l) / rho0

(the Boussinesq pressure-continuity result for stacked immiscible layers:
a deep layer feels the surface tilt *compensated* by the thickness of the
lighter layers above it). With equal densities every g' vanishes and
Phi_k = g eta for all k — the model reduces exactly to the reference's
barotropic stack, which the tests pin.

Formulation: Phi = g*eta + h @ W with W a static (K, K)
strictly-lower-triangular matrix, i.e. ONE tiny level-contracting matmul
per step feeding the existing edge-gradient operator — no new stencils, so
the gather, matrix, and roll paths (and the unstructured sharded model,
where Phi is a purely local column operation) share the formulation
unchanged.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import GRAVITY
from .forcing import RHO0
from ..utils.pytree import pytree_dataclass

__all__ = [
    "Stratification",
    "make_stratification",
    "montgomery_potential",
    "baroclinic_wave_speeds",
]


@pytree_dataclass
class Stratification:
    """Static column coupling for layered baroclinic dynamics.

    ``phi_weights`` is the (K, K) matrix W with
    W[l, k] = -g (rho_k - rho_l)/rho0 for l < k and 0 otherwise, so the
    Montgomery potential is Phi = g*eta[:, None] + h @ W.
    """

    phi_weights: jax.Array  # (K, K)
    densities: jax.Array  # (K,) — kept for diagnostics/IO


def make_stratification(densities, rho0: float = RHO0, g: float = GRAVITY,
                        dtype=None) -> Stratification:
    """Build a :class:`Stratification` from per-layer densities (top first).

    Densities must be non-decreasing downward (statically stable column);
    equal densities are allowed (those layer pairs decouple).
    """
    rho = np.asarray(densities, dtype=np.float64)
    if rho.ndim != 1:
        raise ValueError(f"densities must be 1-D (K,), got shape {rho.shape}")
    if np.any(np.diff(rho) < 0):
        raise ValueError(
            "densities must be non-decreasing downward (stable column); "
            f"got {rho.tolist()}"
        )
    k = rho.shape[0]
    if dtype is None:
        dtype = np.float64
    w = np.zeros((k, k), dtype=np.float64)
    for kk in range(k):
        for ll in range(kk):
            w[ll, kk] = -g * (rho[kk] - rho[ll]) / rho0
    return Stratification(
        phi_weights=jnp.asarray(w.astype(dtype)),
        densities=jnp.asarray(rho.astype(dtype)),
    )


def montgomery_potential(ssh, layer_thickness, strat: Stratification):
    """Phi (nCells, K) = g*eta + h @ W — works on any layout whose level
    axis is last (unstructured (nC, K) or lattice (2, ny2, nx, K))."""
    g = jnp.asarray(GRAVITY, layer_thickness.dtype)
    w = strat.phi_weights.astype(layer_thickness.dtype)
    # HIGHEST precision: the K x K contraction is tiny, and a reduced-
    # precision f32 matmul (TF32 or bf16 inputs) would put ~0.1-0.4% noise
    # on the baroclinic pressure terms
    return g * ssh[..., None] + jnp.matmul(
        layer_thickness, w, precision=jax.lax.Precision.HIGHEST
    )


def baroclinic_wave_speeds(densities, layer_depths, rho0: float = RHO0,
                           g: float = GRAVITY) -> np.ndarray:
    """Linear gravity-wave mode speeds of the stratified column at rest
    (flat bottom, no rotation): eigenvalues of the shallow-water coupling
    matrix A[k, l] = H_k * dPhi_k/dh_l, with c_m = sqrt(eig_m). Mode 0 is
    the barotropic ~sqrt(g H_total); higher modes are the internal waves
    (two layers: c1^2 ~ g' H1 H2 / (H1 + H2)). Used by the verification
    tests to pin the baroclinic dynamics against analytic speeds."""
    rho = np.asarray(densities, dtype=np.float64)
    h = np.asarray(layer_depths, dtype=np.float64)
    k = rho.shape[0]
    # dPhi_k/deta = g and deta/dh_l = 1; dPhi_k/dh_l -= g'(l,k) for l < k
    dphi = np.full((k, k), g)
    for kk in range(k):
        for ll in range(kk):
            dphi[kk, ll] -= g * (rho[kk] - rho[ll]) / rho0
    a = h[:, None] * dphi  # d(h_k u_k)/dt coupling, linearized
    eig = np.linalg.eigvals(a)
    return np.sort(np.sqrt(np.abs(eig.real)))[::-1]
