"""Tracer transport: thickness-weighted advection (+ optional del2 mixing)
of cell tracers — temperature, salinity, or any passive field.

The reference RECOGNIZES tracers but ships them stubbed out: its
PrognosticVars carries commented-out temperature/salinity slots (reference:
src/ocn/PrognosticVars.jl:20-26) and no tracer tendency exists anywhere.
This module fills that surface with the standard MPAS-Ocean shallow-water
tracer equation in flux form,

    d(h T)/dt = -div( F * T_e ) + div( kappa * h_e * grad T )

where F = h_e u is the thickness flux every path already computes for the
continuity equation, and T_e is the edge-reconstructed tracer value.

Edge reconstruction is a centered/upwind blend expressed entirely through
the two linear operators the framework already has on every execution path
(cell->edge mean and edge-normal gradient):

    T_e = mean(T) - (beta/2) * sign(F) * dc_e * gradT_e

beta = 0 is the second-order centered mean; beta = 1 is the first-order
monotone donor-cell upwind value (exactly: T_e = T_upwind-cell, since
mean -+ dc*grad/2 selects one endpoint); 0 < beta < 1 blends. The blend is
the whole scheme — no new stencils — which is what lets the gather,
matrix, roll and sharded paths agree to f64 roundoff (the same design
point as models/forcing.py).

Consistency with continuity: a uniform tracer T == c has T_e == c on every
edge (mean = c, grad = 0), so d(hT)/dt = c * d(h)/dt and T stays exactly c
— tests pin this to roundoff. Total tracer content sum_i A_i (h T)_i is
conserved on closed/periodic meshes (the flux-form divergence telescopes).

Tracer arrays are (nCells, nTracers, K): the element axis first (all
operators gather on axis 0), levels last (contiguous), the tracer axis a
small static middle dimension batched for free.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.operators import (
    divergence_on_cell,
    gradient_on_edge,
    interpolate_cell_to_edge,
)

__all__ = [
    "make_tracers",
    "tracer_edge_value",
    "tracer_tendency",
    "apply_tracer_update",
    "tracer_concentration",
    "total_tracer_content",
]


def make_tracers(mesh, fields, dtype=None) -> jnp.ndarray:
    """Stack per-cell tracer fields into the (nCells, nT, K) tracer array.

    ``fields``: sequence of arrays, each (nCells,) (replicated over levels)
    or (nCells, K). Inactive levels (below bathymetry) are zeroed.
    """
    vert = mesh.vert if hasattr(mesh, "vert") else None
    horz = mesh.horz if hasattr(mesh, "horz") else mesh
    nc = horz.cells.n_cells
    k = vert.n_vert_levels if vert is not None else 1
    cols = []
    for f in fields:
        a = np.asarray(f, dtype=np.float64)
        if a.shape == (nc,):
            a = np.repeat(a[:, None], k, axis=1)
        if a.shape != (nc, k):
            raise ValueError(
                f"tracer field must be ({nc},) or ({nc}, {k}); got {a.shape}"
            )
        cols.append(a)
    out = np.stack(cols, axis=1)  # (nC, nT, K)
    if vert is not None:
        out = out * np.asarray(vert.cell_level_mask)[:, None, :]
    if dtype is None:
        dtype = np.asarray(horz.cells.area_cell).dtype
    return jnp.asarray(out.astype(dtype))


def tracer_edge_value(
    tracers: jnp.ndarray, thickness_flux: jnp.ndarray, mesh, upwind
) -> jnp.ndarray:
    """Edge tracer value: centered mean minus the upwind correction.

    ``tracers`` (nCells, nT, K), ``thickness_flux`` (nEdges, K) ->
    (nEdges, nT, K). ``upwind`` in [0, 1]; sign(F) = 0 at F = 0 degrades
    gracefully to the centered value there (the flux is zero anyway).
    """
    t_e = interpolate_cell_to_edge(tracers, mesh)
    if upwind:
        g = gradient_on_edge(tracers, mesh)
        half_dc = (0.5 * upwind) * mesh.edges.dc_edge[:, None, None]
        # sign convention: F > 0 flows from cells_on_edge[0] to [1]
        # (divergence treats the [0]->[1] normal as outward from [0]), so
        # the donor cell is [0] and T_e = mean - dc/2 * grad = T[c0].
        t_e = t_e - half_dc * jnp.sign(thickness_flux[:, None, :]) * g
    return t_e


def tracer_tendency(
    tracers: jnp.ndarray,
    thickness_flux: jnp.ndarray,
    mesh,
    kappa: float = 0.0,
    upwind: float = 1.0,
    h_edge: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """d(hT)/dt at cells: -div(F T_e) [+ div(kappa h_e grad T)].

    ``kappa`` [m^2/s] adds thickness-weighted del2 tracer mixing using the
    ``h_edge`` the caller already computed for the flux. Closed-boundary
    edges carry F = 0 (u is pinned there), and the diffusive flux is masked
    by the edge mask, so no tracer leaks through walls.
    """
    t_e = tracer_edge_value(tracers, thickness_flux, mesh, upwind)
    flux = thickness_flux[:, None, :] * t_e  # (nE, nT, K)
    if kappa:
        if h_edge is None:
            raise ValueError("tracer diffusion needs h_edge")
        g = gradient_on_edge(tracers, mesh)
        diff = (kappa * h_edge * mesh.vert.edge_level_mask
                * mesh.edges.edge_mask[:, None])[:, None, :] * g
        flux = flux - diff
    tend = -divergence_on_cell(flux, mesh)
    return tend * mesh.vert.cell_level_mask[:, None, :]


def tracer_concentration(
    content: jnp.ndarray, h: jnp.ndarray, cell_level_mask: jnp.ndarray
) -> jnp.ndarray:
    """T = content / h on active levels (content is h*T; (nCells, nT, K)).

    The canonical masked divide every unstructured path shares (the
    structured planes have their own layout variant): live cells divide by
    h unconditionally, inactive levels stay exactly zero.
    """
    mask = cell_level_mask[:, None, :]
    safe_h = jnp.where(mask > 0, h[:, None, :], jnp.ones_like(mask))
    return content / safe_h * mask


def apply_tracer_update(
    tracers: jnp.ndarray,
    h_old: jnp.ndarray,
    h_new: jnp.ndarray,
    tend_hT: jnp.ndarray,
    dt,
    cell_level_mask: jnp.ndarray,
) -> jnp.ndarray:
    """T_new = (h_old T + dt d(hT)/dt) / h_new on active levels.

    The prognostic quantity is the CONTENT h T (what the flux form
    conserves); the carried state is the concentration T, re-derived after
    the continuity update. Inactive levels stay exactly zero.
    """
    content = h_old[:, None, :] * tracers + dt * tend_hT
    return tracer_concentration(content, h_new, cell_level_mask)


def total_tracer_content(tracers, layer_thickness, mesh) -> jnp.ndarray:
    """sum over cells/levels of A_c h T — the conserved integral, per
    tracer: (nT,). Used by tests and the in-run monitor."""
    act = layer_thickness * mesh.vert.cell_level_mask
    return jnp.einsum("cnk,ck,c->n", tracers, act, mesh.cells.area_cell,
                      precision=jax.lax.Precision.HIGHEST)
