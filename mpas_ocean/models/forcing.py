"""Surface / bottom momentum forcing: wind stress, bottom drag, Rayleigh
damping.

The reference RECOGNIZES a forcing subsystem but ships it empty — its
`src/ocn/ForcingVars.jl` file exists with no content (SURVEY section 2,
component row "ForcingVars: file exists but is empty"). This module fills
that surface with the standard shallow-water momentum forcing terms
MPAS-Ocean itself applies:

    du/dt +=  top_mask    * (tau . n) / (rho0 * h_edge)       wind stress
    du/dt += -bottom_mask * (r_lin * u + Cd * |u| * u / h)    bottom drag
    du/dt += -lambda * u                                      Rayleigh

All terms are ELEMENTWISE in (edge, level) once the wind stress has been
projected onto edge normals and the top/bottom one-hot level masks built —
a deliberate design point: the same `forcing_tendency` closure runs
unchanged on the gather, matrix, roll and sharded paths
(no new stencils, no extra halo rounds). The quadratic drag therefore uses
the local normal speed |u_e| rather than the reconstructed full edge speed;
for the boundary-layer configs this term models, the distinction is well
inside the O(Cd) parameterization uncertainty, and keeping it local is what
lets every execution path agree to roundoff.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.pytree import pytree_dataclass

__all__ = ["Forcing", "make_forcing", "forcing_tendency", "RHO0"]

# MPAS-Ocean's reference seawater density [kg/m^3]
RHO0 = 1026.0


@pytree_dataclass
class Forcing:
    """Precomputed, layout-agnostic momentum forcing.

    ``wind_edge`` is the KINEMATIC normal wind stress tau.n / rho0
    [m^2/s^2] at edges; ``top_mask``/``bottom_mask`` are one-hot
    (nEdges, K) selectors of the first/last active level (zeroed on
    closed-boundary edges). The three coefficients are scalars:
    ``drag_linear`` [1/s], ``drag_quadratic`` = Cd [dimensionless],
    ``rayleigh`` [1/s].
    """

    wind_edge: jax.Array  # (nEdges,)
    top_mask: jax.Array  # (nEdges, K)
    bottom_mask: jax.Array  # (nEdges, K)
    drag_linear: jax.Array  # scalar
    drag_quadratic: jax.Array  # scalar
    rayleigh: jax.Array  # scalar


def make_forcing(
    mesh,
    *,
    wind_stress_zonal=0.0,
    wind_stress_meridional=0.0,
    wind_stress_edge=None,
    bottom_drag_linear: float = 0.0,
    bottom_drag_quadratic: float = 0.0,
    rayleigh: float = 0.0,
    rho0: float = RHO0,
    dtype=None,
) -> Forcing:
    """Build a :class:`Forcing` for ``mesh``.

    ``wind_stress_zonal`` / ``wind_stress_meridional`` are in N/m^2 (Pa),
    scalars or per-cell ``(nCells,)`` arrays (cell fields are averaged to
    edges before projecting onto the edge normal with ``angle_edge``, the
    same convention the IGW exact solution uses for velocities, reference:
    src/inertialGravityWave.jl:47-64). Alternatively pass the already
    projected ``wind_stress_edge`` (nEdges, Pa) directly.
    """
    horz, vert = mesh.horz, mesh.vert
    edges = horz.edges
    n_edges = edges.n_edges
    k = vert.n_vert_levels
    if dtype is None:
        dtype = np.asarray(horz.cells.area_cell).dtype

    if wind_stress_edge is not None:
        tau_n = np.asarray(wind_stress_edge, dtype=np.float64)
        if tau_n.shape != (n_edges,):
            raise ValueError(
                f"wind_stress_edge must be (nEdges,)={n_edges}, "
                f"got {tau_n.shape}"
            )
    else:
        def at_edges(x):
            x = np.asarray(x, dtype=np.float64)
            if x.ndim == 0:
                return np.full(n_edges, float(x))
            if x.shape == (horz.cells.n_cells,):
                coe = np.asarray(edges.cells_on_edge)
                return 0.5 * (x[coe[:, 0]] + x[coe[:, 1]])
            if x.shape == (n_edges,):
                return x
            raise ValueError(f"wind stress shape {x.shape} not understood")

        angle = np.asarray(edges.angle_edge, dtype=np.float64)
        tau_n = at_edges(wind_stress_zonal) * np.cos(angle) + at_edges(
            wind_stress_meridional
        ) * np.sin(angle)

    # one-hot first/last active level per edge; closed edges get none.
    # First active edge level = max of the adjacent cells' first levels
    # (the same derivation edge_level_mask uses, mesh/vert_mesh.py:117)
    coe = np.asarray(edges.cells_on_edge)
    min_lc = np.asarray(vert.min_level_cell)
    top = np.maximum(min_lc[coe[:, 0]], min_lc[coe[:, 1]])
    bot = np.asarray(vert.max_level_edge_top) - 1  # 1-past-last -> last
    lv = np.arange(k)[None, :]
    emask = np.asarray(edges.edge_mask, dtype=np.float64)
    active = bot >= top
    top_mask = (lv == top[:, None]) & active[:, None]
    bottom_mask = (lv == bot[:, None]) & active[:, None]
    return Forcing(
        wind_edge=jnp.asarray((tau_n / rho0) * emask, dtype),
        top_mask=jnp.asarray(top_mask * emask[:, None], dtype),
        bottom_mask=jnp.asarray(bottom_mask * emask[:, None], dtype),
        drag_linear=jnp.asarray(bottom_drag_linear, dtype),
        drag_quadratic=jnp.asarray(bottom_drag_quadratic, dtype),
        rayleigh=jnp.asarray(rayleigh, dtype),
    )


def forcing_tendency(
    normal_velocity: jnp.ndarray, h_edge: jnp.ndarray, forcing: Forcing
) -> jnp.ndarray:
    """Momentum forcing tendency, elementwise in (edge, level).

    Works on ANY layout whose trailing axis is levels: unstructured
    (nEdges, K), structured planes (3, 2, ny2, nx, K), or slabs — the
    caller supplies `forcing` fields in the matching layout (see
    structured/model.struct_forcing). ``h_edge`` is the cell-to-edge
    interpolated layer thickness every path already computes for the
    thickness flux; inactive levels divide by a safe 1 and are masked out.
    """
    u = normal_velocity
    # one reciprocal instead of two divides: the wind and quadratic-drag
    # terms share the same 1/h_edge factor, and a divide costs several
    # multiplies
    inv_h = jnp.ones_like(h_edge) / jnp.where(
        h_edge > 0, h_edge, jnp.ones_like(h_edge)
    )
    wind = forcing.wind_edge if forcing.wind_edge.ndim == u.ndim else (
        forcing.wind_edge[..., None]
    )
    tend = forcing.top_mask * (wind * inv_h)
    tend = tend - forcing.bottom_mask * (
        forcing.drag_linear * u
        + forcing.drag_quadratic * jnp.abs(u) * u * inv_h
    )
    return tend - forcing.rayleigh * u
