"""Shallow-water dynamical core: state containers, diagnostics, tendencies.

Re-design of the reference's ocean core (reference: src/ocn/):
state lives in immutable pytrees threaded through `lax.scan`, not mutable
structs updated by kernel launches. The dynamical core matches the
reference's: gravity (ssh-gradient pressure) + linear Coriolis tendencies
for normal velocity (src/ocn/Tendencies/normalVelocity/), thickness-flux
divergence for layer thickness (src/ocn/Tendencies/layerThickness/), and the
diagnostic chain thicknessFlux -> velocityDivCell -> relativeVorticity ->
layerThicknessEdge (src/ocn/DiagnosticVars.jl:108-117).

Shapes: ssh (nCells,), layer_thickness (nCells, K), normal_velocity
(nEdges, K) — element-major with levels innermost (the reference is
level-major (K, nElem), same memory order, opposite index convention).

Deliberate quirk fixes (documented in SURVEY section 7; all inert for the
single-layer equivalence configs): tendencies and interpolations run over
every active level, not a hardcoded k=1.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..constants import GRAVITY
from ..ops.operators import (
    curl_on_vertex,
    divergence_on_cell,
    gradient_on_edge,
    interpolate_cell_to_edge,
    interpolate_cell_to_vertex,
    interpolate_vertex_to_edge,
    tangential_reconstruction,
)
from ..utils.pytree import pytree_dataclass


@pytree_dataclass
class PrognosticVars:
    """Prognostic state at one time level (reference:
    src/ocn/PrognosticVars.jl:6-57, which keeps a Vector of <=2 levels;
    under `scan` the carry *is* the single live level).

    ``tracers`` holds the optional prognostic tracer concentrations
    (temperature/salinity/passive fields — the slots the reference stubs
    out, PrognosticVars.jl:20-26; see models/tracers.py). None (the
    default) keeps every tracer-free call site unchanged."""

    ssh: jax.Array  # (nCells,)
    layer_thickness: jax.Array  # (nCells, K)
    normal_velocity: jax.Array  # (nEdges, K)
    tracers: jax.Array | None = None  # (nCells, nTracers, K)


@pytree_dataclass
class DiagnosticVars:
    """Diagnostic fields (reference: src/ocn/DiagnosticVars.jl:6-73). The
    kinetic-energy / tangential-velocity diagnostics live in standalone
    functions so the hot step path stays lean."""

    layer_thickness_edge: jax.Array  # (nEdges, K)
    thickness_flux: jax.Array  # (nEdges, K)
    velocity_div_cell: jax.Array  # (nCells, K)
    relative_vorticity: jax.Array  # (nVertices, K)


@pytree_dataclass
class TendencyVars:
    """Prognostic tendencies (reference:
    src/ocn/Tendencies/TendencyVars.jl:7-49). ``tend_tracer`` is the
    tracer-CONTENT tendency d(hT)/dt (models/tracers.py), present only
    when the state carries tracers."""

    tend_normal_velocity: jax.Array  # (nEdges, K)
    tend_layer_thickness: jax.Array  # (nCells, K)
    tend_tracer: jax.Array | None = None  # (nCells, nTracers, K)


def compute_diagnostics(prog: PrognosticVars, mesh) -> DiagnosticVars:
    """Diagnostic pipeline (reference: DiagnosticVars.jl:108-117).

    Order matters in the reference only because velocityDivCell scribbles
    over layerThicknessEdge as scratch (DiagnosticVars.jl:175-193); here
    each field is computed independently and XLA fuses what it can.
    """
    h_edge = interpolate_cell_to_edge(prog.layer_thickness, mesh)
    # thicknessFlux = u * h_edge (reference kernel DiagnosticVars.jl:158-173)
    flux = prog.normal_velocity * h_edge
    div = divergence_on_cell(prog.normal_velocity, mesh)
    vort = curl_on_vertex(prog.normal_velocity, mesh)
    return DiagnosticVars(
        layer_thickness_edge=h_edge,
        thickness_flux=flux,
        velocity_div_cell=div,
        relative_vorticity=vort,
    )


def kinetic_energy_on_cell(normal_velocity: jnp.ndarray, mesh) -> jnp.ndarray:
    """KE_i = (1/A_i) sum_{e in EC(i)} (dc_e dv_e / 4) u_e^2 — the standard
    MPAS cell kinetic energy (BASELINE north-star diagnostic)."""
    edges = mesh.edges
    w = 0.25 * edges.dc_edge * edges.dv_edge
    e_sq = (w[:, None] * normal_velocity * normal_velocity)[
        mesh.cells.edges_on_cell
    ]
    masked = e_sq * mesh.cells.edge_mask_on_cell[:, :, None]
    return masked.sum(axis=1) / mesh.cells.area_cell[:, None]


def potential_vorticity_on_vertex(
    prog: PrognosticVars, mesh, relative_vorticity=None
) -> jnp.ndarray:
    """Layer potential vorticity at vertices: q_v = (f_v + zeta_v) / h_v,
    with h_v the kite-area thickness average (Ringler et al. 2010, the TRiSK
    scheme MPAS-Ocean uses; BEYOND the reference, whose dynamical core has
    'gravity and coriolis forces, with no non-linear terms', README.MD:12).

    Inactive levels (below bathymetry at any adjacent cell) are masked to
    zero with a safe denominator, so no Inf/NaN enters the tendency chain.
    """
    zeta = (
        relative_vorticity
        if relative_vorticity is not None
        else curl_on_vertex(prog.normal_velocity, mesh)
    )
    h_v = interpolate_cell_to_vertex(prog.layer_thickness, mesh)
    vmask = mesh.vert.vertex_level_mask
    safe_h = jnp.where(vmask > 0, h_v, jnp.ones_like(h_v))
    return (mesh.duals.f[:, None] + zeta) / safe_h * vmask


def pv_flux_tendency(
    q_edge: jnp.ndarray, thickness_flux: jnp.ndarray, mesh
) -> jnp.ndarray:
    """Nonlinear Coriolis + rotational momentum advection:

        tend_e = sum_j w_{e,j} * F_j * (q_e + q_j) / 2

    — the TRiSK energy-conserving discretization of q (h u)^perp (Ringler et
    al. 2010 eq. 49/62; MPAS-Ocean's symmetrized PV flux), where F = h_e u
    is the thickness flux and q the vertex-averaged PV at edges. With
    q -> f/H and F -> H u it reduces to the linear Coriolis term (up to
    where f is sampled: the reference samples f at the neighbor edge,
    horizontal_advection_and_coriolis.jl:70-72; the symmetric average is
    what conserves energy in the nonlinear regime).
    """
    half = jnp.asarray(0.5, q_edge.dtype)
    return half * (
        q_edge * tangential_reconstruction(thickness_flux, mesh)
        + tangential_reconstruction(thickness_flux * q_edge, mesh)
    )


def del2_tendency(normal_velocity: jnp.ndarray, mesh, coeff) -> jnp.ndarray:
    """Harmonic (del2) momentum mixing done right.

    The reference ships this formulation in a dead, broken module
    (reference: normalVelocity/horizontal_momentum_mixing.jl — not included
    by normalVelocity.jl:12-13, with an undefined variable, a
    self-referential assignment and the wrong kernel instantiated, SURVEY
    section 1 "Dead code"). Intended math (:74-79):
        tend += nu * ( (div[c2]-div[c1])/dc - (vort[v2]-vort[v1])/dv )
    i.e. the vector Laplacian del2 u = grad(div u) - curl(vort u).
    """
    div = divergence_on_cell(normal_velocity, mesh)
    vort = curl_on_vertex(normal_velocity, mesh)
    coe = mesh.edges.cells_on_edge
    voe = mesh.edges.vertices_on_edge
    grad_div = (div[coe[:, 1]] - div[coe[:, 0]]) / mesh.edges.dc_edge[:, None]
    grad_vort = (vort[voe[:, 1]] - vort[voe[:, 0]]) / mesh.edges.dv_edge[:, None]
    return coeff * (grad_div - grad_vort)


def compute_normal_velocity_tendency(
    prog: PrognosticVars, diag: DiagnosticVars, mesh, del2_coeff: float = 0.0,
    nonlinear: bool = False, forcing=None, strat=None, pressure_prog=None,
) -> jnp.ndarray:
    """du/dt = -g * grad(ssh) + Coriolis/advection [+ del2 mixing]
    [+ wind / bottom-drag / Rayleigh forcing].

    Linear core (the reference's full dynamical core, README.MD:12):
    -g grad(ssh) pressure + linear TRiSK Coriolis (reference:
    normalVelocity.jl:21-53 dispatching to pressure_gradient.jl:45-65 and
    horizontal_advection_and_coriolis.jl:50-75; del2 is the repaired
    version of its dead mixing module, see del2_tendency.)

    ``nonlinear=True`` upgrades to the full vector-invariant shallow-water
    momentum equation (BEYOND the reference):

        du/dt = q (h u)^perp - grad(g ssh + K) [+ del2]

    with K the cell kinetic energy and q the layer PV — the TRiSK
    energy-conserving scheme (Ringler et al. 2010) MPAS-Ocean itself uses.
    """
    edges = mesh.edges
    # ``pressure_prog`` overrides the state the PRESSURE terms read — the
    # forward-backward stepper evaluates them at the freshly-updated
    # thickness while every other term stays at the old state
    pp = prog if pressure_prog is None else pressure_prog
    if strat is None:
        # pressure gradient: tend -= g * (ssh[c2]-ssh[c1])/dc, all levels
        grad_ssh = gradient_on_edge(pp.ssh, mesh)  # (nEdges,)
        tend = -GRAVITY * grad_ssh[:, None] * mesh.vert.edge_level_mask
    else:
        # layered baroclinic pressure: per-layer Montgomery potential
        # (models/stratification.py) — a K x K level matmul feeding the same
        # edge gradient; equal densities reduce to the branch above
        from .stratification import montgomery_potential

        phi = montgomery_potential(pp.ssh, pp.layer_thickness, strat)
        tend = -gradient_on_edge(phi, mesh) * mesh.vert.edge_level_mask

    if nonlinear:
        # kinetic-energy gradient: tend -= grad(K), K per cell and level
        ke = kinetic_energy_on_cell(prog.normal_velocity, mesh)
        tend = tend - gradient_on_edge(ke, mesh) * mesh.vert.edge_level_mask
        # symmetrized PV flux q (h u)^perp
        q_v = potential_vorticity_on_vertex(
            prog, mesh, relative_vorticity=diag.relative_vorticity
        )
        q_e = interpolate_vertex_to_edge(q_v, mesh)
        tend = tend + pv_flux_tendency(
            q_e, diag.thickness_flux, mesh
        ) * mesh.vert.edge_level_mask
    else:
        # linear Coriolis: tend += sum_j w_j * u[eoe_j] * f[eoe_j]
        # (the reference folds f at the *neighbor* edge into the tangential
        # reconstruction, h_a_and_c.jl:70-72)
        uf = prog.normal_velocity * edges.f[:, None]
        tend = tend + tangential_reconstruction(uf, mesh) * mesh.vert.edge_level_mask

    if del2_coeff:
        # masked by the edge level mask: no mixing acceleration below
        # bathymetry (keeps inactive-level velocity exactly zero on
        # variable-depth meshes, matching the matrix path's folded del2)
        tend = tend + del2_tendency(
            prog.normal_velocity, mesh, del2_coeff
        ) * mesh.vert.edge_level_mask

    if forcing is not None:
        # wind stress / bottom drag / Rayleigh damping (models/forcing.py
        # — the subsystem the reference stubs as an empty ForcingVars.jl);
        # elementwise given the h_edge the flux already needed
        from .forcing import forcing_tendency

        tend = tend + forcing_tendency(
            prog.normal_velocity, diag.layer_thickness_edge, forcing
        )

    # closed-boundary edges never accelerate
    return tend * edges.edge_mask[:, None]


def compute_layer_thickness_tendency(
    prog: PrognosticVars, diag: DiagnosticVars, mesh
) -> jnp.ndarray:
    """dh/dt = -div(thicknessFlux).

    (reference: layerThickness.jl:14-28 -> thicknessFluxDivOnCell!,
    horizontal_advection.jl:42-69 — its `+=` with edgeSignOnCell is exactly
    minus the generic divergence, SURVEY quirk 7.8.)
    """
    tend = -divergence_on_cell(diag.thickness_flux, mesh)
    return tend * mesh.vert.cell_level_mask


def compute_tendencies(
    prog: PrognosticVars, diag: DiagnosticVars, mesh, del2_coeff: float = 0.0,
    nonlinear: bool = False, forcing=None,
    tracer_kappa: float = 0.0, tracer_upwind: float = 1.0, strat=None,
) -> TendencyVars:
    tend_tracer = None
    if prog.tracers is not None:
        from .tracers import tracer_tendency

        tend_tracer = tracer_tendency(
            prog.tracers, diag.thickness_flux, mesh,
            kappa=tracer_kappa, upwind=tracer_upwind,
            h_edge=diag.layer_thickness_edge,
        )
    return TendencyVars(
        tend_normal_velocity=compute_normal_velocity_tendency(
            prog, diag, mesh, del2_coeff, nonlinear, forcing, strat
        ),
        tend_layer_thickness=compute_layer_thickness_tendency(prog, diag, mesh),
        tend_tracer=tend_tracer,
    )


def update_ssh(layer_thickness: jnp.ndarray, mesh) -> jnp.ndarray:
    """ssh = total water-column thickness - resting total
    (reference: time_integration.jl:205-212, `Update_ssh!`, generalized from
    its k=1 to the full column sum as the RK4 path intends)."""
    total = (layer_thickness * mesh.vert.cell_level_mask).sum(axis=1)
    return total - mesh.vert.resting_thickness_sum
