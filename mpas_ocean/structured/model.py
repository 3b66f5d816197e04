"""Shallow-water core on the structured hex lattice: every stencil is a
roll/shift, no gathers.

Mathematically identical to the unstructured path (models/shallow_water.py)
on uniform periodic hex meshes — tests assert agreement to ~1e-12 in f64 —
but runs as fused elementwise XLA ops over contiguous arrays.

Layout (see hex_layout.py): cell fields (2, ny2, nx, K), edge fields
(3, 2, ny2, nx, K) with canonical family normals at 0/60/120 degrees,
vertex fields (2, 2, ny2, nx, K).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import GRAVITY
from ..models.shallow_water import PrognosticVars
from ..utils.pytree import pytree_dataclass, static_field
from .hex_layout import A, B, E, NE, NW, HexLayout

__all__ = ["StructuredModel", "StructState", "StructMesh",
           "structured_rollout_diff"]


@pytree_dataclass
class StructState:
    ssh: jax.Array  # (2, ny2, nx)
    layer_thickness: jax.Array  # (2, ny2, nx, K)
    normal_velocity: jax.Array  # (3, 2, ny2, nx, K)
    tracers: jax.Array | None = None  # (2, ny2, nx, nT, K)


@pytree_dataclass
class StructMesh:
    nx: int = static_field()
    ny2: int = static_field()
    n_vert_levels: int = static_field()
    # static Coriolis stencil: tuple of (f_out, p_out, f_in, p_in, dm, di, w)
    coriolis_terms: tuple = static_field()

    dc: jax.Array  # scalar
    dv: jax.Array  # scalar
    area_cell: jax.Array  # scalar (uniform)
    f_edge: jax.Array  # (3, 2, ny2, nx)
    resting_thickness_sum: jax.Array  # (2, ny2, nx)
    # Optional wall mask: 1 on free (interior) edges, 0 on wall edges and
    # edges of culled cells. None = fully periodic lattice. With the mask,
    # culled coastal channels (the reference's Kelvin-wave perf config,
    # reference: README.MD:45-50) run on every structured fast path: masked
    # edges keep u = 0 exactly, so their fluxes and Coriolis taps vanish and
    # the live-cell dynamics match the culled unstructured mesh to roundoff.
    edge_mask: jax.Array | None = None  # (3, 2, ny2, nx)
    # 1 on live cells, 0 on culled slots (None = all live); the tracer
    # update divides content by h exactly where this mask is 1, mirroring
    # the gather path's cell_level_mask guard
    cell_mask: jax.Array | None = None  # (2, ny2, nx)

    # nonlinear (vector-invariant) extension: machine-extracted vertex
    # stencils (hex_layout.py) + Coriolis parameter at vertices. Populated
    # by StructuredModel; () / None on hand-built meshes keeps the linear
    # path working unchanged.
    vertex_cell_terms: tuple = static_field(default=())
    edge_vertex_terms: tuple = static_field(default=())
    f_vertex: jax.Array | None = None  # (2, 2, ny2, nx)
    # wall-masked nonlinear extension (culled channels): per-site kite
    # weights renormalized over LIVE cells (one plane per vertex_cell_terms
    # entry — the lattice counterpart of the gather path's partial-kite
    # normalization, ops/operators.interpolate_cell_to_vertex) and the
    # live-vertex mask guarding the PV division. None on periodic lattices
    # (static 1/3 weights stay bitwise-unchanged there).
    vertex_kite_planes: jax.Array | None = None  # (len(vc_terms), ny2, nx)
    vertex_mask: jax.Array | None = None  # (2, 2, ny2, nx)


def _shift(x: jnp.ndarray, dm: int, di: int) -> jnp.ndarray:
    """out[m, i] = x[m + dm, i + di] on a (ny2, nx, ...) plane, periodic."""
    if dm:
        x = jnp.roll(x, -dm, axis=0)
    if di:
        x = jnp.roll(x, -di, axis=1)
    return x


def _neighbor_cell_field(h, fam):
    """h at the canonical-direction neighbor across family fam;
    h is (2, ny2, nx, ...) -> same shape."""
    h0, h1 = h[0], h[1]
    if fam == E:
        return jnp.stack([_shift(h0, 0, 1), _shift(h1, 0, 1)])
    if fam == NE:
        return jnp.stack([h1, _shift(h0, 1, 1)])
    if fam == NW:
        return jnp.stack([_shift(h1, 0, -1), _shift(h0, 1, 0)])
    raise ValueError(fam)


def grad_on_edge(h, mesh: StructMesh):
    """(h[neighbor] - h[c]) / dc for each family -> (3, 2, ny2, nx, ...)."""
    return jnp.stack(
        [(_neighbor_cell_field(h, f) - h) / mesh.dc for f in (E, NE, NW)]
    )


def interp_cell_to_edge(h, mesh: StructMesh):
    return jnp.stack(
        [0.5 * (_neighbor_cell_field(h, f) + h) for f in (E, NE, NW)]
    )


def _incoming_edge_fields(u):
    """The cell's three non-owned edges: E of the W-neighbor, NE of the
    SW-neighbor, NW of the SE-neighbor (each (2, ny2, nx, ...))."""
    uE, uNE, uNW = u[0], u[1], u[2]
    inc_E = jnp.stack([_shift(uE[0], 0, -1), _shift(uE[1], 0, -1)])
    inc_NE = jnp.stack([_shift(uNE[1], -1, -1), uNE[0]])
    inc_NW = jnp.stack([_shift(uNW[1], -1, 0), _shift(uNW[0], 0, 1)])
    return inc_E, inc_NE, inc_NW


def div_on_cell(u, mesh: StructMesh):
    """Outward-flux divergence of an edge-normal field u (3,2,ny2,nx,...)."""
    inc_E, inc_NE, inc_NW = _incoming_edge_fields(u)
    total = u[0] + u[1] + u[2] - inc_E - inc_NE - inc_NW
    return total * (mesh.dv / mesh.area_cell)


def kinetic_energy_cell(u, mesh: StructMesh):
    """KE_c = (dc dv / 4 A_c) sum over the cell's 6 edges of u_e^2
    (models/shallow_water.kinetic_energy_on_cell on the lattice; dc/dv/A
    are uniform scalars here)."""
    sq = u * u
    inc_E, inc_NE, inc_NW = _incoming_edge_fields(sq)
    total = sq[0] + sq[1] + sq[2] + inc_E + inc_NE + inc_NW
    return total * (0.25 * mesh.dc * mesh.dv / mesh.area_cell)


def cell_to_vertex_kite(h, mesh: StructMesh):
    """Kite-area cell->vertex average -> (2, 2, ny2, nx, ...), from the
    machine-extracted stencil (ops/operators.interpolate_cell_to_vertex).
    On wall-masked lattices the static 1/3 weights are replaced by the
    per-site live-renormalized kite planes (partial kites at boundary
    vertices, zero at dead vertices)."""
    kw = mesh.vertex_kite_planes
    out = [[None, None], [None, None]]
    for t, (kind, p_out, p_in, dm, di, w) in enumerate(mesh.vertex_cell_terms):
        wgt = w if kw is None else kw[t].reshape(
            kw[t].shape + (1,) * (h.ndim - 3)
        )
        contrib = wgt * _shift(h[p_in], dm, di)
        cur = out[kind][p_out]
        out[kind][p_out] = contrib if cur is None else cur + contrib
    return jnp.stack([jnp.stack(planes) for planes in out])


def pv_on_vertex_struct(u, h, mesh: StructMesh):
    """q_v = (f_v + zeta_v) / h_v on the lattice; wall-masked lattices
    guard the division at dead vertices and zero their PV (the gather
    path's safe-denominator + vertex-mask convention,
    models/shallow_water.potential_vorticity_on_vertex)."""
    zeta = curl_on_vertex(u, mesh)
    h_v = cell_to_vertex_kite(h, mesh)
    if mesh.vertex_mask is None:
        return (mesh.f_vertex[..., None] + zeta) / h_v
    vm = mesh.vertex_mask.reshape(mesh.vertex_mask.shape + (1,) * (h_v.ndim - 4))
    safe = jnp.where(vm > 0, h_v, jnp.ones_like(h_v))
    return (mesh.f_vertex[..., None] + zeta) / safe * vm


def _check_nl_mesh(mesh: StructMesh):
    if not mesh.vertex_cell_terms:
        raise ValueError(
            "StructMesh lacks vertex stencils; build it via "
            "StructuredModel so hex_layout extracts them"
        )
    if mesh.edge_mask is not None and mesh.vertex_kite_planes is None:
        raise NotImplementedError(
            "wall-masked nonlinear dynamics need the masked vertex "
            "constants (vertex_kite_planes/vertex_mask) — build the "
            "StructMesh via StructuredModel(parent_horz=..., keep_cells=...)"
        )


def vertex_to_edge_mean(v, mesh: StructMesh):
    """Endpoint mean of a vertex field -> (3, 2, ny2, nx, ...)
    (ops/operators.interpolate_vertex_to_edge)."""
    out = [[None, None] for _ in range(3)]
    for (f_out, p_out, kind, p_in, dm, di) in mesh.edge_vertex_terms:
        contrib = _shift(v[kind, p_in], dm, di)
        cur = out[f_out][p_out]
        out[f_out][p_out] = contrib if cur is None else cur + contrib
    return 0.5 * jnp.stack([jnp.stack(planes) for planes in out])


def tangential_weights_only(x, mesh: StructMesh):
    """sum_j w_j x[eoe_j] — the Coriolis stencil WITHOUT folding f (the
    nonlinear PV flux applies it to the thickness flux)."""
    out = [[None, None] for _ in range(3)]
    for (f_out, p_out, f_in, p_in, dm, di, w) in mesh.coriolis_terms:
        contrib = w * _shift(x[f_in, p_in], dm, di)
        cur = out[f_out][p_out]
        out[f_out][p_out] = contrib if cur is None else cur + contrib
    return jnp.stack([jnp.stack(planes) for planes in out])


def curl_on_vertex(u, mesh: StructMesh):
    """Relative vorticity at vertices -> (2, 2, ny2, nx, ...).

    curl_A(c) = dc/A_tri * (u_NE(c) - u_E(NW(c)) - u_NW(c))
    curl_B(c) = dc/A_tri * (u_E(c) + u_NW(E(c)) - u_NE(c))
    """
    uE, uNE, uNW = u[0], u[1], u[2]
    e_of_nw = jnp.stack([_shift(uE[1], 0, -1), _shift(uE[0], 1, 0)])
    nw_of_e = jnp.stack([_shift(uNW[0], 0, 1), _shift(uNW[1], 0, 1)])
    area_tri = mesh.area_cell * 0.5
    curl_a = (uNE - e_of_nw - uNW) * (mesh.dc / area_tri)
    curl_b = (uE + nw_of_e - uNE) * (mesh.dc / area_tri)
    return jnp.stack([curl_a, curl_b])


def tangential_times_f(u, mesh: StructMesh):
    """TRiSK Coriolis accumulation sum_j w_j * (u * f)[eoe_j] as 60 static
    roll-multiply-adds (stencil machine-extracted in hex_layout.py)."""
    uf = u * mesh.f_edge[..., None]
    out = [[None, None] for _ in range(3)]
    for (f_out, p_out, f_in, p_in, dm, di, w) in mesh.coriolis_terms:
        contrib = w * _shift(uf[f_in, p_in], dm, di)
        cur = out[f_out][p_out]
        out[f_out][p_out] = contrib if cur is None else cur + contrib
    return jnp.stack([jnp.stack(planes) for planes in out])


def tracer_tendency_struct(
    tracers, flux, mesh: StructMesh, kappa: float, upwind: float, h_edge,
):
    """d(hT)/dt on the lattice (models/tracers.tracer_tendency as rolls).

    ``tracers`` (2, ny2, nx, nT, K), ``flux``/``h_edge`` (3, 2, ny2, nx, K).
    Wall edges (edge_mask = 0) carry zero advective flux automatically
    (u = 0 there) and the diffusive flux is masked explicitly, matching the
    culled gather path's edge mask."""
    t_e = interp_cell_to_edge(tracers, mesh)  # (3, 2, ny2, nx, nT, K)
    g = None
    if upwind or kappa:
        g = grad_on_edge(tracers, mesh)
    if upwind:
        t_e = t_e - (0.5 * upwind * mesh.dc) * jnp.sign(
            flux[..., None, :]
        ) * g
    fl = flux[..., None, :] * t_e
    if kappa:
        diff = kappa * h_edge
        if mesh.edge_mask is not None:
            diff = diff * mesh.edge_mask[..., None]
        fl = fl - diff[..., None, :] * g
    return -div_on_cell(fl, mesh)


def _tracer_concentration_struct(content, h, cell_mask):
    """T = content / h on live cells (identical guard to the gather path's
    cell_level_mask: live cells divide by h unconditionally)."""
    if cell_mask is None:
        return content / h[..., None, :]
    mask = cell_mask[..., None, None]
    safe_h = jnp.where(mask > 0, h[..., None, :], jnp.ones_like(h)[..., None, :])
    return content / safe_h * mask


def structured_step(
    state: StructState, mesh: StructMesh, dt, nonlinear: bool = False,
    forcing=None, tracer_kappa: float = 0.0, tracer_upwind: float = 1.0,
    strat=None,
) -> StructState:
    """One forward-Euler step, all rolls + elementwise.

    ``nonlinear=True`` runs the full vector-invariant momentum equation
    (models/shallow_water.compute_normal_velocity_tendency nonlinear
    branch: KE gradient + symmetrized PV flux) on the lattice — periodic
    lattices only: the PV of a dead (culled) cell slot is meaningless, so
    wall-masked channels route nonlinear runs to the gather/matrix paths.
    """
    h_edge = interp_cell_to_edge(state.layer_thickness, mesh)
    flux = state.normal_velocity * h_edge
    tend_h = -div_on_cell(flux, mesh)

    if strat is None:
        grad_ssh = grad_on_edge(state.ssh, mesh)  # (3, 2, ny2, nx)
        tend_u = -GRAVITY * grad_ssh[..., None]
    else:
        # layered baroclinic pressure (models/stratification.py): the
        # K x K Montgomery matmul over the level axis, then the same
        # roll gradient
        from ..models.stratification import montgomery_potential

        phi = montgomery_potential(state.ssh, state.layer_thickness, strat)
        tend_u = -grad_on_edge(phi, mesh)
    if nonlinear:
        _check_nl_mesh(mesh)
        ke = kinetic_energy_cell(state.normal_velocity, mesh)
        tend_u = tend_u - grad_on_edge(ke, mesh)
        q_v = pv_on_vertex_struct(
            state.normal_velocity, state.layer_thickness, mesh
        )
        q_e = vertex_to_edge_mean(q_v, mesh)
        half = jnp.asarray(0.5, q_e.dtype)
        tend_u = tend_u + half * (
            q_e * tangential_weights_only(flux, mesh)
            + tangential_weights_only(flux * q_e, mesh)
        )
    else:
        tend_u = tend_u + tangential_times_f(state.normal_velocity, mesh)

    if forcing is not None:
        # struct-layout Forcing (StructuredModel.to_struct_forcing):
        # elementwise wind / bottom drag / Rayleigh on the already-computed
        # h_edge (models/forcing.py)
        from ..models.forcing import forcing_tendency

        tend_u = tend_u + forcing_tendency(
            state.normal_velocity, h_edge, forcing
        )

    h = state.layer_thickness + dt * tend_h
    u = state.normal_velocity + dt * tend_u
    if mesh.edge_mask is not None:
        u = u * mesh.edge_mask[..., None]
    ssh = h.sum(-1) - mesh.resting_thickness_sum
    tracers = None
    if state.tracers is not None:
        tend_t = tracer_tendency_struct(
            state.tracers, flux, mesh, tracer_kappa, tracer_upwind, h_edge
        )
        content = (
            state.layer_thickness[..., None, :] * state.tracers + dt * tend_t
        )
        tracers = _tracer_concentration_struct(content, h, mesh.cell_mask)
    return StructState(ssh=ssh, layer_thickness=h, normal_velocity=u,
                       tracers=tracers)


def structured_rk4_step(
    state: StructState, mesh: StructMesh, dt, nonlinear: bool = False,
    forcing=None, tracer_kappa: float = 0.0, tracer_upwind: float = 1.0,
    strat=None,
) -> StructState:
    """Classical RK4 on the lattice (mirrors
    forward/time_integration.rk4_step stage for stage: ssh and tracer
    concentration rederived at every stage, tracers advanced in content
    form)."""
    with_tracers = state.tracers is not None

    # tendencies computed directly (same pieces as structured_step)
    def tend(s: StructState):
        h_edge = interp_cell_to_edge(s.layer_thickness, mesh)
        flux = s.normal_velocity * h_edge
        tend_h = -div_on_cell(flux, mesh)
        if strat is None:
            grad_ssh = grad_on_edge(s.ssh, mesh)
            tend_u = -GRAVITY * grad_ssh[..., None]
        else:
            from ..models.stratification import montgomery_potential

            phi = montgomery_potential(s.ssh, s.layer_thickness, strat)
            tend_u = -grad_on_edge(phi, mesh)
        if nonlinear:
            ke = kinetic_energy_cell(s.normal_velocity, mesh)
            tend_u = tend_u - grad_on_edge(ke, mesh)
            q_v = pv_on_vertex_struct(
                s.normal_velocity, s.layer_thickness, mesh
            )
            q_e = vertex_to_edge_mean(q_v, mesh)
            half = jnp.asarray(0.5, q_e.dtype)
            tend_u = tend_u + half * (
                q_e * tangential_weights_only(flux, mesh)
                + tangential_weights_only(flux * q_e, mesh)
            )
        else:
            tend_u = tend_u + tangential_times_f(s.normal_velocity, mesh)
        if forcing is not None:
            from ..models.forcing import forcing_tendency

            tend_u = tend_u + forcing_tendency(s.normal_velocity, h_edge, forcing)
        if mesh.edge_mask is not None:
            tend_u = tend_u * mesh.edge_mask[..., None]
        tend_t = None
        if with_tracers:
            tend_t = tracer_tendency_struct(
                s.tracers, flux, mesh, tracer_kappa, tracer_upwind, h_edge
            )
        return tend_u, tend_h, tend_t

    if nonlinear:
        _check_nl_mesh(mesh)
    u0, h0 = state.normal_velocity, state.layer_thickness
    ht0 = h0[..., None, :] * state.tracers if with_tracers else None

    def stage(du, dh, dht, a):
        h = h0 + a * dh
        tracers = None
        if with_tracers:
            tracers = _tracer_concentration_struct(
                ht0 + a * dht, h, mesh.cell_mask
            )
        u = u0 + a * du
        if mesh.edge_mask is not None:
            u = u * mesh.edge_mask[..., None]
        return StructState(
            ssh=h.sum(-1) - mesh.resting_thickness_sum,
            layer_thickness=h, normal_velocity=u, tracers=tracers,
        )

    k1u, k1h, k1t = tend(state)
    k2u, k2h, k2t = tend(stage(k1u, k1h, k1t, dt / 2.0))
    k3u, k3h, k3t = tend(stage(k2u, k2h, k2t, dt / 2.0))
    k4u, k4h, k4t = tend(stage(k3u, k3h, k3t, dt))
    u = u0 + (dt / 6.0) * (k1u + 2.0 * k2u + 2.0 * k3u + k4u)
    h = h0 + (dt / 6.0) * (k1h + 2.0 * k2h + 2.0 * k3h + k4h)
    if mesh.edge_mask is not None:
        u = u * mesh.edge_mask[..., None]
    tracers = None
    if with_tracers:
        ht = ht0 + (dt / 6.0) * (k1t + 2.0 * k2t + 2.0 * k3t + k4t)
        tracers = _tracer_concentration_struct(ht, h, mesh.cell_mask)
    return StructState(
        ssh=h.sum(-1) - mesh.resting_thickness_sum,
        layer_thickness=h, normal_velocity=u, tracers=tracers,
    )


def structured_fb_step(
    state: StructState, mesh: StructMesh, dt, nonlinear: bool = False,
    forcing=None, tracer_kappa: float = 0.0, tracer_upwind: float = 1.0,
    strat=None,
) -> StructState:
    """Forward-backward on the lattice (mirrors
    forward/time_integration.forward_backward_step)."""
    h_edge = interp_cell_to_edge(state.layer_thickness, mesh)
    flux = state.normal_velocity * h_edge
    h = state.layer_thickness + dt * (-div_on_cell(flux, mesh))
    ssh = h.sum(-1) - mesh.resting_thickness_sum

    if strat is None:
        tend_u = -GRAVITY * grad_on_edge(ssh, mesh)[..., None]
    else:
        from ..models.stratification import montgomery_potential

        tend_u = -grad_on_edge(montgomery_potential(ssh, h, strat), mesh)
    if nonlinear:
        _check_nl_mesh(mesh)
        ke = kinetic_energy_cell(state.normal_velocity, mesh)
        tend_u = tend_u - grad_on_edge(ke, mesh)
        q_v = pv_on_vertex_struct(
            state.normal_velocity, state.layer_thickness, mesh
        )
        q_e = vertex_to_edge_mean(q_v, mesh)
        half = jnp.asarray(0.5, q_e.dtype)
        tend_u = tend_u + half * (
            q_e * tangential_weights_only(flux, mesh)
            + tangential_weights_only(flux * q_e, mesh)
        )
    else:
        tend_u = tend_u + tangential_times_f(state.normal_velocity, mesh)
    if forcing is not None:
        from ..models.forcing import forcing_tendency

        tend_u = tend_u + forcing_tendency(
            state.normal_velocity, h_edge, forcing
        )
    u = state.normal_velocity + dt * tend_u
    if mesh.edge_mask is not None:
        u = u * mesh.edge_mask[..., None]
    tracers = None
    if state.tracers is not None:
        tend_t = tracer_tendency_struct(
            state.tracers, flux, mesh, tracer_kappa, tracer_upwind, h_edge
        )
        content = (
            state.layer_thickness[..., None, :] * state.tracers + dt * tend_t
        )
        tracers = _tracer_concentration_struct(content, h, mesh.cell_mask)
    return StructState(ssh=ssh, layer_thickness=h, normal_velocity=u,
                       tracers=tracers)


@partial(jax.jit, static_argnames=("n_steps", "nonlinear", "tracer_kappa",
                                   "tracer_upwind", "rk4", "fb"))
def structured_run_loop(
    state: StructState, mesh: StructMesh, dt, n_steps: int,
    nonlinear: bool = False, forcing=None,
    tracer_kappa: float = 0.0, tracer_upwind: float = 1.0,
    rk4: bool = False, strat=None, fb: bool = False,
):
    if rk4 and fb:
        raise ValueError("rk4 and fb are mutually exclusive")
    step = structured_rk4_step if rk4 else (
        structured_fb_step if fb else structured_step)

    def body(s, _):
        return step(s, mesh, dt, nonlinear, forcing,
                    tracer_kappa, tracer_upwind, strat), None

    out, _ = jax.lax.scan(body, state, length=n_steps)
    return out


def structured_rollout_diff(
    state: StructState, mesh: StructMesh, dt, n_steps: int,
    nonlinear: bool = False, tracer_kappa: float = 0.0,
    tracer_upwind: float = 1.0, strat=None, forcing=None,
) -> StructState:
    """n-step forward-Euler lattice rollout for whole-loop gradients — the
    reverse the reference validates with Enzyme (reference:
    test/enzyme/test_Enzyme_end2end.jl:78-92).

    Same values as ``structured_run_loop``; under ``jax.grad`` the scan is
    checkpointed at two levels (sqrt(n)-step chunks), so reverse-mode
    memory is O(sqrt(n) * state) instead of O(n * step intermediates).
    ``dt``, ``strat`` and the struct-layout ``forcing`` are differentiable
    inputs like the state."""
    import math

    b = max(1, math.isqrt(n_steps))
    a, rem = divmod(n_steps, b)

    step = jax.checkpoint(
        lambda s, _: (structured_step(s, mesh, dt, nonlinear,
                                      forcing=forcing,
                                      tracer_kappa=tracer_kappa,
                                      tracer_upwind=tracer_upwind,
                                      strat=strat), None)
    )

    def chunk(s, _):
        s, _ = jax.lax.scan(step, s, length=b)
        return s, None

    if a:
        state, _ = jax.lax.scan(jax.checkpoint(chunk), state, length=a)
    if rem:
        state, _ = jax.lax.scan(step, state, length=rem)
    return state


class StructuredModel:
    """Fast path for uniform hex lattices — fully periodic, or coastal
    channels carved out of a periodic parent by cell culling.

    Build from an unstructured Mesh; converts state in/out of the lattice
    layout (host-side, once) and runs the rolled dynamics on device.

    Channel form: pass the periodic ``parent_horz`` the culled mesh was
    carved from (mesh.cull.cull_cells) plus the ``keep_cells`` mask. The
    lattice then covers the full parent; culled cells/edges are dead slots
    whose velocity the step pins to exactly zero via StructMesh.edge_mask,
    so walls behave identically to the culled gather path (the reference
    has no boundary support at all — VertMesh.jl:50-57 requires periodic).
    """

    def __init__(self, mesh, nx: int, ny: int, *,
                 parent_horz=None, keep_cells=None):
        if (parent_horz is None) != (keep_cells is None):
            raise ValueError("parent_horz and keep_cells go together")
        horz, vert = mesh.horz, mesh.vert
        lattice_horz = horz if parent_horz is None else parent_horz
        self.layout = HexLayout(lattice_horz, nx, ny)
        self.mesh_unstructured = mesh
        lay = self.layout
        dtype = np.asarray(lattice_horz.cells.area_cell).dtype

        edge_mask = None
        cell_mask = None
        vertex_kite_planes = None
        vertex_mask = None
        if parent_horz is None:
            self.cell_gids = None
            self.edge_gids = None
            self._n_parent_cells = horz.n_cells
            self._n_parent_edges = horz.n_edges
            rts_parent = np.asarray(vert.resting_thickness_sum)
        else:
            keep = np.asarray(keep_cells, dtype=bool)
            if int(keep.sum()) != horz.n_cells:
                raise ValueError("keep_cells does not match the culled mesh")
            self.cell_gids = np.flatnonzero(keep)
            coe = np.asarray(parent_horz.edges.cells_on_edge)
            keep_edge = keep[coe].any(axis=1)
            if int(keep_edge.sum()) != horz.n_edges:
                raise ValueError("culled mesh was not built from keep_cells")
            self.edge_gids = np.flatnonzero(keep_edge)
            self._n_parent_cells = parent_horz.n_cells
            self._n_parent_edges = parent_horz.n_edges
            # sanity: culled cell i sits at parent cell cell_gids[i]
            assert np.allclose(
                np.asarray(horz.cells.x), np.asarray(parent_horz.cells.x)[self.cell_gids]
            )
            # free (two live cells) edges keep their dynamics; wall edges
            # (one live cell) and dead edges are pinned to u = 0
            interior = keep[coe].all(axis=1).astype(dtype)
            edge_mask = jnp.asarray(lay.edges_to_struct(interior))
            cell_mask = jnp.asarray(lay.cells_to_struct(keep.astype(dtype)))
            rts_parent = np.zeros(parent_horz.n_cells, dtype=dtype)
            rts_parent[self.cell_gids] = np.asarray(vert.resting_thickness_sum)
            # masked vertex constants for nonlinear dynamics on walls: tap
            # liveness planes renormalize the kite weights over live cells
            # (uniform kites, so weight ∝ the periodic stencil weight) and
            # define the live-vertex mask
            keep_struct = lay.cells_to_struct(keep.astype(np.float64))
            vt = lay.vertex_cell_terms
            live = []
            for (kind, p_out, p_in, dm, di, w) in vt:
                lv = np.roll(
                    np.roll(keep_struct[p_in], -dm, axis=0), -di, axis=1
                )
                live.append(w * lv)
            live = np.stack(live)  # (n_terms, ny2, nx)
            sums = np.zeros((2, 2) + keep_struct.shape[1:])
            for t, (kind, p_out, *_r) in enumerate(vt):
                sums[kind, p_out] += live[t]
            safe_sums = np.where(sums > 0, sums, 1.0)
            vertex_kite_planes = jnp.asarray(
                np.stack(
                    [
                        live[t] / safe_sums[vt[t][0], vt[t][1]]
                        for t in range(len(vt))
                    ]
                ).astype(dtype)
            )
            vertex_mask = jnp.asarray((sums > 0).astype(dtype))

        rts = lay.cells_to_struct(rts_parent)
        terms = tuple(
            (t.f_out, t.p_out, t.f_in, t.p_in, t.dm, t.di, t.w)
            for t in lay.coriolis_terms
        )
        self.struct_mesh = StructMesh(
            nx=nx,
            ny2=ny // 2,
            n_vert_levels=vert.n_vert_levels,
            coriolis_terms=terms,
            dc=jnp.asarray(dtype.type(lay.dc)),
            dv=jnp.asarray(dtype.type(np.asarray(lattice_horz.edges.dv_edge)[0])),
            area_cell=jnp.asarray(
                dtype.type(np.asarray(lattice_horz.cells.area_cell)[0])
            ),
            f_edge=jnp.asarray(lay.edges_to_struct(np.asarray(lattice_horz.edges.f))),
            resting_thickness_sum=jnp.asarray(rts),
            edge_mask=edge_mask,
            cell_mask=cell_mask,
            vertex_cell_terms=lay.vertex_cell_terms,
            edge_vertex_terms=lay.edge_vertex_terms,
            f_vertex=jnp.asarray(
                lay.vertices_to_struct(np.asarray(lattice_horz.duals.f))
            ),
            vertex_kite_planes=vertex_kite_planes,
            vertex_mask=vertex_mask,
        )
        # uniformity requirements for the scalar metric shortcut
        assert np.allclose(
            np.asarray(lattice_horz.edges.dv_edge),
            np.asarray(lattice_horz.edges.dv_edge)[0],
        )
        assert np.allclose(
            np.asarray(lattice_horz.cells.area_cell),
            np.asarray(lattice_horz.cells.area_cell)[0],
        )

    # -- culled <-> parent embedding (identity when fully periodic) ------
    def _cells_to_parent(self, field: np.ndarray) -> np.ndarray:
        if self.cell_gids is None:
            return field
        out = np.zeros((self._n_parent_cells,) + field.shape[1:], field.dtype)
        out[self.cell_gids] = field
        return out

    def _edges_to_parent(self, field: np.ndarray) -> np.ndarray:
        if self.edge_gids is None:
            return field
        out = np.zeros((self._n_parent_edges,) + field.shape[1:], field.dtype)
        out[self.edge_gids] = field
        return out

    def to_struct(self, prog: PrognosticVars) -> StructState:
        lay = self.layout
        u = lay.edges_to_struct(
            self._edges_to_parent(np.asarray(prog.normal_velocity)), sign=True
        )
        if self.struct_mesh.edge_mask is not None:
            # the wall condition (u = 0 on masked edges) is a contract of the
            # culled mesh; enforce it exactly on entry
            u = u * np.asarray(self.struct_mesh.edge_mask)[..., None]
        tracers = None
        if prog.tracers is not None:
            tracers = jnp.asarray(
                lay.cells_to_struct(
                    self._cells_to_parent(np.asarray(prog.tracers))
                )
            )
        return StructState(
            ssh=jnp.asarray(
                lay.cells_to_struct(self._cells_to_parent(np.asarray(prog.ssh)))
            ),
            layer_thickness=jnp.asarray(
                lay.cells_to_struct(
                    self._cells_to_parent(np.asarray(prog.layer_thickness))
                )
            ),
            normal_velocity=jnp.asarray(u),
            tracers=tracers,
        )

    def from_struct(self, state: StructState) -> PrognosticVars:
        lay = self.layout
        ssh = lay.cells_from_struct(np.asarray(state.ssh))
        h = lay.cells_from_struct(np.asarray(state.layer_thickness))
        u = lay.edges_from_struct(np.asarray(state.normal_velocity), sign=True)
        tracers = None
        if state.tracers is not None:
            tracers = lay.cells_from_struct(np.asarray(state.tracers))
        if self.cell_gids is not None:
            ssh, h, u = ssh[self.cell_gids], h[self.cell_gids], u[self.edge_gids]
            if tracers is not None:
                tracers = tracers[self.cell_gids]
        return PrognosticVars(
            ssh=jnp.asarray(ssh),
            layer_thickness=jnp.asarray(h),
            normal_velocity=jnp.asarray(u),
            tracers=None if tracers is None else jnp.asarray(tracers),
        )

    def to_struct_forcing(self, forcing):
        """Unstructured Forcing -> struct-layout Forcing: the wind stress
        is a signed normal-projected edge quantity (sign=True like
        normal_velocity); the level masks are unsigned. Culled channels
        embed into the parent lattice with zeros on dead slots, so dead
        edges receive no forcing."""
        from ..models.forcing import Forcing

        lay = self.layout
        wind = lay.edges_to_struct(
            self._edges_to_parent(np.asarray(forcing.wind_edge)), sign=True
        )
        top = lay.edges_to_struct(
            self._edges_to_parent(np.asarray(forcing.top_mask))
        )
        bot = lay.edges_to_struct(
            self._edges_to_parent(np.asarray(forcing.bottom_mask))
        )
        return Forcing(
            wind_edge=jnp.asarray(wind),
            top_mask=jnp.asarray(top),
            bottom_mask=jnp.asarray(bot),
            drag_linear=forcing.drag_linear,
            drag_quadratic=forcing.drag_quadratic,
            rayleigh=forcing.rayleigh,
        )

    def run(self, state: StructState, dt, n_steps: int,
            nonlinear: bool = False, forcing=None,
            tracer_kappa: float = 0.0,
            tracer_upwind: float = 1.0, rk4: bool = False,
            strat=None, fb: bool = False) -> StructState:
        """n_steps of the lattice rollout. On a GPU the linear
        forward-Euler core runs as one Triton kernel launch per step
        (triton_step.py), which beat XLA's fusions of the roll step there
        (PERF.md); every other case, and every other backend, runs the
        roll stencils (``structured_run_loop``)."""
        if (jax.default_backend() == "gpu" and not (nonlinear or rk4 or fb)
                and forcing is None and strat is None
                and state.tracers is None):
            from .triton_step import triton_run_loop

            return triton_run_loop(state, self.struct_mesh, dt, n_steps)
        return structured_run_loop(
            state, self.struct_mesh, dt, n_steps, nonlinear, forcing,
            tracer_kappa, tracer_upwind, rk4, strat, fb,
        )
