"""Matrix (BSR) formulation of the shallow-water step for GENERAL
unstructured meshes.

Same math as forward/time_integration.forward_euler_step (which mirrors the
reference's live ForwardEuler path, reference:
src/forward/time_integration.jl:150-193), with every stencil operator
applied as a block-sparse matmul instead of a row-gather (see
ops/bsr.py). Works on any mesh the gather path works on —
periodic planes, culled coastal channels, spheres — because the mesh
connectivity is baked into the matrices at build time.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import GRAVITY
from ..ops.bsr import Bsr, bsr_matvec, trisk_matrices
from ..utils.pytree import pytree_dataclass
from .shallow_water import PrognosticVars
from .tracers import tracer_concentration as _tracer_concentration

__all__ = ["MatrixModel", "matrix_step", "matrix_fb_step", "matrix_run_loop"]


@pytree_dataclass
class MatrixModel:
    """Precompiled linear operators + masks for the matrix step."""

    grad: Bsr  # (nEdges x nCells)
    c2e: Bsr  # (nEdges x nCells)
    div: Bsr  # (nCells x nEdges)
    corf: Bsr  # (nEdges x nEdges), w * f folded in

    edge_mask_lv: jax.Array  # (nEdges, K) = edge_level_mask * edge_mask
    cell_level_mask: jax.Array  # (nCells, K)
    resting_thickness_sum: jax.Array  # (nCells,)
    # per-edge spacing, used only by the tracer upwind correction
    # (models/tracers.tracer_edge_value re-expressed with the c2e and grad
    # matrices this model already streams)
    dc_edge: jax.Array | None = None  # (nEdges,)

    # nonlinear (vector-invariant) extension — None unless built with
    # nonlinear=True (models/shallow_water.compute_normal_velocity_tendency
    # nonlinear branch, re-expressed as matmuls + elementwise products)
    tang: Bsr | None = None  # (nEdges x nEdges) weights-only tangential
    curl: Bsr | None = None  # (nVertices x nEdges)
    c2v: Bsr | None = None  # (nVertices x nCells) kite average
    v2e: Bsr | None = None  # (nEdges x nVertices) endpoint mean
    ke: Bsr | None = None  # (nCells x nEdges) applied to u^2
    f_vertex: jax.Array | None = None  # (nVertices,)
    vertex_level_mask: jax.Array | None = None  # (nVertices, K)

    @classmethod
    def from_mesh(cls, mesh, bs: int = 128, dtype=np.float32,
                  del2_coeff: float = 0.0,
                  nonlinear: bool = False) -> "MatrixModel":
        """``del2_coeff`` > 0 folds the del2 momentum-mixing operator into
        the Coriolis matrix (ops/bsr.del2_matrix_coo) — the mixing is then
        free at run time. (Like the gather path, the folded del2 is gated by
        the edge level mask, so both paths keep inactive-level velocity at
        exactly zero on variable-bathymetry meshes.)

        ``nonlinear=True`` additionally builds the vector-invariant
        operators so matrix_step/matrix_run_loop accept nonlinear=True.
        The nonlinear tendency never applies the linear Coriolis matrix, so
        with del2_coeff > 0 the `corf` slot holds the del2 operator alone
        (applied to u as its own matvec); with del2_coeff == 0 it is None."""
        mats = trisk_matrices(mesh, bs=bs, dtype=dtype, nonlinear=nonlinear)
        corf = mats["corf"]
        if del2_coeff:
            from ..ops.bsr import build_bsr, del2_matrix_coo

            ne = mesh.horz.edges.n_edges
            e = mesh.horz.edges
            eoe = np.asarray(e.edges_on_edge)
            w = np.asarray(e.weights_on_edge, dtype=np.float64)
            f = np.asarray(e.f, dtype=np.float64)
            r = np.repeat(np.arange(ne), eoe.shape[1])
            d2r, d2c, d2v = del2_matrix_coo(mesh)
            if nonlinear:
                # nonlinear mode never applies corf: the matrix becomes the
                # del2 operator alone (still gated by edge_mask_lv)
                corf = build_bsr(d2r, d2c, del2_coeff * d2v, ne, ne, bs, dtype)
            else:
                corf = build_bsr(
                    np.concatenate([r, d2r]),
                    np.concatenate([eoe.ravel(), d2c]),
                    np.concatenate([(w * f[eoe]).ravel(), del2_coeff * d2v]),
                    ne, ne, bs, dtype,
                )
        elif nonlinear:
            corf = None
        elm = jnp.asarray(mesh.vert.edge_level_mask, dtype)
        emask = jnp.asarray(mesh.horz.edges.edge_mask, dtype)
        extra = {}
        if nonlinear:
            extra = dict(
                tang=mats["tang"],
                curl=mats["curl"],
                c2v=mats["c2v"],
                v2e=mats["v2e"],
                ke=mats["ke"],
                f_vertex=jnp.asarray(mesh.horz.duals.f, dtype),
                vertex_level_mask=jnp.asarray(
                    mesh.vert.vertex_level_mask, dtype
                ),
            )
        return cls(
            grad=mats["grad"],
            c2e=mats["c2e"],
            div=mats["div"],
            corf=corf,
            edge_mask_lv=elm * emask[:, None],
            cell_level_mask=jnp.asarray(mesh.vert.cell_level_mask, dtype),
            resting_thickness_sum=jnp.asarray(
                mesh.vert.resting_thickness_sum, dtype
            ),
            dc_edge=jnp.asarray(mesh.horz.edges.dc_edge, dtype),
            **extra,
        )


def _matrix_tracer_tendency(tracers, flux, h_edge, mm: MatrixModel,
                            kappa: float, upwind: float):
    """d(hT)/dt as matmuls: models/tracers.tracer_tendency with the cell->
    edge mean and edge gradient applied as the c2e / grad matrices (the
    tracer axis rides along as extra matvec columns)."""
    nc, nt, k = tracers.shape
    tr2 = tracers.reshape(nc, nt * k)
    t_e = bsr_matvec(mm.c2e, tr2).reshape(-1, nt, k)
    g = None
    if upwind or kappa:
        g = bsr_matvec(mm.grad, tr2).reshape(-1, nt, k)
    if upwind:
        half_dc = (0.5 * upwind) * mm.dc_edge[:, None, None]
        t_e = t_e - half_dc * jnp.sign(flux[:, None, :]) * g
    fl = flux[:, None, :] * t_e
    if kappa:
        fl = fl - (kappa * h_edge * mm.edge_mask_lv)[:, None, :] * g
    ne = fl.shape[0]
    tend = -bsr_matvec(mm.div, fl.reshape(ne, nt * k)).reshape(nc, nt, k)
    return tend * mm.cell_level_mask[:, None, :]


def _matrix_tendencies(prog: PrognosticVars, mm: MatrixModel,
                       nonlinear: bool = False, forcing=None,
                       tracer_kappa: float = 0.0, tracer_upwind: float = 1.0,
                       strat=None):
    h, u = prog.layer_thickness, prog.normal_velocity
    h_edge = bsr_matvec(mm.c2e, h)
    flux = u * h_edge
    tend_h = -bsr_matvec(mm.div, flux) * mm.cell_level_mask
    tend_t = None
    if prog.tracers is not None:
        tend_t = _matrix_tracer_tendency(
            prog.tracers, flux, h_edge, mm, tracer_kappa, tracer_upwind
        )
    if strat is None:
        grad_ssh = bsr_matvec(mm.grad, prog.ssh)  # (nEdges,)
        tend_u = -GRAVITY * grad_ssh[:, None]
    else:
        # layered baroclinic pressure: Montgomery potential per layer
        # (models/stratification.py) through the same grad matrix
        from .stratification import montgomery_potential

        phi = montgomery_potential(prog.ssh, h, strat)
        tend_u = -bsr_matvec(mm.grad, phi)
    if nonlinear:
        if mm.tang is None:
            raise ValueError(
                "MatrixModel was built without nonlinear operators; "
                "rebuild with MatrixModel.from_mesh(..., nonlinear=True)"
            )
        # KE gradient (models/shallow_water nonlinear branch, as matmuls)
        ke = bsr_matvec(mm.ke, u * u)
        tend_u = tend_u - bsr_matvec(mm.grad, ke)
        # layer PV at vertices, bathymetry-masked with a safe denominator
        zeta = bsr_matvec(mm.curl, u)
        h_v = bsr_matvec(mm.c2v, h)
        vmask = mm.vertex_level_mask
        safe_h = jnp.where(vmask > 0, h_v, jnp.ones_like(h_v))
        q_v = (mm.f_vertex[:, None] + zeta) / safe_h * vmask
        q_e = bsr_matvec(mm.v2e, q_v)
        # symmetrized PV flux sum_j w_j F_j (q_e + q_j)/2
        half = jnp.asarray(0.5, u.dtype)
        tend_u = tend_u + half * (
            q_e * bsr_matvec(mm.tang, flux) + bsr_matvec(mm.tang, flux * q_e)
        )
        if mm.corf is not None:  # del2 mixing (folded standalone)
            tend_u = tend_u + bsr_matvec(mm.corf, u)
    else:
        tend_u = tend_u + bsr_matvec(mm.corf, u)
    if forcing is not None:
        # wind / bottom drag / Rayleigh (models/forcing.py) — elementwise
        # given the h_edge the flux matvec already produced
        from .forcing import forcing_tendency

        tend_u = tend_u + forcing_tendency(u, h_edge, forcing)
    return tend_u * mm.edge_mask_lv, tend_h, tend_t


def _ssh_of(h, mm):
    return (h * mm.cell_level_mask).sum(axis=1) - mm.resting_thickness_sum


def matrix_step(prog: PrognosticVars, mm: MatrixModel, dt,
                nonlinear: bool = False, forcing=None,
                tracer_kappa: float = 0.0,
                tracer_upwind: float = 1.0, strat=None) -> PrognosticVars:
    """One forward-Euler step, all stencils as BSR matmuls."""
    tend_u, tend_h, tend_t = _matrix_tendencies(
        prog, mm, nonlinear, forcing, tracer_kappa, tracer_upwind, strat
    )
    h_new = prog.layer_thickness + dt * tend_h
    u_new = prog.normal_velocity + dt * tend_u
    tracers = None
    if prog.tracers is not None:
        content = prog.layer_thickness[:, None, :] * prog.tracers + dt * tend_t
        tracers = _tracer_concentration(content, h_new, mm.cell_level_mask)
    return PrognosticVars(
        ssh=_ssh_of(h_new, mm), layer_thickness=h_new, normal_velocity=u_new,
        tracers=tracers,
    )


def matrix_fb_step(prog: PrognosticVars, mm: MatrixModel, dt,
                   nonlinear: bool = False, forcing=None,
                   tracer_kappa: float = 0.0,
                   tracer_upwind: float = 1.0, strat=None) -> PrognosticVars:
    """Forward-backward on the matrix path (mirrors
    forward/time_integration.forward_backward_step): h and tracers advance
    with the old flux, then u against the NEW pressure gradient while every
    other momentum term stays at the old state."""
    h0, u = prog.layer_thickness, prog.normal_velocity
    h_edge = bsr_matvec(mm.c2e, h0)
    flux = u * h_edge
    tend_h = -bsr_matvec(mm.div, flux) * mm.cell_level_mask
    h_new = h0 + dt * tend_h
    ssh_new = _ssh_of(h_new, mm)
    # full tendencies with the pressure evaluated at the NEW state: reuse
    # _matrix_tendencies on a hybrid prog (pressure terms only read
    # ssh/layer_thickness through the strat/grad branch below)
    if strat is None:
        tend_u = -GRAVITY * bsr_matvec(mm.grad, ssh_new)[:, None]
    else:
        from .stratification import montgomery_potential

        tend_u = -bsr_matvec(
            mm.grad, montgomery_potential(ssh_new, h_new, strat)
        )
    if nonlinear:
        if mm.tang is None:
            raise ValueError(
                "MatrixModel was built without nonlinear operators; "
                "rebuild with MatrixModel.from_mesh(..., nonlinear=True)"
            )
        ke = bsr_matvec(mm.ke, u * u)
        tend_u = tend_u - bsr_matvec(mm.grad, ke)
        zeta = bsr_matvec(mm.curl, u)
        h_v = bsr_matvec(mm.c2v, h0)
        vmask = mm.vertex_level_mask
        safe_h = jnp.where(vmask > 0, h_v, jnp.ones_like(h_v))
        q_v = (mm.f_vertex[:, None] + zeta) / safe_h * vmask
        q_e = bsr_matvec(mm.v2e, q_v)
        half = jnp.asarray(0.5, u.dtype)
        tend_u = tend_u + half * (
            q_e * bsr_matvec(mm.tang, flux) + bsr_matvec(mm.tang, flux * q_e)
        )
        if mm.corf is not None:
            tend_u = tend_u + bsr_matvec(mm.corf, u)
    else:
        tend_u = tend_u + bsr_matvec(mm.corf, u)
    if forcing is not None:
        from .forcing import forcing_tendency

        tend_u = tend_u + forcing_tendency(u, h_edge, forcing)
    u_new = u + dt * (tend_u * mm.edge_mask_lv)
    tracers = None
    if prog.tracers is not None:
        tend_t = _matrix_tracer_tendency(
            prog.tracers, flux, h_edge, mm, tracer_kappa, tracer_upwind
        )
        content = h0[:, None, :] * prog.tracers + dt * tend_t
        tracers = _tracer_concentration(content, h_new, mm.cell_level_mask)
    return PrognosticVars(ssh=ssh_new, layer_thickness=h_new,
                          normal_velocity=u_new, tracers=tracers)


def matrix_rk4_step(prog: PrognosticVars, mm: MatrixModel, dt,
                    nonlinear: bool = False, forcing=None,
                    tracer_kappa: float = 0.0,
                    tracer_upwind: float = 1.0, strat=None) -> PrognosticVars:
    """Classical RK4 on the matrix path (mirrors
    forward/time_integration.rk4_step, ssh rederived at every stage)."""
    u0, h0 = prog.normal_velocity, prog.layer_thickness
    with_tracers = prog.tracers is not None
    ht0 = h0[:, None, :] * prog.tracers if with_tracers else None

    def rates(p):
        return _matrix_tendencies(
            p, mm, nonlinear, forcing, tracer_kappa, tracer_upwind, strat
        )

    def stage(du, dh, dht, a):
        h = h0 + a * dh
        tracers = None
        if with_tracers:
            tracers = _tracer_concentration(ht0 + a * dht, h, mm.cell_level_mask)
        return PrognosticVars(
            ssh=_ssh_of(h, mm), layer_thickness=h, normal_velocity=u0 + a * du,
            tracers=tracers,
        )

    k1u, k1h, k1t = rates(prog)
    k2u, k2h, k2t = rates(stage(k1u, k1h, k1t, dt / 2.0))
    k3u, k3h, k3t = rates(stage(k2u, k2h, k2t, dt / 2.0))
    k4u, k4h, k4t = rates(stage(k3u, k3h, k3t, dt))
    u = u0 + (dt / 6.0) * (k1u + 2.0 * k2u + 2.0 * k3u + k4u)
    h = h0 + (dt / 6.0) * (k1h + 2.0 * k2h + 2.0 * k3h + k4h)
    tracers = None
    if with_tracers:
        ht = ht0 + (dt / 6.0) * (k1t + 2.0 * k2t + 2.0 * k3t + k4t)
        tracers = _tracer_concentration(ht, h, mm.cell_level_mask)
    return PrognosticVars(ssh=_ssh_of(h, mm), layer_thickness=h,
                          normal_velocity=u, tracers=tracers)


@partial(jax.jit, static_argnames=("n_steps", "rk4", "nonlinear",
                                   "tracer_kappa", "tracer_upwind", "fb"))
def matrix_run_loop(
    prog: PrognosticVars, mm: MatrixModel, dt, n_steps: int, rk4: bool = False,
    nonlinear: bool = False, forcing=None,
    tracer_kappa: float = 0.0, tracer_upwind: float = 1.0, strat=None,
    fb: bool = False,
) -> PrognosticVars:
    if rk4 and fb:
        raise ValueError("rk4 and fb are mutually exclusive")
    step = matrix_rk4_step if rk4 else (matrix_fb_step if fb else matrix_step)

    def body(p, _):
        return step(p, mm, dt, nonlinear, forcing,
                    tracer_kappa, tracer_upwind, strat), None

    out, _ = jax.lax.scan(body, prog, length=n_steps)
    return out
