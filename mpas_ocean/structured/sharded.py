"""Row-sharded structured hex model: the fast path scaled over a device mesh.

Splits the (2, ny2, nx, K) parity-plane lattice into P contiguous row
slabs, one per device, each padded with ONE halo row per side (the full
TRiSK step — interpolation, flux divergence, ssh gradient, the 60-term
Coriolis reconstruction — reaches at most one row up/down; the nx axis
stays whole and periodic on-device). Each step computes the slab interior
with gather-free slice/roll stencils and refreshes the halo rows with two
`lax.ppermute` rotations per field — nearest-neighbor traffic only, the
structured counterpart of parallel/ppermute.py.

This is the deployment path for meshes too large for one device's memory:
per-device compute is identical math to model.structured_step (tests
assert equality to the global rollout at f64 roundoff). Nonlinear
(vector-invariant) dynamics shard too: a second ppermute round exchanges
the derived fields (thickness flux, cell KE, edge PV) whose chained
stencil would otherwise need a 2-ring halo — the slab counterpart of
parallel/shard_step.py's derived-field exchange.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh as DeviceMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from ..constants import GRAVITY
from .conv_model import _INCOMING, _NEIGHBOR
from .hex_layout import E, NE, NW
from .model import StructMesh, StructState

try:  # JAX >= 0.6
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

__all__ = ["ShardedStructuredModel"]


def _roll_nx(y, di: int):
    """Periodic nx-shift out[.., i, ..] = y[.., i+di, ..] as static
    slice+concat."""
    if di:
        y = jnp.concatenate([y[:, di:], y[:, :di]], axis=1)
    return y


def _sh(x, dm: int, di: int, rows: int):
    """Interior-row shift on a halo-padded plane: out[m, i] = x[1+m+dm, i+di]
    for m in [0, rows); di wraps periodically on the (whole) nx axis."""
    return _roll_nx(x[1 + dm : 1 + dm + rows], di)


def _interior(x, rows: int):
    return x[1 : 1 + rows]


def _forcing_core(u_i, he_i, wind_c, top_c, bot_c, dlin, dquad, rayl):
    """models/forcing.forcing_tendency, operation for operation: single
    shared reciprocal, wind on the top mask, linear+quadratic drag on the
    bottom mask, Rayleigh everywhere."""
    inv_h = jnp.ones_like(he_i) / jnp.where(
        he_i > 0, he_i, jnp.ones_like(he_i)
    )
    t = top_c * (wind_c * inv_h)
    t = t - bot_c * (dlin * u_i + dquad * jnp.abs(u_i) * u_i * inv_h)
    return t - rayl * u_i


def _apply_forcing(u_i, he_i, forc, c):
    """Elementwise wind / bottom-drag / Rayleigh term for edge channel c on
    interior rows (models/forcing.forcing_tendency, slab layout):
    forc = (wind6, top6, bot6, drag_lin, drag_quad, rayleigh), each field a
    6-tuple of halo-padded planes sliced to interior by the caller."""
    wind, top, bot, dlin, dquad, rayl = forc
    return _forcing_core(u_i, he_i, wind[c], top[c], bot[c], dlin, dquad,
                         rayl)


def _flux_thickness(h, u, rts, dt, s_div, rows):
    """Thickness flux + continuity update from 1-halo-padded planes.

    Flux/h_edge are evaluated on padded rows [0, rows+1): the divergence
    needs flux at the interior rows AND one row below (_INCOMING dm=-1
    taps); the flux itself reads h up to one row above, so the single halo
    row on each side covers the chained two-operator reach. Returns
    (fluxp, hep, h_new, ssh_new) with fluxp/hep keyed (fam, p) on padded
    rows and h_new/ssh_new interior-row lists."""
    fluxp = {}
    hep = {}
    for fam in (E, NE, NW):
        for p in (0, 1):
            pin, dm, di = _NEIGHBOR[(fam, p)]
            # padded-slab shift: out[m] = x[m+dm] for m in [0, rows+1)
            hn = _roll_nx(h[pin][dm : dm + rows + 1], di)
            hep[(fam, p)] = 0.5 * (hn + h[p][:rows + 1])
            fluxp[(fam, p)] = u[fam * 2 + p][:rows + 1] * hep[(fam, p)]

    h_new, ssh_new = [], []
    for p in (0, 1):
        # outgoing at own row m (padded index 1+m -> fluxp index 1+m)
        total = (
            fluxp[(E, p)][1 : 1 + rows]
            + fluxp[(NE, p)][1 : 1 + rows]
            + fluxp[(NW, p)][1 : 1 + rows]
        )
        for ch, dm, di in _INCOMING[p]:
            fam_in, p_in = divmod(ch, 2)
            total = total - _roll_nx(
                fluxp[(fam_in, p_in)][1 + dm : 1 + dm + rows], di
            )
        hp = _interior(h[p], rows) - (dt * s_div) * total
        h_new.append(hp)
        ssh_new.append(jnp.sum(hp, axis=-1, keepdims=True) - _interior(rts[p], rows))
    return fluxp, hep, h_new, ssh_new


def _step_slab(ssh, h, u, f_edge, rts, dt, inv_dc, s_div, terms, rows,
               masks=None, forc=None, tr=None, tropts=(0.0, 1.0), cmask=None,
               strat_w=None, fb=False):
    """One forward-Euler step on a halo-padded slab; returns interior-only
    planes (ssh, h, u, tracers-or-None). Mirrors model.structured_step
    with halo reads instead of periodic wraps (same coefficients, same
    order). ``masks`` (halo-padded like f_edge, or None) pins
    wall/dead-edge velocity to zero. ``forc`` (see _apply_forcing; fields
    halo-padded) adds the momentum forcing. ``tr`` (list of halo-padded
    (R+2, nx, K) planes indexed [t*2 + p]) advects tracers
    (models/tracers.py, slab form) with ``tropts = (kappa, upwind)``; ``cmask`` (2-tuple of padded (R+2, nx, 1)
    live-cell masks) guards the content/h division on culled lattices.

    ``fb=True`` selects the forward-backward scheme (model.
    structured_fb_step): the pressure stage reads the FRESH thickness/ssh,
    whose own 1-ring makes the total stencil reach TWO rows — all inputs
    must then carry two halo rows per side (rows+4 planes); the continuity
    update runs on the inner 1-pad window and every old-state term is
    sliced to that window first."""
    if fb:
        fluxp_w, hep_w, hn_pad, sshn_pad = _flux_thickness(
            h, u, rts, dt, s_div, rows + 2
        )
        inner = lambda t: tuple(x[1:-1] for x in t)
        ssh, h, u = inner(ssh), inner(h), inner(u)
        f_edge, rts = inner(f_edge), inner(rts)
        if masks is not None:
            masks = inner(masks)
        if forc is not None:
            forc = (inner(forc[0]), inner(forc[1]), inner(forc[2]),
                    forc[3], forc[4], forc[5])
        if tr is not None:
            tr = inner(tr)
        if cmask is not None:
            cmask = inner(cmask)
        # re-window the padded flux/h_edge/new-thickness planes to the
        # inner 1-pad frame: padded-window row r maps to inner row r-1
        fluxp = {kk: v[1 : rows + 2] for kk, v in fluxp_w.items()}
        hep = {kk: v[1 : rows + 2] for kk, v in hep_w.items()}
        h_new = [x[1:-1] for x in hn_pad]
        ssh_new = [x[1:-1] for x in sshn_pad]
        pg_ssh, pg_h = tuple(sshn_pad), tuple(hn_pad)  # 1-padded NEW fields
    else:
        fluxp, hep, h_new, ssh_new = _flux_thickness(h, u, rts, dt, s_div,
                                                     rows)
        pg_ssh, pg_h = ssh, h

    if strat_w is None:
        pg_field, pg_scale = pg_ssh, -GRAVITY * dt
    else:
        # layered baroclinic pressure: Montgomery potential on the padded
        # planes (models/stratification.py), then the same slab gradient
        # reshape-to-2D dot: the same contraction per row
        pg_field = tuple(
            GRAVITY * pg_ssh[p] + jnp.dot(
                pg_h[p].reshape(-1, pg_h[p].shape[-1]), strat_w,
                preferred_element_type=pg_h[p].dtype,
                precision=jax.lax.Precision.HIGHEST,
            ).reshape(pg_h[p].shape)
            for p in (0, 1)
        )
        pg_scale = -dt
    grad2 = []
    for fam in (E, NE, NW):
        for p in (0, 1):
            pin, dm, di = _NEIGHBOR[(fam, p)]
            grad2.append(
                (_sh(pg_field[pin], dm, di, rows)
                 - _interior(pg_field[p], rows)) * inv_dc
            )

    uf = [u[c] * f_edge[c] for c in range(6)]
    acc = [None] * 6
    for f_out, p_out, f_in, p_in, dm, di, w in terms:
        contrib = w * _sh(uf[f_in * 2 + p_in], dm, di, rows)
        c = f_out * 2 + p_out
        acc[c] = contrib if acc[c] is None else acc[c] + contrib

    u_new = [
        _interior(u[c], rows) + dt * acc[c] + pg_scale * grad2[c]
        for c in range(6)
    ]
    if forc is not None:
        wind, top, bot, dlin, dquad, rayl = forc
        forc_i = (
            tuple(w[1 : 1 + rows] for w in wind),
            tuple(t[1 : 1 + rows] for t in top),
            tuple(b[1 : 1 + rows] for b in bot),
            dlin, dquad, rayl,
        )
        for c in range(6):
            fam, p = divmod(c, 2)
            u_new[c] = u_new[c] + dt * _apply_forcing(
                _interior(u[c], rows), hep[(fam, p)][1 : 1 + rows],
                forc_i, c,
            )
    if masks is not None:
        u_new = [u_new[c] * _interior(masks[c], rows) for c in range(6)]

    t_new = None
    if tr is not None:
        kappa, upwind = tropts
        t_new = []
        for t in range(len(tr) // 2):
            # tracer edge flux G on padded rows [0, rows+1), same row window
            # as fluxp; T_e = mean - (upwind/2) sign(F) (T_n - T_p) — the
            # dc/dc of the unstructured formulation cancels on the lattice
            gfl = {}
            for fam in (E, NE, NW):
                for p in (0, 1):
                    pin, dm, di = _NEIGHBOR[(fam, p)]
                    tn = _roll_nx(tr[t * 2 + pin][dm : dm + rows + 1], di)
                    tp = tr[t * 2 + p][: rows + 1]
                    te = 0.5 * (tn + tp)
                    F = fluxp[(fam, p)]
                    if upwind:
                        te = te - (0.5 * upwind) * jnp.sign(F) * (tn - tp)
                    g = F * te
                    if kappa:
                        diff = kappa * hep[(fam, p)]
                        if masks is not None:
                            diff = diff * masks[fam * 2 + p][: rows + 1]
                        g = g - diff * ((tn - tp) * inv_dc)
                    gfl[(fam, p)] = g
            for p in (0, 1):
                total = (
                    gfl[(E, p)][1 : 1 + rows]
                    + gfl[(NE, p)][1 : 1 + rows]
                    + gfl[(NW, p)][1 : 1 + rows]
                )
                for ch, dm, di in _INCOMING[p]:
                    fam_in, p_in = divmod(ch, 2)
                    total = total - _roll_nx(
                        gfl[(fam_in, p_in)][1 + dm : 1 + dm + rows], di
                    )
                content = (
                    _interior(h[p], rows) * _interior(tr[t * 2 + p], rows)
                    - (dt * s_div) * total
                )
                if cmask is not None:
                    cm = _interior(cmask[p], rows)
                    safe = jnp.where(cm > 0, h_new[p], jnp.ones_like(h_new[p]))
                    t_new.append(content / safe * cm)
                else:
                    t_new.append(content / h_new[p])
        t_new = tuple(t_new)
    return tuple(ssh_new), tuple(h_new), tuple(u_new), t_new


def _derived_slab(h, u, mesh_sc, rows):
    """Stage A of the nonlinear slab step: from 1-ring-padded prognostic
    slabs, compute the derived fields whose own 1-ring halos the second
    exchange round will provide — thickness flux and edge PV on the
    interior rows, cell kinetic energy on the interior rows. Mirrors
    parallel/shard_step.py's derived-field exchange (the same reason: the
    chained nonlinear stencil reaches 2 rows, but every individual factor
    reaches at most 1, so exchanging the intermediate fields keeps the
    1-ring halo exact).

    mesh_sc: (inv_dc, ke_scale, curl_scale, f_vertex_pad, vc_terms,
    ev_terms[, vmask_pad, kitew_pad]) — static scalars/stencils + padded
    f_vertex planes; the optional trailing pair (wall-masked lattices)
    carries the live-vertex mask planes and per-site live-renormalized
    kite weight planes (model.pv_on_vertex_struct's boundary handling).
    Vertex fields (zeta, h_v, q_v) are computed on padded rows
    [0, rows+1): their cell/edge taps only reach dm in {0, +1}, and the
    edge PV endpoint taps only reach dm in {-1, 0}, so that row range is
    both locally computable and sufficient (asserted at model build)."""
    inv_dc, ke_scale, curl_scale, f_v, vc_terms, ev_terms, *opt = mesh_sc
    vmask, kitew = opt if opt else (None, None)

    # thickness flux on interior rows
    flux = []
    for fam in (E, NE, NW):
        for p in (0, 1):
            pin, dm, di = _NEIGHBOR[(fam, p)]
            hn = _sh(h[pin], dm, di, rows)
            flux.append(
                u[fam * 2 + p][1 : 1 + rows] * (0.5 * (hn + h[p][1:1 + rows]))
            )

    # cell kinetic energy on interior rows (owned 3 edges + incoming 3)
    sq = [x * x for x in u]
    ke = []
    for p in (0, 1):
        total = (
            sq[E * 2 + p][1 : 1 + rows]
            + sq[NE * 2 + p][1 : 1 + rows]
            + sq[NW * 2 + p][1 : 1 + rows]
        )
        for ch, dm, di in _INCOMING[p]:
            total = total + _sh(sq[ch], dm, di, rows)
        ke.append(total * ke_scale)

    # relative vorticity + kite thickness at vertices, padded rows
    # [0, rows+1) (bottom halo + interior; taps reach dm in {0, +1} only)
    n = rows + 1

    def shp(x, dm, di):  # out[r] = x[r + dm, i + di], r in [0, rows+1)
        return _roll_nx(x[dm : dm + n], di)

    uE0, uE1 = u[E * 2], u[E * 2 + 1]
    uNE0, uNE1 = u[NE * 2], u[NE * 2 + 1]
    uNW0, uNW1 = u[NW * 2], u[NW * 2 + 1]
    # curl_A(c) = (u_NE(c) - u_E(NW(c)) - u_NW(c)) * dc / A_tri
    # curl_B(c) = (u_E(c) + u_NW(E(c)) - u_NE(c)) * dc / A_tri
    # (structured/model.curl_on_vertex, slab form)
    zeta = [
        (uNE0[:n] - shp(uE1, 0, -1) - uNW0[:n]) * curl_scale,  # A, p=0
        (uNE1[:n] - shp(uE0, 1, 0) - uNW1[:n]) * curl_scale,   # A, p=1
        (uE0[:n] + shp(uNW0, 0, 1) - uNE0[:n]) * curl_scale,   # B, p=0
        (uE1[:n] + shp(uNW1, 0, 1) - uNE1[:n]) * curl_scale,   # B, p=1
    ]
    h_v = [None] * 4
    for t, (kind, p_out, p_in, dm, di, w) in enumerate(vc_terms):
        wgt = w if kitew is None else kitew[t][:n]
        contrib = wgt * shp(h[p_in], dm, di)
        c = kind * 2 + p_out
        h_v[c] = contrib if h_v[c] is None else h_v[c] + contrib
    if vmask is None:
        q_v = [(f_v[c][:n] + zeta[c]) / h_v[c] for c in range(4)]
    else:
        q_v = [
            (f_v[c][:n] + zeta[c])
            / jnp.where(vmask[c][:n] > 0, h_v[c], jnp.ones_like(h_v[c]))
            * vmask[c][:n]
            for c in range(4)
        ]

    # edge PV = endpoint mean of q_v, interior rows (taps dm in {-1, 0}:
    # q_v rows [0, rows+1) cover padded rows 1+dm .. rows+dm)
    q_e = [None] * 6
    for f_out, p_out, kind, p_in, dm, di in ev_terms:
        contrib = _roll_nx(q_v[kind * 2 + p_in][1 + dm : 1 + dm + rows], di)
        c = f_out * 2 + p_out
        q_e[c] = contrib if q_e[c] is None else q_e[c] + contrib
    q_e = [0.5 * x for x in q_e]

    return flux, ke, q_e


def _nl_continuity(h, flux, rts, dt, s_div, rows):
    """New thickness/ssh on ``rows`` rows from 1-padded h/rts planes
    (rows+2) and flux planes in the matching frame (plane row r = window
    row r-1, as _derived_slab emits them). The continuity block of
    _apply_slab_nonlinear, exposed so the forward-backward nonlinear step
    can evaluate the FRESH thickness on a padded window first."""
    h_new, ssh_new = [], []
    for p in (0, 1):
        total = (
            flux[E * 2 + p][1 : 1 + rows]
            + flux[NE * 2 + p][1 : 1 + rows]
            + flux[NW * 2 + p][1 : 1 + rows]
        )
        for ch, dm, di in _INCOMING[p]:
            total = total - _sh(flux[ch], dm, di, rows)
        hp = _interior(h[p], rows) - (dt * s_div) * total
        h_new.append(hp)
        ssh_new.append(
            jnp.sum(hp, axis=-1, keepdims=True) - _interior(rts[p], rows)
        )
    return h_new, ssh_new


def _apply_slab_nonlinear(ssh, h, u, flux, ke, q_e, rts, dt, inv_dc, s_div,
                          terms, rows, forc=None, tr=None,
                          tropts=(0.0, 1.0), strat_w=None, masks=None,
                          cmask=None, pg_fresh=None):
    """Stage B of the nonlinear slab step: with 1-ring-padded prognostic
    AND derived slabs, produce the new interior rows (+ tracers when ``tr``
    is given — the tracer flux reads the PADDED exchanged thickness flux,
    so one derived round covers it). Same math/order as
    structured/model.structured_step(nonlinear=True). ``masks`` pins
    wall/dead-edge velocity to zero and masks the tracer diffusion;
    ``cmask`` guards the tracer content/h division on culled lattices.
    ``pg_fresh`` (1-padded (ssh_new, h_new) plane pairs, or None) makes the
    PRESSURE terms read those fresh fields instead of the old state — the
    forward-backward scheme (model.structured_fb_step nonlinear branch);
    every other term stays at the old state."""
    h_new, ssh_new = _nl_continuity(h, flux, rts, dt, s_div, rows)

    def grad(cell_field):
        out = []
        for fam in (E, NE, NW):
            for p in (0, 1):
                pin, dm, di = _NEIGHBOR[(fam, p)]
                out.append(
                    (_sh(cell_field[pin], dm, di, rows)
                     - _interior(cell_field[p], rows)) * inv_dc
                )
        return out

    pg_ssh, pg_h = (ssh, h) if pg_fresh is None else pg_fresh
    if strat_w is None:
        grad_ssh, pg_scale = grad(pg_ssh), -GRAVITY * dt
    else:
        # reshape-to-2D dot: the same contraction per row
        phi = tuple(
            GRAVITY * pg_ssh[p] + jnp.dot(
                pg_h[p].reshape(-1, pg_h[p].shape[-1]), strat_w,
                preferred_element_type=pg_h[p].dtype,
                precision=jax.lax.Precision.HIGHEST,
            ).reshape(pg_h[p].shape)
            for p in (0, 1)
        )
        grad_ssh, pg_scale = grad(phi), -dt
    grad_ke = grad(ke)

    def tangential(x):  # sum_j w_j x[eoe_j], interior rows
        acc = [None] * 6
        for f_out, p_out, f_in, p_in, dm, di, w in terms:
            contrib = w * _sh(x[f_in * 2 + p_in], dm, di, rows)
            c = f_out * 2 + p_out
            acc[c] = contrib if acc[c] is None else acc[c] + contrib
        return acc

    w_flux = tangential(flux)
    fq = [flux[c] * q_e[c] for c in range(6)]
    w_fq = tangential(fq)

    u_new = []
    for c in range(6):
        pv = 0.5 * (q_e[c][1 : 1 + rows] * w_flux[c] + w_fq[c])
        un = (
            _interior(u[c], rows)
            + dt * (pv - grad_ke[c])
            + pg_scale * grad_ssh[c]
        )
        if forc is not None:
            fam, p = divmod(c, 2)
            pin, dm, di = _NEIGHBOR[(fam, p)]
            he_i = 0.5 * (
                _sh(h[pin], dm, di, rows) + _interior(h[p], rows)
            )
            wind, top, bot, dlin, dquad, rayl = forc
            forc_i = (
                tuple(w[1 : 1 + rows] for w in wind),
                tuple(t[1 : 1 + rows] for t in top),
                tuple(b[1 : 1 + rows] for b in bot),
                dlin, dquad, rayl,
            )
            un = un + dt * _apply_forcing(
                _interior(u[c], rows), he_i, forc_i, c
            )
        if masks is not None:
            un = un * _interior(masks[c], rows)
        u_new.append(un)

    t_new = None
    if tr is not None:
        kappa, upwind = tropts
        t_new = []
        for t in range(len(tr) // 2):
            gfl = {}
            for fam in (E, NE, NW):
                for p in (0, 1):
                    pin, dm, di = _NEIGHBOR[(fam, p)]
                    tn = _roll_nx(tr[t * 2 + pin][dm : dm + rows + 1], di)
                    tp = tr[t * 2 + p][: rows + 1]
                    te = 0.5 * (tn + tp)
                    # flux planes are PADDED here: padded row r = window row r
                    F = flux[fam * 2 + p][: rows + 1]
                    if upwind:
                        te = te - (0.5 * upwind) * jnp.sign(F) * (tn - tp)
                    g = F * te
                    if kappa:
                        hn = _roll_nx(h[pin][dm : dm + rows + 1], di)
                        hep = 0.5 * (hn + h[p][: rows + 1])
                        diff = kappa * hep
                        if masks is not None:
                            diff = diff * masks[fam * 2 + p][: rows + 1]
                        g = g - diff * ((tn - tp) * inv_dc)
                    gfl[(fam, p)] = g
            for p in (0, 1):
                total = (
                    gfl[(E, p)][1 : 1 + rows]
                    + gfl[(NE, p)][1 : 1 + rows]
                    + gfl[(NW, p)][1 : 1 + rows]
                )
                for ch, dm, di in _INCOMING[p]:
                    fam_in, p_in = divmod(ch, 2)
                    total = total - _roll_nx(
                        gfl[(fam_in, p_in)][1 + dm : 1 + dm + rows], di
                    )
                content = (
                    _interior(h[p], rows) * _interior(tr[t * 2 + p], rows)
                    - (dt * s_div) * total
                )
                if cmask is not None:
                    cm = _interior(cmask[p], rows)
                    safe = jnp.where(
                        cm > 0, h_new[p], jnp.ones_like(h_new[p])
                    )
                    t_new.append(content / safe * cm)
                else:
                    t_new.append(content / h_new[p])
        t_new = tuple(t_new)
    return tuple(ssh_new), tuple(h_new), tuple(u_new), t_new


def _step_slab_nl(ssh, h, u, f_edge, rts, f_v, dt, inv_dc, s_div, ke_scale,
                  curl_scale, terms, vc_terms, ev_terms, rows, forc=None,
                  tr=None, tropts=(0.0, 1.0), strat_w=None, masks=None,
                  cmask=None, fb=False):
    """One NONLINEAR (vector-invariant) step computed fully locally on
    TWO-halo-padded planes (rows+4) -> interior rows; ``fb=True`` selects
    forward-backward semantics and needs THREE halo rows per side
    (rows+6 planes, reach 3).

    Where the sharded `run` path exchanges the derived fields (flux, KE,
    edge PV) in a second ppermute round to stay exact on a 1-ring halo,
    this variant instead RECOMPUTES them on a 1-padded window from a 2-ring
    halo — the communication-free form the sharded superstep needs (halo
    rows are consumed 2 per side per step).
    Same math/order as _derived_slab + _apply_slab_nonlinear, so all
    nonlinear paths agree to roundoff.

    ``f_v`` carries 4 planes on periodic lattices, or the stacked
    [f_vertex (4); vertex_mask (4); kite weights (12)] on wall-masked
    ones; ``masks``/``cmask`` then pin
    wall-edge velocity / guard the tracer division exactly like the linear
    slab step."""
    if len(f_v) > 4:
        fvert, vmask, kitew = f_v[:4], f_v[4:8], f_v[8:]
        mesh_sc = (inv_dc, ke_scale, curl_scale, fvert, vc_terms, ev_terms,
                   vmask, kitew)
    else:
        mesh_sc = (inv_dc, ke_scale, curl_scale, f_v, vc_terms, ev_terms)
    if fb:
        # reach-3 forward-backward: inputs carry THREE halo rows per side
        # (rows+6 planes). Derived fields on a 2-padded window (rows+4
        # planes, from the full rows+6 inputs), then the FRESH
        # thickness/ssh on a 1-padded window (rows+2) from that flux, and
        # stage B reads the pressure from the fresh fields
        # (model.structured_fb_step nonlinear branch) while every other
        # term stays at the old state.
        flux, ke, q_e = _derived_slab(h, u, mesh_sc, rows + 4)
        in1 = lambda t: tuple(x[1:-1] for x in t)
        in2 = lambda t: tuple(x[2:-2] for x in t)
        hn_pad, sshn_pad = _nl_continuity(
            in1(h), flux, in1(rts), dt, s_div, rows + 2
        )
        if forc is not None:
            forc = (in2(forc[0]), in2(forc[1]), in2(forc[2]),
                    forc[3], forc[4], forc[5])
        return _apply_slab_nonlinear(
            in2(ssh), in2(h), in2(u), in1(flux), in1((ke[0], ke[1])),
            in1(q_e), in2(rts), dt, inv_dc, s_div, terms, rows, forc,
            in2(tr) if tr is not None else None, tropts, strat_w,
            in2(masks) if masks is not None else None,
            in2(cmask) if cmask is not None else None,
            pg_fresh=(tuple(sshn_pad), tuple(hn_pad)),
        )
    flux, ke, q_e = _derived_slab(h, u, mesh_sc, rows + 2)
    inner = lambda t: tuple(x[1:-1] for x in t)
    if forc is not None:
        forc = (inner(forc[0]), inner(forc[1]), inner(forc[2]),
                forc[3], forc[4], forc[5])
    return _apply_slab_nonlinear(
        inner(ssh), inner(h), inner(u), flux, (ke[0], ke[1]), q_e,
        inner(rts), dt, inv_dc, s_div, terms, rows, forc,
        inner(tr) if tr is not None else None, tropts, strat_w,
        inner(masks) if masks is not None else None,
        inner(cmask) if cmask is not None else None,
    )


def _reach(nonlinear: bool, fb: bool) -> int:
    """Halo rows consumed per side per timestep by the superstep window:
    1 for the linear core; 2 for nonlinear (derived fields recomputed on a
    1-padded window) or forward-backward (fresh-thickness pressure reads
    one ring further); 3 for nonlinear + forward-backward (the fresh
    thickness itself needs the 1-padded flux window)."""
    if nonlinear:
        return 3 if fb else 2
    return 2 if fb else 1


def _window_steps(ssh, h, u, tr, f_edge, rts, dt, inv_dc, s_div, terms, *,
                  rows, q, reach, masks=None, forc=None, cmask=None,
                  strat_w=None, tropts=(0.0, 1.0), nl=None, fb=False):
    """Advance a window of ``rows + 2*reach*q`` halo-padded rows by q
    timesteps; the valid window shrinks ``reach`` rows per side per step,
    so the result is the ``rows`` interior rows. Every argument that is a
    tuple of planes (state, constants, forcing fields) spans the full
    window. ``nl`` is None for the linear core, or (f_v planes, ke_scale,
    curl_scale, vertex_cell_terms, edge_vertex_terms) for the nonlinear
    step."""
    full = rows + 2 * reach * q
    for j in range(q):
        rows_j = rows + 2 * reach * (q - 1 - j)
        off = reach * j

        def win(t):
            return None if t is None else tuple(x[off: full - off] for x in t)

        forc_j = None if forc is None else (
            win(forc[0]), win(forc[1]), win(forc[2]), *forc[3:])
        if nl is not None:
            f_v, ke_scale, curl_scale, vc_terms, ev_terms = nl
            ssh, h, u, tr = _step_slab_nl(
                ssh, h, u, win(f_edge), win(rts), win(f_v), dt, inv_dc,
                s_div, ke_scale, curl_scale, terms, vc_terms, ev_terms,
                rows_j, forc_j, tr, tropts, strat_w, win(masks), win(cmask),
                fb=fb,
            )
        else:
            ssh, h, u, tr = _step_slab(
                ssh, h, u, win(f_edge), win(rts), dt, inv_dc, s_div, terms,
                rows_j, win(masks), forc_j, tr, tropts, win(cmask), strat_w,
                fb,
            )
    return ssh, h, u, tr


def _with_halo(interior, axis_name: str, n_parts: int, hq: int = 1):
    """Rebuild padded slabs from stacked interior planes (planes, R, nx,
    ...): ``hq`` halo rows per side, row block [-hq:] from the previous
    device and [:hq] from the next — one ppermute per direction per field
    regardless of hq (the payload just carries hq rows). Requires hq <= R
    (one-neighbor exchange)."""
    down = [(i, (i + 1) % n_parts) for i in range(n_parts)]
    up = [(i, (i - 1) % n_parts) for i in range(n_parts)]
    top = jax.lax.ppermute(interior[:, -hq:], axis_name, down)
    bot = jax.lax.ppermute(interior[:, :hq], axis_name, up)
    return jnp.concatenate([top, interior, bot], axis=1)


class ShardedStructuredModel:
    """Drive the structured fast path over a 1-D device mesh (row slabs).

    The step is split so halo traffic overlaps interior compute (the
    BASELINE north-star "halo-exchange overlap" metric; SURVEY section 8
    plan): the two boundary rows of each slab are stepped FIRST, their
    ppermutes are issued, and the remaining R-2 interior rows are stepped
    while the collectives are in flight — XLA's latency-hiding scheduler
    turns the ppermutes into collective-permute-start/done pairs around the
    independent interior work. Row values are identical either way up to
    XLA's FMA contraction choices (each row's update reads only its
    1-ring, so the split itself is exact; tests pin agreement at 1e-12).
    """

    AXIS = "rows"

    def __init__(self, struct_mesh: StructMesh, devices=None,
                 overlap: bool = True, device_mesh: DeviceMesh | None = None):
        """``device_mesh``: optional prebuilt mesh — 1-D, or the 2-D
        ('dcn', 'ici') hybrid mesh from parallel.distributed.
        hybrid_device_mesh for multi-host runs: row slabs shard over the
        FLATTENED axes, so ring ppermutes stay within a host except at
        the P_dcn host boundaries."""
        if device_mesh is not None:
            self.device_mesh = device_mesh
            self.axes = tuple(device_mesh.axis_names)
            self.n_parts = int(np.prod(list(device_mesh.shape.values())))
        else:
            devices = list(devices if devices is not None else jax.devices())
            self.n_parts = len(devices)
            self.device_mesh = DeviceMesh(np.array(devices), (self.AXIS,))
            self.axes = (self.AXIS,)
        self.smesh = struct_mesh
        self.overlap = bool(overlap)
        ny2 = struct_mesh.ny2
        if ny2 % self.n_parts:
            raise ValueError(
                f"ny2={ny2} rows not divisible by {self.n_parts} devices"
            )
        self.rows = ny2 // self.n_parts
        self._sharding = NamedSharding(self.device_mesh, P(self.axes))

        # static per-slab mesh fields, halo-padded and stacked on a leading
        # parts axis: f_edge (P, 6, R+2, nx, 1), rts (P, 2, R+2, nx, 1)
        f = np.asarray(struct_mesh.f_edge).reshape(6, ny2, struct_mesh.nx, 1)
        rts = np.asarray(struct_mesh.resting_thickness_sum)[..., None]
        self._f_local = self._put(self._slab(f))
        self._rts_local = self._put(self._slab(rts))
        if struct_mesh.edge_mask is None:
            self._mask_local = None
        else:
            m = np.asarray(struct_mesh.edge_mask).reshape(
                6, ny2, struct_mesh.nx, 1
            )
            self._mask_local = self._put(self._slab(m))
        if struct_mesh.f_vertex is None:
            self._fv_local = None
        else:
            self._fv_local = self._put(self._slab(self._fv_planes()))
        if struct_mesh.cell_mask is None:
            self._cmask_local = None
        else:
            cm = np.asarray(struct_mesh.cell_mask)[..., None]
            self._cmask_local = self._put(self._slab(cm))

    def _put(self, host_array):
        """Place a host-global array onto the device mesh — via device_put
        when every device is addressable, via make_array_from_callback in
        multi-process runs (each process feeds only its own shards)."""
        arr = np.asarray(host_array)
        if self._sharding.is_fully_addressable:
            return jax.device_put(jnp.asarray(arr), self._sharding)
        return jax.make_array_from_callback(
            arr.shape, self._sharding, lambda idx: arr[idx]
        )

    def _slab(self, x, m_axis=None, halo: int = 1):
        """(planes..., ny2, nx, ...) -> (P, planes..., R+2*halo, nx, ...)
        with periodic halo rows (host-side numpy). ``m_axis`` overrides the
        default single-trailing-axis assumption (tracer slabs trail
        (nT, K))."""
        ny2 = self.smesh.ny2
        if m_axis is None:
            m_axis = x.ndim - 3  # (..., ny2, nx, trailing)
        out = []
        for q in range(self.n_parts):
            rows = [
                (q * self.rows + r) % ny2
                for r in range(-halo, self.rows + halo)
            ]
            out.append(np.take(x, rows, axis=m_axis))
        return np.stack(out)

    def scatter(self, state: StructState):
        """Global structured state -> stacked halo-padded slabs on devices."""
        k = state.layer_thickness.shape[-1]
        nx = self.smesh.nx
        ssh = np.asarray(state.ssh)[..., None]  # (2, ny2, nx, 1)
        h = np.asarray(state.layer_thickness)
        u = np.asarray(state.normal_velocity).reshape(6, self.smesh.ny2, nx, k)
        out = {
            "ssh": self._put(self._slab(ssh)),
            "h": self._put(self._slab(h)),
            "u": self._put(self._slab(u)),
        }
        if state.tracers is not None:
            # (2, ny2, nx, nT, K) -> plane stack (nT*2, ny2, nx, K)
            # [t*2 + p] -> slabs (P, nT*2, R+2, nx, K) — the same layout
            # the slab steps use
            tr = np.moveaxis(np.asarray(state.tracers), 3, 0).reshape(
                -1, self.smesh.ny2, nx, k
            )
            out["t"] = self._put(self._slab(tr))
        return out

    def gather(self, local) -> StructState:
        """Stacked slabs -> global structured state (interior rows only)."""
        ny2, nx = self.smesh.ny2, self.smesh.nx

        def unslab(x):  # (P, planes, R+2, nx, ...) -> (planes, ny2, nx, ...)
            x = np.asarray(x)[:, :, 1:-1]
            return np.concatenate([x[q] for q in range(self.n_parts)], axis=1)

        ssh = unslab(local["ssh"])[..., 0]
        h = unslab(local["h"])
        u = unslab(local["u"])
        k = h.shape[-1]
        tracers = None
        if "t" in local:
            planes = unslab(local["t"])  # (nT*2, ny2, nx, K)
            tracers = jnp.asarray(
                np.moveaxis(planes.reshape(-1, 2, ny2, nx, planes.shape[-1]),
                            0, 3)
            )
        return StructState(
            ssh=jnp.asarray(ssh),
            layer_thickness=jnp.asarray(h),
            normal_velocity=jnp.asarray(u.reshape(3, 2, ny2, nx, k)),
            tracers=tracers,
        )

    def step_stats(self, n_vert_levels: int, itemsize: int = 4, *,
                   path: str = "run", q: int = 1,
                   nonlinear: bool = False, fb: bool = False,
                   n_tracers: int = 0) -> dict:
        """DETERMINISTIC structural communication/compute profile of one
        timestep on this decomposition — no timing, no noise, exactly
        reproducible, so it can serve as a regression sentinel where
        wall-clock proxies cannot (the virtual-CPU mesh's run-to-run
        swings make its efficiencies useless for regression diffing).

        Counts per STEP (averaged over a superstep for path='superstep'):
        ppermute pairs, payload bytes per collective and per step, and the
        redundant-compute fraction (extra row-updates beyond one update
        per interior row: the superstep's shrinking-window recompute,
        reach*(q-1)/rows; the slab paths re-compute nothing).
        The superstep's design tradeoff is exactly visible here:
        collectives/step fall as 1/q while redundant compute rises as
        (q-1)/rows — a wall-clock proxy whose collectives are nearly free
        (shared-memory CPU) sees only the cost side."""
        R, nx, k = self.rows, self.smesh.nx, n_vert_levels
        reach = _reach(nonlinear, fb)
        n_tr = n_tracers
        # plane-values exchanged per field group one way: ssh(2x1) + h(2K)
        # + u(6K) [+ tracers(2*nT*K)]
        state_vals = (2 * 1 + (8 + 2 * n_tr) * k) * nx
        if path == "superstep":
            q = max(1, int(q))
            hq = reach * q
            n_fields = 3 + (1 if n_tr else 0)
            pairs_per_step = n_fields / q
            bytes_per_collective = state_vals * hq * itemsize / n_fields
            bytes_per_step = 2 * state_vals * hq * itemsize / q
            # per superstep: sum_j (R + 2*reach*(q-1-j)) row updates vs
            # q*R useful
            redundant = reach * (q - 1) / R
            rounds_per_step = 1.0 / q
            detail = {"q": q, "halo_rows": hq}
        else:
            rounds = 3 if (nonlinear and fb) else (2 if nonlinear else 1)
            if fb and not nonlinear:
                hq = 2
            else:
                hq = 1
            n_fields = 3 + (1 if n_tr else 0)
            if nonlinear:
                # round 2 carries the 14 derived planes (flux 6K + ke 2K +
                # qe 6K) as ONE stacked ppermute pair; round 3 (fb) the
                # fresh ssh and h as two more pairs — so pairs/step is
                # n_fields + 1 (nl) or n_fields + 3 (nl+fb), matching the
                # body_nonlinear/_fb implementations exactly
                extra_vals = 14 * k * nx + (
                    (2 + 2 * k) * nx if fb else 0
                )
                pairs_per_step = float(n_fields + (3 if fb else 1))
            else:
                extra_vals = 0
                pairs_per_step = float(n_fields)
            total_vals = state_vals * hq + extra_vals
            bytes_per_collective = total_vals * itemsize / max(
                pairs_per_step, 1
            )
            bytes_per_step = 2 * total_vals * itemsize
            redundant = 0.0
            rounds_per_step = float(rounds)
            detail = {"halo_rows": hq}
        return {
            "path": path,
            "rows_per_device": R,
            "collective_pairs_per_step": float(pairs_per_step),
            "exchange_rounds_per_step": float(rounds_per_step),
            "bytes_per_collective_per_device": float(bytes_per_collective),
            "exchange_bytes_per_step_per_device": float(bytes_per_step),
            "redundant_compute_frac": float(redundant),
            **detail,
        }

    def overlap_stats(self, n_vert_levels: int, itemsize: int = 4) -> dict:
        """Static communication/overlap profile of one sharded step (the
        BASELINE 'halo-exchange overlap %' metric, reported structurally:
        the fraction of the step's row-updates that are scheduled while the
        ppermutes are in flight)."""
        r, nx = self.rows, self.smesh.nx
        k = n_vert_levels
        elems_one_way = (2 * 1 + 2 * k + 6 * k) * nx  # ssh + h + u planes
        active = self.overlap and r >= 3
        return {
            "rows_per_device": r,
            "interior_rows_overlapped": (r - 2) if active else 0,
            "overlappable_compute_frac": (r - 2) / r if active else 0.0,
            "halo_bytes_per_step_per_device": 2 * elems_one_way * itemsize,
        }

    def checksum(self, local):
        """Global sum of all interior state values (psum over the mesh
        axes) — a replicated scalar every process can read, usable where
        `gather` cannot run (multi-process meshes whose devices are not all
        addressable)."""
        axes = self.axes

        def fn(loc):
            s = sum(
                jnp.sum(jax.tree.map(lambda a: a[0], loc[k])[:, 1:-1])
                for k in ("ssh", "h", "u", "t")
                if k in loc
            )
            return jax.lax.psum(s, axes)

        specs = jax.tree.map(lambda _: P(self.axes), local)
        return shard_map(
            fn, mesh=self.device_mesh, in_specs=(specs,), out_specs=P()
        )(local)

    def scatter_forcing(self, struct_forcing):
        """Struct-layout Forcing (StructuredModel.to_struct_forcing) ->
        halo-padded slab layout: wind (P, 6, R+2, nx, 1), level masks
        (P, 6, R+2, nx, K), scalars stacked to (P,)."""
        if struct_forcing is None:
            return None
        ny2, nx = self.smesh.ny2, self.smesh.nx
        wind = np.asarray(struct_forcing.wind_edge).reshape(6, ny2, nx, 1)
        top = np.asarray(struct_forcing.top_mask).reshape(6, ny2, nx, -1)
        bot = np.asarray(struct_forcing.bottom_mask).reshape(6, ny2, nx, -1)
        return {
            "wind": self._put(self._slab(wind)),
            "top": self._put(self._slab(top)),
            "bot": self._put(self._slab(bot)),
            "dlin": self._put(
                np.full(self.n_parts, float(struct_forcing.drag_linear))
            ),
            "dquad": self._put(
                np.full(self.n_parts, float(struct_forcing.drag_quadratic))
            ),
            "rayl": self._put(
                np.full(self.n_parts, float(struct_forcing.rayleigh))
            ),
        }

    def _run_prep(self, local, nonlinear, forcing, strat):
        if nonlinear:
            self._nl_validate()
        lstrat = None
        if strat is not None:
            w = np.asarray(strat.phi_weights)
            lstrat = self._put(np.broadcast_to(w, (self.n_parts,) + w.shape))
        # a dict is an ALREADY-SCATTERED forcing slab set (scatter_forcing)
        # — passed through untouched so it can be a differentiated input
        forcel = (
            forcing if isinstance(forcing, dict)
            else self.scatter_forcing(forcing)
        )
        return (
            self._f_local, self._rts_local, self._mask_local,
            self._fv_local if nonlinear else None,
            forcel,
            self._cmask_local if "t" in local else None, lstrat,
        )

    def gather_forcing_grad(self, d_forcel, struct_forcing):
        """Slab-layout forcing cotangent (jax.grad of `objective` w.r.t. a
        pre-scattered `scatter_forcing` dict) -> struct-layout Forcing
        cotangent matching ``struct_forcing``'s leaves. Interior rows
        reassemble the wind and level-mask planes (halo rows carry zero
        cotangent because the objective rebuilds forcing halos from the
        interior); the per-device scalar cotangents sum. This is the
        multi-chip wind-stress/drag sensitivity — the production adjoint
        the single-device path provides via structured_rollout_diff."""
        ny2, nx = self.smesh.ny2, self.smesh.nx

        def unslab(x):
            x = np.asarray(x)[:, :, 1:-1]
            return np.concatenate(list(x), axis=1)

        wind = unslab(d_forcel["wind"])[..., 0]
        top = unslab(d_forcel["top"])
        bot = unslab(d_forcel["bot"])
        f = struct_forcing
        return f.replace(
            wind_edge=jnp.asarray(
                wind.reshape(f.wind_edge.shape), f.wind_edge.dtype
            ),
            top_mask=jnp.asarray(
                top.reshape(f.top_mask.shape), f.top_mask.dtype
            ),
            bottom_mask=jnp.asarray(
                bot.reshape(f.bottom_mask.shape), f.bottom_mask.dtype
            ),
            drag_linear=jnp.asarray(
                np.asarray(d_forcel["dlin"]).sum(), f.drag_linear.dtype
            ),
            drag_quadratic=jnp.asarray(
                np.asarray(d_forcel["dquad"]).sum(), f.drag_quadratic.dtype
            ),
            rayleigh=jnp.asarray(
                np.asarray(d_forcel["rayl"]).sum(), f.rayleigh.dtype
            ),
        )

    def run(self, local, dt, n_steps: int, nonlinear: bool = False,
            forcing=None, tracer_kappa: float = 0.0,
            tracer_upwind: float = 1.0, strat=None, fb: bool = False):
        """``fb=True`` selects the forward-backward stepper: the pressure
        stage reads the fresh thickness, so each step exchanges TWO halo
        rows per side (linear; still one ppermute pair per field) or adds
        a fresh-thickness exchange round (nonlinear)."""
        self._fb_validate(fb, nonlinear)
        args = self._run_prep(local, nonlinear, forcing, strat)
        return self._run_jit(
            local, *args, float(dt), n_steps, nonlinear, tracer_kappa,
            tracer_upwind, fb=fb,
        )

    def _fb_validate(self, fb: bool, nonlinear: bool):
        if fb and not nonlinear and self.rows < 2:
            raise ValueError(
                "forward-backward needs >= 2 rows per device for the "
                f"2-row halo exchange; got rows/device={self.rows}"
            )

    def objective(self, local, dt, n_steps: int, nonlinear: bool = False,
                  forcing=None, tracer_kappa: float = 0.0,
                  tracer_upwind: float = 1.0, strat=None, fb: bool = False):
        """Replicated scalar objective sum(ssh_final^2) of an n-step
        sharded rollout — DIFFERENTIABLE through the whole loop:
        ``jax.grad(lambda l: model.objective(l, dt, n))(local)`` yields the
        same gradient as the global rollout's (tests pin f64-roundoff
        agreement; the reference needs Enzyme plus hand-written rules for
        this reverse, reference: test/enzyme/test_Enzyme_end2end.jl:78-92 —
        here ppermute transposes to ppermute and the slab step is pure
        jnp). The reverse sweep uses two-level (sqrt) checkpointing, so
        memory is O(sqrt(n) * slab) per device. Input halo rows are
        rebuilt from the interior before the loop, so the cotangent lands
        entirely on interior rows and ``gather`` of the gradient dict
        reassembles the global gradient."""
        self._fb_validate(fb, nonlinear)
        args = self._run_prep(local, nonlinear, forcing, strat)
        return self._run_jit(
            local, *args, float(dt), n_steps, nonlinear, tracer_kappa,
            tracer_upwind, True, fb=fb,
        )

    @partial(
        jax.jit, static_argnames=("self", "dt", "n_steps", "nonlinear",
                                  "tracer_kappa", "tracer_upwind",
                                  "objective", "fb", "q")
    )
    def _run_jit(self, local, f_local, rts_local, mask_local, fv_local,
                 forcel, cmask_local, strat_local, dt, n_steps,
                 nonlinear=False, tracer_kappa=0.0, tracer_upwind=1.0,
                 objective=False, fb=False, q=None):
        """``q=None`` steps one timestep per halo exchange (``run``); an
        integer q runs the communication-avoiding superstep (one exchange
        of reach*q rows, then q steps; ``run_superstep``)."""
        axis, n_parts, rows = self.axes, self.n_parts, self.rows
        overlap = self.overlap
        terms = self.smesh.coriolis_terms
        dtype = local["h"].dtype
        inv_dc = (1.0 / self.smesh.dc).astype(dtype)
        s_div = (self.smesh.dv / self.smesh.area_cell).astype(dtype)
        dt = jnp.asarray(dt, dtype)
        masked = mask_local is not None

        sm = self.smesh
        ke_scale = (0.25 * sm.dc * sm.dv / sm.area_cell).astype(dtype)
        curl_scale = (sm.dc / (0.5 * sm.area_cell)).astype(dtype)
        vc_terms = sm.vertex_cell_terms
        ev_terms = sm.edge_vertex_terms

        with_tracers = "t" in local
        tropts = (tracer_kappa, tracer_upwind)

        def device_fn(local, f_loc, rts_loc, mask_loc, fv_loc, forcel,
                      cmask_loc, strat_loc):
            sq = lambda t: jax.tree.map(lambda a: a[0], t)
            local, f_loc, rts_loc = sq(local), sq(f_loc), sq(rts_loc)
            strat_w = sq(strat_loc).astype(dtype) if strat_loc is not None else None
            cmask = None
            if cmask_loc is not None:
                cm = sq(cmask_loc)
                cmask = tuple(cm[p] for p in range(2))
            f_edge = tuple(f_loc[c] for c in range(6))
            rts = tuple(rts_loc[p] for p in range(2))
            if forcel is not None:
                fl = sq(forcel)
                if objective:
                    # rebuild the forcing slabs' halo rows from their
                    # interior (like the state below), so a gradient taken
                    # w.r.t. the forcing slab dict lands entirely on
                    # interior rows and gather_forcing_grad reassembles
                    # the exact global Forcing cotangent
                    fl = {
                        k: (
                            _with_halo(v[:, 1:-1], axis, n_parts)
                            if v.ndim >= 3 else v
                        )
                        for k, v in fl.items()
                    }
                forc = (
                    tuple(fl["wind"][c].astype(dtype) for c in range(6)),
                    tuple(fl["top"][c].astype(dtype) for c in range(6)),
                    tuple(fl["bot"][c].astype(dtype) for c in range(6)),
                    fl["dlin"].astype(dtype), fl["dquad"].astype(dtype),
                    fl["rayl"].astype(dtype),
                )
            else:
                forc = None
            if masked:
                mask_loc = sq(mask_loc)
                masks = tuple(mask_loc[c] for c in range(6))
            else:
                masks = None
            if nonlinear:
                fv_loc = sq(fv_loc)
                n_fv = fv_loc.shape[0]
                f_v = tuple(fv_loc[c].astype(dtype) for c in range(n_fv))
                if n_fv > 4:
                    mesh_sc = (inv_dc, ke_scale, curl_scale, f_v[:4],
                               vc_terms, ev_terms, f_v[4:8], f_v[8:])
                else:
                    mesh_sc = (inv_dc, ke_scale, curl_scale, f_v,
                               vc_terms, ev_terms)

            def body_serial(carry, _):
                ssh = tuple(carry["ssh"][p] for p in range(2))
                h = tuple(carry["h"][p] for p in range(2))
                u = tuple(carry["u"][c] for c in range(6))
                tr = (
                    tuple(carry["t"][i] for i in range(carry["t"].shape[0]))
                    if with_tracers else None
                )
                ssh_i, h_i, u_i, t_i = _step_slab(
                    ssh, h, u, f_edge, rts, dt, inv_dc, s_div, terms, rows,
                    masks, forc, tr, tropts, cmask, strat_w,
                )
                new = {
                    "ssh": _with_halo(jnp.stack(ssh_i), axis, n_parts),
                    "h": _with_halo(jnp.stack(h_i), axis, n_parts),
                    "u": _with_halo(jnp.stack(u_i), axis, n_parts),
                }
                if with_tracers:
                    new["t"] = _with_halo(jnp.stack(t_i), axis, n_parts)
                return new, None

            def body_overlap(carry, _):
                """Boundary strips first -> issue ppermutes -> interior
                while the collectives fly. Row values identical to
                body_serial (1-ring locality)."""
                ssh = tuple(carry["ssh"][p] for p in range(2))
                h = tuple(carry["h"][p] for p in range(2))
                u = tuple(carry["u"][c] for c in range(6))
                tr = (
                    tuple(carry["t"][i] for i in range(carry["t"].shape[0]))
                    if with_tracers else None
                )

                def run_rows(lo, n):
                    """Step padded rows [lo, lo+n+2) -> n new interior rows."""
                    sub = lambda t: tuple(x[lo : lo + n + 2] for x in t)
                    msub = sub(masks) if masks is not None else None
                    if forc is not None:
                        fsub = (sub(forc[0]), sub(forc[1]), sub(forc[2]),
                                forc[3], forc[4], forc[5])
                    else:
                        fsub = None
                    return _step_slab(
                        sub(ssh), sub(h), sub(u), sub(f_edge), sub(rts),
                        dt, inv_dc, s_div, terms, n, msub, fsub,
                        sub(tr) if tr is not None else None, tropts,
                        sub(cmask) if cmask is not None else None, strat_w,
                    )

                top = run_rows(0, 1)           # new local row 0
                bot = run_rows(rows - 1, 1)    # new local row R-1
                down = [(i, (i + 1) % n_parts) for i in range(n_parts)]
                up = [(i, (i - 1) % n_parts) for i in range(n_parts)]
                n_fields = 4 if with_tracers else 3
                # my new row R-1 -> next device's padded row 0; my new row 0
                # -> previous device's padded row R+1 (same wiring as
                # _with_halo, issued before the interior is computed)
                recv_top = [
                    jax.lax.ppermute(jnp.stack(bot[i]), axis, down)
                    for i in range(n_fields)
                ]
                recv_bot = [
                    jax.lax.ppermute(jnp.stack(top[i]), axis, up)
                    for i in range(n_fields)
                ]
                mid = run_rows(1, rows - 2)    # new local rows 1..R-2

                def asm(i):
                    return jnp.concatenate(
                        [recv_top[i], jnp.stack(top[i]), jnp.stack(mid[i]),
                         jnp.stack(bot[i]), recv_bot[i]],
                        axis=1,
                    )

                new = {"ssh": asm(0), "h": asm(1), "u": asm(2)}
                if with_tracers:
                    new["t"] = asm(3)
                return new, None

            def body_nonlinear(carry, _):
                """Two exchange rounds per step: the carried state halos
                (round 1, done at the end of the previous step) feed stage
                A's derived fields, whose OWN halos round 2 provides —
                the slab counterpart of parallel/shard_step.py's
                derived-field exchange. Serial schedule (the stage-B
                stencil depends on the freshly exchanged derived rows)."""
                ssh = tuple(carry["ssh"][p] for p in range(2))
                h = tuple(carry["h"][p] for p in range(2))
                u = tuple(carry["u"][c] for c in range(6))
                tr = (
                    tuple(carry["t"][i] for i in range(carry["t"].shape[0]))
                    if with_tracers else None
                )
                flux, ke, q_e = _derived_slab(h, u, mesh_sc, rows)
                packed = jnp.stack(flux + ke + q_e)  # (14, rows, nx, K)
                padded = _with_halo(packed, axis, n_parts)
                ssh_i, h_i, u_i, t_i = _apply_slab_nonlinear(
                    ssh, h, u,
                    tuple(padded[c] for c in range(6)),
                    (padded[6], padded[7]),
                    tuple(padded[8 + c] for c in range(6)),
                    rts, dt, inv_dc, s_div, terms, rows, forc,
                    tr, tropts, strat_w, masks, cmask,
                )
                new = {
                    "ssh": _with_halo(jnp.stack(ssh_i), axis, n_parts),
                    "h": _with_halo(jnp.stack(h_i), axis, n_parts),
                    "u": _with_halo(jnp.stack(u_i), axis, n_parts),
                }
                if with_tracers:
                    new["t"] = _with_halo(jnp.stack(t_i), axis, n_parts)
                return new, None

            if fb and not nonlinear:
                # 2-padded constants for the fb slab step, rebuilt once
                # from the 1-halo inputs (payload: 2 rows per ppermute)
                def pad2(stacked):
                    # ONE exchange per stacked constant (an earlier version
                    # re-evaluated this inside each tuple comprehension,
                    # tracing a fresh ppermute pair per unpacked plane)
                    ext2 = _with_halo(stacked[:, 1:-1], axis, n_parts, 2)
                    return tuple(ext2[c] for c in range(ext2.shape[0]))

                f_edge2 = pad2(jnp.stack(f_edge))
                rts2 = pad2(jnp.stack(rts))
                masks2 = None if masks is None else pad2(jnp.stack(masks))
                cmask2 = None if cmask is None else pad2(jnp.stack(cmask))
                forc2 = None
                if forc is not None:
                    forc2 = (
                        pad2(jnp.stack(forc[0])),
                        pad2(jnp.stack(forc[1])),
                        pad2(jnp.stack(forc[2])),
                        forc[3], forc[4], forc[5],
                    )

            def body_fb(carry, _):
                """Forward-backward (reach-2 stencil): the carry is a
                2-PADDED slab (unlike the other bodies' 1-padded), so each
                step is one fb slab step on the carried window followed by
                ONE ppermute pair per field whose payload carries 2 rows —
                an earlier version discarded the end-of-step halos and
                re-exchanged at the start of the next step, doubling the
                fb stepper's collective count (_step_slab's fb branch:
                fresh-thickness pressure)."""
                ssh = tuple(carry["ssh"][p] for p in range(2))
                h = tuple(carry["h"][p] for p in range(2))
                u = tuple(carry["u"][c] for c in range(6))
                tr = (
                    tuple(carry["t"][i] for i in range(carry["t"].shape[0]))
                    if with_tracers else None
                )
                ssh_i, h_i, u_i, t_i = _step_slab(
                    ssh, h, u, f_edge2, rts2, dt, inv_dc, s_div, terms,
                    rows, masks2, forc2, tr, tropts, cmask2, strat_w, True,
                )
                new = {
                    "ssh": _with_halo(jnp.stack(ssh_i), axis, n_parts, 2),
                    "h": _with_halo(jnp.stack(h_i), axis, n_parts, 2),
                    "u": _with_halo(jnp.stack(u_i), axis, n_parts, 2),
                }
                if with_tracers:
                    new["t"] = _with_halo(jnp.stack(t_i), axis, n_parts, 2)
                return new, None

            def body_nonlinear_fb(carry, _):
                """Nonlinear + forward-backward: THREE exchange rounds per
                step — carried state halos feed the derived fields (round
                1), the derived fields' own halos arrive by round 2 (as
                body_nonlinear), and the FRESH thickness/ssh computed from
                the exchanged flux get their halos in round 3 for the fb
                pressure stage (model.structured_fb_step nonlinear
                semantics)."""
                ssh = tuple(carry["ssh"][p] for p in range(2))
                h = tuple(carry["h"][p] for p in range(2))
                u = tuple(carry["u"][c] for c in range(6))
                tr = (
                    tuple(carry["t"][i] for i in range(carry["t"].shape[0]))
                    if with_tracers else None
                )
                flux, ke, q_e = _derived_slab(h, u, mesh_sc, rows)
                packed = jnp.stack(flux + ke + q_e)
                padded = _with_halo(packed, axis, n_parts)
                fluxp = tuple(padded[c] for c in range(6))
                kep = (padded[6], padded[7])
                qep = tuple(padded[8 + c] for c in range(6))
                hn, sshn = _nl_continuity(h, fluxp, rts, dt, s_div, rows)
                sshn_p = _with_halo(jnp.stack(sshn), axis, n_parts)
                hn_p = _with_halo(jnp.stack(hn), axis, n_parts)
                ssh_i, h_i, u_i, t_i = _apply_slab_nonlinear(
                    ssh, h, u, fluxp, kep, qep, rts, dt, inv_dc, s_div,
                    terms, rows, forc, tr, tropts, strat_w, masks, cmask,
                    pg_fresh=(
                        tuple(sshn_p[p] for p in range(2)),
                        tuple(hn_p[p] for p in range(2)),
                    ),
                )
                new = {
                    "ssh": _with_halo(jnp.stack(ssh_i), axis, n_parts),
                    "h": _with_halo(jnp.stack(h_i), axis, n_parts),
                    "u": _with_halo(jnp.stack(u_i), axis, n_parts),
                }
                if with_tracers:
                    new["t"] = _with_halo(jnp.stack(t_i), axis, n_parts)
                return new, None

            if q:
                hq = _reach(nonlinear, fb) * q

                def widen(t):
                    """1-padded constant planes -> hq-padded (exchanged
                    once per call, not per step)."""
                    if t is None:
                        return None
                    ext = _with_halo(jnp.stack(t)[:, 1:-1], axis, n_parts,
                                     hq)
                    return tuple(ext[c] for c in range(ext.shape[0]))

                f_q, rts_q = widen(f_edge), widen(rts)
                masks_q, cmask_q = widen(masks), widen(cmask)
                forc_q = None if forc is None else (
                    widen(forc[0]), widen(forc[1]), widen(forc[2]),
                    *forc[3:])
                nl_q = ((widen(f_v), ke_scale, curl_scale, vc_terms,
                         ev_terms) if nonlinear else None)

                def body_superstep(carry, _):
                    """ONE ppermute pair per field carries hq rows, then
                    q steps on the extended slab; carry = interior rows."""
                    ext = {kk: _with_halo(v, axis, n_parts, hq)
                           for kk, v in carry.items()}
                    tr = (
                        tuple(ext["t"][i] for i in range(ext["t"].shape[0]))
                        if with_tracers else None
                    )
                    ssh_i, h_i, u_i, t_i = _window_steps(
                        tuple(ext["ssh"][p] for p in range(2)),
                        tuple(ext["h"][p] for p in range(2)),
                        tuple(ext["u"][c] for c in range(6)),
                        tr, f_q, rts_q, dt, inv_dc, s_div, terms,
                        rows=rows, q=q, reach=_reach(nonlinear, fb),
                        masks=masks_q, forc=forc_q, cmask=cmask_q,
                        strat_w=strat_w, tropts=tropts, nl=nl_q, fb=fb,
                    )
                    new = {"ssh": jnp.stack(ssh_i), "h": jnp.stack(h_i),
                           "u": jnp.stack(u_i)}
                    if with_tracers:
                        new["t"] = jnp.stack(t_i)
                    return new, None

                body = body_superstep
            elif fb:
                body = body_nonlinear_fb if nonlinear else body_fb
            elif nonlinear:
                body = body_nonlinear
            else:
                body = body_overlap if (overlap and rows >= 3) else body_serial
            # body_fb carries a 2-padded slab: widen on entry, narrow on
            # exit (a 2-padded slab's rows [1:-1] ARE the 1-padded slab);
            # the superstep carries interior rows only
            if q:
                pad = 0
            else:
                pad = 2 if (fb and not nonlinear) else 1
            n_iter = n_steps // q if q else n_steps

            def enter(loc):
                if pad == 0:
                    return {kk: v[:, 1:-1] for kk, v in loc.items()}
                return {kk: _with_halo(v[:, 1:-1], axis, n_parts, pad)
                        for kk, v in loc.items()}

            if objective:
                # differentiable whole-loop objective: rebuild the input
                # halos from the interior (so the cotangent lands entirely
                # on interior rows and `gather` of the gradient dict is the
                # global gradient), run the scan under two-level sqrt
                # checkpointing, and psum the final sum(ssh^2)
                import math

                local = enter(local)
                step = jax.checkpoint(body)
                b = max(1, math.isqrt(n_iter))
                a, rem = divmod(n_iter, b)

                def chunk(c, _):
                    c2, _ = jax.lax.scan(step, c, length=b)
                    return c2, None

                out = local
                if a:
                    out, _ = jax.lax.scan(jax.checkpoint(chunk), out,
                                          length=a)
                if rem:
                    out, _ = jax.lax.scan(step, out, length=rem)
                n_rows = out["ssh"].shape[1]
                s = jnp.sum(out["ssh"][:, pad:n_rows - pad] ** 2)
                return jax.lax.psum(s, axis)
            if pad != 1:
                local = enter(local)
            out, _ = jax.lax.scan(body, local, length=n_iter)
            if pad == 2:
                out = {kk: v[:, 1:-1] for kk, v in out.items()}
            elif pad == 0:
                # re-attach the 1-row halo `run`/`gather`/`checksum` expect
                out = {kk: _with_halo(v, axis, n_parts)
                       for kk, v in out.items()}
            return jax.tree.map(lambda a: a[None], out)

        specs = jax.tree.map(lambda _: P(self.axes), local)
        fspec = jax.tree.map(lambda _: P(self.axes), f_local)
        rspec = jax.tree.map(lambda _: P(self.axes), rts_local)
        mspec = jax.tree.map(lambda _: P(self.axes), mask_local)
        vspec = jax.tree.map(lambda _: P(self.axes), fv_local)
        wspec = jax.tree.map(lambda _: P(self.axes), forcel)
        cspec = jax.tree.map(lambda _: P(self.axes), cmask_local)
        sspec = jax.tree.map(lambda _: P(self.axes), strat_local)
        return shard_map(
            device_fn,
            mesh=self.device_mesh,
            in_specs=(specs, fspec, rspec, mspec, vspec, wspec, cspec, sspec),
            out_specs=P() if objective else specs,
        )(local, f_local, rts_local, mask_local, fv_local, forcel,
          cmask_local, strat_local)

    def _fv_planes(self):
        """Per-vertex constant planes (4, ny2, nx, 1), or the stacked
        [f_vertex; vertex_mask; kite weights] (20, ny2, nx, 1) on
        wall-masked lattices."""
        sm = self.smesh
        ny2, nx = sm.ny2, sm.nx
        fv = np.asarray(sm.f_vertex).reshape(4, ny2, nx, 1)
        if sm.edge_mask is not None and sm.vertex_kite_planes is not None:
            fv = np.concatenate([
                fv,
                np.asarray(sm.vertex_mask).reshape(4, ny2, nx, 1),
                np.asarray(sm.vertex_kite_planes)[:, :, :, None],
            ])
        return fv

    def _nl_validate(self):
        from .model import _check_nl_mesh

        sm = self.smesh
        _check_nl_mesh(sm)
        if sm.f_vertex is None:
            raise ValueError(
                "StructMesh lacks vertex stencils; build it via "
                "StructuredModel so hex_layout extracts them"
            )
        # the derived-field exchange/local-recompute is exact on its halo
        # only because the vertex-stage taps stay within these row offsets
        # (machine-extracted, so verify rather than trust)
        assert all(t[3] in (0, 1) for t in sm.vertex_cell_terms), (
            "vertex-cell stencil reaches outside rows {0, +1}"
        )
        assert all(t[4] in (-1, 0) for t in sm.edge_vertex_terms), (
            "edge-vertex stencil reaches outside rows {-1, 0}"
        )

    def _superstep_q(self, n_steps: int, q, nonlinear: bool, fb: bool):
        """The superstep size actually run: at most the requested ``q``
        (default min(8, rows/reach)), no more than one neighbor slab of
        halo rows (reach*q <= rows), and a divisor of n_steps. Warns when
        an explicitly requested q had to shrink."""
        import warnings

        reach = _reach(nonlinear, fb)
        R = self.rows
        if reach > R:
            raise ValueError(
                f"reach-{reach} dynamics (nonlinear/fb) need at least "
                f"{reach} rows per device for the one-neighbor halo "
                f"exchange; got rows/device={R} — use run() or fewer "
                "devices"
            )
        q_req = q
        q = min(8, R // reach) if q is None else int(q)
        q = max(1, min(q, R // reach, n_steps))
        while n_steps % q:
            q -= 1
        if q_req is not None and q != int(q_req):
            warnings.warn(
                f"run_superstep reduced the requested superstep q={q_req} "
                f"to q={q} (divisibility of n_steps={n_steps} or halo limit "
                f"reach*q<={R})", stacklevel=3,
            )
        return q

    def run_superstep(self, local, dt, n_steps: int, *, q: int | None = None,
                      forcing=None, tracer_kappa: float = 0.0,
                      tracer_upwind: float = 1.0, strat=None,
                      nonlinear: bool = False, fb: bool = False):
        """Communication-avoiding sharded rollout.

        ``run`` does one step and one halo exchange per timestep; this path
        instead exchanges reach*q halo rows per side with ONE ppermute pair
        per field and then advances q timesteps on the halo-extended slab
        (_window_steps), whose valid window shrinks by ``reach`` rows per
        side per step. Collectives drop to 1/q per step for
        reach*(q-1)/rows of redundant row updates. Math identical to
        ``run``/structured_run_loop (tests pin f64-roundoff agreement).

        ``nonlinear=True`` runs the vector-invariant momentum equation
        (reach 2: the derived fields are recomputed locally,
        _step_slab_nl); ``fb=True`` the forward-backward scheme (reach 2;
        nonlinear+fb at reach 3). Accepts and returns the same 1-halo-row
        slab dict as ``run``/``scatter``/``gather``.
        """
        self._fb_validate(fb, nonlinear)
        q = self._superstep_q(n_steps, q, nonlinear, fb)
        args = self._run_prep(local, nonlinear, forcing, strat)
        return self._run_jit(
            local, *args, float(dt), n_steps, nonlinear, tracer_kappa,
            tracer_upwind, fb=fb, q=q,
        )

    def objective_superstep(self, local, dt, n_steps: int, *,
                            q: int | None = None, forcing=None,
                            tracer_kappa: float = 0.0,
                            tracer_upwind: float = 1.0, strat=None,
                            nonlinear: bool = False, fb: bool = False):
        """Replicated scalar sum(ssh_final^2) of an n-step superstep
        rollout (``run_superstep``), differentiable through the whole loop
        under two-level sqrt checkpointing over supersteps. ``jax.grad``
        w.r.t. ``local`` matches the global rollout's gradient at f64
        roundoff (test-pinned). The input dict's halo rows are unused (the
        superstep rebuilds halos by exchange), so the gradient lands on
        interior rows and ``gather`` reassembles it."""
        self._fb_validate(fb, nonlinear)
        q = self._superstep_q(n_steps, q, nonlinear, fb)
        args = self._run_prep(local, nonlinear, forcing, strat)
        return self._run_jit(
            local, *args, float(dt), n_steps, nonlinear, tracer_kappa,
            tracer_upwind, True, fb=fb, q=q,
        )
