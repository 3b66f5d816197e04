"""Convolutional formulation of the structured hex step.

Every TRiSK stencil is a *small convolution* over the parity-plane
channels: cells->edges (interpolation + ssh gradient) is one conv, the
60-term Coriolis reconstruction is one conv, edges->cells (flux divergence)
is one conv — three single-pass ops per step, an alternative to the
roll/shift formulation (model.py) whose shifted planes XLA may
materialize.

Channel layout: edge channels = family*2 + parity (6), cell channels =
parity (2). Spatial dims (ny2, nx) wrap-padded for periodicity; the level
axis rides along as the conv batch dimension.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import GRAVITY
from .hex_layout import E, NE, NW
from .model import StructMesh, StructState

__all__ = ["build_conv_step", "conv_run_loop"]

# neighbor-cell offsets (plane_in, dm, di) per (family, parity_out),
# mirroring model._neighbor_cell_field
_NEIGHBOR = {
    (E, 0): (0, 0, 1),
    (E, 1): (1, 0, 1),
    (NE, 0): (1, 0, 0),
    (NE, 1): (0, 1, 1),
    (NW, 0): (1, 0, -1),
    (NW, 1): (0, 1, 0),
}

# incoming-edge taps for the divergence at cell plane p:
# (edge_channel_in, dm, di) entries with sign -1; outgoing are (f, p, 0, 0)
_INCOMING = {
    0: [(E * 2 + 0, 0, -1), (NE * 2 + 1, -1, -1), (NW * 2 + 1, -1, 0)],
    1: [(E * 2 + 1, 0, -1), (NE * 2 + 0, 0, 0), (NW * 2 + 0, 0, 1)],
}


def _kernel_shape(taps):
    dms = [t[-2] for t in taps]
    dis = [t[-1] for t in taps]
    return max(map(abs, dms)), max(map(abs, dis))


def build_conv_step(mesh: StructMesh, dtype=np.float32):
    """Build (kernels, step_fn). Kernels are OIHW numpy arrays derived from
    the mesh's machine-extracted stencils."""
    # --- cells -> edges: 12 outputs = 6 interp (0.5, 0.5) + 6 grad (+-1/dc)
    taps_c2e = []
    for fam in (E, NE, NW):
        for p in (0, 1):
            pin, dm, di = _NEIGHBOR[(fam, p)]
            taps_c2e.append(((fam * 2 + p), p, 0, 0, pin, dm, di))
    rm = max(abs(t[5]) for t in taps_c2e)
    cm = max(abs(t[6]) for t in taps_c2e)
    k_c2e = np.zeros((12, 2, 2 * rm + 1, 2 * cm + 1), dtype=np.float64)
    dc = float(mesh.dc)
    for out_ch, p_self, _, _, pin, dm, di in taps_c2e:
        # interpolation: 0.5 self + 0.5 neighbor
        k_c2e[out_ch, p_self, rm, cm] += 0.5
        k_c2e[out_ch, pin, rm + dm, cm + di] += 0.5
        # gradient: (neighbor - self) / dc
        k_c2e[6 + out_ch, p_self, rm, cm] += -1.0 / dc
        k_c2e[6 + out_ch, pin, rm + dm, cm + di] += 1.0 / dc

    # --- Coriolis: 6 -> 6 from the extracted terms
    terms = mesh.coriolis_terms
    rmc = max(abs(t[4]) for t in terms)
    cmc = max(abs(t[5]) for t in terms)
    k_cor = np.zeros((6, 6, 2 * rmc + 1, 2 * cmc + 1), dtype=np.float64)
    for (f_out, p_out, f_in, p_in, dm, di, w) in terms:
        k_cor[f_out * 2 + p_out, f_in * 2 + p_in, rmc + dm, cmc + di] += w

    # --- edges -> cells: divergence (* dv/area)
    scale = float(mesh.dv) / float(mesh.area_cell)
    k_div = np.zeros((2, 6, 3, 3), dtype=np.float64)
    for p in (0, 1):
        for fam in (E, NE, NW):
            k_div[p, fam * 2 + p, 1, 1] += scale  # outgoing at self
        for ch, dm, di in _INCOMING[p]:
            k_div[p, ch, 1 + dm, 1 + di] += -scale

    kernels = {
        "c2e": jnp.asarray(k_c2e.astype(dtype)),
        "cor": jnp.asarray(k_cor.astype(dtype)),
        "div": jnp.asarray(k_div.astype(dtype)),
    }
    return kernels


_DN = ("CHWN", "OIHW", "CHWN")


def _wrap_pad(x, rm, cm):
    """Periodic padding of (C, H, W, N) on H (rm) and W (cm)."""
    if rm:
        x = jnp.concatenate([x[:, -rm:], x, x[:, :rm]], axis=1)
    if cm:
        x = jnp.concatenate([x[:, :, -cm:], x, x[:, :, :cm]], axis=2)
    return x


def _conv(x, kernel):
    # pad radii from the (static) kernel shape
    rm = (kernel.shape[2] - 1) // 2
    cm = (kernel.shape[3] - 1) // 2
    return jax.lax.conv_general_dilated(
        _wrap_pad(x, rm, cm),
        kernel,
        window_strides=(1, 1),
        padding="VALID",
        dimension_numbers=_DN,
        preferred_element_type=x.dtype,
        precision=jax.lax.Precision.HIGHEST,
    )


def conv_step(state: StructState, mesh: StructMesh, kernels, dt) -> StructState:
    """One forward-Euler step: 3 convolutions + elementwise ops.

    Matches model.structured_step to roundoff (same coefficients, conv is
    cross-correlation so tap offsets line up with the roll formulation)."""
    ny2, nx = state.ssh.shape[1], state.ssh.shape[2]
    K = state.layer_thickness.shape[-1]

    # cells: channels = parity planes; append ssh as an extra "level" so a
    # single conv yields both h_edge (levels :K) and grad_ssh (level K)
    h_aug = jnp.concatenate(
        [state.layer_thickness, state.ssh[..., None]], axis=-1
    )  # (2, ny2, nx, K+1)
    c2e = _conv(h_aug, kernels["c2e"])  # (12, ny2, nx, K+1)
    h_edge = c2e[:6, ..., :K].reshape(3, 2, ny2, nx, K)
    grad_ssh = c2e[6:, ..., K].reshape(3, 2, ny2, nx)

    u = state.normal_velocity  # (3, 2, ny2, nx, K)
    flux = (u * h_edge).reshape(6, ny2, nx, K)
    div_flux = _conv(flux, kernels["div"])  # (2, ny2, nx, K)

    uf = (u * mesh.f_edge[..., None]).reshape(6, ny2, nx, K)
    cor = _conv(uf, kernels["cor"]).reshape(3, 2, ny2, nx, K)

    tend_u = -GRAVITY * grad_ssh[..., None] + cor
    h = state.layer_thickness - dt * div_flux
    u = state.normal_velocity + dt * tend_u
    if mesh.edge_mask is not None:
        u = u * mesh.edge_mask[..., None]
    ssh = h.sum(-1) - mesh.resting_thickness_sum
    return StructState(ssh=ssh, layer_thickness=h, normal_velocity=u)


@partial(jax.jit, static_argnames=("n_steps",))
def conv_run_loop(state: StructState, mesh: StructMesh, kernels, dt, n_steps: int):
    def body(s, _):
        return conv_step(s, mesh, kernels, dt), None

    out, _ = jax.lax.scan(body, state, length=n_steps)
    return out
