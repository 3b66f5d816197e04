"""The linear forward-Euler lattice step as one Pallas kernel (Triton route).

``structured_step`` is a chain of rolls and elementwise ops that XLA turns
into several fusions per step, each a pass over part of the state. This
kernel does the whole step in one launch: the grid runs over (lattice row,
column tile); each program reads its row's cells and edges and the
neighbour rows/columns it needs straight from global memory (periodic
indices), forms the thickness flux, divergence, ssh, pressure gradient and
the 60-term Coriolis reconstruction in registers, and writes h, u and ssh of
its tile once. The level axis is padded to a power of two (the padding
stays zero) and the whole column sits in one program, so ssh's level sum
needs no second pass.

Scope: the reference's linear core (gravity + Coriolis), periodic or
wall-masked lattices, any float dtype. The stencil tables are the same ones
``structured_step`` uses (conv_model._NEIGHBOR / _INCOMING and the mesh's
coriolis_terms), so the two cannot drift apart; tests compare them in
interpret mode.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..constants import GRAVITY
from .conv_model import _INCOMING, _NEIGHBOR
from .hex_layout import E, NE, NW
from .model import StructMesh, StructState, structured_run_loop

__all__ = ["triton_run_loop"]

# Column tile and warps per program, from a sweep on an H100 at 64x64 and
# 256x256 x 100 levels f32 and 64x64 and 512x512 x 100 levels f64: fastest
# or within 5% of the fastest in each (PERF.md). Small tiles give the 132
# SMs enough programs at 64x64.
BN = 4
NUM_WARPS = 2


def _step_kernel(scal_ref, ssh_ref, h_ref, u_ref, f_ref, rts_ref, mask_ref,
                 _ssh_d, _h_d, _u_d, ssh_o, h_o, u_o, *, ny2, nx, k, bn,
                 terms):
    m = pl.program_id(0)
    col0 = pl.program_id(1) * bn
    lane = jax.lax.broadcasted_iota(jnp.int32, (bn,), 0)
    dtype = h_ref.dtype
    dt, inv_dc, s_div = scal_ref[0], scal_ref[1], scal_ref[2]
    kp = h_ref.shape[-1]
    live_k = jax.lax.broadcasted_iota(jnp.int32, (bn, kp), 1) < k

    def idx(dm, di):
        # raw lax.rem on int32: jnp's % would promote under the x64 flag
        i32 = partial(jnp.asarray, dtype=jnp.int32)
        row = jax.lax.rem(m + i32(dm + ny2), i32(ny2))
        cols = jax.lax.rem(col0 + lane + i32(di + nx), i32(nx))
        return row, cols

    def plane3(ref, plane, dm=0, di=0):  # (bn, kp) tile at offset (dm, di)
        row, cols = idx(dm, di)
        return ref[plane, row, cols, :]

    def plane2(ref, plane, dm=0, di=0):  # (bn,) row segment
        row, cols = idx(dm, di)
        return ref[plane, row, cols]

    def flux(c, dm, di):
        """Thickness flux of edge channel c at offset (dm, di)."""
        fam, p = divmod(c, 2)
        pin, dm2, di2 = _NEIGHBOR[(fam, p)]
        he = 0.5 * (plane3(h_ref, p, dm, di)
                    + plane3(h_ref, pin, dm + dm2, di + di2))
        return plane3(u_ref, c, dm, di) * he

    row, cols = idx(0, 0)
    for p in (0, 1):
        total = flux(E * 2 + p, 0, 0) + flux(NE * 2 + p, 0, 0) + flux(
            NW * 2 + p, 0, 0)
        for ch, dm, di in _INCOMING[p]:
            total = total - flux(ch, dm, di)
        h_new = plane3(h_ref, p) - (dt * s_div) * total
        h_o[p, row, cols, :] = h_new
        ssh_o[p, row, cols] = jnp.sum(h_new, axis=1) - plane2(rts_ref, p)

    g_dt = jnp.asarray(GRAVITY, dtype) * dt
    for fam in (E, NE, NW):
        for p in (0, 1):
            c = fam * 2 + p
            pin, dm, di = _NEIGHBOR[(fam, p)]
            grad = (plane2(ssh_ref, pin, dm, di) - plane2(ssh_ref, p)) * inv_dc
            acc = None
            for f_out, p_out, f_in, p_in, dm_t, di_t, w in terms:
                if f_out * 2 + p_out != c:
                    continue
                ci = f_in * 2 + p_in
                t = (jnp.asarray(w, dtype) * plane2(f_ref, ci, dm_t, di_t)[:, None]
                     * plane3(u_ref, ci, dm_t, di_t))
                acc = t if acc is None else acc + t
            u_new = plane3(u_ref, c) + dt * acc - g_dt * grad[:, None]
            u_new = u_new * plane2(mask_ref, c)[:, None]
            u_o[c, row, cols, :] = jnp.where(live_k, u_new, 0.0)


def _step(scal, state, f_edge, rts, mask, dst, *, terms, k, interpret):
    """One step from ``state`` = (ssh, h, u), written into the buffers of
    ``dst`` (same shapes; their values are not read). A program reads
    neighbour rows of ``state``, so the step cannot run in place."""
    ssh, h, u = state
    _, ny2, nx, kp = h.shape
    bn = math.gcd(BN, nx)  # the column tile divides the row
    kernel = partial(_step_kernel, ny2=ny2, nx=nx, k=k, bn=bn, terms=terms)
    return pl.pallas_call(
        kernel,
        grid=(ny2, nx // bn),
        out_shape=(
            jax.ShapeDtypeStruct(ssh.shape, ssh.dtype),
            jax.ShapeDtypeStruct(h.shape, h.dtype),
            jax.ShapeDtypeStruct(u.shape, u.dtype),
        ),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        input_output_aliases={7: 0, 8: 1, 9: 2},
        interpret=interpret,
        name="triton_lattice_step",
    )(scal, ssh, h, u, f_edge, rts, mask, *dst)


@partial(jax.custom_jvp, nondiff_argnums=(3, 4))
def triton_run_loop(state: StructState, mesh: StructMesh, dt, n_steps: int,
                    interpret: bool = False) -> StructState:
    """n_steps of the linear forward-Euler lattice step, one kernel launch
    per step (same values as ``structured_run_loop`` up to rounding).
    ``interpret=True`` runs the kernel in the Pallas interpreter (tests).

    Differentiable in state, mesh and dt: the kernel has no derivative
    rule of its own, so tangents, and through them ``jax.grad``, are those
    of ``structured_run_loop``, which computes the same map."""
    return _run_loop(state, mesh, dt, n_steps, interpret)


@triton_run_loop.defjvp
def _triton_run_loop_jvp(n_steps, interpret, primals, tangents):
    _, t_out = jax.jvp(partial(structured_run_loop, n_steps=n_steps),
                       primals, tangents)
    return _run_loop(*primals, n_steps, interpret), t_out


@partial(jax.jit, static_argnames=("n_steps", "interpret"))
def _run_loop(state, mesh, dt, n_steps, interpret):
    if state.tracers is not None:
        raise ValueError("the Triton lattice step runs the linear core only")
    ny2, nx = mesh.ny2, mesh.nx
    k = state.layer_thickness.shape[-1]
    kp = pl.next_power_of_2(k)
    dtype = state.layer_thickness.dtype
    pad = ((0, 0),) * 3 + ((0, kp - k),)
    h = jnp.pad(state.layer_thickness, pad)
    u = jnp.pad(state.normal_velocity.reshape(6, ny2, nx, k), pad)
    f_edge = mesh.f_edge.reshape(6, ny2, nx).astype(dtype)
    rts = mesh.resting_thickness_sum.astype(dtype)
    mask = (jnp.ones((6, ny2, nx), dtype) if mesh.edge_mask is None
            else mesh.edge_mask.reshape(6, ny2, nx).astype(dtype))
    # (dt, 1/dc, dv/area, pad): a Triton block's length is a power of two
    scal = jnp.stack([
        jnp.asarray(dt, dtype), (1.0 / mesh.dc).astype(dtype),
        (mesh.dv / mesh.area_cell).astype(dtype), jnp.zeros((), dtype),
    ])

    step = partial(_step, scal, f_edge=f_edge, rts=rts, mask=mask,
                   terms=mesh.coriolis_terms, k=k, interpret=interpret)

    def two_steps(carry, _):
        # ping-pong between two state buffers: each step writes into the
        # buffers the step before last read, so every carry keeps its
        # buffer and the loop copies nothing
        cur, spare = carry
        nxt = step(cur, dst=spare)
        return (step(nxt, dst=cur), nxt), None

    cur = (state.ssh.astype(dtype), h, u)
    spare = jax.tree.map(jnp.zeros_like, cur)
    (cur, spare), _ = jax.lax.scan(two_steps, (cur, spare),
                                   length=n_steps // 2)
    if n_steps % 2:
        cur = step(cur, dst=spare)
    ssh, h, u = cur
    return StructState(
        ssh=ssh, layer_thickness=h[..., :k],
        normal_velocity=u[..., :k].reshape(3, 2, ny2, nx, k),
    )
