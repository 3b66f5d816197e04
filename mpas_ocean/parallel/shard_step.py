"""Sharded time stepping: `shard_map` over a cell partition with halo
exchange through XLA collectives.

Replacement for the MPI halo exchange the reference declares but
never implements (SURVEY section 2.2): each device owns a contiguous block
of cells/edges (partition.py), computes tendencies for its owned elements
from owned+halo data, and refreshes halos with an `all_gather` of packed
boundary values over the mesh axis — a static-shape collective XLA schedules
on ICI. The whole multi-step rollout, collectives included, is one jitted
`lax.scan`.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh as DeviceMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from ..constants import GRAVITY
from ..models.shallow_water import (
    PrognosticVars,
    compute_diagnostics,
    compute_tendencies,
    kinetic_energy_on_cell,
    potential_vorticity_on_vertex,
    pv_flux_tendency,
    update_ssh,
)
from ..ops.operators import (
    divergence_on_cell,
    gradient_on_edge,
    interpolate_cell_to_edge,
    interpolate_vertex_to_edge,
)
from ..forward.time_integration import (
    ForwardBackward,
    ForwardEuler,
    RungeKutta4,
    ocn_timestep,
)
from ..utils.pytree import pytree_dataclass
from .partition import PartitionedMesh, build_partition
from .ppermute import (
    build_permute_schedule,
    halo_exchange_fields_ppermute,
    halo_exchange_ppermute,
)

try:  # JAX >= 0.6 spells it jax.shard_map
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

__all__ = ["ShardedModel", "ExchangeSpec"]


@pytree_dataclass
class ExchangeSpec:
    """Static halo-exchange schedule, one leading (P,) axis per leaf."""

    cell_send: jax.Array  # (P, Sc) local slots to pack
    cell_recv_flat: jax.Array  # (P, Hc) flat index into (P*Sc) gathered packs
    cell_halo_slots: jax.Array  # (P, Hc)
    edge_send: jax.Array  # (P, Se)
    edge_recv_flat: jax.Array  # (P, He)
    edge_halo_slots: jax.Array  # (P, He)


def _halo_exchange(
    prog: PrognosticVars, ex: ExchangeSpec, axis: str,
    apply_to: PrognosticVars | None = None,
) -> PrognosticVars:
    """Refresh halo values of all prognostic fields (inside shard_map;
    per-device views carry no leading parts axis). ``prog`` supplies the
    packed values (send columns index its arrays); received values
    overwrite the halo slots of ``apply_to`` (default ``prog``)."""
    # pack owned boundary values: cells carry h (K) + ssh (1) [+ tracers
    # (nT*K)] together
    k = prog.layer_thickness.shape[1]
    parts = [
        prog.layer_thickness[ex.cell_send],
        prog.ssh[ex.cell_send][:, None],
    ]
    if prog.tracers is not None:
        parts.append(prog.tracers[ex.cell_send].reshape(len(ex.cell_send), -1))
    cell_pack = jnp.concatenate(parts, axis=1)  # (Sc, K+1[+nT*K])
    edge_pack = prog.normal_velocity[ex.edge_send]  # (Se, K)

    all_cells = jax.lax.all_gather(cell_pack, axis, tiled=True)
    all_edges = jax.lax.all_gather(edge_pack, axis, tiled=True)  # (P*Se, K)

    tgt = prog if apply_to is None else apply_to
    cell_in = all_cells[ex.cell_recv_flat]  # (Hc, K+1[+nT*K])
    h = tgt.layer_thickness.at[ex.cell_halo_slots].set(cell_in[:, :k])
    ssh = tgt.ssh.at[ex.cell_halo_slots].set(cell_in[:, k])
    tr = tgt.tracers
    if prog.tracers is not None:
        inc = cell_in[:, k + 1:].reshape(-1, tr.shape[1], tr.shape[2])
        tr = tr.at[ex.cell_halo_slots].set(inc)
    u = tgt.normal_velocity.at[ex.edge_halo_slots].set(all_edges[ex.edge_recv_flat])
    return PrognosticVars(ssh=ssh, layer_thickness=h, normal_velocity=u,
                          tracers=tr)


def _halo_exchange_fields(cell_fields, edge_fields, ex: ExchangeSpec, axis):
    """all_gather variant of ppermute.halo_exchange_fields_ppermute:
    refresh halo slots of derived per-(cell|edge) fields (see there for why
    the nonlinear step needs it)."""
    cf, ef = list(cell_fields), list(edge_fields)
    if cf:
        pack = jnp.concatenate([f[ex.cell_send] for f in cf], axis=1)
        allp = jax.lax.all_gather(pack, axis, tiled=True)
        inc = allp[ex.cell_recv_flat]
        o = 0
        for i, f in enumerate(cf):
            w = f.shape[1]
            cf[i] = f.at[ex.cell_halo_slots].set(inc[:, o:o + w])
            o += w
    if ef:
        pack = jnp.concatenate([f[ex.edge_send] for f in ef], axis=1)
        allp = jax.lax.all_gather(pack, axis, tiled=True)
        inc = allp[ex.edge_recv_flat]
        o = 0
        for i, f in enumerate(ef):
            w = f.shape[1]
            ef[i] = f.at[ex.edge_halo_slots].set(inc[:, o:o + w])
            o += w
    return tuple(cf), tuple(ef)


def sharded_nonlinear_rates(p: PrognosticVars, lmesh, refresh_fields,
                            forcing=None, tracer_kappa: float = 0.0,
                            tracer_upwind: float = 1.0, strat=None):
    """Vector-invariant tendencies on a 1-ring-halo local mesh.

    The PV flux at an owned edge taps derived values (thickness flux, edge
    PV) at the edges of its two adjacent cells; computing those locally
    would need a 2-ring halo (their own stencils reach one more ring out).
    Instead every device computes the derived fields where its data is
    complete — kinetic energy at owned cells, flux and edge PV at owned
    edges (their vertices always have all 3 cells inside the 1-ring halo) —
    and ``refresh_fields((ke,), (flux, q_e))`` overwrites halo slots with
    the owner-computed values. Same math as the global nonlinear tendency
    (models/shallow_water.compute_normal_velocity_tendency), so owned
    elements match the unsharded rollout to f64 roundoff."""
    ke = kinetic_energy_on_cell(p.normal_velocity, lmesh)
    h_edge = interpolate_cell_to_edge(p.layer_thickness, lmesh)
    flux = p.normal_velocity * h_edge
    q_v = potential_vorticity_on_vertex(p, lmesh)
    q_e = interpolate_vertex_to_edge(q_v, lmesh)
    (ke,), (flux, q_e) = refresh_fields((ke,), (flux, q_e))

    elm = lmesh.vert.edge_level_mask
    if strat is None:
        tend_u = -GRAVITY * gradient_on_edge(p.ssh, lmesh)[:, None] * elm
    else:
        from ..models.stratification import montgomery_potential

        phi = montgomery_potential(p.ssh, p.layer_thickness, strat)
        tend_u = -gradient_on_edge(phi, lmesh) * elm
    tend_u = tend_u - gradient_on_edge(ke, lmesh) * elm
    tend_u = tend_u + pv_flux_tendency(q_e, flux, lmesh) * elm
    if forcing is not None:
        from ..models.forcing import forcing_tendency

        tend_u = tend_u + forcing_tendency(p.normal_velocity, h_edge, forcing)
    tend_u = tend_u * lmesh.edges.edge_mask[:, None]
    tend_h = -divergence_on_cell(flux, lmesh) * lmesh.vert.cell_level_mask
    tend_t = None
    if p.tracers is not None:
        # tracer stencils reach only the two cells of each owned cell's
        # edges — inside the 1-ring halo — so the local computation is
        # already owner-exact (same reason the linear step needs no
        # derived-field round); the refreshed flux values at boundary
        # edges are bitwise what this part computes itself
        from ..models.tracers import tracer_tendency

        tend_t = tracer_tendency(
            p.tracers, flux, lmesh, kappa=tracer_kappa,
            upwind=tracer_upwind, h_edge=h_edge,
        )
    return tend_u, tend_h, tend_t


def sharded_fb_step(prog: PrognosticVars, lmesh, dt, refresh_fields,
                    nonlinear: bool = False, forcing=None,
                    tracer_kappa: float = 0.0, tracer_upwind: float = 1.0,
                    strat=None) -> PrognosticVars:
    """Forward-backward inside shard_map: the velocity stage reads the NEW
    thickness's pressure gradient, whose stencil reaches one ring past what
    the locally-computable h_new covers — so (h_new, ssh_new) are refreshed
    mid-step with one derived-field round (the same machinery the nonlinear
    step uses; in nonlinear runs the two rounds merge into one exchange).
    Mirrors forward/time_integration.forward_backward_step for owned
    elements to f64 roundoff."""
    h_edge = interpolate_cell_to_edge(prog.layer_thickness, lmesh)
    flux = prog.normal_velocity * h_edge
    tend_h = -divergence_on_cell(flux, lmesh) * lmesh.vert.cell_level_mask
    h_new = prog.layer_thickness + dt * tend_h
    ssh2 = update_ssh(h_new, lmesh)[:, None]
    elm = lmesh.vert.edge_level_mask
    if nonlinear:
        ke = kinetic_energy_on_cell(prog.normal_velocity, lmesh)
        q_v = potential_vorticity_on_vertex(prog, lmesh)
        q_e = interpolate_vertex_to_edge(q_v, lmesh)
        (h_new, ssh2, ke), (flux, q_e) = refresh_fields(
            (h_new, ssh2, ke), (flux, q_e)
        )
    else:
        (h_new, ssh2), _ = refresh_fields((h_new, ssh2), ())
    ssh_new = ssh2[:, 0]
    if strat is None:
        tend_u = -GRAVITY * gradient_on_edge(ssh_new, lmesh)[:, None] * elm
    else:
        from ..models.stratification import montgomery_potential

        phi = montgomery_potential(ssh_new, h_new, strat)
        tend_u = -gradient_on_edge(phi, lmesh) * elm
    if nonlinear:
        tend_u = tend_u - gradient_on_edge(ke, lmesh) * elm
        tend_u = tend_u + pv_flux_tendency(q_e, flux, lmesh) * elm
    else:
        uf = prog.normal_velocity * lmesh.edges.f[:, None]
        from ..ops.operators import tangential_reconstruction

        tend_u = tend_u + tangential_reconstruction(uf, lmesh) * elm
    if forcing is not None:
        from ..models.forcing import forcing_tendency

        tend_u = tend_u + forcing_tendency(prog.normal_velocity, h_edge,
                                           forcing)
    tend_u = tend_u * lmesh.edges.edge_mask[:, None]
    u_new = prog.normal_velocity + dt * tend_u
    tracers = None
    if prog.tracers is not None:
        from ..models.tracers import apply_tracer_update, tracer_tendency

        tend_t = tracer_tendency(
            prog.tracers, flux, lmesh, kappa=tracer_kappa,
            upwind=tracer_upwind, h_edge=h_edge,
        )
        tracers = apply_tracer_update(
            prog.tracers, prog.layer_thickness, h_new, tend_t, dt,
            lmesh.vert.cell_level_mask,
        )
    return PrognosticVars(ssh=ssh_new, layer_thickness=h_new,
                          normal_velocity=u_new, tracers=tracers)


def sharded_rk4_step(prog: PrognosticVars, lmesh, dt, refresh,
                     rates=None, forcing=None, tracer_kappa: float = 0.0,
                     tracer_upwind: float = 1.0, strat=None) -> PrognosticVars:
    """One RK4 step inside shard_map, with a halo refresh before every
    stage-rate evaluation: each of the four stages widens the stencil by one
    ring, so per-stage exchange is required for the 1-ring halo the
    partition carries (a single per-step exchange silently corrupts owned
    elements near part boundaries).

    ``refresh(p)`` must overwrite halo slots with owner values. The caller
    is responsible for refreshing the RETURNED state (the run loop's
    post-step exchange does it), and ``prog`` must arrive with fresh halos.
    Mirrors forward/time_integration.rk4_step stage for stage. ``rates``
    overrides the stage-rate function (nonlinear sharded runs pass
    sharded_nonlinear_rates bound to the derived-field refresh).
    """

    if rates is None:
        def rates(p):
            diag = compute_diagnostics(p, lmesh)
            t = compute_tendencies(p, diag, lmesh, forcing=forcing,
                                   tracer_kappa=tracer_kappa,
                                   tracer_upwind=tracer_upwind, strat=strat)
            return t.tend_normal_velocity, t.tend_layer_thickness, t.tend_tracer

    u0, h0 = prog.normal_velocity, prog.layer_thickness
    with_tracers = prog.tracers is not None
    ht0 = h0[:, None, :] * prog.tracers if with_tracers else None
    clm = lmesh.vert.cell_level_mask

    from ..models.tracers import tracer_concentration

    def concentration(content, h):
        return tracer_concentration(content, h, clm)

    def stage(du, dh, dht, a):
        h = h0 + a * dh
        tracers = concentration(ht0 + a * dht, h) if with_tracers else None
        p = PrognosticVars(
            ssh=update_ssh(h, lmesh), layer_thickness=h,
            normal_velocity=u0 + a * du, tracers=tracers,
        )
        return refresh(p)

    k1u, k1h, k1t = rates(prog)
    k2u, k2h, k2t = rates(stage(k1u, k1h, k1t, dt / 2.0))
    k3u, k3h, k3t = rates(stage(k2u, k2h, k2t, dt / 2.0))
    k4u, k4h, k4t = rates(stage(k3u, k3h, k3t, dt))
    u = u0 + (dt / 6.0) * (k1u + 2.0 * k2u + 2.0 * k3u + k4u)
    h = h0 + (dt / 6.0) * (k1h + 2.0 * k2h + 2.0 * k3h + k4h)
    tracers = None
    if with_tracers:
        ht = ht0 + (dt / 6.0) * (k1t + 2.0 * k2t + 2.0 * k3t + k4t)
        tracers = concentration(ht, h)
    return PrognosticVars(ssh=update_ssh(h, lmesh), layer_thickness=h,
                          normal_velocity=u, tracers=tracers)


class ShardedModel:
    """Drives a partitioned shallow-water model over a 1-D device mesh.

    Usage:
        sm = ShardedModel(mesh, devices=jax.devices())
        local = sm.scatter(prog)          # global state -> sharded state
        local = sm.run(local, dt, n)      # jitted scan of sharded steps
        prog = sm.gather(local)           # sharded -> global (host)
    """

    AXIS = "space"

    def __init__(self, mesh, devices=None, part: PartitionedMesh | None = None,
                 exchange: str = "ppermute", overlap: bool = True,
                 device_mesh: DeviceMesh | None = None):
        """``exchange``: 'ppermute' (default — neighbor-only ring rotations
        over ICI, SURVEY section 8 plan) or 'allgather' (every part's
        boundary pack broadcast to all devices).

        ``overlap``: step the boundary mini mesh first, issue the halo
        collectives against its result, and compute the full local step
        while they fly (parallel/overlap.py; forward-Euler runs only — RK4's
        stage dependencies keep its per-stage exchanges on the critical
        path).

        ``device_mesh``: optional prebuilt mesh — 1-D, or the 2-D
        ('dcn', 'ici') hybrid from parallel.distributed.hybrid_device_mesh;
        parts shard over the FLATTENED axes so the spatially-coherent
        partition order keeps most exchange traffic on ICI."""
        if device_mesh is not None:
            self.device_mesh = device_mesh
            self.axes = tuple(device_mesh.axis_names)
            self.n_parts = int(np.prod(list(device_mesh.shape.values())))
        else:
            devices = list(devices if devices is not None else jax.devices())
            self.n_parts = len(devices)
            self.device_mesh = DeviceMesh(np.array(devices), (self.AXIS,))
            self.axes = (self.AXIS,)
        self.global_mesh = mesh
        if part is None:
            part = build_partition(mesh, self.n_parts)
        self.part = part
        if exchange not in ("ppermute", "allgather"):
            raise ValueError(f"unknown exchange {exchange!r}")
        self.exchange = exchange
        self.overlap = bool(overlap)
        self._sharded = NamedSharding(self.device_mesh, P(self.axes))
        self._spec_parts = P(self.axes)

        self.local_mesh = self._put_tree(part.local_mesh)
        ex = ExchangeSpec(
            cell_send=jnp.asarray(part.cell_send),
            cell_recv_flat=jnp.asarray(part.cell_recv_flat),
            cell_halo_slots=jnp.asarray(part.cell_halo_slots),
            edge_send=jnp.asarray(part.edge_send),
            edge_recv_flat=jnp.asarray(part.edge_recv_flat),
            edge_halo_slots=jnp.asarray(part.edge_halo_slots),
        )
        self.ex = self._put_tree(ex)
        if exchange == "ppermute":
            rounds = build_permute_schedule(part)
            self.rounds = self._put_tree(rounds)
        else:
            self.rounds = None

        self.mini = None
        if self.overlap:
            from .overlap import build_boundary_mini

            mini, c_look, e_look = build_boundary_mini(part)
            self.mini = self._put_tree(mini)

            def remap(look, a):
                pos = np.take_along_axis(
                    look, np.asarray(a, dtype=np.int64), axis=1
                )
                return jnp.asarray(pos.astype(np.int32))

            # exchange schedules whose SEND columns index the mini axes
            if exchange == "ppermute":
                rm = tuple(
                    r.replace(
                        cell_send=remap(c_look, r.cell_send),
                        edge_send=remap(e_look, r.edge_send),
                    )
                    for r in rounds
                )
                self._ex_mini = self._put_tree(rm)
            else:
                exm = ex.replace(
                    cell_send=remap(c_look, part.cell_send),
                    edge_send=remap(e_look, part.edge_send),
                )
                self._ex_mini = self._put_tree(exm)

    # -- layout helpers -------------------------------------------------
    def _leaf_sharding(self, tree):
        return jax.tree.map(lambda _: self._sharded, tree)

    def _put_tree(self, tree):
        """Place a host-global pytree onto the device mesh; in
        multi-process runs each process feeds only its own shards
        (make_array_from_callback)."""
        if self._sharded.is_fully_addressable:
            return jax.device_put(tree, self._leaf_sharding(tree))

        def put(a):
            a = np.asarray(a)
            return jax.make_array_from_callback(
                a.shape, self._sharded, lambda idx, a=a: a[idx]
            )

        return jax.tree.map(put, tree)

    def _in_specs(self, tree):
        return jax.tree.map(lambda _: self._spec_parts, tree)

    def scatter(self, prog: PrognosticVars) -> PrognosticVars:
        """Split a global prognostic state into stacked per-part local
        states (owned + halo + pad slots), placed on the device mesh."""
        p = self.part
        gids_c = np.where(p.cell_gids >= 0, p.cell_gids, 0)
        gids_e = np.where(p.edge_gids >= 0, p.edge_gids, 0)
        ssh = np.asarray(prog.ssh)[gids_c]
        h = np.asarray(prog.layer_thickness)[gids_c]
        u = np.asarray(prog.normal_velocity)[gids_e]
        tracers = None
        if prog.tracers is not None:
            tracers = jnp.asarray(np.asarray(prog.tracers)[gids_c])
        local = PrognosticVars(
            ssh=jnp.asarray(ssh),
            layer_thickness=jnp.asarray(h),
            normal_velocity=jnp.asarray(u),
            tracers=tracers,
        )
        return self._put_tree(local)

    def gather(self, local: PrognosticVars) -> PrognosticVars:
        """Reassemble the global state from owned slots (host-side)."""
        p = self.part
        n_cells = self.global_mesh.n_cells
        n_edges = self.global_mesh.n_edges
        K = self.global_mesh.n_vert_levels
        ssh = np.empty(n_cells)
        h = np.empty((n_cells, K))
        u = np.empty((n_edges, K))
        l_ssh = np.asarray(local.ssh)
        l_h = np.asarray(local.layer_thickness)
        l_u = np.asarray(local.normal_velocity)
        tracers = l_tr = None
        if local.tracers is not None:
            l_tr = np.asarray(local.tracers)
            tracers = np.empty((n_cells,) + l_tr.shape[2:])
        for q in range(self.n_parts):
            oc = p.cell_gids[q, : p.n_owned_cells[q]]
            ssh[oc] = l_ssh[q, : p.n_owned_cells[q]]
            h[oc] = l_h[q, : p.n_owned_cells[q]]
            if tracers is not None:
                tracers[oc] = l_tr[q, : p.n_owned_cells[q]]
            oe = p.edge_gids[q, : p.n_owned_edges[q]]
            u[oe] = l_u[q, : p.n_owned_edges[q]]
        return PrognosticVars(
            ssh=jnp.asarray(ssh), layer_thickness=jnp.asarray(h),
            normal_velocity=jnp.asarray(u),
            tracers=None if tracers is None else jnp.asarray(tracers),
        )

    def _exchange_fn(self):
        """(pack, ex, apply_to=None) -> state with fresh halos, per the
        configured backend."""
        if self.exchange == "ppermute":
            axis, n_parts = self.axes, self.n_parts
            return lambda prog, ex, apply_to=None: halo_exchange_ppermute(
                prog, ex, axis, n_parts, apply_to
            )
        return lambda prog, ex, apply_to=None: _halo_exchange(
            prog, ex, self.axes, apply_to
        )

    def _exchange_fields_fn(self):
        """(cell_fields, edge_fields, ex) -> halo-fresh derived fields,
        per the configured backend (nonlinear sharded step)."""
        if self.exchange == "ppermute":
            axis, n_parts = self.axes, self.n_parts
            return lambda cf, ef, ex: halo_exchange_fields_ppermute(
                cf, ef, ex, axis, n_parts
            )
        return lambda cf, ef, ex: _halo_exchange_fields(cf, ef, ex, self.axes)

    @property
    def _ex_arg(self):
        return self.rounds if self.exchange == "ppermute" else self.ex

    def scatter_strat(self, strat):
        """Replicate the (tiny) stratification matrices as (P, ...) stacks
        so the shard_map squeeze recovers them per device."""
        if strat is None:
            return None
        from ..models.stratification import Stratification

        rep = lambda a: jnp.asarray(
            np.broadcast_to(np.asarray(a), (self.n_parts,) + np.shape(a))
        )
        return self._put_tree(Stratification(
            phi_weights=rep(strat.phi_weights),
            densities=rep(strat.densities),
        ))

    def scatter_forcing(self, forcing):
        """Global models.forcing.Forcing -> per-part local layout (edge
        fields gathered by edge_gids, scalars replicated as a (P,) stack so
        the shard_map squeeze recovers plain scalars)."""
        if forcing is None:
            return None
        from ..models.forcing import Forcing

        p = self.part
        gids_e = np.where(p.edge_gids >= 0, p.edge_gids, 0)
        local = Forcing(
            wind_edge=jnp.asarray(np.asarray(forcing.wind_edge)[gids_e]),
            top_mask=jnp.asarray(np.asarray(forcing.top_mask)[gids_e]),
            bottom_mask=jnp.asarray(np.asarray(forcing.bottom_mask)[gids_e]),
            drag_linear=jnp.asarray(
                np.full(self.n_parts, float(forcing.drag_linear))
            ),
            drag_quadratic=jnp.asarray(
                np.full(self.n_parts, float(forcing.drag_quadratic))
            ),
            rayleigh=jnp.asarray(
                np.full(self.n_parts, float(forcing.rayleigh))
            ),
        )
        return self._put_tree(local)

    # -- compute --------------------------------------------------------
    def run(self, local: PrognosticVars, dt, n_steps: int, method=ForwardEuler,
            nonlinear: bool = False, forcing=None,
            tracer_kappa: float = 0.0, tracer_upwind: float = 1.0,
            strat=None):
        """n_steps sharded timesteps under one jit (scan inside shard_map).
        ``nonlinear=True`` runs the vector-invariant dynamics (derived-field
        halo exchange keeps the 1-ring halo exact; overlap mini-stepping is
        bypassed — its boundary mesh only carries the linear stencil).
        ``forcing``: a GLOBAL models.forcing.Forcing (scattered here);
        forcing and tracers also bypass the overlap mini step (the boundary
        mini mesh carries no forcing fields or tracer stencils)."""
        lforce = self.scatter_forcing(forcing)
        lstrat = self.scatter_strat(strat)
        use_overlap = (
            self.overlap and method is ForwardEuler and not nonlinear
            and forcing is None and local.tracers is None and strat is None
        )
        mini_args = (self.mini, self._ex_mini) if use_overlap else None
        return self._run_jit(
            local, self.local_mesh, self._ex_arg, mini_args, lforce, lstrat,
            float(dt), n_steps, method, nonlinear, tracer_kappa,
            tracer_upwind,
        )

    @partial(jax.jit, static_argnames=("self", "dt", "n_steps", "method", "nonlinear", "tracer_kappa", "tracer_upwind"))
    def _run_jit(self, local, lmesh, ex, mini_args, lforce, lstrat, dt, n_steps,
                 method, nonlinear=False, tracer_kappa=0.0,
                 tracer_upwind=1.0):
        from .overlap import mini_forward_euler_step

        exchange = self._exchange_fn()
        exchange_fields = self._exchange_fields_fn()
        if method not in (ForwardEuler, RungeKutta4, ForwardBackward):
            raise ValueError(f"unknown sharded time stepper {method!r}")
        use_overlap = mini_args is not None

        def device_fn(local, lmesh, ex, mini_args, lforce, lstrat):
            # leaves arrive as (1, ...) blocks of the parts axis
            sq = lambda t: jax.tree.map(lambda a: a[0], t)
            local, lmesh, ex = sq(local), sq(lmesh), sq(ex)
            lf = sq(lforce) if lforce is not None else None
            ls = sq(lstrat) if lstrat is not None else None
            if use_overlap:
                mini, ex_mini = sq(mini_args)
            nl_rates = lambda p: sharded_nonlinear_rates(
                p, lmesh, lambda cf, ef: exchange_fields(cf, ef, ex),
                forcing=lf, tracer_kappa=tracer_kappa,
                tracer_upwind=tracer_upwind, strat=ls,
            )

            def body(prog, _):
                if method is RungeKutta4:
                    prog = sharded_rk4_step(
                        prog, lmesh, dt, lambda p: exchange(p, ex),
                        rates=nl_rates if nonlinear else None, forcing=lf,
                        tracer_kappa=tracer_kappa, tracer_upwind=tracer_upwind,
                        strat=ls,
                    )
                    return exchange(prog, ex), None
                if method is ForwardBackward:
                    prog = sharded_fb_step(
                        prog, lmesh, dt,
                        lambda cf, ef: exchange_fields(cf, ef, ex),
                        nonlinear=nonlinear, forcing=lf,
                        tracer_kappa=tracer_kappa,
                        tracer_upwind=tracer_upwind, strat=ls,
                    )
                    return exchange(prog, ex), None
                if nonlinear:
                    tu, th, tt = nl_rates(prog)
                    h = prog.layer_thickness + dt * th
                    u = prog.normal_velocity + dt * tu
                    tracers = None
                    if prog.tracers is not None:
                        from ..models.tracers import apply_tracer_update

                        tracers = apply_tracer_update(
                            prog.tracers, prog.layer_thickness, h, tt, dt,
                            lmesh.vert.cell_level_mask,
                        )
                    prog = PrognosticVars(
                        ssh=update_ssh(h, lmesh), layer_thickness=h,
                        normal_velocity=u, tracers=tracers,
                    )
                    return exchange(prog, ex), None
                if use_overlap:
                    # boundary mini first -> collectives fly over full step
                    ssh_b, h_b, u_b = mini_forward_euler_step(prog, mini, dt)
                    pack = PrognosticVars(
                        ssh=ssh_b, layer_thickness=h_b, normal_velocity=u_b
                    )
                    full = ocn_timestep(prog, lmesh, dt, method)
                    return exchange(pack, ex_mini, apply_to=full), None
                prog = ocn_timestep(prog, lmesh, dt, method, forcing=lf,
                                    tracer_kappa=tracer_kappa,
                                    tracer_upwind=tracer_upwind, strat=ls)
                return exchange(prog, ex), None

            out, _ = jax.lax.scan(body, local, length=n_steps)
            return jax.tree.map(lambda a: a[None], out)

        return shard_map(
            device_fn,
            mesh=self.device_mesh,
            in_specs=(
                self._in_specs(local),
                self._in_specs(lmesh),
                self._in_specs(ex),
                self._in_specs(mini_args),
                self._in_specs(lforce),
                self._in_specs(lstrat),
            ),
            out_specs=self._in_specs(local),
        )(local, lmesh, ex, mini_args, lforce, lstrat)

    def objective(self, local: PrognosticVars, dt, n_steps: int, method=ForwardEuler,
                  nonlinear: bool = False, forcing=None,
                  tracer_kappa: float = 0.0, tracer_upwind: float = 1.0,
                  strat=None):
        """Differentiable sharded rollout + global sum(ssh^2) over owned
        cells (psum over the mesh axis)."""
        if method not in (ForwardEuler, RungeKutta4, ForwardBackward):
            raise ValueError(f"unknown sharded time stepper {method!r}")
        lforce = self.scatter_forcing(forcing)
        lstrat = self.scatter_strat(strat)
        p = self.part
        owned_mask = (
            np.arange(p.cell_gids.shape[1])[None, :] < p.n_owned_cells[:, None]
        ).astype(local.ssh.dtype)
        owned_mask = self._put_tree(jnp.asarray(owned_mask))

        exchange = self._exchange_fn()
        exchange_fields = self._exchange_fields_fn()

        def device_fn(local, lmesh, ex, mask, lforce, lstrat):
            sq = lambda t: jax.tree.map(lambda a: a[0], t)
            local, lmesh, ex, mask = sq(local), sq(lmesh), sq(ex), sq(mask)
            lf = sq(lforce) if lforce is not None else None
            ls = sq(lstrat) if lstrat is not None else None
            nl_rates = lambda p: sharded_nonlinear_rates(
                p, lmesh, lambda cf, ef: exchange_fields(cf, ef, ex),
                forcing=lf, tracer_kappa=tracer_kappa,
                tracer_upwind=tracer_upwind, strat=ls,
            )

            def body(prog, _):
                if method is RungeKutta4:
                    prog = sharded_rk4_step(
                        prog, lmesh, dt, lambda p: exchange(p, ex),
                        rates=nl_rates if nonlinear else None, forcing=lf,
                        tracer_kappa=tracer_kappa, tracer_upwind=tracer_upwind,
                        strat=ls,
                    )
                elif method is ForwardBackward:
                    prog = sharded_fb_step(
                        prog, lmesh, dt,
                        lambda cf, ef: exchange_fields(cf, ef, ex),
                        nonlinear=nonlinear, forcing=lf,
                        tracer_kappa=tracer_kappa,
                        tracer_upwind=tracer_upwind, strat=ls,
                    )
                elif nonlinear:
                    tu, th, tt = nl_rates(prog)
                    h = prog.layer_thickness + dt * th
                    u = prog.normal_velocity + dt * tu
                    tracers = None
                    if prog.tracers is not None:
                        from ..models.tracers import apply_tracer_update

                        tracers = apply_tracer_update(
                            prog.tracers, prog.layer_thickness, h, tt, dt,
                            lmesh.vert.cell_level_mask,
                        )
                    prog = PrognosticVars(
                        ssh=update_ssh(h, lmesh), layer_thickness=h,
                        normal_velocity=u, tracers=tracers,
                    )
                else:
                    prog = ocn_timestep(prog, lmesh, dt, method, forcing=lf,
                                        tracer_kappa=tracer_kappa,
                                        tracer_upwind=tracer_upwind, strat=ls)
                return exchange(prog, ex), None

            out, _ = jax.lax.scan(jax.checkpoint(body), local, length=n_steps)
            s = jnp.sum(out.ssh * out.ssh * mask)
            return jax.lax.psum(s, self.axes)

        ex_arg = self._ex_arg
        fn = shard_map(
            device_fn,
            mesh=self.device_mesh,
            in_specs=(
                self._in_specs(local),
                self._in_specs(self.local_mesh),
                self._in_specs(ex_arg),
                self._spec_parts,
                self._in_specs(lforce),
                self._in_specs(lstrat),
            ),
            out_specs=P(),
        )
        return fn(local, self.local_mesh, ex_arg, owned_mask, lforce, lstrat)
