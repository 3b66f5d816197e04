"""CLI driver: run a full simulation from a YAML config.

(reference: src/driver/mpas_ocean.jl — `ocn_run(config_fp)` + argv entry.
Differences by design: the backend is whatever JAX selected instead of
hardcoded CUDA (mpas_ocean.jl:28); periodic outputs are
actually written (the reference only resets the alarm, run_loop.jl:15-18);
and the loop itself is a jitted scan, not a host while-loop.)

Usage: python -m mpas_ocean.forward.driver <config.yml>
"""

from __future__ import annotations

import os
import sys
import time as _time
from datetime import timedelta

import jax
import numpy as np

from ..infra.config import ConfigGet
from ..infra.output import write_output
from .init import ModelSetup, ocn_init, ocn_init_alarms, plan_steps
from .run_loop import ocn_run_loop, ocn_run_loop_with_outputs


def _try_structured_model(mesh):
    """StructuredModel when the mesh is a generator-ordered uniform hex
    lattice, else None. HexLayout validates row-major ordering and exact
    lattice geometry, so false positives cannot slip through (culled
    channels / spheres / file meshes in other orders fall back)."""
    try:
        from ..structured import StructuredModel

        dc = float(np.asarray(mesh.horz.edges.dc_edge)[0])
        nx = int(round(mesh.horz.lx / dc))
        if nx <= 0 or mesh.n_cells % nx:
            return None
        ny = mesh.n_cells // nx
        if ny % 2 or nx * ny != mesh.n_cells:
            return None
        return StructuredModel(mesh, nx, ny)
    except Exception:
        return None


def _structured_rollout(sm, prog, setup, dt, n_steps, dtype):
    """One fast-path rollout chunk: the lattice rollout under one jitted
    scan, at any dtype (``StructuredModel.run`` picks its step)."""
    from ..forward.time_integration import ForwardBackward, RungeKutta4

    st = sm.to_struct(prog)
    sf = (None if setup.forcing is None
          else sm.to_struct_forcing(setup.forcing))
    out = sm.run(
        st, dtype(dt), n_steps,
        nonlinear=setup.nonlinear, forcing=sf,
        tracer_kappa=setup.tracer_kappa, tracer_upwind=setup.tracer_upwind,
        rk4=setup.integrator is RungeKutta4, strat=setup.strat,
        fb=setup.integrator is ForwardBackward,
    )
    return sm.from_struct(out)


def ocn_run(config_fp, dtype=np.float64, use_config_dt: bool = False,
            monitor: str | None = None, path: str = "auto"):
    """Run the configured simulation; returns (setup, final prognostic state).

    ``use_config_dt=False`` keeps reference behavior (dt recomputed from mesh
    spacing, SURVEY quirk 7.4); pass True to honor config_dt.

    ``monitor``: path of a JSON-lines file to receive in-run physics
    metrics (volume, kinetic energy, max |u|, ssh RMS — sampled on device,
    infra/monitor.py); health warnings are printed at the end.

    ``path``: 'auto' routes uniform hex-lattice configs onto the
    structured lattice rollout (``StructuredModel.run``: the same physics
    without gathers; interval outputs run as fast-path chunks); 'gather'
    forces the
    general-mesh loop (also used automatically when a monitor series is
    requested or the mesh is not a lattice).
    """
    print(f"Initializing with config: {config_fp}")
    setup, prog = ocn_init(config_fp, dtype=dtype)

    if use_config_dt:
        clock = setup.time_manager
        sim_alarm = clock.alarms["simulation_end"]
    else:
        clock, sim_alarm, _ = ocn_init_alarms(setup)

    dt = clock.time_step.total_seconds()
    n_steps, output_every = plan_steps(clock)
    print(
        f"Running {n_steps} steps of dt={dt}s "
        f"({setup.integrator.__name__}), output every "
        f"{output_every or 'end-only'} steps"
    )

    mesh = setup.mesh
    t0 = _time.perf_counter()
    outputs = None
    series = None
    want_interval_outputs = bool(
        output_every and n_steps % output_every == 0 and n_steps > output_every
    )
    # fast-path routing: uniform hex lattices run the structured paths
    # (the monitor series needs the gather loop's on-device sampling)
    sm_fast = None
    if path == "auto" and monitor is None:
        sm_fast = _try_structured_model(mesh)
        if sm_fast is not None:
            print("path: structured fast path (lattice detected)")
        else:
            print("path: general-mesh gather loop")
    if monitor is not None:
        from ..infra.monitor import check_health, write_jsonl
        from .run_loop import ocn_run_loop_with_monitor

        every = output_every or max(1, n_steps // 10)
        if n_steps % every:
            # sampling cadence must divide n_steps: snap to the nearest
            # divisor and say so (never silently rewrite the cadence)
            every = min(
                (d for d in range(1, n_steps + 1) if n_steps % d == 0),
                key=lambda d: abs(d - every),
            )
            print(f"monitor: sampling every {every} steps (nearest divisor)")
        if want_interval_outputs:
            # one rollout yields metrics AND the interval output snapshots
            every = output_every
            prog, series, outputs = ocn_run_loop_with_monitor(
                prog, mesh, dtype(dt), n_steps, every,
                setup.integrator, snapshots=True,
                nonlinear=setup.nonlinear, forcing=setup.forcing,
                tracer_kappa=setup.tracer_kappa,
                tracer_upwind=setup.tracer_upwind,
                strat=setup.strat,
            )
        else:
            prog, series = ocn_run_loop_with_monitor(
                prog, mesh, dtype(dt), n_steps, every, setup.integrator,
                nonlinear=setup.nonlinear, forcing=setup.forcing,
                tracer_kappa=setup.tracer_kappa,
                tracer_upwind=setup.tracer_upwind,
                strat=setup.strat,
            )
        jax.block_until_ready(prog)
        write_jsonl(monitor, series, dt, every)
        for w in check_health(jax.tree.map(np.asarray, series)):
            print(f"MONITOR WARNING: {w}")
        print(f"monitor series written: {monitor}")
    elif want_interval_outputs:
        n_outputs = n_steps // output_every
        if sm_fast is not None:
            import jax.numpy as jnp

            snaps = []
            for _ in range(n_outputs):
                prog = _structured_rollout(
                    sm_fast, prog, setup, dt, output_every, dtype
                )
                snaps.append(prog)
            outputs = jax.tree.map(lambda *xs: jnp.stack(xs), *snaps)
        else:
            prog, outputs = ocn_run_loop_with_outputs(
                prog, mesh, dtype(dt), n_steps, n_outputs, setup.integrator,
                nonlinear=setup.nonlinear, forcing=setup.forcing,
                tracer_kappa=setup.tracer_kappa,
                tracer_upwind=setup.tracer_upwind,
                strat=setup.strat,
            )
    elif sm_fast is not None:
        prog = _structured_rollout(sm_fast, prog, setup, dt, n_steps, dtype)
    else:
        prog = ocn_run_loop(
            prog, mesh, dtype(dt), n_steps, setup.integrator,
            nonlinear=setup.nonlinear, forcing=setup.forcing,
            tracer_kappa=setup.tracer_kappa,
            tracer_upwind=setup.tracer_upwind,
            strat=setup.strat,
        )
    jax.block_until_ready(prog)
    elapsed = _time.perf_counter() - t0

    # advance the host clock to the end for bookkeeping/alarms
    clock.set_current_time(clock.start_time + timedelta(seconds=dt * n_steps))

    output_cfg = ConfigGet(setup.config.streams, "output")
    out_fp = ConfigGet(output_cfg, "filename_template")
    sim_seconds = dt * n_steps
    if outputs is not None:
        base, ext = os.path.splitext(out_fp)
        for i in range(int(np.asarray(outputs.ssh).shape[0]) - 1):
            snap = jax.tree.map(lambda a, i=i: a[i], outputs)
            write_output(
                f"{base}.{i:04d}{ext}",
                mesh,
                snap,
                dt,
                dt * output_every * (i + 1),
                tracer_names=setup.tracer_names,
            )
    write_output(out_fp, mesh, prog, dt, sim_seconds,
                 tracer_names=setup.tracer_names)

    gridpoints = mesh.n_cells * mesh.n_vert_levels * n_steps
    print(f"Simulation complete on backend: {jax.devices()[0].platform}")
    print(f"Final time: {clock.curr_time}")
    print(
        f"Wall: {elapsed:.3f}s  ({gridpoints / max(elapsed, 1e-9):.3e} "
        "cell-levels x steps / s)"
    )
    return setup, prog


def ocn_run_with_ad(config_fp, dtype=np.float64, use_config_dt: bool = False):
    """Run the configured simulation AND its adjoint: differentiate the
    on-device objective sum(ssh_final^2) back to the initial prognostic
    state, then write state + adjoint shadows to the output stream.

    (reference: test/enzyme/test_Enzyme_end2end.jl:32-102 `ocn_run_with_ad`
    — Enzyme.autodiff over ocn_run_loop with hand-zeroed shadow structs and
    a custom rule for the device->host copy, ext/MPASEnzymeExt.jl:13-36.
    Here the entire machinery is jax.value_and_grad of the scan rollout.)
    """
    import jax.numpy as jnp

    setup, prog = ocn_init(config_fp, dtype=dtype)
    if use_config_dt:
        clock = setup.time_manager
    else:
        clock, _, _ = ocn_init_alarms(setup)
    dt = clock.time_step.total_seconds()
    n_steps, _ = plan_steps(clock)
    mesh = setup.mesh

    def obj_and_final(p):
        final = ocn_run_loop(
            p, mesh, dtype(dt), n_steps, setup.integrator, checkpoint=True,
            nonlinear=setup.nonlinear, forcing=setup.forcing,
            tracer_kappa=setup.tracer_kappa,
            tracer_upwind=setup.tracer_upwind,
            strat=setup.strat,
        )
        return jnp.sum(final.ssh * final.ssh), final

    # has_aux: one rollout yields objective, final state AND the adjoint
    (objective, final), d_prog = jax.value_and_grad(
        obj_and_final, has_aux=True
    )(prog)

    output_cfg = ConfigGet(setup.config.streams, "output")
    out_fp = ConfigGet(output_cfg, "filename_template")
    write_output(out_fp, mesh, final, dt, dt * n_steps, d_prog=d_prog,
                 tracer_names=setup.tracer_names)
    print(f"objective sum(ssh^2) = {float(objective):.9e}; adjoint written")
    return setup, final, d_prog, float(objective)


def main(argv=None):
    from ..utils.compile_cache import enable_compile_cache

    argv = sys.argv[1:] if argv is None else argv
    with_ad = "--ad" in argv
    argv = [a for a in argv if a != "--ad"]
    monitor = None
    if "--monitor" in argv:
        i = argv.index("--monitor")
        if i + 1 >= len(argv):
            print("--monitor requires a file argument")
            argv = []  # fall through to the usage message
        else:
            monitor = argv[i + 1]
            del argv[i : i + 2]
    path = "auto"
    if "--path" in argv:
        i = argv.index("--path")
        if i + 1 >= len(argv) or argv[i + 1] not in ("auto", "gather"):
            print("--path requires 'auto' or 'gather'")
            argv = []
        else:
            path = argv[i + 1]
            del argv[i : i + 2]
    if len(argv) != 1 or not os.path.isfile(argv[0]):
        print(
            "usage: python -m mpas_ocean.forward.driver "
            "[--ad] [--monitor metrics.jsonl] [--path auto|gather] "
            "<config.yml>"
        )
        return 1
    enable_compile_cache()
    if with_ad:
        ocn_run_with_ad(argv[0])
    else:
        ocn_run(argv[0], monitor=monitor, path=path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
