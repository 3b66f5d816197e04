"""Weak/strong-scaling measurement harness.

The BASELINE gate is ">= 70% weak-scaling grid-point throughput efficiency
from 1 chip to >= 2 hosts"; the reference only narrates MPI scaling results
from an ancestor project (reference: README.MD:55-66) and ships no harness.
This tool measures it on whatever devices are present:

  weak scaling:  per-device problem size fixed (rows_per_device lattice
                 rows), device count swept 1..N; efficiency(N) =
                 throughput(N) / (N * throughput(1))
  strong scaling: global size fixed, devices swept.

On several hosts, launch one process per host with
JAX_COORDINATOR_ADDRESS/JAX_NUM_PROCESSES/JAX_PROCESS_ID set —
parallel.distributed.init_distributed picks them up and the same sweep
runs over the global device set, inter-host hops included.

Usage:
  python -m mpas_ocean.tools.scaling [--rows-per-device 16] [--nx 128]
         [--levels 32] [--steps 200] [--mode weak|strong]

Prints one JSON line per device count plus a summary line.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def _build(nx: int, ny: int, levels: int, dtype=np.float32):
    import jax.numpy as jnp

    from ..mesh import planar_hex_mesh
    from ..mesh.mesh import Mesh
    from ..mesh.vert_mesh import make_vertical_mesh
    from ..models.shallow_water import PrognosticVars
    from ..structured import StructuredModel

    dc = 10000.0e3 / nx
    horz = planar_hex_mesh(nx, ny, dc, f0=1e-4, dtype=dtype)
    vert = make_vertical_mesh(
        horz, n_vert_levels=levels,
        resting_thickness=np.full((horz.n_cells, levels), 1000.0 / levels, dtype=dtype),
        dtype=dtype,
    )
    mesh = Mesh(horz=horz, vert=vert)
    sm = StructuredModel(mesh, nx, ny)
    rng = np.random.default_rng(0)
    h = (1000.0 / levels + 0.01 * rng.normal(size=(horz.n_cells, levels))).astype(dtype)
    u = (0.01 * rng.normal(size=(horz.n_edges, levels))).astype(dtype)
    prog = PrognosticVars(
        ssh=jnp.asarray(h.sum(1) - np.asarray(vert.resting_thickness_sum)),
        layer_thickness=jnp.asarray(h),
        normal_velocity=jnp.asarray(u),
    )
    return sm, sm.to_struct(prog), horz.n_cells * levels


def measure_scaling(
    rows_per_device: int = 16,
    nx: int = 128,
    levels: int = 32,
    steps: int = 200,
    mode: str = "weak",
    device_counts=None,
    dtype=np.float32,
    path: str = "run",
    q: int = 4,
    reps: int = 3,
) -> list[dict]:
    """Sweep device counts; returns one record per count with throughput
    (MEDIAN of ``reps`` timed runs, spread reported so noise is visible)
    and efficiency, plus a DETERMINISTIC structural profile
    (ShardedStructuredModel.step_stats: collectives/step, bytes per
    collective, redundant-compute fraction) that is exactly reproducible —
    the regression-diffable part of the artifact. NOTE: wall-clock numbers
    are meaningful on real accelerators only — on the virtual-CPU test
    mesh they validate the code path and scaling SHAPE, not performance."""
    import jax

    from ..structured import ShardedStructuredModel

    devices = jax.devices()
    if device_counts is None:
        device_counts = []
        n = 1
        while n <= len(devices):
            device_counts.append(n)
            n *= 2

    records = []
    base = None
    base_devices = None
    strong_built = None
    for n in device_counts:
        if mode == "weak":
            ny = 2 * rows_per_device * n  # ny2 rows = rows_per_device * n
            sm, st, gridpoints = _build(nx, ny, levels, dtype)
        else:
            # global size fixed: build the mesh once, reuse across counts
            if strong_built is None:
                ny = 2 * rows_per_device * max(device_counts)
                strong_built = _build(nx, ny, levels, dtype)
            sm, st, gridpoints = strong_built
        ssm = ShardedStructuredModel(sm.struct_mesh, devices=devices[:n])
        local = ssm.scatter(st)

        def run():
            if path == "superstep":
                # communication-avoiding superstep (q steps per exchange)
                out = ssm.run_superstep(local, dtype(30.0), steps, q=q)
            else:
                out = ssm.run(local, dtype(30.0), steps)
            return float(ssm.checksum(out))

        chk = run()  # compile + warm
        times = []
        for _ in range(max(1, reps)):
            t0 = time.perf_counter()
            chk = run()
            times.append(time.perf_counter() - t0)
        t = float(np.median(times))
        spread = float((max(times) - min(times)) / t) if t else 0.0
        thr = gridpoints * steps / t
        if base is None:
            # efficiency is normalized to the SMALLEST measured count (per-
            # device throughput there); when the sweep starts above 1 device
            # the record says so instead of implying a 1-chip baseline
            base = thr / n
            base_devices = n
        rec = {
            "devices": n,
            "mode": mode,
            "path": path,
            "q": q if path == "superstep" else None,
            "lattice": f"{nx}x{ny}x{levels}",
            "gridpoints": gridpoints,
            "gridpoints_per_sec": thr,
            "seconds_per_step": t / steps,
            "timing_spread_frac": spread,
            # both modes: per-device throughput relative to the baseline
            # count's per-device throughput
            "efficiency": thr / (n * base),
            "efficiency_baseline_devices": base_devices,
            "structural": ssm.step_stats(
                levels, np.dtype(dtype).itemsize, path=path,
                q=q if path == "superstep" else 1,
            ),
            "overlap": ssm.overlap_stats(levels, np.dtype(dtype).itemsize),
            "checksum": chk,
        }
        records.append(rec)
    return records


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--rows-per-device", type=int, default=16)
    p.add_argument("--nx", type=int, default=128)
    p.add_argument("--levels", type=int, default=32)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--mode", choices=["weak", "strong"], default="weak")
    args = p.parse_args(argv)

    from ..parallel.distributed import init_distributed

    init_distributed()  # no-op single-process
    records = measure_scaling(
        args.rows_per_device, args.nx, args.levels, args.steps, args.mode
    )
    for r in records:
        print(json.dumps(r))
    eff = records[-1]["efficiency"]
    print(
        json.dumps(
            {
                "metric": f"{args.mode}_scaling_efficiency",
                "value": eff,
                "devices": records[-1]["devices"],
                "gate": "BASELINE requires >= 0.70 weak to >= 2 hosts",
            }
        )
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
