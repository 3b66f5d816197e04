"""Benchmark harness: grid-point throughput of the shallow-water core.

Runs the reference's headline configuration (reference: README.MD:45-50 —
64x64 mesh, 100 vertical levels; its GPU-vs-CPU experiment) on the GPU
through each execution path, and measures in the same call what the card
reaches on a large copy and a large bf16 matrix product. The north-star
metric from BASELINE.json is grid-points/s per device = cells x levels x
steps / wall-second.

Prints ONE JSON line. Every number in it was taken on the device it names
(``device``: platform, device_kind, count); with no GPU the script fails
rather than measuring something else.

Usage: python bench.py   (BENCH_NX / BENCH_LEVELS / BENCH_STEPS / BENCH_REPS
override the sizes)
"""

from __future__ import annotations

import json
import os
import sys
import time

import jax
import numpy as np

NX = int(os.environ.get("BENCH_NX", 64))
LEVELS = int(os.environ.get("BENCH_LEVELS", 100))
STEPS = int(os.environ.get("BENCH_STEPS", 2000))
REPS = int(os.environ.get("BENCH_REPS", 3))

# Published dense peaks per device kind (NVIDIA H100 data sheet, SXM part,
# at its full 700 W power limit). A card set to a lower power limit cannot
# hold these; the measured copy and matmul rates below say what it reaches.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "source": "NVIDIA H100 Tensor Core GPU data sheet (SXM5)",
        "hbm_bytes_per_s": 3.35e12,
        "bf16_flops": 989e12,
        "tf32_flops": 495e12,
        "fp32_flops": 67e12,
        "fp64_flops": 34e12,
    },
}


def published_peaks(device_kind: str) -> dict:
    """Published peak rates of ``device_kind``; an unknown device is an
    error, never a default."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {device_kind!r}; add it to "
            "bench.PEAKS with its data-sheet source"
        ) from None


def build(dtype=np.float32):
    import jax.numpy as jnp

    from mpas_ocean.mesh import planar_hex_mesh
    from mpas_ocean.mesh.mesh import Mesh
    from mpas_ocean.mesh.vert_mesh import make_vertical_mesh
    from mpas_ocean.models.shallow_water import PrognosticVars
    from mpas_ocean.verification.inertial_gravity_wave import InertialGravityWave

    dc = 10000.0e3 / NX
    horz = planar_hex_mesh(NX, NX, dc, f0=1e-4, dtype=dtype)
    igw = InertialGravityWave(lx=NX * dc / 1e3)
    vert = make_vertical_mesh(
        horz,
        n_vert_levels=LEVELS,
        resting_thickness=np.full(
            (horz.n_cells, LEVELS), igw.bottom_depth / LEVELS, dtype=dtype
        ),
        dtype=dtype,
    )
    mesh = Mesh(horz=horz, vert=vert)
    ssh, h, u = igw.initial_state(horz, LEVELS)
    prog = PrognosticVars(
        ssh=jnp.asarray(ssh.astype(dtype)),
        layer_thickness=jnp.asarray(h.astype(dtype)),
        normal_velocity=jnp.asarray(u.astype(dtype)),
    )
    # small, stable dt: forward Euler is weakly unstable for gravity waves
    # (reference behavior too); keeps the rollout finite. dt does not
    # affect throughput.
    return mesh, prog, dtype(30.0)


def build_kelvin(dtype=np.float32):
    """The reference's literal perf configuration: a coastal Kelvin wave
    in a walled channel (README.MD:45-50), as a masked lattice."""
    import jax.numpy as jnp

    from mpas_ocean.mesh import planar_hex_mesh
    from mpas_ocean.mesh.cull import cull_cells
    from mpas_ocean.mesh.mesh import Mesh
    from mpas_ocean.mesh.vert_mesh import make_vertical_mesh
    from mpas_ocean.models.shallow_water import PrognosticVars
    from mpas_ocean.structured import StructuredModel
    from mpas_ocean.verification.kelvin_wave import KelvinWave

    dc = 10000.0e3 / NX
    parent = planar_hex_mesh(NX, NX, dc, f0=1e-4, dtype=dtype)
    y = np.asarray(parent.cells.y)
    keep = (y > 0.5 * dc) & (y < y.max() - 0.5 * dc)
    chan = cull_cells(parent, keep)
    vert = make_vertical_mesh(
        chan,
        n_vert_levels=LEVELS,
        resting_thickness=np.full((chan.n_cells, LEVELS), 1000.0 / LEVELS,
                                  dtype=dtype),
        dtype=dtype,
    )
    mesh = Mesh(horz=chan, vert=vert)
    kw = KelvinWave(lx=NX * dc / 1e3, f0=1e-4)
    ssh, h, u = kw.initial_state(chan, LEVELS)
    prog = PrognosticVars(
        ssh=jnp.asarray(ssh.astype(dtype)),
        layer_thickness=jnp.asarray(h.astype(dtype)),
        normal_velocity=jnp.asarray(u.astype(dtype)),
    )
    sm = StructuredModel(mesh, NX, NX, parent_horz=parent, keep_cells=keep)
    return mesh, prog, dtype(30.0), sm


def _time_fn(run, reps) -> float:
    """Median wall time of run(); run() ends in a host readback of a value
    derived from the result, so the device work is inside the window."""
    s = run()  # compile + warm up
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        s = run()
        times.append(time.perf_counter() - t0)
    if not np.isfinite(s):
        raise FloatingPointError("benchmark state went non-finite")
    return float(np.median(times))


def measure_gather(mesh, prog, dt, steps, reps) -> float:
    """Unstructured (general-mesh gather) path."""
    from mpas_ocean.forward.run_loop import ocn_run_loop

    mesh, prog = jax.device_put((mesh, prog))

    def run():
        return float(ocn_run_loop(prog, mesh, dt, steps).ssh.sum())

    return _time_fn(run, reps)


def measure_matrix(mesh, prog, dt, steps, reps) -> float:
    """General-mesh BSR path (stencils as block-sparse matmuls)."""
    from mpas_ocean.models.matrix_model import MatrixModel, matrix_run_loop

    mm, prog = jax.device_put((MatrixModel.from_mesh(mesh), prog))

    def run():
        return float(matrix_run_loop(prog, mm, dt, steps).ssh.sum())

    return _time_fn(run, reps)


def measure_structured(sm, prog, dt, steps, reps) -> float:
    """Structured hex lattice path as the driver routes it
    (``StructuredModel.run``: the Triton step kernel for the linear core on
    the GPU)."""
    st = jax.device_put(sm.to_struct(prog))

    def run():
        return float(sm.run(st, dt, steps).ssh.sum())

    return _time_fn(run, reps)


def measure_copy_bandwidth(n_bytes: int = 2 << 30, reps: int = 5) -> float:
    """Bytes/s of a large device copy (read + write of ``n_bytes``)."""
    import jax.numpy as jnp

    x = jnp.ones((n_bytes // 4,), jnp.float32)
    f = jax.jit(lambda a: a + 1.0)

    def run():
        return float(f(x)[-1])

    return 2 * n_bytes / _time_fn(run, reps)


def measure_bf16_matmul(n: int = 8192, reps: int = 5) -> float:
    """FLOP/s of a large bf16 matrix product with f32 accumulation."""
    import jax.numpy as jnp

    a = jnp.ones((n, n), jnp.bfloat16)
    f = jax.jit(lambda x: jnp.dot(x, x, preferred_element_type=jnp.float32))

    def run():
        return float(f(a)[0, 0])

    return 2.0 * n**3 / _time_fn(run, reps)


def _prog(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def main():
    from mpas_ocean.structured import StructuredModel
    from mpas_ocean.utils.compile_cache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"bench.py measures the GPU; JAX found {dev.platform!r}"
        )
    enable_compile_cache()
    peaks = published_peaks(dev.device_kind)

    mesh, prog, dt = build()
    n_gridpoints = mesh.n_cells * LEVELS
    sm = StructuredModel(mesh, NX, NX)

    _prog("structured lattice path")
    t_roll = measure_structured(sm, prog, dt, STEPS, REPS)
    _prog("gather path")
    g_steps = max(10, STEPS // 10)
    t_gather = measure_gather(mesh, prog, dt, g_steps, REPS)
    _prog("matrix/BSR path")
    m_steps = max(10, STEPS // 10)
    t_matrix = measure_matrix(mesh, prog, dt, m_steps, REPS)
    _prog("kelvin channel")
    kmesh, kprog, kdt, ksm = build_kelvin()
    t_kelvin = measure_structured(ksm, kprog, kdt, STEPS, REPS)
    _prog("copy bandwidth and bf16 matmul")
    copy_bw = measure_copy_bandwidth()
    mm_flops = measure_bf16_matmul()

    state_bytes = sum(
        x.size * x.dtype.itemsize for x in jax.tree.leaves(sm.to_struct(prog))
    )
    value = n_gridpoints * STEPS / t_roll
    print(json.dumps({
        "metric": "gridpoints_per_sec_per_device",
        "value": value,
        "unit": "cells*levels*steps/s",
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
        "detail": {
            "config": f"{NX}x{NX} hex, {LEVELS} levels, f32",
            "structured_seconds_per_step": t_roll / STEPS,
            "structured_gridpoints_per_sec": value,
            "gather_gridpoints_per_sec": n_gridpoints * g_steps / t_gather,
            "matrix_gridpoints_per_sec": n_gridpoints * m_steps / t_matrix,
            "kelvin_channel_gridpoints_per_sec":
                kmesh.n_cells * LEVELS * STEPS / t_kelvin,
            "state_bytes": int(state_bytes),
            "measured_copy_bytes_per_sec": copy_bw,
            "measured_bf16_matmul_flops": mm_flops,
            "published_peaks": peaks,
        },
    }))


if __name__ == "__main__":
    main()
