"""Quickest proof that the ocean core runs on an NVIDIA GPU.

    python chip_smoke.py           one card: phases a-e below
    python chip_smoke.py --multi   four cards: the domain-decomposed paths,
                                   each against the single-device rollout

Phases on one card:
  a. device check: JAX's default backend must be the GPU (no fallback).
  b. the CLI driver (`forward.driver.main`) on an inertial-gravity-wave
     case at 512x512 cells x 100 levels in f64, once by `--path auto` (the
     lattice rollout, which on the GPU runs the Triton step kernel) and
     once by `--path gather` (the general-mesh loop); their final ssh /
     layerThickness / normalVelocity must agree.
  c. the driver's `--ad` run on the same case: one adjoint entry of
     d(sum ssh^2)/d(layerThickness) against a central finite difference.
  d. the reference's headline configuration, 64x64 x 100 levels in f32:
     the routed lattice rollout, BSR matrix path and gather path against
     each other.
  e. the Triton lattice-step kernel against the XLA roll rollout at
     64x64 and 256x256 x 100 levels f32: agreement, then both timed in
     turns (the kernel is routed only while it wins at both sizes).

Each comparison prints its measured difference, tolerance and precision;
compile seconds are printed per phase, with the step's memory analysis and
the peak device memory. A failed comparison or phase raises, so the script
exits non-zero. The last stdout line is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")

# phase b: final-state agreement of the roll and gather formulations in f64.
# Both evaluate the same arithmetic in a different order; the difference is
# roundoff that grows with the step count (1e-12 relative after 20 steps at
# 64x64x100 on the CPU, dominated by ssh = sum(h) - sum(h_rest), which
# cancels a 1000 m column to O(1 m)). 1e-10 leaves two orders of headroom
# and still catches any formulation error, which shows at 1e-4 or above.
RTOL_F64 = 1e-10
# phase c: the reference's end-to-end adjoint check tolerance on
# d/d(layerThickness) (test/enzyme/test_Enzyme_end2end.jl:179-185)
ATOL_ADJOINT = 1e-4
# phase d: f32 formulations against each other, every matmul at
# Precision.HIGHEST (no TF32). The CPU shows 2.4e-4 (ssh), 1.9e-7 (h) and
# 3.3e-5 (u) max-norm relative after 20 steps; ssh is the worst for the
# same cancellation as above (f32 epsilon x 1000 m / 1 m per step). The
# bounds allow about 8x that for the GPU's different summation order and
# FMA contraction.
RTOL_F32 = {"ssh": 2e-3, "layerThickness": 2e-6, "normalVelocity": 3e-4}
# --multi: the sharded paths against the single-device rollout, f64
RTOL_MULTI = 1e-10

FIELDS = ("ssh", "layerThickness", "normalVelocity")


def gpu_query() -> str:
    """`nvidia-smi` name and power limit, read by a child that stays off
    JAX."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip()


def require_gpu(jax, n_devices: int = 1):
    """Phase a: refuse any backend but the GPU, and too few devices."""
    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(
            f"chip_smoke needs an NVIDIA GPU; JAX's default backend is "
            f"{backend!r}"
        )
    if len(jax.devices()) < n_devices:
        raise SystemExit(
            f"chip_smoke needs {n_devices} GPUs; found {len(jax.devices())}"
        )


class CompileClock:
    """Sums XLA backend-compile seconds reported by jax.monitoring."""

    def __init__(self, jax):
        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            self.total += duration

    def lap(self, start: float) -> float:
        return self.total - start


def compare(label, got, ref, rtol, precision, scale=None):
    """Max-norm relative difference |got - ref|_inf / scale <= rtol, where
    ``scale`` defaults to |ref|_inf."""
    import numpy as np

    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    if got.shape != ref.shape:
        raise AssertionError(f"{label}: shape {got.shape} != {ref.shape}")
    if not (np.isfinite(got).all() and np.isfinite(ref).all()):
        raise AssertionError(f"{label}: non-finite values")
    denom = "max|ref|" if scale is None else f"{scale:.3e}"
    if scale is None:
        scale = float(np.abs(ref).max())
    rel = float(np.abs(got - ref).max()) / max(scale,
                                               np.finfo(np.float64).tiny)
    ok = rel <= rtol
    print(f"  {label}: max|diff|/{denom} = {rel:.3e} "
          f"(tolerance {rtol:.0e}, {precision}) {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise AssertionError(f"{label}: {rel:.3e} > {rtol:.0e}")
    return rel


def igw_lattice(nx: int, levels: int, dtype):
    """A periodic nx x nx hex mesh with the inertial-gravity-wave initial
    state (the reference's verification case), placed on the device."""
    import jax.numpy as jnp
    import numpy as np

    from mpas_ocean.mesh import planar_hex_mesh
    from mpas_ocean.mesh.mesh import Mesh
    from mpas_ocean.mesh.vert_mesh import make_vertical_mesh
    from mpas_ocean.models.shallow_water import PrognosticVars
    from mpas_ocean.verification.inertial_gravity_wave import (
        InertialGravityWave,
    )

    dc = 10000.0e3 / nx
    horz = planar_hex_mesh(nx, nx, dc, f0=1e-4, dtype=dtype)
    igw = InertialGravityWave(lx=nx * dc / 1e3)
    vert = make_vertical_mesh(
        horz, n_vert_levels=levels,
        resting_thickness=np.full((horz.n_cells, levels),
                                  igw.bottom_depth / levels, dtype=dtype),
        dtype=dtype,
    )
    mesh = Mesh(horz=horz, vert=vert).to_device()
    ssh, h, u = igw.initial_state(horz, levels)
    prog = PrognosticVars(
        ssh=jnp.asarray(ssh.astype(dtype)),
        layer_thickness=jnp.asarray(h.astype(dtype)),
        normal_velocity=jnp.asarray(u.astype(dtype)),
    )
    # the reference's dt heuristic (init.jl:117-119)
    return mesh, prog, float(np.floor(2.0 * (dc / 1e3) * dc / 200e3))


def read_state(path):
    from mpas_ocean.infra.netcdf import read_netcdf

    data = read_netcdf(path)
    return {k: data.variables[k][0] for k in data.variables}


def phase_driver(jax, clock, nx=512, levels=100, n_steps=20):
    """Phases b and c through the CLI driver; returns the number of
    comparisons made."""
    import numpy as np

    from mpas_ocean.forward import driver
    from mpas_ocean.forward.init import ocn_init, ocn_init_alarms, plan_steps
    from mpas_ocean.forward.run_loop import ocn_run_loop
    from mpas_ocean.structured import StructuredModel
    from mpas_ocean.tools.cases import make_igw_case

    case = os.path.join(WORK, f"igw{nx}x{levels}")
    shutil.rmtree(case, ignore_errors=True)
    t0 = time.perf_counter()
    resolution_km = 200.0
    dt = float(np.floor(2.0 * resolution_km * resolution_km * 1e3 / 200e3))
    cfg = make_igw_case(case, nx=nx, resolution_km=resolution_km,
                        n_vert_levels=levels, duration_seconds=n_steps * dt)
    out_fp = os.path.join(case, "output.nc")
    print(f"phase b: IGW case {nx}x{nx} x {levels} levels f64, {n_steps} "
          f"steps of {dt:.0f} s (generated in "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)

    results = {}
    for path in ("auto", "gather"):
        c0, t0 = clock.total, time.perf_counter()
        if driver.main(["--path", path, cfg]) != 0:
            raise RuntimeError(f"driver --path {path} failed")
        results[path] = read_state(out_fp)
        print(f"phase b: --path {path}: {time.perf_counter() - t0:.1f} s "
              f"wall, {clock.lap(c0):.1f} s compile", flush=True)
    n = 0
    for f in FIELDS:
        compare(f"phase b auto vs gather {f}", results["auto"][f],
                results["gather"][f], RTOL_F64, "f64")
        n += 1

    # the routed lattice rollout's memory analysis at this size, and the
    # peak so far
    setup, prog = ocn_init(cfg)
    sm = StructuredModel(setup.mesh, nx, nx)
    st = sm.to_struct(prog)
    compiled = jax.jit(sm.run, static_argnums=2).lower(
        st, np.float64(dt), n_steps
    ).compile()
    print(f"phase b: lattice rollout memory_analysis: "
          f"{compiled.memory_analysis()}", flush=True)
    stats = jax.devices()[0].memory_stats() or {}
    print(f"phase b: peak_bytes_in_use = {stats.get('peak_bytes_in_use')}",
          flush=True)

    c0, t0 = clock.total, time.perf_counter()
    if driver.main(["--ad", cfg]) != 0:
        raise RuntimeError("driver --ad failed")
    adj = read_state(out_fp)
    print(f"phase c: --ad: {time.perf_counter() - t0:.1f} s wall, "
          f"{clock.lap(c0):.1f} s compile", flush=True)
    compare("phase c --ad final ssh vs --path gather", adj["ssh"],
            results["gather"]["ssh"], RTOL_F64, "f64")
    n += 1

    # the driver's own dt and step count (it re-derives dt from the mesh
    # spacing, as the reference does)
    clk, _, _ = ocn_init_alarms(setup)
    steps, _ = plan_steps(clk)
    dt_run = np.float64(clk.time_step.total_seconds())
    h0 = np.asarray(prog.layer_thickness)
    rng = np.random.default_rng(0)
    cell, level = int(rng.integers(h0.shape[0])), int(rng.integers(levels))

    def objective(h):
        # the adjoint treats ssh as an input of its own, so only h moves
        p = prog.replace(layer_thickness=jax.numpy.asarray(h))
        out = ocn_run_loop(p, setup.mesh, dt_run, steps, setup.integrator)
        return float(jax.numpy.sum(out.ssh * out.ssh))

    eps = 1e-3
    hp, hm = h0.copy(), h0.copy()
    hp[cell, level] += eps
    hm[cell, level] -= eps
    fd = (objective(hp) - objective(hm)) / (2 * eps)
    ad = float(adj["d_layerThickness"][cell, level])
    ok = abs(ad - fd) <= ATOL_ADJOINT
    print(f"  phase c dJ/dh[{cell},{level}]: adjoint {ad:.9e}, central "
          f"difference (eps {eps:g}) {fd:.9e}, |diff| {abs(ad - fd):.3e} "
          f"(tolerance {ATOL_ADJOINT:g} absolute, f64) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("phase c adjoint disagrees with central "
                             "difference")
    n += 1
    stats = jax.devices()[0].memory_stats() or {}
    print(f"phase c: peak_bytes_in_use = {stats.get('peak_bytes_in_use')}",
          flush=True)
    shutil.rmtree(case, ignore_errors=True)
    return n


def phase_headline(jax, clock, nx=64, levels=100, n_steps=20):
    """Phase d: the f32 headline configuration on three formulations."""
    import numpy as np

    from mpas_ocean.forward.run_loop import ocn_run_loop
    from mpas_ocean.models.matrix_model import MatrixModel, matrix_run_loop
    from mpas_ocean.structured import StructuredModel

    c0, t0 = clock.total, time.perf_counter()
    mesh, prog, dt = igw_lattice(nx, levels, np.float32)
    dt = np.float32(dt)
    sm = StructuredModel(mesh, nx, nx)
    outs = {
        "lattice": sm.from_struct(sm.run(sm.to_struct(prog), dt, n_steps)),
        "matrix": matrix_run_loop(
            prog, MatrixModel.from_mesh(mesh, dtype=np.float32), dt,
            n_steps),
        "gather": ocn_run_loop(prog, mesh, dt, n_steps),
    }
    jax.block_until_ready(outs)
    print(f"phase d: {nx}x{nx} x {levels} levels f32, {n_steps} steps on "
          f"three paths: {time.perf_counter() - t0:.1f} s wall, "
          f"{clock.lap(c0):.1f} s compile", flush=True)
    n = 0
    for a, b in (("lattice", "gather"), ("matrix", "gather"),
                 ("lattice", "matrix")):
        for f, attr in zip(FIELDS, ("ssh", "layer_thickness",
                                    "normal_velocity")):
            compare(f"phase d {a} vs {b} {f}", getattr(outs[a], attr),
                    getattr(outs[b], attr), RTOL_F32[f],
                    "f32, matmuls at Precision.HIGHEST")
            n += 1
    return n


def phase_triton(jax, clock, sizes=(64, 256), levels=100, n_check=20,
                 n_time=500, reps=5):
    """Phase e: the Triton lattice-step kernel, compiled for the card, against
    the XLA roll rollout at f32 — agreement after n_check steps, then both
    timed end to end in turns (xla, triton, triton, xla) per size."""
    import re

    import numpy as np

    from mpas_ocean.structured import StructuredModel
    from mpas_ocean.structured.model import structured_run_loop
    from mpas_ocean.structured.triton_step import triton_run_loop

    n = 0
    for nx in sizes:
        c0 = clock.total
        mesh, prog, dt = igw_lattice(nx, levels, np.float32)
        dt = np.float32(dt)
        sm = StructuredModel(mesh, nx, nx)
        st, smesh = sm.to_struct(prog), sm.struct_mesh
        ref = structured_run_loop(st, smesh, dt, n_check)
        out = triton_run_loop(st, smesh, dt, n_check)
        for f, attr in zip(FIELDS, ("ssh", "layer_thickness",
                                    "normal_velocity")):
            compare(f"phase e {nx}x{nx} triton vs xla {f}",
                    getattr(out, attr), getattr(ref, attr), RTOL_F32[f],
                    "f32")
            n += 1
        hlo = structured_run_loop.lower(st, smesh, dt, n_time).compile()
        fusions = len(re.findall(r"= [^=]*\bfusion\(", hlo.as_text()))
        runs = {
            "xla": lambda: structured_run_loop(st, smesh, dt, n_time),
            "triton": lambda: triton_run_loop(st, smesh, dt, n_time),
        }
        for fn in runs.values():
            jax.block_until_ready(fn())
        times = {"xla": [], "triton": []}
        for _ in range(reps):
            for name in ("xla", "triton", "triton", "xla"):
                t0 = time.perf_counter()
                jax.block_until_ready(runs[name]())
                times[name].append((time.perf_counter() - t0) / n_time)
        med = {k: float(np.median(v)) for k, v in times.items()}
        print(f"phase e {nx}x{nx}x{levels} f32: xla {med['xla'] * 1e6:.2f} "
              f"us/step, triton {med['triton'] * 1e6:.2f} us/step "
              f"(medians of {2 * reps}, {n_time}-step rollouts; "
              f"xla/triton = {med['xla'] / med['triton']:.3f}); XLA module "
              f"has {fusions} fusions; compile {clock.lap(c0):.1f} s",
              flush=True)
    return n


def run_multi(jax, nx=512, levels=100, n_steps=8, q=4, dtype=None):
    """Four devices: the slab model's `run`, the XLA superstep, the
    superstep objective's gradient and the unstructured ShardedModel, each
    gathered and compared with the single-device rollout of the same
    state. Returns the number of comparisons."""
    import jax.numpy as jnp
    import numpy as np

    from mpas_ocean.forward.run_loop import ocn_run_loop
    from mpas_ocean.parallel import ShardedModel
    from mpas_ocean.structured import (
        ShardedStructuredModel,
        StructuredModel,
        structured_rollout_diff,
    )
    from mpas_ocean.structured.model import structured_run_loop

    dtype = dtype or np.float64
    devices = jax.devices()[:4]
    t0 = time.perf_counter()
    mesh, prog, dt = igw_lattice(nx, levels, dtype)
    dt = dtype(dt)
    sm = StructuredModel(mesh, nx, nx)
    st = sm.to_struct(prog)
    smesh = sm.struct_mesh
    print(f"multi: {nx}x{nx} x {levels} levels {np.dtype(dtype).name}, "
          f"{n_steps} steps, {len(devices)} devices (built in "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)

    ref = structured_run_loop(st, smesh, dt, n_steps)
    ssm = ShardedStructuredModel(smesh, devices=devices)
    slab = ssm.gather(ssm.run(ssm.scatter(st), dt, n_steps))
    sup = ssm.gather(ssm.run_superstep(ssm.scatter(st), dt, n_steps, q=q))
    n = 0
    for label, out in (("slab run", slab), (f"superstep q={q}", sup)):
        for f, attr in zip(FIELDS, ("ssh", "layer_thickness",
                                    "normal_velocity")):
            compare(f"multi {label} vs single-device {f}",
                    getattr(out, attr), getattr(ref, attr), RTOL_MULTI,
                    np.dtype(dtype).name)
            n += 1

    gref = jax.grad(lambda s: jnp.sum(
        structured_rollout_diff(s, smesh, dt, n_steps).ssh ** 2))(st)
    g = ssm.gather(jax.grad(
        lambda loc: ssm.objective_superstep(loc, dt, n_steps, q=q)
    )(ssm.scatter(st)))
    # the gradient is one vector over the three fields, so it is compared
    # against its largest entry: the ssh part alone is small (ssh enters
    # only through the pressure gradient, so its cotangent is a difference
    # of neighbouring velocity cotangents) and shrinks with resolution, and
    # its own max-norm turns f64 roundoff of ~1e-13 into 1e-8 at 512x512
    attrs = ("ssh", "layer_thickness", "normal_velocity")
    gscale = max(float(jnp.abs(getattr(gref, a)).max()) for a in attrs)
    for f, attr in zip(FIELDS, attrs):
        compare(f"multi superstep objective grad vs single-device {f}",
                getattr(g, attr), getattr(gref, attr), RTOL_MULTI,
                np.dtype(dtype).name, scale=gscale)
        n += 1

    uref = ocn_run_loop(prog, mesh, dt, n_steps)
    usm = ShardedModel(mesh, devices=devices)
    uout = usm.gather(usm.run(usm.scatter(prog), dt, n_steps))
    for f, attr in zip(FIELDS, ("ssh", "layer_thickness",
                                "normal_velocity")):
        compare(f"multi unstructured ShardedModel vs single-device {f}",
                getattr(uout, attr), getattr(uref, attr), RTOL_MULTI,
                np.dtype(dtype).name)
        n += 1
    return n


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--multi", action="store_true",
                   help="run only the four-device phase")
    args = p.parse_args(argv)

    import jax

    from mpas_ocean.utils.compile_cache import enable_compile_cache

    require_gpu(jax, 4 if args.multi else 1)
    print(f"nvidia-smi: {gpu_query()}", flush=True)
    print(f"compile cache: {enable_compile_cache()}", flush=True)
    clock = CompileClock(jax)
    t0 = time.perf_counter()
    if args.multi:
        n = run_multi(jax)
    else:
        n = (phase_driver(jax, clock) + phase_headline(jax, clock)
             + phase_triton(jax, clock))
    stats = jax.devices()[0].memory_stats() or {}
    print(f"{n} comparisons passed in {time.perf_counter() - t0:.1f} s; "
          f"compile {clock.total:.1f} s; peak_bytes_in_use "
          f"{stats.get('peak_bytes_in_use')}", flush=True)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
