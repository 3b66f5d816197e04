"""The chip smoke script and the benchmark's device table, on the CPU:
both refuse to measure anything but the GPU, and the four-device phase
runs here on virtual devices."""

import jax
import numpy as np
import pytest

import bench
import chip_smoke


def test_chip_smoke_refuses_cpu_backend(capsys):
    with pytest.raises(SystemExit, match="needs an NVIDIA GPU"):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_chip_smoke_multi_phase_on_virtual_devices():
    """The --multi phase (slab run, superstep, superstep gradient,
    unstructured ShardedModel against the single-device rollout) on four
    virtual CPU devices at a small size."""
    assert len(jax.devices()) >= 4
    assert chip_smoke.run_multi(jax, nx=16, levels=3, n_steps=4, q=2) == 12


def test_chip_smoke_compare_enforces_tolerance():
    ref = np.array([1.0, -2.0, 4.0])
    assert chip_smoke.compare("within", ref + 1e-12, ref, 1e-10, "f64") < 1e-10
    with pytest.raises(AssertionError, match="beyond"):
        chip_smoke.compare("beyond", ref + 1e-6, ref, 1e-10, "f64")
    with pytest.raises(AssertionError, match="non-finite"):
        chip_smoke.compare("nan", ref * np.nan, ref, 1e-10, "f64")


def test_bench_peaks_unknown_device_raises():
    with pytest.raises(KeyError, match="no published peaks"):
        bench.published_peaks("cpu")


def test_bench_peaks_h100_table():
    peaks = bench.published_peaks("NVIDIA H100 80GB HBM3")
    assert peaks["hbm_bytes_per_s"] == 3.35e12
    assert peaks["bf16_flops"] == 989e12
    assert "data sheet" in peaks["source"]


def test_bench_refuses_cpu_backend():
    with pytest.raises(SystemExit, match="measures the GPU"):
        bench.main()
