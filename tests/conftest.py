"""Test harness configuration.

Forces the CPU backend with 8 virtual devices BEFORE jax initializes — the
JAX answer to multi-node testing without a cluster (the tier the reference
lacks entirely, SURVEY section 4): sharding/halo-exchange tests run on a
virtual 8-device mesh in CI.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

# the suite runs on the CPU (the virtual devices above) unless the caller
# names platforms explicitly, as a run of the `gpu`-marked tests on the
# card does (JAX_PLATFORMS=cuda,cpu)
if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest

from mpas_ocean.mesh import planar_hex_mesh
from mpas_ocean.mesh.mesh import Mesh
from mpas_ocean.mesh.vert_mesh import make_vertical_mesh


@pytest.fixture(scope="session")
def hex16():
    """Small hex mesh for quick structural tests."""
    return planar_hex_mesh(16, 16, 1000.0, f0=1e-4)


@pytest.fixture(scope="session")
def hex48():
    """48x48 mesh matching the reference's operator-test mesh size
    (test/ocn/test_Operators.jl:12-15)."""
    return planar_hex_mesh(48, 48, 1000.0)


@pytest.fixture(scope="session")
def mesh16(hex16):
    vert = make_vertical_mesh(hex16, n_vert_levels=1)
    return Mesh(horz=hex16, vert=vert).to_device()


@pytest.fixture(scope="session")
def mesh16_3l(hex16):
    vert = make_vertical_mesh(hex16, n_vert_levels=3)
    return Mesh(horz=hex16, vert=vert).to_device()


@pytest.fixture(scope="session")
def igw_mesh():
    """Inertial-gravity-wave setup mesh: 10000 km box (reference polaris
    configuration), coarse for test speed."""
    nx = 32
    dc = 10000.0e3 / nx
    horz = planar_hex_mesh(nx, nx, dc, f0=1e-4)
    vert = make_vertical_mesh(
        horz, n_vert_levels=1, resting_thickness=np.full((horz.n_cells, 1), 1000.0)
    )
    return Mesh(horz=horz, vert=vert).to_device()


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop compiled-executable caches at module boundaries. The full
    suite accumulates several hundred XLA CPU executables in one process;
    past ~240 the CPU backend_compile segfaulted deterministically
    (reproduced twice at the same test; every module passes in isolation).
    Clearing per module keeps the live executable count bounded at a small
    recompile cost."""
    yield
    jax.clear_caches()
