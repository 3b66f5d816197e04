"""Multi-host (multi-process) runtime scaffolding.

The reference *declares* MPI for multi-node runs but ships no distributed
code (MPI deps unused, SURVEY section 2.2; its scaling narrative at
README.MD:55-66 belongs to an ancestor project). Here
`jax.distributed.initialize` joins the processes, every device appears in
`jax.devices()`, and the same shard_map/ppermute step runs unchanged — XLA
hands neighbor transfers to NCCL, over NVLink within a host and over the
network between hosts.

Two pieces live here:
  * `init_distributed` — process bootstrap (env-var or explicit args);
  * `hybrid_device_mesh` — a 2-D ('dcn', 'ici') mesh grouping devices by
    host: 'dcn' indexes hosts (processes), 'ici' the devices within one.
    A 1-D row/cell decomposition sharded over the FLATTENED axes keeps
    ring neighbors on one host except at the P_dcn host boundaries. On a
    single host (e.g. four NVLink-joined cards) a 1-D mesh of
    `jax.devices()` is all that is needed.

Tested with 2 cooperating CPU processes on localhost
(tests/test_multihost.py); several hosts run the same code with
`num_processes`/`process_id` from the launcher environment.
"""

from __future__ import annotations

import os

import jax
import numpy as np

__all__ = ["init_distributed", "hybrid_device_mesh", "is_distributed"]

_initialized = False


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids=None,
) -> bool:
    """Join (or skip joining) the multi-process JAX runtime.

    Arguments default to the standard env vars (JAX_COORDINATOR_ADDRESS,
    JAX_NUM_PROCESSES, JAX_PROCESS_ID). Nothing is autodetected on a GPU
    host, so a multi-process run must give all three. Returns True if a
    multi-process runtime was initialized, False for the single-process
    case (nothing to do).
    """
    global _initialized
    if _initialized:
        return True
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        return False  # single-process run
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )
    _initialized = True
    return True


def is_distributed() -> bool:
    return jax.process_count() > 1


def hybrid_device_mesh(
    dcn_axis: int | None = None,
    ici_axis: int | None = None,
    devices=None,
):
    """Build a 2-D ('dcn', 'ici') jax.sharding.Mesh.

    Defaults: one 'dcn' group per process (host), all of a process's
    devices on its 'ici' axis. Ring neighbors along the flattened ('dcn', 'ici') order stay
    within a group except at the P_dcn group boundaries.
    """
    from jax.sharding import Mesh

    devices = list(devices if devices is not None else jax.devices())
    if dcn_axis is None:
        dcn_axis = max(1, jax.process_count())
    if ici_axis is None:
        ici_axis = len(devices) // dcn_axis
    if dcn_axis * ici_axis != len(devices):
        raise ValueError(
            f"{dcn_axis} x {ici_axis} != {len(devices)} devices"
        )
    if dcn_axis > 1:
        # group by process so the ici axis is intra-host
        devices = sorted(devices, key=lambda d: (d.process_index, d.id))
    arr = np.array(devices).reshape(dcn_axis, ici_axis)
    return Mesh(arr, ("dcn", "ici"))
