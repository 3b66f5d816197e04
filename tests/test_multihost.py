"""Multi-process (multi-host analogue) execution test: two cooperating
processes on localhost, each owning 4 virtual CPU devices, forming the 2x4
('dcn', 'ici') hybrid mesh — the code path a run over several hosts
takes via jax.distributed (the reference declares MPI but ships no
distributed code, SURVEY section 2.2)."""

import os
import socket
import subprocess
import sys

import pytest

_WORKER = os.path.join(os.path.dirname(__file__), "multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_sharded_rollout():
    port = _free_port()
    env = {
        k: v
        for k, v in os.environ.items()
        if k not in ("XLA_FLAGS", "JAX_PLATFORMS")
    }
    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, str(pid), str(port)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env,
            cwd=os.path.dirname(os.path.dirname(_WORKER)),
        )
        for pid in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=540)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multihost workers timed out")
    for p, out in zip(procs, outs):
        if p.returncode != 0 and (
            "UNIMPLEMENTED" in out or "does not support" in out
        ):
            pytest.skip(f"multi-process CPU collectives unavailable: {out[-400:]}")
        assert p.returncode == 0, out[-4000:]
        assert "MULTIHOST_OK" in out, out[-4000:]
