"""Cell-graph utilities: CSR adjacency, RCM ordering, BFS partitioning.

The performance path is a native C++ library (native/mesh_preprocess.cpp,
built on demand with g++ and loaded via ctypes) — the framework's native
runtime component for host-side setup at production mesh scales. A NumPy/
Python implementation with identical semantics serves as fallback and as
the reference for the parity test (tests/test_graph.py).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from functools import lru_cache

import numpy as np

__all__ = [
    "cell_adjacency_csr",
    "rcm_order",
    "greedy_partition",
    "native_available",
]

_NATIVE_SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
    "mesh_preprocess.cpp",
)


@lru_cache(maxsize=1)
def _load_native():
    """Compile (if needed) and load the native library; None on failure."""
    if not os.path.exists(_NATIVE_SRC):
        return None
    # built inside the checkout (build/ is git-ignored); written under a
    # per-process name and renamed, so concurrent test workers never load
    # a half-written library
    cache_dir = os.path.join(os.path.dirname(os.path.dirname(_NATIVE_SRC)),
                             "build", "native")
    os.makedirs(cache_dir, exist_ok=True)
    so_path = os.path.join(cache_dir, "libmeshpre.so")
    if (
        not os.path.exists(so_path)
        or os.path.getmtime(so_path) < os.path.getmtime(_NATIVE_SRC)
    ):
        tmp_path = f"{so_path}.{os.getpid()}"
        try:
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-o", tmp_path,
                 _NATIVE_SRC],
                check=True,
                capture_output=True,
            )
        except (subprocess.CalledProcessError, FileNotFoundError):
            return None
        os.replace(tmp_path, so_path)
    try:
        lib = ctypes.CDLL(so_path)
    except OSError:
        return None
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.rcm_order.argtypes = [ctypes.c_int64, i64p, i64p, i64p]
    lib.rcm_order.restype = ctypes.c_int
    lib.greedy_partition.argtypes = [ctypes.c_int64, i64p, i64p, ctypes.c_int64, i64p]
    lib.greedy_partition.restype = ctypes.c_int
    return lib


def native_available() -> bool:
    return _load_native() is not None


def cell_adjacency_csr(horz) -> tuple[np.ndarray, np.ndarray]:
    """CSR (xadj, adjncy) of the cell adjacency graph from cellsOnCell."""
    coc = np.asarray(horz.cells.cells_on_cell)
    mask = np.asarray(horz.cells.edge_mask_on_cell) > 0
    # drop degenerate self/pad links
    ids = np.arange(horz.n_cells)[:, None]
    mask = mask & (coc != ids)
    counts = mask.sum(1)
    xadj = np.zeros(horz.n_cells + 1, dtype=np.int64)
    np.cumsum(counts, out=xadj[1:])
    adjncy = coc[mask].astype(np.int64)
    return xadj, adjncy


def _rcm_python(n, xadj, adjncy):
    degree = np.diff(xadj)
    visited = np.zeros(n, dtype=bool)
    result = []
    from collections import deque

    for seed in np.argsort(degree, kind="stable"):
        if visited[seed]:
            continue
        q = deque([seed])
        visited[seed] = True
        while q:
            u = q.popleft()
            result.append(u)
            nbrs = [v for v in adjncy[xadj[u] : xadj[u + 1]] if not visited[v]]
            for v in nbrs:
                visited[v] = True
            nbrs.sort(key=lambda v: degree[v])
            q.extend(nbrs)
    return np.asarray(result[::-1], dtype=np.int64)


def rcm_order(n: int, xadj: np.ndarray, adjncy: np.ndarray) -> np.ndarray:
    """Reverse Cuthill-McKee ordering (bandwidth/locality reduction)."""
    lib = _load_native()
    xadj = np.ascontiguousarray(xadj, dtype=np.int64)
    adjncy = np.ascontiguousarray(adjncy, dtype=np.int64)
    if lib is not None:
        out = np.empty(n, dtype=np.int64)
        if lib.rcm_order(n, xadj, adjncy, out) == 0:
            return out
    return _rcm_python(n, xadj, adjncy)


def _greedy_python(n, xadj, adjncy, nparts):
    from collections import deque

    order = rcm_order(n, xadj, adjncy)
    part = np.full(n, -1, dtype=np.int64)
    cursor = 0
    for p in range(nparts):
        quota = (n * (p + 1)) // nparts - (n * p) // nparts
        q = deque()
        while quota > 0:
            if not q:
                while cursor < n and part[order[cursor]] != -1:
                    cursor += 1
                if cursor >= n:
                    break
                q.append(order[cursor])
                part[order[cursor]] = p
                quota -= 1
            u = q.popleft()
            for v in adjncy[xadj[u] : xadj[u + 1]]:
                if quota <= 0:
                    break
                if part[v] == -1:
                    part[v] = p
                    quota -= 1
                    q.append(v)
    part[part == -1] = nparts - 1
    return part


def greedy_partition(n: int, xadj, adjncy, nparts: int) -> np.ndarray:
    """Balanced BFS graph-growing partition (works on spheres and irregular
    meshes where coordinate stripes do not)."""
    lib = _load_native()
    xadj = np.ascontiguousarray(xadj, dtype=np.int64)
    adjncy = np.ascontiguousarray(adjncy, dtype=np.int64)
    if lib is not None:
        out = np.empty(n, dtype=np.int64)
        if lib.greedy_partition(n, xadj, adjncy, nparts, out) == 0:
            return out
    return _greedy_python(n, xadj, adjncy, nparts)
