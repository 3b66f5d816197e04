"""Minimal NetCDF layer with no external NetCDF dependency.

The reference reads/writes NetCDF through NCDatasets.jl (reference:
src/infra/MPASMesh/HorzMesh.jl:336, src/infra/OutPut.jl). This environment
has neither netCDF4 nor xarray, so we provide a small abstraction over
  * scipy.io.netcdf_file  — NetCDF-3 classic (read + write), and
  * h5py                  — NetCDF-4/HDF5 files (read-only subset),
which covers every MPAS mesh/state file format in practice.
"""

from __future__ import annotations

import os
from typing import Any, Mapping

import numpy as np


class NCData:
    """A loaded NetCDF dataset: dims, variables (as numpy arrays), attrs."""

    def __init__(self, dims: dict, variables: dict, attrs: dict):
        self.dims = dims
        self.variables = variables
        self.attrs = attrs

    def __contains__(self, name: str) -> bool:
        return name in self.variables

    def __getitem__(self, name: str) -> np.ndarray:
        return self.variables[name]


def _join_char_array(data: np.ndarray):
    """Join a NetCDF char array (MPAS xtime timestamps) over its trailing
    StrLen axis into python strings per leading record."""
    flat = data.reshape(-1, data.shape[-1]) if data.ndim > 1 else data[None]
    strings = np.array([b"".join(row).decode().strip("\x00 ") for row in flat])
    return strings.reshape(data.shape[:-1]) if data.ndim > 1 else strings[0]


def _read_netcdf3(path: str) -> NCData:
    from scipy.io import netcdf_file

    with netcdf_file(path, "r", mmap=False) as f:
        dims = dict(f.dimensions)
        variables = {}
        for name, var in f.variables.items():
            data = np.array(var[:])  # copy out of the closed file
            if data.dtype.kind == "S":
                variables[name] = _join_char_array(data)
                continue
            variables[name] = data
        attrs = {
            k: (v.decode() if isinstance(v, bytes) else v)
            for k, v in f._attributes.items()
        }
    return NCData(dims, variables, attrs)


def _read_netcdf4(path: str) -> NCData:
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            f"{path} is a NetCDF-4/HDF5 file, and reading it needs h5py, "
            "which is not installed; NetCDF-3 classic files need only scipy"
        ) from e

    dims: dict[str, int] = {}
    variables: dict[str, np.ndarray] = {}
    with h5py.File(path, "r") as f:
        attrs = {
            k: (v.decode() if isinstance(v, bytes) else v)
            for k, v in f.attrs.items()
            if not k.startswith("_")
        }
        for name, item in f.items():
            if not isinstance(item, h5py.Dataset):
                continue
            if item.attrs.get("CLASS") == b"DIMENSION_SCALE":
                dims[name] = item.shape[0] if item.shape else int(item[()])
            else:
                data = item[...]
                if getattr(data, "dtype", None) is not None and data.dtype.kind == "S":
                    data = _join_char_array(np.asarray(data))
                variables[name] = data
        # recover dims from DIMENSION_LIST attachments when present
        for name, item in f.items():
            if isinstance(item, h5py.Dataset) and "DIMENSION_LIST" in item.attrs:
                for ax, refs in enumerate(item.attrs["DIMENSION_LIST"]):
                    for ref in refs:
                        dname = f[ref].name.lstrip("/").replace("phony_dim_", "dim")
                        dims.setdefault(dname, item.shape[ax])
    return NCData(dims, variables, attrs)


def read_netcdf(path: str | os.PathLike) -> NCData:
    """Read a NetCDF file (classic via scipy, HDF5-based via h5py)."""
    path = os.fspath(path)
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic[:3] == b"CDF":
        return _read_netcdf3(path)
    if magic == b"\x89HDF":
        return _read_netcdf4(path)
    raise ValueError(f"{path}: not a recognized NetCDF file (magic {magic!r})")


def write_netcdf(
    path: str | os.PathLike,
    dims: Mapping[str, int],
    variables: Mapping[str, tuple[tuple[str, ...], np.ndarray]],
    attrs: Mapping[str, Any] | None = None,
) -> None:
    """Write a NetCDF-3 classic file.

    ``variables`` maps name -> (dim-name tuple, array).
    """
    from scipy.io import netcdf_file

    with netcdf_file(os.fspath(path), "w") as f:
        for name, size in dims.items():
            f.createDimension(name, size)
        for name, value in (attrs or {}).items():
            setattr(f, name, value)
        for name, (vdims, data) in variables.items():
            data = np.asarray(data)
            var = f.createVariable(name, data.dtype, vdims)
            var[:] = data
