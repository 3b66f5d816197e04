"""Model-output vs analytic-solution comparison tool.

Python re-design of the reference's analysis script (reference:
src/compare.py: ExactSolution mirror classes, RMSE `log_error`, and the
2x3 comparison panels): reads a model output NetCDF, evaluates the analytic
solution at the stored time, reports RMSE, and optionally renders panels.

Usage:
  python -m mpas_ocean.tools.compare output.nc --case igw --lx 10000
  python -m mpas_ocean.tools.compare output.nc --case kelvin --plot cmp.png
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from ..infra.netcdf import read_netcdf
from ..verification.inertial_gravity_wave import InertialGravityWave
from ..verification.kelvin_wave import KelvinWave


def rmse(a, b):
    return float(np.sqrt(np.mean((np.asarray(a) - np.asarray(b)) ** 2)))


def _load_output(path, mesh_path=None):
    """Load (t, ssh, u, coords) from a model output file in EITHER output
    convention the reference's analysis script reads (compare.py:169-205):

      * this framework / MOKA style — a `time` variable in seconds, a `dt`
        global attribute, mesh coordinates written inline;
      * MPAS-Fortran style — an `xtime` char-array of timestamps
        ('YYYY-MM-DD_hh:mm:ss'), a capital-T `Time` record axis, and
        coordinates in a separate mesh file (pass ``mesh_path``).
    """
    from datetime import datetime

    ds = read_netcdf(path)
    if "time" in ds:
        t = float(np.atleast_1d(ds["time"])[-1])
        pick = -1 if np.ndim(ds["ssh"]) == 2 else None
    elif "xtime" in ds:
        stamps = np.atleast_1d(ds["xtime"])
        times = [
            datetime.strptime(str(s).strip(), "%Y-%m-%d_%H:%M:%S")
            for s in stamps
        ]
        t = (times[-1] - times[0]).total_seconds()
        pick = -1
    else:
        raise ValueError(f"{path}: neither 'time' nor 'xtime' present")

    ssh = ds["ssh"][pick] if pick is not None else ds["ssh"]
    u = ds["normalVelocity"]
    u = u[pick] if (pick is not None and u.ndim == 3) else u

    coords = ds
    if mesh_path is not None:
        coords = read_netcdf(mesh_path)
    elif "xCell" not in ds:
        raise ValueError(
            f"{path}: no mesh coordinates (xCell) in the output — "
            "MPAS-Fortran outputs keep them in a separate mesh file; "
            "pass --mesh <mesh.nc>"
        )
    return t, np.asarray(ssh), np.asarray(u), coords


def compare_output(path, case: str = "igw", lx: float = 10000.0, f0: float = 1e-4,
                   mesh_path=None):
    """Returns a dict of RMSEs of ssh and normalVelocity vs the analytic
    solution at the output's time. Reads both this framework's and the
    MPAS-Fortran output conventions (``mesh_path`` supplies coordinates for
    the latter)."""
    t, ssh, u, coords = _load_output(path, mesh_path)
    x_c, y_c = coords["xCell"], coords["yCell"]
    x_e, y_e, ang = coords["xEdge"], coords["yEdge"], coords["angleEdge"]

    if case == "igw":
        sol = InertialGravityWave(lx=lx, f0=f0)
    elif case == "kelvin":
        sol = KelvinWave(lx=lx, f0=f0)
    else:
        raise ValueError(f"unknown case {case!r}")

    ssh_exact = sol.exact_ssh(x_c, y_c, t)
    u_exact = sol.exact_normal_velocity(x_e, y_e, ang, t)

    result = {
        "time": t,
        "case": case,
        "rmse_ssh": rmse(ssh, ssh_exact),
        "rmse_normalVelocity": rmse(u[:, 0], u_exact),
        "rms_ssh_exact": float(np.sqrt(np.mean(ssh_exact**2))),
    }
    return result, (x_c, y_c, ssh, ssh_exact, coords)


def _cell_patches(coords):
    """Cell polygons from the output's mesh connectivity (verticesOnCell,
    1-based 0-padded, the MPAS file convention) with vertices shifted to
    the cell center's nearest periodic image so wrap-around cells draw as
    compact polygons. Returns a list of (n_i, 2) arrays, or None when the
    file lacks vertex data (e.g. a bare MPAS-Fortran output without its
    mesh file)."""
    for k in ("xVertex", "yVertex", "verticesOnCell", "nEdgesOnCell",
              "xCell", "yCell"):
        if k not in coords:
            return None
    xv = np.asarray(coords["xVertex"], dtype=np.float64)
    yv = np.asarray(coords["yVertex"], dtype=np.float64)
    voc = np.asarray(coords["verticesOnCell"], dtype=np.int64)
    nec = np.asarray(coords["nEdgesOnCell"], dtype=np.int64)
    xc = np.asarray(coords["xCell"], dtype=np.float64)
    yc = np.asarray(coords["yCell"], dtype=np.float64)
    # periodic extents estimated from the vertex cloud (plot-only)
    lx = xv.max() - xv.min() + np.diff(np.unique(np.round(xv, 6))).min()
    ly = yv.max() - yv.min() + np.diff(np.unique(np.round(yv, 6))).min()
    patches = []
    for i in range(voc.shape[0]):
        ids = voc[i, : nec[i]] - 1  # 1-based -> 0-based
        ids = ids[ids >= 0]
        px, py = xv[ids].copy(), yv[ids].copy()
        if lx > 0:
            px -= np.round((px - xc[i]) / lx) * lx
        if ly > 0:
            py -= np.round((py - yc[i]) / ly) * ly
        patches.append(np.stack([px, py], axis=1))
    return patches


def plot_comparison(fields, out_path):
    """Numeric / exact / difference panels rendered as TRUE cell patches
    (the reference's polaris plot_horiz_field panels, compare.py:132-167),
    falling back to scatter when the output carries no vertex
    connectivity."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.collections import PolyCollection

    x, y, ssh, ssh_exact = fields[:4]
    coords = fields[4] if len(fields) > 4 else {}
    patches = _cell_patches(coords)
    fig, axes = plt.subplots(1, 3, figsize=(15, 4), constrained_layout=True)
    for ax, data, title in zip(
        axes,
        (ssh, ssh_exact, ssh - ssh_exact),
        ("numerical ssh", "exact ssh", "difference"),
    ):
        if patches is not None:
            pc = PolyCollection(
                [p / 1e3 for p in patches], array=np.asarray(data),
                cmap="RdBu_r", edgecolors="none",
            )
            ax.add_collection(pc)
            ax.autoscale_view()
            fig.colorbar(pc, ax=ax)
        else:
            sc = ax.scatter(x / 1e3, y / 1e3, c=data, s=8, cmap="RdBu_r")
            fig.colorbar(sc, ax=ax)
        ax.set_title(title)
        ax.set_xlabel("x [km]")
        ax.set_ylabel("y [km]")
    fig.savefig(out_path, dpi=120)
    return out_path


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("output")
    p.add_argument("--case", default="igw", choices=["igw", "kelvin"])
    p.add_argument("--lx", type=float, default=10000.0, help="domain length [km]")
    p.add_argument("--f0", type=float, default=1e-4)
    p.add_argument("--plot", default=None, help="write comparison panels to PNG")
    p.add_argument(
        "--mesh", default=None,
        help="mesh file for coordinates (MPAS-Fortran outputs keep them "
        "in a separate file)",
    )
    args = p.parse_args(argv)

    result, fields = compare_output(
        args.output, args.case, args.lx, args.f0, mesh_path=args.mesh
    )
    if args.plot:
        result["plot"] = plot_comparison(fields, args.plot)
    print(json.dumps(result, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
