"""NetCDF round-trip, config-driven init, driver end-to-end, restart."""

import os

import numpy as np
import pytest

from mpas_ocean.forward.driver import ocn_run
from mpas_ocean.forward.init import ocn_init, plan_steps
from mpas_ocean.infra.netcdf import read_netcdf
from mpas_ocean.mesh.io import read_mpas_mesh, save_mpas_mesh
from mpas_ocean.ops import tangential_reconstruction
from mpas_ocean.tools import make_igw_case
from mpas_ocean.verification.inertial_gravity_wave import InertialGravityWave


@pytest.fixture(scope="module")
def igw_case(tmp_path_factory):
    d = tmp_path_factory.mktemp("igw_case")
    cfg = make_igw_case(
        d, nx=16, resolution_km=200.0, duration_seconds=4000,
        output_interval_seconds=2000,
    )
    return str(d), cfg


def test_mesh_roundtrip(hex16, tmp_path):
    path = tmp_path / "mesh.nc"
    save_mpas_mesh(path, hex16)
    m2 = read_mpas_mesh(path)
    assert m2.n_cells == hex16.n_cells
    np.testing.assert_allclose(
        np.asarray(m2.edges.dc_edge), np.asarray(hex16.edges.dc_edge)
    )
    np.testing.assert_array_equal(
        np.asarray(m2.cells.edges_on_cell), np.asarray(hex16.cells.edges_on_cell)
    )
    np.testing.assert_allclose(
        np.asarray(m2.cells.edge_sign_on_cell),
        np.asarray(hex16.cells.edge_sign_on_cell),
    )
    # weights survive and still reconstruct uniform flow exactly
    ang = np.asarray(m2.edges.angle_edge)
    u = 2.0 * np.cos(ang) - 1.0 * np.sin(ang)
    t_exact = -2.0 * np.sin(ang) - 1.0 * np.cos(ang)
    t_num = np.asarray(tangential_reconstruction(u[:, None], m2))[:, 0]
    np.testing.assert_allclose(t_num, t_exact, atol=1e-12)


def test_ocn_init(igw_case):
    d, cfg = igw_case
    setup, prog = ocn_init(cfg)
    assert setup.mesh.n_cells == 16 * 16
    assert prog.layer_thickness.shape == (16 * 16, 1)
    # dt from config (400s for 200km, mpas heuristic), 10 steps
    n_steps, every = plan_steps(setup.time_manager)
    assert n_steps == 10
    assert every == 5


def test_driver_end_to_end(igw_case):
    d, cfg = igw_case
    setup, prog = ocn_run(cfg)
    out_fp = os.path.join(d, "output.nc")
    assert os.path.exists(out_fp)
    out = read_netcdf(out_fp)
    assert out.attrs["dt"] == 400.0
    assert out["time"][0] == 4000.0
    np.testing.assert_allclose(out["ssh"][0], np.asarray(prog.ssh))

    igw = InertialGravityWave(lx=16 * 200.0)
    xc = np.asarray(setup.mesh.cells.x)
    yc = np.asarray(setup.mesh.cells.y)
    rmse = np.sqrt(np.mean((out["ssh"][0] - igw.exact_ssh(xc, yc, 4000.0)) ** 2))
    assert rmse < 0.4  # very coarse 16x16 sanity gate

    # periodic snapshot written at the mid-run output alarm
    assert os.path.exists(os.path.join(d, "output.0000.nc"))


def test_restart(igw_case, tmp_path):
    """Improvement over the reference (restart raises 'not yet supported',
    PrognosticVars.jl:62-65): a run restarted from a prior output matches a
    straight-through run."""
    d, _ = igw_case
    case = tmp_path / "restart_case"
    import shutil

    cfg1 = make_igw_case(case, nx=16, resolution_km=200.0, duration_seconds=2000)
    _, prog_half = ocn_run(cfg1)
    # keep the half-run state as the restart file before it gets overwritten
    shutil.copy(case / "output.nc", case / "restart.nc")

    # full run: 4000s in one go
    cfg2 = make_igw_case(case, nx=16, resolution_km=200.0, duration_seconds=4000)
    _, prog_full = ocn_run(cfg2)
    cfg3 = make_igw_case(case, nx=16, resolution_km=200.0, duration_seconds=2000)
    text = open(cfg3).read().replace(
        "config_do_restart: false", "config_do_restart: true"
    )
    open(cfg3, "w").write(text)
    _, prog_restart = ocn_run(cfg3)

    np.testing.assert_allclose(
        np.asarray(prog_restart.ssh), np.asarray(prog_full.ssh), atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(prog_restart.normal_velocity),
        np.asarray(prog_full.normal_velocity),
        atol=1e-12,
    )


def test_driver_ad_run(igw_case):
    """--ad driver: full rollout + adjoint of sum(ssh^2), shadows persisted
    (reference: test_Enzyme_end2end.jl writes d_Prog via write_netcdf)."""
    from mpas_ocean.forward.driver import ocn_run_with_ad

    d, cfg = igw_case
    setup, final, d_prog, obj = ocn_run_with_ad(cfg, use_config_dt=True)
    assert obj == pytest.approx(float(np.sum(np.asarray(final.ssh) ** 2)), rel=1e-12)

    out = read_netcdf(os.path.join(d, "output.nc"))
    for name, ref in (
        ("d_ssh", d_prog.ssh),
        ("d_layerThickness", d_prog.layer_thickness),
        ("d_normalVelocity", d_prog.normal_velocity),
    ):
        np.testing.assert_allclose(
            np.asarray(out[name][0]).reshape(np.asarray(ref).shape),
            np.asarray(ref),
            atol=1e-12,
        )
    assert np.abs(np.asarray(d_prog.layer_thickness)).max() > 0


def test_culled_mesh_roundtrip_masks_vertex_signs(tmp_path):
    """Re-read culled channel meshes must keep edge_sign_on_vertex == 0 on
    padded edgesOnVertex slots (otherwise the curl at boundary vertices of
    re-read meshes is garbage)."""
    from mpas_ocean.mesh import planar_hex_mesh
    from mpas_ocean.mesh.cull import cull_cells

    horz = planar_hex_mesh(16, 16, 1000.0, f0=1e-4)
    y = np.asarray(horz.cells.y)
    keep = (y > 500.0) & (y < y.max() - 500.0)
    chan = cull_cells(horz, keep)
    path = tmp_path / "chan.nc"
    save_mpas_mesh(path, chan)
    m2 = read_mpas_mesh(path)

    s0 = np.asarray(chan.duals.edge_sign_on_vertex)
    s2 = np.asarray(m2.duals.edge_sign_on_vertex)
    assert (s0 == 0).any()  # boundary vertices exist
    np.testing.assert_array_equal(s2, s0)
    # and the curl operator agrees between original and re-read mesh
    import jax.numpy as jnp

    from mpas_ocean.mesh.mesh import Mesh
    from mpas_ocean.mesh.vert_mesh import make_vertical_mesh
    from mpas_ocean.ops import curl_on_vertex

    u = np.random.default_rng(0).normal(size=(chan.n_edges, 1))
    va = make_vertical_mesh(chan, 1)
    ca = curl_on_vertex(jnp.asarray(u), Mesh(horz=chan, vert=va).to_device())
    cb = curl_on_vertex(jnp.asarray(u), Mesh(horz=m2, vert=va).to_device())
    np.testing.assert_allclose(np.asarray(ca), np.asarray(cb), atol=1e-14)


def _netcdf3_to_hdf5(src, dst):
    """Rewrite a NetCDF-3 file as an HDF5/NetCDF-4-style file (dimension
    scales + DIMENSION_LIST), to exercise the h5py read branch."""
    import h5py

    from mpas_ocean.infra.netcdf import read_netcdf as _read

    ds = _read(src)
    # copy the RAW variable data (char variables stay S1 arrays — the layout
    # real NetCDF-4 files have) and dim names from the scipy reader
    from scipy.io import netcdf_file

    with netcdf_file(str(src), "r", mmap=False) as f:
        var_dims = {k: v.dimensions for k, v in f.variables.items()}
        raw = {k: np.array(v[:]) for k, v in f.variables.items()}
    with h5py.File(dst, "w") as h:
        for name, size in ds.dims.items():
            d = h.create_dataset(name, data=np.zeros(size or 1))
            d.make_scale(name)
        for name, arr in raw.items():
            v = h.create_dataset(name, data=arr)
            for ax, dname in enumerate(var_dims[name]):
                v.dims[ax].attach_scale(h[dname])
        for k, val in ds.attrs.items():
            h.attrs[k] = val


def test_netcdf4_h5py_read_branch(hex16, tmp_path):
    """The HDF5/NetCDF-4 read path (infra/netcdf._read_netcdf4) must load a
    mesh identically to the NetCDF-3 path."""
    pytest.importorskip("h5py")
    p3 = tmp_path / "mesh3.nc"
    p4 = tmp_path / "mesh4.nc"
    save_mpas_mesh(p3, hex16)
    _netcdf3_to_hdf5(p3, p4)

    ds4 = read_netcdf(p4)
    assert ds4.dims.get("nCells") == hex16.n_cells

    m3 = read_mpas_mesh(p3)
    m4 = read_mpas_mesh(p4)
    assert m4.n_cells == m3.n_cells
    np.testing.assert_array_equal(
        np.asarray(m4.cells.edges_on_cell), np.asarray(m3.cells.edges_on_cell)
    )
    np.testing.assert_allclose(
        np.asarray(m4.edges.weights_on_edge),
        np.asarray(m3.edges.weights_on_edge),
    )
    np.testing.assert_allclose(
        np.asarray(m4.duals.edge_sign_on_vertex),
        np.asarray(m3.duals.edge_sign_on_vertex),
    )


def test_plan_steps_rejects_calendar_output_interval():
    """Calendar-period (months/years) output intervals must fail loudly
    instead of silently degrading to end-only output."""
    from datetime import datetime, timedelta

    from mpas_ocean.infra.time_manager import CalendarPeriod

    from mpas_ocean.infra.time_manager import (
        Clock,
        OneTimeAlarm,
        PeriodicAlarm,
    )

    t0 = datetime(2000, 1, 1)
    clock = Clock(t0, timedelta(seconds=600))
    clock.attach_alarm(OneTimeAlarm("simulation_end", t0 + timedelta(days=2)))
    clock.attach_alarm(
        PeriodicAlarm("outputAlarm", CalendarPeriod(months=1), t0)
    )
    with pytest.raises(ValueError, match="calendar period"):
        plan_steps(clock)


def test_compare_reads_mpas_fortran_convention(tmp_path):
    """compare_output must read MPAS-Fortran-style outputs (xtime char
    timestamps, Time record axis, coordinates in a separate mesh file) —
    the second convention the reference's analysis script handles
    (reference: src/compare.py:169-205)."""
    import jax.numpy as jnp

    from mpas_ocean.infra.netcdf import write_netcdf
    from mpas_ocean.mesh import planar_hex_mesh
    from mpas_ocean.mesh.vert_mesh import make_vertical_mesh
    from mpas_ocean.tools.compare import compare_output
    from mpas_ocean.verification.inertial_gravity_wave import (
        InertialGravityWave,
    )

    nx = 16
    dc = 10000.0e3 / nx
    horz = planar_hex_mesh(nx, nx, dc, f0=1e-4)
    vert = make_vertical_mesh(
        horz, 1, resting_thickness=np.full((horz.n_cells, 1), 1000.0)
    )
    mesh_fp = tmp_path / "mesh.nc"
    save_mpas_mesh(mesh_fp, horz)

    # exact solution at t=2400s as the "model output"
    igw = InertialGravityWave(lx=nx * dc / 1e3)
    t = 2400.0
    ssh = igw.exact_ssh(np.asarray(horz.cells.x), np.asarray(horz.cells.y), t)
    u = igw.exact_normal_velocity(
        np.asarray(horz.edges.x),
        np.asarray(horz.edges.y),
        np.asarray(horz.edges.angle_edge),
        t,
    )

    def stamp(seconds):
        from datetime import datetime, timedelta

        s = datetime(2000, 1, 1) + timedelta(seconds=seconds)
        return s.strftime("%Y-%m-%d_%H:%M:%S").ljust(64)

    xtime = np.stack(
        [
            np.frombuffer(stamp(0.0).encode(), dtype="S1"),
            np.frombuffer(stamp(t).encode(), dtype="S1"),
        ]
    )
    out_fp = tmp_path / "fortran_output.nc"
    write_netcdf(
        out_fp,
        dims={
            "Time": 2, "nCells": horz.n_cells, "nEdges": horz.n_edges,
            "nVertLevels": 1, "StrLen": 64,
        },
        variables={
            "xtime": (("Time", "StrLen"), xtime),
            "ssh": (("Time", "nCells"), np.stack([0 * ssh, ssh])),
            "normalVelocity": (
                ("Time", "nEdges", "nVertLevels"),
                np.stack([0 * u, u])[..., None],
            ),
        },
        attrs={"config_dt": "0000_00:10:00"},
    )

    result, _ = compare_output(
        out_fp, "igw", lx=nx * dc / 1e3, mesh_path=mesh_fp
    )
    assert result["time"] == t
    # the "model output" IS the exact solution: RMSE ~ 0
    assert result["rmse_ssh"] < 1e-12
    assert result["rmse_normalVelocity"] < 1e-12

    # same file as NetCDF-4/HDF5: the h5py reader must join the xtime char
    # array into timestamp strings too (real MPAS-Fortran outputs are HDF5)
    h5py = pytest.importorskip("h5py")
    out4_fp = tmp_path / "fortran_output4.nc"
    _netcdf3_to_hdf5(out_fp, out4_fp)
    result4, _ = compare_output(
        out4_fp, "igw", lx=nx * dc / 1e3, mesh_path=mesh_fp
    )
    assert result4["time"] == t
    assert result4["rmse_ssh"] < 1e-12

    # a Fortran-convention output without inline coordinates and without
    # --mesh must fail with a clear pointer to --mesh, not a bare KeyError
    with pytest.raises(ValueError, match="--mesh"):
        compare_output(out_fp, "igw", lx=nx * dc / 1e3)


def test_monitor_series_and_health(tmp_path):
    """In-run monitor: device-sampled metric series, JSONL log, health
    checks (volume conservation on a periodic mesh)."""
    import json

    from mpas_ocean.forward.driver import ocn_run
    from mpas_ocean.tools import make_igw_case

    cfg = make_igw_case(
        tmp_path, nx=16, resolution_km=200.0, duration_seconds=4000,
        output_interval_seconds=2000,
    )
    mon = tmp_path / "metrics.jsonl"
    ocn_run(cfg, monitor=str(mon))
    records = [json.loads(l) for l in open(mon)]
    assert len(records) >= 2
    # monitoring must NOT suppress the configured interval outputs: the
    # 4000s run at 2000s output interval writes one intermediate snapshot
    assert (tmp_path / "output.0000.nc").exists()
    assert (tmp_path / "output.nc").exists()
    for key in ("volume", "kinetic_energy", "max_abs_u", "ssh_rms", "time"):
        assert key in records[0]
    # volume conserved on the periodic IGW box
    v = [r["volume"] for r in records]
    assert abs(v[-1] - v[0]) < 1e-9 * abs(v[0])
    assert all(np.isfinite(list(r.values())).all() for r in records)


def test_driver_nonlinear_config(tmp_path):
    """config_nonlinear_dynamics: true selects the vector-invariant
    dynamics through the whole config->driver->rollout chain, and the
    result differs from the linear run of the same case."""
    from mpas_ocean.tools.cases import make_igw_case

    d_nl = tmp_path / "nl"
    d_lin = tmp_path / "lin"
    d_nl.mkdir(), d_lin.mkdir()
    cfg_nl = make_igw_case(d_nl, nx=16, resolution_km=200.0,
                           duration_seconds=4000, nonlinear=True)
    cfg_lin = make_igw_case(d_lin, nx=16, resolution_km=200.0,
                            duration_seconds=4000)
    setup_nl, prog_nl = ocn_run(cfg_nl)
    assert setup_nl.nonlinear is True
    setup_lin, prog_lin = ocn_run(cfg_lin)
    assert setup_lin.nonlinear is False
    assert np.isfinite(np.asarray(prog_nl.ssh)).all()
    assert (
        np.abs(np.asarray(prog_nl.normal_velocity - prog_lin.normal_velocity)).max()
        > 0
    )


def test_compare_plot_renders_cell_patches(igw_case, tmp_path):
    """plot_comparison must render TRUE cell polygons from the output's own
    verticesOnCell/xVertex connectivity (the reference's polaris
    plot_horiz_field panels, reference: src/compare.py:132-167), not a
    scatter approximation; scatter remains the fallback when vertex data
    is absent."""
    d, cfg = igw_case
    setup, prog = ocn_run(cfg)
    out_fp = os.path.join(d, "output.nc")
    from mpas_ocean.tools.compare import (
        _cell_patches, compare_output, plot_comparison,
    )

    result, fields = compare_output(out_fp, "igw", lx=16 * 200.0)
    coords = fields[4]
    patches = _cell_patches(coords)
    assert patches is not None and len(patches) == 16 * 16
    # hexagon patches: 6 vertices each, compact (no periodic smearing)
    dc = 200.0e3
    for p in patches[:: 37]:
        assert p.shape == (6, 2)
        assert (p[:, 0].max() - p[:, 0].min()) < 2 * dc
        assert (p[:, 1].max() - p[:, 1].min()) < 2 * dc
    png = tmp_path / "cmp.png"
    plot_comparison(fields, str(png))
    assert png.exists() and png.stat().st_size > 0
    # scatter fallback still works without vertex data
    bare = {k: v for k, v in coords.variables.items() if "Vertex" not in k}
    assert _cell_patches(bare) is None
    png2 = tmp_path / "cmp2.png"
    plot_comparison(fields[:4] + (bare,), str(png2))
    assert png2.exists()


def test_driver_fast_path_routing(igw_case, capsys):
    """The CLI driver auto-routes lattice configs onto the structured fast
    path (reference: its driver hardcodes one backend and one loop,
    src/driver/mpas_ocean.jl:28); results match the gather loop at f64
    roundoff and --path gather forces the general loop."""
    d, cfg = igw_case
    setup_f, prog_f = ocn_run(cfg)
    out = capsys.readouterr().out
    assert "structured fast path (lattice detected)" in out
    setup_g, prog_g = ocn_run(cfg, path="gather")
    out = capsys.readouterr().out
    assert "structured fast path" not in out
    np.testing.assert_allclose(
        np.asarray(prog_f.ssh), np.asarray(prog_g.ssh), rtol=0, atol=1e-11
    )
    np.testing.assert_allclose(
        np.asarray(prog_f.normal_velocity),
        np.asarray(prog_g.normal_velocity),
        rtol=0, atol=1e-12,
    )


def test_netcdf4_without_h5py_says_what_is_missing(tmp_path, monkeypatch):
    """h5py is imported only for NetCDF-4 input; without it the reader
    names the missing package instead of failing obscurely."""
    import sys

    p = tmp_path / "mesh4.nc"
    p.write_bytes(b"\x89HDF\r\n\x1a\n" + bytes(64))
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="needs h5py"):
        read_netcdf(p)
