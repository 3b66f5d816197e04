"""Stommel wind-driven gyre: the model's steady state against the analytic
western-intensified solution (verification/stommel_gyre.py).

This is the one verification case that exercises walls, per-cell wind
forcing, Rayleigh damping and the beta plane TOGETHER. The reference has no
forcing subsystem at all (reference: src/ocn/ForcingVars.jl is empty), so
the gate is the analytic solution, not reference parity.

Calibrated on this exact configuration (32x32 basin, delta_S = 4 cells,
dt=120 s forward-backward, ~8 Rayleigh e-folds of spin-up): residual drift
0.8%, full-basin rel-L2 error 9.6% (dominated by the 4-cell boundary
layer), interior (Sverdrup-balance) rel-L2 3.0%, western intensification
3.81 numeric vs 3.69 analytic-on-the-same-edges.
"""

import jax.numpy as jnp
import numpy as np

from mpas_ocean.mesh import planar_hex_mesh
from mpas_ocean.mesh.cull import cull_cells
from mpas_ocean.mesh.mesh import Mesh
from mpas_ocean.mesh.vert_mesh import make_vertical_mesh
from mpas_ocean.models.forcing import make_forcing
from mpas_ocean.models.shallow_water import PrognosticVars
from mpas_ocean.structured import StructuredModel
from mpas_ocean.verification.stommel_gyre import StommelGyre


def test_stommel_analytic_self_consistency():
    g = StommelGyre(lx=1.0e6, ly=8.0e5)
    ys = np.linspace(0.0, g.ly, 33)
    np.testing.assert_allclose(g.psi(0.0, ys), 0.0, atol=1e-12)
    np.testing.assert_allclose(g.psi(g.lx, ys), 0.0, atol=1e-9)
    np.testing.assert_allclose(g.psi(np.linspace(0, g.lx, 33), 0.0), 0.0,
                               atol=1e-12)
    # boundary layer on the WESTERN wall: strong asymmetry
    assert g.western_intensification() > 3.0


def test_stommel_gyre_steady_state():
    nx = ny = 32
    dc = 31.25e3
    horz = planar_hex_mesh(nx, ny, dc, f0=1e-4, beta=1e-11)
    x, y = np.asarray(horz.cells.x), np.asarray(horz.cells.y)
    keep = (
        (x > 0.75 * dc) & (x < x.max() - 0.75 * dc)
        & (y > 0.5 * dc) & (y < y.max() - 0.5 * dc)
    )
    basin = cull_cells(horz, keep)
    xk, yk = np.asarray(basin.cells.x), np.asarray(basin.cells.y)
    dy = dc * np.sqrt(3) / 2
    # wall positions: half a spacing beyond the outermost kept centers
    x0, y0 = xk.min() - 0.5 * dc, yk.min() - 0.5 * dy
    g = StommelGyre(lx=xk.max() + 0.5 * dc - x0, ly=yk.max() + 0.5 * dy - y0)
    assert abs(g.r / g.beta / dc - 4.0) < 0.1  # delta_S = 4 cells

    vert = make_vertical_mesh(
        basin, n_vert_levels=1,
        resting_thickness=np.full((basin.n_cells, 1), g.depth),
    )
    mesh = Mesh(horz=basin, vert=vert).to_device()
    forcing = make_forcing(
        mesh, wind_stress_zonal=g.wind_stress_zonal(yk - y0),
        rayleigh=g.r, rho0=g.rho0,
    )
    sm = StructuredModel(mesh, nx, ny, parent_horz=horz, keep_cells=keep)
    sf = sm.to_struct_forcing(forcing)
    prog = PrognosticVars(
        ssh=jnp.zeros(basin.n_cells),
        layer_thickness=jnp.full((basin.n_cells, 1), g.depth),
        normal_velocity=jnp.zeros((basin.n_edges, 1)),
    )
    st = sm.to_struct(prog)

    # spin up from rest ~8 Rayleigh e-folds (the forward-backward stepper
    # holds the gravity-wave transients while Rayleigh damping removes
    # them; dt=240 s sits on a slow FB instability on this config — the
    # calibration run diverged by step ~20k — so dt=120 s)
    dt = 120.0
    out = sm.run(st, dt, 24000, forcing=sf, fb=True)
    out2 = sm.run(out, dt, 1000, forcing=sf, fb=True)
    u_prev = np.asarray(sm.from_struct(out).normal_velocity)[:, 0]
    u_num = np.asarray(sm.from_struct(out2).normal_velocity)[:, 0]

    # (a) actually steady
    drift = np.abs(u_prev - u_num).max() / np.abs(u_num).max()
    assert drift < 0.02, drift

    xe = np.asarray(basin.edges.x) - x0
    ye = np.asarray(basin.edges.y) - y0
    ang = np.asarray(basin.edges.angle_edge)
    live = np.asarray(basin.edges.edge_mask) > 0
    u_ex = g.normal_velocity(xe, ye, ang)

    # (b) full-basin error (boundary-layer discretization dominates)
    rel = np.linalg.norm((u_num - u_ex)[live]) / np.linalg.norm(u_ex[live])
    assert rel < 0.13, rel

    # (c) Sverdrup interior (outside 2 delta_S of the western wall)
    inner = live & (xe > 2 * g.r / g.beta)
    rin = np.linalg.norm((u_num - u_ex)[inner]) / np.linalg.norm(u_ex[inner])
    assert rin < 0.05, rin

    # (d) western intensification, numeric vs analytic on the SAME edges
    mer = live & (np.abs(np.sin(ang)) > 0.7) \
        & (np.abs(ye - 0.5 * g.ly) < 0.2 * g.ly)
    west, east = mer & (xe < 0.5 * g.lx), mer & (xe >= 0.5 * g.lx)
    asym = np.abs(u_num[west]).max() / np.abs(u_num[east]).max()
    asym_ex = np.abs(u_ex[west]).max() / np.abs(u_ex[east]).max()
    assert asym > 2.5, asym
    np.testing.assert_allclose(asym, asym_ex, rtol=0.15)


def test_nonlinear_gyre_paths_agree_and_spin_up():
    """NONLINEAR wind-driven gyre in a closed basin: the vector-invariant
    dynamics (KE gradient + symmetrized PV flux with masked boundary
    vertices) combined with walls, wind and Rayleigh damping — the
    canonical coastal application the wall-masked nonlinear kernels exist
    for. Asserts (a) the fused/tiled auto path == the gather path at f64
    roundoff mid-spin-up, and (b) the wind's negative curl drives a
    clockwise gyre (negative net relative vorticity) with a bounded,
    finite state."""
    import jax

    from mpas_ocean.forward.run_loop import ocn_run_loop
    from mpas_ocean.models.shallow_water import (
        potential_vorticity_on_vertex,
    )
    from mpas_ocean.ops.operators import curl_on_vertex
    from mpas_ocean.structured.model import structured_run_loop

    nx = ny = 16
    dc = 31.25e3
    horz = planar_hex_mesh(nx, ny, dc, f0=1e-4, beta=1e-11)
    x, y = np.asarray(horz.cells.x), np.asarray(horz.cells.y)
    keep = (
        (x > 0.75 * dc) & (x < x.max() - 0.75 * dc)
        & (y > 0.5 * dc) & (y < y.max() - 0.5 * dc)
    )
    basin = cull_cells(horz, keep)
    xk, yk = np.asarray(basin.cells.x), np.asarray(basin.cells.y)
    dy = dc * np.sqrt(3) / 2
    x0, y0 = xk.min() - 0.5 * dc, yk.min() - 0.5 * dy
    g = StommelGyre(lx=xk.max() + 0.5 * dc - x0, ly=yk.max() + 0.5 * dy - y0)
    vert = make_vertical_mesh(
        basin, n_vert_levels=1,
        resting_thickness=np.full((basin.n_cells, 1), g.depth),
    )
    mesh = Mesh(horz=basin, vert=vert).to_device()
    forcing = make_forcing(
        mesh, wind_stress_zonal=g.wind_stress_zonal(yk - y0),
        rayleigh=g.r, rho0=g.rho0,
    )
    sm = StructuredModel(mesh, nx, ny, parent_horz=horz, keep_cells=keep)
    sf = sm.to_struct_forcing(forcing)
    prog = PrognosticVars(
        ssh=jnp.zeros(basin.n_cells),
        layer_thickness=jnp.full((basin.n_cells, 1), g.depth),
        normal_velocity=jnp.zeros((basin.n_edges, 1)),
    )
    st = sm.to_struct(prog)
    n, dt = 400, 120.0

    from mpas_ocean.forward.time_integration import ForwardBackward

    out_g = ocn_run_loop(prog, mesh, dt, n, method=ForwardBackward,
                         nonlinear=True, forcing=forcing)
    out_s = sm.from_struct(
        structured_run_loop(st, sm.struct_mesh, dt, n, nonlinear=True,
                            forcing=sf, fb=True)
    )
    scale = float(jnp.abs(out_g.normal_velocity).max())
    assert scale > 0 and np.isfinite(scale)
    np.testing.assert_allclose(
        np.asarray(out_s.normal_velocity),
        np.asarray(out_g.normal_velocity),
        rtol=0, atol=1e-12 * max(scale, 1.0),
    )
    # the interior rotation sense matches the analytic Stommel gyre's
    # (the full-basin vorticity sum telescopes to ~0 by Stokes, so compare
    # INTERIOR vorticity against the analytic solution's on the same mesh)
    zeta = np.asarray(curl_on_vertex(out_g.normal_velocity, mesh))[:, 0]
    xe = np.asarray(basin.edges.x) - x0
    ye = np.asarray(basin.edges.y) - y0
    ang = np.asarray(basin.edges.angle_edge)
    u_ex = g.normal_velocity(xe, ye, ang) * np.asarray(basin.edges.edge_mask)
    zeta_ex = np.asarray(curl_on_vertex(jnp.asarray(u_ex[:, None]), mesh))[:, 0]
    xv = np.asarray(basin.duals.x) - x0
    yv = np.asarray(basin.duals.y) - y0
    inner = (
        (xv > 0.25 * g.lx) & (xv < 0.75 * g.lx)
        & (yv > 0.25 * g.ly) & (yv < 0.75 * g.ly)
    )
    assert zeta[inner].sum() * zeta_ex[inner].sum() > 0.0
