"""Beta-plane Rossby wave verification (verification/rossby_wave.py):
the framework's planetary-wave dynamics against the QG dispersion
relation omega = -beta k / (k^2 + l^2 + 1/LR^2)."""

import jax.numpy as jnp
import numpy as np

from mpas_ocean.forward.run_loop import ocn_run_loop
from mpas_ocean.forward.time_integration import ForwardBackward
from mpas_ocean.mesh import planar_hex_mesh
from mpas_ocean.mesh.mesh import Mesh
from mpas_ocean.mesh.vert_mesh import make_vertical_mesh
from mpas_ocean.models.shallow_water import PrognosticVars
from mpas_ocean.verification import RossbyWave


def test_rossby_wave_westward_phase_speed():
    """A geostrophically balanced sinusoidal mode drifts WESTWARD at the QG
    phase speed. On the doubly-periodic beta plane the plane-wave initial
    state is not an exact eigenmode of the variable-f system (beta*Ly/f0 ~
    16% here), so the instantaneous phase beats around the QG line; the
    verified quantity is the drift RATE — a least-squares slope of the
    unwrapped mode phase over ~0.5 QG periods — to 20%, plus the sign and
    bounded amplitude. A beta ~ 0 control shows zero drift (the
    measurement itself is clean)."""
    nx = 32
    # rw.f0 is the DOMAIN-CENTER f (the constant-coefficient value the QG
    # dispersion and geostrophic balance assume); the mesh's f0 is the
    # southern-edge value so that f0 + beta*y matches at mid-domain
    rw = RossbyWave(lx=2000.0, bottom_depth=1000.0,
                    f0=1.05e-4, beta=1e-11, amplitude=0.1)
    dc = rw.lx * 1e3 / nx
    f_south = rw.f0 - rw.beta * (rw.ly_km * 1e3) / 2.0
    horz = planar_hex_mesh(nx, nx, dc, f0=f_south, beta=rw.beta)
    vert = make_vertical_mesh(
        horz, n_vert_levels=1,
        resting_thickness=np.full((horz.n_cells, 1), rw.bottom_depth),
    )
    mesh = Mesh(horz=horz, vert=vert).to_device()
    ssh, h, u = rw.initial_state(horz)
    prog = PrognosticVars(
        ssh=jnp.asarray(ssh), layer_thickness=jnp.asarray(h),
        normal_velocity=jnp.asarray(u),
    )
    x = np.asarray(horz.cells.x)
    y = np.asarray(horz.cells.y)
    c = np.sqrt(rw.g * rw.bottom_depth)
    dt = 0.5 * dc / c
    n_snap, t_tot = 12, 2.4e6
    per = int(round(t_tot / n_snap / dt))
    ts, ph, prev = [0.0], [0.0], 0.0
    p = prog
    for s in range(n_snap):
        p = ocn_run_loop(p, mesh, dt, per, method=ForwardBackward)
        m = rw.measured_phase(x, y, np.asarray(p.ssh))
        while m - prev > np.pi:
            m -= 2 * np.pi
        while m - prev < -np.pi:
            m += 2 * np.pi
        prev = m
        ts.append((s + 1) * per * dt)
        ph.append(m)
    assert np.isfinite(np.asarray(p.ssh)).all()
    slope = np.polyfit(np.array(ts), np.array(ph), 1)[0]
    assert slope < 0  # westward
    np.testing.assert_allclose(slope, rw.omega, rtol=0.20)
    # linear wave + neutral stepper: amplitude stays bounded
    amp = float(np.abs(np.asarray(p.ssh)).max())
    assert 0.5 * rw.amplitude < amp < 3.0 * rw.amplitude


def test_rossby_control_no_beta_no_drift():
    """beta ~ 0 control: the same machinery measures (essentially) zero
    phase drift, so the Rossby test's signal is the beta effect itself."""
    nx = 32
    rw = RossbyWave(lx=2000.0, bottom_depth=1000.0,
                    f0=1.05e-4, beta=1e-13, amplitude=0.1)
    dc = rw.lx * 1e3 / nx
    horz = planar_hex_mesh(nx, nx, dc, f0=rw.f0, beta=rw.beta)
    vert = make_vertical_mesh(
        horz, n_vert_levels=1,
        resting_thickness=np.full((horz.n_cells, 1), rw.bottom_depth),
    )
    mesh = Mesh(horz=horz, vert=vert).to_device()
    ssh, h, u = rw.initial_state(horz)
    prog = PrognosticVars(
        ssh=jnp.asarray(ssh), layer_thickness=jnp.asarray(h),
        normal_velocity=jnp.asarray(u),
    )
    c = np.sqrt(rw.g * rw.bottom_depth)
    dt = 0.5 * dc / c
    n = int(round(1.2e6 / dt))
    out = ocn_run_loop(prog, mesh, dt, n, method=ForwardBackward)
    m = rw.measured_phase(
        np.asarray(horz.cells.x), np.asarray(horz.cells.y),
        np.asarray(out.ssh),
    )
    assert abs(m) < 0.02
