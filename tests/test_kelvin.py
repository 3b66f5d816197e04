"""Coastal Kelvin wave channel: boundary conditions + analytic propagation
(the reference's perf-benchmark configuration, README.MD:45-50, exercised
for correctness: masked boundary edges, wall velocities, wave speed)."""

import jax.numpy as jnp
import numpy as np
import pytest

from mpas_ocean.forward.run_loop import ocn_run_loop
from mpas_ocean.mesh import planar_hex_mesh
from mpas_ocean.mesh.cull import cull_cells
from mpas_ocean.mesh.mesh import Mesh
from mpas_ocean.mesh.vert_mesh import make_vertical_mesh
from mpas_ocean.models.shallow_water import PrognosticVars
from mpas_ocean.verification.kelvin_wave import KelvinWave


NX = NY = 32


@pytest.fixture(scope="module")
def channel_full():
    """Channel: periodic in x, walls north and south (rows culled).

    Returns (culled Mesh, dc, parent horz, keep mask) so the structured
    lattice paths can be built from the same parent."""
    dc = 10000.0e3 / NX
    horz = planar_hex_mesh(NX, NY, dc, f0=1e-4)
    y = np.asarray(horz.cells.y)
    keep = (y > 0.5 * dc) & (y < y.max() - 0.5 * dc)  # cull first/last row
    chan = cull_cells(horz, keep)
    vert = make_vertical_mesh(
        chan, n_vert_levels=1, resting_thickness=np.full((chan.n_cells, 1), 1000.0)
    )
    return Mesh(horz=chan, vert=vert).to_device(), dc, horz, keep


@pytest.fixture(scope="module")
def channel(channel_full):
    mesh, dc, _, _ = channel_full
    return mesh, dc


def test_cull_structure(channel):
    mesh, dc = channel
    em = np.asarray(mesh.edges.edge_mask)
    assert (em == 0).sum() > 0  # boundary edges exist
    # boundary edges have both cell slots equal (wall degeneracy)
    coe = np.asarray(mesh.edges.cells_on_edge)
    b = em == 0
    assert (coe[b, 0] == coe[b, 1]).all()
    # interior connectivity still refers to live elements
    assert np.asarray(mesh.cells.edges_on_cell).max() < mesh.n_edges


def test_wall_stays_closed(channel):
    mesh, dc = channel
    kw = KelvinWave(f0=1e-4, lx=10000.0)
    ssh, h, u = kw.initial_state(mesh.horz)
    prog = PrognosticVars(
        ssh=jnp.asarray(ssh),
        layer_thickness=jnp.asarray(h),
        normal_velocity=jnp.asarray(u),
    )
    fin = ocn_run_loop(prog, mesh, 200.0, 20)
    em = np.asarray(mesh.edges.edge_mask)
    wall_u = np.asarray(fin.normal_velocity)[em == 0]
    np.testing.assert_allclose(wall_u, 0.0, atol=0.0)
    assert np.isfinite(np.asarray(fin.ssh)).all()


def test_volume_conserved_with_walls(channel):
    mesh, dc = channel
    kw = KelvinWave()
    ssh, h, u = kw.initial_state(mesh.horz)
    prog = PrognosticVars(
        ssh=jnp.asarray(ssh),
        layer_thickness=jnp.asarray(h),
        normal_velocity=jnp.asarray(u),
    )
    area = np.asarray(mesh.cells.area_cell)
    v0 = float((np.asarray(prog.layer_thickness)[:, 0] * area).sum())
    fin = ocn_run_loop(prog, mesh, 200.0, 20)
    v1 = float((np.asarray(fin.layer_thickness)[:, 0] * area).sum())
    assert abs(v1 - v0) < 1e-9 * abs(v0)


def _channel_prog(mesh):
    kw = KelvinWave(f0=1e-4, lx=10000.0)
    ssh, h, u = kw.initial_state(mesh.horz)
    return PrognosticVars(
        ssh=jnp.asarray(ssh),
        layer_thickness=jnp.asarray(h),
        normal_velocity=jnp.asarray(u),
    )


@pytest.fixture(scope="module")
def channel_structured(channel_full):
    from mpas_ocean.structured import StructuredModel

    mesh, dc, parent, keep = channel_full
    sm = StructuredModel(mesh, NX, NY, parent_horz=parent, keep_cells=keep)
    return mesh, sm


def _assert_prog_close(a, b, atol=1e-12):
    np.testing.assert_allclose(np.asarray(a.ssh), np.asarray(b.ssh), atol=atol)
    np.testing.assert_allclose(
        np.asarray(a.layer_thickness), np.asarray(b.layer_thickness), atol=atol
    )
    np.testing.assert_allclose(
        np.asarray(a.normal_velocity), np.asarray(b.normal_velocity), atol=atol
    )


def test_structured_channel_matches_gather(channel_structured):
    """Masked-lattice roll path == culled gather path (f64 roundoff): the
    wall mask makes the reference's literal Kelvin perf config run on the
    structured fast path (reference: README.MD:45-50)."""
    mesh, sm = channel_structured
    prog = _channel_prog(mesh)
    n, dt = 25, 200.0
    ref = ocn_run_loop(prog, mesh, dt, n)
    out = sm.from_struct(sm.run(sm.to_struct(prog), dt, n))
    _assert_prog_close(out, ref)
    # wall edges stay exactly closed on the lattice path too
    em = np.asarray(mesh.edges.edge_mask)
    np.testing.assert_allclose(
        np.asarray(out.normal_velocity)[em == 0], 0.0, atol=0.0
    )


def test_structured_channel_sharded_matches_roll(channel_structured):
    """Masked row-sharded slab model == masked roll model on 8 devices."""
    from mpas_ocean.structured import ShardedStructuredModel
    from mpas_ocean.structured.model import structured_run_loop

    mesh, sm = channel_structured
    st = sm.to_struct(_channel_prog(mesh))
    n, dt = 8, 200.0
    ref = structured_run_loop(st, sm.struct_mesh, dt, n)
    ssm = ShardedStructuredModel(sm.struct_mesh)
    out = ssm.gather(ssm.run(ssm.scatter(st), dt, n))
    np.testing.assert_allclose(np.asarray(out.ssh), np.asarray(ref.ssh), atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(out.normal_velocity),
        np.asarray(ref.normal_velocity),
        atol=1e-13,
    )


def test_structured_channel_conv_matches_roll(channel_structured):
    """Masked conv formulation == masked roll model."""
    from mpas_ocean.structured.conv_model import build_conv_step, conv_run_loop
    from mpas_ocean.structured.model import structured_run_loop

    mesh, sm = channel_structured
    st = sm.to_struct(_channel_prog(mesh))
    n, dt = 6, 200.0
    kernels = build_conv_step(sm.struct_mesh, dtype=np.float64)
    ref = structured_run_loop(st, sm.struct_mesh, dt, n)
    out = conv_run_loop(st, sm.struct_mesh, kernels, dt, n)
    np.testing.assert_allclose(np.asarray(out.ssh), np.asarray(ref.ssh), atol=1e-10)
    np.testing.assert_allclose(
        np.asarray(out.normal_velocity),
        np.asarray(ref.normal_velocity),
        atol=1e-12,
    )


def test_kelvin_wave_propagation(channel):
    """The wave must track the analytic translating solution."""
    mesh, dc = channel
    kw = KelvinWave(f0=1e-4, lx=10000.0)
    ssh, h, u = kw.initial_state(mesh.horz)
    prog = PrognosticVars(
        ssh=jnp.asarray(ssh),
        layer_thickness=jnp.asarray(h),
        normal_velocity=jnp.asarray(u),
    )
    dt, n = 200.0, 25  # 5000 s: wave moves ~495 km (~1.6 cells)
    fin = ocn_run_loop(prog, mesh, dt, n)
    x = np.asarray(mesh.cells.x)
    y = np.asarray(mesh.cells.y)
    t = dt * n
    exact = kw.exact_ssh(x, y, t)
    # weight toward the wall where the wave lives
    rmse = np.sqrt(np.mean((np.asarray(fin.ssh) - exact) ** 2))
    rms_sig = np.sqrt(np.mean(exact**2))
    assert rmse < 0.15 * rms_sig
    # and it must clearly beat the "wave did not move" hypothesis
    rmse_static = np.sqrt(np.mean((np.asarray(fin.ssh) - kw.exact_ssh(x, y, 0.0)) ** 2))
    assert rmse < 0.5 * rmse_static
