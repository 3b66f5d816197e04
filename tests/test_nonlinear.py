"""Nonlinear (vector-invariant) dynamics tests.

The reference's dynamical core is linear — "gravity and coriolis forces,
with no non-linear terms" (reference: README.MD:12). The nonlinear option
(KE gradient + symmetrized PV flux, Ringler et al. 2010) is a capability
BEYOND the reference, so there is no reference behavior to match; instead
these tests pin the scheme to its mathematical properties:

  - interpolation operators reproduce constants (kite partition of unity)
  - the nonlinear tendency reduces to the linear one as amplitude -> 0
    at second order (the defining consistency property)
  - total energy (KE + PE) is conserved by the spatial scheme: RK4 drift
    is time-discretization-only and collapses ~16x when dt halves
  - gradients flow end to end (AD vs FD), matching the linear-path AD tier
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpas_ocean.forward.run_loop import ocn_run_loop, ocn_run_loop_objective
from mpas_ocean.forward.time_integration import (
    ForwardEuler,
    RungeKutta4,
    forward_euler_step,
)
from mpas_ocean.models.shallow_water import (
    PrognosticVars,
    compute_diagnostics,
    compute_normal_velocity_tendency,
    kinetic_energy_on_cell,
    potential_vorticity_on_vertex,
    update_ssh,
)
from mpas_ocean.ops.operators import (
    interpolate_cell_to_vertex,
    interpolate_vertex_to_edge,
)


def _wavy_state(mesh, amp):
    """Perturbed state CONSISTENT with the mesh's resting thickness:
    h = resting + wave, ssh rederived by the model's own convention."""
    horz = mesh.horz
    x = np.asarray(horz.cells.x)
    y = np.asarray(horz.cells.y)
    lx = float(x.max() - x.min()) + float(np.asarray(horz.edges.dc_edge)[0])
    wave = amp * np.cos(2 * np.pi * x / lx) * np.sin(2 * np.pi * y / lx)
    k = mesh.vert.n_vert_levels
    h = np.asarray(mesh.vert.resting_thickness_sum)[:, None] / k + wave[:, None] / k
    h = jnp.asarray(np.broadcast_to(h, (horz.n_cells, k)).copy())
    xe = np.asarray(horz.edges.x)
    u = 0.1 * amp * np.sin(2 * np.pi * xe / lx)
    u = jnp.asarray(np.broadcast_to(u[:, None], (horz.n_edges, k)).copy())
    return PrognosticVars(
        ssh=update_ssh(h, mesh), layer_thickness=h, normal_velocity=u
    )


def test_cell_to_vertex_partition_of_unity(mesh16):
    const = jnp.full((mesh16.horz.n_cells,), 3.25)
    out = interpolate_cell_to_vertex(const, mesh16.horz)
    np.testing.assert_allclose(np.asarray(out), 3.25, rtol=1e-13)
    qe = interpolate_vertex_to_edge(out, mesh16.horz)
    np.testing.assert_allclose(np.asarray(qe), 3.25, rtol=1e-13)


def test_pv_is_f_over_h_at_rest(mesh16):
    prog = _wavy_state(mesh16, 0.0)
    q = potential_vorticity_on_vertex(prog, mesh16)
    f_v = np.asarray(mesh16.horz.duals.f)
    h0 = float(np.asarray(prog.layer_thickness)[0, 0])
    np.testing.assert_allclose(np.asarray(q)[:, 0], f_v / h0, rtol=1e-12)


@pytest.fixture(scope="module")
def mesh16_deep(hex16):
    """16x16 hex with a 100 m resting depth: gravity speed ~31 m/s, so
    nonlinear advection is a controlled perturbation."""
    from mpas_ocean.mesh.mesh import Mesh
    from mpas_ocean.mesh.vert_mesh import make_vertical_mesh

    vert = make_vertical_mesh(
        hex16,
        n_vert_levels=1,
        resting_thickness=np.full((hex16.n_cells, 1), 100.0),
    )
    return Mesh(horz=hex16, vert=vert).to_device()


def test_nonlinear_reduces_to_linear_at_small_amplitude(mesh16):
    """|NL(eps) - L(eps)| must shrink ~4x when eps halves (O(eps^2))."""

    def tendency_gap(amp):
        prog = _wavy_state(mesh16, amp)
        diag = compute_diagnostics(prog, mesh16)
        t_lin = compute_normal_velocity_tendency(prog, diag, mesh16)
        t_nl = compute_normal_velocity_tendency(
            prog, diag, mesh16, nonlinear=True
        )
        return float(jnp.max(jnp.abs(t_nl - t_lin)))

    g1 = tendency_gap(0.01)
    g2 = tendency_gap(0.005)
    g4 = tendency_gap(0.0025)
    assert g1 > 0
    assert g1 / g2 == pytest.approx(4.0, rel=0.25)
    assert g2 / g4 == pytest.approx(4.0, rel=0.25)


def _total_energy(prog, mesh):
    """E = sum_c A_c [ sum_k h KE + g/2 ssh^2 ] (flat bottom)."""
    area = mesh.cells.area_cell
    ke = kinetic_energy_on_cell(prog.normal_velocity, mesh)
    h = prog.layer_thickness * mesh.vert.cell_level_mask
    kinetic = jnp.sum((ke * h).sum(axis=1) * area)
    potential = 0.5 * 9.80616 * jnp.sum(prog.ssh * prog.ssh * area)
    return kinetic + potential


def test_energy_conservation_rk4(mesh16_deep):
    """The TRiSK spatial scheme conserves E exactly; with RK4 the residual
    drift is time-discretization-only — tiny, and collapsing when dt
    halves. This is THE signature of the energy-conserving PV flux — an
    asymmetric q average fails this by orders of magnitude."""
    mesh = mesh16_deep
    prog = _wavy_state(mesh, 5.0)
    e0 = float(_total_energy(prog, mesh))

    def drift(dt, n):
        out = ocn_run_loop(
            prog, mesh, dt, n, method=RungeKutta4, nonlinear=True
        )
        return abs(float(_total_energy(out, mesh)) - e0)

    d1 = drift(2.0, 50)
    d2 = drift(1.0, 100)
    assert d1 / abs(e0) < 1e-6  # tiny at all
    assert d1 / d2 > 8.0  # ~16x for a 4th-order stepper


def test_nonlinear_forward_euler_runs_masked_levels(mesh16_3l):
    """Variable-bathymetry masks keep inactive levels exactly zero and the
    state finite through nonlinear steps."""
    mesh = mesh16_3l
    nc = mesh.horz.n_cells
    ne = mesh.horz.n_edges
    rng = np.random.default_rng(0)
    h = 100.0 + rng.normal(size=(nc, 3))
    prog = PrognosticVars(
        ssh=update_ssh(jnp.asarray(h), mesh),
        layer_thickness=jnp.asarray(h),
        normal_velocity=jnp.asarray(0.1 * rng.normal(size=(ne, 3))),
    )
    out = forward_euler_step(prog, mesh, 1.0, nonlinear=True)
    assert np.isfinite(np.asarray(out.normal_velocity)).all()
    assert np.isfinite(np.asarray(out.layer_thickness)).all()
    # masked (inactive) edge levels never accelerate
    elm = np.asarray(mesh.vert.edge_level_mask)
    if (elm == 0).any():
        du = np.asarray(out.normal_velocity - prog.normal_velocity)
        assert np.abs(du[elm == 0]).max() == 0.0


def test_nonlinear_end2end_gradient_vs_fd(igw_mesh):
    mesh = igw_mesh
    prog = _wavy_state(mesh, 1.0)

    def obj(u0):
        p = PrognosticVars(
            ssh=prog.ssh,
            layer_thickness=prog.layer_thickness,
            normal_velocity=u0,
        )
        return ocn_run_loop_objective(
            p, mesh, 50.0, 5, method=ForwardEuler, nonlinear=True
        )

    u0 = prog.normal_velocity
    g = jax.grad(obj)(u0)
    rng = np.random.default_rng(1)
    v = jnp.asarray(rng.normal(size=u0.shape))
    eps = 1e-4
    fd = (float(obj(u0 + eps * v)) - float(obj(u0 - eps * v))) / (2 * eps)
    ad = float(jnp.vdot(g, v))
    assert ad == pytest.approx(fd, rel=1e-6)


def test_matrix_nonlinear_matches_gather(mesh16_3l):
    """The BSR matrix formulation of the nonlinear step agrees with the
    gather path to f64 roundoff (same invariant the linear paths keep)."""
    from mpas_ocean.models.matrix_model import MatrixModel, matrix_run_loop

    mesh = mesh16_3l
    prog = _wavy_state(mesh, 0.05)
    mm = MatrixModel.from_mesh(mesh, dtype=np.float64, nonlinear=True)
    out_g = ocn_run_loop(prog, mesh, 5.0, 10, nonlinear=True)
    out_m = matrix_run_loop(prog, mm, 5.0, 10, nonlinear=True)
    scale = float(jnp.abs(out_g.normal_velocity).max())
    assert np.abs(np.asarray(out_m.normal_velocity - out_g.normal_velocity)).max() < 1e-12 * max(scale, 1.0)
    assert np.abs(np.asarray(out_m.layer_thickness - out_g.layer_thickness)).max() < 1e-10
    # RK4 variant too
    out_g4 = ocn_run_loop(prog, mesh, 5.0, 5, method=RungeKutta4, nonlinear=True)
    out_m4 = matrix_run_loop(prog, mm, 5.0, 5, rk4=True, nonlinear=True)
    assert np.abs(np.asarray(out_m4.normal_velocity - out_g4.normal_velocity)).max() < 1e-12 * max(scale, 1.0)


def test_matrix_nonlinear_requires_operators(mesh16):
    from mpas_ocean.models.matrix_model import MatrixModel, matrix_step

    prog = _wavy_state(mesh16, 0.1)
    mm = MatrixModel.from_mesh(mesh16, dtype=np.float64)
    with pytest.raises(ValueError, match="nonlinear"):
        matrix_step(prog, mm, 1.0, nonlinear=True)


def test_structured_nonlinear_matches_gather():
    """Roll-path nonlinear step (machine-extracted vertex stencils) agrees
    with the gather path at f64 roundoff on a periodic lattice."""
    from mpas_ocean.mesh import planar_hex_mesh
    from mpas_ocean.mesh.mesh import Mesh
    from mpas_ocean.mesh.vert_mesh import make_vertical_mesh
    from mpas_ocean.structured import StructuredModel

    nx = 16
    horz = planar_hex_mesh(nx, nx, 1000.0, f0=1e-4)
    vert = make_vertical_mesh(
        horz, n_vert_levels=2,
        resting_thickness=np.full((horz.n_cells, 2), 50.0),
    )
    mesh = Mesh(horz=horz, vert=vert).to_device()
    prog = _wavy_state(mesh, 0.5)
    sm = StructuredModel(mesh, nx, nx)

    out_g = ocn_run_loop(prog, mesh, 2.0, 20, nonlinear=True)
    out_s = sm.from_struct(sm.run(sm.to_struct(prog), 2.0, 20, nonlinear=True))
    scale = float(jnp.abs(out_g.normal_velocity).max())
    assert np.abs(np.asarray(out_s.normal_velocity - out_g.normal_velocity)).max() < 1e-12 * max(scale, 1.0)
    assert np.abs(np.asarray(out_s.ssh - out_g.ssh)).max() < 1e-9


def _channel_setup(nx=16, K=2):
    from mpas_ocean.mesh import planar_hex_mesh
    from mpas_ocean.mesh.cull import cull_cells
    from mpas_ocean.mesh.mesh import Mesh
    from mpas_ocean.mesh.vert_mesh import make_vertical_mesh
    from mpas_ocean.structured import StructuredModel

    dc = 1000.0
    parent = planar_hex_mesh(nx, nx, dc, f0=1e-4)
    y = np.asarray(parent.cells.y)
    keep = (y > 0.5 * dc) & (y < y.max() - 0.5 * dc)
    chan = cull_cells(parent, keep)
    vert = make_vertical_mesh(
        chan, n_vert_levels=K,
        resting_thickness=np.full((chan.n_cells, K), 50.0),
    )
    mesh = Mesh(horz=chan, vert=vert).to_device()
    sm = StructuredModel(mesh, nx, nx, parent_horz=parent, keep_cells=keep)
    rng = np.random.default_rng(3)
    x = np.asarray(chan.cells.x)
    h = np.full((chan.n_cells, K), 50.0) + 0.5 * np.cos(
        2 * np.pi * x / (x.max() + dc)
    )[:, None]
    u = 0.05 * rng.normal(size=(chan.n_edges, K))
    u *= np.asarray(chan.edges.edge_mask)[:, None]
    prog = PrognosticVars(
        ssh=update_ssh(jnp.asarray(h), mesh),
        layer_thickness=jnp.asarray(h),
        normal_velocity=jnp.asarray(u),
    )
    return mesh, sm, prog


def test_structured_nonlinear_walls_match_gather():
    """WALL-MASKED nonlinear dynamics on every structured path: the
    per-site live-renormalized kite weights + guarded PV division
    (StructMesh.vertex_kite_planes / vertex_mask) reproduce the culled
    gather path's boundary-vertex handling (ops/operators.
    interpolate_cell_to_vertex partial kites) at f64 roundoff — roll,
    sharded slab and sharded superstep (2q-row halos)."""
    import jax as _jax

    from mpas_ocean.structured.model import structured_run_loop
    from mpas_ocean.structured.sharded import ShardedStructuredModel

    mesh, sm, prog = _channel_setup()
    st = sm.to_struct(prog)
    smesh = sm.struct_mesh
    n, dt = 8, 2.0
    out_g = ocn_run_loop(prog, mesh, dt, n, nonlinear=True)
    ref = structured_run_loop(st, smesh, dt, n, nonlinear=True)
    ref_u = sm.from_struct(ref)
    assert np.abs(
        np.asarray(ref_u.normal_velocity - out_g.normal_velocity)
    ).max() < 1e-13
    assert np.abs(np.asarray(ref_u.ssh - out_g.ssh)).max() < 1e-12

    ssm = ShardedStructuredModel(smesh, devices=_jax.devices()[:2])
    out_r = ssm.gather(ssm.run(ssm.scatter(st), dt, n, nonlinear=True))
    out_p = ssm.gather(
        ssm.run_superstep(ssm.scatter(st), dt, n, q=2, nonlinear=True)
    )
    for out in (out_r, out_p):
        np.testing.assert_allclose(
            np.asarray(out.normal_velocity),
            np.asarray(ref.normal_velocity),
            rtol=0, atol=1e-13,
        )
        np.testing.assert_allclose(
            np.asarray(out.ssh), np.asarray(ref.ssh), rtol=0, atol=1e-12
        )


def test_structured_nonlinear_walls_adjoint():
    """The checkpointed reverse (structured_rollout_diff) with the
    wall-masked nonlinear vertex constants matches the roll vjp for an
    arbitrary output cotangent."""
    from mpas_ocean.structured.model import (
        structured_rollout_diff,
        structured_run_loop,
    )

    mesh, sm, prog = _channel_setup(nx=8)
    st = sm.to_struct(prog)
    smesh = sm.struct_mesh
    n, dt = 6, 2.0
    out, vjp = jax.vjp(
        lambda s, t: structured_run_loop(s, smesh, t, n, True), st, dt
    )
    g = jax.tree.map(lambda a: a + 0.5, out)
    d_ref, ddt_ref = vjp(g)
    _, vjp_c = jax.vjp(
        lambda s, t: structured_rollout_diff(s, smesh, t, n, True), st, dt
    )
    d_st, ddt = vjp_c(g)
    for a, b in zip(jax.tree.leaves(d_st), jax.tree.leaves(d_ref)):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-9, atol=1e-12
        )
    np.testing.assert_allclose(float(ddt), float(ddt_ref), rtol=1e-9)


def test_structured_nonlinear_handbuilt_mask_still_rejects():
    """A hand-built masked StructMesh WITHOUT the masked vertex constants
    must still refuse nonlinear runs with a helpful error."""
    from mpas_ocean.structured.model import structured_step

    mesh, sm, prog = _channel_setup(nx=8)
    smesh = sm.struct_mesh.replace(vertex_kite_planes=None, vertex_mask=None)
    with pytest.raises(NotImplementedError, match="masked vertex"):
        structured_step(sm.to_struct(prog), smesh, 1.0, nonlinear=True)
