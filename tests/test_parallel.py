"""Multi-device domain decomposition tests on an 8-device virtual mesh —
the test tier the reference lacks entirely (SURVEY section 4: "multi-node
testing: none")."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpas_ocean.forward.run_loop import ocn_run_loop, ocn_run_loop_objective
from mpas_ocean.models.shallow_water import PrognosticVars
from mpas_ocean.parallel import ShardedModel, build_partition, partition_cells
from mpas_ocean.verification.inertial_gravity_wave import InertialGravityWave


@pytest.fixture(scope="module")
def igw_prog(igw_mesh):
    igw = InertialGravityWave()
    ssh, h, u = igw.initial_state(igw_mesh)
    return PrognosticVars(
        ssh=jnp.asarray(ssh),
        layer_thickness=jnp.asarray(h),
        normal_velocity=jnp.asarray(u),
    )


def test_partition_covers_everything(igw_mesh):
    p = build_partition(igw_mesh, 8)
    # every cell/edge owned exactly once
    all_owned_cells = np.concatenate(
        [p.cell_gids[q, : p.n_owned_cells[q]] for q in range(8)]
    )
    assert sorted(all_owned_cells) == list(range(igw_mesh.n_cells))
    all_owned_edges = np.concatenate(
        [p.edge_gids[q, : p.n_owned_edges[q]] for q in range(8)]
    )
    assert sorted(all_owned_edges) == list(range(igw_mesh.n_edges))
    all_owned_verts = np.concatenate(
        [p.vertex_gids[q, : p.n_owned_vertices[q]] for q in range(8)]
    )
    assert sorted(all_owned_verts) == list(range(igw_mesh.n_vertices))
    # balanced
    assert p.n_owned_cells.max() - p.n_owned_cells.min() <= 1


def test_scatter_gather_roundtrip(igw_mesh, igw_prog):
    sm = ShardedModel(igw_mesh)
    back = sm.gather(sm.scatter(igw_prog))
    np.testing.assert_allclose(np.asarray(back.ssh), np.asarray(igw_prog.ssh))
    np.testing.assert_allclose(
        np.asarray(back.normal_velocity), np.asarray(igw_prog.normal_velocity)
    )


@pytest.mark.parametrize("exchange", ["ppermute", "allgather"])
def test_sharded_matches_single_device(igw_mesh, igw_prog, exchange):
    """The headline correctness gate: 10 sharded steps across 8 devices
    reproduce the single-device rollout (same data, same reduction order
    per element => tight tolerance) — under both halo-exchange backends
    (neighbor ppermute rings and boundary all_gather)."""
    dt = 976.0
    n = 10
    ref = ocn_run_loop(igw_prog, igw_mesh, dt, n)

    sm = ShardedModel(igw_mesh, exchange=exchange)
    local = sm.scatter(igw_prog)
    local = sm.run(local, dt, n)
    out = sm.gather(local)

    np.testing.assert_allclose(
        np.asarray(out.ssh), np.asarray(ref.ssh), rtol=0, atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(out.normal_velocity),
        np.asarray(ref.normal_velocity),
        rtol=0,
        atol=1e-12,
    )
    np.testing.assert_allclose(
        np.asarray(out.layer_thickness),
        np.asarray(ref.layer_thickness),
        rtol=0,
        atol=1e-12,
    )


def test_sharded_objective_and_grad(igw_mesh, igw_prog):
    """Differentiating through the sharded rollout (collectives included)
    matches the single-device adjoint."""
    dt, n = 976.0, 4
    sm = ShardedModel(igw_mesh)

    obj_ref = float(ocn_run_loop_objective(igw_prog, igw_mesh, dt, n))
    obj_sh = float(sm.objective(sm.scatter(igw_prog), dt, n))
    assert obj_sh == pytest.approx(obj_ref, rel=1e-12)

    g_ref = jax.grad(lambda p: ocn_run_loop_objective(p, igw_mesh, dt, n))(igw_prog)
    g_sh_local = jax.grad(lambda l: sm.objective(l, dt, n))(sm.scatter(igw_prog))
    # halo slots accumulate gradient shares locally; owned-slot gradients of
    # the scattered state correspond to d/d(owned copy). To compare against
    # the global gradient, sum each global element's contributions across
    # every part that holds a copy of it.
    p = sm.part
    gc = np.zeros(igw_mesh.n_cells)
    for q in range(sm.n_parts):
        ids = p.cell_gids[q, : p.n_local_cells[q]]
        np.add.at(gc, ids, np.asarray(g_sh_local.ssh)[q, : p.n_local_cells[q]])
    np.testing.assert_allclose(gc, np.asarray(g_ref.ssh), atol=1e-10)


def test_partition_with_more_parts_than_rows(igw_mesh):
    """Degenerate-ish partitions still reproduce the reference rollout."""
    for n_parts in (2, 3):
        devices = jax.devices()[:n_parts]
        sm = ShardedModel(igw_mesh, devices=devices)
        igw = InertialGravityWave()
        ssh, h, u = igw.initial_state(igw_mesh)
        prog = PrognosticVars(
            ssh=jnp.asarray(ssh),
            layer_thickness=jnp.asarray(h),
            normal_velocity=jnp.asarray(u),
        )
        ref = ocn_run_loop(prog, igw_mesh, 976.0, 3)
        out = sm.gather(sm.run(sm.scatter(prog), 976.0, 3))
        np.testing.assert_allclose(
            np.asarray(out.ssh), np.asarray(ref.ssh), atol=1e-12
        )


def test_partition_stats(igw_mesh):
    """Static communication profile: sane balance, small halo, few rounds."""
    from mpas_ocean.parallel import build_partition, format_stats, partition_stats

    p = build_partition(igw_mesh, 8)
    s = partition_stats(p)
    assert s["n_parts"] == 8
    assert s["cells_owned"]["imbalance"] < 1.2
    assert 0 < s["halo_cell_fraction"] < 1.0
    assert 1 <= len(s["exchange_rounds"]) <= 7
    assert s["exchange_bytes_per_device_per_step"] > 0
    assert "ppermute rounds" in format_stats(s)


@pytest.mark.parametrize("exchange", ["ppermute", "allgather"])
def test_sharded_rk4_matches_single_device(igw_mesh, igw_prog, exchange):
    """Sharded RK4 == global RK4 at roundoff: each RK4 stage widens the
    stencil, so the sharded stepper refreshes halos before EVERY stage-rate
    evaluation."""
    from mpas_ocean.forward.time_integration import RungeKutta4

    dt = 976.0
    n = 5
    ref = ocn_run_loop(igw_prog, igw_mesh, dt, n, RungeKutta4)

    sm = ShardedModel(igw_mesh, exchange=exchange)
    out = sm.gather(sm.run(sm.scatter(igw_prog), dt, n, RungeKutta4))

    np.testing.assert_allclose(
        np.asarray(out.ssh), np.asarray(ref.ssh), rtol=0, atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(out.normal_velocity),
        np.asarray(ref.normal_velocity),
        rtol=0,
        atol=1e-12,
    )
    np.testing.assert_allclose(
        np.asarray(out.layer_thickness),
        np.asarray(ref.layer_thickness),
        rtol=0,
        atol=1e-12,
    )


def test_sharded_rejects_unknown_stepper(igw_mesh, igw_prog):
    sm = ShardedModel(igw_mesh)
    local = sm.scatter(igw_prog)
    with pytest.raises(ValueError, match="unknown sharded time stepper"):
        sm.run(local, 10.0, 2, method=float)


@pytest.mark.parametrize("exchange", ["ppermute", "allgather"])
def test_overlap_matches_serial_exchange(igw_mesh, igw_prog, exchange):
    """The overlapped step (boundary-mini first, collectives over the full
    step) is bit-equivalent to the serial compute-then-exchange step."""
    dt, n = 976.0, 6
    a = ShardedModel(igw_mesh, exchange=exchange, overlap=True)
    b = ShardedModel(igw_mesh, exchange=exchange, overlap=False)
    out_a = a.gather(a.run(a.scatter(igw_prog), dt, n))
    out_b = b.gather(b.run(b.scatter(igw_prog), dt, n))
    for x, y in zip(jax.tree.leaves(out_a), jax.tree.leaves(out_b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_scaling_harness_smoke():
    """Weak-scaling harness executes end-to-end on the virtual device mesh
    (numbers are not meaningful on CPU; the code path and bookkeeping are)."""
    from mpas_ocean.tools.scaling import measure_scaling

    recs = measure_scaling(
        rows_per_device=4, nx=16, levels=2, steps=4, device_counts=[1, 2]
    )
    assert [r["devices"] for r in recs] == [1, 2]
    assert recs[0]["efficiency"] == 1.0
    for r in recs:
        assert np.isfinite(r["gridpoints_per_sec"])
        assert np.isfinite(r["checksum"])
    # weak scaling: per-device size constant, global size doubles
    assert recs[1]["gridpoints"] == 2 * recs[0]["gridpoints"]


@pytest.mark.parametrize("exchange", ["ppermute", "allgather"])
def test_sharded_nonlinear_matches_single_device(igw_mesh, igw_prog, exchange):
    """Nonlinear (vector-invariant) sharded stepping: the derived-field
    halo exchange (KE, thickness flux, edge PV) keeps the 1-ring halo
    exact, so owned elements reproduce the unsharded nonlinear rollout."""
    dt, n = 976.0, 10
    ref = ocn_run_loop(igw_prog, igw_mesh, dt, n, nonlinear=True)

    sm = ShardedModel(igw_mesh, exchange=exchange)
    local = sm.run(sm.scatter(igw_prog), dt, n, nonlinear=True)
    out = sm.gather(local)

    for a, b in (
        (out.ssh, ref.ssh),
        (out.normal_velocity, ref.normal_velocity),
        (out.layer_thickness, ref.layer_thickness),
    ):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=0, atol=1e-11
        )


def test_sharded_nonlinear_rk4_and_grad(igw_mesh, igw_prog):
    from mpas_ocean.forward.time_integration import RungeKutta4

    dt, n = 976.0, 4
    sm = ShardedModel(igw_mesh)

    ref4 = ocn_run_loop(
        igw_prog, igw_mesh, dt, n, method=RungeKutta4, nonlinear=True
    )
    out4 = sm.gather(
        sm.run(sm.scatter(igw_prog), dt, n, method=RungeKutta4, nonlinear=True)
    )
    np.testing.assert_allclose(
        np.asarray(out4.normal_velocity),
        np.asarray(ref4.normal_velocity),
        rtol=0, atol=1e-11,
    )

    obj_ref = float(
        ocn_run_loop_objective(igw_prog, igw_mesh, dt, n, nonlinear=True)
    )
    obj_sh = float(sm.objective(sm.scatter(igw_prog), dt, n, nonlinear=True))
    assert obj_sh == pytest.approx(obj_ref, rel=1e-12)
    # gradient flows through the derived-field collectives
    g = jax.grad(lambda l: sm.objective(l, dt, n, nonlinear=True))(
        sm.scatter(igw_prog)
    )
    assert np.isfinite(np.asarray(g.normal_velocity)).all()
