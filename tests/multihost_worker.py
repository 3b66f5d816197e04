"""Worker process for the 2-process multi-host test (test_multihost.py).

Each of the two processes owns 4 virtual CPU devices; together they form
the 2x4 ('dcn', 'ici') hybrid mesh. The worker runs the row-sharded
structured model across all 8 global devices and checks a psum checksum
against the single-device rollout it computes locally.

Usage: python multihost_worker.py <process_id> <coordinator_port>
"""

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import jax

jax.config.update("jax_platforms", "cpu")
try:  # cross-process CPU collectives need the gloo backend where gated
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
except Exception:
    pass

import numpy as np


def main():
    pid, port = int(sys.argv[1]), sys.argv[2]
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

    from mpas_ocean.parallel.distributed import (
        hybrid_device_mesh,
        init_distributed,
    )

    ok = init_distributed(
        coordinator_address=f"127.0.0.1:{port}", num_processes=2, process_id=pid
    )
    assert ok and jax.process_count() == 2, "distributed init failed"
    assert len(jax.devices()) == 8, f"want 8 global devices, got {len(jax.devices())}"

    import jax.numpy as jnp

    from mpas_ocean.mesh import planar_hex_mesh
    from mpas_ocean.mesh.mesh import Mesh
    from mpas_ocean.mesh.vert_mesh import make_vertical_mesh
    from mpas_ocean.models.shallow_water import PrognosticVars
    from mpas_ocean.structured import ShardedStructuredModel, StructuredModel
    from mpas_ocean.structured.model import structured_run_loop

    nx = ny = 16
    horz = planar_hex_mesh(nx, ny, 1000.0, f0=1e-4)
    vert = make_vertical_mesh(
        horz, n_vert_levels=2,
        resting_thickness=np.full((horz.n_cells, 2), 500.0),
    )
    mesh = Mesh(horz=horz, vert=vert).to_device()
    sm = StructuredModel(mesh, nx, ny)
    rng = np.random.default_rng(3)
    h = np.full((horz.n_cells, 2), 500.0) + 0.1 * rng.normal(size=(horz.n_cells, 2))
    u = 0.01 * rng.normal(size=(horz.n_edges, 2))
    prog = PrognosticVars(
        ssh=jnp.asarray(h.sum(1) - np.asarray(vert.resting_thickness_sum)),
        layer_thickness=jnp.asarray(h),
        normal_velocity=jnp.asarray(u),
    )
    st = sm.to_struct(prog)

    dmesh = hybrid_device_mesh()  # (dcn=2, ici=4)
    assert dict(dmesh.shape) == {"dcn": 2, "ici": 4}, dmesh.shape
    ssm = ShardedStructuredModel(sm.struct_mesh, device_mesh=dmesh)
    out = ssm.run(ssm.scatter(st), 10.0, 5)
    chk = float(ssm.checksum(out))

    ref = structured_run_loop(st, sm.struct_mesh, 10.0, 5)
    want = float(
        jnp.sum(ref.ssh) + jnp.sum(ref.layer_thickness)
        + jnp.sum(ref.normal_velocity)
    )
    rel = abs(chk - want) / max(1.0, abs(want))
    assert rel < 1e-12, f"checksum mismatch: {chk} vs {want} (rel {rel})"

    # communication-avoiding superstep across BOTH processes: the 2q-halo
    # ppermutes cross the process boundary (gloo on CPU)
    out2 = ssm.run_superstep(ssm.scatter(st), 10.0, 4, q=2)
    chk2 = float(ssm.checksum(out2))
    ref2 = structured_run_loop(st, sm.struct_mesh, 10.0, 4)
    want2 = float(
        jnp.sum(ref2.ssh) + jnp.sum(ref2.layer_thickness)
        + jnp.sum(ref2.normal_velocity)
    )
    rel2 = abs(chk2 - want2) / max(1.0, abs(want2))
    assert rel2 < 1e-12, f"superstep mismatch: {chk2} vs {want2} ({rel2})"

    # differentiable multi-process objective: replicated value + gradient
    # checksum against the single-process global rollout
    local = ssm.scatter(st)
    oval = float(ssm.objective(local, 10.0, 3))
    oref = float(jnp.sum(structured_run_loop(st, sm.struct_mesh, 10.0, 3).ssh ** 2))
    assert abs(oval - oref) / max(1.0, abs(oref)) < 1e-12, (oval, oref)
    g = jax.grad(lambda l: ssm.objective(l, 10.0, 3))(local)
    gsum = float(
        jax.jit(lambda t: sum(jnp.sum(x) for x in jax.tree.leaves(t)))(g)
    )
    gref_tree = jax.grad(
        lambda s: jnp.sum(
            structured_run_loop(s, sm.struct_mesh, 10.0, 3).ssh ** 2
        )
    )(st)
    gref = float(sum(jnp.sum(x) for x in jax.tree.leaves(gref_tree)))
    assert abs(gsum - gref) / max(1.0, abs(gref)) < 1e-10, (gsum, gref)
    print(f"MULTIHOST_OK pid={pid} chk={chk!r}")


if __name__ == "__main__":
    main()
