"""Native C++ graph preprocessing vs Python fallback, and end-to-end use of
graph partitions in the sharded model (including on the sphere)."""

import numpy as np
import pytest

from mpas_ocean.parallel.graph import (
    _greedy_python,
    _rcm_python,
    cell_adjacency_csr,
    greedy_partition,
    native_available,
    rcm_order,
)


def test_native_builds():
    """The C++ library must compile and load in this environment."""
    assert native_available()


def test_rcm_native_matches_python(hex16):
    xadj, adjncy = cell_adjacency_csr(hex16)
    n = hex16.n_cells
    native = rcm_order(n, xadj, adjncy)
    python = _rcm_python(n, xadj, adjncy)
    np.testing.assert_array_equal(native, python)
    # a valid permutation
    assert sorted(native.tolist()) == list(range(n))


def test_rcm_reduces_bandwidth(hex16):
    xadj, adjncy = cell_adjacency_csr(hex16)
    n = hex16.n_cells
    order = rcm_order(n, xadj, adjncy)
    pos = np.empty(n, dtype=np.int64)
    pos[order] = np.arange(n)

    def bandwidth(p):
        bw = 0
        for u in range(n):
            for v in adjncy[xadj[u] : xadj[u + 1]]:
                bw = max(bw, abs(int(p[u]) - int(p[v])))
        return bw

    rng = np.random.default_rng(0)
    random_pos = rng.permutation(n)
    assert bandwidth(pos) < bandwidth(random_pos)


def test_partition_native_matches_python(hex16):
    xadj, adjncy = cell_adjacency_csr(hex16)
    n = hex16.n_cells
    native = greedy_partition(n, xadj, adjncy, 4)
    python = _greedy_python(n, xadj, adjncy, 4)
    np.testing.assert_array_equal(native, python)
    counts = np.bincount(native, minlength=4)
    assert counts.max() - counts.min() <= 1


def test_graph_partition_on_sphere():
    """Graph partitioning + sharded rollout on the spherical mesh matches
    the single-device run."""
    import jax
    import jax.numpy as jnp

    from mpas_ocean.forward.run_loop import ocn_run_loop
    from mpas_ocean.mesh.mesh import Mesh
    from mpas_ocean.mesh.sphere import spherical_mesh
    from mpas_ocean.mesh.vert_mesh import make_vertical_mesh
    from mpas_ocean.models.shallow_water import PrognosticVars
    from mpas_ocean.parallel import ShardedModel, build_partition
    from mpas_ocean.parallel.partition import partition_cells

    horz = spherical_mesh(6)  # 362 cells
    vert = make_vertical_mesh(
        horz, n_vert_levels=1, resting_thickness=np.full((horz.n_cells, 1), 5000.0)
    )
    mesh = Mesh(horz=horz, vert=vert).to_device()

    part = partition_cells(horz, 8, method="graph")
    counts = np.bincount(part, minlength=8)
    assert counts.max() - counts.min() <= 1

    rng = np.random.default_rng(0)
    eta = 0.5 * rng.normal(size=horz.n_cells)
    prog = PrognosticVars(
        ssh=jnp.asarray(eta),
        layer_thickness=jnp.asarray((eta + 5000.0)[:, None]),
        normal_velocity=jnp.asarray(0.1 * rng.normal(size=(horz.n_edges, 1))),
    )
    ref = ocn_run_loop(prog, mesh, 60.0, 5)

    pm = build_partition(mesh, 8, part_of_cell=part)
    sm = ShardedModel(mesh, part=pm)
    out = sm.gather(sm.run(sm.scatter(prog), 60.0, 5))
    np.testing.assert_allclose(np.asarray(out.ssh), np.asarray(ref.ssh), atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(out.normal_velocity),
        np.asarray(ref.normal_velocity),
        atol=1e-12,
    )
