"""Irregular-mesh tier: the general-mesh machinery on genuinely
non-lattice Voronoi meshes.

The reference's defining scope is "irregular, non-rectilinear, TRiSK-based
meshes" (reference: README.MD:5), and its operator tests run on a real
externally generated MPAS mesh (test/ocn/test_Operators.jl:12-15). Every
other mesh in this suite is a uniform hex lattice or icosphere; this module
exercises the paths production variable-resolution meshes must use —
gather operators, BSR matrix step, RCM reordering, the unstructured
partitioner + ShardedModel — on jittered, Lloyd-relaxed and GRADED
(variable-resolution) Voronoi meshes with mixed 5/6/7-gon cells.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpas_ocean.mesh.irregular import irregular_trisk_mesh
from mpas_ocean.mesh.mesh import Mesh
from mpas_ocean.mesh.vert_mesh import make_vertical_mesh
from mpas_ocean.models.shallow_water import PrognosticVars
from mpas_ocean.ops import (
    curl_on_vertex,
    divergence_on_cell,
    gradient_on_edge,
)
from mpas_ocean.utils.errors import error_measures
from mpas_ocean.verification.manufactured import PlanarTestFields

LX = LY = 10000.0


def _mesh(nx, *, grade=0.0, lloyd=2, levels=1, seed=0):
    horz = irregular_trisk_mesh(
        nx, nx, LX, LY, jitter=0.25, lloyd=lloyd, grade=grade, seed=seed,
        f0=1e-4,
    )
    vert = make_vertical_mesh(
        horz, n_vert_levels=levels,
        resting_thickness=np.full((horz.n_cells, levels), 100.0),
    )
    return Mesh(horz=horz, vert=vert).to_device()


@pytest.fixture(scope="module")
def irr24():
    return _mesh(24)


@pytest.fixture(scope="module")
def graded24():
    return _mesh(24, grade=2.0, lloyd=1, seed=1)


def test_irregular_mesh_is_irregular(irr24, graded24):
    """The generated meshes are genuinely non-lattice: mixed polygon
    degrees, non-constant edge lengths, and (graded) variable cell areas —
    while the discrete geometry invariants hold exactly."""
    for mesh, graded in ((irr24, False), (graded24, True)):
        horz = mesh.horz
        nec = np.asarray(horz.cells.n_edges_on_cell)
        assert len(np.unique(nec)) >= 2, "all cells same degree: a lattice"
        areas = np.asarray(horz.cells.area_cell)
        np.testing.assert_allclose(areas.sum(), LX * LY, rtol=1e-12)
        tri = np.asarray(horz.duals.area_triangle)
        np.testing.assert_allclose(tri.sum(), LX * LY, rtol=1e-12)
        kite = np.asarray(horz.duals.kite_areas_on_vertex)
        np.testing.assert_allclose(kite.sum(), LX * LY, rtol=1e-12)
        dc = np.asarray(horz.edges.dc_edge)
        assert dc.std() / dc.mean() > 0.05, "edge lengths ~constant"
        if graded:
            # densest third of the box has markedly smaller cells
            x = np.asarray(horz.cells.x)
            mid = areas[(x > LX / 3) & (x < 2 * LX / 3)].mean()
            outer = areas[(x < LX / 6) | (x > 5 * LX / 6)].mean()
            assert mid < 0.75 * outer, (mid, outer)


def test_irregular_operator_convergence():
    """Gradient/divergence/curl error norms shrink with resolution on
    irregular meshes. The box is NON-square (a square box makes the
    manufactured curl identically zero) and the jitter amplitude is held
    ABSOLUTE across resolutions (proportional jitter keeps the mesh-noise
    floor fixed — the standard distorted-mesh convergence protocol). TRiSK
    is ~2nd order for grad and ~1st for div/curl on such meshes."""
    LXC, LYC = 10000.0, 8000.0
    errs = {}
    for nx, jit in ((16, 0.30), (32, 0.15)):
        ny = int(nx * LYC / LXC)
        horz = irregular_trisk_mesh(
            nx, ny, LXC, LYC, jitter=jit, lloyd=2, seed=2, f0=1e-4,
        )
        vert = make_vertical_mesh(
            horz, n_vert_levels=1,
            resting_thickness=np.full((horz.n_cells, 1), 100.0),
        )
        mesh = Mesh(horz=horz, vert=vert).to_device()
        fields = PlanarTestFields.from_mesh(horz)
        h = np.asarray(fields.h(horz.cells.x, horz.cells.y))[:, None]
        f_e = np.asarray(fields.f_edge_normal(horz))[:, None]
        grad = np.asarray(gradient_on_edge(jnp.asarray(h), mesh))
        div = np.asarray(divergence_on_cell(jnp.asarray(f_e), mesh))
        curl = np.asarray(curl_on_vertex(jnp.asarray(f_e), mesh))
        eg = error_measures(
            grad, np.asarray(fields.grad_h_edge_normal(horz))[:, None],
            mesh, "edge",
        )
        ed = error_measures(
            div, np.asarray(fields.div_f(horz.cells.x, horz.cells.y))[:, None],
            mesh, "cell",
        )
        ec = error_measures(
            curl, np.asarray(fields.curl_f(horz.duals.x, horz.duals.y))[:, None],
            mesh, "vertex",
        )
        errs[nx] = (eg.L_two, ed.L_two, ec.L_two)
    for i, (name, gate) in enumerate(
        (("grad", 3.0), ("div", 1.6), ("curl", 1.4))
    ):
        ratio = errs[16][i] / errs[32][i]
        assert ratio > gate, (name, errs)


def test_irregular_gather_matrix_parity(irr24, graded24):
    """BSR matrix step == gather step at f64 roundoff on irregular and
    graded meshes (identical matrix entries from non-uniform metrics)."""
    from mpas_ocean.forward.run_loop import ocn_run_loop
    from mpas_ocean.models.matrix_model import MatrixModel, matrix_run_loop

    for mesh in (irr24, graded24):
        horz = mesh.horz
        rng = np.random.default_rng(4)
        h = 100.0 + 0.1 * rng.normal(size=(horz.n_cells, 1))
        u = 0.01 * rng.normal(size=(horz.n_edges, 1))
        prog = PrognosticVars(
            ssh=jnp.asarray(h[:, 0] - 100.0),
            layer_thickness=jnp.asarray(h),
            normal_velocity=jnp.asarray(u),
        )
        dt = 5.0
        ref = ocn_run_loop(prog, mesh, dt, 6)
        mm = MatrixModel.from_mesh(mesh, dtype=np.float64)
        out = matrix_run_loop(prog, mm, dt, 6)
        np.testing.assert_allclose(
            np.asarray(out.ssh), np.asarray(ref.ssh), rtol=0, atol=1e-11
        )
        np.testing.assert_allclose(
            np.asarray(out.normal_velocity),
            np.asarray(ref.normal_velocity),
            rtol=0, atol=1e-13,
        )


def test_irregular_nonlinear_matrix_parity(irr24):
    """Vector-invariant dynamics on an irregular mesh: matrix path ==
    gather path (kite-weighted PV, non-uniform tangential weights)."""
    from mpas_ocean.forward.run_loop import ocn_run_loop
    from mpas_ocean.models.matrix_model import MatrixModel, matrix_run_loop

    mesh = irr24
    horz = mesh.horz
    rng = np.random.default_rng(5)
    h = 100.0 + 0.1 * rng.normal(size=(horz.n_cells, 1))
    u = 0.01 * rng.normal(size=(horz.n_edges, 1))
    prog = PrognosticVars(
        ssh=jnp.asarray(h[:, 0] - 100.0),
        layer_thickness=jnp.asarray(h),
        normal_velocity=jnp.asarray(u),
    )
    ref = ocn_run_loop(prog, mesh, 5.0, 6, nonlinear=True)
    mm = MatrixModel.from_mesh(mesh, dtype=np.float64, nonlinear=True)
    out = matrix_run_loop(prog, mm, 5.0, 6, nonlinear=True)
    np.testing.assert_allclose(
        np.asarray(out.ssh), np.asarray(ref.ssh), rtol=0, atol=1e-11
    )
    np.testing.assert_allclose(
        np.asarray(out.normal_velocity), np.asarray(ref.normal_velocity),
        rtol=0, atol=1e-13,
    )


def test_irregular_rcm_reduces_bandwidth(graded24):
    """RCM reordering measurably shrinks the BSR band bytes on an
    irregular mesh (generated point order is already fairly local, so the
    gate is 'no worse + shrinks a randomized order substantially')."""
    from mpas_ocean.mesh.reorder import rcm_reorder
    from mpas_ocean.ops.bsr import trisk_matrices

    def total_bytes(horz):
        mats = trisk_matrices(Mesh(
            horz=horz,
            vert=make_vertical_mesh(
                horz, n_vert_levels=1,
                resting_thickness=np.full((horz.n_cells, 1), 100.0),
            ),
        ))
        return sum(m.nbytes for m in mats.values())

    horz = graded24.horz
    # scramble the cell order to simulate an arbitrarily-ordered NetCDF
    # mesh, then RCM it back
    from mpas_ocean.mesh.irregular import jittered_points
    from mpas_ocean.mesh.voronoi import build_planar_trisk_mesh

    rng = np.random.default_rng(7)
    pts = np.stack([np.asarray(horz.cells.x), np.asarray(horz.cells.y)], -1)
    perm = rng.permutation(len(pts))
    scrambled = build_planar_trisk_mesh(pts[perm], LX, LY, f0=1e-4)
    b_scrambled = total_bytes(scrambled)
    reordered, _ = rcm_reorder(scrambled)
    b_rcm = total_bytes(reordered)
    b_orig = total_bytes(horz)
    assert b_rcm < 0.55 * b_scrambled, (b_rcm, b_scrambled)
    assert b_rcm <= 1.3 * b_orig, (b_rcm, b_orig)


def test_irregular_sharded_rollout_and_grad(irr24):
    """Unstructured partitioner + ShardedModel on 8 virtual devices, on an
    irregular mesh: rollout parity with the single-device gather path AND
    the whole-loop objective gradient."""
    from mpas_ocean.forward.run_loop import (
        ocn_run_loop, ocn_run_loop_objective,
    )
    from mpas_ocean.parallel import ShardedModel

    mesh = irr24
    horz = mesh.horz
    rng = np.random.default_rng(6)
    h = 100.0 + 0.1 * rng.normal(size=(horz.n_cells, 1))
    u = 0.01 * rng.normal(size=(horz.n_edges, 1))
    prog = PrognosticVars(
        ssh=jnp.asarray(h[:, 0] - 100.0),
        layer_thickness=jnp.asarray(h),
        normal_velocity=jnp.asarray(u),
    )
    n, dt = 6, 5.0
    ref = ocn_run_loop(prog, mesh, dt, n)
    sm = ShardedModel(mesh)
    local = sm.scatter(prog)
    out = sm.gather(sm.run(local, dt, n))
    np.testing.assert_allclose(
        np.asarray(out.ssh), np.asarray(ref.ssh), rtol=0, atol=1e-11
    )
    np.testing.assert_allclose(
        np.asarray(out.normal_velocity), np.asarray(ref.normal_velocity),
        rtol=0, atol=1e-12,
    )
    # adjoint: sharded objective + gradient == single-device. Halo slots
    # accumulate gradient SHARES locally, so each global element's gradient
    # is the sum over every part that holds a copy (same protocol as
    # test_parallel.test_sharded_objective_and_grad).
    obj_ref = float(ocn_run_loop_objective(prog, mesh, dt, n))
    obj_sh = float(sm.objective(local, dt, n))
    assert obj_sh == pytest.approx(obj_ref, rel=1e-12)
    g_ref = jax.grad(
        lambda p: ocn_run_loop_objective(p, mesh, dt, n)
    )(prog)
    g_sh_local = jax.grad(lambda l: sm.objective(l, dt, n))(local)
    p = sm.part
    gc = np.zeros(mesh.n_cells)
    for q in range(sm.n_parts):
        ids = p.cell_gids[q, : p.n_local_cells[q]]
        np.add.at(
            gc, ids, np.asarray(g_sh_local.ssh)[q, : p.n_local_cells[q]]
        )
    np.testing.assert_allclose(gc, np.asarray(g_ref.ssh), atol=1e-10)
