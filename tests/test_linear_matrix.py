"""A^q composed linearized matrix path vs step-by-step linearized steps.

The composed operator must reproduce q plain steps exactly (up to
floating-point reassociation), including the cross-level ssh coupling and
the affine resting-thickness term; f32 drift must stay at roundoff scale
relative to the f32 step-by-step path.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from mpas_ocean.mesh import planar_hex_mesh
from mpas_ocean.mesh.mesh import Mesh
from mpas_ocean.mesh.vert_mesh import make_vertical_mesh
from mpas_ocean.models.linear_matrix import (
    LinearizedMatrixModel,
    linearized_ref_loop,
    linearized_run_loop,
)
from mpas_ocean.models.shallow_water import PrognosticVars

K = 4


@pytest.fixture(scope="module")
def setup():
    horz = planar_hex_mesh(16, 16, 1000.0, f0=1e-4, beta=1e-11)
    vert = make_vertical_mesh(
        horz, n_vert_levels=K,
        resting_thickness=np.full((horz.n_cells, K), 250.0),
    )
    mesh = Mesh(horz=horz, vert=vert).to_device()
    rng = np.random.default_rng(9)
    h = 250.0 + 0.05 * rng.normal(size=(horz.n_cells, K))
    u = 0.01 * rng.normal(size=(horz.n_edges, K))
    prog = PrognosticVars(
        ssh=jnp.asarray(h.sum(1) - np.asarray(vert.resting_thickness_sum)),
        layer_thickness=jnp.asarray(h),
        normal_velocity=jnp.asarray(u),
    )
    return mesh, prog


@pytest.mark.parametrize("q,n_super", [(2, 4), (4, 2), (8, 1)])
def test_composed_matches_stepwise_f64(setup, q, n_super):
    mesh, prog = setup
    dt = 5.0
    n = q * n_super
    ref = linearized_ref_loop(prog, mesh, dt, n)
    lmm = LinearizedMatrixModel.from_mesh(mesh, dt, q=q, dtype=np.float64)
    out = linearized_run_loop(prog, lmm, n_super)
    np.testing.assert_allclose(
        np.asarray(out.ssh), np.asarray(ref.ssh), rtol=1e-9, atol=1e-11
    )
    np.testing.assert_allclose(
        np.asarray(out.layer_thickness), np.asarray(ref.layer_thickness),
        rtol=1e-10,
    )
    np.testing.assert_allclose(
        np.asarray(out.normal_velocity), np.asarray(ref.normal_velocity),
        rtol=1e-8, atol=1e-11,
    )


def test_f32_drift_is_roundoff_scale(setup):
    """f32 A^q error (vs the f64 stepwise truth) stays within a small
    multiple of the f32 STEPWISE path's own error — composition does not
    amplify roundoff beyond reassociation noise."""
    mesh, prog = setup
    dt, q, n_super = 5.0, 4, 4
    n = q * n_super
    truth = linearized_ref_loop(prog, mesh, dt, n)
    p32 = PrognosticVars(
        ssh=prog.ssh.astype(jnp.float32),
        layer_thickness=prog.layer_thickness.astype(jnp.float32),
        normal_velocity=prog.normal_velocity.astype(jnp.float32),
    )
    ref32 = linearized_ref_loop(p32, mesh, dt, n, dtype=np.float32)
    lmm32 = LinearizedMatrixModel.from_mesh(mesh, dt, q=q, dtype=np.float32)
    out32 = linearized_run_loop(p32, lmm32, n_super)

    def err(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b)
        return np.linalg.norm(a - b) / np.linalg.norm(b)

    e_step = err(ref32.normal_velocity, truth.normal_velocity)
    e_comp = err(out32.normal_velocity, truth.normal_velocity)
    assert e_comp < 5.0 * max(e_step, 1e-7), (e_comp, e_step)


def test_composed_on_irregular_mesh():
    """A^q composition with genuinely non-uniform metrics (irregular
    Voronoi mesh): entries of GRAD/DIV/CORF all vary per element, so this
    pins the composition algebra beyond the lattice's uniform case."""
    from mpas_ocean.mesh.irregular import irregular_trisk_mesh

    horz = irregular_trisk_mesh(16, 16, 16000.0, 16000.0, jitter=0.25,
                                lloyd=2, seed=3, f0=1e-4)
    vert = make_vertical_mesh(
        horz, n_vert_levels=2,
        resting_thickness=np.full((horz.n_cells, 2), 100.0),
    )
    mesh = Mesh(horz=horz, vert=vert).to_device()
    rng = np.random.default_rng(11)
    h = 100.0 + 0.05 * rng.normal(size=(horz.n_cells, 2))
    u = 0.01 * rng.normal(size=(horz.n_edges, 2))
    prog = PrognosticVars(
        ssh=jnp.asarray(h.sum(1) - np.asarray(vert.resting_thickness_sum)),
        layer_thickness=jnp.asarray(h),
        normal_velocity=jnp.asarray(u),
    )
    dt, q, n_super = 2.0, 4, 2
    ref = linearized_ref_loop(prog, mesh, dt, q * n_super)
    lmm = LinearizedMatrixModel.from_mesh(mesh, dt, q=q, dtype=np.float64)
    out = linearized_run_loop(prog, lmm, n_super)
    np.testing.assert_allclose(
        np.asarray(out.layer_thickness), np.asarray(ref.layer_thickness),
        rtol=1e-10,
    )
    np.testing.assert_allclose(
        np.asarray(out.normal_velocity), np.asarray(ref.normal_velocity),
        rtol=1e-8, atol=1e-11,
    )


def test_composed_rejects_masked_configs():
    from mpas_ocean.mesh.cull import cull_cells

    horz = planar_hex_mesh(16, 16, 1000.0, f0=1e-4)
    y = np.asarray(horz.cells.y)
    keep = (y > 500.0) & (y < y.max() - 500.0)
    chan = cull_cells(horz, keep)
    vert = make_vertical_mesh(
        chan, n_vert_levels=2,
        resting_thickness=np.full((chan.n_cells, 2), 250.0),
    )
    mesh = Mesh(horz=chan, vert=vert).to_device()
    with pytest.raises(ValueError, match="unmasked"):
        LinearizedMatrixModel.from_mesh(mesh, 5.0, q=2)


def test_band_growth_recorded(setup):
    """The composed operator's stored bytes grow with q (band widening) —
    record the growth factor so the bytes-vs-dispatch tradeoff is visible
    and pinned."""
    mesh, _ = setup
    sizes = {}
    for q in (1, 2, 4):
        lmm = LinearizedMatrixModel.from_mesh(mesh, 5.0, q=q)
        sizes[q] = lmm.nbytes
    # denser but sub-linear in q per step: bytes(q)/q must FALL or stay
    # ~flat (the whole point: same-or-fewer streamed bytes per step, q-fold
    # fewer dispatches)
    assert sizes[4] / 4 < 1.5 * sizes[1], sizes
    assert sizes[2] / 2 < 1.5 * sizes[1], sizes
