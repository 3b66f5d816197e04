"""Spherical icosahedral mesh: structure, geometry, and a steady
geostrophically balanced zonal flow (the linear-dynamics analogue of
Williamson test case 2)."""

import jax.numpy as jnp
import numpy as np
import pytest

from mpas_ocean.constants import GRAVITY
from mpas_ocean.forward.run_loop import ocn_run_loop
from mpas_ocean.mesh.mesh import Mesh
from mpas_ocean.mesh.sphere import (
    EARTH_OMEGA,
    EARTH_RADIUS,
    icosphere_points,
    spherical_mesh,
)
from mpas_ocean.mesh.vert_mesh import make_vertical_mesh
from mpas_ocean.models.shallow_water import PrognosticVars
from mpas_ocean.ops import divergence_on_cell, tangential_reconstruction

N = 8  # 642 cells


@pytest.fixture(scope="module")
def sphere():
    return spherical_mesh(N)


def test_counts(sphere):
    assert sphere.n_cells == 10 * N * N + 2
    assert sphere.n_edges == 30 * N * N
    assert sphere.n_vertices == 20 * N * N
    ne = np.asarray(sphere.cells.n_edges_on_cell)
    assert (ne == 5).sum() == 12  # the icosahedral pentagons
    assert ((ne == 5) | (ne == 6)).all()


def test_areas(sphere):
    total = np.asarray(sphere.cells.area_cell).sum()
    np.testing.assert_allclose(total, 4 * np.pi * EARTH_RADIUS**2, rtol=1e-10)
    np.testing.assert_allclose(
        np.asarray(sphere.duals.area_triangle).sum(),
        4 * np.pi * EARTH_RADIUS**2,
        rtol=1e-6,
    )
    np.testing.assert_allclose(
        np.asarray(sphere.duals.kite_areas_on_vertex).sum(1),
        np.asarray(sphere.duals.area_triangle),
        rtol=1e-4,
    )


def test_coriolis_energy_neutrality(sphere):
    """Antisymmetry of the reconstruction weights (exact for constant f;
    with variable f the reference's donor-edge formulation is not exactly
    energy neutral — same property here)."""
    rng = np.random.default_rng(0)
    u = rng.normal(size=sphere.n_edges)
    area_e = 0.5 * np.asarray(sphere.edges.dc_edge) * np.asarray(sphere.edges.dv_edge)
    f0 = 1e-4
    tend = np.asarray(tangential_reconstruction((u * f0)[:, None], sphere))[:, 0]
    scale = np.sum(area_e * np.abs(u * tend))
    assert abs(np.sum(area_e * u * tend)) < 1e-12 * scale


def _balanced_state(horz, u0=20.0, H=5000.0):
    """Zonal flow u = u0 cos(lat); eta chosen for linear geostrophic
    balance: g d(eta)/(R dlat) = -f u."""
    R = horz.sphere_radius
    sinlat_c = np.asarray(horz.cells.z) / R
    eta = -(EARTH_OMEGA * u0 * R / GRAVITY) * sinlat_c**2
    sinlat_e = np.asarray(horz.edges.z) / R
    coslat_e = np.sqrt(np.maximum(0.0, 1.0 - sinlat_e**2))
    u_n = u0 * coslat_e * np.cos(np.asarray(horz.edges.angle_edge))
    h = (eta + H)[:, None]
    return eta, h, u_n[:, None]


def test_steady_geostrophic_flow(sphere):
    """A balanced zonal flow must stay (discretely) steady."""
    H = 5000.0
    vert = make_vertical_mesh(
        sphere, n_vert_levels=1, resting_thickness=np.full((sphere.n_cells, 1), H)
    )
    mesh = Mesh(horz=sphere, vert=vert).to_device()
    eta, h, u = _balanced_state(sphere, H=H)
    prog = PrognosticVars(
        ssh=jnp.asarray(eta),
        layer_thickness=jnp.asarray(h),
        normal_velocity=jnp.asarray(u),
    )
    # zonal flow is discretely near-divergence-free (truncation-level:
    # flow scale u0/dc ~ 2.5e-5 1/s, observed ~1e-8)
    div = np.asarray(divergence_on_cell(prog.normal_velocity, mesh))
    assert np.abs(div).max() < 1e-7

    dt = 300.0
    n = 50
    fin = ocn_run_loop(prog, mesh, dt, n)
    du = np.abs(np.asarray(fin.normal_velocity) - np.asarray(prog.normal_velocity))
    u_scale = np.abs(np.asarray(prog.normal_velocity)).max()
    # drift stays at discretization level after 50 steps (4+ hours)
    assert du.max() < 0.05 * u_scale
    dssh = np.abs(np.asarray(fin.ssh) - eta).max()
    assert dssh < 0.05 * np.abs(eta).max()


def test_icosphere_points_unique():
    pts = icosphere_points(4)
    assert len(pts) == 162
    np.testing.assert_allclose(np.linalg.norm(pts, axis=1), 1.0, atol=1e-12)
    # pairwise distinct
    from scipy.spatial import cKDTree

    d, _ = cKDTree(pts).query(pts, k=2)
    assert d[:, 1].min() > 1e-3


def test_nonlinear_on_sphere(sphere):
    """Williamson test case 2 proper: the balanced zonal flow is a steady
    solution of the FULL nonlinear shallow-water equations on the sphere
    (with the nonlinear terms the geostrophic ssh must balance both the
    Coriolis AND the u^2/2 metric term — here the linear-balance state is
    close enough at this amplitude to stay near-steady), and the TRiSK
    scheme must conserve energy: RK4 drift is time-discretization-only.
    Exercises kite areas, vertex PV and the symmetric flux on a truly
    unstructured spherical mesh (12 pentagons + hexagons)."""
    from mpas_ocean.models.shallow_water import (
        kinetic_energy_on_cell,
        potential_vorticity_on_vertex,
    )

    H = 5000.0
    vert = make_vertical_mesh(
        sphere, n_vert_levels=1, resting_thickness=np.full((sphere.n_cells, 1), H)
    )
    mesh = Mesh(horz=sphere, vert=vert).to_device()
    eta, h, u = _balanced_state(sphere, H=H)
    prog = PrognosticVars(
        ssh=jnp.asarray(eta),
        layer_thickness=jnp.asarray(h),
        normal_velocity=jnp.asarray(u),
    )
    q = potential_vorticity_on_vertex(prog, mesh)
    assert np.isfinite(np.asarray(q)).all()

    def total_energy(p):
        area = mesh.cells.area_cell
        ke = kinetic_energy_on_cell(p.normal_velocity, mesh)
        hh = p.layer_thickness
        return float(
            jnp.sum((ke * hh).sum(axis=1) * area)
            + 0.5 * GRAVITY * jnp.sum(p.ssh * p.ssh * area)
        )

    from mpas_ocean.forward.time_integration import RungeKutta4

    e0 = total_energy(prog)
    fin = ocn_run_loop(prog, mesh, 300.0, 50, method=RungeKutta4, nonlinear=True)
    assert np.isfinite(np.asarray(fin.normal_velocity)).all()
    # near-steady: nonlinear terms perturb the linear-balanced state only
    # at the u0^2/(g H) ~ 1e-2 level
    du = np.abs(np.asarray(fin.normal_velocity) - np.asarray(prog.normal_velocity))
    assert du.max() < 0.1 * np.abs(u).max()
    # energy conservation on the unstructured sphere
    drift = abs(total_energy(fin) - e0) / abs(e0)
    assert drift < 1e-7


def test_tracers_and_stratification_on_sphere(sphere):
    """Tracers and layered baroclinic dynamics on the truly unstructured
    icosahedral mesh (pentagons included): content exactly conserved,
    uniform tracer preserved, and the stratified run stays finite with the
    levels genuinely coupled."""
    from mpas_ocean.models.stratification import make_stratification
    from mpas_ocean.models.tracers import make_tracers, total_tracer_content

    K = 2
    vert = make_vertical_mesh(
        sphere, n_vert_levels=K,
        resting_thickness=np.full((sphere.n_cells, K), 2500.0),
    )
    mesh = Mesh(horz=sphere, vert=vert).to_device()
    rng = np.random.default_rng(3)
    h0 = np.asarray(vert.resting_thickness) + 5.0 * rng.standard_normal(
        (sphere.n_cells, K)
    )
    u0 = 0.5 * rng.standard_normal((sphere.n_edges, K))
    z = np.asarray(sphere.cells.z)
    tr = make_tracers(mesh, [10.0 + 5.0 * z / z.max(),
                             np.full(sphere.n_cells, 35.0)])
    from mpas_ocean.models.shallow_water import update_ssh

    prog = PrognosticVars(
        ssh=update_ssh(jnp.asarray(h0), mesh),
        layer_thickness=jnp.asarray(h0),
        normal_velocity=jnp.asarray(u0),
        tracers=tr,
    )
    strat = make_stratification([1025.0, 1026.0])
    c0 = np.asarray(total_tracer_content(prog.tracers, prog.layer_thickness, mesh))
    out = ocn_run_loop(prog, mesh, 30.0, 20, tracer_kappa=100.0, strat=strat)
    c1 = np.asarray(total_tracer_content(out.tracers, out.layer_thickness, mesh))
    np.testing.assert_allclose(c1, c0, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(out.tracers[:, 1]), 35.0, rtol=1e-9)
    assert np.isfinite(np.asarray(out.normal_velocity)).all()
    # stratification actually couples the levels
    du = np.abs(
        np.asarray(out.normal_velocity[:, 0] - out.normal_velocity[:, 1])
        - np.asarray(prog.normal_velocity[:, 0] - prog.normal_velocity[:, 1])
    )
    assert du.max() > 0

    # matrix path agrees on the sphere too
    from mpas_ocean.models.matrix_model import MatrixModel, matrix_run_loop

    mm = MatrixModel.from_mesh(mesh, dtype=np.float64)
    out_m = matrix_run_loop(prog, mm, 30.0, 20, tracer_kappa=100.0, strat=strat)
    np.testing.assert_allclose(
        np.asarray(out.tracers), np.asarray(out_m.tracers), atol=2e-10
    )
    np.testing.assert_allclose(
        np.asarray(out.normal_velocity), np.asarray(out_m.normal_velocity),
        atol=1e-12,
    )
