"""del2 momentum mixing + extended diagnostics + compare tool."""

import jax.numpy as jnp
import numpy as np
import pytest

from mpas_ocean.forward.run_loop import ocn_run_loop
from mpas_ocean.models.shallow_water import (
    PrognosticVars,
    del2_tendency,
    kinetic_energy_on_cell,
)
from mpas_ocean.verification.manufactured import PlanarTestFields


def test_del2_of_curl_free_field_converges():
    """On a curl-free (gradient) field del2 reduces to grad(div) and must
    converge; the vorticity branch of the MPAS del2 formulation is only
    first-order pointwise on hex meshes (the reference's own curl golden is
    16% at 48x48, test_Operators.jl:90-91), so the full-field case is
    checked for dissipativity instead (next test)."""
    from mpas_ocean.mesh import planar_hex_mesh
    from mpas_ocean.mesh.mesh import Mesh
    from mpas_ocean.mesh.vert_mesh import make_vertical_mesh

    errs = []
    for n in (16, 32):
        horz = planar_hex_mesh(n, n, 1000.0)
        mesh = Mesh(horz=horz, vert=make_vertical_mesh(horz)).to_device()
        fields = PlanarTestFields.from_mesh(horz)
        u = fields.grad_h_edge_normal(horz)[:, None]  # curl-free
        kx = 2 * np.pi / fields.lx
        ky = 2 * np.pi / fields.ly
        exact = -(kx**2 + ky**2) * u[:, 0]

        # the grad(div) branch alone is cleanly second order
        from mpas_ocean.ops import divergence_on_cell, gradient_on_edge

        D = divergence_on_cell(jnp.asarray(u), mesh)
        gd = np.asarray(gradient_on_edge(D, mesh))[:, 0]
        errs.append(np.linalg.norm(gd - exact) / np.linalg.norm(exact))

        # the full del2 (with the vorticity branch) stays bounded: the
        # curl's first-order noise divided by dv is O(1) relative to the
        # del2 signal — a property of the MPAS formulation itself, not a
        # bug (the reference's own curl golden is 16% at 48x48)
        num = np.asarray(del2_tendency(jnp.asarray(u), mesh, 1.0))[:, 0]
        assert np.linalg.norm(num - exact) < 0.5 * np.linalg.norm(exact)
    assert errs[1] < errs[0] / 3.0  # ~second order
    assert errs[1] < 0.01


def test_del2_damps_energy(mesh16):
    """Mixing must be dissipative: total KE decreases."""
    horz = mesh16.horz
    rng = np.random.default_rng(1)
    u0 = rng.normal(size=(horz.n_edges, 1))
    h0 = np.ones((horz.n_cells, 1))
    prog = PrognosticVars(
        ssh=jnp.zeros(horz.n_cells),
        layer_thickness=jnp.asarray(h0),
        normal_velocity=jnp.asarray(u0),
    )
    area_e = 0.5 * np.asarray(horz.edges.dc_edge) * np.asarray(horz.edges.dv_edge)

    def ke(u):
        return float((area_e * np.asarray(u)[:, 0] ** 2).sum())

    nu = 100.0  # m^2/s
    fin = ocn_run_loop(prog, mesh16, 1.0, 20, del2_coeff=nu)
    fin0 = ocn_run_loop(prog, mesh16, 1.0, 20, del2_coeff=0.0)
    assert ke(fin.normal_velocity) < ke(fin0.normal_velocity)


def test_kinetic_energy_uniform_flow(mesh16):
    """KE of a uniform flow |V|=const should be ~|V|^2/2 in every cell."""
    horz = mesh16.horz
    ang = np.asarray(horz.edges.angle_edge)
    V = np.array([3.0, 4.0])  # |V|^2 = 25
    u = (V[0] * np.cos(ang) + V[1] * np.sin(ang))[:, None]
    ke = np.asarray(kinetic_energy_on_cell(jnp.asarray(u), mesh16))[:, 0]
    np.testing.assert_allclose(ke, 12.5, rtol=1e-2)


def test_compare_tool(tmp_path):
    from mpas_ocean.forward.driver import ocn_run
    from mpas_ocean.tools import make_igw_case
    from mpas_ocean.tools.compare import compare_output

    cfg = make_igw_case(tmp_path, nx=16, resolution_km=200.0, duration_seconds=2000)
    ocn_run(cfg)
    result, fields = compare_output(tmp_path / "output.nc", "igw", lx=16 * 200.0)
    assert result["time"] == 2000.0
    assert result["rmse_ssh"] < 0.3 * result["rms_ssh_exact"]
