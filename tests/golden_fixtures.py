"""Shared definitions for the bit-stability golden fixtures.

The reference pins operator error norms to 1e-8 golden values on ITS mesh
instance (reference: test/ocn/test_Operators.jl:52-91); this repo's meshes
are generated, so tests/test_operators.py can only gate magnitudes (rel
5e-2). These fixtures close that gap: exact f64 CPU values computed from the IN-REPO meshes, pinned at
rtol 1e-13, so a refactor that drifts results by even 1e-10 relative is
caught. Regenerate deliberately with `python tests/golden_fixtures.py`
after an INTENDED numerics change.
"""

from __future__ import annotations

import json
import os

import numpy as np

GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "golden", "golden.json")


def _weights(n: int, seed: int) -> np.ndarray:
    """Deterministic pseudo-random weights: positional checksums that catch
    permutations/sign flips a plain sum would miss."""
    return np.random.default_rng(seed).standard_normal(n)


def compute_golden() -> dict:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from mpas_ocean.forward.run_loop import ocn_run_loop
    from mpas_ocean.forward.time_integration import RungeKutta4
    from mpas_ocean.mesh import planar_hex_mesh
    from mpas_ocean.mesh.mesh import Mesh
    from mpas_ocean.mesh.vert_mesh import make_vertical_mesh
    from mpas_ocean.models.shallow_water import PrognosticVars
    from mpas_ocean.ops import (
        curl_on_vertex,
        divergence_on_cell,
        gradient_on_edge,
    )
    from mpas_ocean.utils.errors import error_measures
    from mpas_ocean.verification.inertial_gravity_wave import (
        InertialGravityWave,
    )
    from mpas_ocean.verification.manufactured import PlanarTestFields

    out: dict = {}

    # --- operator error norms, 48x48 in-repo mesh (cf. the reference's
    # goldens on its gist mesh, test_Operators.jl:52-91) ---------------
    horz = planar_hex_mesh(48, 48, 1000.0)
    vert = make_vertical_mesh(horz, n_vert_levels=1)
    mesh = Mesh(horz=horz, vert=vert).to_device()
    fields = PlanarTestFields.from_mesh(horz)
    h = np.asarray(fields.h(horz.cells.x, horz.cells.y))[:, None]
    f_e = np.asarray(fields.f_edge_normal(horz))[:, None]

    grad = np.asarray(gradient_on_edge(jnp.asarray(h), mesh))
    err = error_measures(
        grad, np.asarray(fields.grad_h_edge_normal(horz))[:, None], mesh, "edge"
    )
    out["op_grad_Linf"], out["op_grad_L2"] = float(err.L_inf), float(err.L_two)
    div = np.asarray(divergence_on_cell(jnp.asarray(f_e), mesh))
    err = error_measures(
        div, np.asarray(fields.div_f(horz.cells.x, horz.cells.y))[:, None],
        mesh, "cell",
    )
    out["op_div_Linf"], out["op_div_L2"] = float(err.L_inf), float(err.L_two)
    curl = np.asarray(curl_on_vertex(jnp.asarray(f_e), mesh))
    err = error_measures(
        curl, np.asarray(fields.curl_f(horz.duals.x, horz.duals.y))[:, None],
        mesh, "vertex",
    )
    out["op_curl_Linf"], out["op_curl_L2"] = float(err.L_inf), float(err.L_two)

    # --- N-step IGW rollout state checksums (f64, CPU) -----------------
    nx = 32
    dc = 10000.0e3 / nx
    horz = planar_hex_mesh(nx, nx, dc, f0=1e-4)
    vert = make_vertical_mesh(
        horz, n_vert_levels=1,
        resting_thickness=np.full((horz.n_cells, 1), 1000.0),
    )
    mesh = Mesh(horz=horz, vert=vert).to_device()
    igw = InertialGravityWave()
    ssh, hh, u = igw.initial_state(horz)
    prog = PrognosticVars(
        ssh=jnp.asarray(ssh),
        layer_thickness=jnp.asarray(hh),
        normal_velocity=jnp.asarray(u),
    )
    wc = _weights(horz.n_cells, 0)
    we = _weights(horz.n_edges, 1)
    for name, method, n in (
        ("igw_fe50", None, 50),
        ("igw_rk4_20", RungeKutta4, 20),
    ):
        if method is None:
            fin = ocn_run_loop(prog, mesh, 600.0, n)
        else:
            fin = ocn_run_loop(prog, mesh, 600.0, n, method)
        out[f"{name}_ssh_dot"] = float(wc @ np.asarray(fin.ssh))
        out[f"{name}_u_dot"] = float(we @ np.asarray(fin.normal_velocity)[:, 0])
        out[f"{name}_ssh_l2"] = float(np.linalg.norm(np.asarray(fin.ssh)))
        out[f"{name}_u_l2"] = float(
            np.linalg.norm(np.asarray(fin.normal_velocity))
        )
    return out


def main():
    os.makedirs(os.path.dirname(GOLDEN_PATH), exist_ok=True)
    vals = compute_golden()
    with open(GOLDEN_PATH, "w") as f:
        json.dump(vals, f, indent=1, sort_keys=True)
    print(f"wrote {len(vals)} golden values to {GOLDEN_PATH}")


if __name__ == "__main__":
    main()
