"""mpas_ocean — an unstructured-mesh (TRiSK) shallow-water ocean framework
built on JAX / XLA.

Brand-new design with the capabilities of the reference Julia package MOKA
(jlk9/MPAS-Ocean.jl): TRiSK C-grid discrete operators on Voronoi/Delaunay
meshes, layer-thickness + normal-velocity prognostic integration, YAML
config / ESMF-style clock, NetCDF I/O, and reverse-mode differentiation of
the whole rollout — designed around a compiler instead of hand launches:

  * mesh & state are immutable pytrees of padded, 0-based, masked arrays
  * operators are pure jnp functions fused by XLA under one `jit`
  * the time loop is a `lax.scan` (no host round-trips per step)
  * adjoints come from `jax.grad` through the scan (vs Enzyme in reference)
  * multi-device runs use `shard_map` domain decomposition with halo
    exchange through XLA collectives, not MPI

Float64 note: the reference is Float64 throughout (its arrays come from
NetCDF doubles). Precision is a first-class, explicit parameter here:
every constructor takes a ``dtype``; tests validate f64 on the CPU, and the
GPU runs f64 natively as well as f32. We enable the x64 flag at import
(unless MOT_DISABLE_X64 is set) so f64 is *available*; individual arrays
keep whatever dtype they were built with.
"""

import os as _os

import jax as _jax

if not _os.environ.get("MOT_DISABLE_X64"):
    _jax.config.update("jax_enable_x64", True)

from .constants import GRAVITY
from .mesh import (
    Edges,
    HorzMesh,
    Mesh,
    PrimaryCells,
    DualCells,
    VerticalMesh,
    planar_hex_mesh,
)
from .infra.config import ConfigRead, GlobalConfig, yaml_config
from .infra.time_manager import (
    Clock,
    OneTimeAlarm,
    PeriodicAlarm,
    mpas_create_clock,
)
from .ops import (
    curl_on_vertex,
    divergence_on_cell,
    gradient_on_edge,
    interpolate_cell_to_edge,
    interpolate_cell_to_vertex,
    interpolate_vertex_to_edge,
    tangential_reconstruction,
)
from .models.shallow_water import (
    DiagnosticVars,
    PrognosticVars,
    TendencyVars,
    compute_diagnostics,
    compute_layer_thickness_tendency,
    compute_normal_velocity_tendency,
    kinetic_energy_on_cell,
    potential_vorticity_on_vertex,
    pv_flux_tendency,
)
from .models.matrix_model import MatrixModel, matrix_run_loop, matrix_step
from .models.tracers import make_tracers, total_tracer_content, tracer_tendency
from .models.stratification import (
    Stratification,
    baroclinic_wave_speeds,
    make_stratification,
    montgomery_potential,
)
from .models.forcing import Forcing, forcing_tendency, make_forcing
from .forward.time_integration import (
    ForwardBackward,
    ForwardEuler,
    RungeKutta4,
    ocn_timestep,
)
from .forward.run_loop import ocn_run_loop, ocn_run_loop_objective

__all__ = [
    "GRAVITY",
    "Edges",
    "HorzMesh",
    "Mesh",
    "PrimaryCells",
    "DualCells",
    "VerticalMesh",
    "planar_hex_mesh",
    "ConfigRead",
    "GlobalConfig",
    "yaml_config",
    "Clock",
    "OneTimeAlarm",
    "PeriodicAlarm",
    "mpas_create_clock",
    "curl_on_vertex",
    "divergence_on_cell",
    "gradient_on_edge",
    "interpolate_cell_to_edge",
    "interpolate_cell_to_vertex",
    "interpolate_vertex_to_edge",
    "tangential_reconstruction",
    "DiagnosticVars",
    "PrognosticVars",
    "TendencyVars",
    "compute_diagnostics",
    "compute_layer_thickness_tendency",
    "compute_normal_velocity_tendency",
    "kinetic_energy_on_cell",
    "potential_vorticity_on_vertex",
    "pv_flux_tendency",
    "MatrixModel",
    "make_tracers",
    "Stratification",
    "baroclinic_wave_speeds",
    "make_stratification",
    "montgomery_potential",
    "total_tracer_content",
    "tracer_tendency",
    "matrix_run_loop",
    "matrix_step",
    "ForwardBackward",
    "ForwardEuler",
    "RungeKutta4",
    "ocn_timestep",
    "ocn_run_loop",
    "ocn_run_loop_objective",
]

__version__ = "0.1.0"
