"""Model initialization from a YAML config.

(reference: src/forward/init.jl — config -> mesh -> clock -> state. The
addition is `plan_steps`, which compiles the clock + alarms
down to a static step count and output stride *before* entering jit, so the
run loop is a single `lax.scan` with no host-side clock in the hot path.)
"""

from __future__ import annotations

from dataclasses import dataclass
from datetime import datetime, timedelta

import jax.numpy as jnp
import numpy as np

from ..infra.config import ConfigGet, ConfigRead, GlobalConfig
from ..infra.time_manager import Clock, OneTimeAlarm, PeriodicAlarm, mpas_create_clock
from ..mesh.io import (
    horz_mesh_from_ncdata,
    read_initial_state,
    vertical_mesh_from_ncdata,
)
from ..infra.netcdf import read_netcdf
from ..mesh.mesh import Mesh
from ..models.shallow_water import PrognosticVars
from .time_integration import ForwardBackward, ForwardEuler, RungeKutta4

_INTEGRATORS = {
    "ForwardEuler": ForwardEuler,
    "RungeKutta4": RungeKutta4,
    "ForwardBackward": ForwardBackward,
}


@dataclass
class ModelSetup:
    """(reference: src/infra/ModelSetup.jl:4-9)"""

    config: GlobalConfig
    mesh: Mesh
    time_manager: Clock
    integrator: type = ForwardEuler
    # vector-invariant (nonlinear) dynamics — a capability beyond the
    # reference's linear core (reference: README.MD:12); selected by the
    # optional namelist key time_integration: config_nonlinear_dynamics
    nonlinear: bool = False
    # momentum forcing (wind stress / bottom drag / Rayleigh) from the
    # optional namelist section `forcing` — the subsystem the reference
    # stubs as an empty file (reference: src/ocn/ForcingVars.jl)
    forcing: object = None
    # tracer transport (temperature/salinity/..., models/tracers.py) from
    # the optional namelist section `tracer_transport` — state slots the
    # reference stubs out (reference: src/ocn/PrognosticVars.jl:20-26)
    tracer_names: tuple = ()
    tracer_kappa: float = 0.0
    tracer_upwind: float = 1.0
    # layered baroclinic stratification (models/stratification.py) from the
    # optional namelist section `stratification` — BEYOND the reference,
    # whose K levels never interact (pressure_gradient.jl:45-65)
    strat: object = None


def ocn_setup_mesh(config: GlobalConfig, dtype=np.float64) -> Mesh:
    """(reference: init.jl:43-55)"""
    mesh_cfg = ConfigGet(config.streams, "mesh")
    mesh_fp = ConfigGet(mesh_cfg, "filename_template")
    ds = read_netcdf(mesh_fp)
    horz = horz_mesh_from_ncdata(ds, dtype=dtype)
    vert = vertical_mesh_from_ncdata(ds, horz, dtype=dtype)
    return Mesh(horz=horz, vert=vert)


def ocn_setup_clock(config: GlobalConfig) -> Clock:
    """(reference: init.jl:57-108)"""
    output_cfg = ConfigGet(config.streams, "output")
    tm_cfg = ConfigGet(config.namelist, "time_management")
    ti_cfg = ConfigGet(config.namelist, "time_integration")

    dt = ConfigGet(ti_cfg, "config_dt")
    stop_time = ConfigGet(tm_cfg, "config_stop_time")
    start_time = ConfigGet(tm_cfg, "config_start_time")
    run_duration = ConfigGet(tm_cfg, "config_run_duration")

    output_reference_time = ConfigGet(output_cfg, "reference_time")
    output_interval = ConfigGet(output_cfg, "output_interval")

    if run_duration != "none":
        clock = mpas_create_clock(dt, start_time, run_duration=run_duration)
        derived = start_time + run_duration
        if stop_time != "none" and stop_time != derived:
            print(
                "Warning: config_run_duration and config_stop_time are "
                "inconsistent: using config_run_duration."
            )
        stop_time = derived
    elif stop_time != "none":
        clock = mpas_create_clock(dt, start_time, stop_time=stop_time)
    else:
        raise ValueError(
            "neither config_run_duration nor config_stop_time were specified"
        )

    clock.attach_alarm(OneTimeAlarm("simulation_end", stop_time))
    clock.attach_alarm(
        PeriodicAlarm("outputAlarm", output_interval, output_reference_time)
    )
    return clock


def ocn_init(config_fp, dtype=np.float64):
    """Build (Setup, PrognosticVars) from a config file
    (reference: init.jl:3-30; Diagnostic/Tendency vars need no allocation
    here — they are pure function outputs)."""
    config = ConfigRead(config_fp)
    mesh = ocn_setup_mesh(config, dtype=dtype).to_device()
    clock = ocn_setup_clock(config)

    ti_cfg = ConfigGet(config.namelist, "time_integration")
    integrator = ForwardEuler
    if "config_time_integrator" in ti_cfg:
        integrator = _INTEGRATORS[ConfigGet(ti_cfg, "config_time_integrator")]

    nonlinear = bool(
        "config_nonlinear_dynamics" in ti_cfg
        and ConfigGet(ti_cfg, "config_nonlinear_dynamics")
    )
    forcing = _forcing_from_config(config, mesh, dtype)
    tracer_names, tracer_kappa, tracer_upwind = _tracer_opts_from_config(config)
    strat = _strat_from_config(config, mesh, dtype)
    setup = ModelSetup(config, mesh, clock, integrator, nonlinear, forcing,
                       tracer_names, tracer_kappa, tracer_upwind, strat)

    tm_cfg = ConfigGet(config.namelist, "time_management")
    if ConfigGet(tm_cfg, "config_do_restart"):
        # improvement over the reference, which raises "restart not yet
        # supported" (PrognosticVars.jl:62-65): restart from a prior output
        # file named by the restart stream
        restart_cfg = ConfigGet(config.streams, "restart")
        input_fp = ConfigGet(restart_cfg, "filename_template")
    else:
        input_cfg = ConfigGet(config.streams, "input")
        input_fp = ConfigGet(input_cfg, "filename_template")

    ssh, h, u = read_initial_state(input_fp, mesh.n_vert_levels)
    tracers = None
    if tracer_names:
        from ..mesh.io import read_tracers

        tracers = jnp.asarray(
            read_tracers(
                input_fp, tracer_names, mesh.n_cells, mesh.n_vert_levels
            ).astype(dtype)
            * np.asarray(mesh.vert.cell_level_mask, dtype)[:, None, :]
        )
    prog = PrognosticVars(
        ssh=jnp.asarray(ssh.astype(dtype)),
        layer_thickness=jnp.asarray(h.astype(dtype)),
        normal_velocity=jnp.asarray(u.astype(dtype)),
        tracers=tracers,
    )
    return setup, prog


def _strat_from_config(config: GlobalConfig, mesh: Mesh, dtype):
    """Optional namelist section `stratification` ->
    models.stratification.Stratification (or None when absent). Keys:
    config_layer_densities (list of K densities, top first, kg/m^3),
    config_density0 (reference density, default 1026)."""
    if "stratification" not in config.namelist:
        return None
    from ..models.forcing import RHO0
    from ..models.stratification import make_stratification

    s_cfg = ConfigGet(config.namelist, "stratification")
    rho = ConfigGet(s_cfg, "config_layer_densities")
    rho = [float(r) for r in (rho if isinstance(rho, list) else [rho])]
    if len(rho) != mesh.n_vert_levels:
        raise ValueError(
            f"config_layer_densities has {len(rho)} entries but the mesh "
            f"carries {mesh.n_vert_levels} levels"
        )
    rho0 = (
        float(ConfigGet(s_cfg, "config_density0"))
        if "config_density0" in s_cfg else RHO0
    )
    return make_stratification(rho, rho0=rho0, dtype=dtype)


def _tracer_opts_from_config(config: GlobalConfig):
    """Optional namelist section `tracer_transport` ->
    (names tuple, kappa, upwind). Keys: config_tracer_names (list of
    variable names read from the input stream), config_tracer_del2
    [m^2/s, default 0], config_tracer_upwind (blend in [0, 1], default 1 —
    the monotone donor-cell end; 0 is the 2nd-order centered mean)."""
    if "tracer_transport" not in config.namelist:
        return (), 0.0, 1.0
    t_cfg = ConfigGet(config.namelist, "tracer_transport")
    names = ConfigGet(t_cfg, "config_tracer_names")
    if isinstance(names, str):
        names = [names]
    kappa = (
        float(ConfigGet(t_cfg, "config_tracer_del2"))
        if "config_tracer_del2" in t_cfg else 0.0
    )
    upwind = (
        float(ConfigGet(t_cfg, "config_tracer_upwind"))
        if "config_tracer_upwind" in t_cfg else 1.0
    )
    if not 0.0 <= upwind <= 1.0:
        raise ValueError(f"config_tracer_upwind must be in [0, 1]; got {upwind}")
    return tuple(names), kappa, upwind


def _forcing_from_config(config: GlobalConfig, mesh: Mesh, dtype):
    """Optional namelist section `forcing` -> models.forcing.Forcing (or
    None when absent / all-zero). Keys (all optional, default 0):
    config_wind_stress_zonal / _meridional [N/m^2],
    config_bottom_drag_linear [1/s], config_bottom_drag_quadratic [Cd],
    config_rayleigh_damping [1/s], config_density0 [kg/m^3, default 1026].
    """
    if "forcing" not in config.namelist:
        return None
    from ..models.forcing import RHO0, make_forcing

    f_cfg = ConfigGet(config.namelist, "forcing")

    def val(key, default=0.0):
        return float(ConfigGet(f_cfg, key)) if key in f_cfg else default

    kwargs = dict(
        wind_stress_zonal=val("config_wind_stress_zonal"),
        wind_stress_meridional=val("config_wind_stress_meridional"),
        bottom_drag_linear=val("config_bottom_drag_linear"),
        bottom_drag_quadratic=val("config_bottom_drag_quadratic"),
        rayleigh=val("config_rayleigh_damping"),
    )
    if not any(kwargs.values()):
        return None
    return make_forcing(
        mesh, rho0=val("config_density0", RHO0), dtype=dtype, **kwargs
    )


def ocn_init_alarms(setup: ModelSetup):
    """Recompute dt from mean edge spacing and fetch the alarms — the
    reference quirk kept for parity (init.jl:111-127, SURVEY quirk 7.4:
    config_dt is discarded; dt = floor(2*(mean(dc)/1e3)*mean(dc)/200e3) s)."""
    dc = np.asarray(setup.mesh.edges.dc_edge)
    dt = float(np.floor(2.0 * (dc.mean() / 1e3) * dc.mean() / 200e3))
    setup.time_manager.change_time_step(timedelta(seconds=dt))
    clock = setup.time_manager
    return clock, clock.alarms["simulation_end"], clock.alarms["outputAlarm"]


def plan_steps(clock: Clock) -> tuple[int, int]:
    """Compile the clock + alarms to (n_steps, output_every) static ints.

    Respects the reference's exact-equality alarm semantics
    (TimeManager.jl:127-129): if dt does not evenly divide the output
    interval, the output alarm never fires (output_every = 0).
    """
    stop = clock.alarms["simulation_end"].ring_time
    dt = clock.time_step
    dt_s = dt.total_seconds()
    total_s = (stop - clock.curr_time).total_seconds()
    n_steps = int(round(total_s / dt_s))
    if abs(n_steps * dt_s - total_s) > 1e-9:
        n_steps = int(np.ceil(total_s / dt_s))

    out = clock.alarms.get("outputAlarm")
    output_every = 0
    if out is not None:
        iv = out.ring_interval
        if isinstance(iv, timedelta):
            iv_s = iv.total_seconds()
            if iv_s > 0 and abs(iv_s / dt_s - round(iv_s / dt_s)) < 1e-9:
                output_every = int(round(iv_s / dt_s))
        elif iv is not None:
            # calendar periods (months/years, CalendarPeriod) have
            # no fixed second count, so a static per-N-steps output plan
            # cannot represent them — reject loudly instead of silently
            # degrading to end-only output
            raise ValueError(
                "output_interval uses a calendar period "
                f"({iv!r}); plan_steps only supports fixed-length "
                "intervals that dt divides evenly — use days or smaller"
            )
    return n_steps, output_every
