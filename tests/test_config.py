"""Config-system unit tests (mirrors reference test/infra/test_Config.jl and
its fixture test/infra/test.yaml)."""

from datetime import datetime, time, timedelta

import pytest

from mpas_ocean.infra.config import (
    ConfigGet,
    ConfigRead,
    CalendarPeriod,
    parse_timestamp,
    yaml_config,
)

FIXTURE = """
omega:
  hmix:
    hmix_String: Restart_timestamp
    hmix_Float: 1.234567890
    hmix_None: none
    hmix_On: true
    hmix_Off: false
    hmix_Exp: 1.e25
  streams:
    intervals:
      yearly_interval:  0001-00-00_00:00:00
      monthly_interval: 0000-02-00_00:00:00
      daily_interval:   0000-00-03_00:00:00
      hourly_interval:  0000-00-00_04:00:00
      minutes_interval: 0000-00-00_00:05:00
      seconds_interval: 0000-00-00_00:00:06
    datetimes:
      NO_HMS:  0001-01-01_00:00:00
      ALL_HMS: 0001-01-01_02:03:04
"""


@pytest.fixture(scope="module")
def config(tmp_path_factory):
    p = tmp_path_factory.mktemp("cfg") / "test.yaml"
    p.write_text(FIXTURE)
    return ConfigRead(p)


def test_namelist_scalars(config):
    hmix = ConfigGet(config.namelist, "hmix")
    assert ConfigGet(hmix, "hmix_String") == "Restart_timestamp"
    assert ConfigGet(hmix, "hmix_Float") == pytest.approx(1.23456789)
    assert ConfigGet(hmix, "hmix_None") == "none"
    assert ConfigGet(hmix, "hmix_On") is True
    assert ConfigGet(hmix, "hmix_Off") is False
    assert ConfigGet(hmix, "hmix_Exp") == pytest.approx(1e25)


def test_stream_intervals(config):
    iv = ConfigGet(ConfigGet(config.streams, "intervals"), "yearly_interval")
    assert iv == CalendarPeriod(years=1)
    iv = ConfigGet(ConfigGet(config.streams, "intervals"), "monthly_interval")
    assert iv == CalendarPeriod(months=2)
    intervals = ConfigGet(config.streams, "intervals")
    assert ConfigGet(intervals, "daily_interval") == timedelta(days=3)
    assert ConfigGet(intervals, "hourly_interval") == timedelta(hours=4)
    assert ConfigGet(intervals, "minutes_interval") == timedelta(minutes=5)
    assert ConfigGet(intervals, "seconds_interval") == timedelta(seconds=6)


def test_stream_datetimes(config):
    dts = ConfigGet(config.streams, "datetimes")
    assert ConfigGet(dts, "NO_HMS") == datetime(1, 1, 1, 0, 0, 0)
    assert ConfigGet(dts, "ALL_HMS") == datetime(1, 1, 1, 2, 3, 4)


def test_timestamp_forms():
    assert parse_timestamp("0001-01-01_02:03:04") == datetime(1, 1, 1, 2, 3, 4)
    assert parse_timestamp("02:03:04") == time(2, 3, 4)
    assert parse_timestamp("0_02:03:04") == time(2, 3, 4)
    # improvement over reference: combined interval parses instead of warning
    assert parse_timestamp("0000-00-03_04:30:00") == timedelta(days=3, hours=4, minutes=30)


def test_config_add_set():
    cfg = yaml_config({"a": 1})
    with pytest.raises(KeyError):
        cfg.add("a", 2)
    cfg.add("b", 3)
    with pytest.raises(KeyError):
        cfg.set("zzz", 0)
    with pytest.warns(UserWarning):
        cfg.set("b", "now-a-string")
    assert cfg.get("b") == "now-a-string"


@pytest.mark.parametrize(
    "text,expected",
    [
        ("a:\n  b: 1\n  c: 2.5\n", {"a": {"b": 1, "c": 2.5}}),
        ("a: [temperature, salinity]\n",
         {"a": ["temperature", "salinity"]}),
        ("a: [1025.0, 1026.5]  # densities\n", {"a": [1025.0, 1026.5]}),
        ("# header\na: 'x # not a comment'\nb: \"q\\\"d\"\n",
         {"a": "x # not a comment", "b": 'q"d'}),
        ("a:\n  b:\n    c: true\n  d: ~\ne: none\n",
         {"a": {"b": {"c": True}, "d": None}, "e": "none"}),
        ("t: 0001-01-01_00:00:00\nx: 1.e25\ny: -3\n",
         {"t": "0001-01-01_00:00:00", "x": 1e25, "y": -3}),
        ("a:\nb: []\n", {"a": None, "b": []}),
    ],
    ids=["nested", "flow-words", "flow-floats", "quotes", "deep",
         "timestamp-float-int", "empty"],
)
def test_yaml_subset_parses(text, expected):
    from mpas_ocean.infra.yaml_subset import load

    assert load(text) == expected


@pytest.mark.parametrize(
    "text",
    ["a:\n  - 1\n  - 2\n", "a: &anchor 1\n", "a: 1\n a: 2\n",
     "a: 1\na: 2\n", "a: [1, [2]]\n", "just a string\n"],
    ids=["block-seq", "anchor", "bad-indent", "duplicate", "nested-flow",
         "no-key"],
)
def test_yaml_subset_rejects_unsupported(text):
    from mpas_ocean.infra.yaml_subset import load

    with pytest.raises(ValueError):
        load(text)


@pytest.mark.parametrize(
    "start,period,expected",
    [
        (datetime(2001, 1, 31), CalendarPeriod(months=1), datetime(2001, 2, 28)),
        (datetime(2000, 1, 31), CalendarPeriod(months=1), datetime(2000, 2, 29)),
        (datetime(2001, 11, 15), CalendarPeriod(months=3), datetime(2002, 2, 15)),
        (datetime(2001, 3, 1), CalendarPeriod(years=1, days=2, hours=3),
         datetime(2002, 3, 3, 3)),
    ],
    ids=["clamp", "leap", "year-wrap", "mixed"],
)
def test_calendar_period_arithmetic(start, period, expected):
    assert start + period == expected
    assert period + start == expected
    # subtraction steps back by the same calendar rule
    assert (start + period) - period <= start


def test_calendar_period_equality_and_negation():
    assert CalendarPeriod(years=1) == CalendarPeriod(months=12)
    assert CalendarPeriod(months=1) != CalendarPeriod(months=1, days=1)
    assert datetime(2001, 3, 31) - CalendarPeriod(months=1) == datetime(2001, 2, 28)


def test_main_path_imports_without_yaml_or_dateutil(tmp_path):
    """`import mpas_ocean` and the CLI driver need only jax, numpy and
    scipy: with PyYAML and python-dateutil made unimportable they still
    load, and a config file still parses."""
    import os
    import subprocess
    import sys
    import textwrap

    code = textwrap.dedent(
        """
        import sys
        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("yaml", "dateutil", "h5py"):
                    raise ImportError("blocked: " + name)
        sys.meta_path.insert(0, Block())
        import mpas_ocean
        import mpas_ocean.forward.driver
        from mpas_ocean.infra.config import ConfigRead
        cfg = ConfigRead(sys.argv[1])
        assert cfg.namelist.get("a").get("dt").total_seconds() == 600
        loaded = {m.split(".")[0] for m in sys.modules}
        assert not loaded & {"yaml", "dateutil", "h5py"}, loaded
        print("ok")
        """
    )
    cfg = tmp_path / "c.yml"
    cfg.write_text("omega:\n  a:\n    dt: 0000-00-00_00:10:00\n")
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code, str(cfg)],
                       capture_output=True, text=True, timeout=300, env=env,
                       cwd=root)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().endswith("ok")


@pytest.mark.parametrize(
    "variant", ["plain", "forcing", "tracers", "stratification"],
)
def test_generated_case_config_parses(tmp_path, variant):
    """Every config section tools/cases.py writes parses to typed values."""
    from mpas_ocean.tools.cases import make_igw_case

    kw = {
        "plain": {},
        "forcing": {"forcing": {"config_wind_stress_zonal": 0.1,
                                "config_bottom_drag_quadratic": 2.5e-3}},
        "tracers": {"tracers": True, "tracer_del2": 5.0},
        "stratification": {"n_vert_levels": 2,
                           "layer_densities": [1025.0, 1026.5]},
    }[variant]
    cfg = ConfigRead(make_igw_case(tmp_path / "case", nx=4, **kw))
    ti = ConfigGet(cfg.namelist, "time_integration")
    assert ConfigGet(ti, "config_dt") == timedelta(seconds=400)
    assert ConfigGet(ti, "config_nonlinear_dynamics") is False
    assert ConfigGet(ti, "config_time_integrator") == "ForwardEuler"
    tm = ConfigGet(cfg.namelist, "time_management")
    assert ConfigGet(tm, "config_do_restart") is False
    assert ConfigGet(tm, "config_start_time") == datetime(1, 1, 1)
    out = ConfigGet(cfg.streams, "output")
    assert ConfigGet(out, "filename_template").endswith("output.nc")
    if variant == "forcing":
        f = ConfigGet(cfg.namelist, "forcing")
        assert ConfigGet(f, "config_wind_stress_zonal") == 0.1
        assert ConfigGet(f, "config_bottom_drag_quadratic") == 2.5e-3
    if variant == "tracers":
        t = ConfigGet(cfg.namelist, "tracer_transport")
        assert ConfigGet(t, "config_tracer_names") == ["temperature",
                                                       "salinity"]
        assert ConfigGet(t, "config_tracer_del2") == 5.0
    if variant == "stratification":
        s = ConfigGet(cfg.namelist, "stratification")
        assert ConfigGet(s, "config_layer_densities") == [1025.0, 1026.5]
