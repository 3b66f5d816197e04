"""YAML configuration with MPAS-style timestamp parsing.

Same schema as the reference (reference: src/infra/Config.jl): the YAML root
key ``omega`` holds the namelist sections, with a nested ``streams`` key that
is split out into its own config tree (Config.jl:96-116). MPAS timestamp
strings (``YYYY-MM-DD_hh:mm:ss`` datetimes, ``0000-00-00_04:00:00`` style
intervals) are auto-parsed during load (Config.jl:118-225).

Python type mapping of the reference's Julia `Dates` types:
  * DateTime              -> datetime.datetime
  * Year/Month periods    -> time_manager.CalendarPeriod (calendar arithmetic)
  * Day/Hour/Minute/Second-> datetime.timedelta
  * Time                  -> datetime.time

As an improvement over the reference (which warns and keeps the raw string,
Config.jl:218-224), multi-field intervals such as ``0000-00-03_04:30:00``
parse into a combined timedelta.
"""

from __future__ import annotations

import os
import re
import warnings
from datetime import datetime, time, timedelta
from typing import Any

from .time_manager import CalendarPeriod
from .yaml_subset import load as _load_yaml

# Same grammar as the reference's `timestamp_pat` (Config.jl:139-148):
# optional [[year-]month-]day, optional underscore, then hh:mm:ss.
TIMESTAMP_PAT = re.compile(
    r"^(?:"
    r"(?:(\d{1,4})-)?"  # year
    r"(?:(\d\d?)-)?"  # month
    r"(\d+)"  # day
    r")?"
    r"_?"
    r"(\d\d):"  # hour
    r"(\d\d):"  # minute
    r"(\d\d)"  # second
    r"$"
)

_PERIOD_FIELDS = ("years", "months", "days", "hours", "minutes", "seconds")


def _single_period(index: int, value: int):
    """One nonzero field -> the corresponding period type."""
    field = _PERIOD_FIELDS[index]
    if field in ("years", "months"):
        return CalendarPeriod(**{field: value})
    return timedelta(**{field: value})


def parse_timestamp(string: str):
    """Parse one MPAS timestamp string.

    Returns datetime / timedelta / CalendarPeriod / time, or the original
    string if it cannot be interpreted (mirrors DateTime_from_String,
    Config.jl:164-225).
    """
    mat = TIMESTAMP_PAT.match(string)
    if mat is None:
        raise ValueError(f"could not make sense of timestamp format: {string!r}")

    caps = mat.groups()

    # All six fields present with nonzero month & day -> a calendar datetime.
    if all(c is not None for c in caps):
        yr, mn, dy, h, m, s = (int(c) for c in caps)
        if mn != 0 and dy != 0:
            return datetime(yr, mn, dy, h, m, s)

    vals = [0 if c is None else int(c) for c in caps]
    nonzero = [i for i, v in enumerate(vals) if v != 0]

    if len(nonzero) == 1:
        return _single_period(nonzero[0], vals[nonzero[0]])

    h, m, s = vals[3], vals[4], vals[5]

    # No Y/M/D info at all -> a wall-clock time.
    if caps[0] is None and caps[1] is None and caps[2] is None:
        return time(h, m, s)

    # "D_hh:mm:ss" with zero days -> wall-clock time (reference behavior).
    if caps[0] is None and caps[1] is None and int(caps[2]) == 0:
        return time(h, m, s)

    # Improvement over reference: general intervals.
    if len(nonzero) == 0:
        return timedelta(0)
    yr, mn = vals[0], vals[1]
    if yr == 0 and mn == 0:
        return timedelta(days=vals[2], hours=h, minutes=m, seconds=s)
    return CalendarPeriod(
        years=yr, months=mn, days=vals[2], hours=h, minutes=m, seconds=s
    )


def _parse_tree(node: Any) -> Any:
    """Recursively parse timestamp strings in a dict tree."""
    if isinstance(node, dict):
        return {k: _parse_tree(v) for k, v in node.items()}
    if isinstance(node, str) and TIMESTAMP_PAT.match(node):
        return parse_timestamp(node)
    return node


class yaml_config:
    """A thin wrapper over a nested dict (reference: Config.jl:12-14).

    ``ConfigGet`` descends one key; if the result is itself a dict a new
    ``yaml_config`` wrapping it is returned (Config.jl:42-57).
    """

    def __init__(self, d: dict | None = None):
        self.dict = {} if d is None else d

    def get(self, key: str):
        value = self.dict[key]
        if isinstance(value, dict):
            return yaml_config(value)
        return value

    def add(self, key: str, value: Any) -> None:
        if key in self.dict:
            raise KeyError(
                f"ConfigAdd: variable {key} already exists, use ConfigSet instead"
            )
        self.dict[key] = value

    def set(self, key: str, value: Any) -> None:
        if key not in self.dict:
            raise KeyError(f"ConfigSet: could not find variable {key}")
        if type(self.dict[key]) is not type(value):
            warnings.warn(
                f"ConfigSet: changing type of {key!r}: "
                f"{type(self.dict[key]).__name__} != {type(value).__name__}"
            )
        self.dict[key] = value

    def __contains__(self, key: str) -> bool:
        return key in self.dict


class GlobalConfig:
    """Holds the namelist and streams config trees (Config.jl:23-26)."""

    def __init__(self, namelist: yaml_config | None = None, streams: yaml_config | None = None):
        self.namelist = namelist if namelist is not None else yaml_config()
        self.streams = streams if streams is not None else yaml_config()


# Omega-style free-function spellings, matching the reference export surface.
def ConfigGet(cfg: yaml_config, key: str):
    return cfg.get(key)


def ConfigAdd(cfg: yaml_config, key: str, value: Any) -> None:
    cfg.add(key, value)


def ConfigSet(cfg: yaml_config, key: str, value: Any) -> None:
    cfg.set(key, value)


def ConfigRead(filepath: str | os.PathLike) -> GlobalConfig:
    """Load a YAML config file and split into namelist + streams trees.

    (reference: Config.jl:96-116)
    """
    if not os.path.isfile(filepath):
        raise FileNotFoundError("YAML configuration file does not exist")

    with open(filepath) as f:
        config = _load_yaml(f.read())

    omega = config["omega"]
    streams = omega.pop("streams", {})

    streams = _parse_tree(streams)
    namelist = _parse_tree(omega)

    return GlobalConfig(yaml_config(namelist), yaml_config(streams))
