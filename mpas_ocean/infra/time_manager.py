"""ESMF-style simulation clock with one-time and periodic alarms.

Host-side pure Python, same semantics as the reference
(reference: src/infra/TimeManager.jl). Here the clock never
enters the compiled region: before a run, the clock + alarms are compiled
down to a static number of steps and a set of output step indices
(see forward/run_loop.py), so the hot loop is a single `lax.scan`.

Note the reference quirk kept on purpose: an alarm rings only on *exact*
DateTime equality with the current time (TimeManager.jl:127-129), so the
timestep must evenly divide alarm intervals.
"""

from __future__ import annotations

import calendar
from dataclasses import dataclass
from datetime import datetime, timedelta
from typing import Optional, Union


@dataclass(frozen=True, init=False)
class CalendarPeriod:
    """A period of whole years and months plus a fixed-length part — the
    reference's Julia ``Year``/``Month`` periods (Config.jl:118-225).

    Adding it to a datetime moves the calendar month first and clamps the
    day to the target month's length (Jan 31 + 1 month = Feb 28/29), then
    adds the fixed part. Years are stored as 12 months, so
    ``CalendarPeriod(years=1) == CalendarPeriod(months=12)``.
    """

    months: int
    delta: timedelta

    def __init__(self, years: int = 0, months: int = 0, days: int = 0,
                 hours: int = 0, minutes: int = 0, seconds: int = 0):
        object.__setattr__(self, "months", 12 * int(years) + int(months))
        object.__setattr__(self, "delta", timedelta(
            days=days, hours=hours, minutes=minutes, seconds=seconds))

    def __add__(self, other):
        if not isinstance(other, datetime):
            return NotImplemented
        year, month0 = divmod(other.year * 12 + other.month - 1 + self.months,
                              12)
        day = min(other.day, calendar.monthrange(year, month0 + 1)[1])
        return other.replace(year=year, month=month0 + 1, day=day) + self.delta

    __radd__ = __add__

    def __neg__(self) -> "CalendarPeriod":
        out = CalendarPeriod(months=-self.months)
        object.__setattr__(out, "delta", -self.delta)
        return out

    def __rsub__(self, other):
        if not isinstance(other, datetime):
            return NotImplemented
        return other + (-self)

    def __repr__(self) -> str:
        return f"CalendarPeriod(months={self.months}, delta={self.delta!r})"


Period = Union[timedelta, CalendarPeriod]


class AbstractAlarm:
    name: str
    ringing: bool
    stopped: bool
    ring_time: datetime

    def is_ringing(self) -> bool:
        return self.ringing

    def update_status(self, current_time: datetime) -> None:
        # Exact-equality ring condition, as in the reference
        # (TimeManager.jl:127-129).
        if self.ring_time == current_time:
            self.ringing = True

    def rename(self, new_name: str) -> None:
        self.name = new_name

    def stop(self) -> None:
        self.ringing = False


class OneTimeAlarm(AbstractAlarm):
    """Rings once, at ``alarm_time`` (TimeManager.jl:80-91)."""

    def __init__(self, name: str, alarm_time: datetime):
        self.name = name
        self.ringing = False
        self.stopped = False
        self.ring_time = alarm_time

    def reset(self, in_time: Optional[datetime] = None) -> None:
        self.stop()
        if in_time is None:
            self.stopped = True
        else:
            self.ring_time = in_time


class PeriodicAlarm(AbstractAlarm):
    """Rings every ``alarm_interval`` after ``interval_start``
    (TimeManager.jl:94-115). The first ring is one full interval after the
    reference time."""

    def __init__(self, name: str, alarm_interval: Period, interval_start: datetime):
        self.name = name
        self.ringing = False
        self.stopped = False
        self.ring_interval = alarm_interval
        self.ring_time = interval_start + alarm_interval
        self.ring_time_prev: Optional[datetime] = None

    def reset(self, in_time: Optional[datetime] = None) -> None:
        self.stop()
        if in_time is None:
            self.ring_time_prev = self.ring_time
            self.ring_time = self.ring_time_prev + self.ring_interval
        else:
            if in_time < self.ring_time:
                raise ValueError("input time less than the current ring time")
            while self.ring_time <= in_time:
                self.ring_time_prev = self.ring_time
                self.ring_time = self.ring_time_prev + self.ring_interval


def Alarm(name, *args):
    """Convenience constructor dispatching on arity (TimeManager.jl:118-120)."""
    if len(args) == 1:
        return OneTimeAlarm(name, args[0])
    if len(args) == 2:
        return PeriodicAlarm(name, args[0], args[1])
    raise TypeError("Alarm takes (name, time) or (name, interval, start)")


class Clock:
    """Simulation clock (TimeManager.jl:5-29)."""

    def __init__(self, start_time: datetime, time_step: Period):
        self.start_time = start_time
        self.curr_time = start_time
        self.prev_time: Optional[datetime] = None
        self.next_time = start_time + time_step
        self.time_step = time_step
        self.alarms: dict[str, AbstractAlarm] = {}

    def set_current_time(self, in_curr_time: datetime) -> None:
        if in_curr_time < self.start_time:
            raise ValueError("value of current time precedes start time")
        self.curr_time = in_curr_time
        self.prev_time = in_curr_time - self.time_step
        self.next_time = in_curr_time + self.time_step

    def change_time_step(self, time_step: Period) -> None:
        self.time_step = time_step
        self.next_time = self.curr_time + time_step

    def attach_alarm(self, alarm: AbstractAlarm) -> None:
        self.alarms[alarm.name] = alarm

    def advance(self) -> None:
        self.prev_time = self.curr_time
        self.curr_time = self.next_time
        self.next_time = self.curr_time + self.time_step
        for alarm in self.alarms.values():
            alarm.update_status(self.curr_time)

    def __repr__(self) -> str:
        return (
            f"Simulation Clock with {len(self.alarms)} Alarms attached\n"
            f"|- Start Time   : {self.start_time}\n"
            f"|- Current Time : {self.curr_time}\n"
            f"|- Previous Time: {self.prev_time}\n"
            f"|- Next Time    : {self.next_time}\n"
            f"`- Timestep     : {self.time_step}"
        )


def mpas_create_clock(
    time_step: Period,
    start_time: datetime,
    stop_time: Optional[datetime] = None,
    run_duration: Optional[Period] = None,
) -> Clock:
    """Create a clock, validating stop_time/run_duration consistency
    (TimeManager.jl:173-189)."""
    if run_duration is not None:
        derived_stop = start_time + run_duration
        if stop_time is not None and stop_time != derived_stop:
            raise ValueError("stopTime and runDuration are inconsistent")
    elif stop_time is None:
        raise ValueError("neither stopTime nor runDuration are specified")
    return Clock(start_time, time_step)
