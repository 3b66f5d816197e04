"""Clock/alarm unit tests (mirrors reference test/infra/test_timeManager.jl:
simulate two years at 20-minute steps and assert every alarm class rings on
schedule)."""

from datetime import datetime, timedelta

import pytest
from mpas_ocean.infra.time_manager import CalendarPeriod

from mpas_ocean.infra.time_manager import (
    Clock,
    OneTimeAlarm,
    PeriodicAlarm,
    mpas_create_clock,
)


def test_clock_basics():
    start = datetime(2000, 1, 1)
    dt = timedelta(minutes=20)
    clock = Clock(start, dt)
    assert clock.curr_time == start
    assert clock.prev_time is None
    assert clock.next_time == start + dt

    clock.advance()
    assert clock.curr_time == start + dt
    assert clock.prev_time == start

    clock.set_current_time(start + timedelta(days=1))
    assert clock.prev_time == start + timedelta(days=1) - dt

    with pytest.raises(ValueError):
        clock.set_current_time(start - dt)

    clock.change_time_step(timedelta(hours=1))
    assert clock.next_time == clock.curr_time + timedelta(hours=1)


def test_create_clock_validation():
    start = datetime(2000, 1, 1)
    with pytest.raises(ValueError):
        mpas_create_clock(timedelta(minutes=20), start)
    with pytest.raises(ValueError):
        mpas_create_clock(
            timedelta(minutes=20),
            start,
            stop_time=datetime(2000, 3, 1),
            run_duration=timedelta(days=1),
        )
    clock = mpas_create_clock(
        timedelta(minutes=20), start, run_duration=timedelta(days=30)
    )
    assert clock.start_time == start


def test_two_year_alarm_schedule():
    """March through two years at 20-minute steps counting rings."""
    start = datetime(2000, 1, 1)
    dt = timedelta(minutes=20)
    clock = Clock(start, dt)

    alarms = {
        "once": OneTimeAlarm("once", datetime(2000, 6, 1)),
        "monthly": PeriodicAlarm("monthly", CalendarPeriod(months=1), start),
        "daily": PeriodicAlarm("daily", timedelta(days=1), start),
        "hourly": PeriodicAlarm("hourly", timedelta(hours=1), start),
    }
    for a in alarms.values():
        clock.attach_alarm(a)

    end = datetime(2002, 1, 1)
    rings = dict.fromkeys(alarms, 0)
    while clock.curr_time < end:
        clock.advance()
        for name, alarm in alarms.items():
            if alarm.is_ringing():
                rings[name] += 1
                alarm.reset()

    n_days = (end - start).days
    assert rings["once"] == 1
    assert rings["monthly"] == 24
    assert rings["daily"] == n_days
    assert rings["hourly"] == n_days * 24


def test_exact_equality_ring_condition():
    """Reference quirk kept: alarm only rings on exact equality
    (TimeManager.jl:127-129), so a dt that does not divide the interval
    never fires."""
    start = datetime(2000, 1, 1)
    clock = Clock(start, timedelta(minutes=7))
    alarm = PeriodicAlarm("out", timedelta(hours=1), start)
    clock.attach_alarm(alarm)
    for _ in range(100):
        clock.advance()
    assert not alarm.is_ringing()


def test_periodic_alarm_reset_to_time():
    start = datetime(2000, 1, 1)
    alarm = PeriodicAlarm("out", timedelta(hours=1), start)
    with pytest.raises(ValueError):
        alarm.reset(start - timedelta(hours=2))
    alarm.reset(start + timedelta(hours=5, minutes=30))
    assert alarm.ring_time == start + timedelta(hours=6)
