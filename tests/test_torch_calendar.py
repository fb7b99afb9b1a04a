"""PyTorch port vs JAX package: the calendar (cice_tpu_torch/calendar.py, a
copy of cice_tpu/calendar.py, which the port does not import) and the
calendar the port's Model keeps. Pure Python on both sides, so the
comparisons are exact: every date, step count and output trigger equal.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes: leave the cores to other workers

from cice_tpu import calendar as jcal  # noqa: E402
from cice_tpu_torch import calendar as tcal  # noqa: E402
from cice_tpu_torch import config as tconfig  # noqa: E402
from cice_tpu_torch.model import driver as tdriver  # noqa: E402

TYPES = ("noleap", "gregorian", "360day")


def _same(tc, jc):
    assert dataclasses.astuple(tc) == dataclasses.astuple(jc)
    assert (tc.yday, tc.elapsed_days, tc.elapsed_seconds, tc.fyday,
            tc.timestamp()) == (jc.yday, jc.elapsed_days,
                                jc.elapsed_seconds, jc.fyday,
                                jc.timestamp())


@pytest.mark.parametrize("ctype", TYPES)
def test_month_and_year_lengths_match(ctype):
    for year in (1900, 1999, 2000, 2004, 2005, 2100):
        assert tcal.days_in_year(ctype, year) == \
            jcal.days_in_year(ctype, year)
        assert tcal.is_leap(year) == jcal.is_leap(year)
        for month in range(1, 13):
            assert tcal.days_in_month(ctype, year, month) == \
                jcal.days_in_month(ctype, year, month)
            for day in (1, 15, 28):
                assert tcal.day_of_year(ctype, year, month, day) == \
                    jcal.day_of_year(ctype, year, month, day)


@pytest.mark.parametrize("ctype", TYPES)
def test_date_round_trips_over_100k_days(ctype):
    """calchk-style: elapsed days -> date -> elapsed days over 100000 days,
    forwards from the reference year and backwards before it."""
    days = sorted(set(range(0, 100001, 997)) | {
        0, 1, 58, 59, 60, 364, 365, 366, 1460, 1461, 36524, 36525, 100000})
    for ref in (2000, 1901):
        for edays in days + [-d for d in days[1:40]]:
            got = tcal.elapsed_days_to_date(ctype, edays, ref_year=ref)
            assert got == jcal.elapsed_days_to_date(ctype, edays,
                                                    ref_year=ref)
            assert tcal.date_to_elapsed_days(ctype, *got, ref_year=ref) \
                == edays


@pytest.mark.parametrize("ctype", TYPES)
@pytest.mark.parametrize("start", [(2005, 1, 31, 82800), (2005, 12, 31, 82800),
                                   (2004, 2, 28, 82800), (2000, 2, 28, 0),
                                   (2003, 2, 28, 43200), (2005, 11, 30, 0)],
                         ids=["month", "year", "feb28-leap", "feb28-2000",
                              "feb28-noleap", "nov30"])
def test_advance_across_month_year_and_feb29(ctype, start):
    """Both calendars advance in step, with dt of 1 s, 1 h, 1 day and 3 days,
    across month ends, year ends and 29 February."""
    y, m, d, sec = start
    if ctype == "360day" and d > 30:
        d = 30
    for dt in (1.0, 3600.0, 86400.0, 3 * 86400.0):
        tc = tcal.Calendar(ctype, y, m, d, sec, year_init=y)
        jc = jcal.Calendar(ctype, y, m, d, sec, year_init=y)
        for _ in range(40):
            tc, jc = tc.advance(dt), jc.advance(dt)
            _same(tc, jc)
    feb29 = tcal.Calendar(ctype, 2004, 2, 28, 82800).advance(3600)
    assert (feb29.month, feb29.day) == ((2, 29) if ctype != "noleap"
                                        else (3, 1))
    with pytest.raises(ValueError, match="integer number of seconds"):
        tc.advance(0.5)


@pytest.mark.parametrize("ctype", TYPES)
def test_is_boundary_every_frequency_over_a_year(ctype):
    """Every output trigger at dt=3600 over a year (8760 steps) of each
    calendar type, from a mid-month start of a leap year."""
    dt = 3600.0
    tc = tcal.Calendar(ctype, 2004, 2, 10, 0, year_init=2004)
    jc = jcal.Calendar(ctype, 2004, 2, 10, 0, year_init=2004)
    freqs = [(f, n) for f in ("y", "m", "d", "h", "1", "x", "n")
             for n in (1, 2, 3, 5)]
    hits = {fn: 0 for fn in freqs}
    for _ in range(8760):
        tc, jc = tc.advance(dt), jc.advance(dt)
        for f, n in freqs:
            got = tc.is_boundary(f, n, dt)
            assert got == jc.is_boundary(f, n, dt), (f, n, tc)
            hits[(f, n)] += got
    _same(tc, jc)
    assert hits[("h", 1)] == 8760 and hits[("1", 5)] == 8760 // 5
    assert hits[("d", 1)] == 365 and hits[("m", 1)] == 12
    assert hits[("y", 1)] == 1 and hits[("x", 1)] == 0
    with pytest.raises(ValueError, match="unknown frequency"):
        tc.is_boundary("w")


@pytest.mark.parametrize("ctype", TYPES)
def test_npt_to_steps_every_unit(ctype):
    for start in ((2005, 1, 1, 0), (2004, 2, 15, 3600), (2003, 12, 31, 0)):
        tc = tcal.Calendar(ctype, *start, year_init=2003)
        jc = jcal.Calendar(ctype, *start, year_init=2003)
        for unit in ("1", "s", "h", "d", "m", "y", 1):
            for npt in (0, 1, 2, 7, 13):
                for dt in (1800.0, 3600.0):
                    assert tcal.npt_to_steps(npt, unit, dt, tc) == \
                        jcal.npt_to_steps(npt, unit, dt, jc), \
                        (unit, npt, dt, start)
    with pytest.raises(ValueError, match="unknown npt_unit"):
        tcal.npt_to_steps(1, "w", 3600.0, tc)


@pytest.mark.parametrize("over,ctype", [
    ({}, "noleap"),
    ({"setup.use_leap_years": True}, "gregorian"),
    ({"setup.calendar_type": "gregorian"}, "gregorian"),
    ({"setup.calendar_type": "360day", "setup.days_per_year": 360},
     "360day")], ids=["noleap", "use_leap_years", "gregorian", "360day"])
def test_model_keeps_the_calendar(over, ctype):
    """Model builds the calendar as the JAX Model does, from any start date,
    and its istep / elapsed_seconds / yday / year read it."""
    cfg = tconfig.gx1pop_step(48, 40).with_overrides(**{
        "setup.year_init": 2004, "setup.month_init": 2,
        "setup.day_init": 28, "setup.sec_init": 75600, **over})
    m = tdriver.Model(cfg, device="cpu")
    jc = jcal.Calendar(ctype, 2004, 2, 28, 75600, year_init=2004)
    _same(m.calendar, jc)
    assert (m.istep, m.elapsed_seconds, m.yday, m.year) == \
        (0, jc.elapsed_seconds, jc.fyday, 2004)


def test_model_rejects_inconsistent_days_per_year():
    cfg = tconfig.gx1pop_step(48, 40).with_overrides(
        **{"setup.calendar_type": "360day"})
    with pytest.raises(ValueError, match="days_per_year=365 inconsistent"):
        tdriver.Model(cfg, device="cpu")
