"""Model calendar (the port's copy of cice_tpu/calendar.py, which it does
not import).

Re-implements the semantics of the reference calendar
(cicecore/shared/ice_calendar.F90:36-51, advance_timestep:324, calendar:355):
an integer-second clock with noleap / proleptic-Gregorian / 360-day calendars,
date<->elapsed-time conversions, and per-stream output triggers. Pure Python
(host-side control flow; never traced).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

DAYS_PER_MONTH = {
    "noleap": [31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31],
    "360day": [30] * 12,
}
SECDAY = 86400


def is_leap(year: int) -> bool:
    """Proleptic-Gregorian leap rule (reference ice_calendar compute_days_between)."""
    return (year % 4 == 0 and year % 100 != 0) or (year % 400 == 0)


def days_in_month(calendar_type: str, year: int, month: int) -> int:
    if calendar_type == "gregorian":
        base = DAYS_PER_MONTH["noleap"][month - 1]
        if month == 2 and is_leap(year):
            return base + 1
        return base
    return DAYS_PER_MONTH[calendar_type][month - 1]


def days_in_year(calendar_type: str, year: int) -> int:
    if calendar_type == "360day":
        return 360
    if calendar_type == "gregorian" and is_leap(year):
        return 366
    return 365


def day_of_year(calendar_type: str, year: int, month: int, day: int) -> int:
    """1-based ordinal day of year."""
    return sum(days_in_month(calendar_type, year, m) for m in range(1, month)) + day


def date_to_elapsed_days(calendar_type: str, year: int, month: int, day: int,
                         ref_year: int = 0) -> int:
    """Whole days elapsed from ref_year-01-01 to the given date."""
    days = 0
    if calendar_type == "360day":
        days = (year - ref_year) * 360
    elif calendar_type == "noleap":
        days = (year - ref_year) * 365
    else:
        step = 1 if year >= ref_year else -1
        for y in range(ref_year, year, step):
            days += step * days_in_year(calendar_type, y if step > 0 else y - 1)
    return days + day_of_year(calendar_type, year, month, day) - 1


def elapsed_days_to_date(calendar_type: str, edays: int, ref_year: int = 0):
    """Inverse of date_to_elapsed_days."""
    year = ref_year + edays // 366  # lower bound
    while edays >= date_to_elapsed_days(calendar_type, year + 1, 1, 1, ref_year):
        year += 1
    while edays < date_to_elapsed_days(calendar_type, year, 1, 1, ref_year):
        year -= 1
    rem = edays - date_to_elapsed_days(calendar_type, year, 1, 1, ref_year)
    month = 1
    while rem >= days_in_month(calendar_type, year, month):
        rem -= days_in_month(calendar_type, year, month)
        month += 1
    return year, month, rem + 1


@dataclass(frozen=True)
class Calendar:
    """Immutable calendar state; `advance` returns the next instant."""

    calendar_type: str = "noleap"
    year: int = 2005
    month: int = 1
    day: int = 1
    sec: int = 0                 # seconds into the day
    istep: int = 0               # completed timesteps
    year_init: int = 2005

    @property
    def yday(self) -> int:
        return day_of_year(self.calendar_type, self.year, self.month, self.day)

    @property
    def elapsed_days(self) -> int:
        """Days since year_init-01-01 00:00."""
        return date_to_elapsed_days(self.calendar_type, self.year, self.month,
                                    self.day, self.year_init)

    @property
    def elapsed_seconds(self) -> int:
        return self.elapsed_days * SECDAY + self.sec

    @property
    def fyday(self) -> float:
        """Fractional day of year (1-based), used by forcing interpolation."""
        return self.yday + self.sec / SECDAY

    def timestamp(self) -> str:
        return f"{self.year:04d}-{self.month:02d}-{self.day:02d}-{self.sec:05d}"

    def advance(self, dt: float) -> "Calendar":
        """Advance by dt seconds (dt must divide into whole seconds;
        reference advance_timestep ice_calendar.F90:324 enforces integer dt)."""
        idt = int(round(dt))
        if abs(dt - idt) > 1e-6:
            raise ValueError(f"dt={dt} must be an integer number of seconds")
        sec = self.sec + idt
        year, month, day = self.year, self.month, self.day
        while sec >= SECDAY:
            sec -= SECDAY
            day += 1
            if day > days_in_month(self.calendar_type, year, month):
                day = 1
                month += 1
                if month > 12:
                    month = 1
                    year += 1
        return replace(self, year=year, month=month, day=day, sec=sec,
                       istep=self.istep + 1)

    # -- output triggers (reference `calendar` ice_calendar.F90:355) --------
    def is_boundary(self, freq: str, freq_n: int = 1, dt: float = 3600.0) -> bool:
        """True if this instant closes an output interval of the given frequency.

        freq: 'y' yearly, 'm' monthly, 'd' daily, 'h' hourly, '1' every freq_n
        steps, 'x' never. Evaluated at end-of-step (call after advance).
        """
        if freq in ("x", "n"):
            return False
        if freq == "1":
            return self.istep % max(freq_n, 1) == 0
        if freq == "h":
            total_h = self.elapsed_seconds // 3600
            return self.sec % 3600 == 0 and total_h % max(freq_n, 1) == 0
        if freq == "d":
            return self.sec == 0 and self.elapsed_days % max(freq_n, 1) == 0
        if freq == "m":
            months = (self.year - self.year_init) * 12 + (self.month - 1)
            return (self.sec == 0 and self.day == 1 and
                    months % max(freq_n, 1) == 0)
        if freq == "y":
            return (self.sec == 0 and self.day == 1 and self.month == 1 and
                    (self.year - self.year_init) % max(freq_n, 1) == 0)
        raise ValueError(f"unknown frequency '{freq}'")


def npt_to_steps(npt: int, npt_unit: str, dt: float, cal: Calendar) -> int:
    """Convert a run length in npt_unit to a number of dt steps."""
    npt_unit = str(npt_unit)     # '--set setup.npt_unit=1' parses as int
    if npt_unit == "1":
        return npt
    if npt_unit == "s":
        return int(npt / dt)
    if npt_unit == "h":
        return int(npt * 3600 / dt)
    if npt_unit == "d":
        return int(npt * SECDAY / dt)
    if npt_unit == "m":
        c = cal
        for _ in range(npt):
            dim = days_in_month(c.calendar_type, c.year, c.month)
            c = Calendar(c.calendar_type, c.year + (c.month == 12),
                         c.month % 12 + 1, c.day, c.sec, c.istep, c.year_init)
            _ = dim
        days = date_to_elapsed_days(c.calendar_type, c.year, c.month, c.day,
                                    cal.year_init) - cal.elapsed_days
        return int(days * SECDAY / dt)
    if npt_unit == "y":
        days = (date_to_elapsed_days(cal.calendar_type, cal.year + npt, cal.month,
                                     cal.day, cal.year_init) - cal.elapsed_days)
        return int(days * SECDAY / dt)
    raise ValueError(f"unknown npt_unit '{npt_unit}'")
