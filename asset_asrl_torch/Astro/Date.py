"""Calendar/Julian date utilities (reference `asset_asrl/Astro/Date.py`:
mjd/jd conversions, calendar parsing, day-fraction helpers, a datetime
subclass with Julian-date constructors, and the SPICE-style
seconds-past-J2000 helpers).  Algorithms are the standard Fliegel-Van
Flandern / Meeus conversions, written from scratch.

Port of `asset_asrl_tpu/Astro/Date.py`.
"""

import datetime as _dt

J2000_JD = 2451545.0
MJD_EPOCH_JD = 2400000.5


# ---------------------------------------------------------------- mjd / jd
def mjd_to_jd(mjd):
    """Modified Julian date -> Julian date."""
    return mjd + MJD_EPOCH_JD


def jd_to_mjd(jd):
    """Julian date -> modified Julian date."""
    return jd - MJD_EPOCH_JD


# ---------------------------------------------------------------- calendar
def date_to_jd(year, month, day, hour=0, minute=0, second=0.0):
    """Gregorian/Julian calendar date -> Julian date (Meeus ch. 7).
    `day` may be fractional; the Julian calendar is used before the
    Gregorian reform (1582-10-15), like the reference."""
    y, m = year, month
    if m <= 2:
        y -= 1
        m += 12
    # Gregorian after 1582-10-15
    if (year, month, day) >= (1582, 10, 15):
        A = y // 100
        B = 2 - A + A // 4
    else:
        B = 0
    jd = (int(365.25 * (y + 4716)) + int(30.6001 * (m + 1))
          + day + B - 1524.5)
    return jd + (hour + minute / 60.0 + second / 3600.0) / 24.0


def jd_to_date(jd):
    """Julian date -> (year, month, fractional day)."""
    jd = jd + 0.5
    Z = int(jd)
    F = jd - Z
    A = Z
    if Z >= 2299161:
        alpha = int((Z - 1867216.25) / 36524.25)
        A = Z + 1 + alpha - alpha // 4
    B = A + 1524
    C = int((B - 122.1) / 365.25)
    D = int(365.25 * C)
    E = int((B - D) / 30.6001)
    day = B - D - int(30.6001 * E) + F
    month = E - 1 if E < 14 else E - 13
    year = C - 4716 if month > 2 else C - 4715
    return year, month, day


def jd_to_date2(jd):
    """Julian date -> (year, month, day, hour, minute, second) with an
    integral day (reference jd_to_date2)."""
    year, month, day = jd_to_date(jd)
    d = int(day)
    hour, mins, sec, micro = days_to_hmsm(day - d)
    return year, month, d, hour, mins, sec + micro * 1e-6


# ----------------------------------------------------------- day fractions
def hmsm_to_days(hour=0, mins=0, sec=0, micro=0):
    """Hours/minutes/seconds/microseconds -> fractional days."""
    return (hour + (mins + (sec + micro / 1.0e6) / 60.0) / 60.0) / 24.0


def days_to_hmsm(days):
    """Fractional days -> (hour, min, sec, microsec)."""
    hours = days * 24.0
    hour = int(hours)
    mins_f = (hours - hour) * 60.0
    mins = int(mins_f)
    sec_f = (mins_f - mins) * 60.0
    sec = int(sec_f)
    micro = int(round((sec_f - sec) * 1.0e6))
    if micro >= 1000000:
        micro -= 1000000
        sec += 1
    if sec >= 60:
        sec -= 60
        mins += 1
    if mins >= 60:
        mins -= 60
        hour += 1
    return hour, mins, sec, micro


# ------------------------------------------------------------- datetime io
def datetime_to_jd(date):
    """datetime.datetime (or (y, m, d[, h, m, s]) tuple) -> Julian date."""
    if isinstance(date, (tuple, list)):
        return date_to_jd(*date)
    day = date.day + hmsm_to_days(date.hour, date.minute, date.second,
                                  date.microsecond)
    return date_to_jd(date.year, date.month, day)


def jd_to_datetime(jd):
    """Julian date -> `Date.datetime` (python datetime subclass)."""
    year, month, day = jd_to_date(jd)
    d = int(day)
    hour, mins, sec, micro = days_to_hmsm(day - d)
    return datetime(year, month, d, hour, mins, sec, micro)


def timedelta_to_days(td):
    """datetime.timedelta -> fractional days."""
    return td.total_seconds() / 86400.0


class datetime(_dt.datetime):
    """datetime with Julian-date interop (reference Date.datetime)."""

    def to_jd(self):
        return datetime_to_jd(self)

    def to_mjd(self):
        return jd_to_mjd(self.to_jd())

    @classmethod
    def from_jd(cls, jd):
        year, month, day = jd_to_date(jd)
        d = int(day)
        hour, mins, sec, micro = days_to_hmsm(day - d)
        return cls(year, month, d, hour, mins, sec, micro)

    def __add__(self, other):
        out = _dt.datetime.__add__(self, other)
        return datetime(out.year, out.month, out.day, out.hour, out.minute,
                        out.second, out.microsecond)

    __radd__ = __add__


# --------------------------------------------------- SPICE J2000 seconds
def jd_to_j2000s(jd):
    """Julian date -> seconds past J2000 (SPICE ephemeris-time style)."""
    return (jd - J2000_JD) * 86400.0


def j2000s_to_jd(et):
    return et / 86400.0 + J2000_JD


def JD_SPJ2000D(jd):
    """Julian date -> days past J2000 (reference JD_SPJ2000D)."""
    return jd - J2000_JD


def Date_SPJ2000(day, month, year):
    """Calendar day -> seconds past J2000 (reference Date_SPJ2000)."""
    return jd_to_j2000s(date_to_jd(year, month, day))
