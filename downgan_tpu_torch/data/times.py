"""WRF time handling: the port's own copy of ``downgan_tpu/data/times.py``
(parity with ``DoWnGAN/helpers/wrf_times.py``), numpy and datetime only.
"""
from __future__ import annotations

from datetime import datetime, timedelta
from typing import Iterable, List, Optional, Sequence

import numpy as np


def datetime_wrf_period(
    start_time: datetime, end_time: datetime, step_hours: int = 6
) -> List[datetime]:
    """Enumerate [start, end) in 6-hour steps (reference wrf_times.py:7-15)."""
    diff = end_time - start_time
    hours = int((diff.days * 24 + diff.seconds // 3600) / step_hours)
    return [start_time + timedelta(hours=i * step_hours) for i in range(hours)]


def wrf_to_dt(times: Iterable[float]) -> np.ndarray:
    """Decode WRF float times (YYYYMMDD.fraction) to datetime64[D].

    Matches reference ``wrf_times.py:17-32`` including its day-resolution
    truncation: the fractional day is rounded to hours, then the result is
    cast to datetime64[D].
    """
    out = []
    for t in times:
        s = str(float(t))
        year = int(s[:4])
        month = int(s[4:6])
        day = int(s[6:8])
        hours = int(np.round(24 * float(s[8:])))
        out.append(np.datetime64(datetime(year, month, day) + timedelta(hours=hours)))
    return np.array(out, dtype="datetime64[ns]").astype("datetime64[D]")


def dt_index(times: Iterable[float]) -> np.ndarray:
    """Parity alias for the legacy prep library's ``dt_index``
    (``DoWnGAN/helpers/prep_gan.py:55-67``), which duplicates
    ``wrf_times.wrf_to_dt`` with identical YYYYMMDD.fraction decoding and
    day-resolution truncation. Returns datetime64[D] (the reference wraps
    the same values in a pandas DatetimeIndex; this layer is numpy-first).
    """
    return wrf_to_dt(times)


def filter_times(
    times: Sequence, mask_years: Optional[Sequence[int]] = None
) -> np.ndarray:
    """Boolean mask: True where the year is NOT in mask_years (train mask).

    Reference ``wrf_times.py:35-45``: train = years not masked; the test
    mask is the complement.
    """
    arr = np.asarray(times)
    if arr.dtype.kind == "M":
        years = arr.astype("datetime64[Y]").astype(int) + 1970
    else:
        years = np.array([t.year for t in arr])
    if mask_years is None:
        return np.ones(len(arr), dtype=bool)
    mask_years = set(int(y) for y in mask_years)
    return np.array([int(y) not in mask_years for y in years], dtype=bool)
