"""The arithmetic of the end-to-end metrics over a window."""

from __future__ import annotations

import math


def per_request_ms(window_s: float, completed: int):
    """The window's time over the requests completed in it, in ms (None
    when none was)."""
    return window_s / completed * 1e3 if completed else None


def p90(values):
    """The 90th percentile by nearest rank: the smallest value that at
    least 90% of ``values`` do not exceed (None when empty)."""
    v = sorted(values)
    return v[math.ceil(0.9 * len(v)) - 1] if v else None


def mean(values):
    v = list(values)
    return sum(v) / len(v) if v else None
