"""The benchmark's arithmetic over what a run records: rates over the
whole window, percentiles of all samples, the busy union of device
intervals and the idle gaps between them, quartile spreads.
"""

from __future__ import annotations

import statistics


def rate(items: float, seconds: float) -> float:
    """Items per second over the whole window."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return items / seconds


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0 < q < 100) of all ``values``, linear
    between the order statistics (numpy's default): for the p90 of n steps
    the sample at rank 0.9 (n - 1)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no samples")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def union(intervals):
    """Merge ``(start, end)`` intervals; returns the disjoint sorted union."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` clipped to ``[lo, hi]``."""
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in union(intervals))


def idle_share(intervals, lo: float, hi: float) -> float:
    """Share of ``[lo, hi]`` that no interval covers."""
    return 1.0 - busy(intervals, lo, hi) / (hi - lo)


def gaps(intervals, lo: float, hi: float):
    """The idle ``(start, end)`` stretches of ``[lo, hi]`` between the
    union of ``intervals``, longest first."""
    out, cur = [], lo
    for s, e in union(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        out.append((cur, hi))
    return sorted(out, key=lambda g: g[0] - g[1])


def spread(values) -> float:
    """Distance between the first and third quartile over the median, as
    ``statistics.quantiles(values, n=4)`` gives them."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
