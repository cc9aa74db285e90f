"""The 90th percentile of all the window's step times, each the interval
between CUDA events recorded on the stream after consecutive steps (the
first after the event at the window's start)."""

from benchmark.harness import stats

UNIT = "ms"


def read(rec):
    return stats.percentile(rec.step_ms, 90.0) if rec.step_ms else None
