"""Seconds from the process's start to the window's start: imports, the
kernels' build or load, the state, the feed, the first steps (the first
call with cuDNN's search among them) and the warm-up."""

UNIT = "s"


def read(rec):
    return rec.setup_s
