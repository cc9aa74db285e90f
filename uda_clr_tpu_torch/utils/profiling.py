"""Profiling hooks (own copy of uda_clr_tpu/utils/profiling.py on
``torch.profiler``): a trace of everything inside a ``with`` block, written
as a Chrome trace, named regions in its timeline, and an epoch timer."""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(out_dir: str):
    """Profile the block (host, and the card's kernels where CUDA is
    available) into ``{out_dir}/trace.json``:
    ``with trace(run_dir): step(...)``. The block's queued device work is
    drained before the trace stops."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named region in the profiler timeline."""
    with torch.profiler.record_function(name):
        yield


class EpochTimer:
    def __init__(self):
        self.history: list[float] = []

    @contextlib.contextmanager
    def measure(self):
        t0 = time.time()
        yield
        self.history.append(time.time() - t0)

    @property
    def last(self) -> float:
        return self.history[-1] if self.history else 0.0
