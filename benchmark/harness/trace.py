"""Timing on the card and the reading of the profiler's trace: per-step
CUDA events, the busy union of device intervals, the largest device
operations and the longest idle gaps named by the host span open at their
start."""

from __future__ import annotations

import collections

import torch

from benchmark.harness import stats


class StepClock:
    """A CUDA event recorded on the stream at each :meth:`mark` (no sync);
    :meth:`intervals_ms` reads the gaps between consecutive marks once the
    last has completed. On the CPU, the host clock."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.marks = []

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            import time

            self.marks.append(time.perf_counter())

    def intervals_ms(self) -> list:
        m = self.marks
        if self.cuda:
            m[-1].synchronize()
            return [a.elapsed_time(b) for a, b in zip(m, m[1:])]
        return [(b - a) * 1e3 for a, b in zip(m, m[1:])]


def busy_s(rec) -> float:
    """Seconds of the traced sub-window of device activity alone in which
    some device operation ran."""
    return stats.busy([(k[1], k[2]) for k in rec.kernels], rec.trace_lo, rec.trace_hi) / 1e9


def breakdown(rec, top: int = 10, name_chars: int = 160) -> dict:
    """``device_ops``: the device operations with the most time in the
    sub-window of device activity alone, by name; ``idle_gaps``: the
    longest idle stretches of the sub-window with host spans, each named by
    the benchmark's host span open at its start ("between spans" when none
    is)."""
    per = collections.Counter()
    for name, s, e in rec.kernels:
        per[name[:name_chars]] += (e - s) / 1e9
    ops = [[n, v] for n, v in per.most_common(top)]
    gaps = stats.gaps([(k[1], k[2]) for k in rec.span_kernels], rec.span_lo, rec.span_hi)[:top]
    named = []
    for s, e in gaps:
        open_spans = [sp for sp in rec.spans if sp[1] <= s < sp[2]]
        label = open_spans[-1][0] if open_spans else "between spans"
        named.append([label, (e - s) / 1e9])
    return {"device_ops": ops, "idle_gaps": named}
