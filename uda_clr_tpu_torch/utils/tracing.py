"""The port's spans: named host intervals inside the train step, recorded
only while ``torch.profiler`` records.

``with span("clr.step", state.step):`` opens a span; inside it,
``phase("clr.step.forward")`` ends the span's open phase, if any, and
opens the next as its child, so consecutive phases need no indentation.
Each span records its name, its parent's name, its step (the state's step
counter at the outermost span's entry, shared by the spans inside it) and
its start and end from ``time.time_ns()``: the clock of the profiler's
events, CPU and device alike, so spans line up with a trace's device
intervals. While on, each span also opens
``torch.profiler.record_function`` under its name, so it shows in any
trace the profiler writes.

Spans are on exactly while the profiler records
(``torch._C._autograd._profiler_enabled()``, a fraction of a microsecond).
Off, ``span`` returns a shared no-op context after that one check and
``phase`` returns at once: nothing is recorded. On, an outermost span and
everything inside it are kept in memory as one step, the oldest of
:data:`CAPACITY` steps dropped first; nothing is written on the step's
path. :func:`steps` reads them in order, :func:`summary` gives each span
name's milliseconds per step (or the part of given intervals inside it),
:func:`clear` empties the buffer. Open spans nest on one stack: open them
from the thread that runs the step.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import time
from typing import NamedTuple

import torch

CAPACITY = 1024  # steps kept

_profiling = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


class Span(NamedTuple):
    name: str
    parent: str | None
    step: int | None
    start_ns: int
    end_ns: int


_steps: collections.deque = collections.deque(maxlen=CAPACITY)
_open: list = []  # the open spans, outermost first


class _Open:
    """An open span; a phase ends when the next phase opens or its parent
    ends."""

    __slots__ = ("name", "step", "parent", "is_phase", "start", "rf", "inner")

    def __init__(self, name: str, step: int | None, is_phase: bool = False):
        self.name, self.step, self.is_phase = name, step, is_phase

    def __enter__(self, start: int | None = None):
        self.parent = _open[-1] if _open else None
        if self.parent is not None and self.step is None:
            self.step = self.parent.step
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.start = time.time_ns() if start is None else start
        self.inner = []  # the outermost span's finished descendants
        _open.append(self)
        return self

    def __exit__(self, *exc):
        return self.close(time.time_ns(), exc)

    def close(self, end: int, exc=(None, None, None)):
        while _open[-1] is not self:  # an open phase ends with its parent
            _open[-1].close(end, exc)
        _open.pop()
        self.rf.__exit__(*exc)
        done = Span(self.name, self.parent and self.parent.name, self.step, self.start, end)
        if _open:
            _open[0].inner.append(done)
        else:
            _steps.append((done, *sorted(self.inner, key=lambda s: s.start_ns)))
        return False


def span(name: str, step: int | None = None):
    """A context that records a span ``name`` while the profiler records
    (``step``: the step it belongs to; a nested span takes its parent's)."""
    if not _profiling():
        return _OFF
    return _Open(name, step)


def phase(name: str) -> None:
    """Inside a recording span: end its open phase, if any, and open the
    phase ``name`` as its child, starting where the last one ended."""
    if not _open:
        return
    start = None
    if _open[-1].is_phase:
        start = time.time_ns()
        _open[-1].close(start)
    _Open(name, None, is_phase=True).__enter__(start)


def steps(before_ns: int | None = None, last: int | None = None) -> list:
    """The recorded steps in order, each a tuple of its outermost span and
    then the spans inside it by start; with ``before_ns``, those that began
    before it; with ``last``, the last ``last`` of them."""
    out = [s for s in _steps if before_ns is None or s[0].start_ns < before_ns]
    return out[-last:] if last else out


def clear() -> None:
    _steps.clear()


def summary(recorded: list, within=None) -> dict:
    """Milliseconds per step over ``recorded`` (:func:`steps`'s) of each
    span name, and under ``"self"`` the outermost spans' time outside their
    direct children. With ``within``, ``(start_ns, end_ns)`` intervals that
    do not overlap one another: the part of them each span covers instead
    (a span that covers none reads 0)."""
    if not recorded:
        return {}
    if within is not None:
        within = sorted(within)
        starts = [b for b, _ in within]

    def length(s: Span) -> float:
        if within is None:
            return s.end_ns - s.start_ns
        lo = max(bisect.bisect_left(starts, s.start_ns) - 1, 0)
        hi = bisect.bisect_left(starts, s.end_ns)
        return sum(max(0, min(e, s.end_ns) - max(b, s.start_ns)) for b, e in within[lo:hi])

    total = collections.Counter()
    for root, *inner in recorded:
        total[root.name] += length(root)
        total["self"] += length(root)
        for s in inner:
            total[s.name] += length(s)
            if s.parent == root.name:
                total["self"] -= length(s)
    return {k: v / len(recorded) / 1e6 for k, v in total.items()}
