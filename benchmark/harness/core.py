"""One run of one cell: set-up, the measured window, the traced
sub-window, the comparison with the reference, the result line.

A cell (``benchmark/workloads/<cell>.json``) names its configuration
(``benchmark/configs/<config>.json``), its traffic mix
(``benchmark/traffic/<traffic>.json``, read by the feed it names,
``benchmark/feeds/<feed>.py``), its metrics (each a reader,
``benchmark/metrics/<metric>.py``) and the limits of its correctness
numbers. Nothing here names a cell.

Set-up: the program's state from the seed's weights, the feed, the
program's first :data:`check.STEPS` steps through the window's own call and
feed (recorded for the comparison), then the traffic's warm-up steps. The
window: steps back to back for ``seconds`` of the host's clock, a CUDA
event recorded after each step, the clock stopped on a value that depends
on the last step. With ``trace`` two sub-windows of the traffic's
``profile_steps`` steps each follow under ``torch.profiler``: the first
records device activity alone, which slows the host's launches least (the
busy time, the idle share, the kernels), the second the benchmark's host
spans beside it (the idle gaps named by what the host was doing). Then the peak
memory is read, the program's state freed, and the reference follows the
first steps.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from benchmark.harness import check, flops, peaks, sides, trace as tracing

ROOT = Path(__file__).resolve().parents[1]  # the benchmark's folder


def load_json(kind: str, name: str, root: Path = ROOT) -> dict:
    """``<root>/<kind>/<name>.json`` (root: the benchmark's folder)."""
    path = Path(root) / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    return json.loads(path.read_text())


def load_cell(name: str, root: Path = ROOT) -> tuple[dict, dict, dict]:
    """(cell, config, traffic) of the cell called ``name``."""
    cell = load_json("workloads", name, root)
    return (cell, load_json("configs", cell["config"], root),
            load_json("traffic", cell["traffic"], root))


def load_py(kind: str, name: str, root: Path = ROOT):
    """The module ``<root>/<kind>/<name>.py`` (a name may hold dots)."""
    path = Path(root) / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Record:
    """What a run measured, for the metric readers."""
    config: dict
    traffic: dict
    device_name: str
    images_per_step: int
    setup_s: float = 0.0
    steps: int = 0
    wall_s: float = 0.0
    step_ms: list = field(default_factory=list)  # CUDA events after consecutive steps
    dispatch_ms: list = field(default_factory=list)  # host clock around each step call
    wait_ms: list = field(default_factory=list)  # host clock around each pull of a batch pair
    copy_ms: list = field(default_factory=list)  # host clock around each copy to the card
    peak_bytes: int = 0
    flops_per_step: float | None = None  # the reference's, counted on meta tensors
    # the traced sub-window of device activity alone: its device intervals
    # [(name, start_ns, end_ns)], its bounds (first start, last end) and steps
    kernels: list = field(default_factory=list)
    trace_lo: int = 0
    trace_hi: int = 0
    trace_steps: int = 0
    # the sub-window with host spans: the spans and device intervals, bounds
    spans: list = field(default_factory=list)
    span_kernels: list = field(default_factory=list)
    span_lo: int = 0
    span_hi: int = 0


class Loop:
    """One step of the window as the Trainer runs it: pull a batch pair,
    copy it to the card, call the step; each span on the host's clock (and
    under ``torch.profiler.record_function`` while tracing)."""

    def __init__(self, feed, program, rec: Record):
        self.feed, self.program, self.rec = feed, program, rec
        self.tracing = False

    def _span(self, name, fn, arg, into):
        t0 = time.perf_counter()
        if self.tracing:
            with torch.profiler.record_function(f"bench.{name}"):
                out = fn(arg)
        else:
            out = fn(arg)
        into.append((time.perf_counter() - t0) * 1e3)
        return out

    def step(self) -> dict:
        rec = self.rec
        host = self._span("pull", lambda _: self.feed.take(), None, rec.wait_ms)
        batch = self._span("copy", self.feed.put, host, rec.copy_ms)
        return self._span("step", self.program.step, batch, rec.dispatch_ms)


def first_steps(loop: Loop) -> tuple[dict, list]:
    """The program's first :data:`check.STEPS` steps through ``loop``,
    read for the comparison; returns (readings, the feed's replay keys of
    their batches)."""
    recorder = loop.program.recorder()
    keys = []
    for _ in range(check.STEPS):
        keys.append(loop.feed.replay_key())
        recorder.after_step(loop.step())
    return recorder.readings(), keys


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device="cuda",
             t_start: float | None = None, fault=None, log=print, root: Path = ROOT) -> dict:
    """Run cell ``name`` once; returns the result object (the last line's
    keys; ``checks`` last). ``fault``: a function wrapping the program's
    step (the tests plant faults with it); ``log`` prints a line to
    standard error; ``root``: the folder holding the cell's files."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    cell, config, traffic = load_cell(name, root)
    feed_mod = load_py("feeds", traffic["feed"], root)
    readers = {m: load_py("metrics", m, root)
               for m in cell["end_to_end" if not trace else "per_layer"]}
    data = config["program"]["data"]
    rec = Record(config, traffic, peaks.device_name(device), int(data["batch_size"]))

    program = sides.Program(config, traffic, seed, device)
    if fault is not None:
        program.step = fault(program.step, program)
    feed = feed_mod.Feed(traffic, config, seed, device)
    try:
        loop = Loop(feed, program, rec)
        prog_readings, first = first_steps(loop)
        for _ in range(int(traffic["warmup_steps"])):
            metrics = loop.step()
        _sync(device)
        for lst in (rec.wait_ms, rec.copy_ms, rec.dispatch_ms):
            lst.clear()
        setup_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        timer = tracing.StepClock(device)

        # ---- the window ----
        t0 = time.perf_counter()
        rec.setup_s = t0 - t_start
        timer.mark()
        cpus = [_cpu()]
        losses = []
        while time.perf_counter() - t0 < seconds:
            metrics = loop.step()
            timer.mark()
            losses.append(metrics["loss_all"])
        float(metrics["loss_all"])  # waits for the last step
        rec.wall_s = time.perf_counter() - t0
        cpus.append(_cpu())
        rec.steps = len(losses)
        rec.step_ms = timer.intervals_ms()
        failed = int((~torch.isfinite(torch.stack(losses))).sum())
        _log_window(rec, cpus, log)

        if trace:
            _traced(loop, rec, int(traffic["profile_steps"]), device, log)
            rec.flops_per_step = flops.step_flops(config, traffic)
        window_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        rec.peak_bytes = window_peak
        log(f"window: {rec.steps} steps in {rec.wall_s:.4f} s, set-up {rec.setup_s:.2f} s, "
            f"peak {window_peak} B (set-up {setup_peak} B)")
    finally:
        feed.close()
    ref_batches = [feed.replay(k) for k in first]
    del program, loop, feed, metrics, losses
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # ---- the reference follows the first steps ----
    t_ref = time.perf_counter()
    ref_readings = sides.reference_readings(config, traffic, seed, device, ref_batches)
    numbers = check.compare(prog_readings, ref_readings)
    limits = cell["limits"]
    correct = check.verdict(numbers, limits) and failed == 0
    log(f"reference: {time.perf_counter() - t_ref:.2f} s")

    metrics_out = {}
    for mname, reader in readers.items():
        value = reader.read(rec)
        if value is not None:
            metrics_out[mname] = {"value": value, "unit": reader.UNIT}
    result = {
        "correct": bool(correct),
        "attempted": rec.steps,
        "failed": failed,
        "metrics": metrics_out,
        "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": rec.device_name, "count": 1,
                   "memory_peak_bytes": int(max(setup_peak, window_peak))},
    }
    if trace:
        lo, hi = rec.trace_lo, rec.trace_hi
        result["device"]["busy_s"] = tracing.busy_s(rec)
        result["device"]["window_s"] = (hi - lo) / 1e9
        result["breakdown"] = tracing.breakdown(rec)
    for k in sorted(set(numbers) - set(limits)):
        log(f"not held: {k} {numbers[k][0]!r} {numbers[k][1]}")
    result["checks"] = {k: {"value": numbers[k][0], "limit": lim}
                        for k, lim in limits.items() if k in numbers}
    result["checks"]["failed_steps"] = {"value": failed, "limit": 0}
    for k, v in result["checks"].items():
        log(f"check {k}: {v['value']!r} (limit {v['limit']!r})")
    return result


def _cpu() -> int:
    """The host core this thread last ran on (-1 where not known)."""
    try:
        return int(Path("/proc/thread-self/stat").read_text().rsplit(")", 1)[1].split()[36])
    except (OSError, IndexError, ValueError):
        return -1


def _log_window(rec: Record, cpus: list, log) -> None:
    """The window's steps by thirds and the host's share of them, on
    standard error: whether a run's pace drifts within its window or is set
    for the whole process."""
    n = len(rec.step_ms)
    if n < 3:
        return
    thirds = [rec.step_ms[i * n // 3:(i + 1) * n // 3] for i in range(3)]
    mean = lambda xs: sum(xs) / len(xs)  # noqa: E731
    log(f"step ms by thirds of the window: {', '.join(f'{mean(t):.3f}' for t in thirds)}; "
        f"host ms per step: dispatch {mean(rec.dispatch_ms):.3f}, pull {mean(rec.wait_ms):.4f}, "
        f"copy {mean(rec.copy_ms):.4f}; host core at start and end {cpus[0]}, {cpus[-1]}; "
        f"cuDNN benchmark={torch.backends.cudnn.benchmark}")


def _device_events(prof) -> list:
    """[(name, start_ns, end_ns)] of the operations that ran on the card."""
    return [(e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation()]


def _traced(loop: Loop, rec: Record, n: int, device, log=print) -> None:
    """Two sub-windows of ``n`` whole steps under ``torch.profiler``, each
    synchronised before and after; fills the record's trace fields. The
    first records device activity alone (on the CPU, which has none, host
    activity), which slows the host's launches least; the second adds the
    host's operations and the benchmark's spans, which slow it more."""
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    spans_before = [len(x) for x in (rec.wait_ms, rec.copy_ms, rec.dispatch_ms)]
    walls = []
    for with_spans in (False, True):
        acts = [ProfilerActivity.CPU] if with_spans or not cuda else []
        acts += [ProfilerActivity.CUDA] if cuda else []
        _sync(device)
        t0 = time.perf_counter()
        with profile(activities=acts) as prof:
            loop.tracing = with_spans
            for _ in range(n):
                metrics = loop.step()
            float(metrics["loss_all"])
            _sync(device)
            loop.tracing = False
        walls.append(time.perf_counter() - t0)
        kernels = _device_events(prof)
        if not with_spans:
            rec.kernels, rec.trace_steps = kernels, n
            rec.trace_lo = min((k[1] for k in kernels), default=0)
            rec.trace_hi = max((k[2] for k in kernels), default=0)
            continue
        spans = sorted(((e.name(), e.start_ns(), e.end_ns())
                        for e in prof.profiler.kineto_results.events()
                        if e.name().startswith("bench.")), key=lambda sp: sp[1])
        rec.spans, rec.span_kernels = spans, kernels
        rec.span_lo = spans[0][1] if spans else 0
        rec.span_hi = max([k[2] for k in kernels] + [sp[2] for sp in spans] + [rec.span_lo])
    # the window's host spans stay the untraced steps'
    for lst, n0 in zip((rec.wait_ms, rec.copy_ms, rec.dispatch_ms), spans_before):
        del lst[n0:]
    span_ms = (rec.trace_hi - rec.trace_lo) / n / 1e6
    busy_ms = tracing.busy_s(rec) / n * 1e3
    step_ms = rec.wall_s / max(rec.steps, 1) * 1e3
    log(f"traced: {n} steps a sub-window; device activity alone: first to last device op "
        f"{span_ms:.3f} ms a step, busy {busy_ms:.3f} ms a step; untraced window "
        f"{step_ms:.3f} ms a step, where that busy time would leave the device idle "
        f"{100 * (1 - busy_ms / step_ms):.3f}%; host spans' sub-window {walls[1] / n * 1e3:.3f} "
        f"ms a step, the profiler's own start and stop included")
