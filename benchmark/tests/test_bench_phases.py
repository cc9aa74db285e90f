"""The program's phase spans (``clr.step.<phase>``, uda_clr_tpu_torch/utils/
tracing.py) under the benchmark's traced run: on the CPU the steps of the
device-only sub-window hold the host time of every phase their step has;
on the card their split of the sub-window's idle stretches closes on
``device.idle_pct``, and the phases' host time on the ``clr.step`` span.
The card test runs with ``python -m pytest -m cuda benchmark/tests``."""

from __future__ import annotations

import pytest

from benchmark.harness import core, stats
from conftest import small_copy
from uda_clr_tpu_torch.utils import tracing

PHASES = ["forward", "mc", "losses", "backward", "update"]
SEED = 2**31 + 7


def _traced_run(cell, root, device, monkeypatch) -> tuple[dict, core.Record, list]:
    """A traced run of ``cell``; returns (its result, its record, the
    program's steps of its device-only sub-window: the last
    ``trace_steps`` begun before the sub-window with the benchmark's host
    spans)."""
    seen = {}
    traced = core._traced

    def keep(loop, rec, *args, **kwargs):
        seen["rec"] = rec
        return traced(loop, rec, *args, **kwargs)

    monkeypatch.setattr(core, "_traced", keep)
    tracing.clear()
    result = core.run_cell(cell, SEED, 0.5, True, device, root=root, log=lambda m: None)
    rec = seen["rec"]
    return result, rec, tracing.steps(before_ns=rec.span_lo, last=rec.trace_steps)


def _host_ms(steps) -> dict:
    """Host ms a step of each phase the steps hold, by phase."""
    per = tracing.summary(steps)
    return {p: per[f"clr.step.{p}"] for p in PHASES if f"clr.step.{p}" in per}


@pytest.mark.parametrize("cell,phases", [
    ("clr-mbv2-staged", PHASES),
    ("clr-mbv2-warmup-staged", [p for p in PHASES if p != "mc"]),
])
def test_a_traced_cpu_run_records_each_phases_host_time(cell, phases, small, monkeypatch):
    result, rec, steps = _traced_run(cell, small, "cpu", monkeypatch)
    assert rec.trace_steps
    assert len(steps) == rec.trace_steps
    assert all(step[0].name == "clr.step" for step in steps)
    host = _host_ms(steps)
    assert list(host) == phases
    assert all(v > 0 for v in host.values()), host
    assert not rec.kernels  # no device interval on the CPU: no idle to split


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["clr-mbv2-staged", "clr-mbv2-warmup-staged"])
def test_the_phase_split_closes_on_the_card(cell, card, tmp_path, monkeypatch):
    """The phases' part of the sub-window's idle stretches plus the idle
    outside every phase equals the idle share of the sub-window per step,
    within 1%; the phases' host time is at least 90% of the ``clr.step``
    span's."""
    root = small_copy(tmp_path / "bench", size=128, batch=4, mc_samples=8, dtype="bfloat16")
    result, rec, steps = _traced_run(cell, root, card, monkeypatch)
    assert len(steps) == rec.trace_steps
    host = _host_ms(steps)
    assert all(v > 0 for v in host.values()), host
    assert list(host) == [p for p in PHASES if p != "mc" or "warmup" not in cell]

    kernels = [(k[1], k[2]) for k in rec.kernels]
    per = tracing.summary(steps, within=stats.gaps(kernels, rec.trace_lo, rec.trace_hi))
    idle = {p: per[f"clr.step.{p}"] for p in host}
    assert all(v >= 0 for v in idle.values()), idle
    window_ms = (rec.trace_hi - rec.trace_lo) / 1e6
    phases = [(s.start_ns, s.end_ns) for step in steps for s in step[1:]]
    outside = window_ms - stats.busy(kernels + phases, rec.trace_lo, rec.trace_hi) / 1e6
    want = result["metrics"]["device.idle_pct"]["value"] / 100 * window_ms / rec.trace_steps
    assert sum(idle.values()) + outside / len(steps) == pytest.approx(want, rel=0.01)
    assert sum(host.values()) >= 0.9 * tracing.summary(steps)["clr.step"]
