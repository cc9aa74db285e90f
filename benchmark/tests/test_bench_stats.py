"""The metric arithmetic on synthetic records: the rate over the whole
window, the p90 of all steps, the idle share as the union of device
intervals, the idle gaps and the readers built on them."""

from __future__ import annotations

import statistics

import pytest

from benchmark.harness import core, stats, trace


def test_rate_is_all_work_over_all_time():
    assert stats.rate(8 * 31, 5.0) == pytest.approx(49.6)
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_percentile_of_all_samples():
    xs = list(range(1, 101))  # 1..100
    assert stats.percentile(xs, 90) == pytest.approx(90.1)
    assert stats.percentile([5.0], 90) == 5.0
    # one slow step among many moves the p90 only where it lies beyond it
    steps = [150.0] * 95 + [400.0] * 5
    assert stats.percentile(steps, 90) == 150.0
    steps = [150.0] * 85 + [400.0] * 15
    assert stats.percentile(steps, 90) == 400.0


def test_union_busy_idle_and_gaps():
    ivs = [(0, 10), (5, 15), (20, 30), (29, 31), (40, 41)]
    assert stats.union(ivs) == [(0, 15), (20, 31), (40, 41)]
    assert stats.busy(ivs, 0, 50) == 15 + 11 + 1
    assert stats.idle_share(ivs, 0, 50) == pytest.approx(1 - 27 / 50)
    assert stats.busy(ivs, 10, 25) == 5 + 5  # clipped to the window
    assert stats.gaps(ivs, 0, 50) == [(31, 40), (41, 50), (15, 20)]  # longest first


def test_spread_is_quartiles_over_median():
    vals = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, q2, q3 = statistics.quantiles(vals, n=4)
    assert stats.spread(vals) == pytest.approx((q3 - q1) / q2)


def _record(**kw):
    config = core.load_json("configs", "clr_mobilenet_os16")
    traffic = core.load_json("traffic", "prototype_staged")
    rec = core.Record(config, traffic, "NVIDIA H100 80GB HBM3", 8)
    for k, v in kw.items():
        setattr(rec, k, v)
    return rec


def test_readers_on_a_synthetic_record():
    ms = 1_000_000  # ns
    kernels = [("void mask_head_kernel<bf16>", 0, 2 * ms // 5), ("conv", ms, 3 * ms),
               ("mask_head_kernel", 5 * ms, 5 * ms + 2 * ms // 5)]
    rec = _record(steps=40, wall_s=8.0, step_ms=[200.0] * 36 + [300.0] * 4,
                  dispatch_ms=[150.0, 170.0], wait_ms=[1.0, 3.0], peak_bytes=3 * 2**30,
                  setup_s=21.5, flops_per_step=6.967e12, kernels=kernels,
                  trace_lo=0, trace_hi=10 * ms, trace_steps=2,
                  spans=[("bench.step", 0, 4 * ms)], span_kernels=kernels, span_lo=0,
                  span_hi=10 * ms)
    read = lambda m: core.load_py("metrics", m).read(rec)  # noqa: E731
    assert read("train_img_s") == pytest.approx(40.0)
    assert read("step_ms_p90") == pytest.approx(210.0)  # rank 35.1 of 40
    assert read("peak_mem_gib") == pytest.approx(3.0)
    assert read("setup_s") == 21.5
    assert read("step.dispatch_ms") == pytest.approx(160.0)
    assert read("step.mfu") == pytest.approx(100 * 6.967e12 / 0.2 / 989.5e12)
    # K1: 643.8 MB at 3.35 TB/s against 0.4 ms per step
    k1 = core.load_py("metrics", "kernel.k1_roofline_pct")
    assert k1.k1_bytes(rec.config) == 1_048_576 * 307 * 2
    assert read("kernel.k1_roofline_pct") == pytest.approx(
        100 * (1_048_576 * 307 * 2 / 3.35e12) / 0.4e-3)
    # 2.8 ms busy in the 10 ms of the sub-window of device activity alone
    assert read("device.idle_pct") == pytest.approx(100 * (1 - 2.8 / 10))
    assert trace.busy_s(rec) == pytest.approx(2.8e-3)
    bd = trace.breakdown(rec)
    assert bd["device_ops"][0] == ["conv", pytest.approx(2e-3)]
    assert bd["idle_gaps"][0] == ["between spans", pytest.approx(4.6e-3)]
    assert bd["idle_gaps"][1] == ["bench.step", pytest.approx(2e-3)]
    assert bd["idle_gaps"][2] == ["bench.step", pytest.approx(0.6e-3)]


def test_readers_read_nothing_where_nothing_ran():
    rec = _record(steps=10, wall_s=2.0)
    for m in ("kernel.k1_roofline_pct", "device.idle_pct", "step.mfu", "step_ms_p90"):
        assert core.load_py("metrics", m).read(rec) is None
    rec = _record(steps=10, wall_s=2.0, flops_per_step=1e12)
    rec.device_name = "cpu"  # no peak: no share
    assert core.load_py("metrics", "step.mfu").read(rec) is None
