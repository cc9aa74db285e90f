"""The port's benchmark scaffolding (utils/benchmarking.py, hostfeed.py,
devinfo.py) and its two benchmarks (``python -m uda_clr_tpu_torch.bench``
and ``.bench_eval``) on the CPU. Mirrors tests/test_benchmarking.py and
tests/test_hostfeed.py case for case; the benchmarks run whole at 64^2 in
a subprocess, as a user calls them. No JAX."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from uda_clr_tpu_torch.utils import hostfeed
from uda_clr_tpu_torch.utils.benchmarking import (
    count_flops,
    mfu,
    oom_message,
    staged_train_batch,
    timed_windows,
)

ROOT = Path(__file__).resolve().parents[1]
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "vs_baseline_range", "step_ms_median",
              "step_ms_windows", "mfu", "step_tflops", "host_fed", "host_fed_f32",
              "device_kind", "power_limit_w"}
HOST_FED_KEYS = {"step_ms", "img_per_sec_card", "wire", "backend", "workers", "host_cores",
                 "device_fraction", "h2d_ms", "h2d_mbytes", "load_ms"}


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


def run_module(module: str, args: list, env: dict | None = None, timeout: int = 240):
    """``python -m module args`` from the repo root at two threads."""
    return subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT, capture_output=True,
                          text=True, timeout=timeout,
                          env={**os.environ, "OMP_NUM_THREADS": "2", **(env or {})})


def last_json(proc) -> dict:
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


# ---- utils/benchmarking.py ----

def test_timed_windows_call_count_and_stats():
    calls = []

    def step_once(carry):
        calls.append(carry)
        return carry + 1, torch.tensor(float(carry))

    carry, stats = timed_windows(step_once, 0, windows=3, iters=4, warmup=2)
    # 1 first call + 2 warm-up + 3 windows x 4 iters
    assert len(calls) == 1 + 2 + 3 * 4
    assert carry == len(calls)
    assert len(stats["window_ms"]) == 3
    assert stats["window_ms"] == sorted(stats["window_ms"])
    assert stats["median_ms"] == float(np.median(stats["window_ms"]))
    assert stats["first_call_s"] >= 0.0
    assert sorted(stats["window_ms_run_order"]) == stats["window_ms"]


def test_timed_windows_fetches_barrier():
    """The barrier must convert to float: a non-scalar is a caller's fault
    and fails loudly rather than timing nothing."""
    with pytest.raises(ValueError):
        timed_windows(lambda c: (c, torch.zeros((2, 2))), None, windows=1, iters=1)


def test_staged_train_batch_contract():
    data = staged_train_batch(4, 32, "cpu")
    assert set(data) == {"image_s", "map_s", "boundary_s", "image_t"}
    assert data["image_s"].shape == (4, 32, 32, 3)
    assert data["map_s"].shape == (4, 32, 32, 2)
    assert data["boundary_s"].shape == (4, 32, 32, 1)
    for v in data.values():
        assert v.dtype == torch.float32 and v.device.type == "cpu"
    assert set(np.unique(data["map_s"].numpy())) <= {0.0, 1.0}


def test_staged_train_batch_u8_wire_decodes():
    """``wire='u8'`` stages uint8 wire arrays whose decode on the device is
    valid (so ``UDA_BENCH_WIRE=u8`` times the decoding step)."""
    from uda_clr_tpu_torch.data.wire import decode_batch

    data = staged_train_batch(4, 32, "cpu", wire="u8")
    assert set(data) == {"image_s", "map_s", "boundary_s", "image_t"}
    for v in data.values():
        assert v.dtype == torch.uint8
    dec = decode_batch(data)
    img = dec["image_s"]
    assert img.dtype == torch.float32 and img.min() >= -1.0 and img.max() <= 1.0
    assert set(np.unique(dec["map_s"].numpy())) <= {0.0, 1.0}
    assert 0.0 <= float(dec["boundary_s"].min()) and float(dec["boundary_s"].max()) <= 1.0
    with pytest.raises(ValueError, match="wire"):
        staged_train_batch(1, 8, "cpu", wire="u16")


def test_count_flops_and_mfu():
    """A matmul counts 2*n^3; an unknown card gives no mfu and no error; a
    known one divides by its peak."""
    x = torch.ones((64, 64))
    out, flops = count_flops(lambda: x @ x)
    assert flops == 2 * 64**3 and float(out[0, 0]) == 64.0
    assert mfu(flops, 1.0, "cpu") == (None, flops / 1e12)
    share, tflops = mfu(989.5e9, 1.0, "NVIDIA H100 80GB HBM3")
    assert tflops == pytest.approx(0.9895) and share == pytest.approx(1.0)


def test_count_flops_grouped_conv_gradients_cost_their_forward():
    """FlopCounterMode's own rule counts a grouped conv's weight gradient at
    ``groups`` times its forward; the port's counts each gradient as one
    forward."""
    x = torch.randn(2, 8, 10, 10, requires_grad=True)
    w = torch.randn(8, 1, 3, 3, requires_grad=True)
    forward = 2 * 2 * 8 * 1 * 9 * 8 * 8

    def fwd_bwd():
        torch.nn.functional.conv2d(x, w, groups=8).sum().backward()

    assert count_flops(fwd_bwd)[1] == 3 * forward
    w.grad = None
    x.requires_grad_(False)
    assert count_flops(fwd_bwd)[1] == 2 * forward  # no input gradient asked for


def test_oom_message_trims_preamble():
    e = RuntimeError("x" * 500 + "CUDA out of memory. Tried to allocate 2.00 GiB" + "y" * 500)
    msg = oom_message(e)
    assert msg.startswith("out of memory")
    assert len(msg) <= 160
    # messages without the marker pass through (truncated)
    assert oom_message(RuntimeError("boom")) == "boom"


def test_mask_head_impl_switch():
    """``cfg.method.mask_head_impl`` (the bench's ``UDA_MASKHEAD_IMPL``):
    'xla' takes K1's plain version, on the CPU the same as 'auto'; an
    unknown name raises."""
    from uda_clr_tpu_torch.models.deeplab import DeepLab
    from uda_clr_tpu_torch.train.steps import mc_suffix

    gen = DeepLab()
    rng = np.random.default_rng(2)
    fp = torch.from_numpy(rng.standard_normal((1, 256, 2, 2)).astype(np.float32))
    ll = torch.from_numpy(rng.standard_normal((1, 48, 8, 8)).astype(np.float32))
    run = lambda impl: mc_suffix(gen, fp, ll, (32, 32), 1, 2, torch.Generator().manual_seed(0),
                                 seed=7, mask_head_impl=impl)
    assert torch.equal(run("auto"), run("xla"))
    with pytest.raises(ValueError, match="mask_head_impl"):
        run("triton")


# ---- utils/devinfo.py ----

def test_devinfo_peak_lookup():
    from uda_clr_tpu_torch.utils.devinfo import (
        A100_REFERENCE_IMG_PER_SEC,
        peak_hbm_gbs,
        peak_tflops,
    )

    assert peak_tflops("NVIDIA H100 80GB HBM3") == 989.5
    assert peak_tflops("NVIDIA H100 PCIe") == 756.5
    assert peak_tflops("NVIDIA H100 NVL") == 835.5
    assert peak_hbm_gbs("NVIDIA H100 80GB HBM3") == 3350.0
    assert peak_tflops("unknown accelerator") is None
    assert peak_hbm_gbs("cpu") is None
    assert A100_REFERENCE_IMG_PER_SEC == 20.0


# ---- utils/hostfeed.py ----

def _dataset(n=4):
    from uda_clr_tpu_torch.data.synthetic import SyntheticFundus
    from uda_clr_tpu_torch.data.transforms import train_transforms

    return SyntheticFundus(n=n, size=80, transform=train_transforms(48))


def test_paired_batches_zero_batch_fails_fast():
    ds = _dataset()
    with pytest.raises(ValueError, match="zero batches"):
        next(hostfeed.paired_batches(ds, ds, batch=8, workers=1))


@pytest.mark.parametrize("backend", ["thread", "process"])
def test_paired_batches_yields_and_closes(backend):
    ds = _dataset()
    gen = hostfeed.paired_batches(ds, ds, batch=2, workers=1, backend=backend)
    bs, bt = next(gen)
    gen.close()  # must not hang: the epoch's workers see the stop
    assert bs["image"].shape == (2, 48, 48, 3)
    assert bt["image"].shape == (2, 48, 48, 3)
    assert not np.array_equal(bs["image"], bt["image"])  # independent streams


def test_h2d_probe_and_device_batch():
    one = {k: np.zeros((2, 8, 8, c), np.float32) for k, c in
           (("image_s", 3), ("map_s", 2), ("boundary_s", 1), ("image_t", 3))}
    ms, nbytes = hostfeed.h2d_probe(one, "cpu", loads=2)
    assert ms >= 0.0 and nbytes == 2 * 8 * 8 * 9 * 4
    host = {"image": np.ones((2, 8, 8, 3), np.float32), "map": np.zeros((2, 8, 8, 2), np.uint8),
            "boundary": np.zeros((2, 8, 8, 1), np.float32)}
    d = hostfeed.device_batch(host, host, "cpu")
    assert set(d) == {"image_s", "map_s", "boundary_s", "image_t"}
    assert d["map_s"].dtype == torch.uint8 and d["image_t"].shape == (2, 8, 8, 3)


def test_pure_load_ms_drains_before_timing():
    """The drain pulls (a full prefetch queue after a device-bound window)
    are consumed untimed."""
    pulled = []

    def gen():
        i = 0
        while True:
            pulled.append(i)
            yield (None, None)
            i += 1

    hostfeed.pure_load_ms(gen(), steps=3, drain=4)
    assert len(pulled) == 7  # 4 drained + 3 timed


def test_pure_load_ms_drain_scales_with_workers():
    """The ready backlog is ``prefetch`` batches plus one blocked batch per
    worker; the default drain grows with the workers."""
    for workers, prefetch in ((1, 2), (4, 2), (2, 5)):
        pulled = []

        def gen():
            while True:
                pulled.append(0)
                yield (None, None)

        hostfeed.pure_load_ms(gen(), steps=2, workers=workers, prefetch=prefetch)
        assert len(pulled) == (prefetch + workers + 1) + 2


# ---- the two benchmarks, whole ----

def test_bench_cpu_prints_one_json_line():
    proc = run_module("uda_clr_tpu_torch.bench",
                      ["--device", "cpu", "--windows", "2", "--iters", "1",
                       "--host-fed-steps", "2"],
                      {"UDA_BENCH_SIZE": "64", "UDA_BENCH_BATCH": "2"})
    res = last_json(proc)
    assert set(res) >= BENCH_KEYS
    assert res["unit"] == "images/sec/card" and res["device_kind"] == "cpu"
    assert len(res["step_ms_windows"]) == 2 and res["value"] > 0
    assert res["step_ms_windows"] == sorted(res["step_ms_windows"])
    assert res["mfu"] is None and res["power_limit_w"] is None  # no card, no peak
    assert res["step_tflops"] > 0
    for key, wire, backend in (("host_fed", "u8", "process"), ("host_fed_f32", "f32", "thread")):
        row = res[key]
        assert set(row) == HOST_FED_KEYS, key
        assert (row["wire"], row["backend"]) == (wire, backend)
        assert row["step_ms"] > 0 and row["load_ms"] > 0 and row["device_fraction"] > 0


def test_bench_eval_cpu_rows():
    proc = run_module("uda_clr_tpu_torch.bench_eval",
                      ["--device", "cpu", "--size", "64", "--batches", "1,2", "--windows", "2",
                       "--iters", "1"])
    res = last_json(proc)
    assert set(res) == {"metric", "rows", "host_postprocess_ms_per_image", "device_kind",
                        "power_limit_w"}
    assert [r["batch"] for r in res["rows"]] == [1, 2]
    for r in res["rows"]:
        assert set(r) == {"batch", "step_ms", "img_per_sec_card", "mfu", "step_tflops",
                          "first_call_s"}
        assert r["step_ms"] > 0 and r["mfu"] is None
    # the forward's flops scale with the batch
    assert res["rows"][1]["step_tflops"] == pytest.approx(2 * res["rows"][0]["step_tflops"],
                                                          rel=1e-3)
    assert res["host_postprocess_ms_per_image"] > 0


@pytest.mark.parametrize("module", ["uda_clr_tpu_torch.bench", "uda_clr_tpu_torch.bench_eval"])
def test_benchmarks_refuse_cuda_without_a_card(module):
    """Without a card, ``--device cuda`` (the default) raises; it never
    falls back to the CPU, and prints no result."""
    proc = run_module(module, [], {"CUDA_VISIBLE_DEVICES": ""}, timeout=120)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert proc.stdout.strip() == ""
