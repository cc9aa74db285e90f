"""The port's card-side measurement tools on the CPU: the per-op work model
(utils/opcount.py), the roofline's join and table logic
(``roofline_closure.py``) on synthetic profiler records, and each of the
seven tools' ``main`` whole at 64^2 with 2 + 2 images, one window of one
step (``--device cpu``: the kernels' plain versions, no device trace).
No JAX; tests/test_torch_flops.py holds the per-op flops of a step to the
JAX step's count."""

import importlib
import json
import math

import pytest
import torch
import torch.nn.functional as F

from uda_clr_tpu_torch import roofline_closure as rc
from uda_clr_tpu_torch.config import Config
from uda_clr_tpu_torch.models.layers import dropout_impl, set_dropout_impl
from uda_clr_tpu_torch.train.state import create_train_state
from uda_clr_tpu_torch.train.steps import make_train_step
from uda_clr_tpu_torch.utils import opcount
from uda_clr_tpu_torch.utils.benchmarking import count_flops, staged_train_batch

F32 = 4  # bytes per float32 element


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


def counted(fn):
    with opcount.OpCounter() as c:
        fn()
    return c


# ---- the work model ------------------------------------------------------

def test_add_reads_inputs_once_and_writes_its_output():
    x, y = torch.randn(4, 8), torch.randn(4, 8)
    c = counted(lambda: x + y)
    (rec,) = c.ops.values()
    assert rec["name"] == "aten.add.Tensor" and rec["calls"] == 1
    assert rec["bytes"] == 3 * 32 * F32 and rec["flops"] == 0
    assert list(c.ops) == ["aten.add.Tensor f32[4,8] f32[4,8]"]


def test_inplace_add_reads_and_writes_its_tensor_once_each():
    x, y = torch.randn(4, 8), torch.randn(4, 8)
    c = counted(lambda: x.add_(y))
    assert c.total("bytes") == (2 + 1) * 32 * F32  # x and y read, x written


def test_self_add_reads_its_input_once():
    x = torch.randn(4, 8)
    assert counted(lambda: x + x).total("bytes") == 2 * 32 * F32


def test_views_cost_nothing_and_a_broadcast_counts_once():
    x = torch.randn(4, 8)
    c = counted(lambda: (x.view(32), x.t(), x[1:3], x.unsqueeze(0), x.detach()))
    assert c.total("bytes") == 0 and c.total("flops") == 0 and len(c.ops) == 5
    b = torch.randn(8).expand(4, 8)  # stride 0 over the rows: 8 distinct elements
    assert counted(lambda: x * b).total("bytes") == (32 + 8 + 32) * F32


def test_conv_and_its_backward():
    n, cin, cout, h, k = 2, 3, 4, 8, 3
    x = torch.randn(n, cin, h, h, requires_grad=True)
    w = torch.randn(cout, cin, k, k, requires_grad=True)
    g = torch.randn(n, cout, h, h)
    with opcount.OpCounter() as c:
        out = F.conv2d(x, w, padding=1)
        out.backward(g)
    fwd = c.ops[opcount.op_key(torch.ops.aten.convolution.default, (x, w), {})]
    bwd = next(r for r in c.ops.values() if r["name"] == "aten.convolution_backward.default")
    macs = n * cout * h * h * cin * k * k
    assert fwd["flops"] == 2 * macs and bwd["flops"] == 2 * 2 * macs  # each gradient a forward
    x_b, w_b, y_b = x.numel() * F32, w.numel() * F32, out.numel() * F32
    assert fwd["bytes"] == x_b + w_b + y_b
    assert bwd["bytes"] == (y_b + x_b + w_b) + (x_b + w_b)  # g, x, w read; dx, dw written


def test_kernel_work_from_counters():
    before = dict.fromkeys(("k1", "rows", "k3_fwd", "k3_bwd", "k3_bytes", "k4", "k4_bytes"), 0)
    after = {**before, "k1": 1, "rows": 1048576, "k3_fwd": 2, "k3_bwd": 1, "k3_bytes": 600,
             "k4": 4, "k4_bytes": 900}
    work = opcount.kernel_work(before, after, torch.bfloat16)
    k1 = work["K1 mask_head_split"]
    assert k1["launches"] == 1 and round(k1["bytes"] / 1e6, 1) == 643.8
    assert round(k1["flops"] / 1e9, 2) == 1.28
    assert work["K3 dropout"] == {"launches": 3, "bytes": 600, "flops": 0}
    assert work["K4 domain_norm"] == {"launches": 4, "bytes": 900, "flops": 0}
    assert set(opcount.kernel_counts()) == set(before)
    assert opcount.kernel_work(before, before, torch.bfloat16) == {}


def test_step_op_flops_sum_to_count_flops():
    """One prototype-phase step: the ops' flops add up to count_flops of the
    same call (the roofline's first closure check)."""
    cfg = Config()
    cfg.method.mc_samples = 2
    state = create_train_state(cfg, seed=0, device="cpu")
    step = make_train_step(cfg, "prototype_full", proto_phase=True)
    data = staged_train_batch(2, 64, "cpu")
    counter = opcount.OpCounter()

    def run():
        with counter:
            return step(state, data, 1e-3, 2.5e-5, 30)

    _, flops = count_flops(run)
    assert flops > 0 and counter.total("flops") == flops
    assert counter.total("bytes") > 0


# ---- the roofline's join and table ---------------------------------------

def _span(name, ts, dur, tid=1, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": tid, "ts": ts, "dur": dur}


def _launch(corr, ts, tid=1):
    return {**_span("cudaLaunchKernel", ts, 1, tid, "cuda_runtime"), "args": {"correlation": corr}}


def _kernel(name, corr, dur, cat="kernel"):
    return {**_span(name, 1000 + corr, dur, 7, cat), "args": {"correlation": corr}}


def test_attribute_joins_each_launch_to_its_op_range():
    p = opcount.RANGE_PREFIX
    events = [
        _span(p + "aten.add", 0, 10), _span(p + "aten.conv", 20, 30),
        _span(p + "aten.conv", 100, 10, tid=2),  # the backward's thread
        _launch(1, 5), _launch(2, 25), _launch(3, 30), _launch(4, 102, tid=2),
        _launch(5, 60), _launch(6, 70),  # outside every range
        _kernel("elementwise_kernel", 1, 4.0), _kernel("cudnn_conv", 2, 8.0),
        _kernel("cudnn_conv_aux", 3, 2.0, "gpu_memset"), _kernel("conv_bwd", 4, 16.0),
        _kernel("void mask_head_kernel<bf16>", 5, 32.0), _kernel("stray", 6, 64.0, "gpu_memcpy"),
        _span("gpu annotation", 0, 500, 7, "gpu_user_annotation"),  # not device work
    ]
    times, total = rc.attribute(events)
    assert times == {"aten.add": 4.0, "aten.conv": 26.0, "K1 mask_head_split": 32.0,
                     rc.UNATTRIBUTED: 64.0}
    assert total == 126.0


def test_table_shares_tail_and_checks():
    hbm, tflops = 3350.0, 989.5
    work = {"big": {"calls": 2, "bytes": 2 * 3.35e9, "flops": 0},  # 1 ms per step of bytes
            "mm": {"calls": 2, "bytes": 0, "flops": 2 * 989.5e9},  # 1 ms per step of flops
            "small": {"calls": 4, "bytes": 2 * 0.335e9, "flops": 0},
            "K1": {"launches": 2, "bytes": 0.0, "flops": 0}}
    times = {"big": 2 * 2000.0, "mm": 2 * 4000.0, "small": 2 * 400.0, "K1": 2 * 100.0}
    rows, heavy, tail = rc.table(work, times, 2, 1.0, hbm, tflops)
    assert [r["op"] for r in heavy] == ["mm", "big"]
    mm, big = heavy
    assert mm["bound_by"] == "operations" and mm["share"] == pytest.approx(0.25)
    assert big["bound_by"] == "bytes" and big["share"] == pytest.approx(0.5)
    assert big["calls"] == 1 and big["gbytes"] == pytest.approx(3.35)
    assert tail["ms"] == pytest.approx(0.5) and tail["calls"] == 3
    assert tail["roofline_ms"] == pytest.approx(0.1) and tail["share"] == pytest.approx(0.2)
    ok = rc.checks(10, 10, 100.0, 99.5, heavy, tail)
    assert ok == {"flops_conserved": True, "ms_conserved": True, "max_share": pytest.approx(0.5),
                  "shares_bounded": True}
    assert rc.checks(10, 11, 100.0, 99.5, heavy, tail)["flops_conserved"] is False
    assert rc.checks(10, 10, 100.0, 98.0, heavy, tail)["ms_conserved"] is False
    fast = rc.table(work, {**times, "big": 2 * 900.0}, 2, 0.5, hbm, tflops)
    assert rc.checks(10, 10, 1.0, 1.0, fast[1], fast[2])["shares_bounded"] is False
    # no peaks (the CPU): no roofline, no shares
    cpu = rc.table(work, times, 2, 1.0, None, None)
    assert all(r["share"] is None for r in cpu[0]) and cpu[2]["roofline_ms"] is None
    assert rc.checks(1, 1, None, 5.0, cpu[1], cpu[2])["ms_conserved"] is None


# ---- the seven tools, whole ------------------------------------------------

TOOLS = {
    "roofline_closure": (["--size", "64", "--batch", "2", "--steps", "1", "--floor", "50"],
                         {"steps", "proto_steps", "step_tflops", "op_tflops", "table", "tail",
                          "checks", "launches", "time_source"}),
    "bench_norm_ab": (["--size", "64", "--batch", "2", "--windows", "1", "--iters", "1"],
                      {"bn", "tn", "tn_over_bn", "tn_vs_baseline", "proto_steps"}),
    "bench_batch_scaling": (["--size", "64", "--batches", "2", "--windows", "1", "--iters", "1"],
                            {"rows", "proto_steps"}),
    "bench_e2e": (["--size", "64", "--batch", "2", "--steps", "1", "--workers", "1",
                   "--n-data", "4"],
                  {"staged_step_ms", "h2d_ms", "host_fed", "host_cores", "proto_steps"}),
    "ab_mc_fast": (["--size", "64", "--batch", "2", "--steps", "1"], {"steps", "variants"}),
    "bench_pipeline": (["--size", "64", "--n", "4", "--batch", "2", "--workers", "1"],
                       {"rows", "workers", "host_cores"}),
    "bench_loader_backend": (["--size", "64", "--batch", "2", "--batches", "1", "--workers",
                              "1"],
                             {"cells", "gil_stall_frac", "gil_held_s_per_batch",
                              "process_ceiling_batch_s", "host_cores"}),
}
OUT_FILES = {"roofline_closure", "ab_mc_fast", "bench_loader_backend"}


def _numbers(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _numbers(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _numbers(v)
    elif isinstance(tree, (int, float)) and not isinstance(tree, bool):
        yield tree


@pytest.fixture
def restore_dropout():
    before = dropout_impl()
    yield
    set_dropout_impl(before)


@pytest.mark.parametrize("name", list(TOOLS))
def test_tool_main_on_cpu_prints_its_json_line(name, tmp_path, capsys, restore_dropout):
    argv, keys = TOOLS[name]
    if name in OUT_FILES:
        argv = argv + ["--out", str(tmp_path / f"{name}.csv")]
    module = importlib.import_module(f"uda_clr_tpu_torch.{name}")
    returned = module.main(argv + ["--device", "cpu"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res == json.loads(json.dumps(returned))
    assert set(res) >= keys | {"metric", "device_kind", "power_limit_w"}
    assert res["device_kind"] == "cpu" and res["power_limit_w"] is None
    assert all(math.isfinite(v) for v in _numbers(res)), res
    if name in OUT_FILES:
        assert (tmp_path / f"{name}.csv").read_text().count("\n") >= 2
    if name == "roofline_closure":
        assert res["checks"]["flops_conserved"] is True and res["op_tflops"] > 0
        assert res["checks"]["ms_conserved"] is None and res["time_source"] != "device trace"
    if name == "bench_norm_ab":
        assert res["tn_over_bn"] == pytest.approx(
            res["tn"]["step_ms_median"] / res["bn"]["step_ms_median"], rel=1e-3)
    if name == "ab_mc_fast":
        assert set(res["variants"]) == {"fast_fused", "fast_plain", "slow"}
        assert all(v["finite"] for v in res["variants"].values())
        fused, plain = res["variants"]["fast_fused"], res["variants"]["fast_plain"]
        assert fused["loss_all_last10"] == plain["loss_all_last10"]  # same plain head on CPU
    if name == "bench_pipeline":
        assert [r["native"] for r in res["rows"]] == [True, False]


@pytest.mark.parametrize("name", list(TOOLS))
def test_tool_refuses_cuda_without_a_card(name, monkeypatch):
    """``--device cuda`` (the default) raises without a card, before any
    work; no tool falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = importlib.import_module(f"uda_clr_tpu_torch.{name}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main(TOOLS[name][0])

