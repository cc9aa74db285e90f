"""The port's benchmarks on the card: the mask-head kernel's flop formula
against its plain version's count, the refusal of ``--device cuda`` on a
machine that shows no card, and ``python -m uda_clr_tpu_torch.bench`` at
128^2, B 2. Imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_bench_cuda.py

Without a card every test skips."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from uda_clr_tpu_torch.ops import mask_head as mh
from uda_clr_tpu_torch.utils.benchmarking import MASK_HEAD_FLOPS_PER_ROW, count_flops

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


def _args(card, rows=(2, 64, 64)):
    rng = np.random.default_rng(3)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(card)
    return (f(*rows, 256).bfloat16(), f(*rows, 48).bfloat16(), f(*rows, 1).bfloat16(),
            0.1 * f(305), 0.5 + f(305).abs(), 1.0 + 0.2 * f(305), 0.1 * f(305),
            0.05 * f(2, 305, 1, 1), 0.1 * f(2))


def test_mask_head_formula_equals_plain_count(card):
    """K1's CUDA launch is invisible to FlopCounterMode; count_flops adds
    its formula per row, which must equal what FlopCounterMode counts for
    the plain version on the same inputs."""
    args = _args(card)
    launches = mh.LAUNCHES
    _, kernel = count_flops(lambda: mh.fused_mask_head_split(*args, seed=5, rate=0.1))
    _, plain = count_flops(lambda: mh.mask_head_plain(*args, seed=5, rate=0.1))
    assert mh.LAUNCHES == launches + 1
    assert kernel == plain == MASK_HEAD_FLOPS_PER_ROW * 2 * 64 * 64


def test_mask_head_impl_xla_runs_the_plain_version(card):
    """``UDA_MASKHEAD_IMPL=xla`` (``cfg.method.mask_head_impl``): the MC
    pass runs K1's plain version on the card, no K1 launch, the same
    logits as K1 from the same draws."""
    from uda_clr_tpu_torch.models.deeplab import DeepLab
    from uda_clr_tpu_torch.train.steps import mc_suffix

    gen = DeepLab().to(card)
    rng = np.random.default_rng(2)
    fp = torch.from_numpy(rng.standard_normal((2, 256, 4, 4)).astype(np.float32)).to(card)
    ll = torch.from_numpy(rng.standard_normal((2, 48, 16, 16)).astype(np.float32)).to(card)
    out = {}
    for impl in ("auto", "xla"):
        launches = mh.LAUNCHES
        g = torch.Generator(card).manual_seed(0)
        out[impl] = mc_suffix(gen, fp, ll, (64, 64), 2, 4, g, seed=7, mask_head_impl=impl)
        assert mh.LAUNCHES == launches + (impl == "auto"), impl
    peak = float(out["xla"].abs().max())
    assert float((out["auto"] - out["xla"]).abs().max()) <= 1e-4 * max(1.0, peak)


def _run(module, args, env):
    return subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT, capture_output=True,
                          text=True, timeout=600, env={**os.environ, **env})


@pytest.mark.parametrize("module", ["uda_clr_tpu_torch.bench", "uda_clr_tpu_torch.bench_eval"])
def test_cuda_refused_where_no_card_shows(card, module):
    """With the card hidden, ``--device cuda`` raises a clear error and
    prints no result: it never falls back to the CPU."""
    proc = _run(module, ["--device", "cuda"], {"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert proc.stdout.strip() == ""


def test_bench_on_the_card_reports_mfu(card):
    proc = _run("uda_clr_tpu_torch.bench", ["--windows", "2", "--iters", "2",
                                            "--host-fed-steps", "2"],
                {"UDA_BENCH_SIZE": "128", "UDA_BENCH_BATCH": "2"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["device_kind"] == torch.cuda.get_device_name(0)
    assert res["mfu"] is not None and 0.0 < res["mfu"] <= 1.0
    assert res["step_tflops"] > 0 and len(res["step_ms_windows"]) == 2
    assert res["host_fed"]["wire"] == "u8" and res["host_fed_f32"]["wire"] == "f32"
