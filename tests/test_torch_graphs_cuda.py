"""The train step's prefix as CUDA graphs (uda_clr_tpu_torch/train/graphs.py)
on the card, against the same steps run eagerly. Imports neither JAX nor
the JAX package, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_graphs_cuda.py

Without a card every test skips.

``prototype_full`` at 128^2, B 2+2, BN per half and TransNorm, on
mobilenet and Aligned Xception, in bfloat16 and float32, three steps of
its warm-up or its prototype phase from the same weights, batches and
seeds, graphed and eager. Equal bit for bit: the first step's losses,
running stats, EMA banks and K1's std map (the forward alone sets them). The gradients are
not deterministic even between two eager runs: the backward of the
align-corners resize (ASPP's image pool, the decoder, the logits) adds
with atomics, and cuDNN's weight gradients may too; through Adam, whose
first step moves a parameter by about its learning rate whatever the
gradient's size, the biases of norms that feed another norm (their true
gradient is zero) then differ by up to twice their value. So the first
step's gradients, and the parameters, running stats and banks after the
third step, are held as one vector each to the wider of one bfloat16
rounding (2^-8 of its norm) and four times what two eager runs differ by
(on an H100 graphed and eager differ by 0.8-1.35 times that); the later
steps' losses, which the MC pass's thresholds make chaotic, to the wider
of :data:`LATER_LOSSES` and four times the eager runs' gap. The test
prints the leaves that differ; TransNorm's cases are held alike.
Besides: a capture leaves the state as it found it; a parameter placed
anew forces a new capture; the counters read one capture, then replays;
a replayed step calls K4 from the host only outside the prefix (its
counters count the host's calls); and the profiler records the replayed
kernels, as many ``domain_norm`` kernels a step as eagerly.
"""

import copy

import numpy as np
import pytest
import torch

from uda_clr_tpu_torch.config import Config
from uda_clr_tpu_torch.models import layers
from uda_clr_tpu_torch.ops import domain_norm as K4
from uda_clr_tpu_torch.train import graphs
from uda_clr_tpu_torch.train.state import create_train_state
from uda_clr_tpu_torch.train.steps import make_train_step
from uda_clr_tpu_torch.utils import tracing

pytestmark = pytest.mark.cuda

SIZE, B = 128, 2
LR_GEN, LR_DIS, EPOCH = 1e-3, 2.5e-5, 30
BF16_ROUND = 2.0 ** -8  # one round-to-nearest in bfloat16, relative
# the later steps' losses as one vector, relative: the MC pass's std
# threshold and the pseudo-label thresholds flip pixels on rounding noise
# (on an H100 graphed and eager steps 2-3 differ by up to 0.43% in float32,
# two eager runs by 0.07-0.3%, a single bfloat16 loss by 1.3%)
LATER_LOSSES = 0.02
K4_COUNTERS = ("LAUNCHES_MOMENTS", "LAUNCHES_FWD", "LAUNCHES_REDUCE", "LAUNCHES_BWD")


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic, layers.dropout_impl())
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    graphs._CACHES.clear()
    tracing.clear_counts()
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved[:2]
    torch.backends.cudnn.deterministic = saved[2]
    layers.set_dropout_impl(saved[3])
    graphs._CACHES.clear()


def _cfg(backbone: str, dtype: str, norm: str = "bn") -> Config:
    cfg = Config()
    cfg.model.backbone = backbone
    cfg.model.compute_dtype = dtype
    cfg.model.norm = norm
    cfg.method.mc_samples = 4
    return cfg


def _batch(i: int, device) -> dict:
    rng = np.random.default_rng(100 + i)
    return {k: torch.from_numpy(v.astype(np.float32)).to(device) for k, v in {
        "image_s": rng.standard_normal((B, SIZE, SIZE, 3)),
        "map_s": rng.uniform(size=(B, SIZE, SIZE, 2)) > 0.5,
        "boundary_s": rng.uniform(size=(B, SIZE, SIZE, 1)),
        "image_t": rng.standard_normal((B, SIZE, SIZE, 3))}.items()}


def _k4() -> tuple:
    return tuple(getattr(K4, n) for n in K4_COUNTERS)


def _run(cfg, proto: bool, graphed: bool, device, monkeypatch) -> dict:
    """Three steps of one state: each step's losses, the first step's
    running stats, std map, banks and generator gradients, the last step's
    parameters, running stats and banks; the counts and K4's launches a
    step."""
    graphs._CACHES.clear()
    tracing.clear_counts()
    out = {"losses": [], "launches": []}
    with monkeypatch.context() as m:
        if not graphed:
            m.setattr(graphs, "_on_card", lambda x: False)
        state = create_train_state(cfg, seed=0, device=device, method="prototype_full")
        step = make_train_step(cfg, "prototype_full", proto_phase=proto)
        gen = state.gen
        for i in range(3):
            before = _k4()
            state, metrics = step(state, _batch(i, device), LR_GEN, LR_DIS, EPOCH)
            torch.cuda.synchronize()
            out["launches"].append(tuple(a - b for a, b in zip(_k4(), before)))
            out["losses"].append({k: v.clone() for k, v in metrics.items()
                                  if not k.startswith("_")})
            if i == 0:
                out["first"] = {f"buffer.{k}": v.clone() for k, v in gen.named_buffers()}
                if proto:
                    out["first"].update(std_t=metrics["_viz"]["std_t"].clone(),
                                        proto_src=state.proto_src.clone(),
                                        proto_trg=state.proto_trg.clone())
                out["grad"] = {k: p.grad.clone() for k, p in gen.named_parameters()
                               if p.grad is not None}
        out["last"] = {f"state.{k}": v.clone() for k, v in gen.state_dict().items()}
        if proto:
            out["last"].update(proto_src=state.proto_src.clone(), proto_trg=state.proto_trg.clone())
    out["counts"] = tracing.graph_counts()
    return out


def _rel(a: dict, b: dict) -> float:
    """||a - b|| over ||b||, all the leaves of the two dicts as one vector."""
    num = sum(float((a[k].double() - b[k].double()).square().sum()) for k in b)
    den = sum(float(b[k].double().square().sum()) for k in b)
    return (num / max(den, 1e-300)) ** 0.5


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("proto", [True, False], ids=["prototype", "warmup"])
@pytest.mark.parametrize("backbone", ["mobilenet", "xception"])
@pytest.mark.parametrize("norm", ["bn", "tn"])
def test_graphed_steps_equal_eager(card, monkeypatch, norm, backbone, proto, dtype):
    cfg = _cfg(backbone, dtype, norm)
    graphed = _run(cfg, proto, True, card, monkeypatch)
    eager = _run(cfg, proto, False, card, monkeypatch)
    control = _run(cfg, proto, False, card, monkeypatch)
    assert graphed["counts"] == {"capture": 1, "replay": 2, "eager": {}, "replay_share": 2 / 3}
    assert eager["counts"]["eager"] == {"device": 3}
    # K4's counters count the host's calls: a replayed step calls K4 only
    # outside the prefix, the same number of times every step (the card's
    # kernels: test_profiler_records_replayed_kernels)
    assert graphed["launches"][1] == graphed["launches"][2]
    assert all(g < e for g, e in zip(graphed["launches"][1], eager["launches"][1])), (
        graphed["launches"], eager["launches"])
    # the first step's forward: bit for bit
    assert graphed["losses"][0].keys() == eager["losses"][0].keys()
    assert all(torch.equal(v, eager["losses"][0][k]) for k, v in graphed["losses"][0].items())
    first = graphed["first"]
    assert [k for k in first if not torch.equal(first[k], eager["first"][k])] == []
    # what the gradients reach: within one bfloat16 rounding of the whole,
    # or the spread of two eager runs
    for what in ("grad", "last"):
        gap, spread = _rel(graphed[what], eager[what]), _rel(control[what], eager[what])
        differ = sorted(k for k in eager[what]
                        if not torch.equal(graphed[what][k], eager[what][k]))
        print(f"{norm} {backbone} {'prototype' if proto else 'warmup'} {dtype} {what}: graphed vs "
              f"eager {gap:.3e}, eager vs eager {spread:.3e}; {len(differ)} of "
              f"{len(eager[what])} leaves differ, first {differ[:4]}")
        assert gap <= max(BF16_ROUND, 4 * spread), (what, gap, spread)
    for i in (1, 2):
        gap = _rel(graphed["losses"][i], eager["losses"][i])
        spread = _rel(control["losses"][i], eager["losses"][i])
        print(f"  step {i + 1} losses: graphed vs eager {gap:.3e}, eager vs eager {spread:.3e}")
        assert gap <= max(LATER_LOSSES, 4 * spread), (i, gap, spread)


def _prototype_state(card, backbone="mobilenet", dtype="bfloat16"):
    cfg = _cfg(backbone, dtype)
    state = create_train_state(cfg, seed=0, device=card, method="prototype_full")
    return cfg, state


def test_capture_leaves_state(card):
    """A capture puts back every parameter, gradient, buffer and the
    default generators' states, bit for bit."""
    torch.backends.cudnn.deterministic = True
    _, state = _prototype_state(card)
    gen = state.gen
    for p in gen.parameters():
        p.grad = torch.full_like(p, 0.25)
    before = {k: v.clone() for k, v in gen.state_dict().items()}
    grads = [p.grad.clone() for p in gen.parameters()]
    rng = torch.cuda.get_rng_state(card), torch.get_rng_state()
    batch = _batch(0, card)
    parts = [batch["image_s"].to(torch.bfloat16), batch["image_t"].to(torch.bfloat16)]
    graphs._Prefix(gen, parts, 2)
    torch.cuda.synchronize()
    after = gen.state_dict()
    assert [k for k in before if not torch.equal(before[k], after[k])] == []
    assert all(torch.equal(p.grad, g) for p, g in zip(gen.parameters(), grads))
    assert torch.equal(torch.cuda.get_rng_state(card), rng[0])
    assert torch.equal(torch.get_rng_state(), rng[1])


def test_replaced_parameter_recaptures(card):
    """A parameter placed anew drops the graphs on its old storage and
    captures again; the new graphs give the eager outputs."""
    torch.backends.cudnn.deterministic = True
    _, state = _prototype_state(card)
    gen = state.gen
    batch = _batch(0, card)
    parts = [batch["image_s"].to(torch.bfloat16), batch["image_t"].to(torch.bfloat16)]
    graphs.prefix(gen, parts, 2)
    graphs.prefix(gen, parts, 2)
    gen.aspp.conv1.weight.data = gen.aspp.conv1.weight.data.clone()
    ref = copy.deepcopy(gen)
    got = graphs.prefix(gen, parts, 2)
    x = torch.cat(parts, dim=0).permute(0, 3, 1, 2)
    want = ref.heads_prefix(*ref.features(x, True, 2), True, 2)
    torch.cuda.synchronize()
    assert tracing.graph_counts() == {"capture": 2, "replay": 1, "eager": {},
                                      "replay_share": 1 / 3}
    assert len(graphs._CACHES[gen]) == 1
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_profiler_records_replayed_kernels(card, monkeypatch):
    """Under ``torch.profiler`` a replayed step shows as many ``domain_norm``
    kernels on the card as an eager step."""
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cudnn.deterministic = True
    counts = []
    for graphed in (True, False):
        graphs._CACHES.clear()
        with monkeypatch.context() as m:
            if not graphed:
                m.setattr(graphs, "_on_card", lambda x: False)
            cfg, state = _prototype_state(card)
            step = make_train_step(cfg, "prototype_full", proto_phase=True)
            state, _ = step(state, _batch(0, card), LR_GEN, LR_DIS, EPOCH)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                state, _ = step(state, _batch(1, card), LR_GEN, LR_DIS, EPOCH)
                torch.cuda.synchronize()
        counts.append(sum(1 for e in prof.profiler.kineto_results.events()
                          if e.device_type() == torch.autograd.DeviceType.CUDA
                          and "domain_norm" in e.name()))
    assert counts[0] == counts[1] > 0, counts
