"""The CUDA graphs of the train step's prefix (uda_clr_tpu_torch/train/graphs.py)
on the CPU, at 32^2, B 1+1, mobilenet.

- The gate: one case per reason the prefix stays eager, on one shared
  generator, each asserting the counter's reason and today's eager outputs
  and running stats, bit for bit.
- The cache key: it changes with the input's shape, dtype, ``domains`` and
  the norms' row layout, and with a parameter or buffer placed anew.
- The capture's wiring, under an emulated graph (:class:`EmulatedGraph`: a
  capture records the aten ops the capturing code runs, a replay runs them
  again into the recorded outputs, so static tensors behave as a graph's
  memory): a warm-up step of ``prototype_full`` that captures and a
  prototype-phase step that replays equal the eager steps bit for bit; a
  capture leaves the state as it found it.
- A parameter placed anew forces a new capture. The card test (tests/test_torch_graphs_cuda.py) holds real
  graphs to the same bits.
"""

import contextlib
import copy
import types

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from uda_clr_tpu_torch.config import Config
from uda_clr_tpu_torch.models.deeplab import DeepLab, nchw
from uda_clr_tpu_torch.models.norm import frozen_stats, global_rows
from uda_clr_tpu_torch.train import graphs
from uda_clr_tpu_torch.train.state import create_train_state
from uda_clr_tpu_torch.train.steps import make_train_step
from uda_clr_tpu_torch.utils import tracing

SIZE = 32
LR_GEN, LR_DIS, EPOCH = 1e-3, 2.5e-5, 30


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def fresh():
    graphs._CACHES.clear()
    tracing.clear_counts()
    yield
    graphs._CACHES.clear()
    tracing.clear_counts()


@pytest.fixture(scope="module")
def model():
    return DeepLab(backbone="mobilenet", seed=0)


def _parts(size: int = SIZE, dtype=torch.float32, seed: int = 0) -> list:
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(1, size, size, 3, generator=g).to(dtype) for _ in range(2)]


class EmulatedGraph:
    """A ``torch.cuda.CUDAGraph`` stand-in on the CPU: :func:`emulated_capture`
    records every aten op run inside it with its arguments and outputs,
    :meth:`replay` runs them again and copies each result into the recorded
    output (an ``empty``'s contents are left as they are, as a graph leaves
    them)."""

    SKIP = (torch.ops.aten.empty.memory_format, torch.ops.aten.empty_like.default,
            torch.ops.aten.empty_strided.default)

    def __init__(self):
        self.ops = []

    def replay(self):
        with torch.no_grad():
            for func, args, kwargs, outs in self.ops:
                new = func._op(*args, **kwargs)  # the C++ op, past the Python wrapper
                if func in self.SKIP:
                    continue
                for o, n in zip(outs, (new,) if isinstance(new, torch.Tensor) else new):
                    if isinstance(o, torch.Tensor) and o is not n:
                        o.copy_(n)


class _Record(TorchDispatchMode):
    def __init__(self, ops):
        super().__init__()
        self.ops = ops

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops.append((func, args, kwargs, (out,) if isinstance(out, torch.Tensor) else out))
        return out


@contextlib.contextmanager
def emulated_capture(graph, pool=None, capture_error_mode="global"):
    with _Record(graph.ops):
        yield


def _emulate(monkeypatch):
    """Graphs emulated on the CPU, and CPU tensors taken as the card's."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", EmulatedGraph)
    monkeypatch.setattr(torch.cuda, "graph", emulated_capture)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(torch.cuda, "get_rng_state", lambda device=None: torch.get_rng_state())
    monkeypatch.setattr(torch.cuda, "set_rng_state", lambda state, device=None: None)
    monkeypatch.setattr(graphs, "_on_card", lambda x: True)


@pytest.fixture()
def emulated(monkeypatch):
    _emulate(monkeypatch)


def _eager(gen, parts, domains: int):
    """Today's code: the backbone, then the heads' prefix, in train mode."""
    x = nchw(torch.cat(parts, dim=0))
    high, low = gen.features(x, True, domains)
    return gen.heads_prefix(high, low, True, domains)


def _state(gen) -> dict:
    return {k: v.clone() for k, v in gen.state_dict().items()}


def _equal(a: dict, b: dict) -> list:
    """The keys whose tensors differ."""
    return [k for k in a if not torch.equal(a[k], b[k])]


def _case(reason: str, gen, monkeypatch, undo: contextlib.ExitStack):
    """(context, inputs) under which the gate fails on ``reason`` first, on
    the shared generator ``gen``; ``undo`` takes back what the case changes
    on it, and the patches reach graphs.py alone."""
    ctx, parts = contextlib.nullcontext(), _parts()
    if reason == "no_grad":
        ctx = torch.no_grad()
    elif reason == "input_grad":
        parts[0].requires_grad_(True)
    elif reason == "world_size":
        monkeypatch.setattr(graphs, "dist_lib", types.SimpleNamespace(world_size=lambda: 2))
    elif reason == "spatial":
        monkeypatch.setattr(graphs, "spatial", types.SimpleNamespace(active=lambda: True))
    elif reason == "remat":
        monkeypatch.setattr(gen.backbone, "remat", True)
    elif reason == "hooks":
        undo.callback(gen.aspp.conv1.register_forward_hook(lambda *args: None).remove)
    elif reason == "dispatch_mode":
        ctx = _Record([])  # any TorchDispatchMode
    elif reason == "frozen_stats":
        ctx = frozen_stats(gen)
    elif reason == "frozen_param":
        weight = gen.decoder.conv1.weight.requires_grad_(False)
        undo.callback(weight.requires_grad_, True)
    elif reason == "signatures":
        monkeypatch.setattr(graphs, "_on_card", lambda x: True)
        graphs._CACHES[gen] = {graphs.cache_key(gen, _parts(size), 2): None
                               for size in (8, 16)}  # two other signatures cached
    elif reason == "profiling":
        monkeypatch.setattr(graphs, "_on_card", lambda x: True)
        ctx = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    return ctx, parts


REASONS = ["no_grad", "input_grad", "world_size", "spatial", "remat", "hooks", "dispatch_mode",
           "frozen_stats", "frozen_param", "device", "signatures", "profiling"]


@pytest.fixture(scope="module")
def today(model):
    """(``model``'s state, and for a kind of context today's outputs of
    :func:`_parts` from that state and the state after them), computed once
    a kind."""
    initial, done = _state(model), {}
    kinds = {"plain": contextlib.nullcontext, "no_grad": torch.no_grad,
             "frozen_stats": lambda: frozen_stats(model)}

    def get(kind: str) -> tuple:
        if kind not in done:
            with kinds[kind]():
                out = [o.detach() for o in _eager(model, _parts(), 2)]
            done[kind] = out, _state(model)
            model.load_state_dict(initial)
        return done[kind]

    return initial, get


@pytest.mark.parametrize("reason", REASONS)
def test_gate_runs_eager(reason, model, today, monkeypatch):
    """Each reason keeps the prefix eager, is counted under its name, and
    gives today's outputs and running stats."""
    initial, get = today
    want, want_state = get(reason if reason in ("no_grad", "frozen_stats") else "plain")
    try:
        with contextlib.ExitStack() as undo:
            ctx, parts = _case(reason, model, monkeypatch, undo)
            with ctx:
                got = graphs.prefix(model, parts, 2)
        counts = tracing.graph_counts()
        assert counts["eager"] == {reason: 1} and counts["capture"] == counts["replay"] == 0
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert _equal(_state(model), want_state) == []
    finally:
        model.load_state_dict(initial)  # in place: the same storages


@pytest.mark.parametrize("change", ["shape", "domains", "dtype", "rows", "parameter", "buffer"])
def test_cache_key_changes(change, model):
    """The key changes with the input's shape, ``domains``, dtype and the
    norms' row layout, and with a parameter or buffer placed anew (as
    ``.to()`` or ``load_state_dict(assign=True)`` place them)."""
    gen = copy.deepcopy(model) if change in ("parameter", "buffer") else model
    parts, domains = _parts(), 2
    before = graphs.cache_key(gen, parts, domains)
    assert graphs.cache_key(gen, _parts(seed=1), domains) == before  # same shape, other values
    rows = contextlib.nullcontext()
    if change == "shape":
        parts = _parts(SIZE + 8)
    elif change == "domains":
        domains = 1
    elif change == "dtype":
        parts = _parts(dtype=torch.bfloat16)
    elif change == "rows":
        rows = global_rows((range(2), 4))
    elif change == "parameter":
        gen.aspp.conv1.weight.data = gen.aspp.conv1.weight.data.clone()
    else:
        gen.load_state_dict({**gen.state_dict(), "aspp.bn1.running_mean":
                             gen.aspp.bn1.running_mean.clone()}, assign=True)
    with rows:
        assert graphs.cache_key(gen, parts, domains) != before


def _batch(i: int, b: int = 1) -> dict:
    rng = np.random.default_rng(i)
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in {
        "image_s": rng.standard_normal((b, SIZE, SIZE, 3)),
        "map_s": rng.uniform(size=(b, SIZE, SIZE, 2)) > 0.5,
        "boundary_s": rng.uniform(size=(b, SIZE, SIZE, 1)),
        "image_t": rng.standard_normal((b, SIZE, SIZE, 3))}.items()}


def _two_steps(cfg) -> tuple:
    """A warm-up step, then a prototype-phase step, of one state; returns
    (metrics, the generator's state, the banks, the counts)."""
    state = create_train_state(cfg, seed=0, device="cpu", method="prototype_full")
    steps = [make_train_step(cfg, "prototype_full", proto_phase=p) for p in (False, True)]
    metrics = []
    for i, step in enumerate(steps):
        state, m = step(state, _batch(i), LR_GEN, LR_DIS, EPOCH)
        metrics.append({k: v for k, v in m.items() if not k.startswith("_")})
    return metrics, _state(state.gen), (state.proto_src, state.proto_trg), tracing.graph_counts()


def test_emulated_graphs_equal_eager(monkeypatch, emulated):
    """Through the emulated graphs, a warm-up step that captures and a
    prototype-phase step that replays give the eager steps' losses,
    parameters, running stats and banks bit for bit; the counters read one
    capture, then a replay."""
    cfg = Config()
    cfg.method.mc_samples = 2
    graphed = _two_steps(cfg)
    monkeypatch.setattr(graphs, "_on_card", lambda x: False)
    tracing.clear_counts()
    eager = _two_steps(cfg)
    for got, want in zip(graphed[0], eager[0]):
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in got)
    assert _equal(graphed[1], eager[1]) == []
    assert all(torch.equal(g, w) for g, w in zip(graphed[2], eager[2]))
    assert graphed[3] == {"capture": 1, "replay": 1, "eager": {}, "replay_share": 1 / 2}
    assert eager[3]["eager"] == {"device": 2}


def test_emulated_capture_leaves_state(model, emulated):
    """A capture puts back every parameter, gradient and buffer it found."""
    gen = copy.deepcopy(model)
    for p in gen.parameters():
        p.grad = torch.full_like(p, 0.5)
    before = _state(gen)
    graphs._Prefix(gen, _parts(8), 2)
    assert _equal(_state(gen), before) == []
    assert all(bool((p.grad == 0.5).all()) for p in gen.parameters())


def test_replaced_parameter_recaptures(model, monkeypatch):
    """A parameter placed anew drops the graphs on its old storage and
    captures again (a stand-in capture that runs the eager code)."""
    class Capture:
        def __init__(self, gen, parts, domains):
            self.gen, self.domains = gen, domains

        def __call__(self, parts, params):
            return _eager(self.gen, parts, self.domains)

    monkeypatch.setattr(graphs, "_on_card", lambda x: True)
    monkeypatch.setattr(graphs, "_Prefix", Capture)
    gen, parts = copy.deepcopy(model), _parts(8)
    for _ in range(2):
        graphs.prefix(gen, parts, 2)
    gen.aspp.conv1.weight.data = gen.aspp.conv1.weight.data.clone()
    graphs.prefix(gen, parts, 2)
    assert tracing.graph_counts() == {"capture": 2, "replay": 1, "eager": {},
                                      "replay_share": 1 / 3}
    assert len(graphs._CACHES[gen]) == 1
