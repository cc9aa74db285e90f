"""The port's spans (uda_clr_tpu_torch/utils/tracing.py) in its train step
(train/steps.py), on the CPU at 64^2, B 2: none recorded without the
profiler; under it one ``clr.step`` per call with its consecutive phases
in order, on the profiler's own clock, and a ``clr.backbone`` span inside
a phase for each backbone call (models/deeplab.py), cut into Xception's
three phases on that backbone; no MC phase in a warm-up step; and a step
that computes the same bits with spans on and off."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from uda_clr_tpu_torch.config import Config
from uda_clr_tpu_torch.train.state import create_train_state
from uda_clr_tpu_torch.train.steps import make_train_step
from uda_clr_tpu_torch.utils import tracing

PHASES = ["clr.step.forward", "clr.step.mc", "clr.step.losses", "clr.step.backward",
          "clr.step.update"]
LR_GEN, LR_DIS, EPOCH = 1e-3, 2.5e-5, 30


def _phases(inner) -> list:
    """The step's own phases among the spans inside it."""
    return [s for s in inner if s.parent == "clr.step"]


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


def _batch(b: int = 2, s: int = 64) -> dict:
    rng = np.random.default_rng(0)
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in {
        "image_s": rng.standard_normal((b, s, s, 3)),
        "map_s": rng.uniform(size=(b, s, s, 2)) > 0.5,
        "boundary_s": rng.uniform(size=(b, s, s, 1)),
        "image_t": rng.standard_normal((b, s, s, 3))}.items()}


def _snapshot(state) -> dict:
    """Copies of every parameter and buffer the step writes."""
    out = {f"{name}.{k}": v.clone() for name in ("gen", "dis", "dis2")
           for k, v in getattr(state, name).state_dict().items()}
    out.update(proto_src=state.proto_src.clone(), proto_trg=state.proto_trg.clone())
    return out


@pytest.fixture(scope="module")
def stepped():
    """One prototype_full step of two states from one seed, the first with
    no profiler running, the second under ``torch.profiler`` (CPU); then a
    warm-up step of the second under it. Returns the two (state snapshot,
    metrics) pairs, what the buffer held after each step, and the
    profiler's events of the second."""
    cfg = Config()
    cfg.method.mc_samples = 2
    step = make_train_step(cfg, "prototype_full", proto_phase=True)
    batch = _batch()
    states = [create_train_state(cfg, seed=0, device="cpu", method="prototype_full")
              for _ in range(2)]
    tracing.clear()
    _, off_metrics = step(states[0], batch, LR_GEN, LR_DIS, EPOCH)
    off = _snapshot(states[0]), off_metrics
    held_off = tracing.steps()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, on_metrics = step(states[1], batch, LR_GEN, LR_DIS, EPOCH)
    on = _snapshot(states[1]), on_metrics
    held_on = tracing.steps()
    events = [(e.name(), e.start_ns()) for e in prof.profiler.kineto_results.events()
              if e.name().startswith("clr.")]
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        make_train_step(cfg, "prototype_full", proto_phase=False)(
            states[1], batch, LR_GEN, LR_DIS, EPOCH)
    held_warmup = tracing.steps()
    tracing.clear()
    return {"off": off, "on": on, "held_off": held_off, "held_on": held_on,
            "events": events, "held_warmup": held_warmup}


def test_no_span_without_the_profiler(stepped):
    assert stepped["held_off"] == []


def test_a_profiled_step_records_its_phases_in_order(stepped):
    (root, *inner), = stepped["held_on"]
    phases = _phases(inner)
    assert root.name == "clr.step" and root.parent is None and root.step == 0
    # the one S||T forward's backbone call, inside the forward phase
    (backbone,) = [s for s in inner if s not in phases]
    assert backbone.name == "clr.backbone" and backbone.parent == "clr.step.forward"
    assert phases[0].start_ns <= backbone.start_ns < backbone.end_ns <= phases[0].end_ns
    assert [p.name for p in phases] == PHASES
    assert all(p.parent == "clr.step" and p.step == 0 for p in phases)
    assert root.start_ns <= phases[0].start_ns and phases[-1].end_ns <= root.end_ns
    for a, b in zip(phases, phases[1:]):  # consecutive: each starts where the last ended
        assert a.start_ns < a.end_ns == b.start_ns
    ms = tracing.summary(stepped["held_on"])
    assert set(ms) == {"clr.step", "self", "clr.backbone", *PHASES}
    assert ms["self"] >= 0 and all(ms[p] > 0 for p in PHASES)
    assert ms["self"] + sum(ms[p] for p in PHASES) == pytest.approx(ms["clr.step"])


def test_a_warmup_step_has_no_mc_phase(stepped):
    (root, *inner), = stepped["held_warmup"]
    assert root.step == 1
    assert [p.name for p in _phases(inner)] == [p for p in PHASES if p != "clr.step.mc"]


def test_spans_are_on_the_profilers_clock(stepped):
    """Each ``clr.*`` event of the profiler starts within 1 ms of the
    buffer's stamp of the same span."""
    held = {s.name: s.start_ns for s in stepped["held_on"][0]}
    assert sorted(name for name, _ in stepped["events"]) == sorted(held)
    for name, start in stepped["events"]:
        assert abs(start - held[name]) < 1_000_000, name


def test_spans_change_nothing_the_step_computes(stepped):
    (s_off, m_off), (s_on, m_on) = stepped["off"], stepped["on"]
    m_off, m_on = dict(m_off), dict(m_on)
    viz_off, viz_on = m_off.pop("_viz"), m_on.pop("_viz")
    for a, b in ((m_off, m_on), (viz_off, viz_on), (s_off, s_on)):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_summary_splits_intervals_over_the_spans():
    """Given idle stretches, each span reads the part it covers; the part
    outside every phase is the outermost span's self time or no span's."""
    ms = 1_000_000
    step = (tracing.Span("clr.step", None, 0, 0, 10 * ms),
            tracing.Span("clr.step.forward", "clr.step", 0, 1 * ms, 4 * ms),
            tracing.Span("clr.step.update", "clr.step", 0, 4 * ms, 9 * ms))
    idle = [(-2 * ms, 2 * ms), (3 * ms, 5 * ms), (8 * ms, 12 * ms)]
    got = tracing.summary([step, step], within=idle)
    assert got == {"clr.step": 6.0, "clr.step.forward": 2.0, "clr.step.update": 2.0,
                   "self": 2.0}
    assert tracing.summary([step], within=[]) == dict.fromkeys(got, 0.0)
    assert tracing.summary([step])["self"] == 2.0


def test_the_buffer_keeps_the_last_steps():
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(tracing.CAPACITY + 3):
            with tracing.span("clr.step", i):
                tracing.phase("clr.step.forward")
    held = tracing.steps()
    assert len(held) == tracing.CAPACITY and held[0][0].step == 3
    assert [s[0].step for s in tracing.steps(last=2)] == [tracing.CAPACITY + 1,
                                                          tracing.CAPACITY + 2]
    cut = held[10][0].start_ns
    assert tracing.steps(before_ns=cut)[-1] == held[9]
    tracing.clear()
    assert tracing.steps() == []


@pytest.mark.parametrize("method,norm,phases,backbones", [
    # the standalone MC pass (TransNorm) sits between two forward phases
    ("prototype_full", "tn", ["forward", "mc", "forward", "losses", "backward", "update"],
     ["mc", "forward"]),
    ("baseline", "bn", ["forward", "losses", "backward", "update"], ["forward"]),
    ("mean_teacher", "bn", ["forward", "losses", "backward", "update"],
     ["forward", "forward"]),  # the teacher's and the student's
    ("bcdm", "bn", [], [None] * 7),  # clr.step alone, and its 7 backbone calls in it
])
def test_each_step_records_its_phases(method, norm, phases, backbones):
    cfg = Config()
    cfg.method.mc_samples = 2
    cfg.model.norm = norm
    state = create_train_state(cfg, seed=0, device="cpu", method=method)
    step = make_train_step(cfg, method, proto_phase=True)
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        step(state, _batch(s=32), LR_GEN, LR_DIS, EPOCH)
    (root, *inner), = tracing.steps()
    tracing.clear()
    assert root.name == "clr.step" and root.step == 0
    own = [s for s in inner if s.name.startswith("clr.step.")]
    assert [s.name for s in own] == [f"clr.step.{p}" for p in phases]
    assert all(a.end_ns == b.start_ns for a, b in zip(own, own[1:]))
    calls = [s for s in inner if s.name == "clr.backbone"]
    assert len(calls) + len(own) == len(inner)
    assert [s.parent for s in calls] == ["clr.step" if p is None else f"clr.step.{p}"
                                         for p in backbones]


def test_xceptions_phases_nest_in_the_backbone_span():
    """On Xception the ``clr.backbone`` span of the S||T forward holds the
    consecutive phases entry, middle and exit, inside ``clr.step.forward``;
    the step's phases still close on ``clr.step``."""
    cfg = Config()
    cfg.method.mc_samples = 2
    cfg.model.backbone = "xception"
    state = create_train_state(cfg, seed=0, device="cpu", method="prototype_full")
    step = make_train_step(cfg, "prototype_full", proto_phase=True)
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        step(state, _batch(), LR_GEN, LR_DIS, EPOCH)
    recorded = tracing.steps()
    tracing.clear()
    (root, *inner), = recorded
    phases = _phases(inner)
    assert [p.name for p in phases] == PHASES
    (backbone,) = [s for s in inner if s.name == "clr.backbone"]
    assert backbone.parent == "clr.step.forward"
    assert phases[0].start_ns <= backbone.start_ns < backbone.end_ns <= phases[0].end_ns
    flow = [s for s in inner if s.parent == "clr.backbone"]
    assert [s.name for s in flow] == [f"clr.backbone.{p}" for p in ("entry", "middle", "exit")]
    assert backbone.start_ns <= flow[0].start_ns and flow[-1].end_ns <= backbone.end_ns
    assert all(a.end_ns == b.start_ns for a, b in zip(flow, flow[1:]))
    assert len(inner) == len(phases) + 1 + len(flow)
    ms = tracing.summary(recorded)
    assert ms["self"] + sum(ms[p] for p in PHASES) == pytest.approx(ms["clr.step"])
    assert sum(ms[s.name] for s in flow) <= ms["clr.backbone"] <= ms["clr.step.forward"]
