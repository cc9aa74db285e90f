"""The S||T forward's deterministic prefix as captured CUDA graphs.

The prefix is the generator's backbone (``DeepLab.features``) and the
heads' prefix (``Heads.heads_prefix``: ASPP before its dropout, and the
decoder's low-level projection). It draws no random numbers, so one
capture of it holds for every later step of the same shapes. :func:`prefix`
runs it at the train step's main forward (train/steps.py). Where the
capture is valid it replays two graphed halves, backbone then heads
prefix, each one forward graph and one backward graph, all four in one
memory pool. Elsewhere it runs today's eager code.

Each half is an autograd node (:class:`_Replay`). Its forward copies the
activations it is given into the static inputs, where they are not there
already, and replays the forward graph. Its backward copies the incoming
gradients into the static ones and replays the backward graph. It returns
the static parameter gradients, which autograd accumulates into ``.grad``
as it does for an eager backward. The backbone's static outputs are the
heads half's static inputs, and the heads half's static input gradients
are the backbone's static output gradients, so nothing is copied between
the halves. The step's S||T ``torch.cat`` writes straight into the static
input. The outputs are the graph's static tensors: the next replay
overwrites them, so they are good until the next call of the same
signature.

The graphs engage only where the capture is valid; the first condition of
this list that fails names the reason, counted as
``clr.graph.eager.<reason>`` (utils/tracing.py):

- ``no_grad``: grad mode is on;
- ``input_grad``: no input needs a gradient (the graph computes none);
- ``world_size``: one process (a rank's collectives cannot be captured);
- ``spatial``: no ``('data', 'space')`` mesh, for the same reason;
- ``remat``: the backbone is not rematerialised;
- ``hooks``: no module hook, in the generator or global (a replay runs no
  Python);
- ``dispatch_mode``: no Python dispatch or function mode is on (a replay
  dispatches no op: ``FlopCounterMode`` and the op counts would miss it);
- ``frozen_stats``: no norm under ``frozen_stats`` (the graph writes the
  running stats);
- ``frozen_param``: every parameter of the generator takes a gradient;
- ``device``: the input is a CUDA tensor that K4 launches on;
- ``signatures``: a graph for this signature exists, or fewer than
  :data:`MAX_SIGNATURES` do, so a run whose last batch differs keeps at
  most two sets of graphs;
- ``profiling``: a capture waits until ``torch.profiler`` stops recording
  (a replay under it is recorded kernel by kernel).

The cache lives with the model (a weak map keyed by the generator), so the
warm-up and prototype-phase steps the Trainer builds share it. Its key
(:func:`cache_key`) is the input's shape, dtype and device, ``domains``,
the norms' row layout (``norm.global_rows``) and the ``data_ptr`` of every
parameter and buffer of the generator: a parameter or buffer placed
anew (``.to()``, ``load_state_dict(assign=True)``) drops the cached
graphs, which would replay on stale addresses, and forces a new capture.

A capture (:class:`_Prefix`) runs the prefix once eagerly, forward and
backward (``torch.autograd.grad``: no ``.grad`` is written), so that every
kernel, cuDNN plan and handle is set up before the capture; then captures
forward 1, forward 2, backward 2, backward 1 in the order they replay, in
the ``thread_local`` capture mode (the Trainer's loader threads pin host
memory meanwhile); then restores every parameter, gradient, buffer and the
default generators as they were before it, and replays.

K4's launch counters (ops/domain_norm.py) count the host's calls of its
wrapper: the capture's warm-up and recorded calls count, a replay adds
none. The kernels a replay runs on the card show in ``torch.profiler``.
"""

from __future__ import annotations

import weakref

import torch
from torch.autograd.function import once_differentiable
from torch.nn.modules import module as nn_module
from torch.utils._python_dispatch import _get_current_dispatch_mode

from uda_clr_tpu_torch.models.deeplab import DeepLab, nchw
from uda_clr_tpu_torch.models.norm import DomainNorm2d, current_rows
from uda_clr_tpu_torch.ops import domain_norm as K4
from uda_clr_tpu_torch.parallel import distributed as dist_lib
from uda_clr_tpu_torch.parallel import spatial
from uda_clr_tpu_torch.utils import tracing

MAX_SIGNATURES = 2
_CACHES: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()  # generator -> {key: _Prefix}
_GLOBAL_HOOKS = ("_global_forward_hooks", "_global_forward_pre_hooks",
                 "_global_backward_hooks", "_global_backward_pre_hooks")


_profiling = torch._C._autograd._profiler_enabled


def _on_card(x: torch.Tensor) -> bool:
    return K4.launches_on(x)


def _scan(gen: DeepLab):
    """One walk over the generator's modules: (its parameters, the
    ``data_ptr`` of each parameter and buffer, whether a module has a hook,
    whether a norm is frozen, whether a parameter takes no gradient)."""
    params, storages = [], []
    hooks = frozen = fixed = False
    for m in gen.modules():
        hooks = hooks or bool(m._forward_hooks or m._forward_pre_hooks or m._backward_hooks
                              or m._backward_pre_hooks)
        frozen = frozen or (isinstance(m, DomainNorm2d) and not m.update_stats)
        for p in m._parameters.values():
            if p is not None:
                params.append(p)
                storages.append(p.data_ptr())
                fixed = fixed or not p.requires_grad
        for b in m._buffers.values():
            if b is not None:
                storages.append(b.data_ptr())
    hooks = hooks or any(getattr(nn_module, h) for h in _GLOBAL_HOOKS)
    return params, tuple(storages), hooks, frozen, fixed


def _signature(parts, domains: int) -> tuple:
    n = sum(p.shape[0] for p in parts)
    x = parts[0]
    return (n, *x.shape[1:]), x.dtype, x.device, domains, current_rows()


def cache_key(gen: DeepLab, parts, domains: int, scan=None) -> tuple:
    """The key the graphs of ``cat(parts)`` (NHWC) under ``domains`` are
    cached by: the input's shape, dtype and device, ``domains``, the norms'
    row layout, and the storages of the generator's parameters and buffers
    (``scan``: :func:`_scan`'s walk of ``gen``, where one is at hand)."""
    return _signature(parts, domains), (scan or _scan(gen))[1]


def _reason(gen: DeepLab, parts, scan) -> str | None:
    """Why the graphs may not run this call (the module docstring's list),
    or None."""
    _, _, hooks, frozen, fixed = scan
    checks = (
        ("no_grad", not torch.is_grad_enabled()),
        ("input_grad", any(p.requires_grad for p in parts)),
        ("world_size", dist_lib.world_size() != 1),
        ("spatial", spatial.active()),
        ("remat", getattr(gen.backbone, "remat", False)),
        ("hooks", hooks),
        ("dispatch_mode", _get_current_dispatch_mode() is not None
         or torch._C._is_torch_function_mode_enabled()),
        ("frozen_stats", frozen),
        ("frozen_param", fixed),
        ("device", not _on_card(parts[0])),
    )
    return next((name for name, failed in checks if failed), None)


def _eager(gen: DeepLab, parts, domains: int):
    x = nchw(torch.cat(parts, dim=0) if len(parts) > 1 else parts[0])
    high, low = gen.features(x, True, domains)
    return gen.heads_prefix(high, low, True, domains)


def prefix(gen: DeepLab, parts, domains: int):
    """The train-mode ``gen.heads_prefix(*gen.features(x, True, domains),
    True, domains)`` of ``x``, the NHWC ``parts`` concatenated over the batch, as
    NCHW: (ASPP's pre-dropout features, the low-level projection). Replays
    the cached graphs of this signature where they may run, capturing them
    first if none are cached; else the eager code. Each call adds one to
    ``clr.graph.capture``, ``clr.graph.replay`` or
    ``clr.graph.eager.<reason>``."""
    scan = _scan(gen)
    reason = _reason(gen, parts, scan)
    if reason is None:
        cache = _CACHES.setdefault(gen, {})
        key = cache_key(gen, parts, domains, scan)
        for stale in [k for k in cache if k[1] != key[1]]:
            del cache[stale]  # their graphs read storages no longer the generator's
        entry = cache.get(key)
        if entry is not None:
            tracing.count("clr.graph.replay")
            return entry(parts, scan[0])
        if len(cache) >= MAX_SIGNATURES:
            reason = "signatures"
        elif _profiling():
            reason = "profiling"
        else:
            tracing.count("clr.graph.capture")
            entry = cache[key] = _Prefix(gen, parts, domains)
            return entry(parts, scan[0])
    tracing.count(f"clr.graph.eager.{reason}")
    return _eager(gen, parts, domains)


class _Half:
    """One graphed callable: its forward and backward graphs, static
    tensors, and the positions of its parameters among the generator's."""

    def __init__(self, pool, index: list):
        self.pool, self.index = pool, index
        self.fwd, self.bwd = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        self.inputs = self.outputs = self.grad_outputs = self.grad_inputs = ()

    def capture(self, backward: bool):
        """The context that captures into the forward or backward graph."""
        return torch.cuda.graph(self.bwd if backward else self.fwd, pool=self.pool,
                                capture_error_mode="thread_local")

    def apply(self, inputs, params):
        return _Replay.apply(self, *inputs, *(params[i] for i in self.index))


class _Replay(torch.autograd.Function):
    """A half's forward graph, with its backward graph as the backward."""

    @staticmethod
    def forward(ctx, half: _Half, *inputs):
        for static, x in zip(half.inputs, inputs):
            if static.data_ptr() != x.data_ptr():
                static.copy_(x)
        half.fwd.replay()
        ctx.half = half
        return tuple(o.detach() for o in half.outputs)

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        half = ctx.half
        for static, g in zip(half.grad_outputs, grads):
            if static.data_ptr() != g.data_ptr():
                static.copy_(g)
        half.bwd.replay()
        return None, *(None if g is None else g.detach() for g in half.grad_inputs)


class _Snapshot:
    """Copies of every parameter, gradient and buffer of the generator and
    of the default generators' states, put back by :meth:`restore`."""

    def __init__(self, gen: DeepLab, device):
        self.device = device
        self.tensors = [*gen.parameters(), *gen.buffers()]
        with torch.no_grad():
            self.values = [t.detach().clone() for t in self.tensors]
            self.grads = [(p, None if p.grad is None else p.grad.clone())
                          for p in gen.parameters()]
        self.rng = torch.get_rng_state(), torch.cuda.get_rng_state(device)

    def restore(self) -> None:
        with torch.no_grad():
            for t, v in zip(self.tensors, self.values):
                t.copy_(v)
            for p, g in self.grads:
                if g is None:
                    p.grad = None
                else:
                    p.grad.copy_(g)
        torch.set_rng_state(self.rng[0])
        torch.cuda.set_rng_state(self.rng[1], self.device)


class _Prefix:
    """The two graphed halves of one signature, in one memory pool, and the
    static NHWC input."""

    def __init__(self, gen: DeepLab, parts, domains: int):
        params = _scan(gen)[0]
        position = {id(p): i for i, p in enumerate(params)}
        pool = torch.cuda.graph_pool_handle()
        self.backbone = _Half(pool, [position[id(p)] for p in gen.backbone.parameters()])
        self.heads = _Half(pool, [position[id(p)] for p in gen.prefix_parameters()])
        x0 = parts[0]
        self.x = torch.empty((sum(p.shape[0] for p in parts), *x0.shape[1:]), dtype=x0.dtype,
                             device=x0.device)
        self._fill(parts)
        x = nchw(self.x)
        p1 = [params[i] for i in self.backbone.index]
        p2 = [params[i] for i in self.heads.index]
        snapshot = _Snapshot(gen, x0.device)
        try:
            # the warm-up: every kernel, plan and handle set up outside a capture
            high, low = gen.backbone(x, True, domains)
            outs = gen.heads_prefix(high, low, True, domains)
            torch.autograd.grad(outs, p1 + p2, [torch.zeros_like(o) for o in outs],
                                allow_unused=True)
            del high, low, outs
            with self.backbone.capture(backward=False):
                high, low = gen.backbone(x, True, domains)
            h, l = high.detach().requires_grad_(), low.detach().requires_grad_()
            with self.heads.capture(backward=False):
                fp, ll = gen.heads_prefix(h, l, True, domains)
            grad_fp, grad_ll = torch.empty_like(fp), torch.empty_like(ll)
            with self.heads.capture(backward=True):
                grads2 = torch.autograd.grad((fp, ll), [h, l, *p2], (grad_fp, grad_ll),
                                             allow_unused=True)
            with self.backbone.capture(backward=True):
                grads1 = torch.autograd.grad((high, low), p1, grads2[:2], allow_unused=True)
        finally:
            snapshot.restore()
        self.backbone.outputs = self.heads.inputs = (h.detach(), l.detach())
        self.backbone.grad_outputs = grads2[:2]
        self.backbone.grad_inputs = grads1
        self.heads.outputs = (fp.detach(), ll.detach())
        self.heads.grad_outputs = (grad_fp, grad_ll)
        self.heads.grad_inputs = grads2

    def _fill(self, parts) -> None:
        if len(parts) > 1:
            torch.cat(parts, dim=0, out=self.x)
        else:
            self.x.copy_(parts[0])

    def __call__(self, parts, params):
        self._fill(parts)
        with tracing.span("clr.backbone"):
            high, low = self.backbone.apply((), params)
        return self.heads.apply((high, low), params)
