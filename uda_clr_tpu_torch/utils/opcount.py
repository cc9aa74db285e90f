"""Bytes and flops of each op a PyTorch computation dispatches: the work
model of the per-op roofline (``roofline_closure.py``; the counterpart of
the HLO parse in the JAX package's tools/roofline_closure.py).

The JAX tool reads optimised HLO and pads bytes to the TPU's (8, 128)
tiles; neither exists here. The unit is the eager aten op the dispatcher
sees (``TorchDispatchMode``), forward and backward alike: autograd's
thread runs under the same mode.

* **bytes**: the op's input tensors, each distinct one read once (``x +
  x`` reads ``x`` once), plus its outputs, each written once, at their real
  element sizes. A tensor's bytes count its distinct elements: a dimension
  of stride 0 (a broadcast) counts once. An op whose outputs are all views
  of an input (``view``, ``transpose``, ``slice`` ...) moves nothing, nor do
  the allocations (``empty``) and ``detach``. An in-place op reads and writes
  its tensor once each; an ``out=`` tensor is written, not read.
* **flops**: ``torch.utils.flop_counter``'s formulas (convolutions, matrix
  products, attention), each convolution gradient at its forward's cost
  (``utils/benchmarking._conv_backward_flops``), so the ops' flops sum to
  ``benchmarking.count_flops`` of the same call. Elementwise work counts
  nothing there, and nothing here.

The hand-written kernels launch through ctypes, invisible to dispatch; the
roofline takes them from their counters (:func:`kernel_work`).

With ``annotate``, each op runs inside ``torch.profiler.record_function``
under :data:`RANGE_PREFIX` + its key, so a profile attributes every kernel
whose launch falls in that range to the op (``roofline_closure.py``).
"""

from __future__ import annotations

import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from uda_clr_tpu_torch.utils.benchmarking import MASK_HEAD_FLOPS_PER_ROW, flop_counter

RANGE_PREFIX = "uda_op:"

_aten = torch.ops.aten
# ops that move no device memory: allocations and the autograd bookkeeping
_NO_TRAFFIC = {
    _aten.empty.memory_format, _aten.empty_like.default, _aten.empty_strided.default,
    _aten.new_empty.default, _aten.new_empty_strided.default, _aten.detach.default,
    _aten.lift_fresh.default,
}

# K1's bytes per row: x_up [256], ll [48] and boundary [1] read, the two
# logits written (the element size is the activation's); its flops per row
# are benchmarking.MASK_HEAD_FLOPS_PER_ROW
MASK_HEAD_ELEMS_PER_ROW = 256 + 48 + 1 + 2


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of ``t``'s distinct elements (a stride-0 dimension counts
    once)."""
    if t.numel() == 0:
        return 0
    return t.element_size() * math.prod(n for n, s in zip(t.shape, t.stride()) if s != 0)


def _identity(t: torch.Tensor) -> tuple:
    """What makes two input tensors the same read: storage, offset, shape,
    strides and dtype."""
    return (t.untyped_storage().data_ptr(), t.storage_offset(), tuple(t.shape), t.stride(),
            t.dtype)


def _tensors(tree) -> list[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def op_bytes(func, args, kwargs, out) -> int:
    """The bytes model of the module docstring for one call of ``func``."""
    if func in _NO_TRAFFIC:
        return 0
    schema = func._schema
    returns = [r.alias_info for r in schema.returns]
    if returns and all(a is not None and not a.is_write for a in returns):
        return 0  # views
    outs = {arg.name for arg in schema.arguments if arg.is_out}
    reads = {}
    for name, value in kwargs.items():
        if name not in outs:
            for t in _tensors(value):
                reads.setdefault(_identity(t), tensor_bytes(t))
    for t in _tensors(args):
        reads.setdefault(_identity(t), tensor_bytes(t))
    writes = {}
    for t in _tensors(out):
        writes.setdefault(_identity(t), tensor_bytes(t))
    return sum(reads.values()) + sum(writes.values())


def op_key(func, args, kwargs) -> str:
    """The op's name and its input tensors' dtypes and shapes, e.g.
    ``aten.convolution.default bf16[16,3,512,512] bf16[32,3,3,3]``."""
    parts = [str(func)]
    for t in _tensors((args, kwargs)):
        dtype = str(t.dtype).replace("torch.", "").replace("bfloat16", "bf16") \
            .replace("float", "f")
        parts.append(f"{dtype}[{','.join(str(n) for n in t.shape)}]")
    return " ".join(parts)


class OpCounter(TorchDispatchMode):
    """Within ``with OpCounter() as c:``, every dispatched op adds its call,
    bytes and flops to ``c.ops[key]`` (:func:`op_key`), a dict of ``name``,
    ``calls``, ``bytes`` and ``flops``. ``annotate`` wraps each op in a
    profiler range named :data:`RANGE_PREFIX` + its key."""

    def __init__(self, annotate: bool = False):
        super().__init__()
        self.annotate = annotate
        self.ops: dict[str, dict] = {}
        # the formulas benchmarking.count_flops counts by
        self._flops = flop_counter().flop_registry

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        key = op_key(func, args, kwargs)
        if self.annotate:
            with torch.profiler.record_function(RANGE_PREFIX + key):
                out = func(*args, **kwargs)
        else:
            out = func(*args, **kwargs)
        formula = self._flops.get(func._overloadpacket)
        flops = int(formula(*args, **kwargs, out_val=out)) if formula is not None else 0
        rec = self.ops.setdefault(key, {"name": str(func), "calls": 0, "bytes": 0, "flops": 0})
        rec["calls"] += 1
        rec["bytes"] += op_bytes(func, args, kwargs, out)
        rec["flops"] += flops
        return out

    def total(self, field: str) -> int:
        return sum(rec[field] for rec in self.ops.values())


def kernel_counts() -> dict:
    """The hand-written kernels' counters now (ops/mask_head.py,
    ops/dropout.py, ops/domain_norm.py); :func:`kernel_work` takes two
    readings' difference."""
    from uda_clr_tpu_torch.ops import domain_norm, dropout, mask_head

    return {"k1": mask_head.LAUNCHES, "rows": mask_head.ROWS, "k3_fwd": dropout.LAUNCHES_FWD,
            "k3_bwd": dropout.LAUNCHES_BWD, "k3_bytes": dropout.BYTES,
            "k4": (domain_norm.LAUNCHES_MOMENTS + domain_norm.LAUNCHES_FWD
                   + domain_norm.LAUNCHES_REDUCE + domain_norm.LAUNCHES_BWD),
            "k4_bytes": domain_norm.BYTES}


def kernel_work(before: dict, after: dict, dtype: torch.dtype) -> dict:
    """{kernel: {"launches", "bytes", "flops"}} of the ctypes launches
    between two :func:`kernel_counts` readings: the MC mask head K1 (its
    rows at ``dtype``: ``MASK_HEAD_ELEMS_PER_ROW`` elements and
    ``MASK_HEAD_FLOPS_PER_ROW`` flops each; 643.8 MB and 1.28 GFLOP per
    launch at 1,048,576 bf16 rows; K2, which shares the rows' counter, is
    on no train path), the dropout kernel K3 (each launch reads its
    input and writes its output once) and the norm kernel K4 (its four
    entries' byte bounds: the moments read x, the forward reads x and
    writes y, the reduce reads dy and x, dx reads both and writes dx)."""
    d = {k: after[k] - before[k] for k in after}
    itemsize = torch.empty((), dtype=dtype).element_size()
    out = {}
    if d["k1"]:
        out["K1 mask_head_split"] = {"launches": d["k1"],
                                     "bytes": d["rows"] * MASK_HEAD_ELEMS_PER_ROW * itemsize,
                                     "flops": d["rows"] * MASK_HEAD_FLOPS_PER_ROW}
    k3 = d["k3_fwd"] + d["k3_bwd"]
    if k3:
        out["K3 dropout"] = {"launches": k3, "bytes": d["k3_bytes"], "flops": 0}
    if d["k4"]:
        out["K4 domain_norm"] = {"launches": d["k4"], "bytes": d["k4_bytes"], "flops": 0}
    return out
