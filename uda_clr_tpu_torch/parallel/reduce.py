"""The cross-rank reductions of the train step (the rule is in
:mod:`.distributed`'s docstring). Each is the identity at world size 1: no
collective is launched and nothing is copied."""

from __future__ import annotations

import torch
import torch.distributed as dist

from uda_clr_tpu_torch.parallel.distributed import world_size


class _AllSum(torch.autograd.Function):
    """``all_reduce`` SUM forward; ``all_reduce`` SUM of the cotangent
    backward, so the ranks' averaged gradients are those of the mean of
    their losses."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y, dist.ReduceOp.SUM)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, dist.ReduceOp.SUM)
        return g


class _AllExtreme(torch.autograd.Function):
    """``all_reduce`` MIN or MAX; the (all-summed) cotangent goes to the
    elements that hold the extremum, on the rank that holds it."""

    @staticmethod
    def forward(ctx, x, op):
        y = x.clone()
        dist.all_reduce(y, op)
        ctx.save_for_backward(x == y)
        return y

    @staticmethod
    def backward(ctx, g):
        (held,) = ctx.saved_tensors
        g = g.clone()
        dist.all_reduce(g, dist.ReduceOp.SUM)
        return torch.where(held, g, torch.zeros_like(g)), None


def all_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks (differentiable)."""
    return x if world_size() == 1 else _AllSum.apply(x)


def all_min(x: torch.Tensor) -> torch.Tensor:
    return x if world_size() == 1 else _AllExtreme.apply(x, dist.ReduceOp.MIN)


def all_max(x: torch.Tensor) -> torch.Tensor:
    return x if world_size() == 1 else _AllExtreme.apply(x, dist.ReduceOp.MAX)


def average_grads(params) -> None:
    """Average the gradients of ``params`` over the ranks in place, one flat
    ``all_reduce``; parameters without a gradient are skipped (every rank
    ran the same graph, so they agree on which)."""
    n = world_size()
    if n == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, dist.ReduceOp.SUM)
    flat.div_(n)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view(g.shape))
        offset += g.numel()


def mean_metrics(metrics: dict) -> dict:
    """Each 0-d metric's mean over the ranks, one packed ``all_reduce``."""
    n = world_size()
    if n == 1 or not metrics:
        return metrics
    keys = list(metrics)
    packed = torch.stack([metrics[k].detach().float() for k in keys])
    dist.all_reduce(packed, dist.ReduceOp.SUM)
    packed.div_(n)
    return dict(zip(keys, packed.unbind()))


def _on_backend_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """nccl reduces device tensors only: a CPU tensor (Adam's step count)
    crosses through ``device``."""
    if dist.get_backend() == "nccl" and not t.is_cuda:
        return t.to(device)
    return t


def broadcast_(tensors, device: torch.device) -> None:
    """Overwrite ``tensors`` with rank 0's values, in place (a bool tensor
    crosses as uint8)."""
    if world_size() == 1:
        return
    for t in tensors:
        t = t.detach()
        buf = _on_backend_device(t.to(torch.uint8) if t.dtype == torch.bool else t, device)
        dist.broadcast(buf, 0)
        if buf is not t:
            t.copy_(buf)


def replica_gap(tensors, device: torch.device) -> float:
    """The largest |difference| between this rank's ``tensors`` and rank
    0's, over every rank: broadcast from rank 0, then ``all_reduce`` MAX.
    0.0 when every rank holds the same bits."""
    if world_size() == 1:
        return 0.0
    gap = torch.zeros((), dtype=torch.float64, device=device)
    for t in tensors:
        mine = t.detach().to(device=device, dtype=torch.float64)
        ref = mine.clone()
        dist.broadcast(ref, 0)
        if mine.numel():
            gap = torch.maximum(gap, (mine - ref).abs().max())
    dist.all_reduce(gap, dist.ReduceOp.MAX)
    return float(gap)


def gather_rows(t: torch.Tensor, device: torch.device) -> list[torch.Tensor]:
    """Every rank's copy of the 1-d integer tensor ``t`` (all of one length),
    through one ``all_reduce`` SUM of a [world, len] buffer that holds this
    rank's row alone."""
    n, r = world_size(), dist.get_rank() if world_size() > 1 else 0
    if n == 1:
        return [t]
    buf = torch.zeros((n, t.numel()), dtype=torch.int64, device=device)
    buf[r] = t.to(device=device, dtype=torch.int64)
    dist.all_reduce(buf, dist.ReduceOp.SUM)
    return [row.to(device=t.device, dtype=t.dtype) for row in buf.cpu()]
