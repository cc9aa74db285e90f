"""The ``('data', 'space')`` mesh across processes: the batch split over
``n_data`` data indices and the image rows (H) over ``n_space`` space
indices, one process per device (the counterpart of
uda_clr_tpu/parallel/mesh.py's 2-D mesh, where GSPMD inserts the conv halo
exchanges and spans the batch-norm reductions over both axes).

Layout (:mod:`.mesh`): rank r is data index ``r // n_space`` and space
index ``s = r % n_space``; it holds its data index's rows of the global
batch (``local_rows(B, d, n_data)``) and rows ``[s*H/n_space,
(s+1)*H/n_space)`` of every per-pixel array. :func:`init_mesh` forms one
process group per data index (its space ranks) and one per space index;
the world group keeps the global reductions (:mod:`.reduce`).

The train step enters :func:`region`; inside it the layers that read
across rows take them from the neighbouring stripes:

* :func:`halo_rows` - a stripe with rows above and below from the ranks
  that own them (as many ranks away as the halo reaches), zeros, ``-inf``
  or the reflection beyond the image's edge. Only the rows asked for
  move. Backward sends each halo row's cotangent back to its owner, which
  adds it in. The convs (``models/layers.Conv2d``, ``fixed_padding``, the
  MC pass's split convs), the stem's max pool, the align-corners resizes
  (``ops/resize.py``) and the blur of the strong augmentation pad with it;
* :func:`space_sum` - a sum over the space group (ASPP's image pool, the
  per-image pools of the disk-bank method), with the cotangent summed over
  the group, as ``reduce.all_sum`` does over the world;
* :func:`gather_rows` - the stripes joined over the space group (the
  discriminators' inputs), each stripe's cotangent summed over the group.

Under :mod:`.distributed`'s rule each rank's loss L_r is its data index's
loss computed from its stripe, so that (1/N) sum_r L_r is the global loss:
plain means over equal stripes stay as they are, and a value computed whole
on every rank of a space group (a discriminator's loss on the gathered
input) counts once per space rank, n_space / N = 1 / n_data each.

Outside :func:`region` (validation, the tools, every 1-D path) nothing here
runs. Backends: under nccl the rows cross device to device
(``batch_isend_irecv``). gloo sends and receives CPU tensors only, so
under gloo a card's halo rows are staged through the host explicitly
(copied out, sent, received, copied back); its all-reduces take card
tensors directly. Nothing switches backend.
"""

from __future__ import annotations

import contextlib
import functools
from typing import NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from uda_clr_tpu_torch.parallel.distributed import rank, world_size
from uda_clr_tpu_torch.parallel.mesh import check_mesh, mesh_coords


class SpatialMesh(NamedTuple):
    n_data: int
    n_space: int
    data_index: int
    space_index: int
    space_ranks: tuple  # the global ranks of this rank's space group, by space index
    space_group: object  # this data index's ranks: the halo, space sum and gather
    # this space index's ranks (a stripe across the data indices); the
    # step's global reductions take the world group
    data_group: object


_MESH: SpatialMesh | None = None
_ACTIVE = False


def init_mesh(mesh_shape) -> SpatialMesh | None:
    """Form the 2-D mesh's process groups for ``mesh_shape = (n_data,
    n_space)`` over the current process group; every rank calls it at the
    same point. None (and no group formed) for None, a 1-D shape or
    ``n_space == 1``, which are data parallelism alone."""
    global _MESH
    _MESH = None
    if mesh_shape is None or len(mesh_shape) != 2 or mesh_shape[1] == 1:
        check_mesh(mesh_shape, world_size())
        return None
    check_mesh(mesh_shape, world_size())
    n_data, n_space = (int(n) for n in mesh_shape)
    d, s = mesh_coords(rank(), n_space)
    space_group = data_group = None
    # every rank forms every group, in one order
    for i in range(n_data):
        g = dist.new_group([i * n_space + j for j in range(n_space)])
        if i == d:
            space_group = g
    for j in range(n_space):
        g = dist.new_group([i * n_space + j for i in range(n_data)])
        if j == s:
            data_group = g
    _MESH = SpatialMesh(n_data, n_space, d, s, tuple(d * n_space + j for j in range(n_space)),
                        space_group, data_group)
    return _MESH


def clear() -> None:
    """Forget the mesh (its groups end with the process group)."""
    global _MESH, _ACTIVE
    _MESH, _ACTIVE = None, False


def mesh() -> SpatialMesh | None:
    return _MESH


def active() -> bool:
    """True inside :func:`region` on a mesh with more than one stripe."""
    return _ACTIVE


@contextlib.contextmanager
def region():
    """The train step's extent: the layers read across stripes inside it.
    A no-op without a 2-D mesh."""
    global _ACTIVE
    before = _ACTIVE
    _ACTIVE = _MESH is not None
    try:
        yield
    finally:
        _ACTIVE = before


@contextlib.contextmanager
def whole():
    """A computation on whole images inside the step's extent (a
    discriminator on its gathered input): the layers read no halo."""
    global _ACTIVE
    before = _ACTIVE
    _ACTIVE = False
    try:
        yield
    finally:
        _ACTIVE = before


def data_coords() -> tuple[int, int]:
    """(this rank's data index, the number of data indices): (rank, world)
    without a 2-D mesh."""
    if _MESH is None:
        return rank(), world_size()
    return _MESH.data_index, _MESH.n_data


def space_coords() -> tuple[int, int]:
    """(this rank's space index, the number of stripes): (0, 1) without a
    2-D mesh."""
    if _MESH is None:
        return 0, 1
    return _MESH.space_index, _MESH.n_space


# ---- halo rows ------------------------------------------------------------


class _Plan(NamedTuple):
    """One rank's part in a halo exchange, as positions in its output
    (``out_rows`` rows) and rows of its input."""

    out_rows: int
    own_pos: tuple  # output positions filled from this rank's own rows ...
    own_rows: tuple  # ... these (local indices)
    fill_pos: tuple  # output positions beyond the image: the pad value
    recv: tuple  # ((space index q, output positions filled from q's message), ...)
    send: tuple  # ((space index q, local rows q asks for, in q's order), ...)


@functools.lru_cache(maxsize=None)
def _halo_plan(n: int, s: int, h: int, top: int, bottom: int, pad: str, e_top: int,
               e_bot: int) -> _Plan:
    """The exchange that gives every stripe ``top`` rows above and
    ``bottom`` below. Stripes hold ``h`` image rows each; the first also
    holds ``e_top`` rows above the image and the last ``e_bot`` below it
    (padding an earlier pointwise layer already carries), so global rows
    run from ``-e_top`` to ``n*h + e_bot``. Rows past those take ``pad``:
    'zeros' or '-inf', or 'reflect' (reflect-101, only with e_top = e_bot
    = 0). Every rank derives every rank's part alike."""
    total = n * h

    def source(g):
        if pad == "reflect" and not 0 <= g < total:
            g = -g if g < 0 else 2 * (total - 1) - g
            if not 0 <= g < total:
                raise ValueError(f"a reflected halo of {max(top, bottom)} rows is wider than "
                                 f"the image's {total} rows")
        if not -e_top <= g < total + e_bot:
            return None
        q = min(max(g // h, 0), n - 1)
        return q, g - q * h + (e_top if q == 0 else 0)

    def wants(r):
        return [source(g) for g in range(r * h - top, (r + 1) * h + bottom)]

    mine = wants(s)
    own = [(p, src[1]) for p, src in enumerate(mine) if src is not None and src[0] == s]
    recv = tuple((q, tuple(p for p, src in enumerate(mine) if src is not None and src[0] == q))
                 for q in range(n) if q != s)
    send = tuple((r, tuple(src[1] for src in wants(r) if src is not None and src[0] == s))
                 for r in range(n) if r != s)
    return _Plan(len(mine), tuple(p for p, _ in own), tuple(r for _, r in own),
                 tuple(p for p, src in enumerate(mine) if src is None),
                 tuple((q, pos) for q, pos in recv if pos),
                 tuple((r, rows) for r, rows in send if rows))


@functools.lru_cache(maxsize=None)
def _index(rows: tuple, device: torch.device) -> torch.Tensor:
    """The row indices of a plan on ``device``, made once (a host-to-card
    copy per call would wait for the card's queued work)."""
    return torch.tensor(rows, dtype=torch.long, device=device)


def _exchange(sends: dict, recv_counts: dict, like: torch.Tensor) -> dict:
    """Row blocks of ``like`` ([B, C, k, W]) to and from the space group's
    ranks, by space index; returns the received blocks on ``like``'s
    device. gloo's send and receive take CPU tensors: a card's blocks
    cross through the host."""
    m = _MESH
    staged = like.is_cuda and dist.get_backend() == "gloo"
    ops, received = [], {}
    for q, t in sends.items():
        t = t.contiguous()
        ops.append(dist.P2POp(dist.isend, t.cpu() if staged else t, m.space_ranks[q]))
    b, c, _, w = like.shape
    for q, k in recv_counts.items():
        buf = torch.empty((b, c, k, w), dtype=like.dtype,
                          device="cpu" if staged else like.device)
        received[q] = buf
        ops.append(dist.P2POp(dist.irecv, buf, m.space_ranks[q]))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return {q: buf.to(like.device) for q, buf in received.items()}


def _empty_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    fmt = (torch.channels_last if x.dim() == 4 and not x.is_contiguous()
           and x.is_contiguous(memory_format=torch.channels_last) else torch.contiguous_format)
    return torch.empty((x.shape[0], x.shape[1], rows, x.shape[3]), dtype=x.dtype,
                       device=x.device, memory_format=fmt)


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, key, fill):
        plan = _halo_plan(*key)
        ctx.plan, ctx.shape = plan, x.shape
        out = _empty_rows(x, plan.out_rows)
        dev = x.device
        if plan.fill_pos:
            out.index_fill_(2, _index(plan.fill_pos, dev), fill)
        out.index_copy_(2, _index(plan.own_pos, dev), x.index_select(2, _index(plan.own_rows, dev)))
        got = _exchange({q: x.index_select(2, _index(rows, dev)) for q, rows in plan.send},
                        {q: len(pos) for q, pos in plan.recv}, x)
        for q, pos in plan.recv:
            out.index_copy_(2, _index(pos, dev), got[q])
        return out

    @staticmethod
    def backward(ctx, g):
        plan = ctx.plan
        dev = g.device
        gx = g.new_zeros(ctx.shape)
        gx.index_add_(2, _index(plan.own_rows, dev), g.index_select(2, _index(plan.own_pos, dev)))
        like = g.new_empty((ctx.shape[0], ctx.shape[1], 1, ctx.shape[3]))
        got = _exchange({q: g.index_select(2, _index(pos, dev)) for q, pos in plan.recv},
                        {q: len(rows) for q, rows in plan.send}, like)
        for q, rows in plan.send:
            gx.index_add_(2, _index(rows, dev), got[q])
        return gx, None, None


_FILL = {"zeros": 0.0, "-inf": float("-inf"), "reflect": 0.0}


def halo_rows(x: torch.Tensor, top: int, bottom: int, pad: str = "zeros",
              edge: tuple[int, int] = (0, 0)) -> torch.Tensor:
    """This rank's stripe of NCHW ``x`` with ``top`` rows above and
    ``bottom`` below (differentiable). Beyond the image: ``pad`` 'zeros',
    '-inf' or 'reflect' (reflect-101, as ``F.pad(mode='reflect')``).
    ``edge = (e_top, e_bot)``: the first stripe already carries ``e_top``
    rows above the image and the last ``e_bot`` below it (an earlier
    pointwise layer ran on them); those are rows of the image here. Every
    rank of the space group asks for the same ``top`` and ``bottom`` (each
    derives the others' part from its own). The identity outside
    :func:`region` or with no rows asked for."""
    if not _ACTIVE or top == bottom == 0:
        return x
    n, s = _MESH.n_space, _MESH.space_index
    h = x.shape[2] - (edge[0] if s == 0 else 0) - (edge[1] if s == n - 1 else 0)
    if pad not in _FILL:
        raise ValueError(f"halo pad {pad!r}; 'zeros', '-inf' or 'reflect'")
    key = (n, s, h, top, bottom, pad, *edge)
    return _Halo.apply(x, key, _FILL[pad])


def edge_pad(x: torch.Tensor, top: int, bottom: int) -> torch.Tensor:
    """``top`` zero rows above the image on the first stripe and ``bottom``
    below it on the last; every other stripe is returned as it is. With
    ``halo_rows(..., edge=(top, bottom))`` after a pointwise layer."""
    s, n = space_coords()
    return F.pad(x, (0, 0, top if s == 0 else 0, bottom if s == n - 1 else 0))


def conv_halo(kernel: int, stride: int, padding: int, dilation: int, rows: int) -> tuple[int, int]:
    """(top, bottom) halo rows of a conv along H over a stripe of ``rows``
    rows whose output is the stripe's ``rows // stride`` rows of the
    whole image's (``padding`` rows of zeros at the image's edges)."""
    if rows % stride:
        raise ValueError(f"a stripe of {rows} rows does not split at stride {stride}; the image "
                         f"height must split evenly at every stride-2 stage (mesh.check_stripes)")
    return padding, max(0, (kernel - 1) * dilation - padding - (stride - 1))


def conv2d(x, weight, bias, stride, padding, dilation, groups) -> torch.Tensor:
    """``F.conv2d`` of this rank's stripe: the H padding is the halo (zeros
    at the image's edges), the W padding stays. Without H padding the conv
    reads the rows it is given: its own, or halo rows its caller fetched
    (``layers.fixed_padding``). Tuples of two ints for ``stride``,
    ``padding`` and ``dilation``."""
    if padding[0] == 0:
        return F.conv2d(x, weight, bias, stride, padding, dilation, groups)
    top, bottom = conv_halo(weight.shape[2], stride[0], padding[0], dilation[0], x.shape[2])
    y = F.conv2d(halo_rows(x, top, bottom), weight, bias, stride, (0, padding[1]), dilation,
                 groups)
    if y.shape[2] != x.shape[2] // stride[0]:
        raise ValueError(f"a conv (k {weight.shape[2]}, stride {stride[0]}, padding "
                         f"{padding[0]}, dilation {dilation[0]}) does not keep its rows in "
                         f"stripes: {x.shape[2]} -> {y.shape[2]}")
    return y


# ---- reductions and gathers over the space group --------------------------


class _SpaceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y, dist.ReduceOp.SUM, group=_MESH.space_group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, dist.ReduceOp.SUM, group=_MESH.space_group)
        return g


def space_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over this rank's space group (differentiable); the
    identity outside :func:`region`."""
    return _SpaceSum.apply(x) if _ACTIVE else x


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        n, s = _MESH.n_space, _MESH.space_index
        ctx.dim, ctx.rows = dim, x.shape[dim]
        shape = list(x.shape)
        shape[dim] *= n
        # one all-reduce of a buffer holding this stripe alone: gloo
        # reduces card tensors, and x + 0 is x
        buf = x.new_zeros(shape)
        buf.narrow(dim, s * ctx.rows, ctx.rows).copy_(x)
        dist.all_reduce(buf, dist.ReduceOp.SUM, group=_MESH.space_group)
        return buf

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, dist.ReduceOp.SUM, group=_MESH.space_group)
        return g.narrow(ctx.dim, _MESH.space_index * ctx.rows, ctx.rows), None


def gather_rows(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The space group's stripes of ``x`` joined along ``dim``, in space
    order (differentiable: each stripe's cotangent summed over the group);
    the identity outside :func:`region`."""
    return _GatherRows.apply(x, dim) if _ACTIVE else x


def batch_share(x: torch.Tensor, groups: int) -> torch.Tensor:
    """This space index's share of the images of ``x``, a tensor the same
    on every rank of the space group: of each of ``groups`` equal
    consecutive parts (the source and target halves), the ``s``-th of
    ``n_space`` slices. With :func:`gather_batch`."""
    s, n = space_coords()
    per = x.shape[0] // groups
    if per % n:
        raise ValueError(f"{per} images per domain on this data index do not split over "
                         f"{n} stripes for the image-pool branch's batch statistics")
    share = per // n
    return x.unflatten(0, (groups, per))[:, s * share:(s + 1) * share].flatten(0, 1)


def gather_batch(x: torch.Tensor, groups: int) -> torch.Tensor:
    """The inverse of :func:`batch_share` over the space group."""
    y = gather_rows(x.unflatten(0, (groups, x.shape[0] // groups)), 1)
    return y.flatten(0, 1)
