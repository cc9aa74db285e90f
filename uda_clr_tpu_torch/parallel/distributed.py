"""Data parallelism across OS processes (the counterpart of
uda_clr_tpu/parallel/distributed.py): one process per device, each loading
its rows of every global batch (``BatchLoader(process_index,
process_count)``, data/pipeline.py) and running the same train step on
them, with the step's cross-rank reductions in :mod:`.reduce`.

The rule for losses and gradients. Let N be the world size and L the
single-process loss on the global batch. Each rank r computes L_r so that
(1/N) * sum_r L_r = L:

* a plain mean over equal shards stays as it is (the BCE and MSE losses,
  the discriminator losses, ``source_discriminative_loss``);
* a value that depends only on global quantities is computed the same on
  every rank (the intra and inter prototype losses, ``transfer_factor``,
  ``bank_ema``'s condition). A prototype pool is such a value:
  ``all_sum(num) / all_sum(den)``;
* a loss that is a ratio with a data-dependent denominator becomes
  ``N * local_num / all_sum(den)``, the denominator detached where the JAX
  package's is (``loss_aug``);
* every cross-rank reduction in the forward goes through one autograd
  Function (:func:`.reduce.all_sum`): an ``all_reduce`` SUM forward and an
  ``all_reduce`` SUM of the cotangent backward, so that averaging the
  ranks' gradients gives the gradient of L. Min and max take ``all_reduce``
  MIN/MAX, and the gradient goes to the rank that holds the extremum;
* before every optimizer step that optimizer's gradients are averaged over
  the ranks, one flat ``all_reduce`` per optimizer
  (:func:`.reduce.average_grads`). Not DDP: a step runs several backward
  passes through different optimizers (``bcdm`` up to six), which DDP's
  hooks do not expect;
* every logged metric is the mean over ranks of L_r, under the rule above
  the global value;
* at world size 1 every collective returns its input: none is launched and
  nothing is copied, so the single-process path is unchanged.

Randomness: draws that the JAX package makes for the global batch (the
strong-augment draws, the mean teacher's input noise) are drawn for the
global batch on every rank, each rank taking its rows. Dropout (K1, K3,
'xla16'/'xla') draws per rank: the rank is folded into the step's seeds
and the state's generator seed (:func:`rank_seed`), rank 0's streams being
the single-process streams.

Backends: ``nccl`` on CUDA and ``gloo`` on the CPU unless
``RunConfig.dist_backend`` says otherwise. ``nccl`` refuses two ranks on
one card, so that case raises and names ``dist_backend: gloo``; gloo runs
``all_reduce`` and ``broadcast`` on CUDA tensors through the host. Nothing
switches backend silently, and a failed ``init_process_group`` raises.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from uda_clr_tpu_torch.ops.philox import MASK64, splitmix64


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main() -> bool:
    return rank() == 0


def local_rank() -> int:
    """This process's index among the ranks on its host (``LOCAL_RANK`` as
    torchrun sets it, else the global rank: one host)."""
    return int(os.environ.get("LOCAL_RANK", rank()))


def _local_world(num_processes: int) -> int:
    return int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))


def rank_seed(seed: int, r: int | None = None) -> int:
    """A 64-bit seed with rank ``r`` (this process's by default) folded in;
    rank 0's is ``seed`` itself, so rank 0 draws the single-process
    streams."""
    r = rank() if r is None else r
    if r == 0:
        return seed
    return splitmix64((seed ^ (r * 0xD1B54A32D192ED03)) & MASK64)


def resolve_backend(backend: str | None, device: str | torch.device, num_processes: int) -> str:
    """``backend``, or nccl on CUDA and gloo on the CPU when None. Raises
    for nccl without CUDA and for nccl with more ranks on this host than
    cards (nccl refuses two ranks on one device)."""
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"dist_backend {backend!r}; 'nccl' or 'gloo'")
    if backend == "nccl":
        if device.type != "cuda" or not torch.cuda.is_available():
            raise ValueError("dist_backend nccl needs CUDA devices; on the CPU set "
                             "`dist_backend: gloo` in the run config")
        n_cards, local = torch.cuda.device_count(), _local_world(num_processes)
        if local > n_cards:
            raise ValueError(
                f"nccl cannot run {local} ranks on {n_cards} card(s) of one host (it refuses "
                f"two ranks on one device); set `dist_backend: gloo` in the run config")
    return backend


def initialize(coordinator: str, num_processes: int, process_id: int,
               backend: str | None = None, device: str | torch.device = "cuda") -> None:
    """``torch.distributed.init_process_group``: ``coordinator`` is
    ``host:port`` of rank 0 (becomes ``tcp://host:port``) or a URL such as
    ``file:///path`` (passed through). Raises if the group does not form."""
    backend = resolve_backend(backend, device, num_processes)
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=url, world_size=num_processes,
                            rank=process_id)


def maybe_initialize(run_cfg, device: str | torch.device = "cuda") -> bool:
    """Config-gated init: ``run_cfg.dist_coordinator`` set means data
    parallelism across ``dist_num_processes`` processes. Returns True when
    a process group is active (one this call formed, or one that already
    exists with the configured size and rank)."""
    coord = run_cfg.dist_coordinator
    n, pid = run_cfg.dist_num_processes, run_cfg.dist_process_id
    if not coord:
        if n > 1:
            raise ValueError(f"dist_num_processes {n} needs dist_coordinator (host:port of "
                             f"rank 0) and dist_process_id in the run config")
        return dist.is_initialized()
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank()) != (n, pid):
            raise ValueError(f"a process group of {dist.get_world_size()} ranks (this rank "
                             f"{dist.get_rank()}) exists; the config asks for {n} (rank {pid})")
        return True
    initialize(coord, n, pid, getattr(run_cfg, "dist_backend", None), device)
    return True


def rank_device(base: str | torch.device = "cuda") -> torch.device:
    """This rank's device: ``cuda:{local_rank % device_count}`` for a CUDA
    ``base``, else the CPU."""
    base = torch.device(base)
    if base.type != "cuda":
        return base
    if base.index is not None and world_size() == 1:
        return base
    return torch.device("cuda", local_rank() % max(torch.cuda.device_count(), 1))


def put_global(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """This rank's rows of a global batch (what its loader gave it) on its
    device; pinned for an asynchronous copy to a card."""
    t = torch.from_numpy(x)
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


def shutdown() -> None:
    """End the process group, and the spatial mesh's groups with it."""
    from uda_clr_tpu_torch.parallel import spatial  # spatial imports this module

    spatial.clear()
    if dist.is_initialized():
        dist.destroy_process_group()
