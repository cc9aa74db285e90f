"""Checkpoint / resume in the reference's flat ``torch.save`` dict
(Trainer_prototype_full.py:176-207), with no orbax.

A checkpoint is ``{ckpt_dir}/{tag}.pth.tar`` beside ``{tag}.meta.json``
(epoch, best_mean_dice, iteration). The dict carries the reference's keys,
which ``uda_clr_tpu/convert/torch_import.py:load_reference_checkpoint``
reads: ``epoch``, ``iteration``, ``best_mean_dice``, ``model_state_dict``,
``model_dis_state_dict`` and ``model_dis2_state_dict`` (for the
discriminators the method plays against), ``optim_state_dict``,
``optim_dis_state_dict``, ``optim_dis2_state_dict`` and the learning rates.
An exact resume also needs what the port adds: the prototype banks and
their init flags, the state's ``torch.Generator`` state, ``seed`` and
``step`` (the K1/K3 Philox seeds derive from them, train/steps.py), the
mean teacher's state_dict, and for the disk-bank method its bank
(``proto_bank``) and the frozen initial model (``initial_state_dict``).
TransNorm's running stats sit in ``model_state_dict`` under the
reference's keys (``running_{mean,var}_{source,target}``). A ``bcdm``
checkpoint keeps the generator (backbone + first classifier) under
``model_state_dict``, the second classifier under
``model_cls2_state_dict`` and the three Adam states under
``optim_{fea,cls1,cls2}_state_dict`` in place of ``optim_state_dict``.

Under data parallelism every rank calls :func:`save_checkpoint` (it
gathers each rank's dropout generator into ``generator_states``, with the
shared ``noise_generator_state``), rank 0 alone writes, and the ranks meet
at a barrier; on resume every rank loads the same file and takes its own
generator state (a checkpoint from another world size: rank 0 takes the
saved one and every other rank reseeds from the step, so the ranks' streams
stay distinct).
"""

from __future__ import annotations

import json
import os
import re
from typing import Optional

import numpy as np
import torch

from uda_clr_tpu_torch.ops.philox import MASK64, splitmix64
from uda_clr_tpu_torch.parallel import distributed as dist_lib
from uda_clr_tpu_torch.parallel.reduce import gather_rows
from uda_clr_tpu_torch.train.state import TrainState

_SUFFIX = ".pth.tar"
# what an entry point says when it is given an orbax checkpoint directory
ORBAX_NOTE = ("{what} reads .pth/.pth.tar files; convert an orbax checkpoint directory first "
              "with `python convert_orbax_checkpoint.py CKPT_DIR/TAG OUT.pth.tar` (a script at "
              "the repo's root that needs JAX and orbax)")
# what a pickled numpy scalar needs (the reference stores best_mean_dice as
# a numpy float): its reconstructor, np.dtype and the dtype's class
_NUMPY_SCALARS = [np.float64(0).__reduce__()[0], np.dtype] + [
    type(np.dtype(t)) for t in (np.float64, np.float32, np.int64, np.int32, np.bool_)]


def load_file(path: str) -> dict:
    """``torch.load`` onto the CPU that unpickles only tensors, containers,
    primitives and numpy scalars (``weights_only``), for checkpoints of the
    port and of the reference."""
    with torch.serialization.safe_globals(_NUMPY_SCALARS):
        return torch.load(path, map_location="cpu", weights_only=True)


def _cpu(tree):
    """Detached CPU copies of every tensor in a nested state_dict."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


def _lr(opt) -> Optional[float]:
    return None if opt is None else opt.param_groups[0]["lr"]


def state_dict(state: TrainState) -> dict:
    """The checkpoint dict of ``state`` (tensors on the CPU). Under data
    parallelism every rank must call it: it gathers the ranks' generator
    states."""
    sd = lambda m: None if m is None else m.state_dict()
    ckpt = {
        "model_state_dict": sd(state.gen),
        "proto_src": state.proto_src,
        "proto_trg": state.proto_trg,
        "proto_src_init": state.proto_src_init,
        "proto_trg_init": state.proto_trg_init,
        "generator_state": state.generator.get_state(),
        "seed": state.seed,
        "step": state.step,
    }
    if state.bcdm_opt is None:
        ckpt["optim_state_dict"] = state.gen_opt.state_dict()
        ckpt["learning_rate_gen"] = _lr(state.gen_opt)
    else:
        ckpt["model_cls2_state_dict"] = state.cls2.state_dict()
        for name, opt in state.bcdm_opt.items():
            ckpt[f"optim_{name}_state_dict"] = opt.state_dict()
        ckpt["learning_rate_gen"] = _lr(state.bcdm_opt["fea"])
    for name, model, opt in (("dis", state.dis, state.dis_opt), ("dis2", state.dis2, state.dis2_opt)):
        if model is not None:
            ckpt[f"model_{name}_state_dict"] = model.state_dict()
            ckpt[f"optim_{name}_state_dict"] = opt.state_dict()
            ckpt[f"learning_rate_{name}"] = _lr(opt)
    if state.teacher is not None:
        ckpt["teacher_state_dict"] = state.teacher.state_dict()
    if state.initial is not None:
        ckpt["initial_state_dict"] = state.initial.state_dict()
    if state.proto_bank is not None:
        ckpt["proto_bank"] = dict(state.proto_bank)
    if state.noise_generator is not None:
        ckpt["generator_states"] = gather_rows(state.generator.get_state(), state.proto_src.device)
        ckpt["noise_generator_state"] = state.noise_generator.get_state()
    return _cpu(ckpt)


def load_state_dict(state: TrainState, ckpt: dict) -> TrainState:
    """Restore ``ckpt`` into ``state`` in place (modules, optimizers, banks,
    random state, step counter); the checkpoint must come from the same
    method and switches (the same discriminators, teacher, disk bank and
    initial model, and bcdm's second classifier)."""
    state.gen.load_state_dict(ckpt["model_state_dict"])
    if (state.cls2 is None) != ("model_cls2_state_dict" not in ckpt):
        raise ValueError("checkpoint and state disagree on bcdm's second classifier")
    if state.cls2 is None:
        state.gen_opt.load_state_dict(ckpt["optim_state_dict"])
    else:
        state.cls2.load_state_dict(ckpt["model_cls2_state_dict"])
        for name, opt in state.bcdm_opt.items():
            opt.load_state_dict(ckpt[f"optim_{name}_state_dict"])
    for name, model, opt in (("dis", state.dis, state.dis_opt), ("dis2", state.dis2, state.dis2_opt)):
        key = f"model_{name}_state_dict"
        if (model is None) != (key not in ckpt):
            raise ValueError(f"checkpoint and state disagree on the {name} discriminator")
        if model is not None:
            model.load_state_dict(ckpt[key])
            opt.load_state_dict(ckpt[f"optim_{name}_state_dict"])
    if (state.teacher is None) != ("teacher_state_dict" not in ckpt):
        raise ValueError("checkpoint and state disagree on the mean teacher")
    if state.teacher is not None:
        state.teacher.load_state_dict(ckpt["teacher_state_dict"])
    if (state.initial is None) != ("initial_state_dict" not in ckpt):
        raise ValueError("checkpoint and state disagree on the initial model "
                         "(pseudo_from_initial)")
    if state.initial is not None:
        state.initial.load_state_dict(ckpt["initial_state_dict"])
    if (state.proto_bank is None) != ("proto_bank" not in ckpt):
        raise ValueError("checkpoint and state disagree on the disk prototype bank")
    device = state.proto_src.device
    if state.proto_bank is not None:
        state.proto_bank = {k: v.to(device) for k, v in ckpt["proto_bank"].items()}
    for key in ("proto_src", "proto_trg", "proto_src_init", "proto_trg_init"):
        setattr(state, key, ckpt[key].to(device))
    state.seed, state.step = int(ckpt["seed"]), int(ckpt["step"])
    rank, world = dist_lib.rank(), dist_lib.world_size()
    per_rank = ckpt.get("generator_states")
    if per_rank is not None and len(per_rank) == world:
        state.generator.set_state(per_rank[rank])
    elif rank == 0:
        state.generator.set_state(ckpt["generator_state"])
    else:  # saved at another world size: a stream of this rank's own
        state.generator.manual_seed(dist_lib.rank_seed(
            splitmix64((state.seed * 0x9E3779B97F4A7C15 + state.step) & MASK64), rank))
    if state.noise_generator is not None:
        # the draws for the global batch continue the saving run's: one
        # process drew them from its only generator
        state.noise_generator.set_state(ckpt.get("noise_generator_state",
                                                 ckpt["generator_state"]))
    return state


def save_checkpoint(ckpt_dir: str, state: TrainState, epoch: int, best_mean_dice: float,
                    tag: str, iteration: int = 0) -> str:
    """Write ``{tag}.pth.tar`` and ``{tag}.meta.json``; returns the path.
    Under data parallelism every rank calls it, rank 0 writes, and the
    ranks return together."""
    path = os.path.join(ckpt_dir, tag + _SUFFIX)
    ckpt = state_dict(state)
    if dist_lib.is_main():
        os.makedirs(ckpt_dir, exist_ok=True)
        ckpt.update(epoch=epoch, iteration=iteration, best_mean_dice=best_mean_dice)
        tmp = path + ".tmp"
        torch.save(ckpt, tmp)
        os.replace(tmp, path)  # a reader never sees a half-written file
        with open(os.path.join(ckpt_dir, f"{tag}.meta.json"), "w") as f:
            json.dump({"epoch": epoch, "best_mean_dice": best_mean_dice,
                       "iteration": iteration}, f)
    dist_lib.barrier()
    return path


def restore_checkpoint(ckpt_dir: str, tag: str, state: TrainState) -> tuple[TrainState, dict]:
    """Load ``{tag}.pth.tar`` into ``state``; returns (state, meta), meta
    from the sidecar (or the checkpoint's own keys when it is missing)."""
    path = os.path.join(ckpt_dir, tag if tag.endswith(_SUFFIX) else tag + _SUFFIX)
    ckpt = load_file(path)
    load_state_dict(state, ckpt)
    meta_path = os.path.join(ckpt_dir, f"{tag.removesuffix(_SUFFIX)}.meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    else:
        meta = {k: ckpt[k] for k in ("epoch", "best_mean_dice", "iteration") if k in ckpt}
    return state, meta


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The tag ``checkpoint_N`` with the largest N in ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    tags = [m.group(1) for name in os.listdir(ckpt_dir)
            if (m := re.fullmatch(r"(checkpoint_(\d+))\.pth\.tar", name))]
    if not tags:
        return None
    return max(tags, key=lambda t: int(t.rsplit("_", 1)[-1]))
