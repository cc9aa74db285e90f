"""Long-horizon training of the port's steps: the port's counterpart of the
JAX package's long-horizon family (``tools/_longrun_common.py`` and the
``tools/longrun_parity*.py`` / ``longrun_chaos_control.py`` runs), held
against itself on a device the caller names.

    python -m uda_clr_tpu_torch.longrun --method M [--device cuda|cpu] [--iters N]
        [--size S] [--batch B] [--mc-samples T] [--dtype float32|bfloat16]
        [--dropout off|xla16] [--wire f32|u8] [--workers W] [--compare-cpu] [--chaos]
        [--twin-dtype float32|bfloat16] [--out CSV]

Every run trains one configuration of the family from the same start on the
same stream, as the JAX tools do:

* the state from ``train.state.create_train_state`` (seed 0, or the state
  dicts a caller gives, e.g. the JAX state's through the weight bridge),
  with the tools' logit spread when built from the seed: the mask head's
  last conv (``decoder.last_conv.3``) x10, for the disk-bank method also
  the boundary head's (``decoder.last_conv_boundary.8``), so pseudo-labels
  straddle their thresholds from the first iteration;
* the streams of ``SyntheticFundus`` through ``train_transforms`` (source
  seed 1, loader seed 0, shuffled; target seed 2, loader seed 1, cycled) and
  8 validation images (seed 3) through ``eval_transforms``;
* dropout off and float32 by default (TF32 off on a card), lr_gen 1e-3
  (Adam), lr_dis 2.5e-5 (SGD), the epoch fixed at 30 except for the
  disk-bank method, whose pseudo-label thresholds ramp with the loader's
  epoch. ``--wire u8`` feeds the Trainer's uint8 batches (decoded on the
  device) and ``--workers`` sets the loader's threads, for full width;
  ``main`` loads the stream once per shape and reuses it in a later call.

The configurations: ``prototype_full`` (prototype phase, T=4, the fast MC
pass; 150 iterations), ``prototype`` (the disk bank from seeded normals x0.1
of ``default_rng(11)``; 100), ``prototype_wotn`` (that plus the distance
weights and pseudo-labels from the frozen initial model; 100), ``bcdm``
(60), ``mean_teacher`` (no teacher noise, consistency weight 1; 100) and
``posal`` (one boundary discriminator; its state holds the entropy
discriminator as the JAX state does, and the run raises unless it stays
bit-frozen; 100).

Each run records the family's per-iteration losses, the final validation
Dice (cup, disc) and the launches of K1 and K3; it raises on a non-finite
loss, and with dropout off also if the state's generator drew (no draw may
enter these configurations). ``--chaos`` adds the chaos control: the same
run with the backbone's stem conv times (1 + 1e-6); ``--compare-cpu`` the
same training on the CPU; ``--twin-dtype`` the same training on the device
in the other compute dtype. The summary holds, per key, the smoothed
relative gap of each extra run to the main one (a 10-iteration window,
divided by max(|reference|, 1e-3), as the JAX tools summarise), its value
over the first iterations, and the difference of the final Dice. The last
line printed is one JSON object; ``--out`` writes the per-iteration CSV
(``iter``, ``epoch``, ``<run>_<key>``).
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import json
import math
import os
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from uda_clr_tpu_torch import resolve_device
from uda_clr_tpu_torch.config import Config
from uda_clr_tpu_torch.data.pipeline import BatchLoader
from uda_clr_tpu_torch.data.synthetic import SyntheticFundus
from uda_clr_tpu_torch.data.transforms import eval_transforms, train_transforms
from uda_clr_tpu_torch.models import layers as layers_lib
from uda_clr_tpu_torch.ops import dropout as dropout_ops
from uda_clr_tpu_torch.ops import mask_head
from uda_clr_tpu_torch.train.state import BANK_SIZES, create_train_state
from uda_clr_tpu_torch.train.steps import make_eval_step, make_train_step
from uda_clr_tpu_torch.utils.devinfo import card_fields
from uda_clr_tpu_torch.utils.hostfeed import device_batch
from uda_clr_tpu_torch.utils.metrics import dice_coeff_2label

LR_GEN, LR_DIS, FIXED_EPOCH, CONSISTENCY = 1e-3, 2.5e-5, 30, 1.0
N_DATA, N_VAL = 24, 8  # synthetic images per training domain, validation images
SPREAD = 10.0
MASK_OUT = ("decoder.last_conv.3.weight", "decoder.last_conv.3.bias")
BOUNDARY_OUT = ("decoder.last_conv_boundary.8.weight", "decoder.last_conv_boundary.8.bias")
CHAOS_KEY = "backbone.features.0.0.weight"  # the stem conv (JAX: backbone.stem.conv.kernel)
CHAOS = 1e-6
WINDOW, EARLY = 10, 5  # the smoothing window; the iterations of the early gap
FLOOR = 1e-3  # the gap's least denominator


@dataclass(frozen=True)
class Family:
    """One configuration of the family: its step, the keys it records, its
    default length, MC samples, phase, and whether its epoch ramps."""

    step_method: str
    keys: tuple
    iters: int
    mc_samples: int = 2
    proto_phase: bool = False
    spread_boundary: bool = False
    epoch_ramp: bool = False
    spread: bool = True


_BANK_KEYS = ("loss_all", "loss_seg", "loss_adv", "loss_bu", "loss_cup", "loss_disc",
              "loss_D", "loss_D2")
FAMILY = {
    "prototype_full": Family("prototype_full", ("loss_all", "loss_seg", "loss_intra",
                                                "loss_adv", "loss_D", "loss_D2"),
                             150, mc_samples=4, proto_phase=True),
    "prototype": Family("prototype", _BANK_KEYS, 100, proto_phase=True, spread_boundary=True,
                        epoch_ramp=True),
    "prototype_wotn": Family("prototype", _BANK_KEYS, 100, proto_phase=True,
                             spread_boundary=True, epoch_ramp=True),
    "bcdm": Family("bcdm", ("loss_seg", "loss_cdd_before", "loss_cdd_after", "loss_all"), 60,
                   spread=False),
    "mean_teacher": Family("mean_teacher", ("loss_all", "loss_seg", "loss_consistency",
                                            "loss_adv", "loss_D", "loss_D2"), 100),
    "posal": Family("posal", ("loss_all", "loss_seg", "loss_adv", "loss_D"), 100),
}
METHODS = tuple(FAMILY)


def config(method: str, dtype: str = "float32") -> Config:
    """The port's config of ``method`` (a key of :data:`FAMILY`)."""
    fam = FAMILY[method]
    cfg = Config()
    cfg.model.compute_dtype = dtype
    cfg.method.method = fam.step_method
    cfg.method.mc_samples = fam.mc_samples
    cfg.method.mc_fast = True
    if method == "prototype_wotn":
        cfg.method.use_weight_rectify = True
        cfg.method.pseudo_from_initial = True
    if method == "mean_teacher":
        cfg.method.teacher_noise = 0.0
    return cfg


def seeded_bank() -> dict:
    """The disk bank both frameworks start from: seeded unit normals x0.1."""
    rng = np.random.default_rng(11)
    return {k: rng.standard_normal(n).astype(np.float32) * 0.1 for k, n in BANK_SIZES.items()}


def build_state(method: str, cfg: Config, device, seed: int = 0, state_dicts: dict | None = None,
                perturb: float = 0.0):
    """The train state of ``method``: from ``seed`` with the logit spread
    (and the seeded bank), or from ``state_dicts`` (the keyword arguments of
    ``create_train_state``) as given; then, with ``perturb``, the stem conv
    of the generator times (1 + perturb). ``posal``'s state holds both
    discriminators, as the JAX state does."""
    fam = FAMILY[method]
    kwargs = dict(state_dicts or {})
    if state_dicts is None and fam.step_method == "prototype":
        kwargs["proto_bank"] = seeded_bank()
    holds = "adversarial" if method == "posal" else fam.step_method
    state = create_train_state(cfg, seed=seed, device=device, method=holds, **kwargs)
    keys = MASK_OUT + (BOUNDARY_OUT if fam.spread_boundary else ())
    with torch.no_grad():
        if state_dicts is None and fam.spread:
            for model in (state.gen, state.teacher, state.initial):
                if model is not None:
                    params = model.state_dict()
                    for k in keys:
                        params[k].mul_(SPREAD)
        if perturb:
            state.gen.state_dict()[CHAOS_KEY].mul_(1.0 + perturb)
    return state


def train_streams(size: int, batch: int, n_data: int = N_DATA, workers: int = 1,
                  wire: str = "f32"):
    """A fresh source loader and the endless target stream."""
    ds_s = SyntheticFundus(n_data, size + 28, seed=1, transform=train_transforms(size, wire))
    ds_t = SyntheticFundus(n_data, size + 28, seed=2, transform=train_transforms(size, wire))
    loader_s = BatchLoader(ds_s, batch, shuffle=True, seed=0, num_workers=workers)
    it_t = BatchLoader(ds_t, batch, shuffle=False, seed=1, num_workers=workers).forever()
    return loader_s, it_t


def stream(iters: int, size: int, batch: int, n_data: int = N_DATA, workers: int = 1,
           wire: str = "f32") -> list:
    """The first ``iters`` (loader epoch, source batch, target batch) of the
    streams, as numpy batches."""
    return take(*train_streams(size, batch, n_data, workers, wire), iters)


# main's streams by (size, batch, n_data, wire): a later call takes a prefix
# of an earlier, longer one instead of augmenting the samples again
STREAMS: dict = {}


def cached_stream(iters: int, size: int, batch: int, n_data: int = N_DATA, workers: int = 1,
                  wire: str = "f32") -> list:
    """:func:`stream`, kept in :data:`STREAMS` for the next call."""
    key = (size, batch, n_data, wire)
    if len(STREAMS.get(key, ())) < iters:
        STREAMS[key] = stream(iters, size, batch, n_data, workers, wire)
    return STREAMS[key][:iters]


def take(loader_s, it_t, iters: int) -> list:
    """The first ``iters`` (loader epoch, source batch, target batch) of a
    source loader's epochs, each beside the target stream's next batch."""
    out, epoch = [], 0
    while len(out) < iters:
        for batch_s in loader_s.epoch(epoch):
            out.append((epoch, batch_s, next(it_t)))
            if len(out) == iters:
                break
        epoch += 1
    return out


def val_set(size: int, wire: str = "f32") -> SyntheticFundus:
    return SyntheticFundus(N_VAL, size + 28, seed=3, transform=eval_transforms(size, wire))


def val_dice(gen, size: int, device, dtype: torch.dtype = torch.float32,
             wire: str = "f32") -> list:
    """Mean (cup, disc) Dice of ``gen``'s eval forward over the validation
    set, in batches of 4 (the JAX tools' ``jax_val_dice``)."""
    step = make_eval_step(gen, dtype)
    dice = []
    for batch in BatchLoader(val_set(size, wire), 4, shuffle=False, drop_last=False,
                             num_workers=1).epoch(0):
        logits, _, _ = step(torch.from_numpy(batch["image"]).to(device),
                            torch.from_numpy(batch["map"]).to(device))
        dice.append(dice_coeff_2label(logits.cpu().numpy(), batch["map"]))
    return [float(v) for v in np.mean(np.array(dice), axis=0)]


def launches() -> dict:
    return {"k1": mask_head.LAUNCHES, "k3_fwd": dropout_ops.LAUNCHES_FWD,
            "k3_bwd": dropout_ops.LAUNCHES_BWD}


def run(method: str, cfg: Config, batches: list, device, size: int, state_dicts=None,
        perturb: float = 0.0, each=None, wire: str = "f32") -> dict:
    """Train ``method`` over ``batches`` (:func:`stream`) on ``device``.
    ``each(i, state)`` is called after iteration i. Returns {'rows': per
    iteration {'iter', 'epoch', key: value}, 'dice', 'launches', 'seconds',
    'state'}; raises on a non-finite loss, if the generator drew with
    dropout off, or if ``posal`` moved the entropy discriminator."""
    fam = FAMILY[method]
    device = torch.device(device)
    state = build_state(method, cfg, device, state_dicts=state_dicts, perturb=perturb)
    step = make_train_step(cfg, fam.step_method, proto_phase=fam.proto_phase)
    frozen = ({k: v.clone() for k, v in state.dis2.state_dict().items()}
              if method == "posal" else None)
    drawn = state.generator.get_state().clone()
    before, t0, rows = launches(), time.perf_counter(), []
    for i, (epoch, batch_s, batch_t) in enumerate(batches):
        batch = device_batch(batch_s, batch_t, device)
        if method == "mean_teacher":
            batch["consistency_weight"] = CONSISTENCY
        state, m = step(state, batch, LR_GEN, LR_DIS, epoch if fam.epoch_ramp else FIXED_EPOCH)
        row = {"iter": i, "epoch": epoch}
        for k in fam.keys:
            row[k] = float(m[k])
            if not math.isfinite(row[k]):
                raise FloatingPointError(f"{method} on {device}: {k} = {row[k]} at iteration {i}")
        rows.append(row)
        if each is not None:
            each(i, state)
    if device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counted = {k: v - before[k] for k, v in launches().items()}
    if layers_lib.dropout_impl() == "off" and not torch.equal(drawn,
                                                              state.generator.get_state()):
        raise AssertionError(f"{method}: the state's generator drew with dropout off")
    if frozen is not None:
        moved = [k for k, v in state.dis2.state_dict().items() if not torch.equal(v, frozen[k])]
        if moved or state.dis2_opt.state:
            raise AssertionError(f"posal moved the entropy discriminator: {moved}")
    return {"rows": rows, "dice": val_dice(state.gen, size, device, cfg.model.dtype, wire),
            "launches": counted, "seconds": seconds, "state": state}


def smooth(x: np.ndarray, w: int = WINDOW) -> np.ndarray:
    return np.convolve(x, np.ones(w) / w, mode="valid") if len(x) >= w else x


def gap(a, b) -> dict:
    """The smoothed relative gap of series ``a`` to the reference ``b``:
    {'mean', 'max'} of |smooth(a) - smooth(b)| / max(|smooth(b)|, 1e-3)."""
    sa, sb = smooth(np.asarray(a, dtype=np.float64)), smooth(np.asarray(b, dtype=np.float64))
    rel = np.abs(sa - sb) / np.maximum(np.abs(sb), FLOOR)
    return {"mean": float(np.mean(rel)), "max": float(np.max(rel))}


def early_gap(a, b, n: int = EARLY) -> list:
    """The unsmoothed relative gap of ``a`` to ``b`` at each of the first
    ``n`` iterations."""
    a, b = np.asarray(a[:n], dtype=np.float64), np.asarray(b[:n], dtype=np.float64)
    return [float(v) for v in np.abs(a - b) / np.maximum(np.abs(b), FLOOR)]


def series(rows: list, key: str) -> list:
    return [r[key] for r in rows]


def compare(rows: list, ref_rows: list, keys) -> dict:
    """Per key: the smoothed gap of ``rows`` to ``ref_rows`` and the early gap."""
    return {k: {**gap(series(rows, k), series(ref_rows, k)),
                "early": early_gap(series(rows, k), series(ref_rows, k))} for k in keys}


def windows(rows: list, key: str = "loss_all") -> list:
    """The mean of ``key`` over the first and over the last window."""
    s = series(rows, key)
    return [float(np.mean(s[:WINDOW])), float(np.mean(s[-WINDOW:]))]


def write_csv(path: str, runs: dict, keys) -> None:
    """``iter``, ``epoch`` and ``<run>_<key>`` per iteration."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    first = next(iter(runs.values()))
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["iter", "epoch"] + [f"{name}_{k}" for name in runs for k in keys])
        for i, r in enumerate(first):
            w.writerow([r["iter"], r["epoch"]] + [runs[name][i][k] for name in runs for k in keys])


@contextlib.contextmanager
def settings(dropout: str):
    """The dropout backend and TF32 off for the block, restored after."""
    prev = (layers_lib.dropout_impl(), torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    layers_lib.set_dropout_impl(dropout)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        layers_lib.set_dropout_impl(prev[0])
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev[1:]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--method", required=True, choices=METHODS)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument("--iters", type=int, default=None, help="default: the method's")
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--batch", type=int, default=2, help="images per domain")
    ap.add_argument("--mc-samples", type=int, default=None, help="T; default: the method's")
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    ap.add_argument("--dropout", default="off", choices=("off", "xla16"))
    ap.add_argument("--wire", default="f32", choices=("f32", "u8"))
    ap.add_argument("--workers", type=int, default=1, help="loader threads")
    ap.add_argument("--compare-cpu", action="store_true",
                    help="also train on the CPU from the same start and batches")
    ap.add_argument("--chaos", action="store_true",
                    help=f"also train with the stem conv x (1 + {CHAOS})")
    ap.add_argument("--twin-dtype", default=None, choices=("float32", "bfloat16"),
                    help="also train in this compute dtype on the device")
    ap.add_argument("--out", default=None, help="the per-iteration CSV")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.compare_cpu and device.type != "cuda":
        raise ValueError("--compare-cpu holds a card's run to the CPU's: pass --device cuda")
    fam = FAMILY[args.method]
    iters = args.iters or fam.iters
    cfg = config(args.method, args.dtype)
    cfg.method.mc_samples = args.mc_samples or fam.mc_samples

    t0 = time.perf_counter()
    batches = cached_stream(iters, args.size, args.batch, workers=args.workers, wire=args.wire)
    load_s = time.perf_counter() - t0
    plan = [("port", device, 0.0, cfg)]
    if args.compare_cpu:
        plan.append(("cpu", torch.device("cpu"), 0.0, cfg))
    if args.chaos:
        plan.append(("chaos", device, CHAOS, cfg))
    if args.twin_dtype:
        twin = config(args.method, args.twin_dtype)
        twin.method.mc_samples = cfg.method.mc_samples
        plan.append((args.twin_dtype, device, 0.0, twin))
    runs = {}
    with settings(args.dropout):
        for name, dev, perturb, run_cfg in plan:
            r = runs[name] = run(args.method, run_cfg, batches, dev, args.size,
                                 perturb=perturb, wire=args.wire)
            r.pop("state")
            print(f"# {args.method} {name} on {dev}: loss_all {r['rows'][0]['loss_all']:.4f} -> "
                  f"{r['rows'][-1]['loss_all']:.4f}, val Dice (cup, disc) {r['dice']}, "
                  f"{r['seconds']:.1f} s, launches {r['launches']}", file=sys.stderr, flush=True)
    rows = {name: r["rows"] for name, r in runs.items()}
    if args.out:
        write_csv(args.out, rows, fam.keys)
    result = {
        "longrun": args.method,
        "device": str(device),
        "iters": iters, "size": args.size, "batch": args.batch,
        "mc_samples": cfg.method.mc_samples, "dtype": args.dtype,
        "dropout": args.dropout, "wire": args.wire, "load_s": load_s,
        "runs": {name: {"dice": r["dice"], "launches": r["launches"], "seconds": r["seconds"],
                        "loss_all_windows": windows(r["rows"]),
                        "first": {k: r["rows"][0][k] for k in fam.keys},
                        "last": {k: r["rows"][-1][k] for k in fam.keys}}
                 for name, r in runs.items()},
        "gaps": {name: compare(rows[name], rows["port"], fam.keys)
                 for name in rows if name != "port"},
        "dice_gap": {name: [abs(a - b) for a, b in zip(runs[name]["dice"], runs["port"]["dice"])]
                     for name in runs if name != "port"},
        "csv": args.out,
        **card_fields(device),
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
