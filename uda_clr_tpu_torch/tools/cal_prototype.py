"""Offline prototype-bank initialization (uda_clr_tpu/tools/cal_prototype.py,
the reference's cal_prototype.py), for the disk-bank method.

Runs a (pre-trained) generator in eval mode over the target train split with
the eval transform and pools masked-average feature prototypes:
  * 'bu'   [304]: x_bu_feature under sigmoid(boundary_before) > 0.5
  * 'cup'  [305]: x_feature under sigmoid(mask_before)[..., 0] > 0.1
  * 'disc' [305]: x_feature under sigmoid(mask_before)[..., 1] > 0.5
each pooled per image with a +1-smoothed denominator.

Deliberate fix, as in the JAX package: the reference's running average
overwrites its accumulator with the current batch before accumulating
(cal_prototype.py:177-190), so its bank is the LAST image's prototype; this
tool saves the arithmetic mean over the dataset.

Saves an .npz with keys {'bu', 'cup', 'disc'}, read by
``MethodConfig.prototype_bank_path``.

Usage: python -m uda_clr_tpu_torch.tools.cal_prototype --checkpoint <file.pth.tar>
           --data-dir ... --datasetT Drishti-GS --out prototypes.npz [--use_TN]
       python -m uda_clr_tpu_torch.tools.cal_prototype --synthetic --out bank.npz
``--device`` defaults to ``cuda``; ``cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from uda_clr_tpu_torch import resolve_device
from uda_clr_tpu_torch.data.wire import decode_batch
from uda_clr_tpu_torch.models.deeplab import DeepLab


def _pool(feat: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-image +1-smoothed pooled prototypes, [B, C]."""
    return torch.sum(feat * mask, dim=(1, 2)) / (torch.sum(mask, dim=(1, 2)) + 1.0)


@torch.no_grad()
def compute_prototypes(gen: DeepLab, batches, dtype: torch.dtype = torch.float32) -> dict:
    """The bank {'bu', 'cup', 'disc'} (float32 numpy) of ``gen``'s eval
    forward over ``batches`` (dicts with an NHWC 'image', float32 or uint8
    wire), on the device of ``gen``'s parameters; the per-image pools are
    summed on the host as the JAX tool sums them."""
    device = next(gen.parameters()).device
    sums = {"bu": 0.0, "cup": 0.0, "disc": 0.0}
    n = 0
    for batch in batches:
        image = torch.as_tensor(batch["image"]).to(device)
        image = decode_batch({"image": image})["image"].to(dtype)
        out = gen(image, train=False)
        pred = torch.sigmoid(out.mask_before.float())
        bu = (torch.sigmoid(out.boundary_before.float()) > 0.5).float()
        cup = (pred[..., 0:1] > 0.1).float()
        disc = (pred[..., 1:2] > 0.5).float()
        xf, xbu = out.x_feature.float(), out.x_bu_feature.float()
        for key, pooled in (("bu", _pool(xbu, bu)), ("cup", _pool(xf, cup)),
                            ("disc", _pool(xf, disc))):
            sums[key] = sums[key] + np.sum(pooled.cpu().numpy(), axis=0)
        n += image.shape[0]
    return {k: (v / max(n, 1)).astype(np.float32) for k, v in sums.items()}


def load_generator(path: str, gen: DeepLab) -> None:
    """Load the generator of a ``.pth``/``.pth.tar`` checkpoint (the port's
    or the reference's ``model_state_dict``) into ``gen``; every tensor of
    ``gen`` must be in it (extra keys such as ``num_batches_tracked`` are
    ignored)."""
    from uda_clr_tpu_torch.train.checkpoint import ORBAX_NOTE, load_file

    if not path.endswith((".pth", ".pth.tar")):
        raise NotImplementedError(ORBAX_NOTE.format(what="--checkpoint"))
    ckpt = load_file(path)
    if "model_state_dict" not in ckpt:
        raise ValueError(f"{path} holds no model_state_dict")
    src = ckpt["model_state_dict"]
    want = gen.state_dict()
    missing = sorted(k for k in want if k not in src)
    if missing:
        raise ValueError(f"{path} lacks {len(missing)} tensors of the model, e.g. {missing[:3]} "
                         f"(a TransNorm checkpoint needs --use_TN, a BN one not)")
    gen.load_state_dict({k: src[k] for k in want})


def main(argv=None) -> dict:
    from uda_clr_tpu_torch.data.fundus import FundusSegmentation
    from uda_clr_tpu_torch.data.pipeline import BatchLoader
    from uda_clr_tpu_torch.data.synthetic import SyntheticFundus
    from uda_clr_tpu_torch.data.transforms import eval_transforms

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint", default=None, help=".pth/.pth.tar checkpoint (port or reference)")
    p.add_argument("--data-dir", default="")
    p.add_argument("--datasetT", default="Drishti-GS")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--image-size", type=int, default=512)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--out", default="prototypes.npz")
    p.add_argument("--use_TN", action="store_true")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    gen = DeepLab(num_classes=2, backbone="mobilenet", seed=0,
                  norm="tn" if args.use_TN else "bn")
    if args.checkpoint:
        load_generator(args.checkpoint, gen)
    gen.to(device)
    if device.type == "cuda":
        gen.to(memory_format=torch.channels_last)
    if args.synthetic:
        ds = SyntheticFundus(8, args.image_size + 28, transform=eval_transforms(args.image_size))
    else:
        ds = FundusSegmentation(args.data_dir, args.datasetT, "train",
                                eval_transforms(args.image_size))
    loader = BatchLoader(ds, args.batch_size, shuffle=False, drop_last=False, num_workers=2)
    bank = compute_prototypes(gen, loader.epoch(0))
    np.savez(args.out, **bank)
    print(f"saved prototype bank to {args.out}: "
          + ", ".join(f"{k}[{v.shape[0]}]" for k, v in bank.items()))
    return bank


if __name__ == "__main__":
    main()
