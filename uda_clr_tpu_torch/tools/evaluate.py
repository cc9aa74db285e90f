"""Standalone evaluation (own copy of uda_clr_tpu/tools/evaluate.py).

Runs a checkpoint over a dataset split and reports the reference metric
suite (cup/disc Dice, PA, IoU at threshold 0.75 — utils/metrics.py
semantics), optionally applying the morphological ``postprocessing``
(Utils.py:438-474) and saving contour overlays (save_per_img,
Utils.py:515-585) like the reference's offline analysis flow. The eval
forward runs on the device; metrics, postprocessing and images on the host.

Usage:
  python -m uda_clr_tpu_torch.tools.evaluate --checkpoint runs/x/checkpoints/checkpoint_7.pth.tar \\
      --data-dir /data/Fundus --dataset Drishti-GS --split test \\
      [--postprocess] [--save-viz out/] [--device cpu]
``--checkpoint`` reads the port's ``.pth.tar`` and the reference's
``.pth``/``.pth.tar`` (an orbax directory: convert it first with
``convert_orbax_checkpoint.py``). ``--device`` defaults to ``cuda``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from uda_clr_tpu_torch.data.wire import decode_array, decode_batch
from uda_clr_tpu_torch.models.deeplab import DeepLab
from uda_clr_tpu_torch.utils.metrics import dice_coeff_2label, dice_coefficient_numpy, pixel_acc
from uda_clr_tpu_torch.utils.postprocess import postprocessing
from uda_clr_tpu_torch.utils.visualize import save_per_img, untransform

METRICS = ("cup_dice", "disc_dice", "cup_pa", "disc_pa", "cup_iou", "disc_iou")


@torch.no_grad()
def evaluate(gen: DeepLab, loader, dataset_name: str = "Drishti-GS",
             postprocess: bool = False, save_viz: str | None = None) -> dict:
    """Mean over ``loader``'s batches of the metric suite of ``gen``'s eval
    forward (on the device of its parameters; float32 or uint8 wire
    batches)."""
    device = next(gen.parameters()).device
    gen.eval()
    totals = {k: 0.0 for k in METRICS}
    n = 0
    for batch in loader.epoch(0):
        image = decode_batch({"image": torch.as_tensor(batch["image"]).to(device)})["image"]
        logits = gen(image.float(), train=False).mask_logits.float().cpu().numpy()
        map_t = decode_array("map", batch["map"])
        if postprocess:
            cup_d = disc_d = 0.0
            for i in range(logits.shape[0]):
                probs = 1.0 / (1.0 + np.exp(-logits[i]))
                cleaned = postprocessing(probs, dataset=dataset_name)
                cup_d += dice_coefficient_numpy(cleaned[..., 0], map_t[i][..., 0])
                disc_d += dice_coefficient_numpy(cleaned[..., 1], map_t[i][..., 1])
            cup_d /= logits.shape[0]
            disc_d /= logits.shape[0]
        else:
            cup_d, disc_d = dice_coeff_2label(logits, map_t)
        pa_cup, pa_disc, iou_cup, iou_disc = pixel_acc(logits, map_t)
        for k, v in zip(METRICS, (cup_d, disc_d, pa_cup, pa_disc, iou_cup, iou_disc)):
            totals[k] += v
        if save_viz:
            images = decode_array("image", batch["image"])
            for i, name in enumerate(batch["img_name"]):
                probs = 1.0 / (1.0 + np.exp(-logits[i]))
                img, _ = untransform(images[i], map_t[i])
                save_per_img(img.astype(np.uint8), save_viz, name, probs)
        n += 1
    return {k: v / max(n, 1) for k, v in totals.items()}


def load_model(checkpoint: str | None, use_tn: bool, device: torch.device) -> DeepLab:
    """The mobilenet generator (seed 0 without a checkpoint) on ``device``,
    in eval mode."""
    from uda_clr_tpu_torch.tools.cal_prototype import load_generator

    gen = DeepLab(num_classes=2, backbone="mobilenet", seed=0, norm="tn" if use_tn else "bn")
    if checkpoint:
        load_generator(checkpoint, gen)
    gen.to(device).eval()
    if device.type == "cuda":
        gen.to(memory_format=torch.channels_last)
    return gen


def main(argv=None) -> dict:
    from uda_clr_tpu_torch import resolve_device
    from uda_clr_tpu_torch.data.fundus import FundusSegmentation
    from uda_clr_tpu_torch.data.pipeline import BatchLoader
    from uda_clr_tpu_torch.data.synthetic import SyntheticFundus
    from uda_clr_tpu_torch.data.transforms import eval_transforms

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint", default=None,
                   help=".pth/.pth.tar checkpoint (port or reference)")
    p.add_argument("--data-dir", default="")
    p.add_argument("--dataset", default="Drishti-GS")
    p.add_argument("--split", default="test")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--image-size", type=int, default=512)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--use_TN", action="store_true")
    p.add_argument("--postprocess", action="store_true")
    p.add_argument("--save-viz", default=None)
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)

    gen = load_model(args.checkpoint, args.use_TN, resolve_device(args.device))
    if args.synthetic:
        ds = SyntheticFundus(8, args.image_size + 28, transform=eval_transforms(args.image_size))
    else:
        ds = FundusSegmentation(args.data_dir, args.dataset, args.split,
                                eval_transforms(args.image_size))
    loader = BatchLoader(ds, args.batch_size, shuffle=False, drop_last=False, num_workers=2)
    metrics = evaluate(gen, loader, args.dataset, args.postprocess, args.save_viz)
    print(json.dumps(metrics, indent=2))
    return metrics


if __name__ == "__main__":
    main()
