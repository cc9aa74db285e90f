"""Convert an orbax checkpoint written by the JAX package's Trainer into the
PyTorch port's ``.pth.tar``.

The port reads ``.pth``/``.pth.tar`` files only (it needs no JAX or
orbax). This script, which imports both packages, restores the checkpoint
directory with ``uda_clr_tpu/train/checkpoint.py:restore_checkpoint``
against a state built from the run's ``config.yaml``, converts every
module through ``uda_clr_tpu_torch/convert/from_jax.py:train_state_dicts``
and writes the port's checkpoint (the reference's keys; fresh optimizer
states) with the epoch, iteration and best Dice of the orbax sidecar. The
result serves as the port Trainer's ``initial_resume`` or ``resume``, and
as ``--checkpoint`` of the port's tools. It runs on the CPU.

Usage:
  python convert_orbax_checkpoint.py RUN/checkpoints/checkpoint_7 OUT/checkpoint_7.pth.tar \\
      [--config RUN/config.yaml]
"""

from __future__ import annotations

import argparse
import os


def convert(ckpt_path: str, out: str, config: str | None = None) -> str:
    """Convert the orbax checkpoint directory ``ckpt_path`` (``.../TAG``)
    to ``out`` (a ``.pth.tar``); returns ``out``."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from uda_clr_tpu.config import Config as JaxConfig
    from uda_clr_tpu.models.deeplab import DeepLab
    from uda_clr_tpu.train import checkpoint as jax_ckpt
    from uda_clr_tpu.train.state import create_train_state as jax_train_state
    from uda_clr_tpu_torch.config import Config
    from uda_clr_tpu_torch.convert.from_jax import train_state_dicts
    from uda_clr_tpu_torch.train import checkpoint as ckpt_lib
    from uda_clr_tpu_torch.train.state import create_train_state

    if not out.endswith(".pth.tar"):
        raise ValueError(f"{out}: the output is a .pth.tar file")
    ckpt_dir, tag = os.path.split(os.path.abspath(ckpt_path.rstrip("/")))
    config = config or os.path.join(os.path.dirname(ckpt_dir), "config.yaml")
    with open(config) as f:
        text = f.read()
    jcfg, cfg = JaxConfig.from_yaml(text), Config.from_yaml(text)
    method, size = jcfg.method.method, jcfg.data.image_size
    model = DeepLab(num_classes=jcfg.model.num_classes, backbone=jcfg.model.backbone,
                    output_stride=jcfg.model.output_stride, norm=jcfg.model.norm,
                    remat=jcfg.model.remat)
    # the restore needs only the state's shapes and dtypes
    template = jax.eval_shape(lambda: jax_train_state(
        model, jax.random.PRNGKey(jcfg.run.seed), (jcfg.data.batch_size, size, size, 3),
        jcfg.optim, with_teacher=method == "mean_teacher",
        with_proto_bank=method == "prototype", with_cls2=method == "bcdm"))
    restored, meta = jax_ckpt.restore_checkpoint(ckpt_dir, tag, template)
    state = create_train_state(cfg, seed=cfg.run.seed, device="cpu", method=method,
                               **train_state_dicts(jax.device_get(restored),
                                                   cfg.model.output_stride))
    out_dir, out_name = os.path.split(os.path.abspath(out))
    path = ckpt_lib.save_checkpoint(
        out_dir, state, int(meta.get("epoch", 0)), float(meta.get("best_mean_dice", 0.0)),
        out_name.removesuffix(".pth.tar"), iteration=int(meta.get("iteration", 0)))
    print(f"converted {ckpt_path} ({method}, {jcfg.model.backbone}, norm {jcfg.model.norm}) "
          f"-> {path}")
    return path


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("checkpoint", help="orbax checkpoint directory, RUN/checkpoints/TAG")
    p.add_argument("out", help="the port's checkpoint to write, ending in .pth.tar")
    p.add_argument("--config", default=None,
                   help="the run's config.yaml (default: beside the checkpoints directory)")
    args = p.parse_args(argv)
    return convert(args.checkpoint, args.out, args.config)


if __name__ == "__main__":
    main()
