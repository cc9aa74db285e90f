"""Sealed serving artifact of the segmenter on ``torch.export`` (own copy of
uda_clr_tpu/tools/export.py, whose artifact holds StableHLO).

The eval forward is exported ONCE with the trained weights inside, saved
into a single file, and can be re-loaded and run on a serving host with
``torch.export.load`` alone: without the model code, the config system or
the checkpoint stack of this package.

Properties of the artifact:

* **Batch-polymorphic.** The batch dimension is symbolic
  (``torch.export.Dim``), so one artifact serves any request batch size
  from 2 to ``MAX_BATCH`` (sizes 0 and 1 are specialised by the export).
* **One device.** The weights sit on the device the artifact was exported
  on (``--device``, default ``cuda``); the JAX tool's ``--platforms``.
* **Wire-format aware.** With ``wire='u8'`` the input is the raw ``uint8``
  ROI crop (NHWC, 0..255) and the ``Normalize_tf`` scaling
  (``u/127.5 - 1``) is part of the graph, through the port's bit-exact
  device decode (data/wire.py).
* **Self-describing outputs.** ``{"mask_probs": [b,S,S,2] (ch0=cup,
  ch1=disc), "boundary_probs": [b,S,S,1]}``, sigmoid probabilities in
  float32, the quantities every reference consumer thresholds (0.75 eval
  metrics; 0.5/0.1 postprocessing). Thresholding and morphology stay on the
  host.

The file is ``MAGIC | u32 meta length | meta JSON | payload``, the
payload ``torch.export.save``'d; the header gives a serving frontend the
input contract without reading the program.

Usage:
  python -m uda_clr_tpu_torch.tools.export --checkpoint runs/x/checkpoints/checkpoint_7.pth.tar \\
      --out model.uda.pt2 [--image-size 512] [--use_TN] [--wire u8] [--device cpu] [--selftest]

Loading on the serving host (no uda_clr_tpu_torch needed):
  import io, json, torch
  raw = open("model.uda.pt2", "rb").read(); n = int.from_bytes(raw[4:8], "little")
  model = torch.export.load(io.BytesIO(raw[8 + n:])).module()
  outs = model(images)
"""

from __future__ import annotations

import argparse
import io
import json

import numpy as np
import torch

MAGIC = b"UDA1"  # artifact header: magic + u32 meta length + meta JSON + payload
MAX_BATCH = 256


class ServingModel(torch.nn.Module):
    """Eval forward of ``gen``: image -> sigmoid probability dict.

    ``wire='u8'``: input is raw uint8 pixels (0..255), decoded in the graph
    (data/wire.py). ``wire='f32'``: input is the normalized float32 image
    in [-1, 1]."""

    def __init__(self, gen, wire: str = "f32"):
        super().__init__()
        if wire not in ("f32", "u8"):
            raise ValueError(f"wire must be 'f32' or 'u8', got {wire!r}")
        self.gen = gen.eval()
        self.wire = wire

    def forward(self, image: torch.Tensor) -> dict:
        from uda_clr_tpu_torch.data import wire as wire_lib

        if self.wire == "u8":
            image = wire_lib.decode_batch({"image": image})["image"]
        out = self.gen(image, train=False)
        return {"mask_probs": torch.sigmoid(out.mask_logits.float()),
                "boundary_probs": torch.sigmoid(out.boundary_logits.float())}


def make_serving_fn(gen, wire: str = "f32") -> ServingModel:
    return ServingModel(gen, wire)


def export_serving(gen, image_size: int, wire: str = "f32"):
    """The serving function as a ``torch.export.ExportedProgram`` with a
    symbolic batch, on the device of ``gen``'s parameters."""
    device = next(gen.parameters()).device
    dtype = torch.uint8 if wire == "u8" else torch.float32
    example = torch.zeros((2, image_size, image_size, 3), dtype=dtype, device=device)
    batch = torch.export.Dim("b", min=2, max=MAX_BATCH)
    with torch.no_grad():
        return torch.export.export(ServingModel(gen, wire), (example,),
                                   dynamic_shapes={"image": {0: batch}})


def save_artifact(exported, path: str, meta: dict) -> int:
    """Write ``MAGIC | u32 meta-json length | meta json | saved program``;
    returns the bytes written."""
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    payload = buf.getvalue()
    blob = json.dumps(meta, sort_keys=True).encode("utf-8")
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(len(blob).to_bytes(4, "little"))
        f.write(blob)
        f.write(payload)
    return len(MAGIC) + 4 + len(blob) + len(payload)


def load_artifact(path: str):
    """Read an artifact file -> (meta dict, ``torch.export.ExportedProgram``)."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:4] != MAGIC:
        raise ValueError(f"{path}: not a UDA serving artifact (bad magic {raw[:4]!r})")
    n = int.from_bytes(raw[4:8], "little")
    meta = json.loads(raw[8 : 8 + n].decode("utf-8"))
    return meta, torch.export.load(io.BytesIO(raw[8 + n :]))


def selftest_input(wire: str, batch: int, image_size: int, seed: int = 0) -> np.ndarray:
    """The random request the self-test runs (the JAX tool's)."""
    rng = np.random.default_rng(seed)
    if wire == "u8":
        return rng.integers(0, 256, (batch, image_size, image_size, 3), dtype=np.uint8)
    return rng.uniform(-1, 1, (batch, image_size, image_size, 3)).astype(np.float32)


def max_abs_err(got: dict, want: dict) -> float:
    return max(float(torch.max(torch.abs(got[k] - want[k]))) for k in want)


def main(argv=None) -> dict:
    from uda_clr_tpu_torch import resolve_device
    from uda_clr_tpu_torch.tools.evaluate import load_model

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint", default=None,
                   help=".pth/.pth.tar checkpoint, port or reference "
                        "(default: fresh init, for pipeline smoke tests)")
    p.add_argument("--out", required=True)
    p.add_argument("--image-size", type=int, default=512)
    p.add_argument("--use_TN", action="store_true")
    p.add_argument("--wire", choices=("f32", "u8"), default="f32")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    p.add_argument("--selftest", action="store_true",
                   help="reload the artifact and check it against the live "
                        "model on a random batch before reporting success")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    norm = "tn" if args.use_TN else "bn"
    gen = load_model(args.checkpoint, args.use_TN, device)
    exported = export_serving(gen, args.image_size, wire=args.wire)
    meta = {
        "input": {"shape": ["b", args.image_size, args.image_size, 3],
                  "dtype": "uint8" if args.wire == "u8" else "float32",
                  "layout": "NHWC", "wire": args.wire},
        "outputs": {"mask_probs": "[b,S,S,2] sigmoid, ch0=cup ch1=disc",
                    "boundary_probs": "[b,S,S,1] sigmoid"},
        "norm": norm,
        "device": device.type,
        "checkpoint": args.checkpoint or "fresh-init",
    }
    nbytes = save_artifact(exported, args.out, meta)

    if args.selftest:
        _, loaded = load_artifact(args.out)
        x = torch.from_numpy(selftest_input(args.wire, 2, args.image_size)).to(device)
        with torch.no_grad():
            got = loaded.module()(x)
            want = make_serving_fn(gen, wire=args.wire)(x)
        err = max_abs_err(got, want)
        if err > 1e-6:
            raise SystemExit(f"selftest FAILED: max |artifact - live| = {err}")
        meta["selftest_max_abs_err"] = err

    result = {"out": args.out, "bytes": nbytes, **meta}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
