"""Serving throughput of the eval forward on one card (the counterpart of the
JAX package's ``tools/bench_eval.py``).

    python -m uda_clr_tpu_torch.bench_eval [--size 512] [--batches 8,32,64]
        [--norm bn] [--dtype bfloat16] [--windows 3] [--iters 10] [--device cuda]

The reference has no inference benchmark; its only eval surface is the
per-epoch ``validate()`` loop. For serving, what counts is the images per
second of the deterministic eval forward (the deployed artifact: mobilenet
backbone -> ASPP -> dual-head decoder -> sigmoid probabilities at
``--size``^2) at each batch size, and the host post-processing per image
(utils/postprocess.py: median filters, erosion, largest filled hole) that
a serving host pays after the card.

Each batch size gets a first call, 2 warm-up calls and ``--windows``
windows of ``--iters`` chained calls (utils/benchmarking.timed_windows);
one more call runs untimed under FlopCounterMode for ``mfu`` (its
convolutions only; utils/benchmarking.py). A batch that runs out of device
memory gives a row with ``error``; any other error raises. ``--device cpu``
runs on the CPU, for tests; without a card and without it, it raises.

Prints one JSON line: a row per batch size (median ms, img/s/card, ``mfu``,
``step_tflops``, ``first_call_s``), the host post-processing ms per image,
the card's name (``device_kind``) and its power limit (``power_limit_w``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from uda_clr_tpu_torch.utils.benchmarking import count_flops, mfu, oom_message, timed_windows
from uda_clr_tpu_torch.utils.devinfo import card_fields

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@torch.no_grad()
def serve(gen, image: torch.Tensor, token: torch.Tensor, dtype: torch.dtype):
    """The deployed forward: eval-mode DeepLab -> cup/disc sigmoid
    probabilities in float32, and their mean. ``token`` (the previous
    call's mean) is folded into the input, so consecutive calls chain on the
    card and one fetch at the end of a window forces the whole window
    (``0.0 * token`` is not folded away: floats admit NaN and Inf)."""
    outs = gen((image + 0.0 * token).to(dtype), train=False)
    probs = torch.sigmoid(outs.mask_logits.float())
    return probs, probs.mean()


def main(argv=None) -> dict:
    from uda_clr_tpu_torch import resolve_device
    from uda_clr_tpu_torch.tools.evaluate import load_model
    from uda_clr_tpu_torch.utils.postprocess import postprocessing

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--batches", default="8,32,64")
    ap.add_argument("--norm", default="bn", choices=("bn", "tn"))
    ap.add_argument("--dtype", default="bfloat16", choices=tuple(DTYPES))
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    dtype, size = DTYPES[args.dtype], args.size
    card = card_fields(device)
    kind = card["device_kind"]
    gen = load_model(None, args.norm == "tn", device)

    rng = np.random.default_rng(0)
    rows = []
    probs_np = None
    for batch in [int(b) for b in args.batches.split(",")]:
        image = probs = None
        try:
            image = torch.from_numpy(
                rng.standard_normal((batch, size, size, 3)).astype(np.float32)).to(device)

            def serve_once(carry):
                _, token = carry
                probs, chk = serve(gen, image, token, dtype)
                return (probs, chk), chk

            token0 = torch.zeros((), device=device)
            (probs, _), stats = timed_windows(serve_once, (None, token0),
                                              windows=args.windows, iters=args.iters)
            med = stats["median_ms"]
            if probs_np is None:
                probs_np = probs[0].cpu().numpy()
            _, flops = count_flops(lambda: serve(gen, image, token0, dtype))
        except torch.cuda.OutOfMemoryError as e:
            image = probs = None
            torch.cuda.empty_cache()
            msg = oom_message(e)
            rows.append({"batch": batch, "error": msg})
            print(f"# B{batch}: FAILED: {msg}", file=sys.stderr, flush=True)
            continue
        row_mfu, tflops = mfu(flops, med, kind)
        row = {"batch": batch, "step_ms": round(med, 2),
               "img_per_sec_card": round(batch / (med / 1e3), 2),
               "mfu": round(row_mfu, 4) if row_mfu is not None else None,
               "step_tflops": round(tflops, 6),
               "first_call_s": round(stats["first_call_s"], 2)}
        print(f"# B{batch}: {med:.2f} ms, {row['img_per_sec_card']} img/s, mfu {row['mfu']}",
              file=sys.stderr, flush=True)
        rows.append(row)

    # the host post-processing per image, which serving pays after the card
    post_ms = None
    if probs_np is not None:
        n = 3
        t0 = time.perf_counter()
        for _ in range(n):
            postprocessing(probs_np, threshold=0.75, dataset="G")
        post_ms = (time.perf_counter() - t0) / n * 1000.0
        print(f"# host postprocessing: {post_ms:.1f} ms/image", file=sys.stderr, flush=True)

    result = {
        "metric": f"eval/serving forward throughput ({size}x{size}, {args.dtype}, {args.norm})",
        "rows": rows,
        "host_postprocess_ms_per_image": round(post_ms, 1) if post_ms is not None else None,
        **card,
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
