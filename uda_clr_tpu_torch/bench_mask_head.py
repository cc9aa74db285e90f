"""Time the mask-head kernels (K1, K2) alone on the card, beside another
build of the same C entries when one is given, in turns in one process.

    python -m uda_clr_tpu_torch.bench_mask_head [--against OTHER.cu ...] [--rows 1048576]
        [--sass DIR] [--json PATH]

For bf16 and f32 at ``--rows`` rows (chip_smoke.py's inputs: normal x_up,
relu'd ll, normal boundary, their batch moments), rate 0.1: each build of
K1 and K2 is held to the plain version (tolerances as chip_smoke.py; a
comparison build that disagrees is reported and still timed), then
timed with the coefficients computed once (CUDA events, median of windows
of back-to-back launches) in the order others, this, this, others reversed, so all
see the same card, clocks and neighbours; then again at rate 0, whose
instance skips the draw; and reads the SM clock and power draw while this
checkout's build runs. Each ``--against`` names a
``mask_head.cu`` with the same ``extern "C"`` entries (an earlier version,
say), built like this checkout's and named after its directory. ``--sass DIR`` writes ``cuobjdump -sass``
of this checkout's build to DIR and prints its instruction counts per
kernel instance. Prints the card's name and power limit and, as its last
line, one JSON object. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import shutil
import statistics
import subprocess
from pathlib import Path

import torch

from uda_clr_tpu_torch.ops import cuda_build
from uda_clr_tpu_torch.ops import mask_head as mh

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
WINDOWS, PER_WINDOW = 5, 20


def cuda_ms(fn, windows: int = WINDOWS, per_window: int = PER_WINDOW) -> float:
    """Median over ``windows`` of the mean time of ``per_window``
    back-to-back calls, each window timed with CUDA events."""
    fn()  # warm
    times = []
    for _ in range(windows):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_window):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_window)
    return statistics.median(times)


def card_line() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60)
    return proc.stdout.strip().splitlines()[0] if proc.returncode == 0 else "nvidia-smi failed"


def clocks_under_load(fn, ms_per_call: float) -> str:
    """nvidia-smi's SM clock (MHz) and power draw (W), read while ~0.5 s
    of back-to-back calls of ``fn`` are queued on the card."""
    for _ in range(max(1, min(1000, int(500 / ms_per_call)))):
        fn()
    proc = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                           "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    torch.cuda.synchronize()
    return proc.stdout.strip()


def inputs(m: int, dtype, g):
    rand = lambda *s: torch.randn(*s, device="cuda", generator=g)
    x_up = rand(m, 256).to(dtype)
    ll = torch.relu(rand(m, 48)).to(dtype)
    bnd = rand(m, 1).to(dtype)
    var, mean = torch.var_mean(torch.cat([x_up, ll, bnd], dim=1).float(), dim=0, correction=0)
    scale, bias = 1.0 + 0.2 * rand(305), 0.1 * rand(305)
    wt, wb = 0.05 * rand(2, 305, 1, 1), 0.1 * rand(2)
    return (x_up, ll, bnd), (mean, var, scale, bias, wt, wb)


def tolerance(want, dtype) -> float:
    peak = float(want.abs().max())
    return 1e-5 * max(1.0, peak) if dtype == torch.float32 else peak * 2.0**-7


def sass_counts(so: Path, out_dir: Path) -> dict:
    """cuobjdump -sass of ``so`` into ``out_dir``; instruction counts per
    kernel instance, in total and by opcode."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{so.stem}.sass").write_text(text)
    counts, fn = {}, None
    for line in text.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            fn = head.group(1)
            counts[fn] = collections.Counter()
            continue
        ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if fn and ins:
            counts[fn][ins.group(1).split(".")[0]] += 1
    return {fn: dict(total=sum(c.values()), top=dict(c.most_common(14)))
            for fn, c in counts.items() if "mask_head_kernel" in fn}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", type=Path, action="append", default=[],
                    help="another mask_head.cu with the same C entries (repeatable)")
    ap.add_argument("--rows", type=int, default=64 * 128 * 128)
    ap.add_argument("--sass", type=Path, help="directory for this build's SASS")
    ap.add_argument("--json", type=Path, help="also write the result object here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_mask_head: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False

    builds = {"this": mh.LIBRARY}
    for src in args.against:
        builds[src.resolve().parent.name] = cuda_build.KernelLibrary(src.resolve(), mh.SIGNATURES)
    others = [b for b in builds if b != "this"]
    cuda_build.build_all(list(builds.values()))
    card = card_line()
    print(f"card: {card}; {torch.cuda.get_device_name(0)}, torch {torch.__version__}", flush=True)
    for name, lib in builds.items():
        for line in lib.log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas {name}: {line.strip()}")

    m, rate, seed = args.rows, 0.1, 0x1234_5678_9ABC_DEF0
    g = torch.Generator("cuda").manual_seed(0)
    result = {"card": card, "rows": m, "rate": rate, "kernels": []}
    order = others + ["this", "this"] + others[::-1]
    for dtype in (torch.bfloat16, torch.float32):
        views, coef_args = inputs(m, dtype, g)
        coef = mh.coefficients(*coef_args, dtype)
        x_bu = torch.cat(views[:2], dim=1)
        want = mh.mask_head_plain(*views, *coef_args, seed=seed, rate=rate).float()
        tol = tolerance(want, dtype)
        size = views[0].element_size()
        bound_ms = (m * 305 + m * 2) * size / HBM_BYTES_PER_S * 1e3
        dname = str(dtype).split(".")[-1]
        for kname, tensors in (("K1", views), ("K2", (x_bu, views[2]))):
            errs = {}
            for bname, lib in builds.items():
                got = mh.launch(tensors, coef, seed, rate, library=lib)
                errs[bname] = float((got.float() - want).abs().max())
                if not errs[bname] <= tol:  # a comparison build may be a timing-only cut
                    msg = (f"{kname} {dname} ({bname} build) disagrees with the plain version: "
                           f"{errs[bname]:.3e} > {tol:.3e}")
                    if bname == "this":
                        raise SystemExit(msg)
                    print(msg, flush=True)
            times = collections.defaultdict(list)
            for bname in order:
                lib = builds[bname]
                times[bname].append(cuda_ms(lambda: mh.launch(tensors, coef, seed, rate, library=lib)))
            # rate 0 runs the instance without the draw phase
            times0 = collections.defaultdict(list)
            for bname in order:
                lib = builds[bname]
                times0[bname].append(cuda_ms(lambda: mh.launch(tensors, coef, seed, 0.0, library=lib)))
            smem, per_sm = mh.occupancy(kname == "K1", rate, dtype, "cuda")
            load = clocks_under_load(lambda: mh.launch(tensors, coef, seed, rate),
                                     statistics.mean(times["this"]))
            row = dict(name=kname, dtype=dname, bound_ms=bound_ms, tolerance=tol,
                       max_abs_err=errs, ms=dict(times), ms_rate0=dict(times0),
                       smem_bytes=smem, blocks_per_sm=per_sm, clocks_under_load=load)
            row["share_of_bound"] = bound_ms / statistics.mean(times["this"])
            row["gb_per_s"] = (m * 307 * size) / (statistics.mean(times["this"]) * 1e-3) / 1e9
            print(f"{kname} {dname}: this {times['this']} ms"
                  + "".join(f", {b} {times[b]} ms" for b in others)
                  + f"; at rate 0: {dict(times0)} ms; byte bound {bound_ms:.4f} ms, share {row['share_of_bound']:.3f}, "
                  f"{row['gb_per_s']:.1f} GB/s; max_abs_err {errs} (tolerance {tol:.3e}); "
                  f"{smem} B shared memory per block, {per_sm} blocks per SM; SM clock, power "
                  f"under load: {load}", flush=True)
            result["kernels"].append(row)
        del views, x_bu, want, coef
        torch.cuda.empty_cache()
    if args.sass:
        result["sass"] = sass_counts(mh.LIBRARY.so_path(), args.sass)
        for fn, c in result["sass"].items():
            print(f"SASS {fn}: {c['total']} instructions; {c['top']}")
    line = json.dumps(result)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
