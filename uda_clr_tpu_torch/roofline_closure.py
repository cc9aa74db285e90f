"""Per-op roofline of the flagship train step on one card (the counterpart
of the JAX package's ``tools/roofline_closure.py``).

    python -m uda_clr_tpu_torch.roofline_closure [--steps 3] [--floor 1.0]
        [--size 512] [--batch 8] [--out runs/roofline_closure.csv] [--device cuda]

The step is ``bench.py``'s: the prototype-phase ``prototype_full`` step at
512x512, 8 source + 8 target images, T=8, bfloat16, mobilenet OS16,
``norm='bn'``, dropout backend ``UDA_DROPOUT_IMPL`` (``xla16``). After a
first call and 2 warm-up steps, ``--steps`` steps run under the profiler,
under ``utils/opcount.OpCounter`` (each aten op's bytes and flops, and a
profiler range around it) and under ``count_flops``:

1. **Work per op.** The dispatcher's aten ops, keyed by name and input
   shapes; bytes and flops as ``utils/opcount.py`` counts them. The kernels
   launched through ctypes (K1, K4 on every norm site, and K3 under
   ``'pallas'``) come from their counters, with their byte and flop
   formulas; ``TorchDispatchMode`` sees none of them.
2. **Time per op.** Every device kernel, copy and memset of the trace is
   joined to the op range its launch falls in (the chrome trace's
   correlation of launch and kernel); a hand-written kernel launched
   outside any op range goes to its own row by its kernel's name. The
   kernels' device durations do not depend on the host time the counting
   adds.
3. **Roofline.** Per op, roofline ms = max(bytes / the card's HBM rate,
   flops / its dense bf16 peak) (``utils/devinfo.py``: 3350 GB/s and
   989.5 TFLOP/s on the H100 SXM); achieved share = roofline ms /
   measured ms.

Ops below ``--floor`` ms per step are summed into one tail row. The tool
checks its own closure and raises (after printing the table) unless the
per-op flops sum to ``count_flops`` of the same steps, the per-op device
ms sum to the trace's device time within 1%, and no row's share (the
table's and the tail's) reads above 1.05.

Writes the whole per-op table to ``--out`` (CSV), prints the table rows
and, last, one JSON line with the totals, the checks, the table, the K1
launches, ``device_kind`` and ``power_limit_w``. On the CPU (``--device
cpu``, for tests) there is no device trace: each op's time is its range
on the host clock, and the roofline columns and the time checks are null.
"""

from __future__ import annotations

import argparse
import bisect
import csv
import json
import os
import tempfile

from uda_clr_tpu_torch.utils import opcount
from uda_clr_tpu_torch.utils.benchmarking import (
    EPOCH,
    LR_DIS,
    LR_GEN,
    count_flops,
    flagship_config,
    staged_train_batch,
)
from uda_clr_tpu_torch.utils.devinfo import card_fields, peak_hbm_gbs, peak_tflops

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# hand-written kernels launched outside any op range: row name by a
# fragment of the CUDA kernel's name (csrc/*.cu)
KERNEL_ROWS = (("mask_head_kernel", "K1 mask_head_split"), ("dropout_kernel", "K3 dropout"),
               ("domain_norm", "K4 domain_norm"))
UNATTRIBUTED = "(launched outside any op range)"
TIME_RTOL = 0.01  # the per-op device ms against the trace's total
SHARE_MAX = 1.05  # a share above 1 means the work model undercounts


def attribute(events: list[dict]) -> tuple[dict, float]:
    """Device microseconds by row from chrome-trace events: each device
    event (kernel, copy, memset) goes to the op range (name
    ``opcount.RANGE_PREFIX`` + key) on its launch's thread that holds the
    launch's start, else to a hand-written kernel's row by name
    (:data:`KERNEL_ROWS`), else to :data:`UNATTRIBUTED`. Returns ({row:
    us}, the total us of the device events)."""
    ranges: dict[tuple, list] = {}
    launches = {}
    for ev in events:
        cat, args = ev.get("cat", ""), ev.get("args") or {}
        if cat == "user_annotation" and ev.get("name", "").startswith(opcount.RANGE_PREFIX):
            ranges.setdefault((ev["pid"], ev["tid"]), []).append(
                (float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0.0)),
                 ev["name"][len(opcount.RANGE_PREFIX):]))
        elif cat in LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = ((ev["pid"], ev["tid"]), float(ev["ts"]))
    for spans in ranges.values():
        spans.sort()
    starts = {thread: [s[0] for s in spans] for thread, spans in ranges.items()}
    out: dict[str, float] = {}
    total = 0.0
    for ev in events:
        if ev.get("cat") not in DEVICE_CATS:
            continue
        dur = float(ev.get("dur", 0.0))
        total += dur
        row = None
        launch = launches.get((ev.get("args") or {}).get("correlation"))
        if launch is not None and launch[0] in ranges:
            spans = ranges[launch[0]]
            i = bisect.bisect_right(starts[launch[0]], launch[1]) - 1
            if i >= 0 and spans[i][0] <= launch[1] <= spans[i][1]:
                row = spans[i][2]
        if row is None:
            name = ev.get("name", "")
            row = next((r for frag, r in KERNEL_ROWS if frag in name), UNATTRIBUTED)
        out[row] = out.get(row, 0.0) + dur
    return out, total


def host_ranges(events: list[dict]) -> dict:
    """Host microseconds of each op range (the CPU, which has no device
    trace)."""
    out: dict[str, float] = {}
    for ev in events:
        if ev.get("cat") == "user_annotation" and \
                ev.get("name", "").startswith(opcount.RANGE_PREFIX):
            key = ev["name"][len(opcount.RANGE_PREFIX):]
            out[key] = out.get(key, 0.0) + float(ev.get("dur", 0.0))
    return out


def roofline_ms(nbytes: float, flops: float, hbm_gbs, tflops):
    """(roofline ms, what bounds it) at the card's peaks, or (None, None)."""
    if not hbm_gbs or not tflops:
        return None, None
    t_bytes, t_ops = nbytes / (hbm_gbs * 1e9) * 1e3, flops / (tflops * 1e12) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def table(work: dict, times_us: dict, steps: int, floor_ms: float, hbm_gbs, tflops):
    """Rows per step from ``work`` ({row: {"calls" or "launches", "bytes",
    "flops"}}) and ``times_us`` ({row: us over ``steps``}), largest time
    first: ``(all rows, the rows >= floor_ms, the tail row)``. A row with
    time but no work (:data:`UNATTRIBUTED`) keeps its time."""
    rows = []
    for name in sorted(set(work) | set(times_us)):
        w = work.get(name, {})
        ms = times_us.get(name, 0.0) / 1e3 / steps
        nbytes, flops = w.get("bytes", 0) / steps, w.get("flops", 0) / steps
        roof, bound = roofline_ms(nbytes, flops, hbm_gbs, tflops)
        rows.append({
            "op": name,
            "calls": (w.get("calls", w.get("launches", 0))) / steps,
            "ms": ms,
            "gbytes": nbytes / 1e9,
            "gflops": flops / 1e9,
            "roofline_ms": roof,
            "bound_by": bound,
            "share": (roof / ms if roof is not None and ms > 0 else None),
        })
    rows.sort(key=lambda r: -r["ms"])
    heavy = [r for r in rows if r["ms"] >= floor_ms]
    light = [r for r in rows if r["ms"] < floor_ms]
    t_ms = sum(r["ms"] for r in light)
    t_roof = None if hbm_gbs is None or tflops is None else sum(
        r["roofline_ms"] or 0.0 for r in light)
    tail = {"op": f"tail: {len(light)} rows below {floor_ms} ms", "calls": sum(
        r["calls"] for r in light), "ms": t_ms, "gbytes": sum(r["gbytes"] for r in light),
        "gflops": sum(r["gflops"] for r in light), "roofline_ms": t_roof, "bound_by": None,
        "share": (t_roof / t_ms if t_roof is not None and t_ms > 0 else None)}
    return rows, heavy, tail


def checks(op_flops: int, counted_flops: int, device_us, attributed_us, heavy: list,
           tail: dict) -> dict:
    """The closure: flops conserved exactly; the attributed device time
    within :data:`TIME_RTOL` of the trace's; no share above
    :data:`SHARE_MAX` (null where not measured)."""
    shares = [r["share"] for r in heavy + [tail] if r["share"] is not None]
    return {
        "flops_conserved": op_flops == counted_flops,
        "ms_conserved": (None if device_us is None else
                         abs(device_us - attributed_us) <= TIME_RTOL * device_us),
        "max_share": max(shares) if shares else None,
        "shares_bounded": (max(shares) <= SHARE_MAX) if shares else None,
    }


def _fmt(v, spec):
    return "-" if v is None else format(v, spec)


def main(argv=None) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from uda_clr_tpu_torch import resolve_device
    from uda_clr_tpu_torch.models.layers import set_dropout_impl
    from uda_clr_tpu_torch.train.state import create_train_state
    from uda_clr_tpu_torch.train.steps import make_train_step

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3, help="profiled prototype-phase steps")
    ap.add_argument("--floor", type=float, default=1.0, help="ms per step of a table row")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8, help="images per domain")
    ap.add_argument("--out", default=os.path.join("runs", "roofline_closure.csv"))
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    set_dropout_impl(os.environ.get("UDA_DROPOUT_IMPL", "xla16"))
    cfg = flagship_config("bn")
    state = create_train_state(cfg, seed=0, device=device)
    data = staged_train_batch(args.batch, args.size, device)
    step = make_train_step(cfg, "prototype_full", proto_phase=True)
    warm = 3  # the first call and 2 warm-up steps
    for _ in range(warm):
        state, metrics = step(state, data, LR_GEN, LR_DIS, EPOCH)
    float(metrics["loss_all"])

    counter = opcount.OpCounter(annotate=True)
    before = opcount.kernel_counts()

    def run():
        nonlocal state
        with counter:
            for _ in range(args.steps):
                state, m = step(state, data, LR_GEN, LR_DIS, EPOCH)
        return m

    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=activities) as prof:
        metrics, counted = count_flops(run)
        loss = float(metrics["loss_all"])
    kernels = opcount.kernel_work(before, opcount.kernel_counts(), cfg.model.dtype)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]

    card = card_fields(device)
    work = {**counter.ops, **kernels}
    if device.type == "cuda":
        times, device_us = attribute(events)
        hbm, tflops = peak_hbm_gbs(card["device_kind"]), peak_tflops(card["device_kind"])
    else:
        times, device_us, hbm, tflops = host_ranges(events), None, None, None
    rows, heavy, tail = table(work, times, args.steps, args.floor, hbm, tflops)
    op_flops = counter.total("flops") + sum(k["flops"] for k in kernels.values())
    attributed_us = sum(us for row, us in times.items() if row != UNATTRIBUTED)
    closure = checks(op_flops, counted, device_us, attributed_us, heavy, tail)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    print(f"# {card['device_kind']} ({card['power_limit_w']} W): {args.steps} profiled steps, "
          f"{len(rows)} rows; peaks {hbm} GB/s, {tflops} TFLOP/s; loss_all {loss:.5f}")
    print(f"{'ms':>8} {'calls':>6} {'GB':>8} {'GFLOP':>9} {'roof_ms':>8} {'bound':>10} "
          f"{'share':>6}  op")
    for r in heavy + [tail]:
        print(f"{r['ms']:8.3f} {r['calls']:6.0f} {r['gbytes']:8.3f} {r['gflops']:9.1f} "
              f"{_fmt(r['roofline_ms'], '8.3f')} {r['bound_by'] or '-':>10} "
              f"{_fmt(r['share'], '6.3f')}  {r['op'][:110]}")
    result = {
        "metric": f"per-op roofline of prototype_full ({args.size}x{args.size}, "
                  f"B{args.batch}+{args.batch}, T=8 MC, bf16, bn)",
        "steps": args.steps,
        "proto_steps": warm + args.steps,
        "step_tflops": counted / args.steps / 1e12,
        "op_tflops": op_flops / args.steps / 1e12,
        "device_ms_per_step": None if device_us is None else device_us / 1e3 / args.steps,
        "attributed_ms_per_step": attributed_us / 1e3 / args.steps,
        "rows": len(rows),
        "floor_ms": args.floor,
        "table": heavy,
        "tail": tail,
        "checks": closure,
        "launches": {name: k["launches"] for name, k in kernels.items()},
        "time_source": "device trace" if device.type == "cuda" else "host ranges (cpu)",
        "csv": args.out,
        **card,
    }
    print(json.dumps(result), flush=True)
    failed = [k for k in ("flops_conserved", "ms_conserved", "shares_bounded")
              if closure[k] is False]
    if failed:
        raise RuntimeError(f"roofline_closure: the closure fails: {failed} ({closure}; "
                           f"op flops {op_flops}, count_flops {counted})")
    return result


if __name__ == "__main__":
    main()
