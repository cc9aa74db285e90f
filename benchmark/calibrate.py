"""Readings that the limits of a cell's correctness numbers are set from,
on the card at the cell's own size, in one process:

    python benchmark/calibrate.py --workload <cell> --seeds 11,12,... \\
        [--control 3] [--faults half_batch,altered] [--out FILE]

For each seed the program's first steps (through the window's call and
feed, as a run makes them) against the float32 reference: the sound
readings, whose largest is a number's lower reading. For the first
``--control`` seeds also the control, the reference rounded to float8
(e4m3, per-tensor scale) wherever the program rounds to bfloat16, forward
and backward (:func:`sides.fp8_quant`), and the program with each planted
fault the cell can have (:mod:`benchmark.harness.faults`; all of them by
default), each against the same float32 reference: their smallest is the
upper reading. One JSON line per reading; the benchmark's runs never run
this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
    sys.path[0] = str(CHECKOUT)


def readings(cell: str, seeds, control: int, faults, device="cuda", root=None, out=None,
             log=print):
    """Yield one dict per reading (``seed``, ``kind``, ``numbers``)."""
    import torch

    from benchmark.harness import check, core, sides
    from benchmark.harness import faults as faults_lib

    root = core.ROOT if root is None else root
    _, config, traffic = core.load_cell(cell, root)
    feed_mod = core.load_py("feeds", traffic["feed"], root)

    def program_side(seed, fault=None):
        program = sides.Program(config, traffic, seed, device)
        if fault is not None:
            program.step = faults_lib.FAULTS[fault](program.step, program)
        feed = feed_mod.Feed(traffic, config, seed, device)
        try:
            loop = core.Loop(feed, program, core.Record(config, traffic, "", 0))
            got, keys = core.first_steps(loop)
        finally:
            feed.close()
        batches = [feed.replay(k) for k in keys]
        del program, loop, feed
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        return got, batches

    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        prog, batches = program_side(seed)
        ref = sides.reference_readings(config, traffic, seed, device, batches)
        rows = [("sound", prog)]
        if i < control:
            rows.append(("control", sides.reference_readings(config, traffic, seed, device,
                                                             batches, quant=sides.fp8_quant)))
            for f in faults:
                rows.append((f"fault:{f}", program_side(seed, f)[0]))
        for kind, got in rows:
            numbers = check.compare(got, ref)
            row = {"cell": cell, "seed": seed, "kind": kind,
                   "numbers": {k: v[0] for k, v in numbers.items()},
                   "at": {k: v[1] for k, v in numbers.items()},
                   "losses": got["losses"],
                   "raw": {"side": _raw(got), "ref": _raw(ref) if kind == "sound" else None}}
            if out is not None:
                out.write(json.dumps(row) + "\n")
                out.flush()
            yield row
        log(f"seed {seed}: {time.perf_counter() - t0:.1f} s")


def _raw(readings: dict) -> dict:
    """A side's readings as plain numbers, so that other numbers can be
    worked out from them later: the leaves' norms, each bank row's norm
    and each tile's norm."""
    import torch

    norm = lambda t: float(torch.linalg.vector_norm(t))  # noqa: E731
    return {"grad": readings["grad"], "change": readings["change"],
            "stats1": readings["stats1"],
            "bank": {k: [norm(row) for row in v] for k, v in readings["bank"].items()},
            "bank1": {k: [norm(row) for row in v] for k, v in readings["bank1"].items()},
            "viz": {k: norm(v) for k, v in readings["viz"].items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control", type=int, default=3, help="seeds with the control and faults")
    ap.add_argument("--faults", default=None, help="comma-separated; default: every fault "
                    "the cell can have")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.faults is None:
        from benchmark.harness import core, faults as faults_lib

        faults = faults_lib.for_traffic(core.load_cell(args.workload)[2])
    else:
        faults = [f for f in args.faults.split(",") if f]
    out = open(args.out, "a") if args.out else None
    try:
        for row in readings(args.workload, seeds, args.control, faults, out=out,
                            log=lambda m: print(m, file=sys.stderr, flush=True)):
            print(json.dumps({k: row[k] for k in ("seed", "kind", "numbers")}), flush=True)
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
