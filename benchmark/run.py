"""The benchmark of ``uda_clr_tpu_torch`` on NVIDIA cards: one run of one cell.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell is ``benchmark/workloads/<cell>.json``
(README.md says what the files hold). Standard error carries the card, the
sample counts and each number the correctness check compared, beside its
limit, last; the last line of standard output is the result object.

Exits non-zero, with no result, without a CUDA card or with fewer cards
than the cell asks for, where the program is not in the checkout, and
where ``jax``, ``jaxlib``, ``flax`` or the JAX package are loaded once the
window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]


def _setup_process() -> None:
    """The checkout on the import path in place of this folder, and the
    build and compile caches inside the checkout, at fixed paths."""
    here = Path(__file__).resolve().parent
    sys.path[:] = [p for p in sys.path if not p or Path(p).resolve() != here]
    if str(CHECKOUT) not in sys.path:
        sys.path.insert(0, str(CHECKOUT))
    build = CHECKOUT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(build / "inductor")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


FORBIDDEN = ("jax", "jaxlib", "flax", "uda_clr_tpu")


def loaded_forbidden(modules) -> list[str]:
    """The loaded modules whose top-level name (before the first dot) is
    one of :data:`FORBIDDEN`, compared whole."""
    return sorted({m for m in modules if m.split(".", 1)[0] in FORBIDDEN})


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _setup_process()

    import torch

    from benchmark.harness import core, peaks

    cell = core.load_json("workloads", args.workload)
    if not torch.cuda.is_available():
        log("no CUDA card: the benchmark runs on the card only")
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        log(f"{torch.cuda.device_count()} cards; the cell asks for {cell['chips']}")
        return 2
    try:
        import uda_clr_tpu_torch
    except ImportError as e:
        log(f"the program is missing: {e}")
        return 2
    if CHECKOUT not in Path(uda_clr_tpu_torch.__file__).resolve().parents:
        log(f"the program loaded from {uda_clr_tpu_torch.__file__}, outside {CHECKOUT}")
        return 2

    log(f"card: {peaks.card_line(0)}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"cuDNN {torch.backends.cudnn.version()}, benchmark={torch.backends.cudnn.benchmark}, "
        f"deterministic={torch.backends.cudnn.deterministic}; "
        f"{torch.get_num_threads()} host threads of {len(os.sched_getaffinity(0))} cores")
    result = core.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                           "cuda", T_START, log=log)
    bad = loaded_forbidden(sys.modules)
    if bad:
        log(f"loaded in this process: {', '.join(bad)}")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
