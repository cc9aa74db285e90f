"""Shared set-up of the benchmark's CPU tests: the repository root on the
path, torch held to two threads, a fixture that skips a test without a
CUDA card, and a small copy of the benchmark's data files."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

torch.set_num_threads(2)

BENCH = ROOT / "benchmark"


@pytest.fixture
def card():
    """Skips the test where no CUDA card is present."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def small_copy(dst: Path, size: int = 64, batch: int = 2, mc_samples: int = 4,
               dtype: str = "float32") -> Path:
    """The benchmark's cell, configuration and traffic files (and its feeds
    and metric readers) copied to ``dst`` with every configuration at
    ``size``^2, ``batch`` + ``batch`` images, ``mc_samples`` MC samples and
    ``dtype`` compute, and one warm-up and two profiled steps."""
    for kind in ("workloads", "configs", "traffic", "feeds", "metrics"):
        shutil.copytree(BENCH / kind, dst / kind)
    for f in (dst / "configs").glob("*.json"):
        c = json.loads(f.read_text())
        c["program"]["data"].update(image_size=size, batch_size=batch)
        c["program"]["method"]["mc_samples"] = mc_samples
        c["program"]["model"]["compute_dtype"] = dtype
        f.write_text(json.dumps(c))
    for f in (dst / "traffic").glob("*.json"):
        t = json.loads(f.read_text())
        t.update(warmup_steps=1, profile_steps=2)
        f.write_text(json.dumps(t))
    return dst


@pytest.fixture
def small(tmp_path):
    return small_copy(tmp_path / "bench")
