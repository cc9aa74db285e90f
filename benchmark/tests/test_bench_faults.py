"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card skipped (CPU, a small copy, the program in
float32), once for each fault a training cell on one card can have; and
the same run without a fault comes out correct.

In float32 the program takes the reference's first step to rounding, so
the copy holds the cells' step-1 numbers to float32 limits (1e-4; the
change and the banks after three steps to their cell's limits, as Adam's
first steps turn float32 rounding into 1e-2 gaps). The cells' own limits
against these faults, at their own size in bfloat16, were read on the
card (PERF.md)."""

from __future__ import annotations

import json

import pytest

from benchmark.harness import core, faults

F32 = 1e-4
STEP1 = ("stats1_", "grad_", "std", "loss1.")  # the numbers read after step 1


@pytest.fixture
def small(small):
    for f in (small / "workloads").glob("*.json"):
        cell = json.loads(f.read_text())
        cell["limits"].update({k: F32 for k in cell["limits"] if k.startswith(STEP1)})
        f.write_text(json.dumps(cell))
    return small

CELLS = ["clr-mbv2-staged", "clr-mbv2-warmup-staged", "clr-r101-staged"]


def run(cell, root, fault=None):
    return core.run_cell(cell, 2**31 + 77, 0.5, False, "cpu", fault=fault, root=root,
                         log=lambda m: None)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, small):
    result = run(cell, small)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert result["attempted"] >= 1 and result["failed"] == 0


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS
                                        for f in faults.for_traffic(core.load_cell(c)[2])])
def test_fault_is_not_correct(cell, fault, small):
    result = run(cell, small, faults.FAULTS[fault])
    assert not result["correct"], result["checks"]
