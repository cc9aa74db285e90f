"""On the card: a whole run of each cell at a small size, through the
program's kernels, comes out correct with every metric of its cell.
Run with ``python -m pytest -m cuda benchmark/tests``."""

from __future__ import annotations

import pytest

from benchmark.harness import core
from conftest import small_copy


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", ["clr-mbv2-staged", "clr-mbv2-warmup-staged",
                                  "clr-r101-staged"])
def test_small_run_on_the_card(cell, trace, card, tmp_path):
    root = small_copy(tmp_path / "bench", size=128, batch=4, mc_samples=8, dtype="bfloat16")
    spec = core.load_json("workloads", cell, root)
    result = core.run_cell(cell, 2**31 + 5, 1.0, trace, card, root=root, log=lambda m: None)
    assert result["device"]["platform"] == "gpu"
    names = spec["per_layer" if trace else "end_to_end"]
    assert set(result["metrics"]) <= set(names)
    if trace:
        assert result["device"]["busy_s"] > 0
