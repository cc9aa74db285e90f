"""A later change adds a cell by adding files only: a new workload file
(here a new traffic mix too) in a copy of the benchmark's files, and the
harness runs it without an edit to any file that is already there."""

from __future__ import annotations

import json

from benchmark.harness import core


def test_a_cell_added_as_files_runs(small):
    before = {p: p.read_bytes() for p in small.rglob("*") if p.is_file()}
    traffic = json.loads((small / "traffic" / "prototype_staged.json").read_text())
    traffic.update(name="prototype_staged_two", pairs=2, epoch=40)
    (small / "traffic" / "prototype_staged_two.json").write_text(json.dumps(traffic))
    cell = json.loads((small / "workloads" / "clr-mbv2-staged.json").read_text())
    cell.update(name="clr-mbv2-two-staged", traffic="prototype_staged_two")
    (small / "workloads" / "clr-mbv2-two-staged.json").write_text(json.dumps(cell))
    result = core.run_cell("clr-mbv2-two-staged", 5, 0.5, True, "cpu", root=small,
                           log=lambda m: None)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1
    assert "step.dispatch_ms" in result["metrics"]
    assert all(p.read_bytes() == b for p, b in before.items())
