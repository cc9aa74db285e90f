"""The plain reference against the port, at 64^2, B 2 + 2, float32 on the
CPU, for both backbones and both phases: from the same weights, batches
and seed they take the same first step (the dropout masks, the MC pass's
Philox words, the losses, the gradients and the running statistics)."""

from __future__ import annotations

import pytest

from benchmark.harness import check, core, sides


@pytest.mark.parametrize("cell", ["clr-mbv2-staged", "clr-mbv2-warmup-staged",
                                  "clr-r101-staged"])
def test_reference_follows_the_port(cell, small):
    _, config, traffic = core.load_cell(cell, small)
    feed = core.load_py("feeds", traffic["feed"], small).Feed(traffic, config, 11, "cpu")
    program = sides.Program(config, traffic, 11, "cpu")
    loop = core.Loop(feed, program, core.Record(config, traffic, "cpu", 2))
    prog, keys = core.first_steps(loop)
    ref = sides.reference_readings(config, traffic, 11, "cpu", [feed.replay(k) for k in keys])
    numbers = check.compare(prog, ref)
    assert numbers["loss1"][0] < 1e-5, numbers["loss1"]
    assert numbers["grad"][0] < 1e-4, numbers["grad"]
    assert numbers["stats1"][0] < 1e-4, numbers["stats1"]
    viz = {k: v for k, v in numbers.items() if k.startswith("viz.")}
    assert viz and max(v[0] for v in viz.values()) < 1e-4, viz
    assert numbers.get("std", (0.0,))[0] < 1e-4, numbers.get("std")
    # later steps only within float32's chaos after Adam's first step
    for m in ("gen", "dis", "dis2"):
        assert numbers[f"change_median.{m}"][0] < 0.1, m
    assert set(prog["losses"][0]) == set(ref["losses"][0])
