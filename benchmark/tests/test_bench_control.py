"""The control: the reference put in the program's place and computed in
float8 (e4m3, per-tensor scale) at every point where the program rounds to
bfloat16, its values on the way forward and their gradients on the way
back, against the float32 reference, fails the cell's limits; the
bfloat16 program at the same size passes them, but for the prototype
banks', whose centroids rest on 16 times fewer feature pixels here than
at the cells' size. At 128^2, B 4 + 4, T 8 on the CPU (the cells' limits
come from runs at their own size on the card)."""

from __future__ import annotations

import pytest

from benchmark.harness import check, core, sides
from conftest import small_copy


@pytest.fixture(scope="module")
def bf16(tmp_path_factory):
    return small_copy(tmp_path_factory.mktemp("bench"), size=128, batch=4, mc_samples=8,
                      dtype="bfloat16")


@pytest.mark.parametrize("cell", ["clr-mbv2-staged", "clr-mbv2-warmup-staged"])
def test_control_fails_and_the_program_passes(cell, bf16):
    spec, config, traffic = core.load_cell(cell, bf16)
    feed = core.load_py("feeds", traffic["feed"], bf16).Feed(traffic, config, 5, "cpu")
    program = sides.Program(config, traffic, 5, "cpu")
    prog, keys = core.first_steps(core.Loop(feed, program, core.Record(config, traffic, "", 4)))
    batches = [feed.replay(k) for k in keys]
    ref = sides.reference_readings(config, traffic, 5, "cpu", batches)
    ctl = sides.reference_readings(config, traffic, 5, "cpu", batches, quant=sides.fp8_quant)
    unbanked = {k: v for k, v in spec["limits"].items() if not k.startswith("bank")}
    assert check.verdict(check.compare(prog, ref), unbanked)
    assert not check.verdict(check.compare(ctl, ref), spec["limits"])
