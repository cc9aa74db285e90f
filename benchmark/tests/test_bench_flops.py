"""The FLOP counter: each convolution gradient at its forward's cost, on a
small network against a hand count; the reference's count on meta tensors
against the program's own count at the same shapes."""

from __future__ import annotations

import pytest
import torch
import torch.nn as nn

from benchmark.harness import core, flops, sides


def test_small_conv_net_against_a_hand_count():
    net = nn.Sequential(nn.Conv2d(3, 8, 3, padding=1, bias=False), nn.ReLU(),
                        nn.Conv2d(8, 8, 3, padding=1, groups=8, bias=False),
                        nn.Conv2d(8, 4, 1, bias=False))
    x = torch.randn(2, 3, 16, 16, requires_grad=False)
    px = 2 * 16 * 16  # output pixels
    fwd = 2 * px * (8 * 3 * 9 + 8 * 1 * 9 + 4 * 8 * 1)
    # backward: the first conv's input needs no gradient (only its weight's),
    # the others both: each gradient costs its forward
    bwd = 2 * px * (8 * 3 * 9) + 2 * (2 * px * (8 * 1 * 9 + 4 * 8 * 1))
    with flops.counter() as c:
        net(x).sum().backward()
    assert c.get_total_flops() == fwd + bwd


@pytest.mark.parametrize("cell", ["clr-mbv2-staged", "clr-mbv2-warmup-staged",
                                  "clr-r101-staged"])
def test_reference_count_equals_the_programs(cell, small):
    """At 64^2, B 2 + 2 on the CPU, the reference's count on meta tensors
    equals ``count_flops`` of one program step (which adds K1's product
    by its rows on the card; on the CPU its plain version's product is
    counted)."""
    from uda_clr_tpu_torch.utils.benchmarking import count_flops

    _, config, traffic = core.load_cell(cell, small)
    ours = flops.step_flops(config, traffic)
    program = sides.Program(config, traffic, 3, "cpu")
    feed = core.load_py("feeds", traffic["feed"], small).Feed(traffic, config, 3, "cpu")
    _, theirs = count_flops(lambda: program.step(feed.take()))
    assert ours == theirs


def test_full_size_counts():
    """The flagship's count at 512^2, B 8 + 8, T 8 is the 6.967 TFLOP per
    step that the program's ``count_flops`` gave on the card."""
    _, config, traffic = core.load_cell("clr-mbv2-staged")
    assert flops.step_flops(config, traffic) == pytest.approx(6.967e12, rel=1e-3)
