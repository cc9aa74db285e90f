"""The whole step's share of the card's dense bfloat16 peak: the FLOPs of
one step of the configuration's reference (counted once on meta tensors,
:mod:`benchmark.harness.flops`), over the window's mean step time (its wall
time over its steps, outside the profiled sub-window), over the peak."""

from benchmark.harness import peaks

UNIT = "%"


def read(rec):
    peak = peaks.peak_flops(rec.device_name)
    if not peak or not rec.flops_per_step or not rec.steps:
        return None
    return 100.0 * rec.flops_per_step / (rec.wall_s / rec.steps) / peak
