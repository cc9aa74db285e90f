"""Hyperparameter ramp schedules (own copy of uda_clr_tpu/utils/ramps.py;
reference utils/Utils.py:312-334)."""

from __future__ import annotations

import numpy as np


def sigmoid_rampup(current: float, rampup_length: float) -> float:
    """Exponential rampup from arXiv:1610.02242."""
    if rampup_length == 0:
        return 1.0
    current = float(np.clip(current, 0.0, rampup_length))
    phase = 1.0 - current / rampup_length
    return float(np.exp(-5.0 * phase * phase))


def linear_rampup(current: float, rampup_length: float) -> float:
    assert current >= 0 and rampup_length >= 0
    if current >= rampup_length:
        return 1.0
    return current / rampup_length


def cosine_rampdown(current: float, rampdown_length: float) -> float:
    assert 0 <= current <= rampdown_length
    return float(0.5 * (np.cos(np.pi * current / rampdown_length) + 1))


def get_current_consistency_weight(epoch: float, consistency: float, rampup: float) -> float:
    """Mean-teacher consistency weight schedule (Trainer_MT bytecode:
    consistency_lamda * sigmoid_rampup(epoch, consistency_rampup))."""
    return consistency * sigmoid_rampup(epoch, rampup)
