"""The port's ``prototype_full`` step with its other switches against the
JAX package's ``make_train_step``: two prototype-phase iterations with
``retrify_pseudo`` off (plain soft-mask target centroids, no MC pass) and
with ``use_global`` off (no EMA across steps), dropout off on both sides.
The default path is tests/test_torch_step.py's. Harness and tolerances:
tests/torch_step_harness.py."""

import pytest

from tests.torch_step_harness import (  # noqa: F401
    check_banks,
    check_losses,
    check_params,
    dropout_off,
    run_steps,
    two_threads,
)

# two torch threads: at one per core the port's CPU work and XLA's threads
# contend in one process (a port step took ~10 s instead of ~0.3 s)
pytestmark = pytest.mark.usefixtures("two_threads")


@pytest.mark.parametrize("switch,bank_atol", [
    ("retrify_pseudo", 1e-2),  # banks measured 2.3e-3
    ("use_global", 8e-2),  # 1.5e-2: target pixels cross the hard pseudo-label thresholds
])
def test_prototype_full_switch_off_matches_jax(dropout_off, switch, bank_atol):
    jstate, state, history = run_steps("prototype_full", (True, True),
                                       lambda m: setattr(m, switch, False))
    check_losses(history)
    check_params(jstate, state, discriminators=(True, True))
    check_banks(jstate, state, bank_atol)
