"""The port's generic train step (uda_clr_tpu_torch/train/steps.py) for the
supervised ``baseline`` against the JAX package's ``make_train_step``: two
iterations from the same weights and batches, dropout off on both sides,
with and without the boundary MSE term (``use_boundary_loss``, the
reference's Trainer_baseline_wob). The harness and the tolerances, each
with what was measured, are in tests/torch_step_harness.py."""

import pytest

from tests.torch_step_harness import (  # noqa: F401  (fixtures)
    check_losses,
    check_params,
    dropout_off,
    run_steps,
    two_threads,
)

# two torch threads: at one per core the port's CPU work and XLA's threads
# contend in one process (a port step took ~10 s instead of ~0.3 s)
pytestmark = pytest.mark.usefixtures("two_threads")


@pytest.mark.parametrize("use_boundary_loss", [True, False])
def test_baseline_steps_match_jax(dropout_off, use_boundary_loss):
    jstate, state, history = run_steps(
        "baseline", (False, False),
        lambda m: setattr(m, "use_boundary_loss", use_boundary_loss))
    assert set(history[0][0]) == {"loss_seg", "loss_all"}
    check_losses(history)
    check_params(jstate, state, discriminators=(False, False))
