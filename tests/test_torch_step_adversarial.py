"""The port's generic train step for ``adversarial`` (both PatchGAN
discriminators) and ``posal`` (adversarial with the entropy discriminator
forced off; the reference's Trainer_posal) against the JAX package's
``make_train_step``: two iterations from the same weights and batches,
dropout off on both sides. Harness and tolerances: tests/torch_step_harness.py."""

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


@pytest.mark.parametrize("method,discriminators", [("adversarial", (True, True)),
                                                   ("posal", (True, False))])
def test_adversarial_steps_match_jax(dropout_off, method, discriminators):
    jstate, state, history = run_steps(method, (False, False))
    keys = {"loss_seg", "loss_adv", "loss_all", "loss_D"} | ({"loss_D2"} if discriminators[1] else set())
    assert set(history[0][0]) == keys
    check_losses(history)
    check_params(jstate, state, discriminators)
