"""The port's generic train step for ``mean_teacher`` against the JAX
package's ``make_train_step``: two iterations from the same weights and
batches, dropout off and ``teacher_noise`` 0 on both sides (the noise
streams cannot coincide), with and without the adversarial branch
(``use_adv``; the reference's Trainer_MT_wo_ad). The teacher's EMA params
and tracked stats are compared as well. Harness and tolerances:
tests/torch_step_harness.py."""

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


@pytest.mark.parametrize("use_adv", [True, False])
def test_mean_teacher_steps_match_jax(dropout_off, use_adv):
    def configure(m):
        m.teacher_noise = 0.0
        m.use_adv = use_adv

    jstate, state, history = run_steps("mean_teacher", (False, False), configure)
    assert "loss_consistency" in history[0][0]
    check_losses(history)
    check_params(jstate, state, discriminators=(use_adv, use_adv))
