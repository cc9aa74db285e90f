"""The disk-bank method (``method='prototype'``) in the port: its prototype
functions (uda_clr_tpu_torch/ops/prototypes.py) against the JAX package's
(ops/prototypes.py:255-296) and the zero-guarded bank EMA, then the step
under ``norm='tn'`` with the default switches against JAX
``make_train_step``: two prototype-phase iterations from the same weights,
bank and batches, dropout off on both sides. Harness and tolerances:
tests/torch_step_harness.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_step_harness import (  # noqa: F401
    TN_RTOL,
    TN_STATS_RTOL,
    check_losses,
    check_proto_bank,
    check_params,
    dropout_off,
    random_bank,
    run_steps,
    two_threads,
)
from uda_clr_tpu.ops import prototypes as JP
from uda_clr_tpu_torch.ops import prototypes as P

pytestmark = pytest.mark.usefixtures("two_threads")

def _feature_and_mask(seed: int, sparse: bool = False):
    rng = np.random.default_rng(seed)
    feat = rng.standard_normal((2, 9, 11, 16)).astype(np.float32)
    mask = (rng.uniform(size=(2, 9, 11, 1)) > (0.97 if sparse else 0.4)).astype(np.float32)
    return feat, mask


# eps +1 (every pool of Trainer_prototype) and +1e-16 (the cup/disc pools of
# bank_use_bu=False), on a dense mask and on one that may leave an image empty
@pytest.mark.parametrize("eps", [1.0, 1e-16])
@pytest.mark.parametrize("sparse", [False, True])
def test_masked_pool_mean_matches_jax(eps, sparse):
    feat, mask = _feature_and_mask(0, sparse)
    got = P.masked_pool_mean(torch.from_numpy(feat), torch.from_numpy(mask), eps).numpy()
    want = np.asarray(JP.masked_pool_mean(jnp.asarray(feat), jnp.asarray(mask), eps))
    # float32 sums in another order (measured <= 6.0e-8)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_adaptation_factor_matches_jax():
    for epoch in (0, 1, 2, 5, 10, 26, 30, 100, 499):
        assert P.adaptation_factor(epoch) == float(JP.adaptation_factor(jnp.float32(epoch))), epoch


@pytest.mark.parametrize("fn", ["cosine_prototype_weight", "feat_prototype_distance"])
def test_prototype_weights_match_jax(fn):
    feat, _ = _feature_and_mask(1)
    proto = np.random.default_rng(2).standard_normal(16).astype(np.float32)
    got = getattr(P, fn)(torch.from_numpy(feat), torch.from_numpy(proto)).numpy()
    want = np.asarray(getattr(JP, fn)(jnp.asarray(feat), jnp.asarray(proto)))
    assert got.shape == want.shape == (2, 9, 11, 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)  # measured <= 9.6e-7 of 7.7
    dist = torch.from_numpy(np.abs(got))
    np.testing.assert_allclose(P.minmax_prototype_weight(dist).numpy(),
                               np.asarray(JP.minmax_prototype_weight(jnp.asarray(dist.numpy()))),
                               rtol=1e-5, atol=1e-6)


def test_bank_ema_is_zero_guarded():
    """(1 - m) bank + m cur, as the JAX step's commit (steps.py:862-876),
    and an all-zero current prototype leaves the vector unchanged."""
    rng = np.random.default_rng(4)
    bank = rng.standard_normal(305).astype(np.float32)
    cur = rng.standard_normal(305).astype(np.float32)
    mom = 0.001
    got = P.bank_ema(torch.from_numpy(bank), torch.from_numpy(cur), mom).numpy()
    want = np.asarray(jnp.where(jnp.sum(jnp.asarray(cur)) != 0.0,
                                (1.0 - mom) * jnp.asarray(bank) + mom * jnp.asarray(cur),
                                jnp.asarray(bank)))
    np.testing.assert_array_equal(got, want)
    same = P.bank_ema(torch.from_numpy(bank), torch.zeros(305), mom).numpy()
    np.testing.assert_array_equal(same, bank)


def test_prototype_bank_tn_matches_jax(dropout_off):
    jstate, state, history = run_steps("prototype", (True, True), norm="tn",
                                       prepare=random_bank)
    assert {"loss_bu", "loss_cup", "loss_disc"} <= set(history[0][0])
    check_losses(history, TN_RTOL)
    check_params(jstate, state, discriminators=(True, True), stats_rtol=TN_STATS_RTOL)
    check_proto_bank(jstate, state, 5e-5)  # measured 1.4e-5
