"""The ops the port's prototype_mt and mean_teacher steps add
(uda_clr_tpu_torch/ops/{augment,losses,prototypes}.py, train/optim.py,
train/steps.py:consistency_threshold) against the JAX package's, on shared
inputs made with numpy.

Tolerances: strong_augment is bitwise on shared draws (the same float32
ops in the same order, every intermediate snapped to the uint8 grid);
1e-6 relative on the elementwise loss and its gradient; 1e-5 on the source
discriminative loss and its gradients, whose channel means and global means
sum in another order; 1e-6 on the weight EMA."""

import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_step_harness import jax_aug_draws, two_threads  # noqa: F401
from uda_clr_tpu.ops import losses as JL
from uda_clr_tpu.ops import prototypes as JP
from uda_clr_tpu.ops.augment import strong_augment as jax_strong_augment
from uda_clr_tpu.train import optim as jax_optim
from uda_clr_tpu.train.state import create_train_state as jax_create_train_state
from uda_clr_tpu_torch.ops import losses as L
from uda_clr_tpu_torch.ops import prototypes as P
from uda_clr_tpu_torch.ops.augment import N_DRAWS, augment_draws, strong_augment
from uda_clr_tpu_torch.train import optim as optim_lib
from uda_clr_tpu_torch.train.steps import consistency_threshold

# two torch threads: at one per core the port's CPU work and XLA's threads
# contend in one process (a port step took ~10 s instead of ~0.3 s)
pytestmark = pytest.mark.usefixtures("two_threads")


RNG = np.random.default_rng


def _draws_of(key, b):
    """The nine uniforms of each image that jax strong_augment(key, .) draws."""
    return np.stack([
        np.asarray([jax.random.uniform(k) for k in jax.random.split(kk, 9)])
        for kk in jax.random.split(key, b)]).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_strong_augment_matches_jax_on_shared_draws(seed):
    img = RNG(seed).uniform(-1, 1, (8, 24, 20, 3)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax_strong_augment(key, jnp.asarray(img)))
    draws = _draws_of(key, 8)
    got = strong_augment(torch.from_numpy(img), torch.from_numpy(draws)).numpy()
    np.testing.assert_array_equal(got, want)


def test_augment_draws_cover_every_branch():
    """Host-side Philox draws: deterministic per seed, in [0, 1), and over
    64 images each branch (colour p=0.8, gray p=0.2, 5-tap p=0.5, blur
    p=0.5) is both taken and skipped; the transform keeps [-1, 1]."""
    d = augment_draws(5, 64, "cpu")
    assert d.shape == (64, N_DRAWS) and d.dtype == torch.float32
    assert torch.equal(d, augment_draws(5, 64, "cpu"))
    assert not torch.equal(d, augment_draws(6, 64, "cpu"))
    assert float(d.min()) >= 0.0 and float(d.max()) < 1.0
    for j, p in ((0, 0.8), (6, 0.2), (7, 0.5), (8, 0.5)):
        taken = (d[:, j] < p).float().mean().item()
        assert 0.0 < taken < 1.0
    x = torch.from_numpy(RNG(9).uniform(-1, 1, (64, 8, 8, 3)).astype(np.float32))
    y = strong_augment(x, d)
    assert float(y.abs().max()) <= 1.0 + 1e-6 and not torch.equal(x, y)


def test_jax_aug_draws_replays_the_step_key():
    """The step tests hand the port the JAX step's draws: k_aug is the
    fourth of six keys split from the state's rng (steps.py:560)."""
    from uda_clr_tpu.models.deeplab import DeepLab

    model = DeepLab(num_classes=2, backbone="mobilenet", output_stride=16, norm="bn")
    # the state's rng alone: the compiled program keeps only its computation
    rng = jax.jit(lambda key: jax_create_train_state(model, key, (1, 32, 32, 3)).rng)(
        jax.random.PRNGKey(0))
    jstate = types.SimpleNamespace(rng=rng)
    k_aug = jax.random.split(jstate.rng, 6)[3]
    np.testing.assert_array_equal(jax_aug_draws(jstate, 3), _draws_of(k_aug, 3))


def test_bce_sigmoid_stable_elementwise_value_and_grad():
    rng = RNG(1)
    logits = (4.0 * rng.standard_normal((2, 8, 8, 2))).astype(np.float32)
    logits[0, 0, 0] = [17.5, 40.0]  # float32 sigmoid saturates to exactly 1 or 0
    logits[0, 0, 1] = [-20.0, -120.0]
    targets = (rng.uniform(size=logits.shape) > 0.5).astype(np.float32)
    g = rng.standard_normal(logits.shape).astype(np.float32)
    want, vjp = jax.vjp(lambda x: JL.bce_sigmoid_stable_elementwise(x, jnp.asarray(targets)),
                        jnp.asarray(logits))
    x = torch.tensor(logits, requires_grad=True)
    got = L.bce_sigmoid_stable_elementwise(x, torch.from_numpy(targets))
    got.backward(torch.from_numpy(g))
    assert np.isfinite(x.grad.numpy()).all()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
                               rtol=1e-6, atol=1e-8)


def test_source_discriminative_loss_value_and_grads():
    rng = RNG(2)
    feature = rng.standard_normal((2, 8, 8, 305)).astype(np.float32)
    pred = rng.uniform(size=(2, 8, 8, 2)).astype(np.float32)
    # centroids near the features' mean, so both hinge branches are active
    protos = [(0.05 * rng.standard_normal(305)).astype(np.float32) for _ in range(4)]
    jfn = lambda f, *c: JP.source_discriminative_loss(f, jnp.asarray(pred), JP.Prototypes(*c))
    want, jgrads = jax.value_and_grad(jfn, argnums=(0, 1, 2, 3, 4))(
        jnp.asarray(feature), *map(jnp.asarray, protos))
    f = torch.tensor(feature, requires_grad=True)
    cs = [torch.tensor(c, requires_grad=True) for c in protos]
    got = P.source_discriminative_loss(f, torch.from_numpy(pred), P.Prototypes(*cs))
    got.backward()
    assert got.item() > 0
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    for t, jg in zip([f] + cs, jgrads):
        scale = np.abs(np.asarray(jg)).max()
        assert scale > 0
        np.testing.assert_allclose(t.grad.numpy() / scale, np.asarray(jg) / scale, atol=1e-5)


@pytest.mark.parametrize("alpha", [0.0, 0.5, 0.99])
def test_weight_ema_matches_jax(alpha):
    rng = RNG(3)
    t0 = [rng.standard_normal(s).astype(np.float32) for s in ((4, 3), (5,))]
    s0 = [rng.standard_normal(s).astype(np.float32) for s in ((4, 3), (5,))]
    want = jax_optim.weight_ema([jnp.asarray(a) for a in t0], [jnp.asarray(a) for a in s0],
                                jnp.float32(alpha))
    mods = []
    for arrs in (t0, s0):
        m = torch.nn.Module()
        m.a, m.b = (torch.nn.Parameter(torch.from_numpy(a.copy())) for a in arrs)
        mods.append(m)
    optim_lib.weight_ema(mods[0], mods[1], alpha)
    for p, w in zip(mods[0].parameters(), want):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("epoch", [0, 30, 199, 200, 450])
def test_consistency_threshold_matches_jax(epoch):
    ramp = jnp.exp(-5.0 * jnp.square(1.0 - jnp.clip(jnp.float32(epoch), 0.0, 200.0) / 200.0))
    want = float((0.85 + 0.25 * ramp) * math.log(2.0))
    assert consistency_threshold(epoch) == pytest.approx(want, rel=1e-7)
