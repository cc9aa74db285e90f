"""The port's ops and optimizers (uda_clr_tpu_torch/ops, train/optim.py)
against the JAX package's, on shared inputs made with numpy.

Tolerances: 1e-6 relative on elementwise losses and their gradients (the
same float32 formulas); 1e-5 on the prototype centroids, whose sums over
(B, h, w) run in another order; the retrify masks, being hard thresholds,
must agree exactly; 1e-5 absolute on the bilinear resize (torch computes
the tap weights in float32, the JAX package in float64 then rounds);
1e-6 relative on two optimizer steps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from uda_clr_tpu.ops import losses as JL
from uda_clr_tpu.ops import prototypes as JP
from uda_clr_tpu.ops.resize import resize_bilinear_align_corners as jax_bilinear
from uda_clr_tpu.ops.resize import resize_nearest as jax_nearest
from uda_clr_tpu.train import optim as jax_optim
from uda_clr_tpu_torch.config import OptimConfig
from uda_clr_tpu_torch.ops import losses as L
from uda_clr_tpu_torch.ops import prototypes as P
from uda_clr_tpu_torch.ops.resize import resize_bilinear_align_corners, resize_nearest
from uda_clr_tpu_torch.train import optim as optim_lib
from tests.torch_step_harness import two_threads  # noqa: F401  (fixture)

# two torch threads: at one per core the port's CPU work and XLA's threads
# contend in one process (a port step took ~10 s instead of ~0.3 s)
pytestmark = pytest.mark.usefixtures("two_threads")


RNG = np.random.default_rng


def _t(x, grad=False):
    return torch.tensor(np.asarray(x), requires_grad=grad)


def _logits_and_targets(seed):
    rng = RNG(seed)
    logits = (4.0 * rng.standard_normal((2, 8, 8, 2))).astype(np.float32)
    # saturated logits: float32 sigmoid rounds to exactly 1 (or 0) there
    logits[0, 0, 0] = [17.5, 40.0]
    logits[0, 0, 1] = [-20.0, -120.0]
    targets = (rng.uniform(size=logits.shape) > 0.5).astype(np.float32)
    return logits, targets


@pytest.mark.parametrize("name", ["bce_sigmoid_stable", "bce_with_logits", "mse"])
def test_loss_values_and_grads(name):
    logits, targets = _logits_and_targets(1)
    if name == "mse":
        targets = RNG(2).uniform(size=logits.shape).astype(np.float32)
    jfn, tfn = getattr(JL, name), getattr(L, name)
    want, jgrad = jax.value_and_grad(lambda x: jfn(x, jnp.asarray(targets)))(jnp.asarray(logits))
    x = _t(logits, grad=True)
    got = tfn(x, _t(targets))
    got.backward()
    assert np.isfinite(x.grad.numpy()).all()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), rtol=1e-6, atol=1e-10)


def test_entropy_map_values_and_grads():
    logits, _ = _logits_and_targets(3)
    want, vjp = jax.vjp(JL.entropy_map, jnp.asarray(logits))
    g = RNG(4).standard_normal(logits.shape).astype(np.float32)
    x = _t(logits, grad=True)
    got = L.entropy_map(x)
    got.backward(_t(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
                               rtol=1e-5, atol=1e-7)


def _proto_inputs(seed):
    rng = RNG(seed)
    b, h, w, c, t = 2, 8, 8, 305, 4
    feature = rng.standard_normal((b, h, w, c)).astype(np.float32)
    pred = rng.uniform(size=(b, h, w, 2)).astype(np.float32)
    mask_before = (3.0 * rng.standard_normal((b, h, w, 2))).astype(np.float32)
    # MC logits whose per-pixel spread straddles the std<0.04 threshold
    base = rng.standard_normal((1, b, 4 * h, 4 * w, 2))
    spread = rng.uniform(0.0, 0.6, (1, b, 4 * h, 4 * w, 2))
    mc = (base + spread * rng.standard_normal((t, b, 4 * h, 4 * w, 2))).astype(np.float32)
    return feature, pred, mask_before, mc


def test_gen_prototype_matches_jax():
    feature, pred, _, _ = _proto_inputs(5)
    want = JP.gen_prototype(jnp.asarray(pred), jnp.asarray(feature))
    got = P.gen_prototype(_t(pred), _t(feature))
    for name, g, w in zip(P.Prototypes._fields, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6, err_msg=name)


def test_gen_prototype_retrify_matches_jax():
    feature, _, mask_before, mc = _proto_inputs(6)
    want = JP.gen_prototype_retrify(jnp.asarray(mask_before), jnp.asarray(feature),
                                    jnp.asarray(mc), 0.75, 0.04)
    got = P.gen_prototype_retrify(_t(mask_before), _t(feature), _t(mc), 0.75, 0.04)
    conf = np.asarray(want.conf_mask)
    assert 0.05 < conf.mean() < 0.95  # both sides of the threshold are exercised
    np.testing.assert_array_equal(got.conf_mask.numpy(), conf)
    np.testing.assert_allclose(got.std_map.numpy(), np.asarray(want.std_map), rtol=1e-5, atol=1e-7)
    for name, g, w in zip(P.Prototypes._fields, got.prototypes, want.prototypes):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6, err_msg=name)


def test_prototype_losses_match_jax():
    rng = RNG(7)
    src = [rng.standard_normal(305).astype(np.float32) for _ in range(4)]
    trg = [rng.standard_normal(305).astype(np.float32) for _ in range(4)]
    js, jt = JP.Prototypes(*map(jnp.asarray, src)), JP.Prototypes(*map(jnp.asarray, trg))
    ps, pt = P.Prototypes(*map(_t, src)), P.Prototypes(*map(_t, trg))
    np.testing.assert_allclose(P.intra_domain_loss(ps, pt).item(),
                               float(JP.intra_domain_loss(js, jt)), rtol=1e-6)
    np.testing.assert_allclose(P.inter_domain_loss(ps).item(),
                               float(JP.inter_domain_loss(js)), rtol=1e-6)
    stacked = P.Prototypes.unstack(ps.stack())
    assert all(torch.equal(a, b) for a, b in zip(stacked, ps))


@pytest.mark.parametrize("in_hw,out_hw", [((4, 4), (16, 16)), ((16, 16), (64, 64)),
                                          ((1, 1), (4, 4)), ((8, 8), (8, 8))])
def test_bilinear_align_corners_matches_jax(in_hw, out_hw):
    x = RNG(8).standard_normal((2, *in_hw, 3)).astype(np.float32)
    want = np.asarray(jax_bilinear(jnp.asarray(x), out_hw))
    got = resize_bilinear_align_corners(_t(x).permute(0, 3, 1, 2), out_hw).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("in_hw,out_hw", [((64, 64), (16, 16)), ((512, 512), (128, 128)),
                                          ((10, 7), (4, 3))])
def test_nearest_matches_jax_and_torch_nearest(in_hw, out_hw):
    x = RNG(9).standard_normal((2, *in_hw, 2)).astype(np.float32)
    want = np.asarray(jax_nearest(jnp.asarray(x), out_hw))
    nchw = _t(x).permute(0, 3, 1, 2)
    got = resize_nearest(nchw, out_hw)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    # torch's 'nearest' is the same floor(i * in / out) rule; 'nearest-exact' is not
    np.testing.assert_array_equal(F.interpolate(nchw, size=out_hw, mode="nearest").numpy(),
                                  got.numpy())


def _one_step(make_opt, jax_tx, lr):
    rng = RNG(10)
    p0 = rng.standard_normal((5, 3)).astype(np.float32)
    grads = [rng.standard_normal((5, 3)).astype(np.float32) for _ in range(2)]
    params = jnp.asarray(p0)
    opt_state = jax_tx.init(params)
    p = torch.nn.Parameter(_t(p0))
    opt = make_opt([p])
    optim_lib.set_lr(opt, lr)
    for g in grads:
        upd, opt_state = jax_tx.update(jnp.asarray(g), opt_state, params)
        params = jax_optim.apply_updates(params, upd, lr)
        p.grad = _t(g)
        opt.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(params), rtol=1e-6, atol=1e-7)


def test_adam_matches_jax():
    cfg = OptimConfig()
    _one_step(lambda ps: optim_lib.make_gen_optimizer(ps, cfg),
              jax_optim.adam_direction(cfg.adam_b1, cfg.adam_b2), 1e-3)


def test_sgd_matches_jax():
    cfg = OptimConfig()
    _one_step(lambda ps: optim_lib.make_dis_optimizer(ps, cfg),
              jax_optim.sgd_direction(cfg.sgd_momentum, cfg.weight_decay), 2.5e-5)


@pytest.mark.parametrize("epoch", [0, 99, 100, 250, 499])
def test_gen_lr_schedule_matches_jax(epoch):
    assert optim_lib.gen_lr_schedule(epoch, 1e-3) == jax_optim.gen_lr_schedule(epoch, 1e-3)
