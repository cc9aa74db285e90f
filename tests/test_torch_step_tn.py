"""TransNorm in the port (uda_clr_tpu_torch/models/norm.py, mode 'tn')
against the JAX package's ``DomainNorm2d(mode='tn')`` in every mode, its
buffers through the checkpoint and the weight bridge, and the flagship
``prototype_full`` step under ``norm='tn'`` (the standalone fast MC forward
with the degenerate TransNorm prefix and K1's doubled coefficients) against
JAX ``make_train_step``: two prototype-phase iterations from the same
weights and batches, dropout off on both sides. Harness and tolerances:
tests/torch_step_harness.py."""

import jax
import numpy as np
import pytest
import torch

from tests.torch_step_harness import (  # noqa: F401
    TN_RTOL,
    TN_STATS_RTOL,
    check_banks,
    check_losses,
    check_params,
    dropout_off,
    run_steps,
    two_threads,
)
from uda_clr_tpu.convert.torch_import import load_reference_checkpoint
from uda_clr_tpu.models.norm import DomainNorm2d as JaxDomainNorm2d
from uda_clr_tpu_torch.config import Config
from uda_clr_tpu_torch.convert.from_jax import deeplab_state_dict
from uda_clr_tpu_torch.models.norm import DomainNorm2d
from uda_clr_tpu_torch.train import checkpoint as ckpt_lib
from uda_clr_tpu_torch.train.state import create_train_state

pytestmark = pytest.mark.usefixtures("two_threads")

C = 7
TN_KEYS = ("mean_source", "var_source", "mean_target", "var_target")


def _tn_inputs(batch: int, seed: int = 1):
    """An NHWC batch whose halves differ (so alpha differs from 1), random
    affine params and running stats."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((batch, 5, 6, C)) * 2 + 0.5).astype(np.float32)
    x[batch // 2:] = x[batch // 2:] * 1.7 - 0.8
    params = {"scale": rng.standard_normal(C).astype(np.float32),
              "bias": rng.standard_normal(C).astype(np.float32)}
    stats = {k: (rng.uniform(0.5, 2, C) if k.startswith("var") else rng.standard_normal(C))
             .astype(np.float32) for k in TN_KEYS}
    return x, params, stats


def _port_tn(params, stats) -> DomainNorm2d:
    m = DomainNorm2d(C, mode="tn")
    sd = {"weight": params["scale"], "bias": params["bias"]}
    sd.update({f"running_{k}": v for k, v in stats.items()})
    m.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return m


# (train, domains, batch): the even split (TransNorm ignores domains), the
# reference's uneven split of an odd batch, the MC pass's degenerate mode
# and eval mode (target stats, alpha from the running stats)
@pytest.mark.parametrize("train,domains,batch", [
    (True, 2, 4), (True, 1, 4), (True, 2, 5), (True, 0, 4), (False, 1, 4)])
def test_transnorm_matches_jax(train, domains, batch):
    x, params, stats = _tn_inputs(batch)
    want, upd = JaxDomainNorm2d(C, mode="tn").apply(
        {"params": params, "batch_stats": stats}, x, train, domains, mutable=["batch_stats"])
    m = _port_tn(params, stats)
    got = m(torch.from_numpy(x).permute(0, 3, 1, 2), train, domains).permute(0, 2, 3, 1)
    # float32 moments and rsqrt in another order (measured <= 2.9e-6 absolute)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    for k in TN_KEYS:  # the EMA of both domains' buffers (measured <= 4.8e-7)
        np.testing.assert_allclose(getattr(m, f"running_{k}").numpy(),
                                   np.asarray(upd["batch_stats"][k]), rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    if not train or domains == 0:  # neither writes stats
        for k in TN_KEYS:
            np.testing.assert_array_equal(getattr(m, f"running_{k}").numpy(), stats[k])


def test_transnorm_gradients_match_jax():
    """Gradients through TransNorm (alpha detached on both sides) for the
    input and the affine params."""
    x, params, stats = _tn_inputs(4, seed=2)
    r = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)
    norm = JaxDomainNorm2d(C, mode="tn")

    def loss(p, xx):
        out, _ = norm.apply({"params": p, "batch_stats": stats}, xx, True, 2,
                            mutable=["batch_stats"])
        return (out * r).sum()

    g_p, g_x = jax.grad(loss, argnums=(0, 1))(params, x)
    m = _port_tn(params, stats)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    (m(xt, True, 2).permute(0, 2, 3, 1) * torch.from_numpy(r)).sum().backward()
    # float32 sums in another order (measured <= 4.5e-7 of the largest entry)
    for got, want in ((xt.grad.permute(0, 2, 3, 1), g_x), (m.weight.grad, g_p["scale"]),
                      (m.bias.grad, g_p["bias"])):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 2e-5 * np.abs(want).max()


def test_frozen_stats_covers_transnorm():
    from uda_clr_tpu_torch.models.norm import frozen_stats

    x, params, stats = _tn_inputs(4)
    m = _port_tn(params, stats)
    with frozen_stats(m):
        m(torch.from_numpy(x).permute(0, 3, 1, 2), True, 2)
    for k in TN_KEYS:
        np.testing.assert_array_equal(getattr(m, f"running_{k}").numpy(), stats[k])


def test_transnorm_checkpoint_is_read_by_jax(tmp_path):
    """A TN port checkpoint: the reference's buffer names in
    model_state_dict, read by JAX ``load_reference_checkpoint`` into the TN
    batch-stats tree, and carried back by the weight bridge unchanged."""
    cfg = Config()
    cfg.model.norm = "tn"
    state = create_train_state(cfg, seed=0, device="cpu", method="prototype_full")
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for name, buf in state.gen.named_buffers():
            buf.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, buf.shape).astype(np.float32)))
    sd = state.gen.state_dict()
    assert "backbone.features.0.1.running_mean_source" in sd
    assert not any(k.endswith(("running_mean", "running_var")) for k in sd)
    path = ckpt_lib.save_checkpoint(str(tmp_path), state, 0, 0.5, "checkpoint_1")
    conv = load_reference_checkpoint(path)
    params, stats = conv["gen"]
    for key, tree in (("backbone.features.0.1", stats["backbone"]["stem_bn"]),
                      ("decoder.last_conv.0", stats["decoder"]["mask_bn"]),
                      ("aspp.global_avg_pool.2", stats["aspp"]["gap_bn"])):
        assert set(tree) == set(TN_KEYS)
        for k in TN_KEYS:
            np.testing.assert_array_equal(tree[k], sd[f"{key}.running_{k}"].numpy())
    back = deeplab_state_dict(params, stats)
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_prototype_full_tn_matches_jax(dropout_off):
    jstate, state, history = run_steps("prototype_full", (True, True), norm="tn")
    assert {"loss_intra", "loss_inter"} <= set(history[0][0])
    check_losses(history, TN_RTOL)
    check_params(jstate, state, discriminators=(True, True), stats_rtol=TN_STATS_RTOL)
    check_banks(jstate, state, 8e-2)  # measured 2.2e-2: target pixels cross the thresholds
