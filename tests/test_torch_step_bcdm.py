"""The port's ``bcdm`` step (uda_clr_tpu_torch/train/steps.py:make_bcdm_step)
against the JAX package's (uda_clr_tpu/train/steps.py:304-491): its two
losses at unit level, two iterations from the same JAX-initialised weights
(mobilenet, 64^2, B=2, dropout off, lr 1e-5; tests/torch_step_harness.py),
and a checkpoint that resumes bitwise. The Trainer runs a CPU step of it
in tests/test_torch_trainer.py::test_bcdm_and_remat_train_a_step.

Per iteration phase A steps the three Adam optimizers once, phase B
``cls1`` and ``cls2`` once and phase C ``fea`` four times: step counts fea
5, cls1 2, cls2 2."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_step_harness import (  # noqa: F401  (fixtures)
    BN_STATS,
    G_PARAMS,
    check_losses,
    check_model,
    check_params,
    close,
    dropout_off,
    get,
    make_batch,
    run_steps,
    two_threads,
)
from uda_clr_tpu.ops import losses as JL
from uda_clr_tpu.convert.torch_import import load_reference_checkpoint
from uda_clr_tpu_torch.config import Config
from uda_clr_tpu_torch.train import checkpoint as ckpt_lib
from uda_clr_tpu_torch.train.state import create_train_state
from uda_clr_tpu_torch.train.steps import (
    BCDM_TEMPERATURE,
    bcdm_seg_loss,
    discrepancy,
    make_train_step,
)
from uda_clr_tpu_torch.models.deeplab import DeepLabOutputs

# relative tolerance per iteration (measured value beside, margin >= 3x)
# (iteration 0 follows one Adam step of every parameter for cdd_before and
# five of the backbone's for cdd_after, each with its sign noise at lr)
# (On an AMD EPYC host iteration 0 reads loss_seg 6.9e-6 and loss_all
# 9.1e-6: there both frameworks' float32 losses lie 6.0e-3 from the port's
# float64 one, so the gap between them is float32 noise; measured before;
# measured on AMD EPYC.)
BCDM_RTOL = {
    "loss_seg": (2.5e-5, 7e-4),  # 5.0e-7, 2.3e-4; 6.9e-6, 6.5e-5
    "loss_all": (3e-5, 7e-4),  # 1.4e-6, 2.3e-4; 9.1e-6, 6.4e-5
    "loss_cdd_before": (1e-3, 1.4e-3),  # 3.0e-4, 4.6e-4
    "loss_cdd_after": (4e-3, 1.2e-3),  # 1.3e-3, 3.6e-4
}
# Phase B's discrepancy gradient is ~1e-2 of phase A's seg gradient, so
# its share of a classifier's Adam step is ~1e-3 lr, under the frameworks'
# float32 noise in the parameters. It shows in Adam's first moment (0.1 x
# the gradient) of the mask conv, where no train-mode norm amplifies that
# noise: held after the first iteration (measured <= 5.6e-4 of the largest
# entry; cls2 with phase B's gradient zeroed 2.4e-2, negated 4.8e-2).
MOMENT_RTOL = 2e-3


def test_discrepancy_and_tempered_seg_loss_equal_jax(two_threads):
    rng = np.random.default_rng(0)
    v1, v2 = (3 * rng.standard_normal((2, 16, 16, 2))).astype(np.float32), \
        (3 * rng.standard_normal((2, 16, 16, 2))).astype(np.float32)
    want = float(jnp.mean(jnp.abs(jax_sigmoid(v1) - jax_sigmoid(v2))))
    got = float(discrepancy(torch.from_numpy(v1), torch.from_numpy(v2)))
    assert abs(got - want) <= 1e-6 * abs(want)

    mask = (4 * rng.standard_normal((2, 16, 16, 2))).astype(np.float32)
    bnd = (2 * rng.standard_normal((2, 16, 16, 1))).astype(np.float32)
    map_s = (rng.uniform(size=(2, 16, 16, 2)) > 0.5).astype(np.float32)
    boundary_s = rng.uniform(size=(2, 16, 16, 1)).astype(np.float32)
    for temp in (1.0, BCDM_TEMPERATURE):
        # steps.py:401-404: BCE of the tempered mask logits + the untempered MSE
        want = float(JL.bce_sigmoid_stable(jnp.asarray(mask) / temp, jnp.asarray(map_s))
                     + JL.mse(jax_sigmoid(bnd), jnp.asarray(boundary_s)))
        outs = DeepLabOutputs(torch.from_numpy(mask), torch.from_numpy(bnd),
                              *([None] * 5))
        got = float(bcdm_seg_loss(outs, torch.from_numpy(map_s), torch.from_numpy(boundary_s),
                                  temp))
        assert abs(got - want) <= 1e-6 * abs(want), temp


def jax_sigmoid(x):
    import jax

    return jax.nn.sigmoid(jnp.asarray(x))


def _check_mask_conv_moments(it, jstate, state):
    """After the first iteration, Adam's moments of both classifiers' mask
    conv, which no train-mode norm separates from the losses."""
    if it != 0:
        return
    key, path = G_PARAMS[2]
    for name, model in (("cls1", state.gen), ("cls2", state.cls2)):
        mine = state.bcdm_opt[name].state[dict(model.named_parameters())[key]]
        theirs = jstate.bcdm_opt[name]
        for ours, tree in (("exp_avg", theirs.mu), ("exp_avg_sq", theirs.nu)):
            want = np.asarray(get(tree, path)).transpose(3, 2, 0, 1)
            close(mine[ours].numpy(), want, MOMENT_RTOL, f"{name} {key} {ours}")


def test_two_bcdm_iterations_match_jax(dropout_off, two_threads):
    jstate, state, history = run_steps("bcdm", (False, False), each=_check_mask_conv_moments)
    check_losses(history, BCDM_RTOL)
    # generator = backbone + classifier 1; the discriminators are built
    # (as JAX's state holds them) and never stepped
    check_params(jstate, state, (True, True))
    # the second classifier (ASPP + decoder) as the generator's heads (a
    # cls2 never stepped moves the median |diff| to ~lr)
    check_model(state.cls2.state_dict(), jstate.cls2_params, jstate.cls2_stats, "cls2",
                param_keys=G_PARAMS[1:], stats_keys=BN_STATS[1:])
    for name, per_iter in (("fea", 5), ("cls1", 2), ("cls2", 2)):
        assert int(jstate.bcdm_opt[name].count) == 2 * per_iter
        steps = {int(s["step"]) for s in state.bcdm_opt[name].state.values()}
        assert steps == {2 * per_iter}, (name, steps)


def _batch(seed):
    return {k: torch.from_numpy(v) for k, v in make_batch(np.random.default_rng(seed),
                                                          "bcdm").items()}


def test_checkpoint_resumes_bitwise(tmp_path, two_threads):
    """Save after one step, take a second; a fresh state restored from the
    checkpoint takes the same second step bit for bit (cls2 and the three
    Adam states included; dropout on, its generator restored)."""
    cfg = Config()
    step = make_train_step(cfg, "bcdm")
    state = create_train_state(cfg, seed=0, device="cpu", method="bcdm")
    state, _ = step(state, _batch(1), 1e-3, 2.5e-5)
    path = ckpt_lib.save_checkpoint(str(tmp_path), state, 0, 0.0, "checkpoint_1", iteration=0)
    ckpt = ckpt_lib.load_file(path)
    assert {"model_cls2_state_dict", "optim_fea_state_dict", "optim_cls1_state_dict",
            "optim_cls2_state_dict"} <= set(ckpt) and "optim_state_dict" not in ckpt
    # the generator stays where the JAX package's reader finds it
    assert "gen" in load_reference_checkpoint(path)
    state, want = step(state, _batch(2), 1e-3, 2.5e-5)

    fresh = create_train_state(cfg, seed=5, device="cpu", method="bcdm")
    fresh, _ = ckpt_lib.restore_checkpoint(str(tmp_path), "checkpoint_1", fresh)
    fresh, got = step(fresh, _batch(2), 1e-3, 2.5e-5)
    viz_got, viz_want = got.pop("_viz"), want.pop("_viz")
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for k in viz_want:  # the image-grid tiles too
        assert torch.equal(viz_got[k], viz_want[k]), k
    for a, b in ((state.gen, fresh.gen), (state.cls2, fresh.cls2)):
        for k, v in a.state_dict().items():
            assert torch.equal(b.state_dict()[k], v), k
    for name, opt in state.bcdm_opt.items():
        mine = fresh.bcdm_opt[name].state_dict()["state"]
        for i, s in opt.state_dict()["state"].items():
            for k in s:
                assert torch.equal(mine[i][k], s[k]), (name, i, k)
