"""The port's standalone MC forward (train/steps.py:mc_dropout_forward)
against the JAX package's ``steps._mc_dropout_forward`` (fast and slow,
under both norms, T=2, dropout off), the prototype-bank tool's
``compute_prototypes`` against JAX's (tools/cal_prototype.py) on the same
weights and synthetic batches, and the bank method's woTN configuration
(``norm='bn'``, ``bank_use_bu=False``, ``use_weight_rectify=True``,
``pseudo_from_initial=True``, with an initial model whose mask head is
negated, so reading the generator's heads instead would show) against JAX
``make_train_step``: two prototype-phase iterations, dropout off on both
sides. Harness and tolerances: tests/torch_step_harness.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_models import to_np
from tests.torch_step_harness import (  # noqa: F401
    check_losses,
    check_params,
    check_proto_bank,
    dropout_off,
    random_bank,
    run_steps,
    two_threads,
)
from uda_clr_tpu.models.deeplab import DeepLab as JaxDeepLab
from uda_clr_tpu.tools.cal_prototype import compute_prototypes as jax_compute_prototypes
from uda_clr_tpu.train.steps import _mc_dropout_forward
from uda_clr_tpu_torch.convert.from_jax import deeplab_state_dict
from uda_clr_tpu_torch.data.pipeline import BatchLoader
from uda_clr_tpu_torch.data.synthetic import SyntheticFundus
from uda_clr_tpu_torch.data.transforms import eval_transforms
from uda_clr_tpu_torch.models.deeplab import DeepLab
from uda_clr_tpu_torch.tools.cal_prototype import compute_prototypes
from uda_clr_tpu_torch.train.steps import mc_dropout_forward

pytestmark = pytest.mark.usefixtures("two_threads")

B, SIZE, T = 2, 64, 2


def _variables(norm: str):
    """JAX DeepLab variables (init traced as one program) with random norm
    affines and, for plain BN, random running stats; mask_out x10 spreads
    the logits across the thresholds."""
    model = JaxDeepLab(num_classes=2, backbone="mobilenet", output_stride=16, norm=norm)
    v = jax.jit(lambda k: model.init(k, jnp.zeros((1, SIZE, SIZE, 3)), train=False))(
        jax.random.PRNGKey(3))
    params, stats = to_np(v["params"]), to_np(v["batch_stats"])
    rng = np.random.default_rng(3)

    def walk(p, s):
        for k, node in p.items():
            if isinstance(node, dict) and "scale" in node:
                c = node["scale"].shape[0]
                node["scale"] = (1.0 + 0.2 * rng.standard_normal(c)).astype(np.float32)
                node["bias"] = (0.2 * rng.standard_normal(c)).astype(np.float32)
                for sk in s[k]:
                    s[k][sk] = (rng.uniform(0.5, 1.5, c) if sk.startswith("var")
                                else 0.1 * rng.standard_normal(c)).astype(np.float32)
            elif isinstance(node, dict):
                walk(node, s.get(k, {}))

    walk(params, stats)
    params["decoder"]["mask_out"]["conv"]["kernel"] *= 10.0
    gen = DeepLab(norm=norm)
    gen.load_state_dict(deeplab_state_dict(params, stats))
    return model, params, stats, gen


@pytest.fixture(scope="module", params=["bn", "tn"])
def variables(request):
    return request.param, _variables(request.param)


@pytest.mark.parametrize("fast", [True, False])
def test_mc_dropout_forward_matches_jax(dropout_off, variables, fast):
    norm, (model, params, stats, gen) = variables
    x = np.random.default_rng(5).standard_normal((B, SIZE, SIZE, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, s, xx: _mc_dropout_forward(
        model, p, s, xx, jax.random.PRNGKey(0), T, fast=fast, rng_impl="threefry"))(
        params, stats, x))
    before = {k: v.clone() for k, v in gen.state_dict().items()}
    got = mc_dropout_forward(gen, torch.from_numpy(x), T, fast, None, 0).numpy()
    assert got.shape == want.shape == (T, B, SIZE, SIZE, 2)
    # float32 convolutions and batch moments over few pixels, in another
    # order (measured: bn fast 4.4e-4, slow 2.0e-4; tn fast 2.1e-4, slow 1.5e-4)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= 1.5e-3, f"{norm} fast={fast}: max diff {err:.2e} of the largest logit"
    for k, v in gen.state_dict().items():  # no running-stat writes
        assert torch.equal(v, before[k]), k
    if not fast:  # dropout off: the slow pass equals the fast one (the twin;
        # measured 9.7e-5 of the largest logit under bn, 3.0e-7 under tn)
        fast_out = mc_dropout_forward(gen, torch.from_numpy(x), T, True, None, 0).numpy()
        assert np.abs(fast_out - got).max() <= 5e-4 * np.abs(got).max()


def test_compute_prototypes_matches_jax():
    model, params, stats, gen = _variables("bn")
    ds = SyntheticFundus(4, SIZE + 28, transform=eval_transforms(SIZE))
    batches = list(BatchLoader(ds, 2, shuffle=False, drop_last=False, num_workers=1).epoch(0))
    got = compute_prototypes(gen, batches)
    want = jax_compute_prototypes(model, {"params": params, "batch_stats": stats},
                                  [{"image": jnp.asarray(b["image"])} for b in batches])
    for k, n in (("bu", 304), ("cup", 305), ("disc", 305)):
        assert got[k].shape == (n,) and got[k].dtype == np.float32
        assert np.abs(got[k]).max() > 0, k
        # eval forwards of two frameworks: relative to the largest entry
        # (measured 3.4e-6 bu, 3.9e-6 cup, 1.4e-6 disc)
        err = np.abs(got[k] - np.asarray(want[k])).max() / np.abs(np.asarray(want[k])).max()
        assert err <= 1.5e-5, f"{k}: {err:.2e}"


def _wotn_start(jstate):
    """A random bank, and an initial model that differs from the generator:
    its mask head is negated, so its pseudo-labels are the complement."""
    jstate = random_bank(jstate)
    params = to_np(jstate.gen_params)
    params["decoder"]["mask_out"]["conv"]["kernel"] *= -1.0
    params["decoder"]["mask_out"]["conv"]["bias"] *= -1.0
    return jstate.replace(initial_params=jax.tree.map(jnp.asarray, params),
                          initial_stats=jax.tree.map(jnp.copy, jstate.gen_stats))


def _wotn(m):
    m.bank_use_bu = False
    m.use_weight_rectify = True
    m.pseudo_from_initial = True


def test_prototype_bank_wotn_matches_jax(dropout_off):
    jstate, state, history = run_steps("prototype", (True, True), _wotn, prepare=_wotn_start)
    assert {"loss_cup", "loss_disc"} <= set(history[0][0]) and "loss_bu" not in history[0][0]
    check_losses(history)
    check_params(jstate, state, discriminators=(True, True))
    check_proto_bank(jstate, state, 1e-5)  # measured 2.3e-6
    # bank_use_bu=False pools no target bu prototype: the bu vector stays
    np.testing.assert_array_equal(state.proto_bank["bu"].numpy(),
                                  np.asarray(random_bank(jstate).proto_bank["bu"]))
    # the initial model is frozen: never updated
    for k, v in deeplab_state_dict(to_np(jstate.initial_params),
                                   to_np(jstate.initial_stats)).items():
        assert torch.equal(state.initial.state_dict()[k], v), k
