"""The slice as a whole: the port's flagship ``prototype_full`` train step
(uda_clr_tpu_torch/train/steps.py) against the JAX package's
``make_train_step``, from the same JAX-initialised weights carried over by
the weight bridge.

Two prototype-phase iterations (MC-rectified pseudo-labels, global EMA
banks), then one warmup iteration, with dropout off on both sides: the two
frameworks' random streams cannot coincide, and with dropout off every
remaining quantity is deterministic while batch norm stays in train mode.
The mask logits are spread (mask_out x10) so that sigmoid(mask_before)
straddles the 0.75 pseudo-label threshold, as tests/test_step_parity.py
does.

Tolerances were measured on this test's inputs (torch 2.13 CPU, jax 0.9
CPU at matmul precision 'highest') and set with a margin of at least 3x;
the measured values stand beside each. Iteration 0 is float32 noise over
~60 batch norms. From iteration 1 on, each state inherits Adam's first
steps: their size is lr wherever a gradient is nonzero, and their sign is
noise where the true gradient is ~0 (the biases of batch norms that feed
another batch norm; tests/test_step_parity.py:115-121), so lr_gen is 1e-5
and the G params are held by the median of their difference in units of
lr (a missing or wrong update moves the median to ~lr).

The first iteration is also run by the port in two gloo ranks (one source
and one target image each, tests/torch_dp_ranks.py) and held to the same
JAX step with the same tolerances: data parallelism's global moments,
pools and averaged gradients against JAX's single-device step. It is run
once more on the ``('data', 'space')`` mesh ``(1, 2)``: two ranks, each
with the top or bottom half of every image, their halo exchanges against
JAX's single-device step at the same tolerances. The JAX iterations run
once for the file."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_dp_ranks as dp
from tests.test_torch_models import to_np
from tests.torch_step_harness import check_viz, jax_train_state, two_threads  # noqa: F401
from uda_clr_tpu.config import Config as JaxConfig
from uda_clr_tpu.models import layers as jax_layers
from uda_clr_tpu.models.deeplab import DeepLab as JaxDeepLab
from uda_clr_tpu.train.steps import make_train_step as jax_make_train_step
from uda_clr_tpu_torch.config import Config
from uda_clr_tpu_torch.convert.from_jax import deeplab_state_dict, discriminator_state_dict
from uda_clr_tpu_torch.models import layers as port_layers
from uda_clr_tpu_torch.train.state import create_train_state
from uda_clr_tpu_torch.train.steps import make_train_step

# two torch threads: at one per core the port's CPU work and XLA's threads
# contend in one process (a port step took ~10 s instead of ~0.3 s)
pytestmark = pytest.mark.usefixtures("two_threads")


B, SIZE, T = 2, 64, 4
LR_GEN, LR_DIS = 1e-5, 2.5e-5
LOSSES = ("loss_seg", "loss_adv", "loss_all", "loss_D", "loss_D2")
PROTO_LOSSES = ("loss_intra", "loss_inter")

# per iteration: relative on the losses (measured max 6.2e-6, 8.8e-4,
# 3.2e-3), relative on the prototype losses (4.1e-5, 2.0e-3), absolute on
# the banks, whose entries are <= ~1 (1.2e-4, 1.4e-2: a few target pixels
# cross the hard pseudo-label thresholds after the first update)
LOSS_RTOL = (2e-5, 3e-3, 1e-2)
PROTO_LOSS_RTOL = (2e-4, 1e-2)
BANK_ATOL = (4e-4, 5e-2)
# after the three iterations, relative to each tensor's largest entry
PARAM_MEDIAN_LR = 0.2  # G params: median |diff| / lr (measured <= 0.045)
PARAM_RTOL = 1e-3  # G params (measured <= 3.0e-4)
STATS_RTOL = 6e-3  # BN running stats (measured <= 1.9e-3)
DIS_RTOL = 1e-6  # D params after SGD (measured <= 2.6e-7)

G_PARAMS = (
    ("backbone.features.0.0.weight", ("backbone", "stem", "conv", "kernel")),
    ("aspp.conv1.weight", ("aspp", "proj_conv", "conv", "kernel")),
    ("decoder.last_conv.3.weight", ("decoder", "mask_out", "conv", "kernel")),
    ("decoder.last_conv_boundary.4.weight", ("decoder", "bound_conv2", "conv", "kernel")),
)
BN_STATS = (
    ("backbone.features.0.1", ("backbone", "stem_bn")),
    ("aspp.bn1", ("aspp", "proj_bn")),
    ("decoder.last_conv.0", ("decoder", "mask_bn")),
    ("decoder.last_conv_boundary.1", ("decoder", "bound_bn1")),
)


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _batch(rng):
    return {
        "image_s": rng.standard_normal((B, SIZE, SIZE, 3)).astype(np.float32),
        "map_s": (rng.uniform(0, 1, (B, SIZE, SIZE, 2)) > 0.5).astype(np.float32),
        "boundary_s": rng.uniform(0, 1, (B, SIZE, SIZE, 1)).astype(np.float32),
        "image_t": rng.standard_normal((B, SIZE, SIZE, 3)).astype(np.float32),
    }


@pytest.fixture()
def dropout_off():
    prev = jax_layers._DROPOUT_IMPL, port_layers.dropout_impl()
    jax_layers.set_dropout_impl("off")
    port_layers.set_dropout_impl("off")
    yield
    jax_layers.set_dropout_impl(prev[0])
    port_layers.set_dropout_impl(prev[1])


PHASES = (True, True, False)  # prototype phase per iteration


@pytest.fixture(scope="module")
def jax_run():
    """The JAX steps, once for the file: the converted port state_dicts of
    the start, and per iteration its batch, metrics and state after."""
    prev = jax_layers._DROPOUT_IMPL
    jax_layers.set_dropout_impl("off")
    try:
        jcfg = JaxConfig()
        jcfg.model.compute_dtype = "float32"
        jcfg.method.mc_samples = T
        jcfg.method.rng_impl = "threefry2x32"  # rbg keys are TPU-only
        model = JaxDeepLab(num_classes=2, backbone="mobilenet", output_stride=16, norm="bn")
        jstate = jax_train_state(model)
        params = to_np(jstate.gen_params)
        params["decoder"]["mask_out"]["conv"]["kernel"] *= 10.0
        jstate = jstate.replace(gen_params=jax.tree.map(jnp.asarray, params))
        start = dict(gen_state_dict=deeplab_state_dict(params, to_np(jstate.gen_stats)),
                     dis_state_dict=discriminator_state_dict(to_np(jstate.dis_params)),
                     dis2_state_dict=discriminator_state_dict(to_np(jstate.dis2_params)))
        rng = np.random.default_rng(7)
        iterations = []
        for proto in PHASES:
            batch = _batch(rng)
            jstate, want = jax_make_train_step(model, jcfg, "prototype_full", proto_phase=proto)(
                jstate, {k: jnp.asarray(v) for k, v in batch.items()}, LR_GEN, LR_DIS, 30)
            # host copies: the next step donates this state's buffers
            iterations.append((batch, jax.device_get(want), jax.device_get(jstate)))
    finally:
        jax_layers.set_dropout_impl(prev)
    return start, iterations


def _check_losses(got, want, it, proto):
    assert set(got) == set(LOSSES + (PROTO_LOSSES if proto else ()))
    for k in LOSSES:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=LOSS_RTOL[it],
                                   err_msg=f"iter {it}: {k}")
    for k in PROTO_LOSSES if proto else ():
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=PROTO_LOSS_RTOL[it],
                                   err_msg=f"iter {it}: {k}")


def _check_banks(banks, jstate, it):
    for name in ("proto_src", "proto_trg"):
        np.testing.assert_allclose(banks[name].numpy(), np.asarray(getattr(jstate, name)),
                                   rtol=0, atol=BANK_ATOL[it], err_msg=f"iter {it}: {name}")


def _close(got, want, rtol, what):
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= rtol, f"{what}: max diff {err:.2e} of the largest entry > {rtol}"


def _check_params(sd, jstate):
    for key, path in G_PARAMS:
        want = np.asarray(_get(jstate.gen_params, path)).transpose(3, 2, 0, 1)
        _close(sd[key].numpy(), want, PARAM_RTOL, key)
        median = np.median(np.abs(sd[key].numpy() - want)) / LR_GEN
        assert median <= PARAM_MEDIAN_LR, f"{key}: median diff {median:.3f} lr"
    for key, path in BN_STATS:
        node = _get(jstate.gen_stats, path)
        for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
            _close(sd[f"{key}.{ours}"].numpy(), np.asarray(node[theirs]), STATS_RTOL,
                   f"{key}.{ours}")


def test_prototype_full_steps_match_jax(dropout_off, jax_run):
    start, iterations = jax_run
    cfg = Config()
    cfg.method.mc_samples = T
    state = create_train_state(cfg, seed=0, device="cpu", **start)

    for it, (proto, (batch, want, jstate)) in enumerate(zip(PHASES, iterations)):
        state, got = make_train_step(cfg, "prototype_full", proto_phase=proto)(
            state, {k: torch.from_numpy(v) for k, v in batch.items()}, LR_GEN, LR_DIS)

        check_viz(got.pop("_viz"), want["_viz"], it)
        _check_losses(got, want, it, proto)
        if proto:
            _check_banks({"proto_src": state.proto_src, "proto_trg": state.proto_trg}, jstate, it)
            assert bool(state.proto_src_init) and bool(jstate.proto_src_init)
    assert state.step == int(jstate.step) == 3

    _check_params(state.gen.state_dict(), jstate)
    for dis, jparams in ((state.dis, jstate.dis_params), (state.dis2, jstate.dis2_params)):
        for i in (1, 5):
            want = np.asarray(_get(jparams, (f"conv{i}", "conv", "kernel"))).transpose(3, 2, 0, 1)
            _close(getattr(dis, f"conv{i}").weight.detach().numpy(), want, DIS_RTOL, f"conv{i}")


def test_two_ranks_first_iteration_matches_jax(jax_run, tmp_path):
    """Two gloo ranks, each with one source and one target image, against
    JAX's single-device step on both: the losses, the banks, the G params
    and running stats after the step, at iteration 0's tolerances."""
    start, iterations = jax_run
    batch, want, jstate = iterations[0]
    ranks = dp.spawn(dp.flagship_step, tmp_path, (start, batch, T, LR_GEN, LR_DIS))
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    _check_losses(ranks[0]["metrics"], want, 0, True)
    _check_banks(ranks[0]["banks"], jstate, 0)
    _check_params(ranks[0]["gen"], jstate)


def test_spatial_ranks_first_iteration_matches_jax(jax_run, tmp_path):
    """Two gloo ranks on the ``(1, 2)`` mesh, each with one half of the rows
    of every image of the batch, against JAX's single-device step: the
    losses, the banks, the G params and running stats after the step, at
    iteration 0's tolerances."""
    start, iterations = jax_run
    batch, want, jstate = iterations[0]
    ranks = dp.spawn(dp.flagship_step, tmp_path, (start, batch, T, LR_GEN, LR_DIS, 2))
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    _check_losses(ranks[0]["metrics"], want, 0, True)
    _check_banks(ranks[0]["banks"], jstate, 0)
    _check_params(ranks[0]["gen"], jstate)
