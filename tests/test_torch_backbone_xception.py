"""The port's Aligned Xception DeepLab (uda_clr_tpu_torch/models/xception.py)
against the JAX package's, from the same JAX-initialised weights (norms
perturbed) carried over by the weight bridge, dropout off, at B=2 and 64^2:
the bridge round trip, train mode with ``domains=2`` (outputs, running
stats, gradients), eval mode (outputs, gradients) and each kind of Block
alone in train mode.

Tolerances (tests/torch_step_harness.py:check_backbone) stand beside each
with the value measured on these inputs (torch 2.13 CPU, jax 0.9 CPU at
matmul precision 'highest'), with a margin of at least 3x. In train mode
every norm normalises one image per domain, so float32 rounding is
amplified layer by layer and the gradients carry a noise floor (as
ROADMAP.md notes for mobilenet; it stays at B=4 with ``domains=1``), so
the train-mode backward is also held tightly on each kind of Block alone; eval
mode has no such amplification, and there the gradients are held tightly,
except where relu kinks of activations that reach ~1e6 from these random
weights and statistics flip."""

import jax
import numpy as np
import pytest

from tests.torch_step_harness import (  # noqa: F401  (fixtures)
    B,
    backbone_errors,
    block_errors,
    check_backbone,
    check_block,
    dropout_off,
    jax_deeplab,
    two_threads,
)
from uda_clr_tpu.convert.torch_import import convert_deeplab_state_dict
from uda_clr_tpu.models.xception import XceptionBlock as JaxBlock
from uda_clr_tpu_torch.convert.from_jax import _xception_block, deeplab_state_dict
from uda_clr_tpu_torch.models.deeplab import DeepLab
from uda_clr_tpu_torch.models.xception import Block

BACKBONE = "xception"

TRAIN_TOL = {
    "outputs": 1.5e-3,  # 4.5e-4
    "stats": 1.5e-4,  # 4.6e-5
    # (largest over the group, median over its tensors): the noise floor
    "grads": {"backbone": (0.1, 0.11),  # 0.032, 0.034
              "aspp": (0.3, 0.07),  # 0.096, 0.022
              "decoder": (0.07, 0.06)},  # 0.023, 0.020
}
EVAL_TOL = {
    "outputs": 3.5e-5,  # 1.0e-5
    "stats": 0.0,  # eval mode writes nothing
    "grads": {"backbone": (1.5e-5, 1e-5),  # 4.9e-6, 3.2e-6
              "aspp": (1.6e-5, 1.1e-5),  # 5.2e-6, 3.5e-6
              "decoder": (2e-5, 5e-6)},  # 6.1e-6, 1.4e-6
}


@pytest.fixture(scope="module")
def jax_model():
    return jax_deeplab(BACKBONE, 16)


def test_bridge_round_trip(jax_model):
    """JAX variables -> the port's state_dict -> the JAX package's own
    converter -> the original trees bit for bit; the port's module takes
    the state_dict strictly."""
    _, params, stats = jax_model
    sd = deeplab_state_dict(params, stats)
    DeepLab(backbone=BACKBONE).load_state_dict(sd)
    back_p, back_s = convert_deeplab_state_dict({k: v.numpy() for k, v in sd.items()})
    flat = lambda t: {jax.tree_util.keystr(k): np.asarray(v)
                      for k, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    for want, got in ((params, back_p), (stats, back_s)):
        fw, fg = flat(want), flat(got)
        assert fw.keys() == fg.keys()
        for k in fw:
            np.testing.assert_array_equal(fg[k], fw[k], err_msg=k)


@pytest.mark.parametrize("train", [True, False])
def test_against_jax(jax_model, dropout_off, two_threads, train):
    model, params, stats = jax_model
    res = backbone_errors(model, params, stats, BACKBONE, 16, train)
    check_backbone(res, TRAIN_TOL if train else EVAL_TOL, f"{BACKBONE} train={train}")


# one Block alone, train mode, domains=2 (measured over bn and tn: output
# 5.8e-7, stats 7.7e-7, gradients 2.2e-5, the largest that of the norm
# after a separable conv, whose weight's gradient cancels)
BLOCK_TOL = {"output": 2e-6, "stats": 2.5e-6, "grads": 7e-5}


@pytest.mark.parametrize("norm", ["bn", "tn"])
@pytest.mark.parametrize("plan", [
    (16, 32, 2, 2, 1, False, True, False),  # as block1: strided, no first ReLU
    (32, 32, 3, 1, 2, True, True, False),  # as the middle flow's, dilated
    (32, 48, 2, 1, 2, True, False, True),  # as block20: grow last, is_last
])
def test_block_train_mode_against_jax(two_threads, norm, plan):
    """The train-mode backward through a Block's norm sites (the separable
    convs' inner norms included), held tightly where the whole model's
    gradients carry the noise floor of depth, for each kind of block."""
    res = block_errors(JaxBlock(*plan, norm=norm), Block(*plan, norm=norm),
                       lambda sd, key, p, s: _xception_block(sd, key, p, s, plan),
                       (B, 16, 16, plan[0]))
    check_block(res, BLOCK_TOL, f"Block {plan} {norm}")
