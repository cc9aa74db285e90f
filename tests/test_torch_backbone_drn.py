"""The port's DRN-D-54 DeepLab (uda_clr_tpu_torch/models/drn.py), at
its output stride 8,
against the JAX package's, from the same JAX-initialised weights (norms
perturbed) carried over by the weight bridge, dropout off, at B=2 and 64^2:
the bridge round trip, train mode with ``domains=2`` (outputs, running
stats, gradients), eval mode (outputs, gradients) and a Bottleneck alone
in train mode, under plain BN and under TransNorm.

Tolerances (tests/torch_step_harness.py:check_backbone) stand beside each
with the value measured on these inputs (torch 2.13 CPU, jax 0.9 CPU at
matmul precision 'highest'), with a margin of at least 3x. In train mode
every norm normalises one image per domain, so float32 rounding is
amplified layer by layer and the gradients carry a noise floor (as
ROADMAP.md notes for mobilenet; it stays at B=4 with ``domains=1``), so
the train-mode backward is also held tightly on a Bottleneck alone; eval
mode has no such amplification, and there the gradients are held tightly,
except where relu kinks of activations that reach ~1e6 from these random
weights and statistics flip."""

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
from uda_clr_tpu.models.drn import _Bottleneck as JaxBottleneck
from uda_clr_tpu_torch.convert.from_jax import _bottleneck, deeplab_state_dict
from uda_clr_tpu_torch.models.deeplab import DeepLab
from uda_clr_tpu_torch.models.resnet import Bottleneck

BACKBONE = "drn"

TOL = {
    ("bn", True): {
        "outputs": 8e-4,  # 2.5e-4
        "stats": 5e-5,  # 1.5e-5
        # (largest over the group, median over its tensors): the noise floor
        "grads": {"backbone": (0.12, 0.13),  # 0.037, 0.043
                  "aspp": (0.55, 0.13),  # 0.18, 0.042
                  "decoder": (0.08, 0.05)},  # 0.027, 0.017
    },
    ("bn", False): {
        "outputs": 2e-5,  # 5.4e-6
        "stats": 0.0,  # eval mode writes nothing
        "grads": {"backbone": (6e-3, 5e-3),  # 1.9e-3, 1.5e-3
                  "aspp": (6e-3, 6e-3),  # 1.8e-3, 1.7e-3
                  "decoder": (1e-2, 5e-6)},  # 3.0e-3, 1.3e-6
    },
    ("tn", True): {
        "outputs": 1.3e-3,  # 4.1e-4
        "stats": 1.1e-3,  # 3.5e-4
        "grads": {"backbone": (0.12, 0.11),  # 0.037, 0.036
                  "aspp": (0.31, 0.08),  # 0.10, 0.026
                  "decoder": (0.075, 0.065)},  # 0.024, 0.021
    },
    # On an AMD EPYC host one boundary-head pre-activation of ~1e11 (4.9e-7
    # of the layer's largest, 2e17) is within float32 noise of zero: the
    # port's conv rounds it below zero, JAX's above, float64 above; each
    # framework's float32 conv output lies 1.7e-6 of its largest from
    # float64. That one ReLU kink moves every ASPP and decoder-input
    # gradient by ~3e-3. (measured before; measured on AMD EPYC)
    ("tn", False): {
        "outputs": 1.2e-5,  # 3.9e-6
        "stats": 0.0,
        "grads": {"backbone": (1.4e-2, 1.1e-2),  # 4.5e-3, 3.5e-3; 4.6e-3, 5.4e-3
                  "aspp": (1e-2, 1.2e-2),  # 2.2e-6, 1.4e-6; 3.2e-3, 4.0e-3
                  "decoder": (1.2e-2, 7e-6)},  # 1.3e-6, 9.2e-7; 4.0e-3, 2.1e-6
    },
}


@pytest.fixture(scope="module")
def jax_models():
    return {norm: jax_deeplab(BACKBONE, 8, norm) for norm in ("bn", "tn")}


@pytest.mark.parametrize("norm", ["bn", "tn"])
def test_bridge_round_trip(jax_models, norm):
    """JAX variables -> the port's state_dict -> the JAX package's own
    converter -> the original trees bit for bit; the port's module takes
    the state_dict strictly."""
    import jax

    _, params, stats = jax_models[norm]
    sd = deeplab_state_dict(params, stats, 8)
    DeepLab(backbone=BACKBONE, norm=norm).load_state_dict(sd)
    back_p, back_s = convert_deeplab_state_dict({k: v.numpy() for k, v in sd.items()}, 8)
    flat = lambda t: {jax.tree_util.keystr(k): np.asarray(v)
                      for k, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    for want, got in ((params, back_p), (stats, back_s)):
        fw, fg = flat(want), flat(got)
        assert fw.keys() == fg.keys()
        for k in fw:
            np.testing.assert_array_equal(fg[k], fw[k], err_msg=k)


@pytest.mark.parametrize("norm, train", [("bn", True), ("bn", False), ("tn", True),
                                         ("tn", False)])
def test_against_jax(jax_models, dropout_off, two_threads, norm, train):
    model, params, stats = jax_models[norm]
    res = backbone_errors(model, params, stats, BACKBONE, 8, train, norm)
    check_backbone(res, TOL[norm, train], f"{BACKBONE} {norm} train={train}")


# one dilated Bottleneck alone, train mode, domains=2 (measured over bn and
# tn: output 1.1e-6, stats 3.2e-7, gradients 9.9e-7)
BLOCK_TOL = {"output": 4e-6, "stats": 1e-6, "grads": 3e-6}


@pytest.mark.parametrize("norm", ["bn", "tn"])
def test_bottleneck_train_mode_against_jax(two_threads, norm):
    """The train-mode backward through a Bottleneck's norm sites, held
    tightly where the whole model's gradients carry the noise floor of
    depth: layer5's dilation pair (2, 2) with its projection (DRN's
    Bottleneck is ResNet's; the 3x3 conv takes the pair's second entry)."""
    res = block_errors(JaxBottleneck(16, 1, (2, 2), True, norm),
                       Bottleneck(32, 16, 1, 2, True, norm), _bottleneck, (B, 16, 16, 32))
    check_block(res, BLOCK_TOL, f"DRN Bottleneck {norm}")
