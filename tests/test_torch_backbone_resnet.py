"""The port's ResNet-101 DeepLab (uda_clr_tpu_torch/models/resnet.py)
against the JAX package's, from the same JAX-initialised weights (norms
perturbed) carried over by the weight bridge, dropout off, at B=2 and 64^2:
the bridge round trip, train mode with ``domains=2`` (outputs, running
stats, gradients), eval mode (outputs, gradients), output stride 8 in
eval mode, and one Bottleneck alone in train mode.

Tolerances (tests/torch_step_harness.py:check_backbone, check_block) stand
beside each with the value measured on these inputs (torch 2.13 CPU, jax
0.9 CPU at matmul precision 'highest'), with a margin of at least 3x. In
train mode float32 rounding is amplified through 33 blocks of train-mode
norms: the outputs differ by 6.6e-3 of their largest entry and the
gradients carry a noise floor (backbone 0.19 of the largest gradient).
The floor is the depth's, not this test's size: the port's own float32
gradients differ from its float64 ones by 0.095 (backbone) and 0.18
(ASPP), and the floor stays at 0.11-0.27 at B=4 with ``domains=1`` and at
0.13-0.28 at 128^2. So the train-mode backward is held tightly block by
block (a Bottleneck alone: 1.2e-6), and eval mode, which has no such
amplification, holds the whole model's gradients per tensor."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_step_harness import (  # noqa: F401  (fixtures)
    SIZE,
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
from uda_clr_tpu.models.resnet import Bottleneck as JaxBottleneck
from uda_clr_tpu_torch.convert.from_jax import _bottleneck, deeplab_state_dict
from uda_clr_tpu_torch.models.deeplab import DeepLab
from uda_clr_tpu_torch.models.resnet import Bottleneck

BACKBONE = "resnet"

TRAIN_TOL = {
    "outputs": 2.5e-2,  # 7.8e-3
    "stats": 4e-3,  # 1.1e-3
    # (largest over the group, median over its tensors): the noise floor
    "grads": {"backbone": (0.6, 0.5),  # 0.19, 0.17
              "aspp": (0.85, 0.55),  # 0.28, 0.17
              "decoder": (0.2, 0.21)},  # 0.061, 0.069
}
EVAL_TOL = {
    "outputs": 2e-5,  # 4.9e-6
    "stats": 0.0,  # eval mode writes nothing
    # the backbone's largest: relu kinks of layer3.0, whose activations
    # reach ~1e6 in eval mode from these random weights and statistics
    "grads": {"backbone": (6e-3, 1e-5),  # 1.7e-3, 2.6e-6
              "aspp": (5e-6, 5e-6),  # 1.1e-6, 1.3e-6
              "decoder": (1e-5, 5e-6)},  # 2.4e-6, 1.1e-6
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


def test_output_stride_8_eval_forward(jax_model, two_threads):
    """The same variables at output stride 8 (strides (1,2,1,1), dilations
    (1,1,2,4), ASPP dilations (1,12,24,36)): the seven outputs in eval mode."""
    _, params, stats = jax_model
    model8 = type(jax_model[0])(num_classes=2, backbone=BACKBONE, output_stride=8)
    x = np.random.default_rng(6).standard_normal((B, SIZE, SIZE, 3)).astype(np.float32)
    want = jax.jit(lambda v, x: model8.apply(v, x, train=False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    gen = DeepLab(backbone=BACKBONE, output_stride=8)
    gen.load_state_dict(deeplab_state_dict(params, stats, 8))
    with torch.no_grad():
        got = gen(torch.from_numpy(x), False)
    assert got.aspp_feature.shape == (B, SIZE // 8, SIZE // 8, 256)
    for name, g, w in zip(got._fields, got, want):
        w = np.asarray(w)
        err = float(np.abs(g.numpy() - w).max() / np.abs(w).max())
        assert err <= 1.5e-5, f"{name}: {err:.2e}"  # 3.5e-6


# one Bottleneck alone, train mode, domains=2 (measured over bn and tn:
# output 1.4e-6, stats 4.4e-7, gradients 1.2e-6)
BLOCK_TOL = {"output": 5e-6, "stats": 1.5e-6, "grads": 4e-6}


@pytest.mark.parametrize("norm", ["bn", "tn"])
@pytest.mark.parametrize("inplanes, stride, dilation, down", [(32, 2, 1, True), (64, 1, 2, False)])
def test_bottleneck_train_mode_against_jax(two_threads, norm, inplanes, stride, dilation, down):
    """The train-mode backward through a Bottleneck's norm sites, held
    tightly where the whole model's gradients carry the noise floor of
    depth: strided with its projection, and dilated with the identity."""
    res = block_errors(JaxBottleneck(16, stride, dilation, down, norm),
                       Bottleneck(inplanes, 16, stride, dilation, down, norm),
                       _bottleneck, (B, 16, 16, inplanes))
    check_block(res, BLOCK_TOL, f"Bottleneck {norm} stride {stride} dilation {dilation}")
