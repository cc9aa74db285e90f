"""The port's MobileNetV2 DeepLab at output stride 8 (the atrous plan of
uda_clr_tpu_torch/models/mobilenet.py and ASPP's dilations (1,12,24,36))
against the JAX package's, from the same JAX-initialised weights (norms
perturbed) carried over by the weight bridge, dropout off, at B=2 and 64^2:
train mode with ``domains=2`` (outputs, running stats, gradients) and eval
mode (outputs, gradients).

Tolerances (tests/torch_step_harness.py:check_backbone) stand beside each
with the value measured on these inputs (torch 2.13 CPU, jax 0.9 CPU at
matmul precision 'highest'), with a margin of at least 3x. Train-mode
gradients carry the noise floor ROADMAP.md notes for mobilenet; in eval
mode the backbone's ReLU6 kinks flip with the float noise."""

import pytest

from tests.torch_step_harness import (  # noqa: F401  (fixtures)
    backbone_errors,
    check_backbone,
    dropout_off,
    jax_deeplab,
    two_threads,
)

TOL = {
    True: {
        "outputs": 2e-4,  # 6.4e-5
        "stats": 2.5e-5,  # 8.3e-6
        # (largest over the group, median over its tensors): the noise floor
        "grads": {"backbone": (0.041, 0.052),  # 0.014, 0.017
                  "aspp": (0.24, 0.07),  # 0.079, 0.023
                  "decoder": (0.018, 0.015)},  # 0.0060, 0.0049
    },
    False: {
        "outputs": 5e-5,  # 1.5e-5
        "stats": 0.0,  # eval mode writes nothing
        "grads": {"backbone": (2.2e-2, 2.1e-2),  # 7.1e-3, 6.7e-3
                  "aspp": (2.1e-5, 1.4e-5),  # 6.9e-6, 4.5e-6
                  "decoder": (2.1e-5, 4e-6)},  # 6.9e-6, 1.3e-6
    },
}


@pytest.fixture(scope="module")
def jax_model():
    return jax_deeplab("mobilenet", 8)


@pytest.mark.parametrize("train", [True, False])
def test_against_jax(jax_model, dropout_off, two_threads, train):
    model, params, stats = jax_model
    res = backbone_errors(model, params, stats, "mobilenet", 8, train)
    assert res["outputs"]  # the ASPP feature is at H/8
    check_backbone(res, TOL[train], f"mobilenet OS8 train={train}")
