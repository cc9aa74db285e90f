"""Rematerialised backbone blocks (``DeepLab(remat=True)``,
uda_clr_tpu_torch/models/layers.py:run_block), torch only: the JAX
package's contract (tests/test_remat.py) that remat is a pure memory
transform. From the same weights, a train-mode forward and backward gives
the same outputs, the same running statistics and the same gradients as
without it, under plain BN and under TransNorm; the running statistics
are written once, by the forward, and the backward's recompute writes
nothing (it runs under ``frozen_stats``)."""

import numpy as np
import pytest
import torch

from uda_clr_tpu_torch.models import layers
from uda_clr_tpu_torch.models.deeplab import DeepLab
from uda_clr_tpu_torch.models.norm import frozen_stats

B, SIZE = 2, 32


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two torch threads (the suite runs files side by side on a few cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def dropout_off():
    """The heads' dropout sites off (the two models would draw apart)."""
    prev = layers.dropout_impl()
    layers.set_dropout_impl("off")
    yield
    layers.set_dropout_impl(prev)


def _buffers(model):
    return {k: v.clone() for k, v in model.named_buffers()}


def _run(model, x, weights):
    model.zero_grad(set_to_none=True)
    outs = model(x, True, 2)
    after_forward = _buffers(model)
    sum(torch.mean(o * w) for o, w in zip(outs, weights)).backward()
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    return [o.detach() for o in outs], after_forward, grads


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((B, SIZE, SIZE, 3)).astype(np.float32))
    outs = DeepLab(backbone="drn")(x, False)
    weights = [torch.from_numpy(rng.standard_normal(tuple(o.shape)).astype(np.float32))
               for o in outs]
    return x, weights


@pytest.mark.parametrize("backbone", ["mobilenet", "drn"])
@pytest.mark.parametrize("norm", ["bn", "tn"])
def test_remat_equals_the_plain_model(inputs, backbone, norm):
    x, weights = inputs
    if backbone == "mobilenet":  # its ASPP sees H/16; drn's H/8
        weights = weights[:2] + [weights[2][:, ::2, ::2]] + weights[3:]
    plain = DeepLab(backbone=backbone, norm=norm, seed=1)
    remat = DeepLab(backbone=backbone, norm=norm, seed=2, remat=True)
    remat.load_state_dict(plain.state_dict())
    outs_p, stats_p, grads_p = _run(plain, x, weights)
    outs_r, stats_r, grads_r = _run(remat, x, weights)
    for a, b in zip(outs_p, outs_r):
        assert torch.equal(a, b)
    # the forward writes the stats once; the backward's recompute writes nothing
    final = _buffers(remat)
    for k, v in stats_p.items():
        assert torch.equal(stats_r[k], v), k
        assert torch.equal(final[k], v), f"{k}: the recompute wrote the running stats again"
    for k, g in grads_p.items():
        # the same kernels in the same order on the CPU (measured: bitwise)
        assert torch.equal(grads_r[k], g), k


def test_remat_under_frozen_stats_writes_nothing(inputs):
    """A rematerialised forward and backward inside ``frozen_stats`` (the
    augmented forward with ``aug_backward``) writes no running stats, and
    leaves the flags as it found them."""
    x, weights = inputs
    model = DeepLab(backbone="drn", remat=True)
    before = _buffers(model)
    with frozen_stats(model):
        outs = model(x, True, 2)
        sum(torch.mean(o * w) for o, w in zip(outs, weights)).backward()
    for k, v in _buffers(model).items():
        assert torch.equal(v, before[k]), k
    model(x, True, 2)
    assert not torch.equal(model.state_dict()["backbone.layer0.1.running_mean"],
                           before["backbone.layer0.1.running_mean"])
