"""The backbones and rematerialisation on the card. Imports neither JAX nor
the JAX package, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_backbones_cuda.py

Without a card every test skips. Float32 with TF32 off; cuDNN sums the
convolutions in other orders than the CPU, hence the tolerances."""

import numpy as np
import pytest
import torch

from uda_clr_tpu_torch.models import layers
from uda_clr_tpu_torch.models.deeplab import DeepLab

pytestmark = pytest.mark.cuda


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic, layers.dropout_impl())
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    layers.set_dropout_impl("off")
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved[:2]
    torch.backends.cudnn.deterministic = saved[2]
    layers.set_dropout_impl(saved[3])


def _perturbed(backbone, output_stride, **kw):
    gen = DeepLab(backbone=backbone, output_stride=output_stride, seed=0, **kw)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, t in gen.named_parameters():
            if t.dim() == 1 and name.endswith("weight"):
                t.copy_(1.0 + 0.1 * torch.randn(t.shape, generator=g))
        for name, t in gen.named_buffers():
            t.copy_(0.1 * torch.randn(t.shape, generator=g) if "mean" in name
                    else 0.5 + torch.rand(t.shape, generator=g))
    return gen


def _x():
    return torch.from_numpy(np.random.default_rng(3).standard_normal((2, 64, 64, 3))
                            .astype(np.float32))


@pytest.mark.parametrize("backbone, output_stride", [
    ("resnet", 16), ("resnet", 8), ("xception", 16), ("xception", 8), ("drn", 8),
    ("mobilenet", 8)])
@pytest.mark.parametrize("train", [False, True])
def test_forward_card_equals_cpu(card, backbone, output_stride, train):
    """Eval mode within 1e-4 of the largest entry; train mode (``domains=2``,
    one image per domain) amplifies the float noise through the norms, as
    against JAX (tests/test_torch_backbone_*.py), so within 3e-2."""
    gen = _perturbed(backbone, output_stride)
    x = _x()
    with torch.no_grad():
        want = gen(x, train, 2 if train else 1)
        gen.to(card).to(memory_format=torch.channels_last)
        got = gen(x.to(card), train, 2 if train else 1)
    tol = 3e-2 if train else 1e-4
    for name, a, b in zip(got._fields, got, want):
        err = float((a.cpu() - b).abs().max() / b.abs().max())
        assert err <= tol, f"{name}: {err:.2e}"


@pytest.mark.parametrize("backbone", ["resnet", "drn"])
def test_remat_on_the_card(card, backbone):
    """Rematerialised blocks on the card: the same outputs and running stats
    as the plain model, written once, and the same gradients within the
    noise of the atomic accumulations in the backward."""
    x = _x().to(card)
    runs = []
    for remat in (False, True):
        gen = _perturbed(backbone, 16, remat=remat).to(card).to(memory_format=torch.channels_last)
        outs = gen(x, True, 2)
        stats = {k: v.clone() for k, v in gen.named_buffers()}
        sum(o.float().square().mean() for o in outs).backward()
        runs.append((outs, stats, dict(gen.named_buffers()),
                     {k: p.grad for k, p in gen.named_parameters()}))
    (o0, s0, _, g0), (o1, s1, after, g1) = runs
    for a, b in zip(o0, o1):
        assert torch.equal(a, b)
    for k, v in s0.items():
        assert torch.equal(s1[k], v) and torch.equal(after[k], v), k
    scale = max(float(v.abs().max()) for v in g0.values())
    for k, v in g0.items():
        err = float((g1[k] - v).abs().max()) / scale
        assert err <= 1e-4, f"{k}: {err:.2e} of the largest gradient"
