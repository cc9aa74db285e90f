"""The fused dropout kernel K3 (uda_clr_tpu_torch/csrc/dropout.cu) on the
card, forward and backward, against its plain PyTorch version on the same
inputs. Imports neither JAX nor the JAX package, so it runs where only
PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_dropout_cuda.py

Without a card every test skips. The kernel and the plain version draw the
same Philox words and scale by the same dtype-rounded 1/keep, so they must
agree bitwise."""

import pytest
import torch

from uda_clr_tpu_torch.ops import dropout as K3

pytestmark = pytest.mark.cuda


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,channels_last", [((3, 5, 17, 19), True), ((3, 5, 17, 19), False),
                                                 ((1001,), False)])
def test_kernel_matches_plain_forward_and_backward(card, dtype, shape, channels_last):
    """Ragged sizes (the last group of 4 is partial), both memory formats,
    and an NCHW-contiguous cotangent for a channels_last input."""
    g = torch.Generator(card).manual_seed(0)
    x = torch.randn(shape, device=card, generator=g).to(dtype)
    if channels_last:
        x = x.to(memory_format=torch.channels_last)
    x.requires_grad_()
    cot = torch.randn(shape, device=card, generator=g).to(dtype)
    seed, rate = 0x0123456789ABCDEF, 0.1
    before = K3.LAUNCHES_FWD, K3.LAUNCHES_BWD
    y = K3.fused_dropout(x, seed, rate)
    y.backward(cot)
    assert (K3.LAUNCHES_FWD, K3.LAUNCHES_BWD) == (before[0] + 1, before[1] + 1)
    want = K3.dropout_plain(x.detach(), seed, rate)
    want_grad = K3.dropout_plain(cot.contiguous(memory_format=K3.memory_format(x)), seed, rate)
    torch.cuda.synchronize()
    assert y.dtype == dtype and y.stride() == x.stride()
    assert torch.equal(y, want)
    assert torch.equal(x.grad, want_grad)
    kept = (want != 0).float().mean().item()
    assert 0.85 < kept < 0.95


def test_kernel_refuses_what_it_does_not_take(card):
    with pytest.raises(TypeError):
        K3.fused_dropout(torch.ones(8, device=card, dtype=torch.float16), 0, 0.1)
