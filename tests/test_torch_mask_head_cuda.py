"""The CUDA mask-head kernels (uda_clr_tpu_torch/csrc/mask_head.cu, K1 and
K2) on the card, against their plain PyTorch version on the same inputs. Imports neither
JAX nor the JAX package, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_mask_head_cuda.py

Without a card every test skips. Tolerances: float32 1e-5 (the sums over
305 channels run in another order; TF32 is off); bfloat16 one bf16 ulp of
the largest output (the same sums may then round to neighbouring values)."""

import numpy as np
import pytest
import torch

from uda_clr_tpu_torch.ops import mask_head as mh
from uda_clr_tpu_torch.train.steps import kernel_seed

pytestmark = pytest.mark.cuda


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _args(card, dtype, n=3, hw=17, seed=4):
    """Inputs at a ragged row count (3*17*17 rows)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(card)
    return (f(n, hw, hw, 256).to(dtype), f(n, hw, hw, 48).to(dtype), f(n, hw, hw, 1).to(dtype),
            0.1 * f(305), 0.5 + f(305).abs(), 1.0 + 0.2 * f(305), 0.1 * f(305),
            0.05 * f(2, 305, 1, 1), 0.1 * f(2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_kernel_matches_plain(card, dtype, rate):
    args = _args(card, dtype)
    seed = kernel_seed(1, 2)
    before = mh.LAUNCHES
    got = mh.fused_mask_head_split(*args, seed=seed, rate=rate)
    assert mh.LAUNCHES == before + 1
    assert got.dtype == dtype and got.shape == (3, 17, 17, 2)
    want = mh.mask_head_plain(*args, seed=seed, rate=rate).float()
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else float(want.abs().max()) * 2.0**-7
    assert float((got.float() - want).abs().max()) <= tol


def test_kernel_refuses_what_it_does_not_take(card):
    args = list(_args(card, torch.float32))
    with pytest.raises(TypeError):
        mh.fused_mask_head_split(args[0].half(), args[1].half(), args[2].half(), *args[3:], seed=0)
    with pytest.raises(ValueError):  # a strided view is not row-major [..., 256]
        mh.fused_mask_head_split(args[0].transpose(1, 2), *args[1:], seed=0)
    with pytest.raises(ValueError):  # mixed devices
        mh.fused_mask_head_split(args[0], args[1].cpu(), *args[2:], seed=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_matches_plain_and_k1(card, dtype):
    """K2 on x_bu = cat(x_up, ll) against its plain version, and bitwise
    against K1 on the split views with the same seed (same row code, same
    element index)."""
    args = _args(card, dtype)
    x_bu = torch.cat([args[0], args[1]], dim=-1)
    seed = kernel_seed(3, 1)
    before = mh.LAUNCHES_BU
    got = mh.fused_mask_head(x_bu, *args[2:], seed=seed, rate=0.1)
    assert mh.LAUNCHES_BU == before + 1
    k1 = mh.fused_mask_head_split(*args, seed=seed, rate=0.1)
    want = mh.mask_head_bu_plain(x_bu, *args[2:], seed=seed, rate=0.1).float()
    torch.cuda.synchronize()
    assert torch.equal(got, k1)
    tol = 1e-5 if dtype == torch.float32 else float(want.abs().max()) * 2.0**-7
    assert float((got.float() - want).abs().max()) <= tol
