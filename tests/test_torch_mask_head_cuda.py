"""The CUDA mask-head kernels (uda_clr_tpu_torch/csrc/mask_head.cu, K1 and
K2) on the card, against their plain PyTorch version on the same inputs. Imports neither
JAX nor the JAX package, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_mask_head_cuda.py

Without a card every test skips. Tolerances: float32 1e-5 (the sums over
305 channels run in another order; TF32 is off); bfloat16 one bf16 ulp of
the largest output (the same sums may then round to neighbouring values).
The unit-weight cases are bitwise: each output's sum holds one term."""

import numpy as np
import pytest
import torch

from uda_clr_tpu_torch.ops import mask_head as mh
from uda_clr_tpu_torch.train.steps import kernel_seed

pytestmark = pytest.mark.cuda

TILE_ROWS = 32  # rows per tile of the kernel (csrc/mask_head.cu, kRows)
DTYPES = (torch.float32, torch.bfloat16)


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _args(card, dtype, n=3, hw=17, seed=4):
    """Inputs at a ragged row count (3*17*17 rows by default)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(card)
    return (f(n, hw, hw, 256).to(dtype), f(n, hw, hw, 48).to(dtype), f(n, hw, hw, 1).to(dtype),
            0.1 * f(305), 0.5 + f(305).abs(), 1.0 + 0.2 * f(305), 0.1 * f(305),
            0.05 * f(2, 305, 1, 1), 0.1 * f(2))


def _tol(want, dtype):
    return 1e-5 if dtype == torch.float32 else float(want.abs().max()) * 2.0**-7


@pytest.mark.parametrize("dtype", DTYPES)
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
    assert float((got.float() - want).abs().max()) <= _tol(want, dtype)


RAGGED_ROWS = (1, 3, 7, TILE_ROWS - 1, TILE_ROWS, TILE_ROWS + 1, 3 * 17 * 17, 5 * TILE_ROWS + 3)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("seed", [kernel_seed(5, 0), kernel_seed(6, 7)])
def test_ragged_rows_match_plain_and_k2_equals_k1(card, dtype, rate, seed):
    """Row counts around the tile size (first, last and only tiles that are
    partial; a boundary span that is not a multiple of 16 bytes): K1 and K2
    against the plain version, and K2 bitwise against K1."""
    for m in RAGGED_ROWS:
        args = _args(card, dtype, n=m, hw=1, seed=m)
        args = tuple(t.reshape(m, -1) for t in args[:3]) + args[3:]
        x_bu = torch.cat(args[:2], dim=-1)
        k1 = mh.fused_mask_head_split(*args, seed=seed, rate=rate)
        k2 = mh.fused_mask_head(x_bu, *args[2:], seed=seed, rate=rate)
        want = mh.mask_head_plain(*args, seed=seed, rate=rate).float()
        torch.cuda.synchronize()
        assert k1.shape == (m, 2) and torch.equal(k1, k2), m
        assert float((k1.float() - want).abs().max()) <= _tol(want, dtype), m


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("channels", [(0, 255), (256, 303), (304, 7)])
def test_unit_weight_bitwise(card, dtype, channels):
    """Output 0 is channel c and output 1 channel c' after BN, ReLU and
    dropout (one-hot weights, bias 0), every value positive before the
    dropout: each output's sum holds one term, so kernel and plain version
    agree bit for bit, and a mask off by one element would show. x_up,
    ll and boundary each hold one of the checked channels."""
    c0, c1 = channels
    for m in (5 * TILE_ROWS + 3, 3 * 17 * 17):
        args = list(_args(card, dtype, n=m, hw=1, seed=c0 + m))
        args[:3] = [t.reshape(m, -1) for t in args[:3]]
        args[3] = torch.full_like(args[3], -6.0)  # x - mean > 0: ReLU keeps every element
        w = torch.zeros_like(args[7])
        w[0, c0], w[1, c1] = 1.0, 1.0
        args[7], args[8] = w, torch.zeros_like(args[8])
        seed = kernel_seed(c1, m)
        got = mh.fused_mask_head_split(*args, seed=seed, rate=0.1)
        got_bu = mh.fused_mask_head(torch.cat(args[:2], dim=-1), *args[2:], seed=seed, rate=0.1)
        want = mh.mask_head_plain(*args, seed=seed, rate=0.1)
        torch.cuda.synchronize()
        dropped = (want == 0).float().mean(dim=0)
        assert bool((dropped > 0.03).all() and (dropped < 0.2).all()), dropped  # ~10% dropped
        assert torch.equal(got, want) and torch.equal(got_bu, want), (channels, m)


def test_kernel_refuses_what_it_does_not_take(card):
    args = list(_args(card, torch.float32))
    with pytest.raises(TypeError):
        mh.fused_mask_head_split(args[0].half(), args[1].half(), args[2].half(), *args[3:], seed=0)
    with pytest.raises(ValueError):  # a strided view is not row-major [..., 256]
        mh.fused_mask_head_split(args[0].transpose(1, 2), *args[1:], seed=0)
    with pytest.raises(ValueError):  # mixed devices
        mh.fused_mask_head_split(args[0], args[1].cpu(), *args[2:], seed=0)
    # a boundary view that starts 4 bytes into its storage: the bulk copies
    # need 16-byte aligned spans
    bnd = torch.zeros(3 * 17 * 17 + 1, device=card)[1:].reshape(3, 17, 17, 1)
    with pytest.raises(ValueError, match="aligned"):
        mh.fused_mask_head_split(args[0], args[1], bnd, *args[3:], seed=0)


@pytest.mark.parametrize("dtype", DTYPES)
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
    assert float((got.float() - want).abs().max()) <= _tol(want, dtype)


@pytest.mark.parametrize("split", [True, False])
def test_occupancy_query(card, split):
    """Two 256-thread blocks fit on an SM: the dynamic shared memory of a
    block's stages, masks and barriers stays under half of the SM's 228 KB."""
    for dtype in DTYPES:
        smem, per_sm = mh.occupancy(split, 0.1, dtype, card)
        assert 48 * 1024 < smem < 114 * 1024 and per_sm >= 2
