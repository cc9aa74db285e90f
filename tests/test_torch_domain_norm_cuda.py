"""The norm kernel K4 (uda_clr_tpu_torch/csrc/domain_norm.cu) on the card,
forward and backward, against its plain version (models/norm.py's op-by-op
code) in float32 on the same values. Imports neither JAX nor the JAX
package, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_domain_norm_cuda.py

Without a card every test skips.

Tolerances, each with its reason:
- float32: y and dx within 2e-5 of the largest reference entry, the
  parameters' gradients within 1e-4, the running stats within 1e-5: the
  same formulas, with the sums taken in another order;
- bfloat16: the plain version in float32 on the same bf16 values is the
  reference. The kernel computes in float32 and rounds y and dx once to
  bf16 (the bf16 plain version rounds three times), so each y and dx entry
  lies within one bf16 rounding, 2^-8 of its magnitude, plus 2e-5 of the
  largest entry for the float32 sums; the parameters' gradients and the
  running stats are float32 sums of the same bf16 values: 1e-4 and 1e-5.
"""

import numpy as np
import pytest
import torch

from uda_clr_tpu_torch.models.norm import DomainNorm2d
from uda_clr_tpu_torch.ops import domain_norm as K4

pytestmark = pytest.mark.cuda

BF16_ROUND = 2.0 ** -8  # one round-to-nearest in bfloat16 (8-bit significand), relative


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _module(mode: str, c: int, device) -> DomainNorm2d:
    m = DomainNorm2d(c, mode=mode)
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        m.weight.copy_(1 + 0.2 * torch.randn(c, generator=g))
        m.bias.copy_(0.2 * torch.randn(c, generator=g))
        for b in m.buffers():
            b.copy_(0.3 + torch.rand(b.shape, generator=g))
    return m.to(device)


def _run(m: DomainNorm2d, x, cot, train: bool, domains: int, plain: bool):
    x = x.clone().requires_grad_()
    m.zero_grad()
    y = (m.forward_plain if plain else m)(x, train, domains)
    y.backward(cot)
    return {"y": y.detach().float(), "dx": x.grad.float(), "dscale": m.weight.grad,
            "dbias": m.bias.grad, **{k: v.clone() for k, v in m.named_buffers()}}


def _compare(got: dict, want: dict, dtype, where: str):
    for key, w in want.items():
        g, top = got[key], float(w.abs().max())
        err = (g - w).abs()
        if key in ("y", "dx"):
            bound = 2e-5 * top + (BF16_ROUND * w.abs() if dtype == torch.bfloat16 else 0.0)
            assert bool((err <= bound).all()), f"{where} {key}: {float(err.max()):.3e}"
        else:
            tol = 1e-4 if key in ("dscale", "dbias") else 1e-5
            assert float(err.max()) <= tol * max(top, 1e-3), f"{where} {key}: {float(err.max())}"


def _case(card, mode, n, c, hw, train, domains, dtype, channels_last, update=True, seed=0):
    g = torch.Generator(card).manual_seed(seed)
    x = (1.5 * torch.randn(n, c, *hw, device=card, generator=g) + 0.4).to(dtype)
    cot = torch.randn(n, c, *hw, device=card, generator=g).to(dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
        cot = cot.contiguous(memory_format=torch.channels_last)
    kernel, plain = _module(mode, c, card), _module(mode, c, card)
    kernel.update_stats = plain.update_stats = update
    before = (K4.LAUNCHES_MOMENTS, K4.LAUNCHES_FWD, K4.LAUNCHES_REDUCE, K4.LAUNCHES_BWD)
    got = _run(kernel, x, cot, train, domains, plain=False)
    after = (K4.LAUNCHES_MOMENTS, K4.LAUNCHES_FWD, K4.LAUNCHES_REDUCE, K4.LAUNCHES_BWD)
    want = _run(plain, x.float(), cot.float(), train, domains, plain=True)
    torch.cuda.synchronize()
    assert got["y"].shape == x.shape
    _compare(got, want, dtype, f"{mode} n={n} c={c} train={train} domains={domains}")
    return [a - b for a, b in zip(after, before)]


CASES = [  # (mode, n, train, domains): even, uneven and one-group splits, eval
    ("bn", 6, True, 2), ("bn", 5, True, 1), ("bn", 6, False, 1),
    ("tn", 6, True, 2), ("tn", 5, True, 2), ("tn", 6, True, 0), ("tn", 6, False, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels_last", [True, False])
@pytest.mark.parametrize("mode,n,train,domains", CASES)
@pytest.mark.parametrize("c", [40, 305, 1])
def test_kernel_matches_plain(card, dtype, channels_last, mode, n, train, domains, c):
    """y, dx, dscale, dbias and the running stats; one moments and one
    normalize launch in train mode (the normalize alone in eval mode), one
    reduce and one dx launch backward."""
    launches = _case(card, mode, n, c, (9, 11), train, domains, dtype, channels_last)
    assert launches == [1 if train else 0, 1, 1, 1]


@pytest.mark.parametrize("mode", ["bn", "tn"])
def test_frozen_stats_write_no_running_stats(card, mode):
    _case(card, mode, 4, 24, (8, 8), True, 2, torch.bfloat16, True, update=False)


@pytest.mark.parametrize("shape,domains", [((16, 96, 258, 258), 2), ((16, 305, 128, 128), 2),
                                           ((64, 256, 128, 128), 1), ((16, 320, 32, 32), 2)])
def test_the_steps_largest_sites(card, shape, domains):
    """The step's largest norm sites at 512^2, B 8+8, in bf16 channels_last
    (the MC suffix's [64, 256, 128, 128] is one group)."""
    n, c, h, w = shape
    _case(card, "bn", n, c, (h, w), True, domains, torch.bfloat16, True)
    torch.cuda.empty_cache()


@pytest.mark.parametrize("shape", [(16, c, 256, 256) for c in (32, 64, 128)]
                         + [(16, c, 128, 128) for c in (128, 256)]
                         + [(16, c, 64, 64) for c in (256, 728)]
                         + [(16, c, 32, 32) for c in (728, 1024, 1536, 2048)])
def test_xceptions_sites(card, shape):
    """The eleven distinct norm-site shapes of Aligned Xception-65 at
    512^2, B 8+8, in bf16 channels_last, split 8 | 8."""
    n, c, h, w = shape
    _case(card, "bn", n, c, (h, w), True, 2, torch.bfloat16, True)
    torch.cuda.empty_cache()


def test_moments_repeat_bit_for_bit(card):
    """The two-level reduction has a fixed order: the same input gives the
    same sums, and they equal float64 sums within float32 round-off."""
    g = torch.Generator(card).manual_seed(2)
    x = torch.randn(16, 96, 66, 66, device=card, generator=g).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    a, b = K4.moments([(x, 8)])[0], K4.moments([(x, 8)])[0]
    assert torch.equal(a, b)
    x64 = x.double().unflatten(0, (2, 8))
    want = torch.cat([x64.sum((1, 3, 4)).reshape(-1), (x64 * x64).sum((1, 3, 4)).reshape(-1),
                      torch.full((2,), 8 * 66 * 66.0, dtype=torch.float64, device=card)])
    assert torch.allclose(a.double(), want, rtol=1e-5, atol=1e-3)


def test_kernel_refuses_what_it_does_not_take(card):
    m = _module("bn", 8, card)
    with pytest.raises(TypeError):
        m(torch.ones(4, 8, 3, 3, device=card, dtype=torch.float16), True, 2)
    with pytest.raises(ValueError, match="channels_last or contiguous"):
        m(torch.ones(4, 3, 3, 16, device=card)[..., ::2].permute(0, 3, 1, 2), True, 1)
    with pytest.raises(ValueError, match="even batch"):
        m(torch.ones(5, 8, 3, 3, device=card), True, 2)


def test_flagship_step_goes_through_k4(card):
    """One prototype-phase step of the flagship (mobilenet OS16, bf16, 128^2,
    B 2+2, T=4): one moments and one normalize launch per norm site forward
    (the S||T forward's sites plus the MC suffix's 5 moments and 2
    normalizes) and one reduce and one dx launch per site the loss reaches."""
    from uda_clr_tpu_torch.config import Config
    from uda_clr_tpu_torch.train.state import create_train_state
    from uda_clr_tpu_torch.train.steps import make_train_step

    cfg = Config()
    cfg.method.mc_samples = 4
    state = create_train_state(cfg, seed=0, device=card, method="prototype_full")
    sites = {"train": 0, "grad": 0}

    def count(module, inputs, output):
        sites["train"] += 1
        sites["grad"] += int(output.requires_grad)

    hooks = [m.register_forward_hook(count) for m in state.gen.modules()
             if isinstance(m, DomainNorm2d)]
    rng = np.random.default_rng(0)
    b, s = 2, 128
    batch = {k: torch.from_numpy(v.astype(np.float32)).to(card) for k, v in {
        "image_s": rng.standard_normal((b, s, s, 3)), "map_s": rng.uniform(size=(b, s, s, 2)) > 0.5,
        "boundary_s": rng.uniform(size=(b, s, s, 1)),
        "image_t": rng.standard_normal((b, s, s, 3))}.items()}
    step = make_train_step(cfg, "prototype_full", proto_phase=True)
    before = (K4.LAUNCHES_MOMENTS, K4.LAUNCHES_FWD, K4.LAUNCHES_REDUCE, K4.LAUNCHES_BWD)
    state, metrics = step(state, batch, 1e-3, 2.5e-5, epoch=30)
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    after = (K4.LAUNCHES_MOMENTS, K4.LAUNCHES_FWD, K4.LAUNCHES_REDUCE, K4.LAUNCHES_BWD)
    assert sites["train"] >= 61 and sites["grad"] >= 61
    assert [a - b for a, b in zip(after, before)] == [
        sites["train"] + 5, sites["train"] + 2, sites["grad"], sites["grad"]]
    assert np.isfinite(float(metrics["loss_all"]))


@pytest.mark.parametrize("dims", [(0, 2, 3), (0, 1, 2)])
def test_batch_moments_take_the_kept_dimension_as_channels(card, dims):
    """``batch_moments`` over (0, 2, 3) of an NCHW activation and over
    (0, 1, 2) of an NHWC one (the mask head's inputs) on K4, against the
    float32 plain moments."""
    from uda_clr_tpu_torch.models.norm import _moments, batch_moments

    g = torch.Generator(card).manual_seed(3)
    x = torch.randn(8, 16, 16, 48, device=card, generator=g).to(torch.bfloat16)
    if dims == (0, 2, 3):
        x = x.permute(0, 3, 1, 2)
    before = K4.LAUNCHES_MOMENTS
    mean, var = batch_moments(x, dims)
    want_mean, want_var, _ = _moments([x], dims)[0]
    assert K4.LAUNCHES_MOMENTS == before + 1 and mean.shape == (48,)
    torch.testing.assert_close(mean, want_mean, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(var, want_var, rtol=1e-5, atol=1e-6)


def test_tn_factor_matches_transfer_factor(card):
    """TransNorm's a1 in one launch against ``transfer_factor`` of the
    groups' float32 means and unbiased variances."""
    from uda_clr_tpu_torch.models.norm import _unbias, transfer_factor

    g = torch.Generator(card).manual_seed(4)
    x = (torch.randn(6, 48, 10, 10, device=card, generator=g) * 2 + 0.3).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    stats = K4.moments([(x, 2)])[0]
    mean, var, n = K4.mean_var(stats, 2, 48)
    vu = var * _unbias(n)[:, None]
    want = transfer_factor(mean[0], vu[0], mean[1], vu[1], 1e-5)
    torch.testing.assert_close(K4.tn_factor(stats, 48, 1e-5), want, rtol=1e-5, atol=1e-6)
