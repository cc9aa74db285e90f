"""The norm kernel K4's wrapper (uda_clr_tpu_torch/ops/domain_norm.py) on the
CPU: CPU tensors take models/norm.py's op-by-op plain version with the same
bits as before the kernel, the wrapper's checks raise, its launch plan
keeps the kernel's limits, and its ctypes signatures match the C entries
of csrc/domain_norm.cu. The kernel itself is held to the plain version on
the card by tests/test_torch_domain_norm_cuda.py and chip_smoke.py."""

import ctypes
import re

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from uda_clr_tpu_torch.models import norm
from uda_clr_tpu_torch.models.norm import DomainNorm2d
from uda_clr_tpu_torch.ops import cuda_build
from uda_clr_tpu_torch.ops import domain_norm as K4


@pytest.fixture(autouse=True)
def two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _counters():
    return (K4.LAUNCHES_MOMENTS, K4.LAUNCHES_FWD, K4.LAUNCHES_REDUCE, K4.LAUNCHES_BWD, K4.BYTES)


def _module(mode: str, c: int, seed: int = 0) -> DomainNorm2d:
    m = DomainNorm2d(c, mode=mode)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        m.weight.copy_(1 + 0.1 * torch.randn(c, generator=g))
        m.bias.copy_(0.1 * torch.randn(c, generator=g))
        for b in m.buffers():
            b.copy_(0.2 + torch.rand(b.shape, generator=g))
    return m


def _seed_bn(m: DomainNorm2d, x: torch.Tensor, train: bool, domains: int) -> torch.Tensor:
    """The BN norm as the port ran it before K4, written out: float32
    moments E[x^2] - E[x]^2, the EMA (target half first), the normalize in
    x's dtype."""
    dt = x.dtype

    def apply(x, mean, var, scale, bias):
        shape = mean.shape[:-1] + (mean.shape[-1], 1, 1)
        inv = torch.rsqrt(var + m.eps)
        return (x - mean.reshape(shape).to(dt)) * (inv * scale).reshape(shape).to(dt) \
            + bias.reshape(bias.shape[:-1] + (-1, 1, 1)).to(dt)

    def ema(mean, var, n):
        with torch.no_grad():
            m.running_mean.copy_(0.9 * m.running_mean + 0.1 * mean)
            m.running_var.copy_(0.9 * m.running_var + 0.1 * (var * (n / max(n - 1, 1))))

    if not train:
        return apply(x, m.running_mean, m.running_var, m.weight, m.bias)
    if domains <= 1:
        x32 = x.float()
        mean = x32.mean((0, 2, 3))
        var = torch.clamp((x32 * x32).mean((0, 2, 3)) - mean * mean, min=0.0)
        ema(mean.detach(), var.detach(), x.shape[0] * x.shape[2] * x.shape[3])
        return apply(x, mean, var, m.weight, m.bias)
    b = x.shape[0] // 2
    x2 = x.unflatten(0, (2, b))
    x32 = x2.float()
    mean = x32.mean((1, 3, 4))
    var = torch.clamp((x32 * x32).mean((1, 3, 4)) - mean * mean, min=0.0)
    n = b * x.shape[2] * x.shape[3]
    ema(mean[1].detach(), var[1].detach(), n)
    ema(mean[0].detach(), var[0].detach(), n)
    z = apply(x2, mean[:, None, :], var[:, None, :], m.weight.expand(2, -1)[:, None, :], m.bias)
    return z.flatten(0, 1)


MODES = [(True, 2), (True, 1), (False, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels_last", [True, False])
@pytest.mark.parametrize("train,domains", MODES)
def test_cpu_bn_is_bitwise_the_seed_after_two_steps(dtype, channels_last, train, domains):
    """Outputs, gradients and running stats of two steps through the routed
    forward equal the pre-kernel formulas bit for bit, and no kernel
    counter moves."""
    g = torch.Generator().manual_seed(1)
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    got, want = _module("bn", 24), _module("bn", 24)
    before = _counters()
    for step in range(2):
        x = (2 * torch.randn(4, 24, 5, 6, generator=g) + 0.5).to(dtype).contiguous(
            memory_format=fmt)
        cot = torch.randn(4, 24, 5, 6, generator=g).to(dtype)
        outs = []
        for m, fn in ((got, lambda m, x: m(x, train, domains)),
                      (want, lambda m, x: _seed_bn(m, x, train, domains))):
            xi = x.clone().requires_grad_()
            m.zero_grad()
            y = fn(m, xi)
            y.backward(cot)
            outs.append((y.detach(), xi.grad, m.weight.grad, m.bias.grad))
        for a, b in zip(*outs):
            assert torch.equal(a, b), f"step {step}"
        for (name, a), b in zip(got.named_buffers(), want.buffers()):
            assert torch.equal(a, b), f"{name} after step {step}"
    assert _counters() == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,train,domains", [(4, True, 2), (5, True, 2), (4, True, 0),
                                             (4, False, 1)])
def test_cpu_tn_takes_the_plain_version(dtype, n, train, domains):
    """TransNorm (even and uneven halves, ``domains=0``, eval) on CPU
    tensors: the routed forward is the plain version, bit for bit, over two
    steps, and no kernel counter moves."""
    g = torch.Generator().manual_seed(2)
    got, want = _module("tn", 16), _module("tn", 16)
    before = _counters()
    for _ in range(2):
        x = (torch.randn(n, 16, 4, 4, generator=g) + 0.3).to(dtype).contiguous(
            memory_format=torch.channels_last)
        cot = torch.randn(n, 16, 4, 4, generator=g).to(dtype)
        outs = []
        for m, fn in ((got, got.forward), (want, want.forward_plain)):
            xi = x.clone().requires_grad_()
            m.zero_grad()
            y = fn(xi, train, domains)
            y.backward(cot)
            outs.append((y.detach(), xi.grad, m.weight.grad, m.bias.grad, *m.buffers()))
        for a, b in zip(*outs):
            assert torch.equal(a, b)
    assert _counters() == before


def test_cpu_moments_and_normalize_take_the_plain_version():
    """The MC suffix's ``batch_moments_parts`` and ``normalize`` on CPU
    tensors: the op-by-op float32 moments and normalize, bit for bit."""
    g = torch.Generator().manual_seed(3)
    xs = [torch.randn(6, c, 8, 8, generator=g).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last) for c in (16, 48, 1)]
    before = _counters()
    got = norm.batch_moments_parts(xs, (0, 2, 3))
    for (mean, var), x in zip(got, xs):
        x32 = x.float()
        want = x32.mean((0, 2, 3))
        assert torch.equal(mean, want)
        assert torch.equal(var, torch.clamp((x32 * x32).mean((0, 2, 3)) - want * want, min=0.0))
    mean, var = got[0]
    scale, bias = torch.rand(16, generator=g) + 0.5, torch.randn(16, generator=g)
    assert torch.equal(norm.normalize(xs[0], mean, var, scale, bias),
                       norm.normalize_plain(xs[0], mean, var, scale, bias))
    assert _counters() == before


def test_launches_only_on_real_cuda_tensors():
    assert not K4.launches_on(torch.ones(2, 3, 4, 4))
    assert not K4.launches_on(torch.ones(2, 3, 4, 4, device="meta"))
    with FakeTensorMode() as mode:
        fake = mode.from_tensor(torch.ones(2, 3, 4, 4))
    assert not K4.launches_on(fake)


def test_wrapper_checks_raise():
    x = torch.ones(2, 8, 4, 4)
    with pytest.raises(ValueError, match="CUDA"):
        K4.moments([(x, None)])
    with pytest.raises(ValueError, match=r"\[N, C, H, W\]"):
        K4.channels_last(torch.ones(2, 8, 4))
    with pytest.raises(ValueError, match="channels_last or contiguous"):
        K4.channels_last(torch.ones(2, 4, 4, 8).transpose(1, 3))
    assert K4.channels_last(x.contiguous(memory_format=torch.channels_last))
    assert not K4.channels_last(x)
    with pytest.raises(TypeError, match="float32"):
        K4._vector(torch.ones(8, dtype=torch.float64), 8, "scale", x.device)
    with pytest.raises(ValueError, match="contiguous"):
        K4._vector(torch.ones(9), 8, "scale", x.device)
    with pytest.raises(ValueError, match="constant statistics"):
        K4.normalize_fixed(x, torch.zeros(8, requires_grad=True), torch.ones(8), torch.ones(8),
                           torch.zeros(8), 1e-5)
    with pytest.raises(ValueError, match="split"):
        K4.plan_of(x, 3)


# the step's norm sites at 512^2, B 8+8 (the MC site is one group)
SITES = [((16, 96, 258, 258), 8), ((16, 305, 128, 128), 8), ((64, 256, 128, 128), None),
         ((16, 256, 128, 128), 8), ((16, 320, 32, 32), 8), ((16, 2048, 32, 32), 8),
         ((5, 1, 7, 7), 2), ((2, 24, 1, 1), 0)]


@pytest.mark.parametrize("shape,k", SITES)
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("cl", [True, False])
def test_plan_keeps_the_kernel_limits(shape, k, itemsize, cl):
    n, c, h, w = shape
    kk, groups = (n, 1) if k is None else (k, 2)
    sms = 132
    plan = K4._plan(n, c, h * w, kk, groups, cl, itemsize, 16, sms)
    (_, _, hw, k0, g, is_cl, vec, lanes, rpp, tiles, ch0, ch1) = plan
    assert (k0, g, is_cl) == (kk, groups, int(cl))
    run = c if cl else hw
    assert run % vec == 0 and vec * itemsize <= 16
    # the widest vector that divides the run
    assert vec == 16 // itemsize or run % (2 * vec)
    if not cl:
        assert (ch0, ch1) == (kk, n - kk)
        return
    vectors = c // vec
    assert lanes * rpp <= K4._THREADS and (tiles - 1) * lanes < vectors <= tiles * lanes
    rows = (kk * hw, (n - kk) * hw)
    for chunks, r in zip((ch0, ch1), rows):
        assert (chunks == 0) == (r == 0)
    assert ch0 + ch1 <= max(K4._BLOCKS_PER_SM) * sms // tiles + 2


def test_plan_of_the_largest_sites():
    """16-byte vectors along C where C allows, one tile below 256 vectors,
    and enough blocks for 132 SMs at the small late sites."""
    assert K4._plan(16, 96, 258 * 258, 8, 2, True, 2, 16, 132)[6:] == (8, 12, 21, 1, 264, 264)
    assert K4._plan(16, 305, 128 * 128, 8, 2, True, 2, 16, 132)[6:10] == (1, 153, 1, 2)
    late = K4._plan(16, 320, 32 * 32, 8, 2, True, 2, 16, 132)
    assert late[6:10] == (8, 40, 6, 1) and late[10] + late[11] >= 132
    # a 4-byte aligned pointer caps bf16 vectors at 2 elements
    assert K4._plan(16, 96, 64, 8, 2, True, 2, 4, 132)[6] == 2


_CTYPES = {"const void*": cuda_build.P, "void*": cuda_build.P, "float*": cuda_build.P,
           "const float*": cuda_build.P, "int": cuda_build.INT,
           "long long": cuda_build.I64, "float": cuda_build.F32}


def test_signatures_match_the_source():
    """Every ``extern "C"`` entry of csrc/domain_norm.cu takes the ctypes
    types the wrapper declares, in order (a pointer as a 64-bit void*, an
    int, a long long, a float), and returns an int."""
    source = (cuda_build.CSRC / "domain_norm.cu").read_text()
    entries = re.findall(r'extern "C" (\w+) (\w+)\((.*?)\)\s*\{', source, re.S)
    assert {name for _, name, _ in entries} == set(K4.LIBRARY.signatures)
    for ret, name, params in entries:
        assert ret == "int", name
        types = [re.sub(r"\s+", " ", p.strip()).rsplit(" ", 1)[0].replace(" *", "*")
                 for p in params.split(",")]
        # a pointer's type ends in *, bound to its name in the source
        types = [t + "*" if p.strip().split()[-1].startswith("*") else t
                 for t, p in zip(types, params.split(","))]
        want = [_CTYPES[t] for t in types]
        assert K4.LIBRARY.signatures[name] == want, name
        assert all(a in (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float)
                   for a in want)
