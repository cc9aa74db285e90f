"""The port's dropout (uda_clr_tpu_torch/models/layers.py backends and the
fused kernel K3's plain version, ops/dropout.py) against the JAX package's
TpuDropout and ``dropout_pallas``.

The two frameworks' random streams cannot coincide, so the masks are
shared: the model dropout's mask is recovered from TpuDropout's output, and
the Pallas interpreter stubs its PRNG to zeros (every element kept), which
the plain version replays from all-zero words. Every comparison here is
bitwise: the scaling is one division or one product in the input dtype.
The CUDA kernel is held to the plain version on the card by
tests/test_torch_dropout_cuda.py and chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uda_clr_tpu.models import layers as jax_layers
from uda_clr_tpu.ops.pallas.dropout import dropout_pallas
from uda_clr_tpu_torch.models import layers as port_layers
from uda_clr_tpu_torch.ops import dropout as K3
from uda_clr_tpu_torch.ops.philox import inv_keep, keep_threshold, philox_words
from tests.torch_step_harness import two_threads  # noqa: F401  (fixture)

# two torch threads: at one per core the port's CPU work and XLA's threads
# contend in one process (a port step took ~10 s instead of ~0.3 s)
pytestmark = pytest.mark.usefixtures("two_threads")


DTYPES = [(jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)]


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.fixture()
def impl():
    prev = jax_layers._DROPOUT_IMPL, port_layers.dropout_impl()
    yield
    jax_layers.set_dropout_impl(prev[0])
    port_layers.set_dropout_impl(prev[1])


@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("backend", ["xla16", "xla"])
def test_model_dropout_scale_matches_tpu_dropout(impl, jdt, tdt, rate, backend):
    """Survivors are x / round_dt(keep) rounded to the dtype, bit for bit
    (a float32 1/keep moves about a third of the kept bf16 values at rate
    0.1 by one ulp)."""
    jax_layers.set_dropout_impl(backend)
    x = jnp.asarray(_x((4, 40, 40, 16)), jdt)
    out = jax_layers.TpuDropout(rate).apply({}, x, False, rngs={"dropout": jax.random.PRNGKey(1)})
    want = np.asarray(out.astype(jnp.float32))
    xs = np.array(x.astype(jnp.float32))
    mask = (want != 0) & (xs != 0)
    assert abs(mask.mean() - (1 - rate)) < 0.01
    got = port_layers.apply_keep_mask(torch.from_numpy(xs).to(tdt), torch.from_numpy(mask), rate)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("backend,rate", [("xla16", 0.1), ("xla16", 0.5), ("xla", 0.1)])
def test_model_dropout_keep_rate(impl, backend, rate):
    """'xla16' keeps a draw below min(round(keep*65536), 65535) of 2^16,
    'xla' below keep; both keep x's memory format."""
    port_layers.set_dropout_impl(backend)
    x = torch.ones(8, 16, 64, 64).to(memory_format=torch.channels_last)
    stream = port_layers.DropoutStream(torch.Generator().manual_seed(0))
    y = port_layers.dropout(x, rate, stream)
    assert y.is_contiguous(memory_format=torch.channels_last)
    kept = (y != 0).double().mean().item()
    n = x.numel()
    assert abs(kept - (1 - rate)) < 4 * ((rate * (1 - rate) / n) ** 0.5)
    assert torch.equal(y[y != 0], torch.full_like(y[y != 0], 1 / (1 - rate)))


def test_set_dropout_impl_names(impl):
    for name in ("auto", "xla", "xla16", "pallas", "off"):
        port_layers.set_dropout_impl(name)
        assert port_layers.dropout_impl() == name
    with pytest.raises(ValueError):
        port_layers.set_dropout_impl("bernoulli")


def test_pallas_backend_runs_k3_plain_on_cpu(impl):
    """Under 'pallas' (and 'auto') a model site is K3 with the stream's next
    seed; the MC pass's sites never take the kernel (steps.py:_mc_drop)."""
    x = torch.from_numpy(_x((2, 8, 6, 5))).requires_grad_()
    for name in ("pallas", "auto"):
        port_layers.set_dropout_impl(name)
        stream = port_layers.DropoutStream(None, seed=99)
        seed = port_layers.DropoutStream(None, seed=99).next_seed()
        before = K3.LAUNCHES_FWD, K3.LAUNCHES_BWD
        y = port_layers.dropout(x, 0.1, stream)
        assert torch.equal(y.detach(), K3.dropout_plain(x.detach(), seed, 0.1))
        assert stream.next_seed() != seed
        y.sum().backward()
        assert (K3.LAUNCHES_FWD, K3.LAUNCHES_BWD) == before  # CPU tensors launch nothing
    g = torch.Generator().manual_seed(3)
    got = port_layers.mc_dropout(x.detach(), 0.1, g)
    want = port_layers.bernoulli_dropout(x.detach(), 0.1, torch.Generator().manual_seed(3), False)
    assert torch.equal(got, want)


@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_k3_plain_matches_pallas_interpret(jdt, tdt, monkeypatch):
    """Forward and VJP against ``dropout_pallas(..., interpret=True)``, whose
    stubbed PRNG keeps every element: the plain version given all-zero
    words is x * round_dt(1/keep), and its backward g * round_dt(1/keep)."""
    rate = 0.1
    x = jnp.asarray(_x((2, 16, 16, 32), 1), jdt)
    g = jnp.asarray(_x((2, 16, 16, 32), 2), jdt)
    seed = jnp.int32(5)
    want, vjp = jax.vjp(lambda v: dropout_pallas(v, seed, rate, True), x)
    (want_grad,) = vjp(g)

    monkeypatch.setattr(K3, "philox_words",
                        lambda e0, e1, s, device: torch.zeros(e1 - e0, dtype=torch.int64))
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(tdt).requires_grad_()
    got = K3.fused_dropout(xt, 123, rate)
    got.backward(torch.from_numpy(np.array(g.astype(jnp.float32))).to(tdt))
    assert got.dtype == tdt and xt.grad.dtype == tdt
    np.testing.assert_array_equal(got.detach().float().numpy(), np.asarray(want.astype(jnp.float32)))
    np.testing.assert_array_equal(xt.grad.float().numpy(), np.asarray(want_grad.astype(jnp.float32)))


@pytest.mark.parametrize("tdt", [torch.bfloat16, torch.float32])
def test_k3_backward_takes_forward_memory_format(tdt):
    """A channels_last input with an NCHW-contiguous upstream gradient: the
    backward lays the gradient out as the forward's input before replaying
    the mask, so grad == mask * round_dt(1/keep) * g elementwise."""
    rate = 0.3
    x = torch.from_numpy(_x((3, 7, 5, 6), 3)).to(tdt).to(memory_format=torch.channels_last)
    x.requires_grad_()
    y = K3.fused_dropout(x, seed=2024, rate=rate)
    assert y.is_contiguous(memory_format=torch.channels_last)
    mask = (y != 0) & (x != 0)
    g = torch.from_numpy(_x((3, 7, 5, 6), 4)).to(tdt)
    assert g.is_contiguous() and not g.is_contiguous(memory_format=torch.channels_last)
    y.backward(g)
    want = torch.where(mask, g * inv_keep(rate, tdt), torch.zeros((), dtype=tdt))
    assert torch.equal(x.grad, want)
    assert 0.6 < mask.float().mean().item() < 0.8


def test_k3_plain_follows_memory_order():
    """Element e of the stream is the e-th element in memory: a
    channels_last tensor draws as its NHWC-contiguous twin does, and the
    words decide exactly which elements survive."""
    rate, seed = 0.25, 77
    x = torch.from_numpy(_x((2, 6, 5, 9), 5)).to(memory_format=torch.channels_last)
    y = K3.dropout_plain(x, seed, rate)
    twin = K3.dropout_plain(x.permute(0, 2, 3, 1).contiguous(), seed, rate)
    assert torch.equal(y.permute(0, 2, 3, 1), twin)
    words = philox_words(0, x.numel(), seed, "cpu").reshape(2, 5, 9, 6)
    keep = words < keep_threshold(rate)
    assert torch.equal(twin != 0, keep)
    assert torch.equal(twin[keep], (x.permute(0, 2, 3, 1)[keep] * inv_keep(rate, torch.float32)))


def test_k3_rate_zero_is_identity_and_rates_are_checked():
    x = torch.from_numpy(_x((4, 5)))
    assert K3.fused_dropout(x, 1, 0.0) is x
    with pytest.raises(ValueError):
        K3.dropout_plain(x, 1, 1.0)
