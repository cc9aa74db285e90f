"""The port's mask heads (uda_clr_tpu_torch/ops/mask_head.py: K1
fused_mask_head_split and the MC pass around it, train/steps.py:mc_suffix;
K2 fused_mask_head) against the JAX package's.

On the CPU the wrapper runs its plain version; the CUDA kernel is held to
that plain version elementwise on the card by
tests/test_torch_mask_head_cuda.py and by chip_smoke.py.

Tolerances: 1e-5 absolute on the epilogue (float32 sums over 305 channels
taken in another order); 1e-4 on the MC pass, which adds two 3x3 convs and
two batch norms in float32 before the epilogue; bitwise in the unit-weight
bf16 configuration, where each output's float32 sum holds one term."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_models import jax_deeplab_variables, port_deeplab
from uda_clr_tpu.models import layers as jax_layers
from uda_clr_tpu.ops.pallas.mask_head import (
    _xla_reference,
    fused_mask_head,
    fused_mask_head_split,
)
from uda_clr_tpu.train.steps import _mc_suffix
from uda_clr_tpu_torch.models import layers as port_layers
from uda_clr_tpu_torch.models.deeplab import nchw
from uda_clr_tpu_torch.ops import mask_head as mh
from uda_clr_tpu_torch.train.steps import kernel_seed, mc_suffix


def _inputs(n=2, hw=16, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(
        x_up=f(n, hw, hw, 256), ll=f(n, hw, hw, 48), boundary=f(n, hw, hw, 1),
        mean=0.1 * f(305), var=rng.uniform(0.5, 2.0, 305).astype(np.float32),
        scale=1.0 + 0.2 * f(305), bias=0.1 * f(305),
        w=0.05 * f(1, 1, 305, 2), w_bias=0.1 * f(2),
    )


def _port_args(a):
    t = lambda k: torch.from_numpy(a[k])
    w_oihw = torch.from_numpy(a["w"].transpose(3, 2, 0, 1).copy())
    return (t("x_up"), t("ll"), t("boundary"), t("mean"), t("var"), t("scale"),
            t("bias"), w_oihw, t("w_bias"))


def test_plain_matches_jax_reference_at_rate_zero():
    a = _inputs(seed=1)
    x_bu = np.concatenate([a["x_up"], a["ll"]], axis=-1)
    want = _xla_reference(x_bu, a["boundary"], a["mean"], a["var"], a["scale"], a["bias"],
                          a["w"], a["w_bias"], 0.0, 1e-5, jax.random.PRNGKey(0))
    got = mh.fused_mask_head_split(*_port_args(a), seed=5, rate=0.0)
    assert got.shape == (2, 16, 16, 2) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_plain_matches_pallas_interpret_all_kept():
    """The Pallas interpreter stubs the PRNG to zeros, so every element is
    kept and scaled by 1/keep; the plain version given all-zero bits does
    the same."""
    a = _inputs(seed=2)
    want = fused_mask_head_split(
        a["x_up"], a["ll"], a["boundary"], a["mean"], a["var"], a["scale"], a["bias"],
        a["w"], a["w_bias"], jax.random.PRNGKey(9), rate=0.1, impl="interpret")
    bits = torch.zeros((2 * 16 * 16, 305), dtype=torch.int64)
    got = mh.mask_head_plain(*_port_args(a), rate=0.1, bits=bits)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_plain_matches_pallas_interpret_bf16_unit_weight():
    """bf16 at rate 0.1 with every element kept: output 0 is channel 7 and
    output 1 channel 260 after BN, ReLU and dropout (w = 1, bias 0), so the
    float32 sums hold one term each and the plain version must equal the
    TPU kernel bit for bit. The TPU kernel scales by 1/keep rounded to bf16
    (1.109375), not by float32 1/0.9."""
    a = _inputs(seed=4)
    a["w"][:] = 0.0
    a["w"][0, 0, 7, 0] = 1.0
    a["w"][0, 0, 260, 1] = 1.0
    a["w_bias"][:] = 0.0
    bf = lambda k: jnp.asarray(a[k], jnp.bfloat16)
    want = fused_mask_head_split(
        bf("x_up"), bf("ll"), bf("boundary"), a["mean"], a["var"], a["scale"], a["bias"],
        a["w"], a["w_bias"], jax.random.PRNGKey(9), rate=0.1, impl="interpret")
    args = list(_port_args(a))
    args[:3] = [t.to(torch.bfloat16) for t in args[:3]]
    bits = torch.zeros((2 * 16 * 16, 305), dtype=torch.int64)
    got = mh.mask_head_plain(*args, rate=0.1, bits=bits)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    assert (want != 0).mean() > 0.3  # ReLU leaves enough nonzero outputs to compare
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_k2_plain_matches_pallas_interpret_all_kept():
    """K2 (x_bu[304] | boundary[1]) against the TPU kernel in interpret mode,
    every element kept, and against its XLA plain version at rate 0."""
    a = _inputs(seed=5)
    x_bu = np.concatenate([a["x_up"], a["ll"]], axis=-1)
    common = (a["boundary"], a["mean"], a["var"], a["scale"], a["bias"], a["w"], a["w_bias"],
              jax.random.PRNGKey(3))
    args = _port_args(a)
    port_args = (torch.from_numpy(x_bu),) + args[2:]
    want = fused_mask_head(x_bu, *common, rate=0.1, impl="interpret")
    bits = torch.zeros((2 * 16 * 16, 305), dtype=torch.int64)
    got = mh.mask_head_bu_plain(*port_args, rate=0.1, bits=bits)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    want0 = fused_mask_head(x_bu, *common, rate=0.0, impl="xla")
    got0 = mh.fused_mask_head(*port_args, seed=3, rate=0.0)
    assert got0.shape == (2, 16, 16, 2)
    np.testing.assert_allclose(got0.numpy(), np.asarray(want0), rtol=0, atol=1e-5)


def test_k2_draws_k1s_stream():
    """K2 on cat(x_up, ll) equals K1 on the split views with the same seed:
    channel c of row r is element r*305 + c of the stream in both."""
    a = _inputs(n=1, hw=8, seed=6)
    args = _port_args(a)
    x_bu = torch.cat([args[0], args[1]], dim=-1)
    seed = kernel_seed(2, 9)
    k1 = mh.fused_mask_head_split(*args, seed=seed, rate=0.1)
    k2 = mh.fused_mask_head(x_bu, *args[2:], seed=seed, rate=0.1)
    assert torch.equal(k1, k2)
    assert not torch.equal(k1, mh.fused_mask_head_split(*args, seed=seed, rate=0.0))


def test_philox_known_answer():
    """Random123's published vector for Philox4x32-10 at counter 0, key 0."""
    zero = torch.zeros(1, dtype=torch.int64)
    words = [int(w) for w in mh.philox4x32_10(zero, zero, 0)]
    assert words == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]


def test_philox_keep_rate_and_determinism():
    m, rate = 4096, 0.1
    bits = mh.philox_bits(m, kernel_seed(3, 0), "cpu", rows_per_chunk=1000)
    assert bits.shape == (m, 305) and int(bits.min()) >= 0 and int(bits.max()) < 2**32
    kept = (bits < mh.keep_threshold(rate)).double().mean().item()
    n = m * 305
    sigma = (0.9 * 0.1 / n) ** 0.5
    assert abs(kept - 0.9) < 3 * sigma
    # the stream depends on the element index only, not on the chunking
    assert torch.equal(bits, mh.philox_bits(m, kernel_seed(3, 0), "cpu"))
    other = mh.philox_bits(m, kernel_seed(3, 1), "cpu")
    assert (bits == other).double().mean().item() < 1e-3
    # rate 0 keeps every draw, 0xFFFFFFFF included
    assert mh.keep_threshold(0.0) == 2**32


def test_philox_bits_chunks_off_a_group_boundary():
    """Chunks of 999 rows start at element 999*305*k, which is 3 (mod 4)
    for k = 1: the chunk's first word is the last of a Philox group. The
    stream still depends on the element index only, as the kernel's tile
    draw (whole groups from 305*r0 on) assumes."""
    m, seed = 2500, kernel_seed(4, 2)
    assert (999 * 305) % 4 == 3
    chunked = mh.philox_bits(m, seed, "cpu", rows_per_chunk=999)
    assert torch.equal(chunked, mh.philox_bits(m, seed, "cpu"))
    # element e is word e & 3 of group e >> 2
    e = 999 * 305
    words = mh.philox4x32_10(torch.tensor([e >> 2]), torch.zeros(1, dtype=torch.int64), seed)
    assert int(chunked.view(-1)[e]) == int(words[e & 3])


def test_plain_dropout_follows_bits():
    """At rate 0.1 the plain version drops exactly the elements whose draw is
    at or above the threshold (checked through a unit-weight channel)."""
    a = _inputs(n=1, hw=8, seed=3)
    a["mean"][:] = -10.0  # every post-BN value positive: relu keeps all
    a["var"][:] = 1.0
    a["scale"][:] = 1.0
    a["bias"][:] = 0.0
    a["w"][:] = 0.0
    a["w"][0, 0, 7, 0] = 1.0  # output 0 = channel 7 after dropout
    args = _port_args(a)
    seed = kernel_seed(11, 4)
    got = mh.fused_mask_head_split(*args, seed=seed, rate=0.1)
    bits = mh.philox_bits(64, seed, "cpu")
    keep = bits[:, 7] < mh.keep_threshold(0.1)
    h = (torch.from_numpy(a["x_up"]).reshape(64, 256)[:, 7] + 10.0) * torch.rsqrt(
        torch.tensor(1.0 + 1e-5))
    assert torch.equal(got.reshape(64, 2)[:, 0] == a["w_bias"][0], ~keep)
    torch.testing.assert_close(got.reshape(64, 2)[keep, 0],
                               h[keep] * mh.inv_keep(0.1, torch.float32) + float(a["w_bias"][0]),
                               rtol=1e-5, atol=1e-5)


@pytest.fixture()
def dropout_off():
    prev = jax_layers._DROPOUT_IMPL, port_layers.dropout_impl()
    jax_layers.set_dropout_impl("off")
    port_layers.set_dropout_impl("off")
    yield
    jax_layers.set_dropout_impl(prev[0])
    port_layers.set_dropout_impl(prev[1])


def test_mc_suffix_matches_jax(dropout_off):
    model, params, stats = jax_deeplab_variables(seed=8)
    b, t, size = 2, 4, 64
    rng = np.random.default_rng(9)
    feat_predrop = np.abs(rng.standard_normal((b, size // 16, size // 16, 256))).astype(np.float32)
    ll = np.abs(rng.standard_normal((b, size // 4, size // 4, 48))).astype(np.float32)
    want = _mc_suffix(model, params, stats, jnp.asarray(feat_predrop), jnp.asarray(ll),
                      (size, size), b, t, jax.random.PRNGKey(0), "threefry2x32", "auto")
    gen = port_deeplab(params, stats)
    before = {k: v.clone() for k, v in gen.state_dict().items()}
    got = mc_suffix(gen, nchw(torch.from_numpy(feat_predrop)), nchw(torch.from_numpy(ll)),
                    (size, size), b, t, None, seed=0)
    assert tuple(got.shape) == (t, b, size, size, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    # the MC pass writes no running stats
    assert all(torch.equal(v, before[k]) for k, v in gen.state_dict().items())
