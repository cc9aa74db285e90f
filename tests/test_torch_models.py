"""The port's models (uda_clr_tpu_torch/models) against the JAX package's,
from the same JAX-initialised weights carried over by the weight bridge
(uda_clr_tpu_torch/convert/from_jax.py). The port runs on the CPU.

Tolerance: 2e-3 absolute / 1e-3 relative on DeepLab outputs, as
tests/test_convert.py holds the JAX model to the torch transcription (fp32
convolutions accumulate in different orders over ~60 layers); 1e-5 on
single layers.

The JAX model's init and forward are traced as one program each and shared
by the cases (one compile per shape, not one per op and case)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uda_clr_tpu.convert.torch_import import (
    convert_deeplab_state_dict,
    convert_discriminator_state_dict,
)
from uda_clr_tpu.models import layers as jax_layers
from uda_clr_tpu.models.deeplab import DeepLab as JaxDeepLab
from uda_clr_tpu.models.gan import BoundaryDiscriminator, UncertaintyDiscriminator
from uda_clr_tpu.models.mobilenet import mobilenet_block_plan as jax_block_plan
from uda_clr_tpu.models.norm import DomainNorm2d as JaxDomainNorm2d
from uda_clr_tpu_torch.convert.from_jax import deeplab_state_dict, discriminator_state_dict
from uda_clr_tpu_torch.models import layers as port_layers
from uda_clr_tpu_torch.models.deeplab import DeepLab
from uda_clr_tpu_torch.models.gan import PatchDiscriminator
from uda_clr_tpu_torch.models.mobilenet import mobilenet_block_plan
from uda_clr_tpu_torch.models.norm import DomainNorm2d

# two torch threads: at one per core the port's CPU work and XLA's threads
# contend in one process (a port step took ~10 s instead of ~0.3 s)
pytestmark = pytest.mark.usefixtures("two_threads")


@pytest.fixture(scope="module")
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


SIZE, B = 64, 2


def to_np(tree):
    return jax.tree.map(lambda a: np.array(a, dtype=np.float32), tree)


def perturb_bn(params, stats, rng):
    """Random BN affine params and running stats (init leaves them at
    1/0/0/1, which would hide a swapped field)."""
    params, stats = to_np(params), to_np(stats)

    def walk(p, s):
        for k, v in p.items():
            if isinstance(v, dict) and "scale" in v:
                c = v["scale"].shape[0]
                v["scale"] = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
                v["bias"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
                s[k]["mean"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
                s[k]["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            elif isinstance(v, dict):
                walk(v, s.get(k, {}))

    walk(params, stats)
    return params, stats


@functools.lru_cache(maxsize=None)
def _jax_deeplab(size):
    """The JAX mobilenet DeepLab and its init at ``size``, compiled once."""
    model = JaxDeepLab(num_classes=2, backbone="mobilenet", output_stride=16, norm="bn")
    return model, jax.jit(lambda key: model.init(key, jnp.zeros((1, size, size, 3)), train=False))


def jax_deeplab_variables(seed=0, size=SIZE):
    model, init = _jax_deeplab(size)
    v = init(jax.random.PRNGKey(seed))
    params, stats = perturb_bn(v["params"], v["batch_stats"], np.random.default_rng(seed))
    return model, params, stats


def port_deeplab(params, stats):
    gen = DeepLab()
    gen.load_state_dict(deeplab_state_dict(params, stats))
    return gen


@pytest.fixture()
def dropout_off():
    prev = jax_layers._DROPOUT_IMPL, port_layers.dropout_impl()
    jax_layers.set_dropout_impl("off")
    port_layers.set_dropout_impl("off")
    yield
    jax_layers.set_dropout_impl(prev[0])
    port_layers.set_dropout_impl(prev[1])


def test_block_plan_matches_jax():
    assert mobilenet_block_plan(16) == jax_block_plan(16)


@pytest.mark.parametrize("train,domains", [(False, 1), (True, 1), (True, 2)])
def test_domain_norm_matches_jax(train, domains):
    rng = np.random.default_rng(1)
    c = 7
    x = (rng.standard_normal((4, 5, 6, c)) * 2 + 0.5).astype(np.float32)
    scale = rng.standard_normal(c).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    mean = rng.standard_normal(c).astype(np.float32)
    var = rng.uniform(0.5, 2, c).astype(np.float32)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean, "var": var}}
    want, upd = JaxDomainNorm2d(c).apply(variables, x, train, domains, mutable=["batch_stats"])

    m = DomainNorm2d(c)
    m.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
                       "running_mean": torch.from_numpy(mean),
                       "running_var": torch.from_numpy(var)})
    got = m(torch.from_numpy(x).permute(0, 3, 1, 2), train, domains).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(m.running_mean.numpy(), np.asarray(upd["batch_stats"]["mean"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(m.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-6, atol=1e-6)


_STAT_SAMPLES = (
    ("backbone.features.0.1", ("backbone", "stem_bn")),
    ("backbone.features.17.conv.7", ("backbone", "block_16", "project_bn")),
    ("aspp.global_avg_pool.2", ("aspp", "gap_bn")),
    ("decoder.last_conv.0", ("decoder", "mask_bn")),
    ("decoder.last_conv_boundary.5", ("decoder", "bound_bn2")),
)


@pytest.mark.parametrize("train,domains", [(False, 1), (True, 1), (True, 2)])
def test_deeplab_outputs_match_jax(dropout_off, train, domains):
    model, params, stats = jax_deeplab_variables(seed=3)
    x = np.random.default_rng(4).standard_normal((B, SIZE, SIZE, 3)).astype(np.float32)
    want, upd = jax.jit(lambda v, x: model.apply(v, x, train=train, domains=domains,
                                                  mutable=["batch_stats"]))(
        {"params": params, "batch_stats": stats}, x)
    gen = port_deeplab(params, stats)
    with torch.no_grad():
        got = gen(torch.from_numpy(x), train, domains)
    assert got._fields == want._fields
    for name, g, w in zip(got._fields, got, want):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3, atol=2e-3, err_msg=name)
    sd = gen.state_dict()
    for key, path in _STAT_SAMPLES:
        node = upd["batch_stats"]
        for p in path:
            node = node[p]
        np.testing.assert_allclose(sd[f"{key}.running_mean"].numpy(), np.asarray(node["mean"]),
                                   rtol=1e-3, atol=1e-5, err_msg=key)
        np.testing.assert_allclose(sd[f"{key}.running_var"].numpy(), np.asarray(node["var"]),
                                   rtol=1e-3, atol=1e-5, err_msg=key)


@pytest.mark.parametrize("cls,channels", [(BoundaryDiscriminator, 1), (UncertaintyDiscriminator, 2)])
def test_discriminators_match_jax(cls, channels):
    params = to_np(jax.jit(lambda k: cls().init(k, jnp.zeros((1, SIZE, SIZE, channels))))(
        jax.random.PRNGKey(channels))["params"])
    x = np.random.default_rng(5).uniform(0, 1, (B, SIZE, SIZE, channels)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x: cls().apply({"params": p}, x))(params, x))
    dis = PatchDiscriminator(channels)
    dis.load_state_dict(discriminator_state_dict(params))
    with torch.no_grad():
        got = dis(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_bridge_round_trip():
    """JAX params -> port state_dict -> the JAX package's own converter ->
    the original trees, bit for bit; and the port's module takes the
    state_dict strictly (same keys and shapes)."""
    _, params, stats = jax_deeplab_variables(seed=6)
    sd = deeplab_state_dict(params, stats)
    assert set(sd) == set(DeepLab().state_dict())
    back_p, back_s = convert_deeplab_state_dict({k: v.numpy() for k, v in sd.items()})
    flat = lambda t: {jax.tree_util.keystr(k): np.asarray(v)
                      for k, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    for want, got in ((params, back_p), (stats, back_s)):
        fw, fg = flat(want), flat(got)
        assert fw.keys() == fg.keys()
        for k in fw:
            np.testing.assert_array_equal(fg[k], fw[k], err_msg=k)

    dparams = to_np(jax.jit(lambda k: BoundaryDiscriminator().init(k, jnp.zeros((1, 32, 32, 1))))(
        jax.random.PRNGKey(0))["params"])
    back = convert_discriminator_state_dict(
        {k: v.numpy() for k, v in discriminator_state_dict(dparams).items()})
    for i in range(1, 6):
        np.testing.assert_array_equal(back[f"conv{i}"]["conv"]["kernel"],
                                      dparams[f"conv{i}"]["conv"]["kernel"])


def test_port_init_is_seeded():
    a, b = DeepLab(seed=1).state_dict(), DeepLab(seed=1).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    c = DeepLab(seed=2).state_dict()
    assert not torch.equal(a["aspp.conv1.weight"], c["aspp.conv1.weight"])
