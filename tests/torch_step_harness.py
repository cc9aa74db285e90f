"""Shared harness of the port-vs-JAX step tests (tests/test_torch_step_*.py):
the same JAX-initialised weights carried over by the weight bridge, the
same numpy batches, dropout off on both sides, and both frameworks' train
steps run side by side.

The mask logits are spread (mask_out x10) so that sigmoid(mask_before)
straddles the 0.75 pseudo-label threshold, as tests/test_step_parity.py
does. lr_gen is 1e-5: from the second iteration on, each state inherits
Adam's first steps, whose size is lr wherever a gradient is nonzero and
whose sign is noise where the true gradient is ~0 (the biases of batch
norms that feed another batch norm), so the G params are held by the median
of their difference in units of lr (a missing or wrong update moves it to
~lr) and by their largest difference relative to their largest entry.

The JAX state is built by ``create_train_state`` traced as one program
(:func:`jax_train_state`): the eager init compiles op by op and takes
several times longer; its weights differ from the eager init's by float32
rounding only, and both frameworks start from the same ones either way."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_models import to_np
from uda_clr_tpu.config import Config as JaxConfig
from uda_clr_tpu.models import layers as jax_layers
from uda_clr_tpu.models.deeplab import DeepLab as JaxDeepLab
from uda_clr_tpu.train.state import create_train_state as jax_create_train_state
from uda_clr_tpu.train.steps import make_train_step as jax_make_train_step
from uda_clr_tpu_torch.config import Config
from uda_clr_tpu_torch.convert.from_jax import deeplab_state_dict, train_state_dicts
from uda_clr_tpu_torch.models import layers as port_layers
from uda_clr_tpu_torch.models.deeplab import DeepLab
from uda_clr_tpu_torch.train.state import BANK_SIZES, create_train_state
from uda_clr_tpu_torch.train.steps import make_train_step

B, SIZE, T = 2, 64, 4
LR_GEN, LR_DIS, EPOCH = 1e-5, 2.5e-5, 30

# Relative tolerance of each metric per iteration, set with a margin of at
# least 3x over what was measured on these inputs (torch 2.13 CPU, jax 0.9
# CPU at matmul precision 'highest'; the largest measured value over the
# step tests stands in the comment). Iteration 0 is float32 noise over ~60
# batch norms; later iterations inherit Adam's first-step sign noise.
RTOL = {
    "loss_seg": (3e-5, 6e-3, 1e-2),  # 8.2e-6, 1.9e-3, 3.2e-3
    "loss_all": (3e-5, 6e-3, 1e-2),  # 8.2e-6, 1.9e-3, 3.2e-3
    "loss_adv": (1e-6, 2e-5, 2e-5),  # 1.3e-7, 4.4e-6, 2.2e-6
    "loss_D": (1e-6, 1e-5, 3e-5),  # 8.6e-8, 1.4e-6, 6.2e-6
    "loss_D2": (2e-6, 5e-5, 5e-5),  # 4.3e-7, 1.1e-5, 1.4e-5
    "loss_consistency": (2e-4, 2e-3, None),  # 4.4e-5, 3.6e-4
    "loss_intra": (3e-4, 1e-2, 2e-2),  # 6.5e-5, 2.0e-3, 5.3e-3
    "loss_inter": (1e-4, 2e-3, 1e-3),  # 2.1e-5, 4.1e-4, 2.3e-4
    "loss_src_reg": (None, 5e-4, 2e-3),  # -, 1.1e-4, 4.5e-4
    # loss_aug counts pixels through two hard thresholds (pseudo-label, MC
    # std < 0.04) that the sign noise flips: held at unit level here (7.4e-2,
    # 1.1e-3), exactly in tests/test_torch_ops_mt.py
    "loss_aug": (None, 0.25, 0.25),
    # the disk-bank method (prototype): pools through the hard epoch-ramped
    # thresholds, so iteration 1 inherits threshold flips
    "loss_cup": (4e-5, 2e-2),  # 1.1e-5, 5.5e-3
    "loss_disc": (1.5e-4, 1.2e-3),  # 4.4e-5, 3.4e-4
    "loss_bu": (1.2e-4, 2e-2),  # 3.4e-5, 6.6e-3
}
# norm='tn': TransNorm splits B=2 into halves of one image, whose moments and
# the per-channel alpha carry more of the iteration-1 sign noise
TN_RTOL = {
    "loss_intra": (3e-4, 1.5e-2),  # 8.2e-5, 4.1e-3
    "loss_adv": (1e-6, 3e-5),  # 2.0e-7, 7.9e-6
}
TN_STATS_RTOL = 1.2e-2  # TN running stats (measured <= 3.8e-3)
# after the iterations, relative to each tensor's largest entry
PARAM_RTOL = 1e-3  # G and teacher params (measured <= 3.1e-4)
PARAM_MEDIAN_LR = 0.2  # G params: median |diff| / lr (measured <= 0.037)
STATS_RTOL = 6e-3  # BN running stats (measured <= 2.0e-3)
DIS_RTOL = 1e-6  # D params after SGD (measured <= 3.1e-7)

G_PARAMS = (
    ("backbone.features.0.0.weight", ("backbone", "stem", "conv", "kernel")),
    ("aspp.conv1.weight", ("aspp", "proj_conv", "conv", "kernel")),
    ("decoder.last_conv.3.weight", ("decoder", "mask_out", "conv", "kernel")),
    ("decoder.last_conv_boundary.4.weight", ("decoder", "bound_conv2", "conv", "kernel")),
)
BN_STATS = (
    ("backbone.features.0.1", ("backbone", "stem_bn")),
    ("aspp.bn1", ("aspp", "proj_bn")),
    ("decoder.last_conv.0", ("decoder", "mask_bn")),
    ("decoder.last_conv_boundary.1", ("decoder", "bound_bn1")),
)


_STATE_PROGRAMS = {}


def jax_train_state(model, **kwargs):
    """The JAX package's ``create_train_state`` at the test shape from
    PRNGKey(0), traced and compiled as one program, once per model
    configuration and options in a process (the cases of a file share it)."""
    key = (model.backbone, model.output_stride, model.norm, tuple(sorted(kwargs.items())))
    if key not in _STATE_PROGRAMS:
        _STATE_PROGRAMS[key] = jax.jit(
            lambda k: jax_create_train_state(model, k, (B, SIZE, SIZE, 3), **kwargs))
    return _STATE_PROGRAMS[key](jax.random.PRNGKey(0))


def get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def make_batch(rng, method):
    batch = {
        "image_s": rng.standard_normal((B, SIZE, SIZE, 3)).astype(np.float32),
        "map_s": (rng.uniform(0, 1, (B, SIZE, SIZE, 2)) > 0.5).astype(np.float32),
        "boundary_s": rng.uniform(0, 1, (B, SIZE, SIZE, 1)).astype(np.float32),
        "image_t": rng.standard_normal((B, SIZE, SIZE, 3)).astype(np.float32),
    }
    if method == "baseline":
        del batch["image_t"]
    return batch


@pytest.fixture(scope="module")
def two_threads():
    """Two torch threads for the port's side (the suite runs files side by
    side on a few cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


@pytest.fixture()
def dropout_off():
    prev = jax_layers._DROPOUT_IMPL, port_layers.dropout_impl()
    jax_layers.set_dropout_impl("off")
    port_layers.set_dropout_impl("off")
    yield
    jax_layers.set_dropout_impl(prev[0])
    port_layers.set_dropout_impl(prev[1])


def jax_aug_draws(jstate, b: int) -> np.ndarray:
    """The nine uniforms per image the JAX step's strong_augment draws
    (steps.py:560 splits k_aug from the state's rng; augment.py:121-162)."""
    k_aug = jax.random.split(jstate.rng, 6)[3]
    return np.stack([
        np.asarray([jax.random.uniform(k) for k in jax.random.split(key, 9)])
        for key in jax.random.split(k_aug, b)]).astype(np.float32)


def run_steps(method: str, phases, configure=None, monkeypatch=None, norm: str = "bn",
              prepare=None, each=None):
    """Run ``len(phases)`` iterations of ``method`` (``phases`` = the
    proto_phase flag of each) in both frameworks under ``norm``.
    ``configure(mcfg)`` edits both method configs; ``prepare(jstate)``
    returns the JAX state to start from (the port's is carried over from
    it); ``each(iteration, jstate, state)`` is called after each iteration.
    With ``monkeypatch`` the port's augmentation takes the JAX step's
    draws. Returns (jstate, state, [(got, want) per iter])."""
    jcfg = JaxConfig()
    jcfg.model.compute_dtype = "float32"
    jcfg.model.norm = norm
    jcfg.method.mc_samples = T
    jcfg.method.rng_impl = "threefry2x32"  # rbg keys are TPU-only
    cfg = Config()
    cfg.model.norm = norm
    cfg.method.mc_samples = T
    if configure is not None:
        configure(jcfg.method)
        configure(cfg.method)
    teacher = method == "mean_teacher"
    model = JaxDeepLab(num_classes=2, backbone="mobilenet", output_stride=16, norm=norm)
    jstate = jax_train_state(model, with_teacher=teacher,
                             with_proto_bank=method == "prototype",
                             with_cls2=method == "bcdm")
    params = to_np(jstate.gen_params)
    params["decoder"]["mask_out"]["conv"]["kernel"] *= 10.0
    gp = jax.tree.map(jnp.asarray, params)
    jstate = jstate.replace(gen_params=gp)
    if teacher:
        jstate = jstate.replace(teacher_params=jax.tree.map(jnp.copy, gp))
    if prepare is not None:
        jstate = prepare(jstate)
    state = create_train_state(cfg, seed=0, device="cpu", method=method,
                               **train_state_dicts(jstate))

    jax_steps, port_steps = {}, {}
    rng = np.random.default_rng(7)
    history = []
    for proto in phases:
        if proto not in jax_steps:
            jax_steps[proto] = jax_make_train_step(model, jcfg, method, proto_phase=proto)
            port_steps[proto] = make_train_step(cfg, method, proto_phase=proto)
        if monkeypatch is not None:
            draws = torch.from_numpy(jax_aug_draws(jstate, B))
            monkeypatch.setattr("uda_clr_tpu_torch.train.steps.augment_draws",
                                lambda seed, b, device: draws)
        batch = make_batch(rng, method)
        jstate, want = jax_steps[proto](jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                                        LR_GEN, LR_DIS, EPOCH)
        state, got = port_steps[proto](state, {k: torch.from_numpy(v) for k, v in batch.items()},
                                       LR_GEN, LR_DIS, EPOCH)
        check_viz(got.pop("_viz"), want.pop("_viz"), len(history))
        want = {k: float(v) for k, v in want.items()}
        history.append(({k: v.item() for k, v in got.items()}, want))
        if each is not None:
            each(len(history) - 1, jstate, state)
    assert state.step == int(jstate.step) == len(phases)
    return jstate, state, history


# The step's first-image ``_viz`` tiles, per iteration, relative to each
# tile's largest entry (measured on the prototype_full step: pred_s 2.3e-3,
# 3.0e-2, 4.8e-2; the x10 mask logits put many pixels on sigmoid's slope;
# std_t and conf_t equal, dropout off makes the MC samples equal)
VIZ_RTOL = (7e-3, 0.1, 0.15)


def check_viz(got, want, it):
    """The step's ``_viz`` tiles (the Trainer's image grids): the same keys
    and shapes on both sides, each tile within ``VIZ_RTOL[it]``."""
    assert set(got) == set(want), f"iter {it}: _viz {sorted(got)} vs {sorted(want)}"
    for k, w in want.items():
        w, g = np.asarray(w), got[k].numpy()
        assert g.shape == w.shape, (k, g.shape, w.shape)
        err = float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-12))
        assert err <= VIZ_RTOL[it], f"iter {it}: _viz {k} max diff {err:.2e} of its largest"


def check_losses(history, overrides=None):
    """Every metric of every iteration: the same keys on both sides, each
    finite, and relative agreement within ``RTOL[key][iteration]``
    (``overrides`` replaces entries, e.g. ``TN_RTOL``)."""
    rtol = {**RTOL, **(overrides or {})}
    for it, (got, want) in enumerate(history):
        assert set(got) == set(want), f"iter {it}: {sorted(got)} vs {sorted(want)}"
        for k in want:
            assert np.isfinite(got[k]), f"iter {it}: {k} = {got[k]}"
            rel = abs(got[k] - want[k]) / max(abs(want[k]), 1e-12)
            assert rel <= rtol[k][it], f"iter {it}: {k} port {got[k]} jax {want[k]} rel {rel:.2e}"


def close(got, want, rtol, what):
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= rtol, f"{what}: max diff {err:.2e} of the largest entry > {rtol}"


def check_model(sd, params, stats, what, stats_rtol=STATS_RTOL, param_keys=G_PARAMS,
                stats_keys=BN_STATS):
    """The params at ``param_keys`` (relative to their largest entry, and by
    their median difference in units of lr) and the running stats at
    ``stats_keys`` of the state_dict ``sd`` against the JAX trees."""
    for key, path in param_keys:
        want = np.asarray(get(params, path)).transpose(3, 2, 0, 1)
        close(sd[key].numpy(), want, PARAM_RTOL, f"{what} {key}")
        median = np.median(np.abs(sd[key].numpy() - want)) / LR_GEN
        assert median <= PARAM_MEDIAN_LR, f"{what} {key}: median diff {median:.3f} lr"
    for key, path in stats_keys:
        node = get(stats, path)
        # plain BN's mean/var, or TransNorm's four per-domain buffers
        names = ("mean", "var") if "mean" in node else (
            "mean_source", "var_source", "mean_target", "var_target")
        for theirs in names:
            ours = f"running_{theirs}"
            close(sd[f"{key}.{ours}"].numpy(), np.asarray(node[theirs]), stats_rtol,
                  f"{what} {key}.{ours}")


def check_params(jstate, state, discriminators: tuple, stats_rtol=STATS_RTOL):
    """G params and BN running stats (within ``stats_rtol``), the mean
    teacher's if there is one, and the discriminators: ``discriminators`` =
    (boundary D, entropy D) that the port's state must hold."""
    check_model(state.gen.state_dict(), jstate.gen_params, jstate.gen_stats, "gen",
                stats_rtol)
    if state.teacher is not None:
        check_model(state.teacher.state_dict(), jstate.teacher_params, jstate.teacher_stats,
                    "teacher")
    assert (state.dis is not None, state.dis2 is not None) == discriminators
    for dis, jparams in ((state.dis, jstate.dis_params), (state.dis2, jstate.dis2_params)):
        if dis is None:
            continue
        for i in (1, 5):
            want = np.asarray(get(jparams, (f"conv{i}", "conv", "kernel"))).transpose(3, 2, 0, 1)
            close(getattr(dis, f"conv{i}").weight.detach().numpy(), want, DIS_RTOL, f"conv{i}")


def random_bank(jstate):
    """``jstate`` with a nonzero disk bank (zeros would hide a wrong EMA or
    distance)."""
    rng = np.random.default_rng(11)
    bank = {k: jnp.asarray(0.1 * rng.standard_normal(n).astype(np.float32))
            for k, n in BANK_SIZES.items()}
    return jstate.replace(proto_bank=bank)


def check_proto_bank(jstate, state, atol: float):
    """The disk bank of the disk-bank method, absolute."""
    for k in BANK_SIZES:
        np.testing.assert_allclose(state.proto_bank[k].numpy(), np.asarray(jstate.proto_bank[k]),
                                   rtol=0, atol=atol, err_msg=k)


def check_banks(jstate, state, atol: float):
    """The EMA prototype banks, absolute (their entries are <= ~1)."""
    assert bool(state.proto_src_init) and bool(jstate.proto_src_init)
    for name in ("proto_src", "proto_trg"):
        np.testing.assert_allclose(getattr(state, name).numpy(), np.asarray(getattr(jstate, name)),
                                   rtol=0, atol=atol, err_msg=name)


# ---- the backbones against JAX (tests/test_torch_backbone_*.py) ----

def perturb_norms(params, stats, rng):
    """Random norm affine params and running stats, plain BN's or
    TransNorm's four (init leaves them at 1/0/0/1, which would hide a
    swapped field)."""
    params, stats = to_np(params), to_np(stats)

    def walk(p, s):
        for k, v in p.items():
            if isinstance(v, dict) and "scale" in v:
                c = v["scale"].shape[0]
                v["scale"] = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
                v["bias"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
                for name in s[k]:
                    s[k][name] = ((0.1 * rng.standard_normal(c)) if name.startswith("mean")
                                  else rng.uniform(0.5, 1.5, c)).astype(np.float32)
            elif isinstance(v, dict):
                walk(v, s.get(k, {}))

    walk(params, stats)
    return params, stats


def jax_deeplab(backbone: str, output_stride: int = 16, norm: str = "bn", seed: int = 0):
    """JAX DeepLab on ``backbone`` and its variables from ``PRNGKey(seed)``
    (init traced as one program), with perturbed norms."""
    model = JaxDeepLab(num_classes=2, backbone=backbone, output_stride=output_stride, norm=norm)
    v = jax.jit(lambda key: model.init(key, jnp.zeros((1, 32, 32, 3)), train=False))(
        jax.random.PRNGKey(seed))
    params, stats = perturb_norms(v["params"], v["batch_stats"], np.random.default_rng(seed))
    return model, params, stats


def output_weights(output_stride: int, seed: int = 5):
    """A fixed random weight per output of the 7-tuple: the test loss is the
    sum of the means of output * weight, so every output feeds the
    gradients."""
    rng = np.random.default_rng(seed)
    s, q, o = SIZE, SIZE // 4, SIZE // output_stride
    shapes = ((s, s, 2), (s, s, 1), (o, o, 256), (q, q, 304), (q, q, 305), (q, q, 2), (q, q, 1))
    return [rng.standard_normal((B,) + sh).astype(np.float32) for sh in shapes]


def jax_forward(model, params, stats, x, train: bool, domains: int, weights):
    """The JAX model's outputs, updated stats and the test loss's gradients
    with respect to the params."""
    def loss_fn(p):
        outs, upd = model.apply({"params": p, "batch_stats": stats}, x, train=train,
                                domains=domains, mutable=["batch_stats"])
        loss = sum(jnp.mean(o * w) for o, w in zip(outs, weights))
        return loss, (outs, upd["batch_stats"])

    (_, (outs, upd)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    return outs, upd, grads


def port_forward(gen, x, train: bool, domains: int, weights):
    """The port model's outputs and its gradients by state_dict key."""
    outs = gen(torch.from_numpy(x), train, domains)
    sum(torch.mean(o * torch.from_numpy(w)) for o, w in zip(outs, weights)).backward()
    return outs, {k: p.grad for k, p in gen.named_parameters()}


GROUPS = ("backbone", "aspp", "decoder")


def grad_errors(got: dict, jax_grads, stats, output_stride: int) -> dict:
    """Per group of parameters (backbone, ASPP, decoder): ``global``, the
    largest |port - JAX| over the group's gradients over their largest
    |JAX| entry, and ``median``, the median over the group's tensors of
    each tensor's largest |port - JAX| over its largest |JAX| entry. The
    JAX gradient tree is carried to the port's keys by the weight bridge."""
    want = deeplab_state_dict(to_np(jax_grads), stats, output_stride)
    out = {}
    for group in GROUPS:
        keys = [k for k in got if k.startswith(group)]
        diff = [float((got[k] - want[k]).abs().max()) for k in keys]
        scale = [float(want[k].abs().max()) for k in keys]
        out[group] = {"global": max(diff) / max(scale),
                      "median": float(np.median([d / max(s, 1e-30)
                                                 for d, s in zip(diff, scale)]))}
    return out


def backbone_errors(model, params, stats, backbone: str, output_stride: int, train: bool,
                    norm: str = "bn") -> dict:
    """The port's DeepLab on ``backbone`` against the JAX model from the same
    variables, dropout off, at B=2 and SIZE^2: in train mode with
    ``domains=2``, in eval mode with ``domains=1``. Returns the largest
    difference of each output over its largest JAX entry (``outputs``), of
    the running stats after the forward (``stats``, over every norm site),
    and :func:`grad_errors` (``grads``)."""
    x = np.random.default_rng(4).standard_normal((B, SIZE, SIZE, 3)).astype(np.float32)
    os_ = 8 if backbone == "drn" else output_stride
    weights = output_weights(os_)
    domains = 2 if train else 1
    outs, upd, grads = jax_forward(model, params, stats, x, train, domains, weights)
    gen = DeepLab(backbone=backbone, output_stride=output_stride, norm=norm)
    gen.load_state_dict(deeplab_state_dict(params, stats, output_stride))
    got, port_grads = port_forward(gen, x, train, domains, weights)
    assert got._fields == outs._fields
    res = {"outputs": {}}
    for name, g, w in zip(got._fields, got, outs):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, name
        res["outputs"][name] = float(np.abs(g.detach().numpy() - w).max() / np.abs(w).max())
    sd = gen.state_dict()
    want = deeplab_state_dict(params, to_np(upd), output_stride)
    res["stats"] = max(float((sd[k] - want[k]).abs().max() / want[k].abs().max())
                       for k in want if ".running_" in k)
    res["grads"] = grad_errors(port_grads, grads, stats, output_stride)
    return res


def check_backbone(res: dict, tol: dict, what: str) -> None:
    """``res`` of :func:`backbone_errors` within ``tol`` = {'outputs': x,
    'stats': x, 'grads': {group: (global, median)}}."""
    worst = max(res["outputs"].values())
    assert worst <= tol["outputs"], f"{what}: outputs {res['outputs']}"
    assert res["stats"] <= tol["stats"], f"{what}: running stats {res['stats']:.2e}"
    for group, (g_tol, m_tol) in tol["grads"].items():
        e = res["grads"][group]
        assert e["global"] <= g_tol and e["median"] <= m_tol, f"{what}: {group} gradients {e}"


def block_errors(jax_block, port_block, to_state_dict, shape, seed: int = 0,
                 domains: int = 2) -> dict:
    """One backbone block alone, in train mode with ``domains``, from the
    JAX block's init at input ``shape`` (NHWC, norms perturbed), carried to
    ``port_block`` by ``to_state_dict(sd, key, params, stats)``. The test
    loss is the mean of output * a fixed random weight. Returns the largest
    difference of the output over its largest JAX entry (``output``), of
    the running stats (``stats``), and of each gradient, the input's
    included, over its tensor's largest JAX entry (``grads``: the largest
    over the tensors). A block is shallow, so its train-mode gradients
    carry no noise floor from depth."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    v = jax.jit(lambda key: jax_block.init(key, jnp.asarray(x), False))(jax.random.PRNGKey(seed))
    params, stats = perturb_norms(v["params"], v["batch_stats"], rng)
    out_shape = jax.eval_shape(lambda: jax_block.apply(v, jnp.asarray(x), False)).shape
    w = rng.standard_normal(out_shape).astype(np.float32)

    def loss_fn(p, x):
        out, upd = jax_block.apply({"params": p, "batch_stats": stats}, x, True, domains,
                                   mutable=["batch_stats"])
        return jnp.mean(out * w), (out, upd["batch_stats"])

    (_, (out, upd)), (g_params, g_x) = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    sd = {}
    to_state_dict(sd, "b", params, stats)
    port_block.load_state_dict({k[2:]: v for k, v in sd.items()})
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().requires_grad_()
    got = port_block(xt, True, domains).permute(0, 2, 3, 1)
    torch.mean(got * torch.from_numpy(w)).backward()

    rel = lambda a, b: float(np.abs(a - b).max() / np.abs(b).max())
    res = {"output": rel(got.detach().numpy(), np.asarray(out))}
    want = {}
    to_state_dict(want, "b", to_np(g_params), to_np(upd))
    mine = dict(port_block.named_parameters())
    ours = port_block.state_dict()
    res["stats"] = max(rel(ours[k[2:]].numpy(), want[k].numpy())
                       for k in want if ".running_" in k)
    # the bias of a separable conv's inner norm feeds the pointwise conv and
    # then another train-mode norm, which takes its mean out: its gradient is
    # zero in exact arithmetic, so each tensor is held relative to the larger
    # of its own largest entry and 1% of the block's largest gradient
    pairs = {k: (mine[k].grad.numpy(), want[f"b.{k}"].numpy()) for k in mine}
    floor = 1e-2 * max(float(np.abs(ref).max()) for _, ref in pairs.values())
    grads = {k: float(np.abs(g - ref).max() / max(float(np.abs(ref).max()), floor))
             for k, (g, ref) in pairs.items()}
    grads["input"] = rel(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(g_x))
    res["grads"] = max(grads.values())
    return res


def check_block(res: dict, tol: dict, what: str) -> None:
    """``res`` of :func:`block_errors` within ``tol`` (the same keys)."""
    for k, t in tol.items():
        assert res[k] <= t, f"{what}: {k} {res[k]:.2e} > {t}"
