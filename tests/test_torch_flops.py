"""The port's flop count (utils/benchmarking.count_flops, the numerator of
the benchmarks' ``mfu``) held to a count taken from the JAX package's
programs, from the same weights (the weight bridge) at 64^2 with B=2.

The JAX count walks the jaxpr of the JAX function (``jax.make_jaxpr``, into
every sub-jaxpr) and counts each ``conv_general_dilated`` and
``dot_general`` by the forward convolution or product it derives from: 2
flops per multiply-add, the zeros that ``lhs_dilation`` inserts (the input
gradient of a strided conv) counting for nothing. FlopCounterMode counts by
the same rule once the port's ``convolution_backward`` formula holds each
gradient to its forward's cost; the three single-conv cases check the rule
first. The resizes are left out on the JAX side: JAX computes them as
einsums with a 2-D [out, in] interpolation matrix
(uda_clr_tpu/ops/resize.py:73-75), the port with ``F.interpolate``, which
FlopCounterMode does not count.
"""

import jax
import jax.numpy as jnp
from jax.extend.core import Literal
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.test_torch_models import to_np
from tests.torch_step_harness import (  # noqa: F401
    B, EPOCH, LR_DIS, LR_GEN, SIZE, T, jax_train_state, make_batch, two_threads,
)
from uda_clr_tpu.config import Config as JaxConfig
from uda_clr_tpu.models.deeplab import DeepLab as JaxDeepLab
from uda_clr_tpu.ops.resize import _align_corners_matrix
from uda_clr_tpu.train.steps import make_train_step as jax_make_train_step
from uda_clr_tpu_torch.config import Config
from uda_clr_tpu_torch.convert.from_jax import deeplab_state_dict, train_state_dicts
from uda_clr_tpu_torch.models.deeplab import DeepLab
from uda_clr_tpu_torch.train.state import create_train_state
from uda_clr_tpu_torch.train.steps import make_train_step
from uda_clr_tpu_torch.utils.benchmarking import count_flops
from uda_clr_tpu_torch.utils.opcount import OpCounter

pytestmark = pytest.mark.usefixtures("two_threads")

# Relative tolerances, with the gap measured on these inputs beside each
# (torch 2.13 CPU, jax 0.9 CPU). Under FlopCounterMode's own
# convolution_backward rule the depthwise case is 5.0 over and the step
# 0.252 over (24.19 GFLOP counted as 30.29): it counts a grouped conv's
# weight gradient at ``groups`` times its forward.
CONV_RTOL = 0.0  # measured 0 on all three
EVAL_RTOL = 1e-6  # measured 0 (1.72 GFLOP)
STEP_RTOL = 1e-2  # measured 0 (24.19 GFLOP)

# primitives that carry a value through unchanged in what it is (an
# interpolation matrix or a reversed kernel stays one)
_PASS = {"convert_element_type", "transpose", "copy", "copy_p", "reshape"}
_CONTROL = {"while", "cond"}


def _is_interp(value) -> bool:
    a = np.asarray(value)
    if a.ndim != 2 or not np.issubdtype(a.dtype, np.floating):
        return False
    return np.array_equal(a.astype(np.float32), _align_corners_matrix(a.shape[1], a.shape[0]))


def _conv_flops(eqn, input_grad: bool) -> int:
    """2 flops per multiply-add of the forward convolution ``eqn`` derives
    from. A forward or weight-gradient conv: output elements x the kernel's
    input features x its window. An input gradient (JAX convolves the
    cotangent, dilated by the stride, with the reversed kernel): the
    cotangent's positions x the kernel's elements, the forward's count; the
    zeros that ``lhs_dilation`` inserts and the full padding count for
    nothing."""
    lhs, rhs = (v.aval for v in eqn.invars)
    out = eqn.outvars[0].aval
    dn = eqn.params["dimension_numbers"]
    if input_grad:
        positions = int(np.prod(lhs.shape)) // lhs.shape[dn.lhs_spec[1]]
        return 2 * positions * int(np.prod(rhs.shape))
    window = int(np.prod([rhs.shape[d] for d in dn.rhs_spec[2:]]))
    return 2 * int(np.prod(out.shape)) * rhs.shape[dn.rhs_spec[1]] * window


def _dot_flops(eqn) -> int:
    lhs, rhs = (v.aval for v in eqn.invars)
    (_, rc), (_, rb) = eqn.params["dimension_numbers"]
    free = [d for i, d in enumerate(rhs.shape) if i not in rc and i not in rb]
    return 2 * int(np.prod(lhs.shape)) * int(np.prod(free))


def jaxpr_flops(closed) -> dict:
    """{'conv': ..., 'dot': ..., 'resize': ...} flops of a ClosedJaxpr.
    Values are followed through the program: the interpolation matrices
    (constants) and the outputs of ``rev`` (the reversed kernels of input
    gradients), each through the primitives in ``_PASS`` and into
    sub-jaxprs."""
    totals = {"conv": 0, "dot": 0, "resize": 0}

    def walk(jaxpr, consts, marks_in, mult):
        marks = {v: "interp" for v, c in zip(jaxpr.constvars, consts) if _is_interp(c)}
        marks.update({v: m for v, m in zip(jaxpr.invars, marks_in) if m})
        for eqn in jaxpr.eqns:
            name = eqn.primitive.name
            ins = [None if isinstance(v, Literal) else marks.get(v) for v in eqn.invars]
            if name in _CONTROL:
                raise NotImplementedError(f"{name}: the count depends on the data")
            if name == "conv_general_dilated":
                totals["conv"] += mult * _conv_flops(eqn, ins[1] == "rev")
            elif name == "dot_general":
                totals["resize" if "interp" in ins else "dot"] += mult * _dot_flops(eqn)
            elif name == "rev":
                marks[eqn.outvars[0]] = "rev"
            elif name in _PASS and ins[0]:
                marks[eqn.outvars[0]] = ins[0]
            for sub in eqn.params.values():
                if hasattr(sub, "jaxpr") and hasattr(sub, "consts"):
                    sub_jaxpr, sub_consts = sub.jaxpr, sub.consts
                elif hasattr(sub, "eqns"):
                    sub_jaxpr, sub_consts = sub, []
                else:
                    continue
                times = eqn.params.get("length", 1) if name == "scan" else 1
                n = len(sub_jaxpr.invars)
                walk(sub_jaxpr, sub_consts, ins if len(ins) == n else [None] * n, mult * times)

    walk(closed.jaxpr, closed.consts, [None] * len(closed.jaxpr.invars), 1)
    return totals


def rel(a, b) -> float:
    return abs(a - b) / b


# ---- the rule, on one strided, one atrous and one depthwise conv ----

# (input NCHW, weight OIHW, stride, padding, dilation, groups)
CONVS = {
    "strided": ((2, 8, 16, 16), (12, 8, 3, 3), 2, 1, 1, 1),
    "atrous": ((2, 8, 12, 12), (8, 8, 3, 3), 1, 6, 6, 1),
    "depthwise": ((2, 16, 16, 16), (16, 1, 3, 3), 2, 1, 1, 16),
}


@pytest.mark.parametrize("case", sorted(CONVS))
def test_conv_rule_matches_jaxpr(case):
    xs, ws, stride, pad, dil, groups = CONVS[case]
    rng = np.random.default_rng(0)
    x, w = rng.standard_normal(xs).astype(np.float32), rng.standard_normal(ws).astype(np.float32)

    def jax_loss(x, w):
        y = jax.lax.conv_general_dilated(
            x, w, (stride, stride), [(pad, pad)] * 2, rhs_dilation=(dil, dil),
            dimension_numbers=("NCHW", "OIHW", "NCHW"), feature_group_count=groups)
        return jnp.sum(y * y)

    want = jaxpr_flops(jax.make_jaxpr(jax.grad(jax_loss, argnums=(0, 1)))(x, w))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()

    def port():
        y = F.conv2d(xt, wt, None, stride, pad, dil, groups)
        (y * y).sum().backward()

    _, got = count_flops(port)
    oh = (xs[2] + 2 * pad - dil * (ws[2] - 1) - 1) // stride + 1
    forward = 2 * xs[0] * ws[0] * ws[1] * ws[2] * ws[3] * oh * oh
    assert want["dot"] == want["resize"] == 0
    assert want["conv"] == 3 * forward, want  # forward + both gradients
    assert rel(got, want["conv"]) <= CONV_RTOL, (got, want)


# ---- the eval forward and the flagship step ----

def test_eval_forward_flops_match_jax():
    model = JaxDeepLab(num_classes=2, backbone="mobilenet", output_stride=16, norm="bn")
    v = jax.jit(lambda k: model.init(k, jnp.zeros((1, 32, 32, 3)), train=False))(
        jax.random.PRNGKey(0))
    x = np.random.default_rng(1).standard_normal((B, SIZE, SIZE, 3)).astype(np.float32)
    want = jaxpr_flops(jax.make_jaxpr(
        lambda v, x: model.apply(v, x, train=False).mask_logits)(v, jnp.asarray(x)))
    gen = DeepLab(backbone="mobilenet", output_stride=16, norm="bn").eval()
    gen.load_state_dict(deeplab_state_dict(to_np(v["params"]), to_np(v["batch_stats"])))
    with torch.no_grad():
        _, got = count_flops(lambda: gen(torch.from_numpy(x), train=False))
    assert want["resize"] > 0 and want["dot"] == 0
    assert rel(got, want["conv"]) <= EVAL_RTOL, (got, want)


@pytest.fixture(scope="module")
def flagship_step():
    """One prototype-phase ``prototype_full`` step (T=4, float32) from the
    same state on both sides: the JAX step's count from its jaxpr (traced
    once for the file), the port's state, batch and step."""
    jcfg = JaxConfig()
    jcfg.model.compute_dtype = "float32"
    jcfg.method.mc_samples = T
    jcfg.method.rng_impl = "threefry2x32"
    cfg = Config()
    cfg.method.mc_samples = T
    model = JaxDeepLab(num_classes=2, backbone="mobilenet", output_stride=16, norm="bn")
    jstate = jax_train_state(model)
    batch = make_batch(np.random.default_rng(7), "prototype_full")
    jstep = jax_make_train_step(model, jcfg, "prototype_full", proto_phase=True)
    want = jaxpr_flops(jax.make_jaxpr(lambda s, b: jstep(s, b, LR_GEN, LR_DIS, EPOCH))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}))
    step = make_train_step(cfg, "prototype_full", proto_phase=True)

    def port_step():
        state = create_train_state(cfg, seed=0, device="cpu", method="prototype_full",
                                   **train_state_dicts(jstate))
        return step(state, {k: torch.from_numpy(v) for k, v in batch.items()}, LR_GEN, LR_DIS,
                    EPOCH)

    return want, port_step


def test_flagship_step_flops_match_jax(flagship_step):
    """The convolutions and products both frameworks' steps run, gradients
    included."""
    want, port_step = flagship_step
    (_, metrics), got = count_flops(port_step)
    assert np.isfinite(float(metrics["loss_all"]))
    assert want["resize"] > 0
    assert rel(got, want["conv"] + want["dot"]) <= STEP_RTOL, (got, want)


def test_flagship_step_per_op_flops_match_jax(flagship_step):
    """The per-op roofline's total (utils/opcount.OpCounter, the ops' flops
    summed, as roofline_closure.py sums them) against the JAX step's count,
    and equal to count_flops of the same call."""
    want, port_step = flagship_step
    counter = OpCounter()

    def run():
        with counter:
            return port_step()

    _, got = count_flops(run)
    total = counter.total("flops")
    assert total == got
    assert rel(total, want["conv"] + want["dot"]) <= STEP_RTOL, (total, want)
