"""The generic single-forward train step (uda_clr_tpu/train/steps.py
:make_train_step :493-1050, with its ``mc_inline`` branch :582-657, the
standalone MC forward ``_mc_dropout_forward`` :234-301 and ``_mc_suffix``
:136-231) for ``baseline``, ``adversarial``, ``posal``, ``prototype``,
``prototype_full``, ``prototype_mt`` and ``mean_teacher``, under either
norm (``'bn'``, ``'tn'``), switched by the method and the config's flags as
the JAX step is; and the bi-classifier ``bcdm`` step
(:func:`make_bcdm_step`, steps.py:304-491).

One forward of the batch (S||T with ``domains=2`` when the method uses the
target; the source alone for the baseline) feeds the G loss, the D losses
(on detached outputs) and the prototype pooling; running stats update as
each part of the forward runs. Under plain BN with ``mc_fast`` the
prototype phase reuses the target halves of (ASPP-predrop, low-level) for
the MC pass; under TransNorm, or with ``mc_fast`` off, the MC pass is the
standalone :func:`mc_dropout_forward` on the target batch. Either writes no
running stats; the fast passes run their mask head through the
hand-written kernel K1 (ops/mask_head.py), the slow one runs the model's
own dropout sites (K3 under ``'pallas'``). ``prototype`` (the disk-bank
method) pools per-image prototypes, pulls target toward source and EMAs a
bank read from disk. ``prototype_mt`` adds the source discriminative loss
and the augmented-consistency loss on target, whose augmented forward
writes no running stats either. ``mean_teacher`` adds an eval-mode teacher
forward and the teacher's EMA after the student's update.

Randomness: the 'xla16'/'xla' dropout backends draw from the state's
generator; the fused dropout kernel K3, K1 and the augmentation draw from
64-bit Philox seeds derived on the host from (state.seed, state.step), so no
step syncs with the device.

Data parallelism (parallel/distributed.py has the rule): each rank steps on
its rows of the global batch. The norms' moments, the MC pass's, the
prototype pools and ``loss_aug``'s denominator are reduced over the ranks,
every optimizer's gradients are averaged before its step, and the metrics
are the mean over the ranks. The augmentation draws and the mean teacher's
noise are drawn for the global batch, each rank taking its rows; dropout
draws per rank (the rank folded into the seeds, rank 0 drawing the
single-process streams).

On the ``('data', 'space')`` mesh (parallel/spatial.py) a step runs inside
``spatial.region()`` on its data index's rows and its stripe of rows of
every image: the convs, the max pool, the resizes and the blur read their
neighbours' rows, the per-image pools and ASPP's image pool sum over the
space group, the discriminators run on gathered inputs; the global draws
take this data index's rows (over ``n_data``) and this stripe. K1 and K3
run on each rank's stripe, with global moments.

On one card the main forward's deterministic prefix (backbone, ASPP
before its dropout, the low-level projection) replays as CUDA graphs,
forward and backward, captured at its first call (train/graphs.py, which
lists where it stays eager); every other forward runs eagerly.

A uint8 wire batch is decoded to float32 first (data/wire.py), as the JAX
step does (steps.py:559). bf16: the batch is then cast to
``cfg.model.compute_dtype`` once; every conv
casts its float32 weight to the activation dtype, norms reduce in float32,
and losses run in float32 (explicit casts, no autocast).

Spans (utils/tracing.py), recorded only while ``torch.profiler`` records:
a call is ``clr.step``, and :func:`make_train_step`'s is cut into the
consecutive phases ``clr.step.forward`` (decode, teacher, the S||T
forward), ``clr.step.mc`` (the MC pass, where the step has one; the
standalone pass sits between two forward phases), ``clr.step.losses``,
``clr.step.backward`` (the generator's backward and gradient averaging)
and ``clr.step.update`` (Adam, the discriminators' games, the bank
commit, the teacher's EMA). Each backbone call inside a step records its
own ``clr.backbone`` span (models/deeplab.py; train/graphs.py around a
replay) within the open phase.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from uda_clr_tpu_torch.config import Config
from uda_clr_tpu_torch.data.wire import decode_batch
from uda_clr_tpu_torch.models import layers as layers_lib
from uda_clr_tpu_torch.models.deeplab import DeepLab, DeepLabOutputs, nchw, nhwc
from uda_clr_tpu_torch.models.norm import (
    batch_moments,
    batch_moments_parts,
    frozen_stats,
    global_rows,
    normalize,
)
from uda_clr_tpu_torch.ops import losses as L
from uda_clr_tpu_torch.ops import prototypes as P
from uda_clr_tpu_torch.ops.augment import augment_draws, strong_augment
from uda_clr_tpu_torch.ops.mask_head import fused_mask_head_split, mask_head_plain
from uda_clr_tpu_torch.ops.philox import MASK64, splitmix64
from uda_clr_tpu_torch.ops.resize import resize_bilinear_align_corners, resize_nearest
from uda_clr_tpu_torch.parallel import distributed as dist_lib
from uda_clr_tpu_torch.parallel import spatial
from uda_clr_tpu_torch.parallel.mesh import check_stripes, local_rows, local_stripe
from uda_clr_tpu_torch.parallel.reduce import all_sum, average_grads, mean_metrics
from uda_clr_tpu_torch.train import graphs
from uda_clr_tpu_torch.train import optim as optim_lib
from uda_clr_tpu_torch.train.state import TrainState, discriminators_used
from uda_clr_tpu_torch.utils import tracing

_CL = torch.channels_last
MASK_HEAD_IMPLS = ("auto", "pallas", "xla")  # cfg.method.mask_head_impl

# sub-streams of a step's seed; K1 takes the step seed itself; the slow MC
# pass's lane i draws from sub-stream _MC_LANES + i; bcdm's head forward k
# from _BCDM_HEADS + k
_MAIN_FORWARD, _AUG_FORWARD, _AUG_DRAWS, _MC_LANES, _BCDM_HEADS = 1, 2, 3, 16, 32
# bcdm (steps.py:394-396): mask logits tempered in the phase-A loss, the
# discrepancy weight, and the feature-only steps of phase C
BCDM_TEMPERATURE, BCDM_CDD_WEIGHT, BCDM_INNER_FEA_STEPS = 1.8, 0.01, 4


def kernel_seed(seed: int, step: int) -> int:
    """64-bit Philox key of a step's mask-head draw (splitmix64 of the base
    seed and step counter; host integers only, no device sync)."""
    return splitmix64((seed * 0x9E3779B97F4A7C15 + step) & MASK64)


def stream_seed(step_seed: int, stream: int) -> int:
    """The seed of one sub-stream of a step (a forward's dropout sites, the
    augmentation draws), distinct from the step seed K1 uses."""
    return splitmix64((step_seed ^ (stream << 56)) & MASK64)


def _conv(x, weight, padding: int, bias=None):
    conv = spatial.conv2d if spatial.active() else torch.nn.functional.conv2d
    return conv(x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype), (1, 1),
                (padding, padding), (1, 1), 1)


@torch.no_grad()
def mc_suffix(gen: DeepLab, feat_predrop, ll, hw, b: int, t_samples: int,
              generator: torch.Generator | None, seed: int, tn_degenerate: bool = False,
              mask_head_impl: str = "auto"):
    """T dropout-sampled mask-head passes from the deterministic prefix
    (NCHW ``feat_predrop`` [B,256,h',w'] and ``ll`` [B,48,h,w]); returns
    [T, B, H, W, 2] mask logits. Writes no running stats: BN uses batch
    moments computed here (steps.py:93-107,136-231). Its dropout sites
    follow ``_mc_drop`` (never K3); the mask head is K1 at rate 0.1 from
    ``seed``. ``tn_degenerate``: TransNorm's identical-halves mode (the
    norm's ``domains=0``): the three norm sites' scale and bias times 2,
    the coefficients K1 receives included. ``mask_head_impl`` (the config's
    switch): ``'xla'`` runs K1's plain version on any device, the JAX
    package's ``'xla'`` A/B; ``'auto'`` and ``'pallas'`` run K1."""
    H, W = hw
    s2 = 2.0 if tn_degenerate else None
    affine = lambda bn: (bn.weight, bn.bias) if s2 is None else (bn.weight * s2, bn.bias * s2)
    dec = gen.decoder
    bc = dec.last_conv_boundary
    drop = layers_lib.mc_dropout
    # replicate at the first dropout site: one flat T*B batch
    feat_rep = torch.cat([feat_predrop] * t_samples, dim=0)
    ll_rep = torch.cat([ll] * t_samples, dim=0).contiguous(memory_format=_CL)
    x = drop(feat_rep, 0.5, generator)
    x_up = resize_bilinear_align_corners(x, tuple(ll.shape[2:])).contiguous(memory_format=_CL)

    # boundary head; conv1 split by linearity over the virtual 304-concat
    w1 = bc[0].weight  # [256, 304, 3, 3]
    y = _conv(x_up, w1[:, :256], 1) + _conv(ll_rep, w1[:, 256:], 1)
    mu1, var1 = batch_moments(y, (0, 2, 3))
    y = torch.relu(normalize(y, mu1, var1, *affine(bc[1])))
    y = drop(y, 0.5, generator)
    y = _conv(y, bc[4].weight, 1)
    mu2, var2 = batch_moments(y, (0, 2, 3))
    y = torch.relu(normalize(y, mu2, var2, *affine(bc[5])))
    y = drop(y, 0.1, generator)
    boundary = _conv(y, bc[8].weight, 0, bc[8].bias).contiguous(memory_format=_CL)

    # mask head: the virtual 305-concat's moments are the per-part moments
    moments = batch_moments_parts((x_up, ll_rep, boundary), (0, 2, 3))
    mask_bn, mask_out = dec.last_conv[0], dec.last_conv[3]
    if mask_head_impl not in MASK_HEAD_IMPLS:
        raise ValueError(f"mask_head_impl {mask_head_impl!r}; one of {MASK_HEAD_IMPLS}")
    head = mask_head_plain if mask_head_impl == "xla" else fused_mask_head_split
    x1 = head(
        nhwc(x_up), nhwc(ll_rep), nhwc(boundary),
        torch.cat([m for m, _ in moments]), torch.cat([v for _, v in moments]),
        *affine(mask_bn), mask_out.weight, mask_out.bias,
        seed, rate=0.0 if layers_lib.dropout_impl() == "off" else 0.1,
    )
    mc = resize_bilinear_align_corners(nchw(x1), (H, W))
    return nhwc(mc).reshape(t_samples, b, H, W, -1)


@torch.no_grad()
def mc_dropout_forward(gen: DeepLab, image_t: torch.Tensor, t_samples: int, fast: bool,
                       generator: torch.Generator | None, seed: int,
                       mask_head_impl: str = "auto") -> torch.Tensor:
    """T MC-dropout mask-logit samples of the NHWC target batch, [T, B, H,
    W, 2], without gradients or running-stat writes (steps.py:234-301).

    ``fast``: one train-mode backbone + prefix pass at batch B (``domains``
    0 under TransNorm, its identical-halves mode; 1 under BN), then
    :func:`mc_suffix` (K1 from ``seed``). Otherwise the reference's
    structure: T/2 lanes, each a train-mode forward of the [T; T]-repeated
    batch with ``domains=1`` through the model's own dropout sites (K3
    under ``'pallas'``; lane i's sites draw from sub-stream
    ``_MC_LANES + i`` of ``seed``), two samples per lane, the first T kept.
    """
    b, hw = image_t.shape[0], tuple(image_t.shape[1:3])
    with frozen_stats(gen):
        if fast:
            dm = 0 if gen.norm == "tn" else 1
            high, low = gen.features(nchw(image_t), True, dm)
            fp, ll = gen.heads_prefix(high, low, True, dm)
            return mc_suffix(gen, fp, ll, hw, b, t_samples, generator, seed,
                             tn_degenerate=gen.norm == "tn", mask_head_impl=mask_head_impl)
        x_rep = torch.cat([image_t, image_t], dim=0)
        lanes = [gen(x_rep, True, 1, layers_lib.DropoutStream(
            generator, stream_seed(seed, _MC_LANES + i))).mask_logits
            for i in range(max(t_samples // 2, 1))]
    mc = torch.stack(lanes)  # [lanes, 2B, H, W, 2]
    return mc.reshape(-1, b, *mc.shape[2:])[:t_samples]


def _split(outs: DeepLabOutputs, b: int):
    return DeepLabOutputs(*(o[:b] for o in outs)), DeepLabOutputs(*(o[b:] for o in outs))


def _ema_bank(bank, init, cur: P.Prototypes, d: float) -> P.Prototypes:
    return P.Prototypes(*(torch.where(init, (1 - d) * bk + d * cu, cu)
                          for bk, cu in zip(P.Prototypes.unstack(bank), cur)))


def _dis_loss(dis, x_s, x_t):
    out_s, out_t = dis(x_s).float(), dis(x_t).float()
    return L.bce_with_logits(out_s, torch.ones_like(out_s)) + \
        L.bce_with_logits(out_t, torch.zeros_like(out_t))


def consistency_threshold(epoch: float) -> float:
    """The ramped pseudo-label threshold of loss_aug, in float32
    (steps.py:905-908): (0.85 + 0.25 * exp(-5 (1 - clip(epoch, 0, 200)/200)^2)) ln 2."""
    f = np.float32
    ramp = np.exp(f(-5.0) * np.square(f(1.0) - np.clip(f(epoch), f(0.0), f(200.0)) / f(200.0)))
    return float((f(0.85) + f(0.25) * ramp) * f(math.log(2.0)))


def discrepancy(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """bcdm's classifier discrepancy, mean |sigmoid(v1) - sigmoid(v2)|
    (steps.py:398-399)."""
    return torch.mean(torch.abs(torch.sigmoid(v1) - torch.sigmoid(v2)))


def bcdm_seg_loss(outs: DeepLabOutputs, map_s, boundary_s, temperature: float = 1.0):
    """BCE of the mask logits divided by ``temperature`` plus the
    untempered boundary MSE, in float32 (steps.py:401-404)."""
    o = outs.mask_logits.float() / temperature
    bd = outs.boundary_logits.float()
    return L.bce_sigmoid_stable(o, map_s) + L.mse(torch.sigmoid(bd), boundary_s)


def one_domain(n: int):
    """TransNorm's layout of a one-domain forward of ``n`` local images
    (:func:`norm.global_rows`): this data index's rows of the global batch,
    whose first half is source, as JAX splits it."""
    d_index, n_data = spatial.data_coords()
    rows = local_rows(n * n_data, d_index, n_data)
    return global_rows((range(rows.start, rows.stop), n * n_data))


def _check_stripes(gen: DeepLab, image: torch.Tensor) -> None:
    """Under the spatial mesh: the image's rows (n_space stripes of this
    one's) split evenly at every stride-2 stage of ``gen``."""
    if spatial.active():
        n = spatial.space_coords()[1]
        check_stripes(image.shape[1] * n, n, gen.output_stride)


def make_bcdm_step(cfg: Config):
    """The bi-classifier discrepancy step (uda_clr_tpu/train/steps.py
    :304-491): F = gen's backbone, C1 = gen's heads, C2 = ``state.cls2``,
    every forward in train mode with ``domains=1`` and every running stat
    updated in order, A -> B -> C.

    A. A source forward through F and both classifiers; the sum of the two
       seg losses (mask logits / 1.8) steps ``fea``, ``cls1`` and ``cls2``.
    B. A source forward through F and both classifiers without a graph,
       for its running-stat updates only; then a target forward whose
       features carry no graph, and 0.01 * discrepancy of the mask logits
       steps ``cls1`` and ``cls2`` (a positive sign, as compiled in the
       reference).
    C. Four times: a target forward and 0.01 * discrepancy steps ``fea``
       alone; the backward computes no classifier gradient.

    Each backward accumulates into the parameters its phase steps only
    (``backward(inputs=...)``), their grads cleared first. Metrics:
    ``loss_seg`` (A), ``loss_cdd_before`` (B), ``loss_cdd_after`` (the last
    of C) and ``loss_all`` = A + 0.01 * (B + C's last); ``_viz`` holds
    phase A's first-image ``pred_s`` and ``pred_b_s`` of the first
    classifier."""
    dt = cfg.model.dtype
    w = BCDM_CDD_WEIGHT

    def step(state: TrainState, batch: dict, lr_gen: float, lr_dis: float, epoch=0):
        with spatial.region(), tracing.span("clr.step", state.step):
            return _step(state, batch, lr_gen, lr_dis)

    def _step(state: TrainState, batch: dict, lr_gen: float, lr_dis: float):
        batch = decode_batch(batch)  # uint8 wire batches -> float32
        _check_stripes(state.gen, batch["image_s"])
        gen, cls2, g, opt = state.gen, state.cls2, state.generator, state.bcdm_opt
        step_seed = dist_lib.rank_seed(kernel_seed(state.seed, state.step))
        image_s = nchw(batch["image_s"].to(dt))
        image_t = nchw(batch["image_t"].to(dt))
        map_s, boundary_s = batch["map_s"], batch["boundary_s"]
        hw = tuple(image_s.shape[2:])
        params = {"fea": list(gen.backbone.parameters()),
                  "cls1": list(gen.aspp.parameters()) + list(gen.decoder.parameters()),
                  "cls2": list(cls2.parameters())}
        forwards = itertools.count()  # each head forward's dropout sub-stream

        def both_heads(high, low):
            return [c.heads(high, low, hw, True, 1, layers_lib.DropoutStream(
                g, stream_seed(step_seed, _BCDM_HEADS + next(forwards)))) for c in (gen, cls2)]

        def update(loss, names):
            for name in names:
                optim_lib.set_lr(opt[name], lr_gen)
                opt[name].zero_grad(set_to_none=True)
            loss.backward(inputs=[p for name in names for p in params[name]])
            for name in names:
                average_grads(params[name])
                opt[name].step()

        def cdd(o1, o2):
            return discrepancy(o1.mask_logits.float(), o2.mask_logits.float())

        # ---- A: the supervised source step of F, C1 and C2 ----
        with one_domain(image_s.shape[0]):
            o1, o2 = both_heads(*gen.features(image_s, True, 1))
        loss_seg = (bcdm_seg_loss(o1, map_s, boundary_s, BCDM_TEMPERATURE)
                    + bcdm_seg_loss(o2, map_s, boundary_s, BCDM_TEMPERATURE))
        viz = {"pred_s": torch.sigmoid(o1.mask_logits.detach().float()[0]),
               "pred_b_s": torch.sigmoid(o1.boundary_logits.detach().float()[0])}
        update(loss_seg, ("fea", "cls1", "cls2"))

        # ---- B: the dead source forward (running stats only), then the
        # classifiers' discrepancy step on target ----
        with torch.no_grad():
            with one_domain(image_s.shape[0]):
                both_heads(*gen.features(image_s, True, 1))
            with one_domain(image_t.shape[0]):
                high, low = gen.features(image_t, True, 1)
        with one_domain(image_t.shape[0]):
            cdd_before = cdd(*both_heads(high, low))
        update(w * cdd_before, ("cls1", "cls2"))

        # ---- C: the feature extractor's discrepancy steps on target ----
        for _ in range(BCDM_INNER_FEA_STEPS):
            with one_domain(image_t.shape[0]):
                cdd_after = cdd(*both_heads(*gen.features(image_t, True, 1)))
            update(w * cdd_after, ("fea",))

        state.step += 1
        metrics = {"loss_seg": loss_seg, "loss_cdd_before": cdd_before,
                   "loss_cdd_after": cdd_after,
                   "loss_all": loss_seg + w * (cdd_before + cdd_after)}
        metrics = mean_metrics({k: v.detach() for k, v in metrics.items()})
        metrics["_viz"] = viz
        return state, metrics

    return step


def make_train_step(cfg: Config, method: str = "prototype_full", proto_phase: bool = False):
    """Build ``step(state, batch, lr_gen, lr_dis, epoch=0) -> (state, metrics)``.

    ``batch``: image_s, map_s, boundary_s (and image_t unless the method is
    the baseline), NHWC tensors on the state's device, float32 or uint8 wire
    (decoded first, data/wire.py); optionally ``consistency_weight`` for the
    mean teacher. ``metrics`` holds detached
    0-d tensors (no host sync inside the step), and under ``"_viz"`` the
    first image's detached tiles for the Trainer's image grids: ``pred_s``,
    ``pred_b_s``, with a target ``pred_t`` and ``bnd_t_raw``, and with the
    MC rectification ``std_t`` and ``conf_t``. The state's modules and
    optimizers update in place. ``proto_phase`` selects the prototype phase
    of ``prototype``/``prototype_full``/``prototype_mt`` (their warmup
    otherwise); the other methods ignore it. ``bcdm`` is
    :func:`make_bcdm_step`'s.
    """
    if method == "bcdm":
        return make_bcdm_step(cfg)
    mcfg = cfg.method
    use_boundary_d, use_entropy_d = discriminators_used(cfg, method)
    if method == "posal":
        method = "adversarial"
    use_target = method != "baseline"
    use_adv = use_boundary_d or use_entropy_d
    use_proto = method in ("prototype_full", "prototype_mt") and proto_phase
    use_bank = method == "prototype" and proto_phase
    use_mt_losses = method == "prototype_mt" and proto_phase
    use_cons = use_mt_losses and mcfg.use_trg_cons
    if use_cons and not mcfg.retrify_pseudo:
        raise ValueError("use_trg_cons requires retrify_pseudo=True: loss_aug is weighted "
                         "by gen_prototype_retrify's MC-std confidence masks")
    # the MC pass rides on the main forward's target half only under BN with
    # mc_fast; TransNorm and the slow pass run the standalone MC forward
    use_mc = use_proto and mcfg.retrify_pseudo
    mc_inline = use_mc and mcfg.mc_fast and cfg.model.norm == "bn"
    use_teacher = method == "mean_teacher"
    dt = cfg.model.dtype

    def step(state: TrainState, batch: dict, lr_gen: float, lr_dis: float, epoch=0):
        with spatial.region(), tracing.span("clr.step", state.step):
            return _step(state, batch, lr_gen, lr_dis, epoch)

    def _step(state: TrainState, batch: dict, lr_gen: float, lr_dis: float, epoch):
        tracing.phase("clr.step.forward")
        batch = decode_batch(batch)  # uint8 wire batches -> float32
        _check_stripes(state.gen, batch["image_s"])
        gen, g = state.gen, state.generator
        # the global-batch draws take this data index's rows (and stripe)
        d_index, n_data = spatial.data_coords()
        s_index, n_space = spatial.space_coords()
        global_seed = kernel_seed(state.seed, state.step)
        step_seed = dist_lib.rank_seed(global_seed)  # K1 and dropout: per rank
        image_s = batch["image_s"].to(dt)
        map_s, boundary_s = batch["map_s"], batch["boundary_s"]
        b = image_s.shape[0]
        image_t = batch["image_t"].to(dt) if use_target else None
        hw = tuple(image_s.shape[1:3])
        domains = 2 if use_target else 1

        # ---- teacher forward (eval mode, noised target view) ----
        teacher_out = None
        if use_teacher:
            t_in = image_t
            if mcfg.teacher_noise > 0.0:
                # drawn for the global batch; this rank's rows and stripe
                n_t, rows = image_t.shape[0] * n_data, image_t.shape[1] * n_space
                noise = torch.randn((n_t, rows) + tuple(image_t.shape[2:]),
                                    device=image_t.device,
                                    generator=g if state.noise_generator is None
                                    else state.noise_generator)
                noise = noise[local_rows(n_t, d_index, n_data),
                              local_stripe(rows, s_index, n_space)]
                t_in = image_t + (mcfg.teacher_noise * noise).to(dt)
            with torch.no_grad():
                teacher_out = state.teacher(t_in, train=False)

        mc = None
        if use_mc and not mc_inline:
            tracing.phase("clr.step.mc")
            mc = mc_dropout_forward(gen, image_t, mcfg.mc_samples, mcfg.mc_fast, g,
                                    step_seed, mcfg.mask_head_impl).float()
            tracing.phase("clr.step.forward")

        # ---- one forward of the batch (S||T, or the source alone); its
        # deterministic prefix as CUDA graphs where they may run ----
        with global_rows(None) if use_target else one_domain(b):
            fp_all, ll_all = graphs.prefix(gen, [image_s, image_t] if use_target else [image_s],
                                           domains)
            outs = gen.heads_suffix(fp_all, ll_all, hw, True, domains, layers_lib.DropoutStream(
                g, stream_seed(step_seed, _MAIN_FORWARD)))
        if mc_inline:
            tracing.phase("clr.step.mc")
            mc = mc_suffix(gen, fp_all[b:].detach(), ll_all[b:].detach(), hw, b,
                           mcfg.mc_samples, g, step_seed,
                           mask_head_impl=mcfg.mask_head_impl).float()
        out_s, out_t = _split(outs, b) if use_target else (outs, None)

        # ---- generator loss ----
        tracing.phase("clr.step.losses")
        o_s = out_s.mask_logits.float()
        b_s = out_s.boundary_logits.float()
        loss_seg = L.bce_sigmoid_stable(o_s, map_s)
        if mcfg.use_boundary_loss:
            loss_seg = loss_seg + L.mse(torch.sigmoid(b_s), boundary_s)
        loss = loss_seg
        metrics = {"loss_seg": loss_seg}
        # first-image tiles for the Trainer's image grids
        # (Trainer_prototype_full.py:307-325,519-575), left on the device
        viz = {"pred_s": torch.sigmoid(o_s[0]), "pred_b_s": torch.sigmoid(b_s[0])}
        if use_target:
            o_t = out_t.mask_logits.float()
            bd_t = out_t.boundary_logits.float()
            viz["pred_t"] = torch.sigmoid(o_t[0])
            viz["bnd_t_raw"] = bd_t[0]  # logged before the sigmoid (:534-535)
        if use_adv:
            # reference term order: entropy-D first, boundary-D second
            adv = 0.0
            if use_entropy_d:
                d_u = state.dis2(L.entropy_map(o_t).to(dt)).float()
                adv = adv + L.bce_with_logits(d_u, torch.ones_like(d_u))
            if use_boundary_d:
                d_b = state.dis(torch.sigmoid(bd_t).to(dt)).float()
                adv = adv + L.bce_with_logits(d_b, torch.ones_like(d_b))
            loss_adv = mcfg.adv_weight * adv
            loss = loss + loss_adv
            metrics["loss_adv"] = loss_adv

        rect = None
        if use_proto:
            x_feat_s = out_s.x_feature.float()
            pred_s = nhwc(resize_nearest(nchw(map_s), tuple(x_feat_s.shape[1:3])))
            src = P.gen_prototype(pred_s, x_feat_s)
            if mcfg.retrify_pseudo:
                rect = P.gen_prototype_retrify(
                    out_t.mask_before.float(), out_t.x_feature.float(), mc,
                    mcfg.pseudo_threshold, mcfg.std_threshold)
                trg = rect.prototypes
                viz["std_t"], viz["conf_t"] = rect.std_map[0], rect.conf_mask[0]
            else:
                trg = P.gen_prototype(torch.sigmoid(out_t.mask_before.float()),
                                      out_t.x_feature.float())
            if mcfg.use_global:
                d = mcfg.global_pro_weight
                src = _ema_bank(state.proto_src, state.proto_src_init, src, d)
                trg = _ema_bank(state.proto_trg, state.proto_trg_init, trg, d)
            intra = P.intra_domain_loss(src, trg)
            loss = loss + mcfg.pro_weight * intra
            metrics["loss_intra"] = intra
            metrics["loss_inter"] = P.inter_domain_loss(src)
            if use_mt_losses and mcfg.src_reg:
                # the grad-carrying EMA centroids, as the reference's loss reads them
                src_reg = P.source_discriminative_loss(x_feat_s, pred_s, src)
                loss = loss + mcfg.src_reg_weight * src_reg
                metrics["loss_src_reg"] = src_reg

        new_bank = None
        if use_bank:
            bank_loss, new_bank = _bank_losses(state, mcfg, out_s, out_t, map_s, boundary_s,
                                               image_t, epoch, metrics)
            loss = loss + mcfg.bank_loss_weight * bank_loss

        if use_cons:
            # augmented consistency on target (steps.py:881-926): pseudo-labels
            # from the plain target logits at the ramped threshold, weighted by
            # the MC-std confidence masks nearest-upsampled to the image
            pseudo = (torch.sigmoid(o_t.detach()) > consistency_threshold(epoch)).float()
            conf = nhwc(resize_nearest(nchw(rect.conf_mask.detach()), hw))
            # drawn for the global batch; this data index's rows
            draws = augment_draws(stream_seed(global_seed, _AUG_DRAWS), b * n_data,
                                  image_t.device)[local_rows(b * n_data, d_index, n_data)]
            x_aug = strong_augment(image_t.float(), draws).to(dt)
            aug_stream = layers_lib.DropoutStream(g, stream_seed(step_seed, _AUG_FORWARD))
            with frozen_stats(gen), torch.set_grad_enabled(mcfg.aug_backward), \
                    one_domain(x_aug.shape[0]):
                o_aug = gen(x_aug, True, 1, aug_stream).mask_logits.float()
            per_px = L.bce_sigmoid_stable_elementwise(o_aug, pseudo)
            # a data-dependent denominator: N * local sum / global sum
            loss_aug = mcfg.aug_weight * torch.sum(per_px * conf) / all_sum(torch.sum(conf))
            if dist_lib.world_size() > 1:
                loss_aug = loss_aug * dist_lib.world_size()
            if mcfg.aug_backward:
                loss = loss + loss_aug
            metrics["loss_aug"] = loss_aug

        if use_teacher:
            w = batch.get("consistency_weight", mcfg.consistency)
            cons = L.mse(torch.sigmoid(o_t), torch.sigmoid(teacher_out.mask_logits.float()))
            loss = loss + w * cons
            metrics["loss_consistency"] = cons

        # ---- generator update (only G's parameters take gradients) ----
        tracing.phase("clr.step.backward")
        optim_lib.set_lr(state.gen_opt, lr_gen)
        state.gen_opt.zero_grad(set_to_none=True)
        gen_params = [p for p in gen.parameters() if p.requires_grad]
        loss.backward(inputs=gen_params)
        average_grads(gen_params)
        tracing.phase("clr.step.update")
        state.gen_opt.step()
        metrics["loss_all"] = loss

        # ---- discriminator updates on the detached S/T outputs ----
        games = []
        if use_boundary_d:
            games.append(("loss_D", state.dis, state.dis_opt,
                          torch.sigmoid(out_s.boundary_logits.detach().float()).to(dt),
                          torch.sigmoid(bd_t.detach()).to(dt)))
        if use_entropy_d:
            games.append(("loss_D2", state.dis2, state.dis2_opt,
                          L.entropy_map(out_s.mask_logits.detach().float()).to(dt),
                          L.entropy_map(o_t.detach()).to(dt)))
        for name, dis, opt, x_s, x_t in games:
            optim_lib.set_lr(opt, lr_dis)
            opt.zero_grad(set_to_none=True)
            loss_d = _dis_loss(dis, x_s, x_t)
            loss_d.backward()
            average_grads(dis.parameters())
            opt.step()
            metrics[name] = loss_d

        # ---- prototype bank commit ----
        if use_proto:
            state.proto_src = src.stack().detach()
            state.proto_trg = trg.stack().detach()
            state.proto_src_init = torch.ones_like(state.proto_src_init)
            state.proto_trg_init = torch.ones_like(state.proto_trg_init)
        if use_bank:
            state.proto_bank = new_bank

        # ---- teacher EMA after the student step; stats track the student's ----
        if use_teacher:
            alpha = min(1.0 - 1.0 / (state.step + 1.0), mcfg.ema_decay)
            optim_lib.weight_ema(state.teacher, gen, alpha)
            with torch.no_grad():
                for t_buf, s_buf in zip(state.teacher.buffers(), gen.buffers()):
                    t_buf.copy_(s_buf)
        state.step += 1
        metrics = mean_metrics({k: v.detach() for k, v in metrics.items()})
        metrics["_viz"] = {k: v.detach() for k, v in viz.items()}
        return state, metrics

    return step


def _bank_losses(state: TrainState, mcfg, out_s, out_t, map_s, boundary_s, image_t, epoch,
                 metrics):
    """The disk-bank method's prototype phase (steps.py:779-879): per-image
    +1-smoothed pools of source bu/cup/disc from the labels, target pools
    under epoch-ramped thresholds of the (optionally distance-weighted)
    'before' heads, from the frozen initial model with
    ``pseudo_from_initial``. Returns (the sum of the pools' MSE distances,
    the bank's EMA toward the target pools); writes the distances into
    ``metrics``."""
    feat_hw = tuple(out_s.x_feature.shape[1:3])
    fg_eps = 1.0 if mcfg.bank_use_bu else 1e-16
    pred_s = P.resize_nhwc(map_s, feat_hw)
    bu_s = P.resize_nhwc(boundary_s, feat_hw)
    xs_f = out_s.x_feature.float()
    proto_x_bu = P.masked_pool_mean(out_s.x_bu_feature.float(), bu_s)
    proto_x_cup = P.masked_pool_mean(xs_f, pred_s[..., 0:1], fg_eps)
    proto_x_disc = P.masked_pool_mean(xs_f, pred_s[..., 1:2], fg_eps)

    thr = P.adaptation_factor(epoch)
    if mcfg.pseudo_from_initial:
        # the frozen initial model in eval mode (its stats cannot drift)
        with torch.no_grad():
            heads = state.initial(image_t, train=False)
    else:
        heads = out_t
    pred_t = torch.sigmoid(heads.mask_before.detach().float())
    bu_soft = torch.sigmoid(heads.boundary_before.detach().float())
    xt_f = out_t.x_feature.float()
    bank = state.proto_bank

    def rectified(soft, feat, key):
        if mcfg.use_weight_rectify:
            soft = soft * P.minmax_prototype_weight(
                P.feat_prototype_distance(feat.detach(), bank[key]))
        return (soft > thr).float()

    proto_y = {"cup": P.masked_pool_mean(xt_f, rectified(pred_t[..., 0:1], xt_f, "cup"), fg_eps),
               "disc": P.masked_pool_mean(xt_f, rectified(pred_t[..., 1:2], xt_f, "disc"),
                                          fg_eps)}
    dis_cup = torch.mean(torch.square(proto_x_cup - proto_y["cup"]))
    dis_disc = torch.mean(torch.square(proto_x_disc - proto_y["disc"]))
    bank_loss = dis_cup + dis_disc
    if mcfg.bank_use_bu:
        xt_bu = out_t.x_bu_feature.float()
        proto_y["bu"] = P.masked_pool_mean(xt_bu, rectified(bu_soft, xt_bu, "bu"))
        dis_bu = torch.mean(torch.square(proto_x_bu - proto_y["bu"]))
        bank_loss = bank_loss + dis_bu
        metrics["loss_bu"] = dis_bu
    metrics["loss_cup"] = dis_cup
    metrics["loss_disc"] = dis_disc
    # without bu (the delete_en ablation) no target bu pool exists, so the
    # bu vector never moves
    new_bank = {k: P.bank_ema(v, proto_y[k], mcfg.bank_ema) if k in proto_y else v
                for k, v in bank.items()}
    return bank_loss, new_bank


def make_eval_step(gen: DeepLab, dtype: torch.dtype = torch.float32):
    """Build ``step(image, map_t) -> (logits, boundary_logits, per_image)``
    (steps.py:1053-1074): an eval-mode forward of ``gen`` without gradients,
    float32 mask and boundary logits [B, H, W, C], and the per-image mean of
    BCE-with-logits against ``map_t`` ([B]), so the trainer can pad a
    partial batch and average over the real images only. uint8 wire inputs
    are decoded first; the metrics' binarization stays on the host."""

    @torch.no_grad()
    def step(image: torch.Tensor, map_t: torch.Tensor):
        decoded = decode_batch({"image": image, "map": map_t})
        outs = gen(decoded["image"].to(dtype), train=False)
        logits = outs.mask_logits.float()
        per_image = torch.mean(L.bce_with_logits_elementwise(logits, decoded["map"]),
                               dim=(1, 2, 3))
        return logits, outs.boundary_logits.float(), per_image

    return step
