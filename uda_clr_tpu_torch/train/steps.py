"""The flagship ``prototype_full`` train step (uda_clr_tpu/train/steps.py
:make_train_step, its ``mc_inline`` branch :582-657 and ``_mc_suffix``
:136-231), in both phases: warmup (``proto_phase=False``) and the prototype
phase with T-sample MC-dropout rectification on the inlined fast path.

One S||T forward with ``domains=2`` feeds the G loss, both D losses (on
detached outputs) and the prototype pooling; running stats update as each
part of the forward runs. The prototype phase reuses the target halves of
(ASPP-predrop, low-level) for the MC pass, which writes no running stats and
runs its mask head through the hand-written kernel (ops/mask_head.py).

bf16: the batch is cast to ``cfg.model.compute_dtype`` once; every conv
casts its float32 weight to the activation dtype, norms reduce in float32,
and losses run in float32 (explicit casts, no autocast).
"""

from __future__ import annotations

import torch

from uda_clr_tpu_torch.config import Config
from uda_clr_tpu_torch.models import layers as layers_lib
from uda_clr_tpu_torch.models.deeplab import DeepLab, DeepLabOutputs, nchw, nhwc
from uda_clr_tpu_torch.models.norm import batch_moments, normalize
from uda_clr_tpu_torch.ops import losses as L
from uda_clr_tpu_torch.ops import prototypes as P
from uda_clr_tpu_torch.ops.mask_head import fused_mask_head_split
from uda_clr_tpu_torch.ops.resize import resize_bilinear_align_corners, resize_nearest
from uda_clr_tpu_torch.train import optim as optim_lib
from uda_clr_tpu_torch.train.state import TrainState

_CL = torch.channels_last


def kernel_seed(seed: int, step: int) -> int:
    """64-bit Philox key of a step's mask-head draw (splitmix64 of the base
    seed and step counter; host integers only, no device sync)."""
    z = (seed * 0x9E3779B97F4A7C15 + step + 1) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return z ^ (z >> 31)


def _conv(x, weight, padding: int, bias=None):
    return torch.nn.functional.conv2d(
        x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype), padding=padding)


@torch.no_grad()
def mc_suffix(gen: DeepLab, feat_predrop, ll, hw, b: int, t_samples: int,
              generator: torch.Generator | None, seed: int):
    """T dropout-sampled mask-head passes from the deterministic prefix
    (NCHW ``feat_predrop`` [B,256,h',w'] and ``ll`` [B,48,h,w]); returns
    [T, B, H, W, 2] mask logits. Writes no running stats: BN uses batch
    moments computed here (steps.py:93-107,136-231)."""
    H, W = hw
    dec = gen.decoder
    bc = dec.last_conv_boundary
    drop = layers_lib.dropout
    # replicate at the first dropout site: one flat T*B batch
    feat_rep = torch.cat([feat_predrop] * t_samples, dim=0)
    ll_rep = torch.cat([ll] * t_samples, dim=0).contiguous(memory_format=_CL)
    x = drop(feat_rep, 0.5, generator)
    x_up = resize_bilinear_align_corners(x, tuple(ll.shape[2:])).contiguous(memory_format=_CL)

    # boundary head; conv1 split by linearity over the virtual 304-concat
    w1 = bc[0].weight  # [256, 304, 3, 3]
    y = _conv(x_up, w1[:, :256], 1) + _conv(ll_rep, w1[:, 256:], 1)
    mu1, var1 = batch_moments(y, (0, 2, 3))
    y = torch.relu(normalize(y, mu1, var1, bc[1].weight, bc[1].bias))
    y = drop(y, 0.5, generator)
    y = _conv(y, bc[4].weight, 1)
    mu2, var2 = batch_moments(y, (0, 2, 3))
    y = torch.relu(normalize(y, mu2, var2, bc[5].weight, bc[5].bias))
    y = drop(y, 0.1, generator)
    boundary = _conv(y, bc[8].weight, 0, bc[8].bias).contiguous(memory_format=_CL)

    # mask head: the virtual 305-concat's moments are the per-part moments
    moments = [batch_moments(t, (0, 2, 3)) for t in (x_up, ll_rep, boundary)]
    mask_bn, mask_out = dec.last_conv[0], dec.last_conv[3]
    x1 = fused_mask_head_split(
        nhwc(x_up), nhwc(ll_rep), nhwc(boundary),
        torch.cat([m for m, _ in moments]), torch.cat([v for _, v in moments]),
        mask_bn.weight, mask_bn.bias, mask_out.weight, mask_out.bias,
        seed, rate=0.0 if layers_lib.dropout_off() else 0.1,
    )
    mc = resize_bilinear_align_corners(nchw(x1), (H, W))
    return nhwc(mc).reshape(t_samples, b, H, W, -1)


def _split(outs: DeepLabOutputs, b: int):
    return DeepLabOutputs(*(o[:b] for o in outs)), DeepLabOutputs(*(o[b:] for o in outs))


def _ema_bank(bank, init, cur: P.Prototypes, d: float) -> P.Prototypes:
    return P.Prototypes(*(torch.where(init, (1 - d) * bk + d * cu, cu)
                          for bk, cu in zip(P.Prototypes.unstack(bank), cur)))


def _dis_loss(dis, x_s, x_t):
    out_s, out_t = dis(x_s).float(), dis(x_t).float()
    return L.bce_with_logits(out_s, torch.ones_like(out_s)) + \
        L.bce_with_logits(out_t, torch.zeros_like(out_t))


def make_train_step(cfg: Config, method: str = "prototype_full", proto_phase: bool = False):
    """Build ``step(state, batch, lr_gen, lr_dis, epoch) -> (state, metrics)``.

    ``batch``: image_s, map_s, boundary_s, image_t, NHWC float32 tensors on
    the state's device. ``metrics`` holds detached 0-d tensors (no host sync
    inside the step). The state's modules and optimizers update in place.
    """
    mcfg = cfg.method
    if method != "prototype_full" or cfg.model.norm != "bn":
        raise NotImplementedError(f"{method}/{cfg.model.norm} is not ported yet")
    if proto_phase and not (mcfg.retrify_pseudo and mcfg.mc_fast):
        raise NotImplementedError("only the inlined MC-rectified prototype phase is ported")
    dt = cfg.model.dtype

    def step(state: TrainState, batch: dict, lr_gen: float, lr_dis: float, epoch=None):
        gen, g = state.gen, state.generator
        image_s = batch["image_s"].to(dt)
        map_s, boundary_s = batch["map_s"], batch["boundary_s"]
        b = image_s.shape[0]
        x_all = nchw(torch.cat([image_s, batch["image_t"].to(dt)], dim=0))
        hw = tuple(x_all.shape[2:])

        # ---- one S||T forward (domains=2) ----
        high, low = gen.features(x_all, True, 2)
        fp_all, ll_all = gen.heads_prefix(high, low, True, 2)
        outs = gen.heads_suffix(fp_all, ll_all, hw, True, 2, g)
        mc = None
        if proto_phase:
            mc = mc_suffix(gen, fp_all[b:].detach(), ll_all[b:].detach(), hw, b,
                           mcfg.mc_samples, g, kernel_seed(state.seed, state.step)).float()
        out_s, out_t = _split(outs, b)

        # ---- generator loss ----
        o_s = out_s.mask_logits.float()
        b_s = out_s.boundary_logits.float()
        loss_seg = L.bce_sigmoid_stable(o_s, map_s) + L.mse(torch.sigmoid(b_s), boundary_s)
        o_t = out_t.mask_logits.float()
        bd_t = out_t.boundary_logits.float()
        # reference term order: entropy-D first, boundary-D second
        d_u = state.dis2(L.entropy_map(o_t).to(dt)).float()
        adv = L.bce_with_logits(d_u, torch.ones_like(d_u))
        d_b = state.dis(torch.sigmoid(bd_t).to(dt)).float()
        adv = adv + L.bce_with_logits(d_b, torch.ones_like(d_b))
        loss_adv = mcfg.adv_weight * adv
        loss = loss_seg + loss_adv
        metrics = {"loss_seg": loss_seg, "loss_adv": loss_adv}

        if proto_phase:
            x_feat_s = out_s.x_feature.float()
            pred_s = nhwc(resize_nearest(nchw(map_s), tuple(x_feat_s.shape[1:3])))
            src = P.gen_prototype(pred_s, x_feat_s)
            rect = P.gen_prototype_retrify(
                out_t.mask_before.float(), out_t.x_feature.float(), mc,
                mcfg.pseudo_threshold, mcfg.std_threshold)
            trg = rect.prototypes
            if mcfg.use_global:
                d = mcfg.global_pro_weight
                src = _ema_bank(state.proto_src, state.proto_src_init, src, d)
                trg = _ema_bank(state.proto_trg, state.proto_trg_init, trg, d)
            intra = P.intra_domain_loss(src, trg)
            loss = loss + mcfg.pro_weight * intra
            metrics["loss_intra"] = intra
            metrics["loss_inter"] = P.inter_domain_loss(src)

        # ---- generator update (only G's parameters take gradients) ----
        optim_lib.set_lr(state.gen_opt, lr_gen)
        state.gen_opt.zero_grad(set_to_none=True)
        gen_params = [p for p in gen.parameters() if p.requires_grad]
        loss.backward(inputs=gen_params)
        state.gen_opt.step()
        metrics["loss_all"] = loss

        # ---- discriminator updates on the detached S/T outputs ----
        sig_bs = torch.sigmoid(out_s.boundary_logits.detach().float()).to(dt)
        sig_bt = torch.sigmoid(bd_t.detach()).to(dt)
        ent_s = L.entropy_map(out_s.mask_logits.detach().float()).to(dt)
        ent_t = L.entropy_map(o_t.detach()).to(dt)
        for name, dis, opt, x_s, x_t in (("loss_D", state.dis, state.dis_opt, sig_bs, sig_bt),
                                         ("loss_D2", state.dis2, state.dis2_opt, ent_s, ent_t)):
            optim_lib.set_lr(opt, lr_dis)
            opt.zero_grad(set_to_none=True)
            loss_d = _dis_loss(dis, x_s, x_t)
            loss_d.backward()
            opt.step()
            metrics[name] = loss_d

        # ---- prototype bank commit ----
        if proto_phase:
            state.proto_src = src.stack().detach()
            state.proto_trg = trg.stack().detach()
            state.proto_src_init = torch.ones_like(state.proto_src_init)
            state.proto_trg_init = torch.ones_like(state.proto_trg_init)
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return step
