"""Class-prototype math (uda_clr_tpu/ops/prototypes.py:34-296), NHWC inputs
as in the JAX package; every centroid division carries the +1e-12 guard.
The last five functions serve the disk-bank method (``method='prototype'``)
and the prototype-bank tool.

Under data parallelism the centroids, the pooled means and the min-max
weight are global values, reduced over the ranks (parallel/reduce.py) and
the same on every rank."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from uda_clr_tpu_torch.ops.resize import resize_bilinear_align_corners
from uda_clr_tpu_torch.parallel import spatial
from uda_clr_tpu_torch.parallel.distributed import world_size
from uda_clr_tpu_torch.parallel.reduce import all_max, all_min, all_sum

_EPS = 1e-12


class Prototypes(NamedTuple):
    cup_obj: torch.Tensor
    disc_obj: torch.Tensor
    cup_bck: torch.Tensor
    disc_bck: torch.Tensor

    def stack(self) -> torch.Tensor:
        return torch.stack(list(self))

    @staticmethod
    def unstack(x: torch.Tensor) -> "Prototypes":
        return Prototypes(x[0], x[1], x[2], x[3])


def _masked_centroid(feature, mask, weight=None):
    """sum(feature * mask * weight) / (sum(mask * weight) + eps) over (B,H,W)
    of the global batch (one packed all-sum of the sums)."""
    w = mask if weight is None else mask * weight
    num = torch.sum(feature * w, dim=(0, 1, 2))
    den = torch.sum(w, dim=(0, 1, 2))
    if world_size() > 1:
        packed = all_sum(torch.cat([num, den]))
        num, den = packed[:-1], packed[-1:]
    return num / (den + _EPS)


def gen_prototype(pred: torch.Tensor, feature: torch.Tensor) -> Prototypes:
    """Soft-mask global class centroids; pred [B,h,w,2], feature [B,h,w,C]."""
    cup, disc = pred[..., 0:1], pred[..., 1:2]
    return Prototypes(
        _masked_centroid(feature, cup),
        _masked_centroid(feature, disc),
        _masked_centroid(feature, 1.0 - cup),
        _masked_centroid(feature, 1.0 - disc),
    )


class RectifiedPrototypes(NamedTuple):
    prototypes: Prototypes
    std_map: torch.Tensor  # [B, H, W, 2]
    conf_mask: torch.Tensor  # [B, h, w, 2]


def resize_nhwc(x, hw):
    """Align-corners bilinear resize of an NHWC tensor to ``hw``."""
    return resize_bilinear_align_corners(x.permute(0, 3, 1, 2), hw).permute(0, 2, 3, 1)


def _rectify_masks(mask_before, feature, mc_logits, pseudo_threshold, std_threshold):
    """Per-region (pseudo-label x confidence) masks and mean-MC-probability
    weights, in Prototypes field order (prototypes.py:113-142)."""
    h, w = feature.shape[1], feature.shape[2]
    preds_soft = torch.sigmoid(mc_logits / 2.0)
    n = mc_logits.shape[0]
    if n > 1:  # unbiased std over T, as jnp.std(ddof=1)
        centered = preds_soft - preds_soft.mean(0)
        std_map = torch.sqrt(torch.sum(centered * centered, 0) / (n - 1))
    else:
        std_map = torch.zeros_like(preds_soft[0])
    prediction = torch.mean(torch.sigmoid(mc_logits), 0)
    prediction_small = resize_nhwc(prediction, (h, w))
    std_small = resize_nhwc(std_map, (h, w))

    pseudo = (torch.sigmoid(mask_before) > pseudo_threshold).to(feature.dtype)
    conf = (std_small < std_threshold).to(feature.dtype)
    masks = (
        pseudo[..., 0:1] * conf[..., 0:1],
        pseudo[..., 1:2] * conf[..., 1:2],
        (1.0 - pseudo[..., 0:1]) * conf[..., 0:1],
        (1.0 - pseudo[..., 1:2]) * conf[..., 1:2],
    )
    weights = (
        prediction_small[..., 0:1],
        prediction_small[..., 1:2],
        1.0 - prediction_small[..., 0:1],
        1.0 - prediction_small[..., 1:2],
    )
    return masks, weights, std_map, conf


def gen_prototype_retrify(mask_before, feature, mc_logits,
                          pseudo_threshold: float = 0.75,
                          std_threshold: float = 0.04) -> RectifiedPrototypes:
    """MC-dropout-rectified target centroids. mask_before [B,h,w,2] logits,
    feature [B,h,w,C], mc_logits [T,B,H,W,2] full-resolution logits."""
    masks, weights, std_map, conf = _rectify_masks(
        mask_before, feature, mc_logits, pseudo_threshold, std_threshold)
    protos = Prototypes(*(_masked_centroid(feature, m, w) for m, w in zip(masks, weights)))
    return RectifiedPrototypes(protos, std_map, conf)


def intra_domain_loss(src: Prototypes, trg: Prototypes) -> torch.Tensor:
    """Sum of the four matching-centroid MSEs."""
    return sum(torch.mean(torch.square(s - t)) for s, t in zip(src, trg))


def inter_domain_loss(src: Prototypes) -> torch.Tensor:
    """Source obj-vs-bck separation (logged only)."""
    return torch.mean(torch.square(src.disc_obj - src.disc_bck)) + torch.mean(
        torch.square(src.cup_obj - src.cup_bck))


def source_discriminative_loss(feature: torch.Tensor, pred: torch.Tensor,
                               protos: Prototypes) -> torch.Tensor:
    """Prototype-guided hinge on source (prototypes.py:212-253): per-pixel
    channel-mean squared distances to the own- and opposite-region
    centroids, hinged with margin 0.01, weighted by the region's soft GT
    mask and reduced with a plain mean. feature [B,h,w,C], pred [B,h,w,2];
    gradients reach both the features and the centroids."""
    margin = 0.01

    def chan_dist(c):
        return torch.mean(torch.square(feature - c), dim=-1)

    d_cup_obj, d_cup_bck = chan_dist(protos.cup_obj), chan_dist(protos.cup_bck)
    d_disc_obj, d_disc_bck = chan_dist(protos.disc_obj), chan_dist(protos.disc_bck)
    cup, disc = pred[..., 0], pred[..., 1]
    relu = torch.relu
    return (torch.mean(cup * relu(d_cup_obj - d_cup_bck + margin))
            + torch.mean((1.0 - cup) * relu(d_cup_bck - d_cup_obj + margin))
            + torch.mean(disc * relu(d_disc_obj - d_disc_bck + margin))
            + torch.mean((1.0 - disc) * relu(d_disc_bck - d_disc_obj + margin)))


def masked_pool_mean(feature: torch.Tensor, mask: torch.Tensor, eps: float = 1.0) -> torch.Tensor:
    """Per-image masked pooling with a smoothed denominator, then the batch
    mean: ``mean_b(sum_hw(feature * mask) / (sum_hw(mask) + eps))``
    (prototypes.py:255-269). eps is +1, or +1e-16 for the cup/disc pools of
    the ``bank_use_bu=False`` ablation. [B,h,w,C] x [B,h,w,1] -> [C].
    Under the spatial mesh an image's sums span its stripes: ``num`` and
    ``den`` are summed over the space group first, so every rank of the
    group holds the image's ratio, and the world sum counts each image
    n_space times over B_local * world = B * n_space."""
    num = torch.sum(feature * mask, dim=(1, 2))  # [B, C]
    den = torch.sum(mask, dim=(1, 2))  # [B, 1]
    if spatial.active():
        packed = spatial.space_sum(torch.cat([num, den], dim=1))
        num, den = packed[:, :-1], packed[:, -1:]
    den = den + eps
    if world_size() > 1:  # the global sum over B over the global B
        return all_sum(torch.sum(num / den, dim=0)) / (num.shape[0] * world_size())
    return torch.mean(num / den, dim=0)


def adaptation_factor(m: float) -> float:
    """The epoch-ramped pseudo-label threshold ``1/(1+exp(-0.8(m+1))) - 0.3``
    (prototypes.py:272-275), in float32 as the JAX step traces it."""
    f = np.float32
    return float(f(1.0) / (f(1.0) + np.exp(f(-0.8) * (f(m) + f(1.0)))) - f(0.3))


def cosine_prototype_weight(feature: torch.Tensor, prototype: torch.Tensor) -> torch.Tensor:
    """Per-pixel cosine similarity to a prototype (prototypes.py:278-283),
    [B,h,w,C] x [C] -> [B,h,w,1]."""
    fn = feature / (torch.linalg.vector_norm(feature, dim=-1, keepdim=True) + 1e-8)
    pn = prototype / (torch.linalg.vector_norm(prototype) + 1e-8)
    return torch.einsum("bhwc,c->bhw", fn, pn)[..., None]


def feat_prototype_distance(feature: torch.Tensor, prototype: torch.Tensor) -> torch.Tensor:
    """Per-pixel L2 distance to a prototype (prototypes.py:286-290),
    [B,h,w,C] x [C] -> [B,h,w,1]."""
    return torch.linalg.vector_norm(feature - prototype, dim=-1)[..., None]


def minmax_prototype_weight(dist: torch.Tensor) -> torch.Tensor:
    """Min-max normalized distance weight (prototypes.py:293-296), the min
    and max over the global batch."""
    lo, hi = all_min(torch.min(dist)), all_max(torch.max(dist))
    return (dist - lo) / (hi - lo + _EPS)


def bank_ema(bank: torch.Tensor, cur: torch.Tensor, momentum: float) -> torch.Tensor:
    """One disk-bank vector's EMA toward the current target prototype
    (steps.py:862-876, update_objective_SingleVector); an all-zero
    prototype leaves the vector as it was."""
    upd = (1.0 - momentum) * bank + momentum * cur.detach()
    return torch.where(torch.sum(cur.detach()) != 0.0, upd, bank)
