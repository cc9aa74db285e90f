"""Colour-space strong augmentation of the target batch for the
augmented-consistency loss (uda_clr_tpu/ops/augment.py): albumentations'
RandomBrightnessContrast + HueSaturationValue (p=0.8 together), ToGray
(p=0.2) and GaussianBlur(5) (p=0.5, ksize 3 or 5, cv2's binomial taps,
reflect-101 border), with the uint8 quantisation points ``_t8``/``_q8``
and the channel reversal of the reference's BGR round-trip.

The random draws and the transform are two functions: :func:`augment_draws`
gives nine uniforms in [0, 1) per image, :func:`strong_augment` applies the
transform they select, so a test can feed both frameworks the same draws.
NHWC float32 images in [-1, 1] in and out; geometry is untouched.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from uda_clr_tpu_torch.ops.philox import philox_words
from uda_clr_tpu_torch.parallel import spatial

N_DRAWS = 9
# cv2.getGaussianKernel(k, 0) for k = 3 and 5, as 5 taps (zero ends for k=3)
_TAP5 = {3: (0.0, 0.25, 0.5, 0.25, 0.0), 5: (0.0625, 0.25, 0.375, 0.25, 0.0625)}
_GRAY = (0.299, 0.587, 0.114)


def augment_draws(seed: int, b: int, device) -> torch.Tensor:
    """[b, 9] float32 uniforms in [0, 1) (24-bit) from the Philox stream of
    ``seed``, computed on the host, so the card and the CPU draw alike."""
    words = philox_words(0, N_DRAWS * b, seed, "cpu")
    u = ((words >> 8).to(torch.float32) * 2.0**-24).reshape(b, N_DRAWS)
    device = torch.device(device)
    if device.type == "cuda":
        return u.pin_memory().to(device, non_blocking=True)
    return u.to(device)


def _uniform(u, lo: float, hi: float):
    """jax.random.uniform's map of a [0, 1) draw onto [lo, hi) in float32."""
    lo_t, hi_t = torch.tensor(lo, dtype=torch.float32), torch.tensor(hi, dtype=torch.float32)
    lo32 = lo_t.item()
    return torch.clamp(u * (hi_t - lo_t).item() + lo32, min=lo32)


def _t8(x):
    """Snap to the uint8 grid, truncating (``astype(np.uint8)``)."""
    return torch.floor(x * 255.0 + 1e-3) / 255.0


def _q8(x):
    """Snap to the uint8 grid, rounding to nearest (cv2's uint8 outputs)."""
    return torch.round(x * 255.0) / 255.0


def _mod1(x):
    """``x % 1.0`` as jnp.remainder computes it (fmod, then +1 if negative)."""
    r = torch.fmod(x, 1.0)
    return torch.where((r != 0) & (r < 0), r + 1.0, r)


def _rgb_to_hsv(rgb):
    r, g, b = rgb.unbind(-1)
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    v = maxc
    delta = maxc - minc
    zero = torch.zeros((), dtype=rgb.dtype, device=rgb.device)
    s = torch.where(maxc > 0, delta / (maxc + 1e-12), zero)
    safe = torch.where(delta > 0, delta, torch.ones_like(delta))
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta > 0, _mod1(h / 6.0), zero)
    return torch.stack([h, s, v], dim=-1)


def _hsv_to_rgb(hsv):
    h, s, v = hsv.unbind(-1)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int64), 6).unsqueeze(-1)
    pick = lambda *vals: torch.stack(vals, dim=-1).gather(-1, i).squeeze(-1)
    return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p), pick(p, p, t, v, v, q)],
                       dim=-1)


def _blur5(x, taps):
    """Separable 5-tap blur of NCHW ``x`` with per-image taps [B, 5], rows
    first, reflect-101 border. Under the spatial mesh a stripe's rows
    above and below come from its neighbours, reflected at the image's
    true edge only."""
    h, w = x.shape[2], x.shape[3]
    k = [taps[:, i].reshape(-1, 1, 1, 1) for i in range(5)]
    if spatial.active():
        xp = spatial.halo_rows(x, 2, 2, "reflect")
    else:
        xp = F.pad(x, (0, 0, 2, 2), mode="reflect")
    acc = k[0] * xp[:, :, 0:h]
    for i in range(1, 5):
        acc = acc + k[i] * xp[:, :, i:i + h]
    xp = F.pad(acc, (2, 2, 0, 0), mode="reflect")
    acc = k[0] * xp[..., 0:w]
    for i in range(1, 5):
        acc = acc + k[i] * xp[..., i:i + w]
    return acc


def strong_augment(images: torch.Tensor, draws: torch.Tensor) -> torch.Tensor:
    """NHWC [B,H,W,3] float32 in [-1, 1] -> the same, transformed as the
    nine draws per image [B, 9] select (augment.py:121-164)."""
    flag = lambda j, p: (draws[:, j] < p).reshape(-1, 1, 1, 1)
    per_image = lambda t: t.reshape(-1, 1, 1)
    alpha = per_image(1.0 + _uniform(draws[:, 1], -0.2, 0.2))
    beta = per_image(_uniform(draws[:, 2], -0.2, 0.2))
    hue = per_image(_uniform(draws[:, 3], -20.0, 20.0) / 180.0)
    sat = per_image(_uniform(draws[:, 4], -30.0, 30.0) / 255.0)
    val = per_image(_uniform(draws[:, 5], -20.0, 20.0) / 255.0)

    # channel-reversed view: the reference's BGR<->RGB round-trip on RGB data
    x = _t8((images.flip(-1) + 1.0) * 0.5)

    y = _t8(torch.clamp(x * alpha.unsqueeze(-1) + beta.unsqueeze(-1), 0.0, 1.0))
    h, s, v = _rgb_to_hsv(y).unbind(-1)
    hsv = torch.stack([_mod1(h + hue), torch.clamp(s + sat, 0.0, 1.0),
                       torch.clamp(v + val, 0.0, 1.0)], dim=-1)
    x = torch.where(flag(0, 0.8), _q8(_hsv_to_rgb(hsv)), x)

    gray = _q8(x[..., 0:1] * _GRAY[0] + x[..., 1:2] * _GRAY[1] + x[..., 2:3] * _GRAY[2])
    x = torch.where(flag(6, 0.2), gray.expand_as(x), x)

    taps = torch.where(draws[:, 7:8] < 0.5,
                       torch.tensor(_TAP5[5], dtype=torch.float32, device=x.device),
                       torch.tensor(_TAP5[3], dtype=torch.float32, device=x.device))
    blurred = _q8(_blur5(x.permute(0, 3, 1, 2), taps)).permute(0, 2, 3, 1)
    x = torch.where(flag(8, 0.5), blurred, x)
    return x.flip(-1) * 2.0 - 1.0
