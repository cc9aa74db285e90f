"""Inputs made from ``--seed``: the initial weights, which the benchmark
hands to the program and to the reference alike, and the staged batches
of fundus-like images. Everything is drawn on the run's device with a
``torch.Generator`` in a few large calls; the same seed gives the same
tensors on the same device.
"""

from __future__ import annotations

import math

import torch

MASK64 = 0xFFFFFFFFFFFFFFFF
# sub-streams of the run's seed
_WEIGHTS, _BATCHES = 1, 2


def substream(seed: int, stream: int) -> int:
    """A 64-bit seed for one use of the run's seed (splitmix64)."""
    z = (seed * 0x9E3779B97F4A7C15 + stream * 0xD1B54A32D192ED03) & MASK64
    z = (z + 0x9E3779B97F4A7C15) & MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK64
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


def init_weights(modules: dict, seed: int, device) -> dict:
    """Initial state of each module, keyed ``{module: {name: tensor}}``
    over the modules' ``state_dict`` names, in sorted order: convolution
    weights N(0, 2 / fan_in) (He, fan in) in the generator, N(0, 0.02) in a
    discriminator (a module whose name starts with ``dis``); norm scales
    1, biases and running means 0, running variances 1. One normal draw
    per module on ``device``."""
    g = torch.Generator(device).manual_seed(substream(seed, _WEIGHTS))
    out = {}
    for mod_name in sorted(modules):
        sd = modules[mod_name].state_dict()
        names = sorted(sd)
        convs = [n for n in names if n.endswith("weight") and sd[n].dim() == 4]
        total = sum(sd[n].numel() for n in convs)
        z = torch.randn(total, generator=g, device=device, dtype=torch.float32)
        weights, off = {}, 0
        for n in names:
            shape = tuple(sd[n].shape)
            if n in convs:
                k = math.prod(shape)
                std = 0.02 if mod_name.startswith("dis") else math.sqrt(2.0 / math.prod(shape[1:]))
                weights[n] = (z[off:off + k] * std).view(shape)
                off += k
            elif n.endswith("running_var") or (n.endswith("weight") and len(shape) == 1):
                weights[n] = torch.ones(shape, device=device)
            else:
                weights[n] = torch.zeros(shape, device=device)
        out[mod_name] = weights
    return out


def fundus_batches(seed: int, pairs: int, batch: int, size: int, device) -> list[dict]:
    """``pairs`` distinct source/target batch pairs in the uint8 wire format
    (``image_s``, ``map_s``, ``boundary_s``, ``image_t``; NHWC): per image a
    bright disc ellipse with an inner cup on a tinted, noisy background, its
    place, radii, aspect, brightness and grain drawn per image from wide
    ranges, so every row differs and no half of a batch stands for it, and the target images' tint and brightness shifted from the
    source's; ``map`` holds the cup and disc masks, ``boundary`` a soft ring
    on the disc's and the cup's edges."""
    g = torch.Generator(device).manual_seed(substream(seed, _BATCHES))
    n = pairs * 2 * batch

    def u(lo, hi):
        return lo + (hi - lo) * torch.rand(n, 1, 1, generator=g, device=device)

    cy, cx = u(0.35, 0.65) * size, u(0.35, 0.65) * size
    disc_r = u(0.12, 0.32) * size
    cup_r = disc_r * u(0.3, 0.8)
    ar = u(0.8, 1.2)
    # the target domain (the second half of each pair) is brighter, bluer
    # and flatter, as one camera's images differ from another's
    target = ((torch.arange(n, device=device) // batch) % 2 == 1).view(n, 1, 1)
    base = torch.where(target, u(70.0, 200.0), u(40.0, 170.0))
    grain = u(6.0, 24.0)
    yy = torch.arange(size, device=device, dtype=torch.float32).view(1, -1, 1)
    xx = torch.arange(size, device=device, dtype=torch.float32).view(1, 1, -1)
    r = torch.sqrt((yy - cy) ** 2 * ar + (xx - cx) ** 2 / ar)  # [n, H, W]
    disc, cup = (r < disc_r).float(), (r < cup_r).float()
    b4 = base[..., None]
    t4 = target[..., None].float()
    img = torch.cat([b4 + 60.0 - 30.0 * t4, b4, b4 * (0.5 + 0.3 * t4)], dim=-1)  # [n, 1, 1, 3]
    img = img + torch.randn(n, size, size, 1, generator=g, device=device) * grain[..., None]
    img = img + disc[..., None] * torch.tensor([70.0, 60.0, 40.0], device=device)
    img = img + cup[..., None] * torch.tensor([40.0, 35.0, 20.0], device=device)
    img = img.clamp(0, 255).round().to(torch.uint8)
    ring = torch.exp(-torch.minimum((r - disc_r) ** 2, (r - cup_r) ** 2) / (2 * 4.0 ** 2))
    maps = torch.stack([cup, disc], dim=-1).to(torch.uint8)
    bnd = (ring * 255.0).round().to(torch.uint8)[..., None]
    out = []
    for p in range(pairs):
        s = slice(2 * p * batch, (2 * p + 1) * batch)
        t = slice((2 * p + 1) * batch, (2 * p + 2) * batch)
        out.append({"image_s": img[s].contiguous(), "map_s": maps[s].contiguous(),
                    "boundary_s": bnd[s].contiguous(), "image_t": img[t].contiguous()})
    return out
