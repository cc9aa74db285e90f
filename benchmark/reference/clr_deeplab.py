"""Plain reference of the CLR train step: DeepLabv3+ (MobileNetV2 or
ResNet-101 backbone, output stride 16, batch norm with per-half source ||
target moments), the prototype_full method (the MC-dropout rectification
with T samples, the global EMA prototype banks, the intra-domain loss) or
its warm-up step, the boundary and entropy PatchGANs, Adam for the
generator and SGD for the discriminators.

Plain PyTorch in float32, no hand-written kernels: a frozen, self-contained
transcription of the published method as the program under test implements
it (DeepLabv3+, Chen et al., arXiv:1802.02611; the CLR trainers), with no
data parallelism and no TransNorm. It imports nothing of the program.

The random draws are worked out again from the seed the benchmark gives
both sides: the dropout sites draw 16-bit words from a ``torch.Generator``
seeded with it, in the order the step visits them, and the MC mask head
draws Philox4x32-10 words from a per-step 64-bit key (splitmix64 of the
seed and the step). On a CUDA device the activations are channels_last,
so the words land on the same elements as in a program laid out alike.

``quant``: the lower-precision control. A rounding function applied
wherever the program, computing in bfloat16, rounds an activation: the
model's input, each convolution's input, weight and output, the steps of
a norm's apply (the mean, the difference, the coefficients, the product,
the bias, the sum), residual sums, pools, resizes, dropout's scaling, the
discriminators' inputs and activations, and the MC mask head's
coefficients, apply, scaling and output; the control's function rounds the
gradient that flows back through each of these points too. None computes
in float32; the caller turns TF32 off.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F

MASK32 = 0xFFFFFFFF
MASK64 = 0xFFFFFFFFFFFFFFFF
_CL = torch.channels_last
EPS_BN = 1e-5


# ---------------------------------------------------------------- random draws

def splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK64
    return z ^ (z >> 31)


def step_key(seed: int, step: int) -> int:
    """The 64-bit Philox key of step ``step``'s MC mask-head draw."""
    return splitmix64((seed * 0x9E3779B97F4A7C15 + step) & MASK64)


def _mulhilo(a: int, c):
    p1 = c * (a & 0xFFFF)
    p2 = c * (a >> 16)
    s = ((p2 & 0xFFFF) << 16) + p1
    return (p2 >> 16) + (s >> 32), s & MASK32


def philox_words(n: int, key: int, device) -> torch.Tensor:
    """Words 0 .. n-1 of Philox4x32-10 under ``key``: element e is word
    (e & 3) of the block at counter (e >> 2, 0, 0, 0); int64 [n]."""
    g = torch.arange(0, (n + 3) >> 2, device=device, dtype=torch.int64)
    c0, c1 = g & MASK32, g >> 32
    c2 = c3 = torch.zeros_like(g)
    k0, k1 = key & MASK32, (key >> 32) & MASK32
    for i in range(10):
        if i:
            k0, k1 = (k0 + 0x9E3779B9) & MASK32, (k1 + 0xBB67AE85) & MASK32
        hi0, lo0 = _mulhilo(0xD2511F53, c0)
        hi1, lo1 = _mulhilo(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack([c0, c1, c2, c3], dim=1).view(-1)[:n]


def ident(x):
    return x


def dropout(x: torch.Tensor, rate: float, generator, q=ident) -> torch.Tensor:
    """Keep where a 16-bit word < round(keep * 2^16) (at most 65535);
    survivors x / keep."""
    keep = 1.0 - rate
    thr = min(int(round(keep * 65536.0)), 65535)
    bits = torch.empty_like(x, dtype=torch.int16).random_(-32768, 32768, generator=generator)
    keep_t = torch.full((), keep, dtype=x.dtype, device=x.device)
    return torch.where(bits < thr - 32768, q(x / keep_t), torch.zeros((), dtype=x.dtype,
                                                                      device=x.device))


# ---------------------------------------------------------------- layers

class Module(nn.Module):
    q = staticmethod(ident)  # the control's rounding, set on the instance by build()


class Conv2d(nn.Conv2d):
    q = staticmethod(ident)

    def forward(self, x):
        q = self.q
        return q(F.conv2d(q(x), q(self.weight), self.bias, self.stride, self.padding,
                          self.dilation, self.groups))


class BatchNorm(Module):
    """Batch norm with float32 moments E[x^2] - E[x]^2 (clamped at 0);
    ``domains=2`` normalises each half of the batch with its own moments
    and updates the running stats target half first, then source
    (momentum 0.1, unbiased variance). ``update`` False writes nothing."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.update = True

    @torch.no_grad()
    def _ema(self, mean, var, n):
        if self.update:
            self.running_mean.copy_(0.9 * self.running_mean + 0.1 * mean)
            self.running_var.copy_(0.9 * self.running_var + 0.1 * (var * (n / max(n - 1, 1))))

    def forward(self, x, domains: int = 1):
        if domains <= 1:
            mu, var = moments(x, (0, 2, 3))
            self._ema(mu, var, x.numel() // x.shape[1])
            return normalize(x, mu, var, self.weight, self.bias, self.q)
        b = x.shape[0] // 2
        parts = []
        stats = [moments(h, (0, 2, 3)) for h in (x[:b], x[b:])]
        n = b * x.shape[2] * x.shape[3]
        self._ema(*stats[1], n)
        self._ema(*stats[0], n)
        for h, (mu, var) in zip((x[:b], x[b:]), stats):
            parts.append(normalize(h, mu, var, self.weight, self.bias, self.q))
        return torch.cat(parts, dim=0)


def moments(x, dims):
    mean = x.mean(dims)
    return mean, torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)


def normalize(x, mean, var, scale, bias, q=ident):
    s = (1, -1, 1, 1)
    a = (torch.rsqrt(var + EPS_BN) * scale).reshape(s)
    return q(q(q(x - q(mean.reshape(s))) * q(a)) + q(bias.reshape(s)))


def run(layers, x, domains: int):
    for layer in layers:
        x = layer(x, domains) if isinstance(layer, BatchNorm) else layer(x)
    return x


def upsample(x, hw, q=ident):
    if tuple(x.shape[-2:]) == tuple(hw):
        return x
    return q(F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=True))


def nearest(x, hw):
    """Nearest resize with source index floor(i * in / out)."""
    h_in, w_in = x.shape[-2:]
    if (h_in, w_in) == tuple(hw):
        return x
    rows = torch.arange(hw[0], device=x.device) * h_in // hw[0]
    cols = torch.arange(hw[1], device=x.device) * w_in // hw[1]
    return x.index_select(-2, rows).index_select(-1, cols)


# ---------------------------------------------------------------- backbones

class InvertedResidual(Module):
    def __init__(self, inp, oup, stride, dilation, t):
        super().__init__()
        hidden = round(inp * t)
        self.dilation = dilation
        self.use_res = stride == 1 and inp == oup
        layers = [] if t == 1 else [Conv2d(inp, hidden, 1, 1, 0, bias=False), BatchNorm(hidden),
                                    nn.ReLU6()]
        layers += [Conv2d(hidden, hidden, 3, stride, 0, dilation, groups=hidden, bias=False),
                   BatchNorm(hidden), nn.ReLU6(), Conv2d(hidden, oup, 1, 1, 0, bias=False),
                   BatchNorm(oup)]
        self.conv = nn.ModuleList(layers)

    def forward(self, x, domains):
        k = 3 + 2 * (self.dilation - 1) - 1  # fixed 'same' padding of the block input
        h = run(self.conv, F.pad(x, (k // 2, k - k // 2, k // 2, k - k // 2)), domains)
        return self.q(x + h) if self.use_res else h


class MobileNetV2(Module):
    """(high [B,320,H/16,W/16], low [B,24,H/4,W/4]) at output stride 16."""
    SETTINGS = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2), (6, 96, 3, 1),
                (6, 160, 3, 2), (6, 320, 1, 1))
    widths = (320, 24)

    def __init__(self, output_stride: int = 16):
        super().__init__()
        blocks, in_ch, cur, rate = [], 32, 2, 1
        for t, c, n, s in self.SETTINGS:
            if cur == output_stride:
                stride, dilation, rate = 1, rate, rate * s
            else:
                stride, dilation, cur = s, 1, cur * s
            for i in range(n):
                blocks.append(InvertedResidual(in_ch, c, stride if i == 0 else 1, dilation, t))
                in_ch = c
        stem = nn.ModuleList([Conv2d(3, 32, 3, 2, 1, bias=False), BatchNorm(32), nn.ReLU6()])
        self.features = nn.ModuleList([stem] + blocks)

    def forward(self, x, domains):
        h = run(self.features[0], x, domains)
        low = None
        for i, block in enumerate(self.features[1:]):
            h = block(h, domains)
            if i == 2:
                low = h
        return h, low


class Bottleneck(Module):
    def __init__(self, inplanes, planes, stride, dilation, downsample):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride, dilation, dilation, bias=False)
        self.bn2 = BatchNorm(planes)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm(planes * 4)
        self.downsample = nn.ModuleList([Conv2d(inplanes, planes * 4, 1, stride, bias=False),
                                         BatchNorm(planes * 4)]) if downsample else None

    def forward(self, x, domains):
        h = F.relu(self.bn1(self.conv1(x), domains))
        h = F.relu(self.bn2(self.conv2(h), domains))
        h = self.bn3(self.conv3(h), domains)
        res = x if self.downsample is None else run(self.downsample, x, domains)
        return F.relu(self.q(h + res))


class ResNet101(Module):
    """DeepLabv3+'s ResNet-101 at output stride 16: stages [3, 4, 23, 3],
    strides (1, 2, 2, 1), dilations (1, 1, 1, 2), multi-grid (1, 2, 4) on
    layer4; (high [B,2048,H/16,W/16], low = layer1 [B,256,H/4,W/4])."""
    widths = (2048, 256)

    def __init__(self, output_stride: int = 16):
        super().__init__()
        if output_stride != 16:
            raise NotImplementedError("the reference holds output stride 16")
        strides, dilations = (1, 2, 2, 1), (1, 1, 1, 2)
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm(64)
        inplanes = 64
        for i, (planes, blocks) in enumerate(((64, 3), (128, 4), (256, 23), (512, 3))):
            rates = (1, 2, 4) if i == 3 else (1,) * blocks
            layer = []
            for j in range(blocks):
                down = j == 0 and (strides[i] != 1 or inplanes != planes * 4)
                layer.append(Bottleneck(inplanes, planes, strides[i] if j == 0 else 1,
                                        rates[j] * dilations[i], down))
                inplanes = planes * 4
            setattr(self, f"layer{i + 1}", nn.ModuleList(layer))

    def forward(self, x, domains):
        h = F.max_pool2d(F.relu(self.bn1(self.conv1(x), domains)), 3, 2, 1)
        low = None
        for i in range(1, 5):
            for block in getattr(self, f"layer{i}"):
                h = block(h, domains)
            if i == 1:
                low = h
        return h, low


BACKBONES = {"mobilenet": MobileNetV2, "resnet": ResNet101}


# ---------------------------------------------------------------- heads

class ASPPBranch(Module):
    def __init__(self, inplanes, k, d):
        super().__init__()
        self.atrous_conv = Conv2d(inplanes, 256, k, 1, 0 if k == 1 else d, d, bias=False)
        self.bn = BatchNorm(256)

    def forward(self, x, domains):
        return F.relu(self.bn(self.atrous_conv(x), domains))


class ASPP(Module):
    def __init__(self, inplanes):
        super().__init__()
        for i, (k, d) in enumerate(((1, 1), (3, 6), (3, 12), (3, 18))):
            setattr(self, f"aspp{i + 1}", ASPPBranch(inplanes, k, d))
        self.global_avg_pool = nn.ModuleList([nn.AdaptiveAvgPool2d(1),
                                              Conv2d(inplanes, 256, 1, bias=False),
                                              BatchNorm(256)])
        self.conv1 = Conv2d(1280, 256, 1, bias=False)
        self.bn1 = BatchNorm(256)

    def predrop(self, x, domains):
        branches = [getattr(self, f"aspp{i}")(x, domains) for i in range(1, 5)]
        pool, conv, bn = self.global_avg_pool
        pooled = F.relu(bn(conv(self.q(pool(x))), domains))
        branches.append(upsample(pooled, x.shape[2:], self.q))
        return F.relu(self.bn1(self.conv1(torch.cat(branches, dim=1)), domains))


class Decoder(Module):
    def __init__(self, low_inplanes, num_classes=2):
        super().__init__()
        self.conv1 = Conv2d(low_inplanes, 48, 1, bias=False)
        self.bn1 = BatchNorm(48)
        self.last_conv = nn.ModuleList([BatchNorm(305), nn.ReLU(), nn.Identity(),
                                        Conv2d(305, num_classes, 1)])
        self.last_conv_boundary = nn.ModuleList([
            Conv2d(304, 256, 3, 1, 1, bias=False), BatchNorm(256), nn.ReLU(), nn.Identity(),
            Conv2d(256, 256, 3, 1, 1, bias=False), BatchNorm(256), nn.ReLU(), nn.Identity(),
            Conv2d(256, 1, 1)])


class Outputs(NamedTuple):  # NHWC
    mask_logits: torch.Tensor
    boundary_logits: torch.Tensor
    x_feature: torch.Tensor
    mask_before: torch.Tensor


def nhwc(x):
    return x.permute(0, 2, 3, 1)


def nchw(x):
    return x.permute(0, 3, 1, 2)


class DeepLab(Module):
    """Backbone + ASPP + the dual-head decoder; parameter names are the
    program's state-dict keys."""

    def __init__(self, backbone: str = "mobilenet", output_stride: int = 16):
        super().__init__()
        self.backbone = BACKBONES[backbone](output_stride)
        high, low = self.backbone.widths
        self.aspp = ASPP(high)
        self.decoder = Decoder(low)

    def prefix(self, x, domains):
        high, low = self.backbone(x, domains)
        dec = self.decoder
        return self.aspp.predrop(high, domains), F.relu(dec.bn1(dec.conv1(low), domains))

    def suffix(self, fp, ll, hw, domains, g):
        """The dropout sites in the order the step draws them: ASPP's 0.5,
        the boundary head's 0.5 and 0.1, the mask head's 0.1."""
        dec, q = self.decoder, self.q
        x = upsample(dropout(fp, 0.5, g, q), ll.shape[2:], q)
        x_bu = torch.cat([x, ll], dim=1)
        c = dec.last_conv_boundary
        y = F.relu(c[1](c[0](x_bu), domains))
        y = F.relu(c[5](c[4](dropout(y, 0.5, g, q)), domains))
        boundary = c[8](dropout(y, 0.1, g, q))
        x_feature = torch.cat([x_bu, boundary], dim=1)
        m = dec.last_conv
        x1 = m[3](dropout(F.relu(m[0](x_feature, domains)), 0.1, g, q))
        return Outputs(nhwc(upsample(x1, hw, q)), nhwc(upsample(boundary, hw, q)),
                       nhwc(x_feature), nhwc(x1))


class PatchGAN(Module):
    """Five conv(k4, s2, p2) layers to 64-128-256-512-1, LeakyReLU(0.2)."""

    def __init__(self, cin):
        super().__init__()
        ch = (cin, 64, 128, 256, 512, 1)
        for i in range(5):
            self.add_module(f"conv{i + 1}", Conv2d(ch[i], ch[i + 1], 4, 2, 2, bias=False))

    def forward(self, x_nhwc):
        x = nchw(self.q(x_nhwc))
        for i in range(1, 6):
            x = getattr(self, f"conv{i}")(x)
            if i < 5:
                x = self.q(F.leaky_relu(x, 0.2))
        return nhwc(x)


# ---------------------------------------------------------------- losses

def bce_prob(logits, t):
    """BCELoss(sigmoid(x), t) with the -100 log clamp."""
    p = torch.sigmoid(logits)
    return -torch.mean(t * torch.clamp(torch.log(p), min=-100.0)
                       + (1.0 - t) * torch.clamp(torch.log1p(-p), min=-100.0))


class _BceProb(torch.autograd.Function):
    """Value :func:`bce_prob`; gradient (sigmoid(x) - t) / N, unclamped."""

    @staticmethod
    def forward(ctx, logits, t):
        ctx.save_for_backward(logits, t)
        return bce_prob(logits, t)

    @staticmethod
    def backward(ctx, g):
        logits, t = ctx.saved_tensors
        return g * (torch.sigmoid(logits) - t) / logits.numel(), None


def bce_logits(x, t):
    return torch.mean(torch.clamp(x, min=0.0) - x * t + torch.log1p(torch.exp(-torch.abs(x))))


def entropy(logits):
    p = torch.sigmoid(logits)
    return -p * torch.log(p + 1e-7)


def centroid(feature, mask, weight=None):
    w = mask if weight is None else mask * weight
    return torch.sum(feature * w, dim=(0, 1, 2)) / (torch.sum(w, dim=(0, 1, 2)) + 1e-12)


def prototypes(pred, feature):
    """(cup_obj, disc_obj, cup_bck, disc_bck) soft-mask centroids."""
    cup, disc = pred[..., 0:1], pred[..., 1:2]
    return [centroid(feature, m) for m in (cup, disc, 1.0 - cup, 1.0 - disc)]


def rectified_prototypes(mask_before, feature, mc, pseudo_thr, std_thr):
    """Target centroids from pseudo-labels kept where the MC samples agree
    (their unbiased std under ``std_thr``), weighted by the mean MC
    probability; and that std map [B, H, W, 2]."""
    h, w = feature.shape[1:3]
    soft = torch.sigmoid(mc / 2.0)
    t = mc.shape[0]
    std = torch.sqrt(torch.sum(torch.square(soft - soft.mean(0)), 0) / (t - 1))
    pred = torch.mean(torch.sigmoid(mc), 0)
    small = lambda z: nhwc(upsample(nchw(z), (h, w)))  # noqa: E731
    pred_s, std_s = small(pred), small(std)
    pseudo = (torch.sigmoid(mask_before) > pseudo_thr).float()
    conf = (std_s < std_thr).float()
    masks = [pseudo[..., i:i + 1] * conf[..., i:i + 1] for i in (0, 1)] + \
        [(1.0 - pseudo[..., i:i + 1]) * conf[..., i:i + 1] for i in (0, 1)]
    weights = [pred_s[..., 0:1], pred_s[..., 1:2], 1.0 - pred_s[..., 0:1], 1.0 - pred_s[..., 1:2]]
    return [centroid(feature, m, wt) for m, wt in zip(masks, weights)], std


# ---------------------------------------------------------------- the MC pass

@torch.no_grad()
def mc_pass(gen: DeepLab, fp, ll, hw, t_samples, g, key, q=ident):
    """T dropout samples of the mask head from the target half's prefix,
    with batch moments and no running-stat writes; [T, B, H, W, 2]."""
    b = fp.shape[0]
    dec = gen.decoder
    bc = dec.last_conv_boundary
    cl = _CL  # as the program lays the MC pass out, on any device
    x = dropout(torch.cat([fp] * t_samples, dim=0), 0.5, g, q)
    ll_rep = torch.cat([ll] * t_samples, dim=0).contiguous(memory_format=cl)
    x_up = upsample(x, ll.shape[2:], q).contiguous(memory_format=cl)

    def conv(z, w, pad, bias=None):
        return q(F.conv2d(q(z), q(w), bias, 1, pad))

    def bn(z, norm):
        mu, var = moments(z, (0, 2, 3))
        return F.relu(normalize(z, mu, var, norm.weight, norm.bias, q))

    w1 = bc[0].weight
    y = bn(q(conv(x_up, w1[:, :256], 1) + conv(ll_rep, w1[:, 256:], 1)), bc[1])
    y = bn(conv(dropout(y, 0.5, g, q), bc[4].weight, 1), bc[5])
    boundary = conv(dropout(y, 0.1, g, q), bc[8].weight, 0, bc[8].bias)
    boundary = boundary.contiguous(memory_format=cl)
    # the mask head over the 305 rows, with Philox dropout at 0.1
    rows = torch.cat([nhwc(x_up), nhwc(ll_rep), nhwc(boundary)], dim=-1).reshape(-1, 305)
    mu, var = moments(rows, (0,))
    norm, out = dec.last_conv[0], dec.last_conv[3]
    a = torch.rsqrt(var + EPS_BN) * norm.weight
    h = torch.relu(q(q(q(rows - q(mu)) * q(a)) + q(norm.bias)))
    words = philox_words(h.numel(), key, h.device).view(h.shape)
    h = torch.where(words < int(0.9 * 2.0**32), q(h * (1.0 / 0.9)),
                    torch.zeros((), device=h.device))
    w = out.weight.reshape(2, 305)
    x1 = q(h @ q(w).t() + out.bias).reshape(x_up.shape[0], *x_up.shape[2:], 2)
    mc = nhwc(upsample(nchw(x1), hw, q))
    return mc.reshape(t_samples, b, *mc.shape[1:])


# ---------------------------------------------------------------- the step

class Models(NamedTuple):
    gen: DeepLab
    dis: PatchGAN  # boundary
    dis2: PatchGAN  # entropy


def build(backbone: str, output_stride: int, device, quant=None) -> Models:
    models = Models(DeepLab(backbone, output_stride), PatchGAN(1), PatchGAN(2))
    for m in models:
        m.to(device)
        if torch.device(device).type == "cuda":
            m.to(memory_format=_CL)
        if quant is not None:
            for sub in m.modules():
                if isinstance(sub, (Module, Conv2d)):
                    sub.q = quant
    return models


def optimizers(models: Models, optim: dict):
    """Adam(b1, b2, eps 1e-8) for the generator, SGD(momentum, weight decay)
    for each discriminator."""
    adam = torch.optim.Adam(models.gen.parameters(), lr=optim["lr_gen"],
                            betas=(optim["adam_b1"], optim["adam_b2"]), eps=1e-8)
    sgd = [torch.optim.SGD(d.parameters(), lr=optim["lr_dis"], momentum=optim["sgd_momentum"],
                           weight_decay=optim["weight_decay"]) for d in (models.dis, models.dis2)]
    return adam, sgd[0], sgd[1]


def decode(batch: dict) -> dict:
    """uint8 wire -> float32: images u/127.5 - 1, maps as they are,
    boundaries u/255."""
    out = {}
    for k, v in batch.items():
        y = v.float()
        if k.startswith("image"):
            y = y / torch.tensor(127.5, device=y.device) - 1.0
        elif k.startswith("boundary"):
            y = y / torch.tensor(255.0, device=y.device)
        out[k] = y
    return out


def train_step(models: Models, opts, batch: dict, step: int, seed: int, generator,
               method: dict, lr_gen: float, lr_dis: float, proto_phase: bool, banks: dict,
               quant=None, apply_updates=True) -> dict:
    """One step; returns its losses (0-d tensors) and, under ``_viz``, the
    first image's probability maps (``pred_s``, ``pred_b_s``, ``pred_t``),
    target boundary logits (``bnd_t_raw``) and MC std map (``std_t``,
    prototype phase). ``banks`` holds the
    source and target banks ``src``/``trg`` ([4, 305], None before the first
    prototype step) and is updated in place. ``apply_updates`` False stops
    after the backward passes (the FLOP count on meta tensors)."""
    gen, dis, dis2 = models
    adam, sgd, sgd2 = opts
    batch = decode(batch)
    image_s, image_t = batch["image_s"], batch["image_t"]
    map_s, boundary_s = batch["map_s"], batch["boundary_s"]
    b = image_s.shape[0]
    q = ident if quant is None else quant
    x = q(nchw(torch.cat([image_s, image_t], dim=0)))
    hw = tuple(x.shape[2:])
    key = step_key(seed, step)
    fp, ll = gen.prefix(x, 2)
    out = gen.suffix(fp, ll, hw, 2, generator)
    mc = None
    if proto_phase:
        mc = mc_pass(gen, fp[b:].detach(), ll[b:].detach(), hw, method["mc_samples"], generator,
                     key, q)
    o_s, o_t = out.mask_logits[:b], out.mask_logits[b:]
    bd_s, bd_t = out.boundary_logits[:b], out.boundary_logits[b:]
    loss_seg = _BceProb.apply(o_s, map_s) + torch.mean(torch.square(torch.sigmoid(bd_s)
                                                                    - boundary_s))
    d_u = dis2(entropy(o_t))
    d_b = dis(torch.sigmoid(bd_t))
    loss_adv = method["adv_weight"] * (bce_logits(d_u, torch.ones_like(d_u))
                                       + bce_logits(d_b, torch.ones_like(d_b)))
    loss = loss_seg + loss_adv
    losses = {"loss_seg": loss_seg, "loss_adv": loss_adv}
    viz = {"pred_s": torch.sigmoid(o_s[0]), "pred_b_s": torch.sigmoid(bd_s[0]),
           "pred_t": torch.sigmoid(o_t[0]), "bnd_t_raw": bd_t[0]}
    if proto_phase:
        feat_s, feat_t = out.x_feature[:b], out.x_feature[b:]
        pred_s = nhwc(nearest(nchw(map_s), feat_s.shape[1:3]))
        src = prototypes(pred_s, feat_s)
        trg, std = rectified_prototypes(out.mask_before[b:], feat_t, mc,
                                        method["pseudo_threshold"], method["std_threshold"])
        viz["std_t"] = std[0]
        d = method["global_pro_weight"]
        if banks.get("src") is not None:
            src = [(1 - d) * bk + d * cu for bk, cu in zip(banks["src"], src)]
            trg = [(1 - d) * bk + d * cu for bk, cu in zip(banks["trg"], trg)]
        intra = sum(torch.mean(torch.square(s - t)) for s, t in zip(src, trg))
        loss = loss + method["pro_weight"] * intra
        losses["loss_intra"] = intra
        losses["loss_inter"] = torch.mean(torch.square(src[1] - src[3])) + \
            torch.mean(torch.square(src[0] - src[2]))
    for opt, lr in ((adam, lr_gen), (sgd, lr_dis), (sgd2, lr_dis)):
        if opt is not None:
            for group in opt.param_groups:
                group["lr"] = lr
            opt.zero_grad(set_to_none=True)
    loss.backward(inputs=list(gen.parameters()))
    if apply_updates:
        adam.step()
    losses["loss_all"] = loss
    games = (("loss_D", dis, sgd, torch.sigmoid(bd_s.detach()), torch.sigmoid(bd_t.detach())),
             ("loss_D2", dis2, sgd2, entropy(o_s.detach()), entropy(o_t.detach())))
    for name, net, opt, xs, xt in games:
        out_s, out_t = net(xs), net(xt)
        loss_d = bce_logits(out_s, torch.ones_like(out_s)) + \
            bce_logits(out_t, torch.zeros_like(out_t))
        loss_d.backward(inputs=list(net.parameters()))
        if apply_updates:
            opt.step()
        losses[name] = loss_d
    if proto_phase:
        banks["src"] = torch.stack(src).detach()
        banks["trg"] = torch.stack(trg).detach()
    losses["_viz"] = {k: v.detach() for k, v in viz.items()}
    return losses

