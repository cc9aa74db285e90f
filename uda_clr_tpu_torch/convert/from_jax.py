"""Weight bridge: the JAX package's ``gen_params`` / ``gen_stats`` /
``dis_params`` (nested dicts of arrays) -> this port's state_dicts.

The inverse of ``convert_deeplab_state_dict`` /
``convert_discriminator_state_dict`` (uda_clr_tpu/convert/torch_import.py),
written here without importing them: conv kernels go HWIO -> OIHW (a
depthwise [k,k,1,C] kernel becomes [C,1,k,k] by the same transpose), BN
``scale``/``bias`` -> ``weight``/``bias``, batch stats ``mean``/``var`` ->
``running_mean``/``running_var`` (plain BN) or TransNorm's
``{mean,var}_{source,target}`` -> ``running_{mean,var}_{source,target}``.
All four backbones, under the reference's keys (torch_import.py:52-172:
mobilenet's ``features``, resnet's torchvision layout, xception's ``rep``
indices, drn's ``layer{L}``). :func:`train_state_dicts` carries a whole
JAX ``TrainState`` across: the generator, the discriminators it holds, the
mean teacher, the frozen initial model, the disk prototype bank and
``bcdm``'s second classifier.
"""

from __future__ import annotations

import numpy as np
import torch

from uda_clr_tpu_torch.models.mobilenet import mobilenet_block_plan
from uda_clr_tpu_torch.models.xception import xception_block_plan, xception_rep_indices


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _conv(sd: dict, key: str, node: dict) -> None:
    conv = node["conv"]
    sd[f"{key}.weight"] = _t(np.asarray(conv["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in conv:
        sd[f"{key}.bias"] = _t(conv["bias"])


def _bn(sd: dict, key: str, params: dict, stats: dict) -> None:
    sd[f"{key}.weight"] = _t(params["scale"])
    sd[f"{key}.bias"] = _t(params["bias"])
    if "mean" in stats:
        sd[f"{key}.running_mean"] = _t(stats["mean"])
        sd[f"{key}.running_var"] = _t(stats["var"])
    else:  # TransNorm
        for k in ("mean_source", "mean_target", "var_source", "var_target"):
            sd[f"{key}.running_{k}"] = _t(stats[k])


def _conv_bn(sd, conv_key, bn_key, p, s, conv_name, bn_name):
    _conv(sd, conv_key, p[conv_name])
    _bn(sd, bn_key, p[bn_name], s[bn_name])


def _mobilenet(sd, bb, bbs, output_stride):
    _conv_bn(sd, "backbone.features.0.0", "backbone.features.0.1", bb, bbs, "stem", "stem_bn")
    for idx, (_, _, _, _, t) in enumerate(mobilenet_block_plan(output_stride)):
        p, s = bb[f"block_{idx}"], bbs[f"block_{idx}"]
        names = ("depthwise", "project") if t == 1 else ("expand", "depthwise", "project")
        for i, name in enumerate(names):
            key = f"backbone.features.{idx + 1}.conv"
            _conv_bn(sd, f"{key}.{3 * i}", f"{key}.{3 * i + 1}", p, s, name, f"{name}_bn")


def _bottleneck(sd, key, p, s):
    for k in (1, 2, 3):
        _conv_bn(sd, f"{key}.conv{k}", f"{key}.bn{k}", p, s, f"conv{k}", f"bn{k}")
    if "down_conv" in p:
        _conv_bn(sd, f"{key}.downsample.0", f"{key}.downsample.1", p, s, "down_conv", "down_bn")


def _resnet(sd, bb, bbs, output_stride):
    _conv_bn(sd, "backbone.conv1", "backbone.bn1", bb, bbs, "conv1", "bn1")
    for layer, blocks in zip((1, 2, 3, 4), (3, 4, 23, 3)):
        for i in range(blocks):
            name = f"layer{layer}_{i}"
            _bottleneck(sd, f"backbone.layer{layer}.{i}", bb[name], bbs[name])


def _drn(sd, bb, bbs, output_stride):
    _conv_bn(sd, "backbone.layer0.0", "backbone.layer0.1", bb, bbs, "layer0_conv", "layer0_bn")
    for layer in (1, 2, 7, 8):
        _conv_bn(sd, f"backbone.layer{layer}.0", f"backbone.layer{layer}.1", bb, bbs,
                 f"layer{layer}_conv0", f"layer{layer}_bn0")
    for layer, blocks in zip((3, 4, 5, 6), (3, 4, 6, 3)):
        for i in range(blocks):
            name = f"layer{layer}_{i}"
            _bottleneck(sd, f"backbone.layer{layer}.{i}", bb[name], bbs[name])


def _sep_conv(sd, key, p, s):
    _conv(sd, f"{key}.conv1", p["depthwise"])
    _bn(sd, f"{key}.bn", p["bn"], s["bn"])
    _conv(sd, f"{key}.pointwise", p["pointwise"])


def _xception_block(sd, key, p, s, plan):
    """A block of ``plan`` = (in, out, reps, stride, dilation,
    start_with_relu, grow_first, is_last) at its ``rep`` indices."""
    for k, i in enumerate(xception_rep_indices(*plan)):
        _sep_conv(sd, f"{key}.rep.{i}", p[f"sep{k}"], s[f"sep{k}"])
        _bn(sd, f"{key}.rep.{i + 1}", p[f"sep{k}_bn"], s[f"sep{k}_bn"])
    if "skip" in p:
        _conv_bn(sd, f"{key}.skip", f"{key}.skipbn", p, s, "skip", "skip_bn")


def _xception(sd, bb, bbs, output_stride):
    for k in (1, 2):
        _conv_bn(sd, f"backbone.conv{k}", f"backbone.bn{k}", bb, bbs, f"conv{k}", f"bn{k}")
    for num, plan in xception_block_plan(output_stride).items():
        _xception_block(sd, f"backbone.block{num}", bb[f"block{num}"], bbs[f"block{num}"], plan)
    for k in (3, 4, 5):
        _sep_conv(sd, f"backbone.conv{k}", bb[f"conv{k}"], bbs[f"conv{k}"])
        _bn(sd, f"backbone.bn{k}", bb[f"bn{k}"], bbs[f"bn{k}"])


_CONVERTERS = {"mobilenet": _mobilenet, "resnet": _resnet, "xception": _xception, "drn": _drn}
# a module name that only that backbone's JAX params hold
_MARKERS = {"stem": "mobilenet", "layer1_0": "resnet", "block1": "xception",
            "layer0_conv": "drn"}


def _backbone_of(params: dict) -> str:
    """The backbone of JAX DeepLab ``params``, from its module names."""
    return next(name for key, name in _MARKERS.items() if key in params["backbone"])


def heads_state_dict(params: dict, stats: dict) -> dict:
    """The ASPP and decoder entries of JAX DeepLab variables (or of
    ``bcdm``'s ``cls2_params``/``cls2_stats``) -> ``aspp.*``/``decoder.*``."""
    sd: dict = {}
    ap, ast = params["aspp"], stats["aspp"]
    for k in range(1, 5):
        _conv(sd, f"aspp.aspp{k}.atrous_conv", ap[f"aspp{k}"]["atrous_conv"])
        _bn(sd, f"aspp.aspp{k}.bn", ap[f"aspp{k}"]["bn"], ast[f"aspp{k}"]["bn"])
    _conv_bn(sd, "aspp.global_avg_pool.1", "aspp.global_avg_pool.2", ap, ast, "gap_conv",
             "gap_bn")
    _conv_bn(sd, "aspp.conv1", "aspp.bn1", ap, ast, "proj_conv", "proj_bn")

    dp, ds = params["decoder"], stats["decoder"]
    _conv_bn(sd, "decoder.conv1", "decoder.bn1", dp, ds, "low_conv", "low_bn")
    _bn(sd, "decoder.last_conv.0", dp["mask_bn"], ds["mask_bn"])
    _conv(sd, "decoder.last_conv.3", dp["mask_out"])
    for i, name in ((0, "bound_conv1"), (4, "bound_conv2"), (8, "bound_out")):
        _conv(sd, f"decoder.last_conv_boundary.{i}", dp[name])
    for i, name in ((1, "bound_bn1"), (5, "bound_bn2")):
        _bn(sd, f"decoder.last_conv_boundary.{i}", dp[name], ds[name])
    return sd


def deeplab_state_dict(params: dict, stats: dict, output_stride: int = 16) -> dict:
    """JAX DeepLab variables (any backbone, ``norm='bn'`` or ``'tn'``) ->
    the port's ``DeepLab`` state_dict (reference key names); the backbone
    is read from the params' module names."""
    sd: dict = {}
    _CONVERTERS[_backbone_of(params)](sd, params["backbone"], stats["backbone"], output_stride)
    sd.update(heads_state_dict(params, stats))
    return sd


def discriminator_state_dict(params: dict) -> dict:
    """JAX PatchDiscriminator params -> ``conv1`` ... ``conv5`` weights."""
    sd: dict = {}
    for i in range(1, 6):
        _conv(sd, f"conv{i}", params[f"conv{i}"])
    return sd


def train_state_dicts(jstate, output_stride: int = 16) -> dict:
    """The keyword arguments of ``train.state.create_train_state`` from a
    JAX ``TrainState`` (read by attribute: ``gen_params``/``gen_stats``,
    ``dis_params``, ``dis2_params``, ``teacher_params``/``teacher_stats``,
    ``initial_params``/``initial_stats``, ``proto_bank``, ``cls2_params``/
    ``cls2_stats``); a field that is None or absent gives None.
    ``output_stride`` is the model's (DRN's is 8 whatever it says)."""
    get = lambda name: getattr(jstate, name, None)
    out = {"gen_state_dict": deeplab_state_dict(get("gen_params"), get("gen_stats"),
                                                output_stride)}
    for key, name in (("dis_state_dict", "dis_params"), ("dis2_state_dict", "dis2_params")):
        params = get(name)
        out[key] = None if params is None else discriminator_state_dict(params)
    for key, name in (("teacher_state_dict", "teacher"), ("initial_state_dict", "initial")):
        params = get(f"{name}_params")
        out[key] = None if params is None else deeplab_state_dict(
            params, get(f"{name}_stats"), output_stride)
    bank = get("proto_bank")
    out["proto_bank"] = None if bank is None else {k: _t(v) for k, v in bank.items()}
    cls2 = get("cls2_params")
    out["cls2_state_dict"] = None if cls2 is None else heads_state_dict(cls2, get("cls2_stats"))
    return out
