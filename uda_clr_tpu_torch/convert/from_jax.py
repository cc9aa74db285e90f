"""Weight bridge: the JAX package's ``gen_params`` / ``gen_stats`` /
``dis_params`` (nested dicts of arrays) -> this port's state_dicts.

The inverse of ``convert_deeplab_state_dict`` /
``convert_discriminator_state_dict`` (uda_clr_tpu/convert/torch_import.py),
written here without importing them: conv kernels go HWIO -> OIHW (a
depthwise [k,k,1,C] kernel becomes [C,1,k,k] by the same transpose), BN
``scale``/``bias`` -> ``weight``/``bias``, batch stats ``mean``/``var`` ->
``running_mean``/``running_var`` (plain BN) or TransNorm's
``{mean,var}_{source,target}`` -> ``running_{mean,var}_{source,target}``.
MobileNet backbone only. :func:`train_state_dicts` carries a whole JAX
``TrainState`` across: the generator, the discriminators it holds, the mean
teacher, the frozen initial model and the disk prototype bank.
"""

from __future__ import annotations

import numpy as np
import torch

from uda_clr_tpu_torch.models.mobilenet import mobilenet_block_plan


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


def deeplab_state_dict(params: dict, stats: dict, output_stride: int = 16) -> dict:
    """JAX DeepLab(backbone='mobilenet', norm='bn' or 'tn') variables -> the
    port's ``DeepLab`` state_dict (reference key names)."""
    sd: dict = {}
    bb, bbs = params["backbone"], stats["backbone"]
    _conv(sd, "backbone.features.0.0", bb["stem"])
    _bn(sd, "backbone.features.0.1", bb["stem_bn"], bbs["stem_bn"])
    for idx, (_, _, _, _, t) in enumerate(mobilenet_block_plan(output_stride)):
        p, s = bb[f"block_{idx}"], bbs[f"block_{idx}"]
        names = ("depthwise", "project") if t == 1 else ("expand", "depthwise", "project")
        for i, name in enumerate(names):
            key = f"backbone.features.{idx + 1}.conv.{3 * i}"
            _conv(sd, key, p[name])
            _bn(sd, f"backbone.features.{idx + 1}.conv.{3 * i + 1}", p[f"{name}_bn"], s[f"{name}_bn"])

    ap, ast = params["aspp"], stats["aspp"]
    for k in range(1, 5):
        _conv(sd, f"aspp.aspp{k}.atrous_conv", ap[f"aspp{k}"]["atrous_conv"])
        _bn(sd, f"aspp.aspp{k}.bn", ap[f"aspp{k}"]["bn"], ast[f"aspp{k}"]["bn"])
    _conv(sd, "aspp.global_avg_pool.1", ap["gap_conv"])
    _bn(sd, "aspp.global_avg_pool.2", ap["gap_bn"], ast["gap_bn"])
    _conv(sd, "aspp.conv1", ap["proj_conv"])
    _bn(sd, "aspp.bn1", ap["proj_bn"], ast["proj_bn"])

    dp, ds = params["decoder"], stats["decoder"]
    _conv(sd, "decoder.conv1", dp["low_conv"])
    _bn(sd, "decoder.bn1", dp["low_bn"], ds["low_bn"])
    _bn(sd, "decoder.last_conv.0", dp["mask_bn"], ds["mask_bn"])
    _conv(sd, "decoder.last_conv.3", dp["mask_out"])
    for i, name in ((0, "bound_conv1"), (4, "bound_conv2"), (8, "bound_out")):
        _conv(sd, f"decoder.last_conv_boundary.{i}", dp[name])
    for i, name in ((1, "bound_bn1"), (5, "bound_bn2")):
        _bn(sd, f"decoder.last_conv_boundary.{i}", dp[name], ds[name])
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
    ``initial_params``/``initial_stats``, ``proto_bank``); a field that is
    None or absent gives None."""
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
    return out
