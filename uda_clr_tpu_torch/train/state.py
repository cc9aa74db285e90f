"""Training state (uda_clr_tpu/train/state.py:26-150): the generator and
both discriminators, their three optimizers, the two EMA prototype banks
with their "seeded yet" flags, and the step's random sources."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from uda_clr_tpu_torch import resolve_device
from uda_clr_tpu_torch.config import Config
from uda_clr_tpu_torch.models.deeplab import DeepLab
from uda_clr_tpu_torch.models.gan import (
    BoundaryDiscriminator,
    PatchDiscriminator,
    UncertaintyDiscriminator,
)
from uda_clr_tpu_torch.train import optim as optim_lib

FEATURE_DIM = 305  # decoder x_feature channels


@dataclass
class TrainState:
    gen: DeepLab
    dis: PatchDiscriminator  # boundary discriminator
    dis2: PatchDiscriminator  # uncertainty (entropy) discriminator
    gen_opt: torch.optim.Adam
    dis_opt: torch.optim.SGD
    dis2_opt: torch.optim.SGD
    proto_src: torch.Tensor  # [4, 305] (cup_obj, disc_obj, cup_bck, disc_bck)
    proto_trg: torch.Tensor
    proto_src_init: torch.Tensor  # bool scalar
    proto_trg_init: torch.Tensor
    generator: torch.Generator  # every dropout draw of the step
    seed: int  # base seed of the mask-head kernel's Philox stream
    step: int = 0


def create_train_state(cfg: Config, seed: int = 0, device: str | torch.device = "cuda",
                       gen_state_dict=None, dis_state_dict=None,
                       dis2_state_dict=None) -> TrainState:
    """Build the modules from ``seed`` (or load the given state_dicts, e.g.
    from :mod:`uda_clr_tpu_torch.convert.from_jax`), move them to ``device``
    (``channels_last`` on the card) and create the optimizers."""
    device = resolve_device(device)
    gen = DeepLab(cfg.model.num_classes, cfg.model.backbone, cfg.model.output_stride,
                  seed=seed)
    dis = BoundaryDiscriminator(seed + 1)
    dis2 = UncertaintyDiscriminator(seed + 2)
    for module, sd in ((gen, gen_state_dict), (dis, dis_state_dict), (dis2, dis2_state_dict)):
        if sd is not None:
            module.load_state_dict(sd)
        module.to(device)
        if device.type == "cuda":
            module.to(memory_format=torch.channels_last)
    zeros = torch.zeros((4, FEATURE_DIM), dtype=torch.float32, device=device)
    return TrainState(
        gen=gen, dis=dis, dis2=dis2,
        gen_opt=optim_lib.make_gen_optimizer(gen.parameters(), cfg.optim),
        dis_opt=optim_lib.make_dis_optimizer(dis.parameters(), cfg.optim),
        dis2_opt=optim_lib.make_dis_optimizer(dis2.parameters(), cfg.optim),
        proto_src=zeros.clone(), proto_trg=zeros.clone(),
        proto_src_init=torch.zeros((), dtype=torch.bool, device=device),
        proto_trg_init=torch.zeros((), dtype=torch.bool, device=device),
        generator=torch.Generator(device).manual_seed(seed),
        seed=seed,
    )
