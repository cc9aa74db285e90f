"""Training state (uda_clr_tpu/train/state.py:26-150): the generator, the
discriminators the method plays against, their optimizers, the two EMA
prototype banks with their "seeded yet" flags, the mean teacher's shadow
model, the disk-bank method's prototype bank and frozen initial model,
``bcdm``'s second classifier with its three optimizers, and the step's
random sources.

Under data parallelism every rank builds the state from the same seed, then
takes rank 0's parameters, buffers, banks and optimizer state
(:func:`replicate_state`), which also checks that the ranks agree; the
dropout generator is seeded per rank (rank 0 with the seed itself) and a
second generator, seeded alike on every rank, draws for the global batch."""

from __future__ import annotations

import copy
from dataclasses import dataclass

import torch

from uda_clr_tpu_torch import resolve_device
from uda_clr_tpu_torch.config import Config
from uda_clr_tpu_torch.models.deeplab import DeepLab, Heads
from uda_clr_tpu_torch.models.gan import (
    BoundaryDiscriminator,
    PatchDiscriminator,
    UncertaintyDiscriminator,
)
from uda_clr_tpu_torch.parallel import distributed as dist_lib
from uda_clr_tpu_torch.parallel.reduce import broadcast_, replica_gap
from uda_clr_tpu_torch.train import optim as optim_lib

FEATURE_DIM = 305  # decoder x_feature channels
METHODS = ("baseline", "adversarial", "posal", "prototype", "prototype_full", "prototype_mt",
           "mean_teacher", "bcdm")
# the disk bank's vectors: x_bu_feature (304) and x_feature (305) channels
BANK_SIZES = {"bu": FEATURE_DIM - 1, "cup": FEATURE_DIM, "disc": FEATURE_DIM}


@dataclass
class TrainState:
    gen: DeepLab
    dis: PatchDiscriminator | None  # boundary discriminator
    dis2: PatchDiscriminator | None  # uncertainty (entropy) discriminator
    gen_opt: torch.optim.Adam | None  # None for bcdm, which steps bcdm_opt
    dis_opt: torch.optim.SGD | None
    dis2_opt: torch.optim.SGD | None
    proto_src: torch.Tensor  # [4, 305] (cup_obj, disc_obj, cup_bck, disc_bck)
    proto_trg: torch.Tensor
    proto_src_init: torch.Tensor  # bool scalar
    proto_trg_init: torch.Tensor
    generator: torch.Generator  # the mask draws of the 'xla16'/'xla' dropout backends
    seed: int  # base of the kernels' 64-bit Philox seeds
    step: int = 0
    # data parallelism: the draws made for the global batch (the mean
    # teacher's noise), seeded alike on every rank; None in one process,
    # where ``generator`` makes them
    noise_generator: torch.Generator | None = None
    teacher: DeepLab | None = None  # mean teacher: EMA of gen's params, gen's running stats
    # disk-bank method: {'bu': [304], 'cup': [305], 'disc': [305]}, from the
    # prototype-bank tool's .npz (or zeros), EMA-updated by the step
    proto_bank: dict | None = None
    # pseudo_from_initial: a frozen copy of the generator (after the initial
    # resume) whose eval-mode 'before' heads give the target pseudo-labels
    initial: DeepLab | None = None
    # bcdm: the second classifier (ASPP + decoder; the first is gen's heads)
    # and three Adam optimizers with their own step counts, 'fea' (gen's
    # backbone), 'cls1' (gen's heads) and 'cls2' (state.py:55-64,108-120)
    cls2: Heads | None = None
    bcdm_opt: dict | None = None


def discriminators_used(cfg: Config, method: str) -> tuple[bool, bool]:
    """(boundary D, entropy D) that ``method``'s step plays against
    (steps.py:538-545): none for the baseline or with ``use_adv`` off;
    ``posal`` forces the entropy D off. ``bcdm`` holds both, as the JAX
    package's state does, though its step never reads them."""
    mcfg = cfg.method
    if method not in METHODS:
        raise ValueError(f"method {method!r}; one of {METHODS}")
    if method == "baseline" or not mcfg.use_adv:
        return False, False
    return mcfg.use_boundary_d, mcfg.use_entropy_d and method != "posal"


def create_train_state(cfg: Config, seed: int = 0, device: str | torch.device = "cuda",
                       gen_state_dict=None, dis_state_dict=None,
                       dis2_state_dict=None, method: str = "prototype_full",
                       teacher_state_dict=None, initial_state_dict=None,
                       proto_bank=None, cls2_state_dict=None) -> TrainState:
    """Build the modules ``method`` needs from ``seed`` (or load the given
    state_dicts, e.g. from :mod:`uda_clr_tpu_torch.convert.from_jax`), with
    ``cfg.model.norm`` at every norm site, move them to ``device``
    (``channels_last`` on the card) and create the optimizers.
    ``mean_teacher`` gets a teacher that starts as a copy of the generator
    unless ``teacher_state_dict`` is given; ``prototype`` gets a disk bank
    (``proto_bank``, arrays or tensors keyed bu/cup/disc; zeros if None);
    ``cfg.method.pseudo_from_initial`` a frozen initial model, a copy of
    the generator unless ``initial_state_dict`` is given; ``bcdm`` a second
    classifier seeded apart (``cls2_state_dict``) and the three optimizers
    in place of ``gen_opt``. ``cfg.model`` picks the backbone, output
    stride and ``remat``."""
    device = resolve_device(device)
    use_bd, use_ed = discriminators_used(cfg, method)
    mc = cfg.model
    gen = DeepLab(mc.num_classes, mc.backbone, mc.output_stride, seed=seed, norm=mc.norm,
                  remat=mc.remat)
    dis = BoundaryDiscriminator(seed + 1) if use_bd else None
    dis2 = UncertaintyDiscriminator(seed + 2) if use_ed else None
    cls2 = Heads(mc.num_classes, mc.backbone, mc.output_stride, seed=seed + 3,
                 norm=mc.norm) if method == "bcdm" else None
    for module, sd in ((gen, gen_state_dict), (dis, dis_state_dict), (dis2, dis2_state_dict),
                       (cls2, cls2_state_dict)):
        if module is None:
            continue
        if sd is not None:
            module.load_state_dict(sd)
        module.to(device)
        if device.type == "cuda":
            module.to(memory_format=torch.channels_last)
    teacher = None
    if method == "mean_teacher":
        teacher = copy.deepcopy(gen)
        if teacher_state_dict is not None:
            teacher.load_state_dict(teacher_state_dict)
        teacher.requires_grad_(False)
    initial = None
    if cfg.method.pseudo_from_initial:
        initial = copy.deepcopy(gen)
        if initial_state_dict is not None:
            initial.load_state_dict(initial_state_dict)
        initial.requires_grad_(False)
    bank = None
    if method == "prototype":
        bank = {k: torch.zeros(n, dtype=torch.float32, device=device) if proto_bank is None
                else torch.as_tensor(proto_bank[k], dtype=torch.float32).to(device).clone()
                for k, n in BANK_SIZES.items()}
        for k, n in BANK_SIZES.items():
            if bank[k].shape != (n,):
                raise ValueError(f"prototype bank {k!r} has shape {tuple(bank[k].shape)}, "
                                 f"want ({n},)")
    bcdm_opt = None
    if cls2 is not None:
        heads1 = list(gen.aspp.parameters()) + list(gen.decoder.parameters())
        bcdm_opt = {name: optim_lib.make_gen_optimizer(params, cfg.optim) for name, params in (
            ("fea", gen.backbone.parameters()), ("cls1", heads1), ("cls2", cls2.parameters()))}
    zeros = torch.zeros((4, FEATURE_DIM), dtype=torch.float32, device=device)
    parallel = dist_lib.world_size() > 1
    state = TrainState(
        gen=gen, dis=dis, dis2=dis2,
        gen_opt=None if cls2 is not None else optim_lib.make_gen_optimizer(
            gen.parameters(), cfg.optim),
        dis_opt=optim_lib.make_dis_optimizer(dis.parameters(), cfg.optim) if dis else None,
        dis2_opt=optim_lib.make_dis_optimizer(dis2.parameters(), cfg.optim) if dis2 else None,
        proto_src=zeros.clone(), proto_trg=zeros.clone(),
        proto_src_init=torch.zeros((), dtype=torch.bool, device=device),
        proto_trg_init=torch.zeros((), dtype=torch.bool, device=device),
        generator=torch.Generator(device).manual_seed(dist_lib.rank_seed(seed)),
        noise_generator=torch.Generator(device).manual_seed(seed) if parallel else None,
        seed=seed,
        teacher=teacher,
        proto_bank=bank,
        initial=initial,
        cls2=cls2,
        bcdm_opt=bcdm_opt,
    )
    if parallel:
        replicate_state(state)
    return state


def optimizers(state: TrainState) -> list[torch.optim.Optimizer]:
    opts = [state.gen_opt, state.dis_opt, state.dis2_opt] + list((state.bcdm_opt or {}).values())
    return [o for o in opts if o is not None]


def replicated_tensors(state: TrainState) -> list[torch.Tensor]:
    """Every tensor the ranks hold alike: the modules' parameters and
    buffers, the banks and their flags, the optimizers' states."""
    out = []
    for module in (state.gen, state.dis, state.dis2, state.teacher, state.initial, state.cls2):
        if module is not None:
            out += list(module.state_dict().values())
    out += [state.proto_src, state.proto_trg, state.proto_src_init, state.proto_trg_init]
    out += [state.proto_bank[k] for k in sorted(state.proto_bank or {})]
    for opt in optimizers(state):
        for group in opt.param_groups:
            for p in group["params"]:
                out += [v for _, v in sorted(opt.state.get(p, {}).items())
                        if isinstance(v, torch.Tensor)]
    return out


def replicate_state(state: TrainState) -> None:
    """Overwrite every replicated tensor with rank 0's, then check that the
    ranks hold the same bits (raises if not). A no-op in one process."""
    tensors = replicated_tensors(state)
    device = state.proto_src.device
    broadcast_(tensors, device)
    gap = replica_gap(tensors, device)
    if gap != 0.0:
        raise RuntimeError(f"the ranks' states differ by {gap} after the broadcast from rank 0")
