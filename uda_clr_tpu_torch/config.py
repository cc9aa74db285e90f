"""Single dataclass config surface (own copy of uda_clr_tpu/config.py:18-176:
the five dataclasses with every field and default, ``to_dict``,
``from_dict`` and the YAML form the trainer writes into its run directory).

The YAML goes through :mod:`uda_clr_tpu_torch.utils.miniyaml`, which reads
and writes the subset the repo's config files use, as PyYAML's ``safe_load``
and ``safe_dump`` do; the port needs no PyYAML. ``ModelConfig.dtype`` is the
port's torch compute dtype (a property, not a field).

``RunConfig.dist_backend`` is the port's own field; ``to_dict`` (and so the
YAML) leaves it out while it is None, so a run directory's ``config.yaml``
stays readable by the JAX package's ``Config``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import torch

from uda_clr_tpu_torch.utils import miniyaml


@dataclass
class ModelConfig:
    num_classes: int = 2
    backbone: str = "mobilenet"  # mobilenet | resnet | xception | drn
    output_stride: int = 16  # 16 | 8 (drn: always 8)
    norm: str = "bn"  # 'bn' | 'tn' (TransNorm, --use_TN)
    compute_dtype: str = "float32"  # 'bfloat16' for the card
    remat: bool = False  # rematerialized backbone blocks (torch.utils.checkpoint)

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32


@dataclass
class DataConfig:
    data_dir: str = ""  # {data_dir}/{dataset}/{split}/ROIs/image
    dataset_source: str = "refuge"
    dataset_target: str = "Drishti-GS"  # refuge | Drishti-GS | RIM-ONE_r3
    image_size: int = 512
    batch_size: int = 8
    num_workers: int = 2
    loader_backend: str = "thread"  # "thread" | "process" (data/pipeline.py)
    wire: str = "u8"  # "u8" (uint8 batches, decoded on the device) | "f32" (data/wire.py)
    synthetic: bool = False  # tests/benchmarks without the real datasets
    synthetic_size: int = 16


@dataclass
class OptimConfig:
    lr_gen: float = 1e-3
    adam_b1: float = 0.9
    adam_b2: float = 0.99
    lr_dis: float = 2.5e-5
    sgd_momentum: float = 0.99
    weight_decay: float = 5e-4
    lr_decrease_rate: float = 0.2  # lr_gen multiplier from epoch lr_step_epochs on
    lr_step_epochs: int = 100


@dataclass
class MethodConfig:
    """Algorithm switches mirroring the reference trainers' surface."""

    method: str = "prototype_full"  # baseline | adversarial | posal | prototype | prototype_full | prototype_mt | mean_teacher | bcdm
    warmup_epoch: int = 25
    adv_weight: float = 0.01
    # ablation switches (train/steps.py:make_train_step)
    use_adv: bool = True  # False: no discriminator game (Trainer_MT_wo_ad)
    use_boundary_d: bool = True  # boundary PatchGAN
    use_entropy_d: bool = True  # entropy PatchGAN; method='posal' forces False
    use_boundary_loss: bool = True  # False: no MSE boundary term (Trainer_baseline_wob)
    bank_use_bu: bool = True  # disk-bank method: the bu prototype-distance term
    # prototype stack (prototype_full, prototype_mt)
    use_pid: bool = True
    use_global: bool = True
    retrify_pseudo: bool = True
    pro_weight: float = 0.1
    global_pro_weight: float = 0.9
    mc_samples: int = 8  # T
    mc_fast: bool = True
    std_threshold: float = 0.04
    pseudo_threshold: float = 0.75
    rng_impl: str = "unsafe_rbg"  # the JAX package's dropout-bit PRNG (unused by the port)
    mask_head_impl: str = "auto"  # MC mask head: auto | pallas (K1) | xla (its plain version)
    # disk-bank variant (method='prototype')
    bank_ema: float = 0.001
    bank_loss_weight: float = 0.05
    prototype_bank_path: str = ""
    # intra-domain category regularization (prototype_mt)
    use_trg_cons: bool = True
    aug_weight: float = 0.1
    aug_backward: bool = False  # True: add aug_weight * loss_aug to the G loss
    use_weight_rectify: bool = False
    pseudo_from_initial: bool = False
    src_reg: bool = True
    src_reg_weight: float = 0.01
    # mean teacher
    ema_decay: float = 0.99
    consistency: float = 1.0
    consistency_rampup: float = 40.0
    teacher_noise: float = 0.1  # sigma of the gaussian noise on the teacher's input


@dataclass
class RunConfig:
    out_dir: str = "runs/default"
    max_epoch: int = 500
    stop_epoch: Optional[int] = None
    interval_validate: int = 10
    checkpoint_every: int = 50
    seed: int = 1337
    resume: Optional[str] = None
    initial_resume: Optional[str] = None  # BEAL warm-start checkpoint
    # None, (1,), (dist_num_processes,) or (n_data, n_space) with n_data * n_space
    # = dist_num_processes: the ('data', 'space') mesh (parallel/spatial.py)
    mesh_shape: Optional[tuple] = None
    # data parallelism across processes (parallel/distributed.py), one per
    # device: dist_coordinator "host:port" of rank 0 (or a file:// URL)
    # enables it; each process loads 1/dist_num_processes of every global
    # batch
    dist_coordinator: Optional[str] = None
    dist_num_processes: int = 1
    dist_process_id: int = 0
    # the port's own: None = nccl on CUDA, gloo on the CPU; 'gloo' for
    # several ranks on one card (nccl refuses them)
    dist_backend: Optional[str] = None
    profile: bool = False
    save_val_images: bool = False  # joint [img|gt|cup|disc] strips per validation
    viz_every: int = 30  # train-time image grids every N iterations (0 = off)


# (section, field) of the port's own fields, written only when set
_PORT_ONLY = (("run", "dist_backend"),)


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    method: MethodConfig = field(default_factory=MethodConfig)
    run: RunConfig = field(default_factory=RunConfig)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        for section, key in _PORT_ONLY:
            if d[section][key] is None:
                del d[section][key]
        return d

    def to_yaml(self) -> str:
        return miniyaml.dump(self.to_dict())

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        def build(tp, sub):
            fields = {f.name for f in dataclasses.fields(tp)}
            kwargs = {}
            for k, v in (sub or {}).items():
                if k not in fields:
                    raise KeyError(f"unknown config key {tp.__name__}.{k}")
                kwargs[k] = tuple(v) if k == "mesh_shape" and v is not None else v
            return tp(**kwargs)

        return cls(
            model=build(ModelConfig, d.get("model")),
            data=build(DataConfig, d.get("data")),
            optim=build(OptimConfig, d.get("optim")),
            method=build(MethodConfig, d.get("method")),
            run=build(RunConfig, d.get("run")),
        )

    @classmethod
    def from_yaml(cls, text: str) -> "Config":
        return cls.from_dict(miniyaml.load(text) or {})
