"""CLI entry point with the flags of uda_clr_tpu/cli.py (the reference's
train_use_fix_initial.py:24-127 surface), driving the port's Trainer, plus
``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain versions).

Examples:
  # supervised baseline on synthetic data (no datasets needed), on the CPU
  python -m uda_clr_tpu_torch.cli --method baseline --synthetic --image-size 64 \\
      --batch-size 4 --max-epoch 2 --out runs/smoke --device cpu

  # the flagship method at full width on the card
  python -m uda_clr_tpu_torch.cli --synthetic --image-size 512 --batch-size 8 \\
      --bf16 --wire u8 --max-epoch 3 --out runs/flagship

  # data parallelism: one command per rank, each with a --config whose run
  # section sets dist_coordinator (host:port of rank 0), dist_num_processes,
  # its dist_process_id and, for several ranks on one card, dist_backend gloo
  python -m uda_clr_tpu_torch.cli --config rank0.yaml &
  python -m uda_clr_tpu_torch.cli --config rank1.yaml

  # the ('data', 'space') mesh: the same, with run.mesh_shape: [n_data,
  # n_space] and dist_num_processes n_data * n_space in every rank's YAML;
  # rank r takes data index r // n_space and stripe r % n_space of the rows

Across processes each rank prints, after training, one line
``rank summary: {json}`` with its epochs' stats, its kernel launches and
the parameters' largest difference from rank 0's (0.0).
"""

from __future__ import annotations

import argparse
import json

from uda_clr_tpu_torch.config import Config


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter, description=__doc__
    )
    p.add_argument("--config", default=None,
                   help="YAML Config file (e.g. configs/clr_drishti.yaml); "
                        "flags given alongside it are ignored except --data-dir/"
                        "--out/--resume/--initial-resume overrides")
    p.add_argument("--method", default="prototype_full",
                   choices=["baseline", "adversarial", "posal", "prototype",
                            "prototype_full", "prototype_mt", "mean_teacher", "bcdm"])
    p.add_argument("--datasetS", default="refuge")
    p.add_argument("--datasetT", default="Drishti-GS")
    p.add_argument("--data-dir", default="")
    p.add_argument("--synthetic", action="store_true",
                   help="use the built-in synthetic fundus dataset")
    p.add_argument("--image-size", type=int, default=512)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--max-epoch", type=int, default=500)
    p.add_argument("--stop-epoch", type=int, default=None)
    p.add_argument("--warmup-epoch", type=int, default=25)
    p.add_argument("--interval-validate", type=int, default=10)
    p.add_argument("--lr-gen", type=float, default=1e-3)
    p.add_argument("--lr-dis", type=float, default=2.5e-5)
    p.add_argument("--lr-decrease-rate", type=float, default=0.2)
    p.add_argument("--weight-decay", type=float, default=5e-4)
    p.add_argument("--momentum", type=float, default=0.99)
    p.add_argument("--out-stride", type=int, default=16)
    p.add_argument("--use_TN", action="store_true", help="TransNorm normalization")
    p.add_argument("--use_pid", action="store_true", default=True)
    p.add_argument("--no-pid", dest="use_pid", action="store_false")
    p.add_argument("--retrify_pesudo", action="store_true", default=True)
    p.add_argument("--no-retrify", dest="retrify_pesudo", action="store_false")
    p.add_argument("--pro_weight", type=float, default=0.1)
    p.add_argument("--global_pro_weight", type=float, default=0.9)
    p.add_argument("--bf16", action="store_true", help="bfloat16 compute (the card's fast path)")
    p.add_argument("--backbone", default="mobilenet",
                   choices=["mobilenet", "resnet", "xception", "drn"])
    p.add_argument("--out", default=None, help="run directory")
    p.add_argument("--resume", default=None)
    p.add_argument("--initial-resume", default=None,
                   help="warm-start checkpoint (BEAL bootstrap)")
    p.add_argument("--seed", type=int, default=1337)
    p.add_argument("--num-workers", type=int, default=2)
    p.add_argument("--loader-backend", default="thread",
                   choices=("thread", "process"),
                   help="loader worker model: threads (zero IPC) or forked "
                        "processes (the reference's DataLoader model; full "
                        "per-core scaling)")
    p.add_argument("--wire", default="u8", choices=("f32", "u8"),
                   help="host->device batch format: u8 (default) ships uint8 "
                        "and decodes on the device, bit-exact vs f32 with 4x "
                        "less transfer; f32 is the reference's contract")
    p.add_argument("--profile", action="store_true",
                   help="capture one torch.profiler window (steps 3-8 of the first "
                        "epoch) into <out>/profile")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on: the card by default; 'cpu' runs the "
                        "kernels' plain versions (tests)")
    return p


def _build(args) -> Config:
    if args.config:
        with open(args.config) as f:
            cfg = Config.from_yaml(f.read())
        if args.data_dir:
            cfg.data.data_dir = args.data_dir
        if args.out is not None:
            cfg.run.out_dir = args.out
        if args.resume is not None:
            cfg.run.resume = args.resume
        if args.initial_resume is not None:
            cfg.run.initial_resume = args.initial_resume
        return cfg

    cfg = Config()
    cfg.model.backbone = args.backbone
    cfg.model.output_stride = args.out_stride
    cfg.model.norm = "tn" if args.use_TN else "bn"
    cfg.model.compute_dtype = "bfloat16" if args.bf16 else "float32"
    cfg.data.data_dir = args.data_dir
    cfg.data.dataset_source = args.datasetS
    cfg.data.dataset_target = args.datasetT
    cfg.data.image_size = args.image_size
    cfg.data.batch_size = args.batch_size
    cfg.data.num_workers = args.num_workers
    cfg.data.loader_backend = args.loader_backend
    cfg.data.wire = args.wire
    cfg.data.synthetic = args.synthetic
    cfg.optim.lr_gen = args.lr_gen
    cfg.optim.lr_dis = args.lr_dis
    cfg.optim.lr_decrease_rate = args.lr_decrease_rate
    cfg.optim.weight_decay = args.weight_decay
    cfg.optim.sgd_momentum = args.momentum
    cfg.method.method = args.method
    cfg.method.warmup_epoch = args.warmup_epoch
    cfg.method.use_pid = args.use_pid
    cfg.method.retrify_pseudo = args.retrify_pesudo
    cfg.method.pro_weight = args.pro_weight
    cfg.method.global_pro_weight = args.global_pro_weight
    cfg.run.max_epoch = args.max_epoch
    cfg.run.stop_epoch = args.stop_epoch
    cfg.run.interval_validate = args.interval_validate
    cfg.run.seed = args.seed
    cfg.run.profile = args.profile
    cfg.run.resume = args.resume
    cfg.run.initial_resume = args.initial_resume
    if args.out is not None:
        cfg.run.out_dir = args.out
    else:
        cfg.run.out_dir = (
            f"runs/{args.datasetT}/{args.method}/"
            f"pid_{args.use_pid}_TN_{args.use_TN}_retrify_{args.retrify_pesudo}"
            f"_gpw_{args.global_pro_weight}_pw{args.pro_weight}"
        )
    return cfg


def build_config(argv=None) -> Config:
    return _build(_parser().parse_args(argv))


def main(argv=None):
    """Build the config, train, and return the Trainer (its
    ``epoch_stats`` hold each epoch's time, throughput and loader wait)."""
    args = _parser().parse_args(argv)
    from uda_clr_tpu_torch.ops import domain_norm, dropout, mask_head
    from uda_clr_tpu_torch.parallel import distributed as dist_lib
    from uda_clr_tpu_torch.train.trainer import Trainer

    try:
        trainer = Trainer(_build(args), device=args.device)
        trainer.train()
        if trainer.world > 1:
            print("rank summary: " + json.dumps({
                "rank": trainer.rank, "world": trainer.world, "epochs": trainer.epoch_stats,
                "replica_gap": trainer.replica_gap,
                "launches": {"k1": mask_head.LAUNCHES, "k3_fwd": dropout.LAUNCHES_FWD,
                             "k3_bwd": dropout.LAUNCHES_BWD,
                             "k4_moments": domain_norm.LAUNCHES_MOMENTS,
                             "k4_fwd": domain_norm.LAUNCHES_FWD,
                             "k4_reduce": domain_norm.LAUNCHES_REDUCE,
                             "k4_dx": domain_norm.LAUNCHES_BWD}}), flush=True)
    finally:
        dist_lib.shutdown()
    return trainer


if __name__ == "__main__":
    main()
