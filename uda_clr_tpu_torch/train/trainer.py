"""Training orchestration (uda_clr_tpu/train/trainer.py:48-563): the loop
around the port's train step, with its data, validation, logging,
checkpoints and resume.

Per iteration the host pulls a source and a target batch from the
prefetching loaders, moves them to the device (uint8 wire batches decode
inside the step) and calls the step; the step's metrics stay 0-d device
tensors until one host fetch per epoch, after which the NaN guard runs and
the CSV and scalar rows are written. The host time blocked on the loaders
is measured per epoch (``epoch_stats``), the evidence of whether the host
feed sets the pace. ``run.profile`` traces one window of steps into
``profile/trace.json``, the step's spans (utils/tracing.py) into
``profile/spans.json``, and that epoch's stats gain ``host_ms``, the
spans' host milliseconds per step by name.

The disk-bank method (``prototype``) reads its bank from
``prototype_bank_path`` (the prototype-bank tool's ``.npz``, zeros without
one); with ``pseudo_from_initial`` the generator is frozen as the initial
model right after ``initial_resume``. Under TransNorm, validation's eval
forward normalizes with the target running stats. ``bcdm`` validates its
generator, the backbone with the first classifier (trainer.py:155).

Images: every ``viz_every`` iterations the step's first-image tiles and
the host batch become the reference's tensorboard image grids (PNGs under
``tensorboard/images/`` without tensorboard), written after the epoch's
scalars, off the step's path; with ``save_val_images`` validation writes
the first 8 batches' strips to ``visualization/epoch_N.png``.

Data parallelism across processes (``run.dist_coordinator``,
``dist_num_processes``, ``dist_process_id``, ``dist_backend``; JAX
trainer.py:54-87,122-137,169-170,268-307,473-483): one process per device,
each on its rows of every global batch (the train loaders are sharded, the
validation loader is not: validation runs replicated on every rank, and
rank 0's metrics decide the checkpoints). Rank 0 alone writes
``config.yaml``, the CSV, the scalars, the images and the checkpoints; the
other ranks get no-op sinks. ``viz_every`` is forced to 0 across processes,
as in JAX. ``epoch_stats`` hold the global img/s and this rank's loader
wait, and after training the ranks check that they hold the same
parameters bit for bit.

The ``('data', 'space')`` mesh (``run.mesh_shape: [n_data, n_space]`` with
``dist_num_processes = n_data * n_space``; parallel/spatial.py): the train
loaders take the data index over ``n_data`` and keep this rank's stripe of
rows, the train step reads across stripes, and validation stays
replicated on whole images (the step alone enters the spatial region).

An orbax checkpoint directory as ``initial_resume`` raises naming
``convert_orbax_checkpoint.py``, which turns it into a ``.pth.tar``.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from uda_clr_tpu_torch import resolve_device
from uda_clr_tpu_torch.config import Config
from uda_clr_tpu_torch.data import wire
from uda_clr_tpu_torch.data.fundus import FundusSegmentation
from uda_clr_tpu_torch.data.pipeline import BatchLoader
from uda_clr_tpu_torch.data.synthetic import SyntheticFundus
from uda_clr_tpu_torch.data.transforms import eval_transforms, train_transforms
from uda_clr_tpu_torch.models.deeplab import effective_output_stride
from uda_clr_tpu_torch.parallel import distributed as dist_lib
from uda_clr_tpu_torch.parallel import spatial
from uda_clr_tpu_torch.parallel.mesh import check_mesh, check_stripes
from uda_clr_tpu_torch.parallel.reduce import broadcast_, replica_gap
from uda_clr_tpu_torch.train import checkpoint as ckpt_lib
from uda_clr_tpu_torch.train import optim as optim_lib
from uda_clr_tpu_torch.train.state import BANK_SIZES, create_train_state, replicate_state
from uda_clr_tpu_torch.train.steps import make_eval_step, make_train_step
from uda_clr_tpu_torch.utils import tracing
from uda_clr_tpu_torch.utils.logging import CsvLogger, ScalarWriter, StepTimer
from uda_clr_tpu_torch.utils.metrics import dice_coeff_2label, pixel_acc
from uda_clr_tpu_torch.utils.ramps import get_current_consistency_weight
from uda_clr_tpu_torch.utils.visualize import joint_val_image, save_val_img

_ADVERSARIAL_METHODS = {"adversarial", "posal", "prototype", "prototype_full", "prototype_mt",
                        "mean_teacher", "bcdm"}


def _not_ported(cfg: Config) -> None:
    """Raise, before any process group forms, for a mesh that is not the
    configured group of processes, and an orbax ``initial_resume``."""
    run = cfg.run
    check_mesh(run.mesh_shape, run.dist_num_processes if run.dist_coordinator else 1)
    if run.initial_resume and not run.initial_resume.endswith((".pth", ".pth.tar")):
        raise NotImplementedError(ckpt_lib.ORBAX_NOTE.format(what="initial_resume"))


class _NoopSink:
    """Write-nothing stand-in for CsvLogger/ScalarWriter on the ranks other
    than 0 (one writer per run)."""

    def __getattr__(self, name):
        return lambda *a, **k: None


class Trainer:
    def __init__(self, cfg: Config, device: str | torch.device = "cuda"):
        """Datasets from cfg.data (synthetic, or the fundus directories);
        ``device``: the card unless the caller asks for the CPU (each rank
        takes its own card, :func:`dist_lib.rank_device`); raises if CUDA is
        asked for and absent. With ``run.dist_coordinator`` set this joins
        the process group first."""
        _not_ported(cfg)
        self.cfg = cfg
        self.method = cfg.method.method
        device = resolve_device(device)
        dist_lib.maybe_initialize(cfg.run, device)
        self.world, self.rank = dist_lib.world_size(), dist_lib.rank()
        self._main = self.rank == 0
        self.device = dist_lib.rank_device(device)
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        self.mesh = spatial.init_mesh(cfg.run.mesh_shape)
        (d_index, self.n_data), (s_index, n_space) = spatial.data_coords(), spatial.space_coords()
        if self.mesh is not None:
            check_stripes(cfg.data.image_size, n_space,
                          effective_output_stride(cfg.model.backbone, cfg.model.output_stride))
        os.makedirs(cfg.run.out_dir, exist_ok=True)
        if self._main:
            with open(os.path.join(cfg.run.out_dir, "config.yaml"), "w") as f:
                f.write(cfg.to_yaml())
        if self.world > 1 and cfg.run.viz_every:
            # as the JAX Trainer (trainer.py:84-87): the tiles are one rank's
            print(f"viz_every {cfg.run.viz_every} -> 0: no train-time image grids across "
                  f"{self.world} processes")
            cfg.run.viz_every = 0

        size = cfg.data.image_size
        wire_fmt = cfg.data.wire
        if cfg.data.synthetic:
            n = cfg.data.synthetic_size
            self.ds_s = SyntheticFundus(n, size + 28, seed=1,
                                        transform=train_transforms(size, wire=wire_fmt))
            self.ds_t = SyntheticFundus(n, size + 28, seed=2,
                                        transform=train_transforms(size, wire=wire_fmt))
            self.ds_val = SyntheticFundus(max(n // 2, 2), size + 28, seed=3,
                                          transform=eval_transforms(size, wire=wire_fmt))
        else:
            self.ds_s = FundusSegmentation(cfg.data.data_dir, cfg.data.dataset_source, "train",
                                           train_transforms(size, wire=wire_fmt))
            self.ds_t = FundusSegmentation(cfg.data.data_dir, cfg.data.dataset_target, "train",
                                           train_transforms(size, wire=wire_fmt))
            self.ds_val = FundusSegmentation(cfg.data.data_dir, cfg.data.dataset_target, "test",
                                             eval_transforms(size, wire=wire_fmt))

        bs, nw, lb = cfg.data.batch_size, cfg.data.num_workers, cfg.data.loader_backend
        # each rank loads its rows (and stripe) of every global batch;
        # validation is unsharded (it runs replicated)
        shard = dict(process_index=d_index, process_count=self.n_data, space_index=s_index,
                     space_count=n_space)
        self.loader_s = BatchLoader(self.ds_s, bs, shuffle=True, seed=cfg.run.seed,
                                    num_workers=nw, backend=lb, **shard)
        self.loader_t = BatchLoader(self.ds_t, bs, shuffle=False, seed=cfg.run.seed + 1,
                                    num_workers=nw, backend=lb, **shard)
        self.loader_val = BatchLoader(self.ds_val, bs, shuffle=False, drop_last=False,
                                      num_workers=nw, backend=lb)

        bank = None
        if self.method == "prototype" and cfg.method.prototype_bank_path:
            with np.load(cfg.method.prototype_bank_path) as f:  # trainer.py:157-161
                bank = {k: f[k] for k in BANK_SIZES}
        self.state = create_train_state(cfg, seed=cfg.run.seed, device=self.device,
                                        method=self.method, proto_bank=bank)
        self._steps = {}  # proto_phase -> step
        self._eval_step = make_eval_step(self.state.gen, cfg.model.dtype)

        self.csv = CsvLogger(cfg.run.out_dir) if self._main else _NoopSink()
        self.writer = ScalarWriter(cfg.run.out_dir) if self._main else _NoopSink()
        self.timer = StepTimer()
        self.epoch = 0
        self.iteration = -1  # last completed global step; -1 = none yet
        self._profiled = False  # run.profile captures one window per run
        self.best_mean_dice = 0.0
        self.best_epoch = -1
        # per trained epoch: wall time, img/s, loader wait, peak device memory
        self.epoch_stats: list[dict] = []
        self.replica_gap = None  # across processes: set by train()

        if cfg.run.initial_resume:
            self._initial_resume(cfg.run.initial_resume)
            if self.state.initial is not None:
                # the generator after the initial resume becomes the frozen
                # pseudo-label model (trainer.py:181-191)
                self.state.initial.load_state_dict(self.state.gen.state_dict())
        if cfg.run.resume:
            self._resume(cfg.run.resume)
        if self.world > 1 and (cfg.run.initial_resume or cfg.run.resume):
            replicate_state(self.state)  # every rank loaded the same file

        # The target stream's position equals the number of completed steps
        # (one target batch per step), so starting it at the restored
        # iteration+1 makes resume exact: the same batches and per-sample
        # augmentation seeds as an uninterrupted run (trainer.py:195-204).
        self._target_iter = self.loader_t.forever(start_batch=self.iteration + 1)

    # ------------------------------------------------------------------
    def _initial_resume(self, path: str):
        """Warm-start the generator and the discriminators the method has
        from a reference-layout ``.pth``/``.pth.tar`` (BEAL bootstrap,
        train_use_fix_initial.py:183-199): every tensor whose key and shape
        match is copied, the rest keep their values (``merge_pretrained``)."""
        ckpt = ckpt_lib.load_file(path)
        st = self.state
        for key, module in (("model_state_dict", st.gen), ("model_dis_state_dict", st.dis),
                            ("model_dis2_state_dict", st.dis2)):
            if module is None or key not in ckpt:
                continue
            src = ckpt[key]
            n = {"param": 0, "stat": 0}
            with torch.no_grad():
                for kind, named in (("param", module.named_parameters()),
                                    ("stat", module.named_buffers())):
                    for name, t in named:
                        if name in src and tuple(src[name].shape) == tuple(t.shape):
                            t.copy_(src[name])
                            n[kind] += 1
            if key == "model_state_dict":
                print(f"initial_resume: merged {n['param']} param / {n['stat']} stat "
                      f"tensors from {path}")

    def _resume(self, tag_or_dir: str):
        if os.path.isdir(tag_or_dir) and ckpt_lib.latest_checkpoint(tag_or_dir) is not None:
            ckpt_dir = tag_or_dir
            tag = ckpt_lib.latest_checkpoint(ckpt_dir)
        else:
            ckpt_dir = os.path.join(self.cfg.run.out_dir, "checkpoints")
            tag = tag_or_dir
        _, meta = ckpt_lib.restore_checkpoint(ckpt_dir, tag, self.state)
        self.epoch = int(meta.get("epoch", -1)) + 1
        self.best_mean_dice = float(meta.get("best_mean_dice", 0.0))
        # the counter carries on from the checkpoint (train_epoch increments it)
        self.iteration = int(meta.get("iteration", self.epoch * len(self.loader_s) - 1))

    def _get_step(self, proto_phase: bool):
        if proto_phase not in self._steps:
            self._steps[proto_phase] = make_train_step(self.cfg, self.method,
                                                       proto_phase=proto_phase)
        return self._steps[proto_phase]

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return dist_lib.put_global(arr, self.device)

    def _device_batch(self, batch_s: dict, batch_t: dict | None) -> dict:
        out = {
            "image_s": self._to_device(batch_s["image"]),
            "map_s": self._to_device(batch_s["map"]),
            "boundary_s": self._to_device(batch_s["boundary"]),
        }
        if batch_t is not None:
            out["image_t"] = self._to_device(batch_t["image"])
        if self.method == "mean_teacher":
            out["consistency_weight"] = float(np.float32(get_current_consistency_weight(
                self.epoch, self.cfg.method.consistency, self.cfg.method.consistency_rampup)))
        return out

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    def train_epoch(self):
        cfg = self.cfg
        past_warmup = self.epoch > cfg.method.warmup_epoch
        proto_phase = (self.method in ("prototype_full", "prototype_mt")
                       and cfg.method.use_pid and past_warmup) or (
            self.method == "prototype" and past_warmup)
        step = self._get_step(proto_phase)
        lr_gen = optim_lib.gen_lr_schedule(
            self.epoch, cfg.optim.lr_gen, cfg.optim.lr_step_epochs, cfg.optim.lr_decrease_rate)
        lr_dis = cfg.optim.lr_dis
        needs_target = self.method in _ADVERSARIAL_METHODS

        # run.profile: one torch.profiler window (steps 3..8 of the first
        # trained epoch, clamped for shorter epochs) into out_dir/profile,
        # rank 0's
        if cfg.run.profile and not self._profiled and self._main:
            n_steps = len(self.loader_s)
            prof_start = 3 if n_steps > 3 else 0
            prof_stop = min(8, n_steps - 1)
        else:
            prof_start, prof_stop = -1, -1
        prof = host_ms = None

        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        self.timer.start()
        pending = []
        viz_pending = []
        viz_every = cfg.run.viz_every
        wait = 0.0
        source = self.loader_s.epoch(self.epoch)
        batch_idx = 0
        while True:
            t0 = time.perf_counter()
            batch_s = next(source, None)
            if batch_s is None:
                break
            batch_t = next(self._target_iter) if needs_target else None
            wait += time.perf_counter() - t0
            self.iteration += 1
            batch = self._device_batch(batch_s, batch_t)
            if batch_idx == prof_start:
                self._sync()  # the window starts with no queued step
                prof = self._start_profile()
            self.state, metrics = step(self.state, batch, lr_gen, lr_dis, self.epoch)
            if batch_idx == prof_stop:
                host_ms = self._stop_profile(prof)
                prof = None
            viz = metrics.pop("_viz", None)
            if viz is not None and viz_every and self.iteration % viz_every == 0:
                # the device tiles and the host batch; written after the epoch
                viz_pending.append((self.iteration, batch_s, batch_t, viz))
            pending.append((self.iteration, metrics))
            self.timer.add_images(batch_s["image"].shape[0] * self.n_data)  # the global batch
            batch_idx += 1
        if prof is not None:  # epoch shorter than the window
            host_ms = self._stop_profile(prof)

        # one host fetch per epoch for all scalars
        rows = []
        sums: dict[str, float] = {}
        if pending:
            keys = list(pending[0][1])
            fetched = torch.stack([torch.stack([m[k].float() for k in keys])
                                   for _, m in pending]).cpu().tolist()
        else:
            keys, fetched = [], []
        for (iteration, _), values in zip(pending, fetched):
            m = dict(zip(keys, values))
            if not np.isfinite(m.get("loss_all", 0.0)):
                bad = sorted(k for k, v in m.items() if not np.isfinite(v))
                raise ValueError(
                    f"loss is nan while training (non-finite: {bad}; "
                    f"iteration {iteration}; metrics: {m})"
                )
            for k, v in m.items():
                sums[k] = sums.get(k, 0.0) + v
                self.writer.add_scalar(f"train/{k}", v, iteration)
            rows.append({"epoch": self.epoch, "iteration": iteration, **m})
        self.csv.write_train_rows(rows)
        for iteration, b_s, b_t, viz in viz_pending:
            self._write_train_images(iteration, b_s, b_t,
                                     {k: v.float().cpu().numpy() for k, v in viz.items()})

        dt, ips = self.timer.stop()
        n = max(len(rows), 1)
        means = {k: v / n for k, v in sums.items()}
        peak = (torch.cuda.max_memory_allocated(self.device) / 2**30
                if self.device.type == "cuda" else None)
        self.epoch_stats.append({"epoch": self.epoch, "proto_phase": proto_phase,
                                 "steps": len(rows), "seconds": dt, "img_per_s": ips,
                                 "loader_wait_s": wait, "peak_gib": peak})
        if host_ms is not None:
            self.epoch_stats[-1]["host_ms"] = host_ms
        self.writer.add_scalar("lr_gen", lr_gen, self.epoch * len(self.loader_s))
        print(
            f"[Epoch: {self.epoch}] lr:{lr_gen:.6f} "
            + " ".join(f"{k}:{v:.4f}" for k, v in sorted(means.items()))
            + f"  {ips:.2f} img/s  time:{dt:.1f}s  loader wait:{1e3 * wait / n:.1f} ms/step"
        )
        return means

    def _write_train_images(self, iteration, batch_s, batch_t, viz):
        """The reference's every-30-iterations tensorboard image grids
        (Trainer_prototype_full.py:307-325,519-575; JAX trainer.py:420-453):
        the batch's first image, per channel, min-max normalized, under the
        reference's tags. Image and target tiles come from the host batch
        (uint8 wire batches decoded), the prediction, std and confidence
        tiles from the step's ``_viz``."""
        w = self.writer
        img_s = wire.decode_array("image", batch_s["image"][0])
        map_s = wire.decode_array("map", batch_s["map"][0])
        bnd_s = wire.decode_array("boundary", batch_s["boundary"][0])
        w.add_image("DomainS/image", (img_s + 1.0) * 0.5, iteration)
        w.add_image("DomainS/target_cup", map_s[..., 0], iteration)
        w.add_image("DomainS/target_disc", map_s[..., 1], iteration)
        w.add_image("DomainS/target_boundary", bnd_s[..., 0], iteration)
        w.add_image("DomainS/prediction_cup", viz["pred_s"][..., 0], iteration)
        w.add_image("DomainS/prediction_disc", viz["pred_s"][..., 1], iteration)
        w.add_image("DomainS/prediction_boundary", viz["pred_b_s"][..., 0], iteration)
        if batch_t is not None and "pred_t" in viz:
            img_t = wire.decode_array("image", batch_t["image"][0])
            w.add_image("DomainT/image", (img_t + 1.0) * 0.5, iteration)
            if "map" in batch_t:
                map_t = wire.decode_array("map", batch_t["map"][0])
                w.add_image("DomainT/target_cup", map_t[..., 0], iteration)
                w.add_image("DomainT/target_disc", map_t[..., 1], iteration)
            w.add_image("DomainT/prediction_cup", viz["pred_t"][..., 0], iteration)
            w.add_image("DomainT/prediction_disc", viz["pred_t"][..., 1], iteration)
            w.add_image("DomainT/boundaryT", viz["bnd_t_raw"][..., 0], iteration)
        if "std_t" in viz:
            w.add_image("DomainT/target_cup_std_map", viz["std_t"][..., 0], iteration)
            w.add_image("DomainT/target_disc_std_map", viz["std_t"][..., 1], iteration)
            w.add_image("DomainT/mask_0", viz["conf_t"][..., 0], iteration)
            w.add_image("DomainT/mask_1", viz["conf_t"][..., 1], iteration)

    def _start_profile(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        tracing.clear()
        prof.start()
        return prof

    def _stop_profile(self, prof) -> dict:
        """Ends the window: ``trace.json`` and the step's spans,
        ``spans.json`` (one list of spans per step), under out_dir/profile;
        returns the spans' host ms per step by name (tracing.summary)."""
        self._sync()  # drain the window
        prof.stop()
        out = os.path.join(self.cfg.run.out_dir, "profile")
        os.makedirs(out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out, "trace.json"))
        recorded = tracing.steps()
        with open(os.path.join(out, "spans.json"), "w") as f:
            json.dump([[s._asdict() for s in step] for step in recorded], f)
        self._profiled = True
        return tracing.summary(recorded)

    # ------------------------------------------------------------------
    def validate(self):
        tot = {"loss": 0.0, "cup_dice": 0.0, "disc_dice": 0.0, "cup_pa": 0.0,
               "disc_pa": 0.0, "cup_iou": 0.0, "disc_iou": 0.0}
        n_batches = 0
        val_strips = []
        bs = self.cfg.data.batch_size
        for batch in self.loader_val.epoch(0):
            # pad the final partial batch up to the batch size (repeat the
            # last image); the pad is masked out of loss and metrics below
            n_valid = batch["image"].shape[0]
            image, map_t = batch["image"], batch["map"]
            if n_valid < bs:
                reps = [1] * (n_valid - 1) + [bs - n_valid + 1]
                image = np.repeat(image, reps, axis=0)
                map_t = np.repeat(map_t, reps, axis=0)
            logits, _, per_image_loss = self._eval_step(self._to_device(image),
                                                        self._to_device(map_t))
            logits = logits.cpu().numpy()[:n_valid]
            loss = float(np.mean(per_image_loss.cpu().numpy()[:n_valid]))
            map_host = wire.decode_array("map", batch["map"])
            if self.cfg.run.save_val_images and len(val_strips) < 8:
                probs = 1.0 / (1.0 + np.exp(-logits[0]))
                img01 = (wire.decode_array("image", batch["image"][0]) + 1.0) * 0.5
                val_strips.append(joint_val_image(img01, probs, map_host[0]))
            if not np.isfinite(loss):
                raise ValueError("loss is nan while validating")
            cup_d, disc_d = dice_coeff_2label(logits, map_host)
            pa_cup, pa_disc, iou_cup, iou_disc = pixel_acc(logits, map_host)
            tot["loss"] += loss
            tot["cup_dice"] += cup_d
            tot["disc_dice"] += disc_d
            tot["cup_pa"] += pa_cup
            tot["disc_pa"] += pa_disc
            tot["cup_iou"] += iou_cup
            tot["disc_iou"] += iou_disc
            n_batches += 1
        for k in tot:
            tot[k] /= max(n_batches, 1)
        if self.world > 1:
            # replicated validation; rank 0's metrics decide for every rank,
            # so the ranks take the same checkpoint branch
            keys = sorted(tot)
            vals = torch.tensor([tot[k] for k in keys], dtype=torch.float64, device=self.device)
            broadcast_([vals], self.device)
            tot = dict(zip(keys, vals.tolist()))
        if val_strips and self._main:
            save_val_img(self.cfg.run.out_dir, self.epoch, val_strips)

        step = self.epoch * len(self.loader_s)
        self.writer.add_scalar("val_data/loss_CE", tot["loss"], step)
        self.writer.add_scalar("val_data/val_CUP_dice", tot["cup_dice"], step)
        self.writer.add_scalar("val_data/val_DISC_dice", tot["disc_dice"], step)
        self.writer.add_scalar("val_data/val_CUP_PA", tot["cup_pa"], step)
        self.writer.add_scalar("val_data/val_DISC_PA", tot["disc_pa"], step)
        self.writer.add_scalar("val_data/val_CUP_IOU", tot["cup_iou"], step)
        self.writer.add_scalar("val_data/val_DISC_IOU", tot["disc_iou"], step)

        mean_dice = tot["cup_dice"] + tot["disc_dice"]
        ckpt_dir = os.path.join(self.cfg.run.out_dir, "checkpoints")
        if mean_dice > self.best_mean_dice:
            self.best_epoch = self.epoch + 1
            self.best_mean_dice = mean_dice
            ckpt_lib.save_checkpoint(ckpt_dir, self.state, self.epoch, self.best_mean_dice,
                                     f"checkpoint_{self.best_epoch}", iteration=self.iteration)
        elif (self.epoch + 1) % self.cfg.run.checkpoint_every == 0:
            ckpt_lib.save_checkpoint(ckpt_dir, self.state, self.epoch, self.best_mean_dice,
                                     f"checkpoint_{self.epoch + 1}", iteration=self.iteration)
        self.csv.write_valid_row(self.epoch, self.iteration, tot["loss"], tot["cup_dice"],
                                 tot["disc_dice"], self.best_epoch)
        self.writer.add_scalar("best_model_epoch", self.best_epoch, step)
        return tot

    # ------------------------------------------------------------------
    def train(self):
        cfg = self.cfg
        stop_epoch = cfg.run.stop_epoch if cfg.run.stop_epoch is not None else cfg.run.max_epoch
        try:
            for epoch in range(self.epoch, cfg.run.max_epoch):
                self.epoch = epoch
                self.train_epoch()
                if epoch == stop_epoch:
                    print(f"Stop epoch at {stop_epoch}")
                    break
                if (epoch + 1) % cfg.run.interval_validate == 0:
                    self.validate()
            if self.world > 1:
                self.replica_gap = self.check_replicas()
        finally:
            self.close()

    def check_replicas(self) -> float:
        """The largest difference between any rank's parameters and rank
        0's (broadcast from rank 0, all-reduce MAX); raises unless 0."""
        st = self.state
        params = [p for m in (st.gen, st.dis, st.dis2, st.cls2, st.teacher) if m is not None
                  for p in m.parameters()]
        gap = replica_gap(params, self.device)
        if gap != 0.0:
            raise RuntimeError(f"rank {self.rank}: parameters differ across ranks by {gap}")
        return gap

    def close(self):
        """Stop the target stream's producer thread and close the writer."""
        self._target_iter.close()
        self.writer.close()
