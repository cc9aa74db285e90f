"""Helpers of the port's data-parallel and spatial-mesh CPU tests
(tests/test_torch_parallel*.py, tests/test_torch_spatial*.py,
tests/test_torch_step.py): ranks spawned with ``torch.multiprocessing``
(``spawn``), joined through a ``file://`` URL under the test's tmp_path, one
torch thread each; and the train-step cases run the same way in one process
on the global batch and in each rank on its rows (and, on the
``('data', 'space')`` mesh, its stripe of rows of every image).

No JAX here: a spawned rank imports this module, and only the port."""

from __future__ import annotations

import hashlib
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from uda_clr_tpu_torch import cli
from uda_clr_tpu_torch.config import Config
from uda_clr_tpu_torch.models import layers as port_layers
from uda_clr_tpu_torch.parallel import reduce, spatial
from uda_clr_tpu_torch.parallel.distributed import initialize
from uda_clr_tpu_torch.parallel.mesh import local_rows, local_stripe
from uda_clr_tpu_torch.train import checkpoint as ckpt_lib
from uda_clr_tpu_torch.train import steps as steps_lib
from uda_clr_tpu_torch.train.state import BANK_SIZES, create_train_state
from uda_clr_tpu_torch.train.steps import make_train_step

B, SIZE, T = 8, 64, 2
LR_GEN, LR_DIS, EPOCH = 1e-5, 2.5e-5, 26

# the method surface of tests/test_mesh_equivalence.py (each case: method,
# norm, MethodConfig overrides, the prototype phase), plus the flagship
# under both norms. The disk bank's case turns on the distance-weighted
# pseudo-labels, the one path through the min-max weight.
CASES = {
    "prototype_full-bn": ("prototype_full", "bn", {}, True),
    "prototype_full-tn": ("prototype_full", "tn", {}, True),
    "bcdm": ("bcdm", "bn", {}, False),
    "mean_teacher": ("mean_teacher", "bn", {"teacher_noise": 0.1}, False),
    "posal": ("posal", "bn", {}, False),
    "prototype": ("prototype", "bn", {"use_weight_rectify": True}, True),
    "prototype_mt": ("prototype_mt", "bn", {"use_trg_cons": True}, True),
    "baseline-tn": ("baseline", "tn", {}, False),
    "bcdm-tn": ("bcdm", "tn", {}, False),
    "prototype_mt-tn": ("prototype_mt", "tn", {"use_trg_cons": True}, True),
}
# the cases of the ('data', 'space') mesh's files (tests/test_torch_spatial.py
# and its card file): CASES but bcdm under tn, whose running stats after
# five updates sit on a float32 floor above those files' absolute bound on
# them (2e-3): one process against itself on the same batch with the rows
# reordered inside each half gives 7.2e-3. test_torch_parallel_steps.py
# holds it
SPATIAL_CASES = [case for case in CASES if case != "bcdm-tn"]


def global_batch(seed: int = 7, b: int = B, size: int = SIZE) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "image_s": rng.standard_normal((b, size, size, 3)).astype(np.float32),
        "map_s": (rng.uniform(0, 1, (b, size, size, 2)) > 0.5).astype(np.float32),
        "boundary_s": rng.uniform(0, 1, (b, size, size, 1)).astype(np.float32),
        "image_t": rng.standard_normal((b, size, size, 3)).astype(np.float32),
    }


def rows(batch: dict, rank: int, world: int, device: str = "cpu") -> dict:
    """A rank's rows of a global batch (source and target alike); on a
    ``('data', 'space')`` mesh (:func:`spatial.init_mesh` called) its data
    index's rows and its stripe of every image."""
    if spatial.mesh() is not None:
        (d, n_data), (s, n_space) = spatial.data_coords(), spatial.space_coords()
        return {k: torch.from_numpy(
            v[local_rows(len(v), d, n_data), local_stripe(v.shape[1], s, n_space)].copy()
        ).to(device) for k, v in batch.items()}
    return {k: torch.from_numpy(v[local_rows(len(v), rank, world)].copy()).to(device)
            for k, v in batch.items()}


def _cpu(tree: dict) -> dict:
    return {k: v.detach().cpu().clone() for k, v in tree.items()}


def run_case(name: str, rank: int = 0, world: int = 1, device: str = "cpu") -> dict:
    """One step of case ``name`` on this rank's rows of the global batch
    (dropout off, float32); returns the metrics, the generator's gradients,
    buffers and parameters after the step, and the banks, on the CPU."""
    method, norm, overrides, proto = CASES[name]
    cfg = Config()
    cfg.model.norm = norm
    cfg.method.mc_samples = T
    for k, v in overrides.items():
        setattr(cfg.method, k, v)
    bank = None
    if method == "prototype":
        rng = np.random.default_rng(3)
        bank = {k: rng.standard_normal(n).astype(np.float32) * 0.1 for k, n in BANK_SIZES.items()}
    if device != "cpu":  # float32 on the card: TF32 off
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    prev = port_layers.dropout_impl()
    port_layers.set_dropout_impl("off")
    try:
        state = create_train_state(cfg, seed=0, device=device, method=method, proto_bank=bank)
        step = make_train_step(cfg, method, proto_phase=proto)
        state, metrics = step(state, rows(global_batch(), rank, world, device), LR_GEN, LR_DIS,
                              EPOCH)
    finally:
        port_layers.set_dropout_impl(prev)
    metrics.pop("_viz")
    gen = state.gen
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "grads": _cpu({n: p.grad for n, p in gen.named_parameters() if p.grad is not None}),
           "buffers": _cpu(dict(gen.named_buffers())),
           "params": _cpu(dict(gen.named_parameters())),
           "banks": _cpu({"proto_src": state.proto_src, "proto_trg": state.proto_trg,
                          **{f"bank_{k}": v for k, v in (state.proto_bank or {}).items()}})}
    if state.dis is not None:
        out["dis"] = _cpu(dict(state.dis.named_parameters()))
    if rank > 0:  # held to rank 0's bit for bit: digests travel, not tensors
        out = {"metrics": out["metrics"],
               **{part: digests(out[part]) for part in ("params", "buffers", "banks")}}
    return out


def digests(tensors: dict) -> dict:
    """{name: a digest of the tensor's dtype, shape and bytes}."""
    def digest(v):
        raw = v.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
        return hashlib.sha256(raw).hexdigest()

    return {k: (str(v.dtype), tuple(v.shape), digest(v)) for k, v in tensors.items()}


def _rank_entry(rank: int, world: int, url: str, target, args, out_dir: str,
                backend: str = "gloo"):
    """A spawned rank: one torch thread, the process group (gloo, also on a
    card; nccl with card ``rank`` as this rank's), ``target(rank, world,
    *args)``, its result to out_dir/rank{r}.pt. An exception ends the rank
    with its traceback, which ``spawn`` raises (and stops the others)."""
    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    initialize(url, world, rank, backend=backend, device="cuda" if backend == "nccl" else "cpu")
    try:
        result = target(rank, world, *args)
    finally:
        if dist.is_initialized():  # the CLI ends its group itself
            dist.destroy_process_group()
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))


def spawn(target, tmp_path, args=(), world: int = 2, meanwhile=None,
          timeout: float = 600.0, backend: str = "gloo") -> list:
    """Run ``target(rank, world, *args)`` in ``world`` spawned ranks of one
    ``backend`` group, and ``meanwhile()`` here while they run; returns each
    rank's result. A rank that raises fails the call with its traceback;
    ranks still running after ``timeout`` seconds are killed and fail it."""
    out_dir = str(tmp_path)
    url = f"file://{os.path.join(out_dir, 'dist_init')}"
    ctx = mp.start_processes(_rank_entry, args=(world, url, target, args, out_dir, backend),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        if meanwhile is not None:
            meanwhile()
    finally:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 1.0)):
            if time.monotonic() >= deadline:
                for proc in ctx.processes:
                    proc.kill()
                raise AssertionError(f"the ranks did not finish within {timeout} s")
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def flagship_step(rank: int, world: int, start: dict, batch: dict, t: int, lr_gen: float,
                  lr_dis: float, n_space: int = 1) -> dict:
    """One ``prototype_full`` prototype-phase step, dropout off, from the
    state_dicts ``start`` on this rank's rows of ``batch`` (the anchors of
    tests/test_torch_step.py against the JAX step; ``n_space`` stripes on
    a ``(world / n_space, n_space)`` mesh)."""
    spatial.init_mesh((world // n_space, n_space))
    port_layers.set_dropout_impl("off")
    cfg = Config()
    cfg.method.mc_samples = t
    state = create_train_state(cfg, seed=0, device="cpu", **start)
    state, got = make_train_step(cfg, "prototype_full", proto_phase=True)(
        state, rows(batch, rank, world), lr_gen, lr_dis)
    got.pop("_viz")
    return {"metrics": {k: float(v) for k, v in got.items()},
            "banks": {"proto_src": state.proto_src, "proto_trg": state.proto_trg},
            "gen": state.gen.state_dict()}


def run_cases(rank: int, world: int, names, device: str = "cpu", n_space: int = 1) -> dict:
    """The cases ``names`` in this rank, on a ``(world / n_space, n_space)``
    mesh."""
    spatial.init_mesh((world // n_space, n_space))
    return {name: run_case(name, rank, world, device) for name in names}


# Each metric's class, as tests/test_mesh_equivalence.py:166-248 sorts them:
# tight keys pass through no hard threshold (a per-rank-moments fault moves
# them by 2.7e-2 under bn and 5.8e-2 under tn); loose keys sit downstream of
# the pseudo-label and confidence thresholds; post keys are computed after
# bcdm's same-step updates. The mean teacher's noise is drawn for the global
# batch, so its consistency loss is tight with the noise on.
_PROTO = ({"loss_seg", "loss_D", "loss_D2", "loss_adv"}, {"loss_intra", "loss_inter", "loss_all"},
          set())
CLASSES = {
    "prototype_full-bn": _PROTO,
    "prototype_full-tn": _PROTO,
    "bcdm": ({"loss_seg"}, set(), {"loss_cdd_before", "loss_cdd_after", "loss_all"}),
    "mean_teacher": ({"loss_seg", "loss_adv", "loss_consistency", "loss_D", "loss_D2",
                      "loss_all"}, set(), set()),
    "posal": ({"loss_seg", "loss_adv", "loss_D", "loss_all"}, set(), set()),
    "prototype": ({"loss_seg", "loss_adv", "loss_D", "loss_D2"},
                  {"loss_all", "loss_cup", "loss_disc", "loss_bu"}, set()),
    "prototype_mt": ({"loss_seg", "loss_adv", "loss_D", "loss_D2", "loss_src_reg"},
                     {"loss_all", "loss_intra", "loss_inter", "loss_aug"}, set()),
    "baseline-tn": ({"loss_seg", "loss_all"}, set(), set()),
    "bcdm-tn": ({"loss_seg"}, set(), {"loss_cdd_before", "loss_cdd_after", "loss_all"}),
    # with dropout off loss_aug passes through no threshold of its own
    "prototype_mt-tn": ({"loss_seg", "loss_adv", "loss_D", "loss_D2", "loss_src_reg",
                         "loss_aug"}, {"loss_all", "loss_intra", "loss_inter"}, set()),
}
# absolute, JAX's values (test_mesh_equivalence.py:248); measured on the
# CPU, 2 ranks against 1 process: tight <= 2.4e-6, loose <= 1.9e-6
# (loss_aug), post <= 2.2e-5 (loss_cdd_after)
METRIC_ATOL = {"tight": 1e-5, "loose": 2e-2, "post": 4e-2}
# the generator's gradients, whose batch-norm biases carry a float32 floor:
# a reordering of the batch inside one process moves them by up to 0.16 of
# the largest gradient. |diff| / |grad| over all tensors (measured <= 0.044,
# bcdm), and each tensor's largest |diff| over the largest gradient
# (measured <= 0.134, tn)
GRAD_L2_RTOL, GRAD_MAX_RTOL = 0.1, 0.25
# bcdm under tn: the gradients of its fifth update, after four Adam steps,
# sit on a float32 floor above GRAD_L2_RTOL: one process against itself on
# the same batch with the rows reordered inside each half gives 0.156
# (measured 2 ranks 0.147; halving each rank's own rows instead gave 1.62)
GRAD_L2_RTOL_CASE = {"bcdm-tn": 0.25}
# running stats, relative to each tensor's largest entry (floor 1e-3):
# measured <= 5.8e-5; bcdm's later forwards follow its updates (0.072)
STATS_RTOL = {"bcdm": 0.25, "bcdm-tn": 0.25}
STATS_RTOL_DEFAULT = 3e-4
PARAM_MEDIAN_LR = 0.2  # G params after Adam: median |diff| / lr (measured 0.0)
BANK_ATOL = 1e-4  # EMA prototype banks and the disk bank (measured <= 2.3e-5)
DIS_RTOL = 1e-6  # the boundary D after SGD, relative to its largest entry (measured <= 4.7e-8)


def compare_case(name: str, one: dict, ranks: list, metric_atol: dict = METRIC_ATOL) -> list[str]:
    """Every fault of the ranks' results against the one-process result of
    case ``name`` (empty when they agree): the ranks hold the same metrics,
    parameters, running stats and banks bit for bit, and rank 0's are held
    to the one process within the tolerances above (``metric_atol`` by the
    metrics' class)."""
    bad = []
    for r, res in enumerate(ranks[1:], 1):
        if res["metrics"] != ranks[0]["metrics"]:
            bad.append(f"rank {r}'s metrics differ from rank 0's")
        for part in ("params", "buffers", "banks"):
            if res[part] != digests(ranks[0][part]):
                bad.append(f"rank {r}'s {part} differ from rank 0's")
    got = ranks[0]
    tight, loose, post = CLASSES[name]
    if set(one["metrics"]) != set(got["metrics"]) or set(one["metrics"]) != tight | loose | post:
        bad.append(f"metric keys {sorted(got['metrics'])} vs {sorted(one['metrics'])}")
    for cls, keys in (("tight", tight), ("loose", loose), ("post", post)):
        for k in keys & set(got["metrics"]):
            gap = abs(one["metrics"][k] - got["metrics"][k])
            if not gap <= metric_atol[cls]:
                bad.append(f"{k} ({cls}): {one['metrics'][k]} vs {got['metrics'][k]}")
    g1, g2 = one["grads"], got["grads"]
    if set(g1) != set(g2):
        bad.append("the ranks' gradients cover other parameters")
    else:
        gmax = max(float(g.abs().max()) for g in g1.values())
        diff = torch.cat([(g1[k] - g2[k]).flatten() for k in g1])
        l2 = float(diff.norm() / torch.cat([g.flatten() for g in g1.values()]).norm())
        if not l2 <= GRAD_L2_RTOL_CASE.get(name, GRAD_L2_RTOL):
            bad.append(f"gradients: |diff| / |grad| {l2:.3g}")
        worst = max(g1, key=lambda k: float((g1[k] - g2[k]).abs().max()))
        if not float((g1[worst] - g2[worst]).abs().max()) <= GRAD_MAX_RTOL * gmax:
            bad.append(f"gradient {worst}: {float((g1[worst] - g2[worst]).abs().max()):.3g} "
                       f"of a largest gradient {gmax:.3g}")
    rtol = STATS_RTOL.get(name, STATS_RTOL_DEFAULT)
    for k, v in one["buffers"].items():
        err = float((v - got["buffers"][k]).abs().max()) / max(float(v.abs().max()), 1e-3)
        if not err <= rtol:
            bad.append(f"running stat {k}: {err:.3g} of its largest entry")
    d = torch.cat([(one["params"][k] - got["params"][k]).abs().flatten() for k in one["params"]])
    if not float(d.median()) / LR_GEN <= PARAM_MEDIAN_LR:
        bad.append(f"params: median diff {float(d.median()) / LR_GEN:.3g} lr")
    for k, v in one["banks"].items():
        if not float((v - got["banks"][k]).abs().max()) <= BANK_ATOL:
            bad.append(f"bank {k}: {float((v - got['banks'][k]).abs().max()):.3g}")
    for k, v in one.get("dis", {}).items():
        if not float((v - got["dis"][k]).abs().max()) <= DIS_RTOL * float(v.abs().max()):
            bad.append(f"discriminator {k}")
    return bad


# ---- the rank side of tests/test_torch_parallel.py ------------------------


def seed_spy(monkeypatch_targets: list):
    """Record the seeds the step hands K1 (its plain version runs) and K3
    (an identity stands in for it: only its seeds are read)."""
    seeds = {"k1": [], "k3": []}
    real_k1, real_k3 = steps_lib.fused_mask_head_split, port_layers.fused_dropout

    def k1(*args, **kwargs):
        seeds["k1"].append(args[9])
        return real_k1(*args, **kwargs)

    def k3(x, seed, rate):
        seeds["k3"].append(seed)
        return x

    steps_lib.fused_mask_head_split, port_layers.fused_dropout = k1, k3
    monkeypatch_targets += [(steps_lib, "fused_mask_head_split", real_k1),
                            (port_layers, "fused_dropout", real_k3)]
    return seeds


def seeded_step(rank: int, world: int) -> dict:
    """One flagship prototype-phase step under the fused dropout ('pallas')
    on this rank's rows of 2 + 2 images at 32^2; the seeds K1 and K3 were
    given."""
    restore = []
    seeds = seed_spy(restore)
    prev = port_layers.dropout_impl()
    port_layers.set_dropout_impl("pallas")
    try:
        cfg = Config()
        cfg.method.mc_samples = 2
        state = create_train_state(cfg, seed=0, device="cpu")
        step = steps_lib.make_train_step(cfg, "prototype_full", proto_phase=True)
        step(state, rows(global_batch(b=2, size=32), rank, world), 1e-3, 2.5e-5, 30)
    finally:
        port_layers.set_dropout_impl(prev)
        for module, name, real in restore:
            setattr(module, name, real)
    return seeds


def collectives(rank: int) -> dict:
    """Each reduction of parallel/reduce.py on rank-dependent values."""
    out = {}
    x = (torch.tensor([1.0, 2.0]) * (rank + 1)).requires_grad_()
    y = reduce.all_sum(x)
    (y * (rank + 1)).sum().backward()
    out["sum"], out["sum_grad"] = y.detach(), x.grad
    v = torch.tensor([float(rank), 5.0 - rank], requires_grad=True)  # [0, 5] and [1, 4]
    lo, hi = reduce.all_min(v.min()), reduce.all_max(v.max())
    (lo + 2.0 * hi).backward()
    reduce.average_grads([v])
    out["min_max"], out["min_max_grad"] = (lo.item(), hi.item()), v.grad
    out["metrics"] = {k: float(t) for k, t in reduce.mean_metrics(
        {"a": torch.tensor(float(rank)), "b": torch.tensor(2.0)}).items()}
    t, flag = torch.full((3,), float(rank)), torch.tensor(rank == 0)
    reduce.broadcast_([t, flag], torch.device("cpu"))
    out["broadcast"] = (t, bool(flag))
    out["gap_equal"] = reduce.replica_gap([t], torch.device("cpu"))
    out["gap_apart"] = reduce.replica_gap([t + rank * 0.5], torch.device("cpu"))
    out["rows"] = reduce.gather_rows(torch.tensor([rank, 7], dtype=torch.uint8),
                                     torch.device("cpu"))
    return out


def checkpoint_round_trip(rank: int, tmp: str) -> dict:
    """A baseline state saved by every rank (rank 0 writes) and restored."""
    cfg = Config()
    state = create_train_state(cfg, seed=0, device="cpu", method="baseline")
    torch.rand(rank + 3, generator=state.generator)  # the ranks' dropout streams move apart
    mine = state.generator.get_state()
    ckpt_lib.save_checkpoint(os.path.join(tmp, "ckpt"), state, 0, 0.0, "checkpoint_1")
    fresh = create_train_state(cfg, seed=0, device="cpu", method="baseline")
    ckpt_lib.restore_checkpoint(os.path.join(tmp, "ckpt"), "checkpoint_1", fresh)
    return {"restored_own": torch.equal(fresh.generator.get_state(), mine),
            "noise_alike": fresh.noise_generator.get_state()}


def cli_runs(rank: int, world: int, tmp: str, mesh_shape=None) -> dict:
    """The CLI in this rank at 32^2: a warmup epoch, then a resume for a
    prototype-phase epoch; each from a --config with run.dist_* (and
    ``run.mesh_shape``)."""
    sys.modules["torch.utils.tensorboard"] = None  # scalars to JSONL (loads no TensorFlow)
    runs = []
    for i, extra in enumerate(([], ["--resume", os.path.join(tmp, "run", "checkpoints")])):
        cfg = cli.build_config(["--synthetic", "--image-size", "32", "--batch-size", "2",
                                "--warmup-epoch", "0", "--interval-validate", "1",
                                "--max-epoch", str(1 + i), "--seed", "0"])
        cfg.method.mc_samples = 2
        cfg.data.synthetic_size = 2  # 1 global step per epoch, each rank 1 image of each domain
        cfg.run.checkpoint_every = 1
        cfg.run.viz_every = 1  # forced to 0 across processes
        cfg.run.dist_coordinator = f"file://{os.path.join(tmp, f'cli_init_{i}')}"
        cfg.run.dist_num_processes, cfg.run.dist_process_id = world, rank
        cfg.run.dist_backend = "gloo"
        cfg.run.mesh_shape = mesh_shape
        path = os.path.join(tmp, f"rank{rank}_{i}.yaml")
        with open(path, "w") as f:
            f.write(cfg.to_yaml())
        trainer = cli.main(["--config", path, "--out", os.path.join(tmp, "run"),
                            "--device", "cpu", *extra])
        runs.append({"epochs": trainer.epoch_stats, "gap": trainer.replica_gap,
                     "iteration": trainer.iteration, "viz_every": trainer.cfg.run.viz_every,
                     "params": {k: v.clone() for k, v in trainer.state.gen.state_dict().items()},
                     "world": trainer.world, "mesh": trainer.mesh is not None})
    return {"runs": runs}


def units(rank: int, world: int, tmp: str) -> dict:
    return {"collectives": collectives(rank), "seeds": seeded_step(rank, world),
            "checkpoint": checkpoint_round_trip(rank, tmp), "cli": cli_runs(rank, world, tmp)}


# ---- the rank side of tests/test_torch_spatial.py -------------------------

# float64 inputs of the halo primitives: B images, C channels, H x W
PB, PC, PH = 8, 4, 16
_PURE = ("conv k3 s1", "conv k3 s2", "conv k3 d6", "conv k3 d18", "conv k7 s2", "conv k1 s2",
         "fixed_padding d2", "fixed_padding s2", "max_pool", "bilinear up", "bilinear down",
         "blur reflect", "masked_pool_mean", "discriminator")
_NORMED = ("inverted_residual d2", "inverted_residual s2", "aspp")
PRIMITIVE_NAMES = _PURE + tuple(f"{n} {norm}" for norm in ("bn", "tn") for n in _NORMED)


def primitive_cases(norm: str = "bn") -> dict:
    """{name: (fn of an NCHW float64 stripe, input shape, whether the output
    is a stripe (else a value every rank holds), the module whose running
    stats the case updates or None)}, built from fixed seeds, so every
    process builds the same ones. The norms run in train mode with
    ``domains=2``."""
    from uda_clr_tpu_torch.models import layers
    from uda_clr_tpu_torch.models.aspp import ASPP
    from uda_clr_tpu_torch.models.gan import PatchDiscriminator
    from uda_clr_tpu_torch.models.mobilenet import InvertedResidual
    from uda_clr_tpu_torch.ops import augment, prototypes
    from uda_clr_tpu_torch.ops.resize import resize_bilinear_align_corners
    from uda_clr_tpu_torch.models.norm import DomainNorm2d

    torch.manual_seed(0)

    def conv(k, s, p, d, groups=1):
        m = layers.Conv2d(PC, PC * 2 // groups * groups, k, s, p, d, groups=groups).double()
        return lambda x: m(x)

    def fixed(k, s, d):
        m = layers.Conv2d(PC, PC, k, s, 0, d, groups=PC, bias=False).double()
        return lambda x: m(layers.fixed_padding(x, k, d))

    def randomize(module):
        with torch.no_grad():
            for n in module.modules():
                if isinstance(n, DomainNorm2d):
                    n.weight.uniform_(0.5, 1.5)
                    n.bias.uniform_(-0.5, 0.5)
        return module.double()

    ir1 = randomize(InvertedResidual(PC, PC, 1, 2, 6, norm))
    ir2 = randomize(InvertedResidual(PC, 2 * PC, 2, 1, 6, norm))
    aspp = randomize(ASPP(PC, 16, norm))
    dis = PatchDiscriminator(PC).double()
    taps = torch.tensor([augment._TAP5[5], augment._TAP5[3]] * (PB // 2), dtype=torch.float64)
    mask = (torch.rand(PB, 1, PH, PH) > 0.4).double()

    def pool(x):  # masked pooling of NHWC features under a mask stripe
        s, n = spatial.space_coords()
        m = mask[:, :, local_stripe(PH, s, n)] if spatial.active() else mask
        return prototypes.masked_pool_mean(x.permute(0, 2, 3, 1), m.permute(0, 2, 3, 1))

    def resize(h_out, w_out):
        return lambda x: resize_bilinear_align_corners(
            x, (h_out // (spatial.space_coords()[1] if spatial.active() else 1), w_out))

    return {
        "conv k3 s1": (conv(3, 1, 1, 1), (PB, PC, PH, PH), True, None),
        "conv k3 s2": (conv(3, 2, 1, 1), (PB, PC, PH, PH), True, None),
        "conv k3 d6": (conv(3, 1, 6, 6), (PB, PC, PH, PH), True, None),
        "conv k3 d18": (conv(3, 1, 18, 18, groups=PC), (PB, PC, PH, PH), True, None),
        "conv k7 s2": (conv(7, 2, 3, 1), (PB, PC, PH, PH), True, None),
        "conv k1 s2": (conv(1, 2, 0, 1), (PB, PC, PH, PH), True, None),
        "fixed_padding d2": (fixed(3, 1, 2), (PB, PC, PH, PH), True, None),
        "fixed_padding s2": (fixed(3, 2, 1), (PB, PC, PH, PH), True, None),
        "max_pool": (layers.max_pool_3x3_s2, (PB, PC, PH, PH), True, None),
        "bilinear up": (resize(4 * PH, 2 * PH), (PB, PC, PH, PH), True, None),
        "bilinear down": (resize(PH // 4, PH // 2), (PB, PC, PH, PH), True, None),
        "blur reflect": (lambda x: augment._blur5(x, taps), (PB, 3, PH, PH), True, None),
        "masked_pool_mean": (pool, (PB, PC, PH, PH), False, None),
        "discriminator": (lambda x: dis(x.permute(0, 2, 3, 1)), (PB, PC, PH, PH), False, None),
        f"inverted_residual d2 {norm}": (lambda x: ir1(x, True, 2), (PB, PC, PH, PH), True,
                                         ir1),
        f"inverted_residual s2 {norm}": (lambda x: ir2(x, True, 2), (PB, PC, PH, PH), True,
                                         ir2),
        f"aspp {norm}": (lambda x: aspp.predrop(x, True, 2), (PB, PC, PH, PH), True, aspp),
    }


def run_primitive(fn, x: torch.Tensor, seed: int, striped: bool, s: int = 0,
                  n: int = 1) -> tuple:
    """``fn`` on stripe ``s`` of ``n`` of ``x`` (the whole for n = 1) and
    the gradient of sum(fn(x) * w), w drawn whole from ``seed`` (a value
    every rank holds: divided by ``n``, so that the ranks' losses sum to
    the whole one's)."""
    x = x[:, :, local_stripe(x.shape[2], s, n)].clone().requires_grad_()
    y = fn(x)
    shape = list(y.shape)
    if striped:
        shape[2] *= n
    w = torch.randn(shape, generator=torch.Generator().manual_seed(seed), dtype=torch.float64)
    if striped:
        w = w[:, :, local_stripe(shape[2], s, n)]
    ((y * w).sum() / (1 if striped else n)).backward()
    return y.detach(), x.grad


def primitive_input(shape, seed: int) -> torch.Tensor:
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed),
                       dtype=torch.float64)


def run_primitives(s: int = 0, n: int = 1) -> dict:
    """Every primitive case under both norms on stripe ``s`` of ``n``
    (inside the spatial region when n > 1): {name: (output, the input's
    gradient, the case's running stats after the call)}."""
    out = {}
    for norm in ("bn", "tn"):
        for i, (name, (fn, shape, striped, module)) in enumerate(primitive_cases(norm).items()):
            if name in out:
                continue
            with spatial.region():
                y, grad = run_primitive(fn, primitive_input(shape, i), 100 + i, striped, s, n)
            stats = {} if module is None else {k: v.clone() for k, v in module.named_buffers()}
            out[name] = (y, grad, stats, striped)
    assert tuple(out) == PRIMITIVE_NAMES, tuple(out)
    return out


BACKBONES = ("resnet", "xception", "drn")


def run_backbones(s: int = 0, n: int = 1) -> dict:
    """Each other backbone's train-mode forward (bn, ``domains=2``,
    float64, the norms' moments summed in float32) of 2 + 2 images at 32^2
    on stripe ``s`` of ``n``: {name: (high, low, the input's gradient, the
    running stats after it)}."""
    from uda_clr_tpu_torch.models.deeplab import build_backbone

    out = {}
    for i, name in enumerate(BACKBONES):
        torch.manual_seed(i)
        net = build_backbone(name, 16 if name != "drn" else 8, "bn", False).double()
        x = torch.randn((4, 3, 32, 32), generator=torch.Generator().manual_seed(i),
                        dtype=torch.float64)
        x = x[:, :, local_stripe(32, s, n)].clone().requires_grad_()
        with spatial.region():
            high, low = net(x, True, 2)
            g = torch.Generator().manual_seed(10 + i)
            loss = 0.0
            for y in (high, low):
                w = torch.randn((y.shape[0], y.shape[1], y.shape[2] * n, y.shape[3]), generator=g,
                                dtype=torch.float64)
                loss = loss + (y * w[:, :, local_stripe(w.shape[2], s, n)]).sum()
            loss.backward()
        out[name] = (high.detach(), low.detach(), x.grad,
                     {k: v.clone() for k, v in net.named_buffers()})
    return out


def mesh_units(rank: int, world: int, n_space: int, names, tmp: str | None = None) -> dict:
    """This rank on a ``(world / n_space, n_space)`` mesh: on one data
    index, :func:`run_primitives` on its stripe; the step cases ``names``;
    with ``tmp``, the other
    backbones (:func:`run_backbones`) and the CLI on that mesh
    (:func:`cli_runs`)."""
    spatial.init_mesh((world // n_space, n_space))
    out = {"cases": {name: run_case(name, rank, world) for name in names}}
    if world == n_space:
        out["primitives"] = run_primitives(rank, world)
    if tmp is not None:
        out["backbones"] = run_backbones(rank, world)
        out["cli"] = cli_runs(rank, world, tmp, (world // n_space, n_space))
    return out
