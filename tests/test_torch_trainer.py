"""The port's Trainer, checkpoints and CLI (uda_clr_tpu_torch/train/trainer.py,
train/checkpoint.py, cli.py) on the CPU at 64^2, B=2, T=2, and the pieces
they share with the JAX package: the uint8 step decode, the eval step
against JAX ``make_eval_step`` on the port's checkpoint, the lr schedule,
ramps and metrics. No JAX train step is compiled here."""

import csv
import json
import math
import sys

import numpy as np
import pytest
import torch

from tests.torch_ref import TorchDeepLab
from uda_clr_tpu.config import Config as JaxConfig
from uda_clr_tpu.convert.torch_import import load_reference_checkpoint
from uda_clr_tpu.models.deeplab import DeepLab as JaxDeepLab
from uda_clr_tpu.train import optim as jax_optim
from uda_clr_tpu.train.steps import make_eval_step as jax_make_eval_step
from uda_clr_tpu.utils import metrics as jax_metrics
from uda_clr_tpu.utils import ramps as jax_ramps
from uda_clr_tpu_torch import cli
from uda_clr_tpu_torch.config import Config
from uda_clr_tpu_torch.data import wire
from uda_clr_tpu_torch.models.gan import BoundaryDiscriminator
from uda_clr_tpu_torch.train import checkpoint as ckpt_lib
from uda_clr_tpu_torch.train import optim
from uda_clr_tpu_torch.train.state import create_train_state
from uda_clr_tpu_torch.train.steps import make_eval_step, make_train_step
from uda_clr_tpu_torch.train.trainer import Trainer
from uda_clr_tpu_torch.utils import metrics, ramps
from uda_clr_tpu_torch.utils.logging import LOG_HEADERS

FLAGS = ["--synthetic", "--image-size", "64", "--batch-size", "2", "--warmup-epoch", "0",
         "--interval-validate", "1", "--seed", "0"]


@pytest.fixture(scope="module", autouse=True)
def lean_cpu():
    """Two torch threads (the suite runs files side by side), and no
    tensorboard: the scalars take the JSONL path, as on a machine without
    it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        yield
    torch.set_num_threads(threads)


def _small_cfg(max_epoch: int, extra=()) -> Config:
    cfg = cli.build_config(FLAGS + ["--max-epoch", str(max_epoch)] + list(extra))
    cfg.method.mc_samples = 2
    cfg.data.synthetic_size = 2  # 1 step per epoch, 2 validation images
    return cfg


def _run_cli(tmp, name: str, cfg: Config, *flags) -> Trainer:
    """``python -m uda_clr_tpu_torch.cli --config <cfg> --out <tmp/name>
    --device cpu [flags]``, in process."""
    path = tmp / f"{name}.yaml"
    path.write_text(cfg.to_yaml())
    return cli.main(["--config", str(path), "--out", str(tmp / name), "--device", "cpu",
                     *flags])


def _rows(out_dir):
    with open(out_dir / "log.csv") as f:
        return list(csv.reader(f))


def _metric_cells(row):
    """Every cell but elapsed_time and the best-model note."""
    return row[:11]


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    """A 2-epoch prototype_full run (epoch 0 warmup, epoch 1 prototype
    phase), one step per epoch."""
    tmp = tmp_path_factory.mktemp("straight")
    trainer = _run_cli(tmp, "run", _small_cfg(2))
    return tmp / "run", trainer


def test_cli_run_writes_config_log_and_checkpoint(straight):
    out, trainer = straight
    cfg = JaxConfig.from_yaml((out / "config.yaml").read_text())
    assert cfg.to_dict() == trainer.cfg.to_dict()
    assert cfg.method.mc_samples == 2 and cfg.run.out_dir == str(out)
    rows = _rows(out)
    assert rows[0] == LOG_HEADERS
    train_rows = [r for r in rows[1:] if r[2]]
    valid_rows = [r for r in rows[1:] if not r[2]]
    assert [r[:2] for r in train_rows] == [["0", "0"], ["1", "1"]]
    assert [r[:2] for r in valid_rows] == [["0", "0"], ["1", "1"]]
    for r in train_rows:
        assert len(r) == 12 and all(math.isfinite(float(c)) for c in (r[2], r[5], r[6], r[7]))
    for r in valid_rows:
        assert len(r) == 13 and r[12].startswith("best model epoch: ")
        assert all(math.isfinite(float(c)) for c in r[8:11]) and 0 <= float(r[9]) <= 1
    tag = ckpt_lib.latest_checkpoint(str(out / "checkpoints"))
    assert tag is not None and tag.startswith("checkpoint_")
    meta = json.loads((out / "checkpoints" / f"{tag}.meta.json").read_text())
    assert set(meta) == {"epoch", "best_mean_dice", "iteration"}
    scalars = [json.loads(line) for line in (out / "tensorboard" / "scalars.jsonl").open()]
    assert {"train/loss_all", "val_data/val_CUP_dice", "lr_gen"} <= {r["tag"] for r in scalars}
    stats = trainer.epoch_stats
    assert [s["proto_phase"] for s in stats] == [False, True]
    assert all(s["steps"] == 1 and s["loader_wait_s"] >= 0 for s in stats)
    assert bool(trainer.state.proto_src_init)  # the prototype phase ran


def test_resume_is_exact(straight, tmp_path):
    """1 epoch, then resume for 1 more: the same metrics, bitwise, and the
    same weights as 2 epochs run straight."""
    out2, ref = straight
    first = _run_cli(tmp_path, "first", _small_cfg(1, ["--profile"]))
    assert (tmp_path / "first" / "profile" / "trace.json").exists()
    assert first.iteration == 0
    resumed = _run_cli(tmp_path, "second", _small_cfg(2), "--resume",
                       str(tmp_path / "first" / "checkpoints"))
    assert resumed.epoch_stats[0]["epoch"] == 1 and len(resumed.epoch_stats) == 1
    assert resumed.iteration == ref.iteration == 1
    want = [_metric_cells(r) for r in _rows(out2)[1:] if r[0] == "1"]
    got = [_metric_cells(r) for r in _rows(tmp_path / "second")[1:]]
    assert got == want and len(got) == 2  # a step row and a validation row
    for (k, a), b in zip(ref.state.gen.state_dict().items(), resumed.state.gen.state_dict().values()):
        assert torch.equal(a, b), k
    assert torch.equal(ref.state.proto_trg, resumed.state.proto_trg)
    assert ref.state.step == resumed.state.step == 2


def test_jax_reads_the_checkpoint_and_agrees_on_eval(straight):
    out, _ = straight
    ckpt_dir = out / "checkpoints"
    tag = ckpt_lib.latest_checkpoint(str(ckpt_dir))
    conv = load_reference_checkpoint(str(ckpt_dir / f"{tag}.pth.tar"))
    meta = json.loads((ckpt_dir / f"{tag}.meta.json").read_text())
    assert {k: conv[k] for k in meta} == meta
    assert {"gen", "dis", "dis2"} <= set(conv)

    state = create_train_state(Config(), seed=5, device="cpu")
    ckpt_lib.restore_checkpoint(str(ckpt_dir), tag, state)
    rng = np.random.default_rng(0)
    image = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    map_t = (rng.random((2, 64, 64, 2)) > 0.5).astype(np.uint8)
    logits, bnd, per_image = (t.numpy() for t in make_eval_step(state.gen)(
        torch.from_numpy(image), torch.from_numpy(map_t)))
    params, stats = conv["gen"]
    j_logits, j_bnd, j_per_image = (np.asarray(t) for t in jax_make_eval_step(
        JaxDeepLab(norm="bn"))({"params": params, "batch_stats": stats}, image, map_t))
    # float32 forwards of two frameworks: sums in another order
    np.testing.assert_allclose(logits, j_logits, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(bnd, j_bnd, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(per_image, j_per_image, rtol=1e-5, atol=1e-6)
    # Dice thresholds at 0.75: a pixel within the logit noise of it may flip
    host_map = wire.decode_array("map", map_t)
    for got, want in zip(metrics.dice_coeff_2label(logits, host_map),
                         jax_metrics.dice_coeff_2label(j_logits, host_map)):
        assert abs(got - want) <= 1e-3


def test_initial_resume_merges_reference_checkpoint(tmp_path):
    torch.manual_seed(0)
    ref = TorchDeepLab()
    dis = BoundaryDiscriminator(seed=9)
    sd = ref.state_dict()
    bad = "decoder.last_conv.3.weight"
    sd[bad] = torch.zeros(3, 3)  # a shape mismatch is skipped, not merged
    path = tmp_path / "beal.pth.tar"
    torch.save({"epoch": 29, "best_mean_dice": np.float64(1.5), "model_state_dict": sd,
                "model_dis_state_dict": dis.state_dict()}, path)
    cfg = _small_cfg(1)
    cfg.run.out_dir = str(tmp_path / "run")
    cfg.run.initial_resume = str(path)
    fresh = create_train_state(cfg, seed=cfg.run.seed, device="cpu")
    trainer = Trainer(cfg, device="cpu")
    try:
        got = trainer.state.gen.state_dict()
        for k, v in got.items():
            want = fresh.gen.state_dict()[k] if k == bad else ref.state_dict()[k]
            assert torch.equal(v, want), k
        for k, v in trainer.state.dis.state_dict().items():
            assert torch.equal(v, dis.state_dict()[k]), k
    finally:
        trainer.close()


def test_uint8_step_equals_f32_step_on_decoded_batch():
    cfg = Config()
    cfg.method.mc_samples = 2
    rng = np.random.default_rng(3)
    u8 = {"image_s": rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8),
          "map_s": (rng.random((2, 64, 64, 2)) > 0.5).astype(np.uint8),
          "boundary_s": rng.integers(0, 256, (2, 64, 64, 1), dtype=np.uint8),
          "image_t": rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)}
    out = []
    for batch in ({k: torch.from_numpy(v) for k, v in u8.items()},
                  {k: torch.from_numpy(wire.decode_array(k, v)) for k, v in u8.items()}):
        state = create_train_state(cfg, seed=1, device="cpu")
        state, m = make_train_step(cfg, "prototype_full", proto_phase=False)(
            state, batch, 1e-3, 2.5e-5)
        out.append((m, state.gen.state_dict()))
    (m_u8, sd_u8), (m_f32, sd_f32) = out
    viz_u8, viz_f32 = m_u8.pop("_viz"), m_f32.pop("_viz")
    assert m_u8.keys() == m_f32.keys() and viz_u8.keys() == viz_f32.keys()
    for k in m_u8:
        assert torch.equal(m_u8[k], m_f32[k]), k
    for k in viz_u8:
        assert torch.equal(viz_u8[k], viz_f32[k]), k
    for k in sd_u8:
        assert torch.equal(sd_u8[k], sd_f32[k]), k


@pytest.mark.parametrize("method, keys", [
    ("baseline", {"loss_seg", "loss_all"}),  # no target stream
    ("mean_teacher", {"loss_seg", "loss_adv", "loss_all", "loss_D", "loss_D2",
                      "loss_consistency"}),  # the ramped consistency weight
])
def test_other_methods_train_an_epoch(method, keys, tmp_path):
    cfg = _small_cfg(1, ["--method", method])
    cfg.run.out_dir = str(tmp_path)
    trainer = Trainer(cfg, device="cpu")
    try:
        means = trainer.train_epoch()
    finally:
        trainer.close()
    assert set(means) == keys and all(math.isfinite(v) for v in means.values())
    assert [r[:2] for r in _rows(tmp_path)[1:]] == [["0", "0"]]
    assert trainer.state.step == 1


def _two_ranks_on_cpu_with_nccl(c):
    c.run.dist_coordinator, c.run.dist_num_processes = "localhost:1234", 2
    c.run.dist_backend = "nccl"


@pytest.mark.parametrize("change, error, match", [
    # data parallelism is ported since; these cases keep their ids and now
    # hold its configuration errors, raised before any process group forms:
    # nccl without a card names the gloo backend
    pytest.param(_two_ranks_on_cpu_with_nccl, ValueError, "dist_backend: gloo",
                 id="change0-A12"),
    # a mesh wider than the (one-process) group names the dist_* fields
    pytest.param(lambda c: setattr(c.run, "mesh_shape", (2,)), ValueError,
                 "dist_num_processes", id="change1-A12"),
    pytest.param(lambda c: setattr(c.run, "initial_resume", "runs/x/checkpoints/checkpoint_3"),
                 NotImplementedError, "orbax", id="change2-orbax"),
    # several processes without a coordinator name it
    pytest.param(lambda c: setattr(c.run, "dist_num_processes", 2), ValueError,
                 "dist_coordinator", id="change3-A12"),
    # ported since: the Trainer builds with it (its strips are held in
    # tests/test_torch_images.py); the case keeps its id
    pytest.param(lambda c: setattr(c.run, "save_val_images", True), None, None,
                 id="change4-save_val_images"),
    # ported since: a ('data', 'space') mesh wider than the (one-process)
    # group names the dist_* fields; the case keeps its id
    pytest.param(lambda c: setattr(c.run, "mesh_shape", (4, 2)), ValueError,
                 "dist_num_processes", id="spatial_mesh"),
])
def test_out_of_slice_options_raise(change, error, match, tmp_path):
    """Options the port has not ported, and configurations it refuses,
    raise naming what to do; a ported one (``error`` None) builds."""
    cfg = _small_cfg(1)
    cfg.run.out_dir = str(tmp_path)
    change(cfg)
    if error is None:
        Trainer(cfg, device="cpu").close()
        return
    with pytest.raises(error, match=match):
        Trainer(cfg, device="cpu")


@pytest.mark.parametrize("change, keys", [
    (lambda c: setattr(c.method, "method", "bcdm"),
     {"loss_seg", "loss_cdd_before", "loss_cdd_after", "loss_all"}),
    (lambda c: setattr(c.model, "remat", True),
     {"loss_seg", "loss_adv", "loss_all", "loss_D", "loss_D2"}),
])
def test_bcdm_and_remat_train_a_step(change, keys, tmp_path):
    """Two options the Trainer once refused: it builds and runs one CPU
    step with each (the flagship's warmup under ``remat``)."""
    cfg = _small_cfg(1)
    cfg.run.out_dir = str(tmp_path)
    change(cfg)
    trainer = Trainer(cfg, device="cpu")
    try:
        means = trainer.train_epoch()
    finally:
        trainer.close()
    assert set(means) == keys and all(math.isfinite(v) for v in means.values())
    assert trainer.state.step == 1


def test_trainer_raises_without_cuda_when_asked_for_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    cfg = _small_cfg(1)
    cfg.run.out_dir = str(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(cfg)


@pytest.mark.parametrize("epoch", [0, 99, 100, 101, 250, 499])
def test_lr_schedule_equals_jax(epoch):
    assert optim.gen_lr_schedule(epoch, 1e-3) == jax_optim.gen_lr_schedule(epoch, 1e-3)
    assert optim.gen_lr_schedule(epoch, 2e-4, 50, 0.5) == \
        jax_optim.gen_lr_schedule(epoch, 2e-4, 50, 0.5)


@pytest.mark.parametrize("current", [0.0, 3.5, 20.0, 40.0, 55.0])
def test_ramps_equal_jax(current):
    for fn in ("sigmoid_rampup", "linear_rampup"):
        assert getattr(ramps, fn)(current, 40.0) == getattr(jax_ramps, fn)(current, 40.0)
    assert ramps.sigmoid_rampup(current, 0) == jax_ramps.sigmoid_rampup(current, 0)
    if current <= 40.0:
        assert ramps.cosine_rampdown(current, 40.0) == jax_ramps.cosine_rampdown(current, 40.0)
    assert ramps.get_current_consistency_weight(current, 1.0, 40.0) == \
        jax_ramps.get_current_consistency_weight(current, 1.0, 40.0)


@pytest.mark.parametrize("seed", range(3))
def test_metrics_equal_jax(seed):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((2, 32, 32, 2)).astype(np.float32) * 3
    target = (rng.random((2, 32, 32, 2)) > 0.6).astype(np.float32)
    assert metrics.dice_coeff_2label(logits, target) == \
        jax_metrics.dice_coeff_2label(logits, target)
    assert metrics.pixel_acc(logits, target) == jax_metrics.pixel_acc(logits, target)
    assert metrics.dice_coeff(logits[..., 0], target[..., 0]) == \
        jax_metrics.dice_coeff(logits[..., 0], target[..., 0])
