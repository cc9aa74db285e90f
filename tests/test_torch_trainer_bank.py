"""The port's Trainer, checkpoints, CLI and prototype-bank tool on the paths
of TransNorm, the disk-bank method (``prototype``) and the repeated-batch
MC pass (``mc_fast=False``), on the CPU at 64^2, B=2, T=2: the prototype
phase past warmup, the tool's bank read through ``prototype_bank_path``,
the frozen initial model and the bank through a checkpoint, an exact
1 + 1 = 2-epoch resume, and the slow MC step against the inline one. No
JAX step is compiled here."""

import csv
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from uda_clr_tpu_torch import cli
from uda_clr_tpu_torch.config import Config
from uda_clr_tpu_torch.models import layers
from uda_clr_tpu_torch.tools import cal_prototype
from uda_clr_tpu_torch.train import checkpoint as ckpt_lib
from uda_clr_tpu_torch.train.state import create_train_state
from uda_clr_tpu_torch.train.steps import make_train_step
from uda_clr_tpu_torch.train.trainer import Trainer

FLAGS = ["--synthetic", "--image-size", "64", "--batch-size", "2", "--warmup-epoch", "0",
         "--interval-validate", "1", "--seed", "0"]


@pytest.fixture(scope="module", autouse=True)
def lean_cpu():
    """Two torch threads (the suite runs files side by side), and no
    tensorboard: the scalars take the JSONL path."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        yield
    torch.set_num_threads(threads)


def _cfg(max_epoch: int, *extra) -> Config:
    cfg = cli.build_config(FLAGS + ["--max-epoch", str(max_epoch), *extra])
    cfg.method.mc_samples = 2
    cfg.data.synthetic_size = 2  # 1 step per epoch, 2 validation images
    cfg.run.checkpoint_every = 1
    return cfg


def _run_cli(tmp, name: str, cfg: Config, *flags) -> Trainer:
    path = tmp / f"{name}.yaml"
    path.write_text(cfg.to_yaml())
    return cli.main(["--config", str(path), "--out", str(tmp / name), "--device", "cpu",
                     *flags])


@pytest.fixture(scope="module")
def bank_path(tmp_path_factory):
    """The prototype-bank tool's .npz from a TransNorm generator over its 8
    synthetic 64^2 images, run through its CLI on the CPU."""
    path = tmp_path_factory.mktemp("bank") / "bank.npz"
    bank = cal_prototype.main(["--synthetic", "--image-size", "64", "--batch-size", "4",
                               "--use_TN", "--device", "cpu", "--out", str(path)])
    assert {k: v.shape for k, v in bank.items()} == {"bu": (304,), "cup": (305,), "disc": (305,)}
    return path


@pytest.fixture(scope="module")
def straight(tmp_path_factory, bank_path):
    """``--method prototype --use_TN`` with the tool's bank, 2 epochs:
    epoch 0 is warmup, epoch 1 past it."""
    tmp = tmp_path_factory.mktemp("straight")
    cfg = _cfg(2, "--method", "prototype", "--use_TN")
    cfg.method.prototype_bank_path = str(bank_path)
    return _run_cli(tmp, "run", cfg), cfg


def test_prototype_epoch_past_warmup_runs_the_prototype_phase(straight, bank_path):
    """The Trainer enters the disk-bank method's prototype phase past warmup
    (trainer.py:313-318), logs its losses and moves the bank."""
    trainer, _ = straight
    assert [s["proto_phase"] for s in trainer.epoch_stats] == [False, True]
    out = Path(trainer.cfg.run.out_dir)
    train_rows = [r for r in _rows(out / "log.csv") if r[2]]
    assert [r[:2] for r in train_rows] == [["0", "0"], ["1", "1"]]
    tags = {json.loads(line)["tag"] for line in open(out / "tensorboard" / "scalars.jsonl")}
    assert {"train/loss_cup", "train/loss_disc", "train/loss_bu"} <= tags
    with np.load(bank_path) as f:  # the bank moved from the tool's values
        for k in ("bu", "cup", "disc"):
            got = trainer.state.proto_bank[k].numpy()
            assert np.all(np.isfinite(got)) and not np.array_equal(got, f[k]), k
    assert trainer.state.gen.backbone.features[0][1].mode == "tn"


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))[1:]


def test_bank_file_loads_through_prototype_bank_path(bank_path, tmp_path):
    cfg = _cfg(1, "--method", "prototype", "--use_TN")
    cfg.run.out_dir = str(tmp_path)
    cfg.method.prototype_bank_path = str(bank_path)
    trainer = Trainer(cfg, device="cpu")
    try:
        with np.load(bank_path) as f:
            for k in ("bu", "cup", "disc"):
                np.testing.assert_array_equal(trainer.state.proto_bank[k].numpy(), f[k])
    finally:
        trainer.close()


def test_resume_with_transnorm_and_bank_is_exact(straight, tmp_path):
    """1 epoch, then a resume for 1 more: the same metrics, weights,
    TransNorm buffers and bank, bitwise, as 2 epochs run straight."""
    ref, cfg2 = straight
    first = _run_cli(tmp_path, "first", _with(cfg2, max_epoch=1))
    assert first.iteration == 0
    resumed = _run_cli(tmp_path, "second", cfg2, "--resume",
                       str(tmp_path / "first" / "checkpoints"))
    assert resumed.epoch_stats[0]["epoch"] == 1 and resumed.epoch_stats[0]["proto_phase"]
    got = [r[:11] for r in _rows(tmp_path / "second" / "log.csv")]
    want = [r[:11] for r in _rows(Path(ref.cfg.run.out_dir) / "log.csv") if r[0] == "1"]
    assert got == want and len(got) == 2
    sd_ref, sd = ref.state.gen.state_dict(), resumed.state.gen.state_dict()
    assert any(k.endswith("running_var_target") for k in sd)
    for k in sd_ref:
        assert torch.equal(sd_ref[k], sd[k]), k
    for k in ref.state.proto_bank:
        assert torch.equal(ref.state.proto_bank[k], resumed.state.proto_bank[k]), k


def test_initial_model_is_the_generator_after_initial_resume(tmp_path):
    """pseudo_from_initial freezes the generator as merged from
    ``initial_resume`` (trainer.py:181-191), not its random init."""
    donor = create_train_state(Config(), seed=11, device="cpu", method="prototype")
    path = ckpt_lib.save_checkpoint(str(tmp_path / "donor"), donor, 29, 1.5, "checkpoint_30")
    cfg = _cfg(1, "--method", "prototype")
    cfg.method.pseudo_from_initial = True
    cfg.run.initial_resume = path
    cfg.run.out_dir = str(tmp_path / "run")
    trainer = Trainer(cfg, device="cpu")
    try:
        got = trainer.state.initial.state_dict()
        for k, v in donor.gen.state_dict().items():
            assert torch.equal(got[k], v), k
            assert torch.equal(trainer.state.gen.state_dict()[k], v), k
    finally:
        trainer.close()


def test_bcdm_still_raises_naming_its_roadmap_item():
    """``bcdm`` once raised here (ROADMAP A2): now its step builds, and
    its state holds the second classifier (ASPP + decoder, seeded apart
    from the generator's heads) and three Adam optimizers over the
    backbone, the first and the second classifier in place of
    ``gen_opt``."""
    assert callable(make_train_step(Config(), "bcdm"))
    state = create_train_state(Config(), device="cpu", method="bcdm")
    assert state.gen_opt is None and set(state.bcdm_opt) == {"fea", "cls1", "cls2"}
    groups = {name: {id(p) for g in opt.param_groups for p in g["params"]}
              for name, opt in state.bcdm_opt.items()}
    assert groups["fea"] == {id(p) for p in state.gen.backbone.parameters()}
    assert groups["cls1"] == {id(p) for m in (state.gen.aspp, state.gen.decoder)
                              for p in m.parameters()}
    assert groups["cls2"] == {id(p) for p in state.cls2.parameters()}
    heads1, heads2 = state.gen.state_dict(), state.cls2.state_dict()
    assert set(heads2) == {k for k in heads1 if not k.startswith("backbone.")}
    assert not torch.equal(heads1["aspp.conv1.weight"], heads2["aspp.conv1.weight"])


def _with(cfg: Config, **run) -> Config:
    out = Config.from_dict(cfg.to_dict())
    for k, v in run.items():
        setattr(out.run, k, v)
    return out


def test_pseudo_from_initial_survives_a_checkpoint(tmp_path):
    cfg = _cfg(1, "--method", "prototype")
    cfg.method.pseudo_from_initial = True
    cfg.method.use_weight_rectify = True
    cfg.method.bank_use_bu = False
    cfg.run.out_dir = str(tmp_path / "run")
    trainer = Trainer(cfg, device="cpu")
    try:
        st = trainer.state
        init_before = {k: v.clone() for k, v in st.initial.state_dict().items()}
        assert all(not p.requires_grad for p in st.initial.parameters())
        step = make_train_step(cfg, "prototype", proto_phase=True)
        batch = {k: torch.from_numpy(v) for k, v in _batch(np.random.default_rng(0)).items()}
        st, m = step(st, batch, 1e-3, 2.5e-5, 30)
        assert set(m) >= {"loss_cup", "loss_disc"} and "loss_bu" not in m
        for k, v in st.initial.state_dict().items():  # never updated
            assert torch.equal(v, init_before[k]), k
        moved = [k for k, v in st.gen.state_dict().items() if not torch.equal(v, init_before[k])]
        assert moved  # the generator trained away from it
        path = ckpt_lib.save_checkpoint(str(tmp_path / "ck"), st, 0, 0.0, "checkpoint_1")
    finally:
        trainer.close()
    fresh = create_train_state(cfg, seed=9, device="cpu", method="prototype")
    ckpt_lib.load_state_dict(fresh, ckpt_lib.load_file(path))
    for k, v in fresh.initial.state_dict().items():
        assert torch.equal(v, init_before[k]), k
    for k, v in fresh.proto_bank.items():
        assert torch.equal(v, st.proto_bank[k]), k
    no_initial = create_train_state(_cfg(1, "--method", "prototype"), device="cpu",
                                    method="prototype")
    with pytest.raises(ValueError, match="initial model"):
        ckpt_lib.load_state_dict(no_initial, ckpt_lib.load_file(path))


def _batch(rng, b=2, size=64):
    return {
        "image_s": rng.standard_normal((b, size, size, 3)).astype(np.float32),
        "map_s": (rng.uniform(0, 1, (b, size, size, 2)) > 0.5).astype(np.float32),
        "boundary_s": rng.uniform(0, 1, (b, size, size, 1)).astype(np.float32),
        "image_t": rng.standard_normal((b, size, size, 3)).astype(np.float32),
    }


@pytest.mark.parametrize("norm", ["bn", "tn"])
def test_slow_mc_step_equals_fast_step_with_dropout_off(norm):
    """mc_fast=False (T/2 repeated-batch forwards of the model) against the
    fast MC pass (inline under bn, standalone under tn), dropout off: the
    same metrics up to the twin's float32 reassociation."""
    prev = layers.dropout_impl()
    layers.set_dropout_impl("off")
    try:
        out = []
        for fast in (True, False):
            cfg = Config()
            cfg.model.norm = norm
            cfg.method.mc_samples = 2
            cfg.method.mc_fast = fast
            state = create_train_state(cfg, seed=4, device="cpu", method="prototype_full")
            with torch.no_grad():  # spread the logits across the pseudo-label threshold
                state.gen.decoder.last_conv[3].weight.mul_(10.0)
            batch = {k: torch.from_numpy(v) for k, v in _batch(np.random.default_rng(1)).items()}
            state, m = make_train_step(cfg, "prototype_full", proto_phase=True)(
                state, batch, 1e-5, 2.5e-5)
            out.append({k: float(v) for k, v in m.items() if k != "_viz"})
    finally:
        layers.set_dropout_impl(prev)
    fast_m, slow_m = out
    assert fast_m.keys() == slow_m.keys()
    # measured: loss_intra 3.9e-6 apart under bn, 8.9e-8 under tn; the rest equal
    for k in fast_m:
        assert math.isclose(slow_m[k], fast_m[k], rel_tol=2e-5), (k, slow_m[k], fast_m[k])
