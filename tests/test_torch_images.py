"""The images the port writes (uda_clr_tpu_torch/utils/visualize.py,
data/png.py:write_png, utils/logging.py:ScalarWriter.add_image, the
Trainer's ``viz_every`` grids and ``save_val_images`` strips) against the
JAX package's, which writes through cv2, and the orbax checkpoint
converter (convert_orbax_checkpoint.py). Files are compared after decoding,
both sides read with the port's ``read_png``. The step's ``_viz`` tiles are
held to JAX's by the step tests (tests/torch_step_harness.py:check_viz, on
the prototype_full and bcdm steps)."""

import os
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

import convert_orbax_checkpoint
from tests.test_torch_trainer import _small_cfg
from uda_clr_tpu.config import Config as JaxConfig
from uda_clr_tpu.models.deeplab import DeepLab as JaxDeepLab
from uda_clr_tpu.train import checkpoint as jax_ckpt
from uda_clr_tpu.train.state import create_train_state as jax_train_state
from uda_clr_tpu.train.trainer import Trainer as JaxTrainer
from uda_clr_tpu.utils import logging as jax_logging
from uda_clr_tpu.utils import visualize as JV
from uda_clr_tpu_torch.convert.from_jax import train_state_dicts
from uda_clr_tpu_torch.data.png import read_png, write_png
from uda_clr_tpu_torch.tools import cal_prototype
from uda_clr_tpu_torch.train.trainer import Trainer
from uda_clr_tpu_torch.utils import logging as port_logging
from uda_clr_tpu_torch.utils import visualize as PV

# share of cv2's contour pixels (findContours + drawContours thickness 2)
# within one pixel of the port's outline, over 12 random filled ellipses
# (measured 1.0; the outlines' IoU 0.93)
OUTLINE_NEAR_SHARE = 0.99


@pytest.fixture(scope="module", autouse=True)
def lean_cpu():
    """Two torch threads, and no tensorboard in either package: images go
    to PNGs, as on a machine without it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        yield
    torch.set_num_threads(threads)


def _decoded(path):
    return read_png(str(path))[0]


def _files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d) for r, _, fs in os.walk(d) for f in fs)


def _same_files(port_dir, jax_dir):
    assert _files(port_dir) == _files(jax_dir)
    for name in _files(port_dir):
        a, b = _decoded(os.path.join(port_dir, name)), _decoded(os.path.join(jax_dir, name))
        assert a.shape == b.shape and np.array_equal(a, b), name


@pytest.mark.parametrize("shape", [(16, 16), (7, 9, 3)])
def test_write_png_round_trip(shape, tmp_path):
    img = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    write_png(str(tmp_path / "a.png"), img)
    got = _decoded(tmp_path / "a.png")
    assert np.array_equal(got.reshape(shape), img)
    flag = cv2.IMREAD_GRAYSCALE if len(shape) == 2 else cv2.IMREAD_COLOR
    theirs = cv2.imread(str(tmp_path / "a.png"), flag)
    assert np.array_equal(theirs if len(shape) == 2 else theirs[..., ::-1], img)
    with pytest.raises(ValueError):
        write_png(str(tmp_path / "b.png"), img.astype(np.float32))


def test_jet_heatmap_equals_cv2():
    """OpenCV's JET table built in numpy, bitwise, on every level and on
    probabilities (out-of-range values clipped as JAX's are)."""
    levels = np.arange(256).reshape(16, 16) / 255.0
    probs = np.random.default_rng(0).uniform(-0.2, 1.2, (20, 30))
    for p in (levels, probs):
        got, want = PV.construct_color_img(p), JV.construct_color_img(p)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_heatmaps_and_val_strips_equal_jax(tmp_path):
    rng = np.random.default_rng(1)
    pred = rng.uniform(0, 1, (24, 32, 2)).astype(np.float32)
    mask = (rng.uniform(0, 1, (24, 32, 2)) > 0.5).astype(np.float32)
    image = rng.uniform(0, 1, (24, 32, 3)).astype(np.float32)
    for lib, root in ((PV, tmp_path / "port"), (JV, tmp_path / "jax")):
        lib.draw_ent(pred, str(root), "a.png")
        lib.draw_mask(pred, str(root), "b.jpg")
        lib.draw_boundary(pred[..., :1], str(root), "c.png")
        strips = [lib.joint_val_image(image, pred, mask), lib.joint_val_image(image, mask, pred)]
        lib.save_val_img(str(root), 3, strips)
    assert np.array_equal(PV.joint_val_image(image, pred, mask),
                          JV.joint_val_image(image, pred, mask))
    _same_files(tmp_path / "port", tmp_path / "jax")
    assert _decoded(tmp_path / "port" / "visualization" / "epoch_3.png").shape == (48, 128, 3)


def test_save_per_img_outline_near_cv2(tmp_path):
    """The original image equals JAX's; the contour overlay's outline: the
    share of cv2's contour pixels within one pixel of the port's."""
    rng = np.random.default_rng(2)
    yy, xx = np.mgrid[:96, :96]
    shares = []
    for i in range(12):
        cy, cx = rng.uniform(35, 60, 2)
        a, b = rng.uniform(10, 30, 2)
        ell = (((yy - cy) / a) ** 2 + ((xx - cx) / b) ** 2 < 1).astype(np.float32)
        prob = np.stack([ell * 0.9, ndi.binary_dilation(ell, iterations=6) * 0.95], -1)
        patch = rng.integers(0, 256, (96, 96, 3), dtype=np.uint8)
        # the same cleaned masks as the tool's, and cv2's drawing of them
        for m in (PV._clean_mask(prob[..., 0], 0.75), PV._clean_mask(prob[..., 1], 0.75)):
            contours, _ = cv2.findContours(m, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_NONE)
            drawn = np.zeros((96, 96), np.uint8)
            cv2.drawContours(drawn, contours, -1, 1, thickness=2)
            near = ndi.binary_dilation(PV.outline(m), structure=np.ones((3, 3)))
            shares.append((drawn.astype(bool) & near).sum() / drawn.sum())
        if i == 0:
            for lib, root in ((PV, tmp_path / "port"), (JV, tmp_path / "jax")):
                lib.save_per_img(patch, str(root), "x.jpg", prob)
    assert min(shares) >= OUTLINE_NEAR_SHARE, min(shares)
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    name = os.path.join("original_image", "x.png")
    assert np.array_equal(_decoded(tmp_path / "port" / name), _decoded(tmp_path / "jax" / name))
    overlay = _decoded(tmp_path / "port" / "overlay" / "x.png")
    green = np.all(overlay == (0, 255, 0), -1)
    blue = np.all(overlay == (0, 0, 255), -1)
    assert green.sum() > 0 and blue.sum() > 0  # cup green, disc blue, as JAX's


def test_add_image_equals_jax(tmp_path):
    """``ScalarWriter.add_image`` without tensorboard: min-max normalized
    PNGs under tensorboard/images/{tag}_{step}.png, equal to JAX's."""
    rng = np.random.default_rng(3)
    images = {"A/gray": rng.normal(size=(8, 9)).astype(np.float32),
              "A/one": rng.normal(size=(8, 9, 1)).astype(np.float32),
              "B/rgb": rng.uniform(-1, 1, (8, 9, 3)).astype(np.float32),
              "B/flat": np.full((8, 9), 2.0, np.float32)}
    for lib, root in ((port_logging, tmp_path / "port"), (jax_logging, tmp_path / "jax")):
        w = lib.ScalarWriter(str(root))
        for tag, img in images.items():
            w.add_image(tag, img, 7)
        w.close()
    _same_files(tmp_path / "port" / "tensorboard" / "images",
                tmp_path / "jax" / "tensorboard" / "images")


def test_trainer_epoch_writes_the_images_of_jax(tmp_path, monkeypatch):
    """A CPU Trainer epoch of the flagship with ``viz_every`` 1 and
    ``save_val_images``: JAX's ``_write_train_images`` given the same
    batches and tiles writes the same files, bit for bit once decoded, and
    validation writes ``visualization/epoch_0.png`` (one strip per
    validation batch)."""
    cfg = _small_cfg(1)
    cfg.run.out_dir = str(tmp_path / "port")
    cfg.run.viz_every, cfg.run.save_val_images = 1, True
    calls = []
    port_write = Trainer._write_train_images

    def record(self, *args):
        calls.append(args)
        port_write(self, *args)

    monkeypatch.setattr(Trainer, "_write_train_images", record)
    trainer = Trainer(cfg, device="cpu")
    try:
        trainer.train()
    finally:
        trainer.close()
    assert len(calls) == 1 and set(calls[0][3]) == {"pred_s", "pred_b_s", "pred_t",
                                                    "bnd_t_raw"}  # a warmup step
    jax_trainer = JaxTrainer.__new__(JaxTrainer)  # the method uses the writer only
    jax_trainer.writer = jax_logging.ScalarWriter(str(tmp_path / "jax"))
    jax_trainer._write_train_images(*calls[0])
    jax_trainer.writer.close()
    images = tmp_path / "port" / "tensorboard" / "images"
    _same_files(images, tmp_path / "jax" / "tensorboard" / "images")
    assert len(_files(images)) == 13  # 7 source tags, 6 target tags at iteration 0
    strips = _decoded(tmp_path / "port" / "visualization" / "epoch_0.png")
    assert strips.shape == (64 * len(trainer.loader_val), 64 * 4, 3)


def _random_jax_state(template, rng):
    return jax.tree.map(lambda s: jnp.asarray(
        rng.normal(0, 0.1, s.shape).astype(s.dtype) if jnp.issubdtype(s.dtype, jnp.floating)
        else np.zeros(s.shape, s.dtype)), template)


def test_orbax_checkpoint_converts_and_resumes(tmp_path):
    """An orbax checkpoint of the JAX Trainer's state (random values in its
    layout, saved by JAX's ``save_checkpoint`` beside its run's
    config.yaml) converts to a ``.pth.tar`` that the port's Trainer warm
    starts and resumes from with the weights the bridge gives; the port's
    entry points name the converter when given the orbax directory."""
    jcfg = JaxConfig()
    jcfg.data.synthetic, jcfg.data.image_size, jcfg.data.batch_size = True, 64, 2
    jcfg.method.warmup_epoch = 0
    run = tmp_path / "jax_run"
    os.makedirs(run / "checkpoints")
    (run / "config.yaml").write_text(jcfg.to_yaml())
    model = JaxDeepLab(num_classes=2, backbone="mobilenet", norm="bn")
    template = jax.eval_shape(lambda: jax_train_state(model, jax.random.PRNGKey(0),
                                                      (2, 64, 64, 3), jcfg.optim))
    jstate = _random_jax_state(template, np.random.default_rng(0))
    jax_ckpt.save_checkpoint(str(run / "checkpoints"), jstate, 4, 0.25, "checkpoint_5",
                             iteration=9)
    out = tmp_path / "port_ckpt" / "checkpoint_5.pth.tar"
    convert_orbax_checkpoint.main([str(run / "checkpoints" / "checkpoint_5"), str(out)])
    want = train_state_dicts(jstate)

    cfg = _small_cfg(6)
    cfg.run.out_dir = str(tmp_path / "port_run")
    for option in ("initial_resume", "resume"):
        setattr(cfg.run, option, str(out) if option == "initial_resume"
                else str(out.parent))
        trainer = Trainer(cfg, device="cpu")
        try:
            for module, key in ((trainer.state.gen, "gen_state_dict"),
                                (trainer.state.dis, "dis_state_dict"),
                                (trainer.state.dis2, "dis2_state_dict")):
                for k, v in want[key].items():
                    assert torch.equal(module.state_dict()[k], v), (option, key, k)
            if option == "resume":
                assert (trainer.epoch, trainer.iteration) == (5, 9)
        finally:
            trainer.close()
        setattr(cfg.run, option, None)

    cfg.run.initial_resume = str(run / "checkpoints" / "checkpoint_5")
    with pytest.raises(NotImplementedError, match="convert_orbax_checkpoint.py"):
        Trainer(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="convert_orbax_checkpoint.py"):
        cal_prototype.main(["--checkpoint", str(run / "checkpoints" / "checkpoint_5"),
                            "--synthetic", "--device", "cpu"])
