"""The port's data path (uda_clr_tpu_torch/data/*) against Pillow and the
JAX package's data path, with the native library off in both packages
(the scipy formulations; tests/test_torch_native.py holds the native
streams). Every comparison is
bitwise (np.array_equal on arrays of the same dtype): the port reproduces
Pillow's integer arithmetic and the JAX module's numpy/scipy calls exactly.
Images are 64^2 crops of 92^2 samples, batches of 2."""

import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image, ImageOps

from uda_clr_tpu.data import fundus as jax_fundus
from uda_clr_tpu.data import native
from uda_clr_tpu.data import pipeline as jax_pipeline
from uda_clr_tpu.data import synthetic as jax_synthetic
from uda_clr_tpu.data import transforms as JT
from uda_clr_tpu.data import wire as jax_wire
from uda_clr_tpu_torch.data import fundus, imaging, png, wire
from uda_clr_tpu_torch.data import native as port_native
from uda_clr_tpu_torch.data import transforms as PT
from uda_clr_tpu_torch.data.pipeline import BatchLoader
from uda_clr_tpu_torch.data.synthetic import SyntheticFundus

SEEDS = range(8)


@pytest.fixture(scope="module", autouse=True)
def native_off():
    """Both packages' transforms take their scipy formulation (the native
    library differs from scipy by 1 on some pixels)."""
    saved = (native._lib, native._tried)
    port_saved = port_native._enabled, port_native._announced
    native.set_enabled(False)
    port_native.set_enabled(False)
    yield
    native._lib, native._tried = saved
    port_native._enabled, port_native._announced = port_saved


def _same(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), what


# ---------------------------------------------------------------- imaging
PIL_METHODS = {"nearest": Image.NEAREST, "bilinear": Image.BILINEAR, "bicubic": Image.BICUBIC}


def _random_image(rng, rgb: bool):
    h, w = (int(v) for v in rng.integers(6, 90, 2))
    shape = (h, w, 3) if rgb else (h, w)
    if rng.random() < 0.5:
        return rng.integers(0, 256, shape, dtype=np.uint8)
    ramp = np.add.outer(np.arange(h) * 5, np.arange(w) * 3) % 256  # smooth content
    return np.broadcast_to(ramp[..., None] if rgb else ramp, shape).astype(np.uint8)


@pytest.mark.parametrize("method", ["nearest", "bilinear", "bicubic", "default"])
@pytest.mark.parametrize("seed", range(3))
def test_resize_equals_pillow(method, seed):
    rng = np.random.default_rng(seed)
    for case in range(12):
        a = _random_image(rng, rgb=bool(case % 2))
        h, w = a.shape[:2]
        # scales on both sides of 1 on each axis, as RandomScaleCrop draws them
        size = (max(1, int(rng.uniform(0.5, 1.5) * w)), max(1, int(rng.uniform(0.5, 1.5) * h)))
        pil = Image.fromarray(a)
        if method == "default":
            want, got = pil.resize(size), imaging.resize(a, size)
        else:
            want, got = pil.resize(size, PIL_METHODS[method]), imaging.resize(a, size, method)
        _same(got, np.asarray(want), (method, a.shape, size))


@pytest.mark.parametrize("seed", range(4))
def test_pad_crop_flip_rotate_equal_pillow(seed):
    rng = np.random.default_rng(seed)
    for case in range(6):
        a = _random_image(rng, rgb=bool(case % 2))
        h, w = a.shape[:2]
        pil = Image.fromarray(a)
        border, fill = int(rng.integers(0, 12)), int(rng.integers(0, 256))
        _same(imaging.expand(a, border, fill), np.asarray(ImageOps.expand(pil, border, fill)))
        x1, y1 = int(rng.integers(-4, w)), int(rng.integers(-4, h))
        box = (x1, y1, x1 + int(rng.integers(1, 50)), y1 + int(rng.integers(1, 50)))
        _same(imaging.crop(a, box), np.asarray(pil.crop(box)), box)
        _same(imaging.flip_left_right(a), np.asarray(pil.transpose(Image.FLIP_LEFT_RIGHT)))
        _same(imaging.flip_top_bottom(a), np.asarray(pil.transpose(Image.FLIP_TOP_BOTTOM)))
        sq = a[: min(h, w), : min(h, w)]
        for k in range(1, 5):
            for f in (Image.BILINEAR, Image.NEAREST):
                want = Image.fromarray(sq).rotate(k * 90, f, expand=False)
                _same(imaging.rotate90(sq, k * 90), np.asarray(want), k)
    with pytest.raises(NotImplementedError):
        imaging.rotate90(np.zeros((4, 6), np.uint8), 90)


# ------------------------------------------------------------- transforms
def _datasets(n=4, size=92, seed=1):
    return (jax_synthetic.SyntheticFundus(n, size, seed=seed),
            SyntheticFundus(n, size, seed=seed))


def test_synthetic_samples_equal_jax():
    jds, pds = _datasets(n=3, size=70, seed=5)
    assert len(jds) == len(pds) == 3
    for i in range(3):
        _same(pds[i]["image"], np.asarray(jds[i]["image"]))
        _same(pds[i]["label"], np.asarray(jds[i]["label"]))
        assert pds[i]["img_name"] == jds[i]["img_name"]


SINGLE = {
    "RandomCrop": (64,), "CenterCrop": (64,), "RandomScaleCrop": (64,), "RandomRotate": (),
    "RandomFlip": (), "elastic_transform": (), "add_salt_pepper_noise": (), "adjust_light": (),
    "eraser": (), "FixedResize": ((70, 50),), "Scale": (70,), "RandomSizedCrop": (64,),
    "ResizeImg": (48,), "Resize": (48,), "Normalize": (), "Normalize_cityscapes": (),
}


def _check_transform(jt, pt, jds, pds):
    for seed in SEEDS:
        i = seed % len(jds)
        a = jt(jds[i], np.random.default_rng(seed))
        b = pt(pds[i], np.random.default_rng(seed))
        assert set(a) == set(b)
        for k in a:
            if k == "img_name":
                assert a[k] == b[k]
            else:
                _same(b[k], np.asarray(a[k]), (seed, k))


@pytest.mark.parametrize("name", sorted(SINGLE))
def test_transform_equals_jax(name):
    jds, pds = _datasets()
    _check_transform(getattr(JT, name)(*SINGLE[name]), getattr(PT, name)(*SINGLE[name]), jds, pds)


@pytest.mark.parametrize("wire_fmt", ["f32", "u8"])
@pytest.mark.parametrize("pipeline", ["Normalize_tf", "train_transforms", "eval_transforms"])
def test_pipelines_equal_jax(pipeline, wire_fmt):
    jds, pds = _datasets()
    if pipeline == "Normalize_tf":
        jt, pt = JT.Normalize_tf(wire_fmt), PT.Normalize_tf(wire_fmt)
    else:
        jt, pt = getattr(JT, pipeline)(64, wire_fmt), getattr(PT, pipeline)(64, wire_fmt)
    _check_transform(jt, pt, jds, pds)


def test_boundary_ring_and_multilabel_equal_jax():
    rng = np.random.default_rng(0)
    for _ in range(4):
        mask = (rng.random((40, 50, 2)) > 0.7).astype(np.float64)
        _same(PT.GetBoundary()(mask), JT.GetBoundary()(mask))
        pre = rng.integers(0, 3, (20, 30))
        _same(PT.to_multilabel(pre), JT.to_multilabel(pre))
    with pytest.raises(ValueError):
        PT.Normalize_tf("f16")


# ---------------------------------------------------------------- loader
def _loader_pair(backend, shuffle=True, drop_last=True, n=6):
    jds = jax_synthetic.SyntheticFundus(n, 92, seed=1, transform=JT.train_transforms(64, "u8"))
    pds = SyntheticFundus(n, 92, seed=1, transform=PT.train_transforms(64, "u8"))
    kw = dict(shuffle=shuffle, seed=7, drop_last=drop_last, num_workers=2, backend=backend)
    return jax_pipeline.BatchLoader(jds, 2, **kw), BatchLoader(pds, 2, **kw)


def _same_batches(jb, pb):
    jb, pb = list(jb), list(pb)
    assert len(jb) == len(pb) > 0
    for a, b in zip(jb, pb):
        assert a["img_name"] == b["img_name"]
        for k in ("image", "map", "boundary"):
            _same(b[k], a[k], k)


def test_thread_loader_equals_jax_two_epochs():
    jl, pl = _loader_pair("thread")
    assert len(jl) == len(pl) == 3
    for epoch in range(2):
        _same_batches(jl.epoch(epoch), pl.epoch(epoch))
    jl, pl = _loader_pair("thread", shuffle=False, drop_last=False, n=5)
    _same_batches(jl.epoch(0), pl.epoch(0))  # final partial batch of 1


def test_process_loader_equals_jax_and_forever_resumes():
    jl, pl = _loader_pair("process")
    _same_batches(jl.epoch(1), pl.epoch(1))
    jl, pl = _loader_pair("thread")
    take = lambda it, n: [next(it) for _ in range(n)]
    _same_batches(take(jl.forever(start_batch=3), 4), take(pl.forever(start_batch=3), 4))
    # entering at batch 3 equals skipping 3 batches of a stream from 0
    _same_batches(take(pl.forever(), 7)[3:], take(pl.forever(start_batch=3), 4))


# ------------------------------------------------------------------ wire
@pytest.mark.parametrize("key", ["image", "image_s", "image_t", "map", "map_s", "map_t",
                                 "boundary", "boundary_s", "boundary_t"])
def test_wire_decode_bitwise_all_256_values(key):
    u = np.arange(256, dtype=np.uint8).reshape(16, 16)
    want = jax_wire.decode_array(key, u)
    _same(wire.decode_array(key, u), want)
    got = wire.decode_batch({key: torch.from_numpy(u)})[key].numpy()
    _same(got.view(np.uint32), want.view(np.uint32), key)  # bit patterns, not values
    if "map" not in key:
        _same(wire.encode_array(key, want), u)


def test_wire_passes_floats_and_refuses_unknown_uint8():
    x = torch.randn(2, 3)
    out = wire.decode_batch({"image_s": x, "consistency_weight": 0.5})
    assert out["image_s"] is x and out["consistency_weight"] == 0.5
    with pytest.raises(KeyError):
        wire.decode_batch({"mystery": torch.zeros(2, dtype=torch.uint8)})
    with pytest.raises(ValueError):
        wire.encode_array("image", np.full(3, 2.0, np.float32))


# ------------------------------------------------------------------- png
PIL_MODES = {"L": 1, "RGB": 3, "P": 1, "LA": 2, "RGBA": 4}


def _pil_image(mode, rng, smooth):
    h, w = 23, 37
    base = (np.add.outer(np.arange(h) * 3, np.arange(w) * 5) % 256 if smooth
            else rng.integers(0, 256, (h, w)))
    arr = np.stack([np.roll(base, i, 1) for i in range(PIL_MODES[mode])], -1).astype(np.uint8)
    if mode == "P":
        im = Image.fromarray(arr[..., 0] % 40, "P")
        im.putpalette([int(v) for v in rng.integers(0, 256, 120)])
        return im
    return Image.fromarray(arr[..., 0] if mode == "L" else arr, mode)


@pytest.mark.parametrize("mode", sorted(PIL_MODES))
def test_png_reader_equals_pillow(mode, tmp_path):
    rng = np.random.default_rng(0)
    for smooth in (False, True):
        path = str(tmp_path / f"{mode}{smooth}.png")
        _pil_image(mode, rng, smooth).save(path)
        _same(png.read_rgb(path), np.asarray(Image.open(path).convert("RGB")))
        mask = Image.open(path)
        if mask.mode == "RGB":
            mask = mask.convert("L")
        _same(png.read_mask(path), np.asarray(mask))


def _encode_png(path, arr, ctype, filters, palette=None):
    """A PNG whose line i uses filter ``filters[i % len(filters)]``."""
    h, w, bpp = arr.shape
    raw, prev, out = arr.reshape(h, w * bpp).astype(np.int64), np.zeros(w * bpp, np.int64), b""
    for y in range(h):
        f, cur = filters[y % len(filters)], raw[y]
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if f == 4:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        else:
            pred = [0, left, prev, (left + prev) // 2][f]
        out += bytes([f]) + ((cur - pred) % 256).astype(np.uint8).tobytes()
        prev = cur

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    data = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
    if palette is not None:
        data += chunk(b"PLTE", palette.tobytes())
    data += chunk(b"IDAT", zlib.compress(out)) + chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(data)


@pytest.mark.parametrize("ctype", [0, 2, 3, 4, 6])
def test_png_reader_all_five_filters(ctype, tmp_path):
    rng = np.random.default_rng(ctype)
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    arr = rng.integers(0, 256 if ctype != 3 else 16, (11, 9, ch), dtype=np.uint8)
    palette = rng.integers(0, 256, (16, 3), dtype=np.uint8) if ctype == 3 else None
    path = str(tmp_path / "f.png")
    for filters in ([0], [1], [2], [3], [4], [4, 3, 2, 1, 0, 1, 4]):
        _encode_png(path, arr, ctype, filters, palette)
        pixels, got_ctype, _ = png.read_png(path)
        assert got_ctype == ctype
        _same(pixels, arr, filters)
        _same(png.read_rgb(path), np.asarray(Image.open(path).convert("RGB")), filters)


def test_luma_equals_pillow_convert_l():
    rgb = np.random.default_rng(0).integers(0, 256, (64, 64, 3), dtype=np.uint8)
    _same(png.luma(rgb), np.asarray(Image.fromarray(rgb).convert("L")))


def _write_layout(root, n=3):
    rng = np.random.default_rng(1)
    for split in ("train", "test"):
        for sub in ("image", "mask"):
            (root / "refuge" / split / "ROIs" / sub).mkdir(parents=True)
        for i in range(n):
            img = rng.integers(0, 256, (30, 40, 3), dtype=np.uint8)
            Image.fromarray(img).save(root / "refuge" / split / "ROIs" / "image" / f"{i}.png")
            mask = np.full((30, 40), 255, np.uint8)
            mask[8:22, 10:30], mask[12:18, 15:25] = 128, 0
            m = Image.fromarray(np.stack([mask] * 3, -1)) if i % 2 else Image.fromarray(mask)
            m.save(root / "refuge" / split / "ROIs" / "mask" / f"{i}.png")


def test_fundus_dataset_equals_jax(tmp_path):
    _write_layout(tmp_path)
    jds = jax_fundus.FundusSegmentation(str(tmp_path), "refuge", "train",
                                        JT.train_transforms(32, "u8"))
    pds = fundus.FundusSegmentation(str(tmp_path), "refuge", "train",
                                    PT.train_transforms(32, "u8"))
    assert len(jds) == len(pds) == 3 and str(jds) == str(pds)
    for i in range(3):
        _same(pds[i]["image"], np.asarray(jds[i]["image"]))
        _same(pds[i]["label"], np.asarray(jds[i]["label"]))
        for seed in range(3):
            a, b = jds.get(i, np.random.default_rng(seed)), pds.get(i, np.random.default_rng(seed))
            for k in ("image", "map", "boundary"):
                _same(b[k], a[k], (i, seed, k))
    for bad in ("Drishti-GS", "refuge/../nowhere"):
        with pytest.raises(FileNotFoundError) as je:
            jax_fundus.validate_layout(str(tmp_path), bad, "train")
        with pytest.raises(FileNotFoundError) as pe:
            fundus.validate_layout(str(tmp_path), bad, "train")
        assert str(pe.value) == str(je.value)
