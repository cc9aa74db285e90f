"""The port's native host augmentation (uda_clr_tpu_torch/data/native.py over
csrc/fundus_aug.cpp) against the JAX package's (uda_clr_tpu/data/native.py
over native/fundus_aug.cpp): both libraries are built here, from the same
code with native/Makefile's flags, so every comparison is bitwise
(np.array_equal, same dtype). The JAX library is built into a temporary
directory and bound through its ``UDA_CLR_NATIVE_LIB`` override, so no
other test's build of native/ can race with it.

Also: the port's transforms and loader take the native path by default
(their streams equal JAX's with native on), ``set_enabled(False)`` and
``UDA_TORCH_NATIVE=0`` give the scipy stream, and a compiler that is
missing or fails makes the port raise (it does not fall back)."""

import re
import subprocess
from pathlib import Path

import numpy as np
import pytest

from uda_clr_tpu.data import native as jax_native
from uda_clr_tpu.data import pipeline as jax_pipeline
from uda_clr_tpu.data import synthetic as jax_synthetic
from uda_clr_tpu.data import transforms as JT
from uda_clr_tpu_torch.data import native
from uda_clr_tpu_torch.data import transforms as PT
from uda_clr_tpu_torch.data.pipeline import BatchLoader
from uda_clr_tpu_torch.data.synthetic import SyntheticFundus
from uda_clr_tpu_torch.ops import cuda_build

REPO = Path(__file__).resolve().parents[1]
SEEDS = range(4)


def _same(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
    assert np.array_equal(a, b), (what, int((a != b).sum()))


def _set_jax(enabled: bool):
    jax_native._lib, jax_native._tried = None, not enabled


@pytest.fixture(scope="module")
def both_native(tmp_path_factory):
    """The JAX library built with native/Makefile's CXXFLAGS (the port's
    own flags, asserted equal) and native on in both packages."""
    make = (REPO / "native" / "Makefile").read_text()
    flags = re.search(r"^CXXFLAGS \?= (.*)$", make, re.M).group(1).split()
    assert flags == cuda_build.CXXFLAGS
    so = tmp_path_factory.mktemp("jax_native") / "libfundus_aug.so"
    subprocess.run([cuda_build.CXX, *flags, "-shared", "-o", str(so),
                    str(REPO / "native" / "fundus_aug.cpp")], check=True, capture_output=True)
    mp = pytest.MonkeyPatch()
    mp.setenv("UDA_CLR_NATIVE_LIB", str(so))
    saved = (jax_native._lib, jax_native._tried, native._enabled, native._announced)
    _set_jax(True)
    native.set_enabled(True)
    assert jax_native.available() and native.available()
    yield
    mp.undo()
    jax_native._lib, jax_native._tried, native._enabled, native._announced = saved


def _fields(rng, h, w):
    return (rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
            ((rng.random((h, w)) < 0.3) * 255).astype(np.uint8),
            rng.random((h, w)) * 2 - 1, rng.random((h, w)) * 2 - 1)


@pytest.mark.parametrize("case", ["gaussian2d", "elastic64", "elastic512", "boundary_ring"])
def test_native_equals_jax_native_bitwise(case, both_native):
    rng = np.random.default_rng(0)
    if case == "gaussian2d":
        f = rng.standard_normal((48, 56))
        for sigma, mode in ((3.0, "constant"), (5.12, "constant"), (3.0, "reflect")):
            _same(native.gaussian2d(f, sigma, mode), jax_native.gaussian2d(f, sigma, mode), mode)
    elif case.startswith("elastic"):
        size = int(case[len("elastic"):])
        img, lbl, rx, ry = _fields(rng, size, size)
        got = native.elastic(img, lbl, rx, ry, 2.0 * size, 0.08 * size)
        want = jax_native.elastic(img, lbl, rx, ry, 2.0 * size, 0.08 * size)
        _same(got[0], want[0], "image")
        _same(got[1], want[1], "label")
    else:
        for _ in range(3):
            m = (rng.random((40, 50, 2)) > 0.6).astype(np.float64)
            _same(native.boundary_ring(m, 5), jax_native.boundary_ring(m, 5))


def _datasets(n=4):
    return (jax_synthetic.SyntheticFundus(n, 92, seed=1), SyntheticFundus(n, 92, seed=1))


def _streams(jt, pt):
    jds, pds = _datasets()
    out = []
    for seed in SEEDS:
        i = seed % len(jds)
        out.append((jt(jds[i], np.random.default_rng(seed)),
                    pt(pds[i], np.random.default_rng(seed))))
    return out


@pytest.mark.parametrize("wire_fmt", ["f32", "u8"])
def test_train_transforms_equal_jax_with_native(wire_fmt, both_native):
    """With native on in both packages the port's train stream equals JAX's
    bit for bit, and it is the native stream: JAX's scipy stream differs on
    these seeds (so a port that kept the scipy path fails here)."""
    native_pairs = _streams(JT.train_transforms(64, wire_fmt), PT.train_transforms(64, wire_fmt))
    for seed, (a, b) in zip(SEEDS, native_pairs):
        assert set(a) == set(b)
        for k in a:
            if k != "img_name":
                _same(b[k], np.asarray(a[k]), (seed, k))
    _set_jax(False)
    try:
        scipy_pairs = _streams(JT.train_transforms(64, wire_fmt), JT.train_transforms(64, wire_fmt))
    finally:
        _set_jax(True)
    assert any(not np.array_equal(a["image"], s["image"])
               for (a, _), (s, _) in zip(native_pairs, scipy_pairs))


@pytest.mark.parametrize("wire_fmt", ["f32", "u8"])
def test_thread_loader_equals_jax_with_native(wire_fmt, both_native):
    jds = jax_synthetic.SyntheticFundus(6, 92, seed=1, transform=JT.train_transforms(64, wire_fmt))
    pds = SyntheticFundus(6, 92, seed=1, transform=PT.train_transforms(64, wire_fmt))
    kw = dict(shuffle=True, seed=7, drop_last=True, num_workers=2, backend="thread")
    jl, pl = jax_pipeline.BatchLoader(jds, 2, **kw), BatchLoader(pds, 2, **kw)
    for epoch in range(2):
        jb, pb = list(jl.epoch(epoch)), list(pl.epoch(epoch))
        assert len(jb) == len(pb) == 3
        for a, b in zip(jb, pb):
            assert a["img_name"] == b["img_name"]
            for k in ("image", "map", "boundary"):
                _same(b[k], a[k], (epoch, k))


def test_native_off_gives_the_scipy_stream(both_native, monkeypatch):
    """``set_enabled(False)`` and ``UDA_TORCH_NATIVE=0`` both turn the port
    to the scipy formulations: its stream then equals JAX's with JAX's
    native library off."""
    _set_jax(False)
    try:
        for turn_off in ("set_enabled", "env"):
            if turn_off == "set_enabled":
                native.set_enabled(False)
            else:
                monkeypatch.setenv(native.ENV_VAR, "0")
                monkeypatch.setattr(native, "_enabled", None)
            assert not native.available()
            for a, b in _streams(JT.train_transforms(64), PT.train_transforms(64)):
                for k in ("image", "map", "boundary"):
                    _same(b[k], a[k], (turn_off, k))
            monkeypatch.delenv(native.ENV_VAR, raising=False)
    finally:
        _set_jax(True)
        native.set_enabled(True)


@pytest.mark.parametrize("compiler", ["missing", "failing"])
def test_compiler_failure_raises(compiler, tmp_path, monkeypatch):
    """A library that does not build raises with the compiler's account
    (no silent scipy fallback), unless native is off."""
    source = tmp_path / "fundus_aug.cpp"
    source.write_text((cuda_build.CSRC / "fundus_aug.cpp").read_text() + "\n// unbuilt copy\n")
    monkeypatch.setattr(native, "LIBRARY", cuda_build.HostLibrary(str(source), {}))
    monkeypatch.setattr(cuda_build.HostLibrary, "build_dir", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "CXX", str(tmp_path / "no-such-g++")
                        if compiler == "missing" else "false")
    monkeypatch.setattr(native, "_enabled", True)
    match = "cannot build" if compiler == "missing" else "failed for"
    with pytest.raises(RuntimeError, match=match):
        native.available()
    with pytest.raises(RuntimeError, match=match):
        PT.train_transforms(64)
    native.set_enabled(False)
    assert not native.available()
    m = (np.random.default_rng(0).random((20, 30, 2)) > 0.5).astype(np.uint8)
    assert native.boundary_ring(m).shape == (20, 30)
