"""The native host augmentation, the evaluation tool and the serving
artifact on the card machine. Imports neither JAX nor the JAX package, so
it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_native_cuda.py

Without a card every test skips. The native library is built on that
machine's host and held to the scipy formulation within the +/-1 uint8
contract of tests/test_native.py; the eval forward and the exported
program run on the card and are held to the same model on the CPU (float32,
TF32 off)."""

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from uda_clr_tpu_torch.data import native
from uda_clr_tpu_torch.data.pipeline import BatchLoader
from uda_clr_tpu_torch.data.synthetic import SyntheticFundus
from uda_clr_tpu_torch.data.transforms import eval_transforms
from uda_clr_tpu_torch.models.deeplab import DeepLab
from uda_clr_tpu_torch.models.norm import DomainNorm2d
from uda_clr_tpu_torch.tools import evaluate, export

pytestmark = pytest.mark.cuda

SIZE = 64
# card vs CPU, float32 with TF32 off: sigmoid probabilities of the x10
# mask logits (measured at batch 2 and 3 on an NVIDIA H100 80GB HBM3:
# bn 6.3e-5 and 6.6e-5, TransNorm 7.3e-5 and 1.28e-4; printed with -s)
PROB_ATOL = 3e-4
# metric means over 8 images: a threshold flip moves a PA by 1/32768
# (measured 0: no flip)
METRIC_ATOL = 3e-4


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _model(norm="bn"):
    """The seeded model, its mask logits spread over 0.75 and its running
    stats drawn at random (TransNorm's source and target apart); under
    TransNorm with the norms' scales halved, which keeps the eval forward
    well-conditioned at random init (tests/test_torch_tools.py)."""
    gen = DeepLab(num_classes=2, backbone="mobilenet", seed=0, norm=norm).eval()
    rng = np.random.default_rng(1)
    with torch.no_grad():
        gen.decoder.last_conv[3].weight.mul_(10.0)
        for m in gen.modules():
            if isinstance(m, DomainNorm2d):
                if norm == "tn":
                    m.weight.mul_(0.5)
                for name, buf in m.named_buffers():
                    buf.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, buf.shape) if "var" in name
                                               else rng.normal(0, 0.1, buf.shape)))
    return gen


def test_native_builds_and_keeps_the_scipy_contract(card):
    """Native elastic warp and boundary ring at 512^2 against the scipy
    path: the ring equal, the warp within 1 on every pixel away from the
    image border band (tests/test_native.py's contract)."""
    assert native.available()
    rng = np.random.default_rng(0)
    h = w = 512
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    lbl = ((rng.random((h, w)) < 0.3) * 255).astype(np.uint8)
    rx, ry = rng.random((h, w)) * 2 - 1, rng.random((h, w)) * 2 - 1
    got_img, got_lbl = native.elastic(img, lbl, rx, ry, 2.0 * w, 0.08 * w)
    mask = (rng.random((h, w, 2)) > 0.5).astype(np.uint8)
    got_ring = native.boundary_ring(mask, 5)
    native.set_enabled(False)
    try:
        want_img, want_lbl = native.elastic(img, lbl, rx, ry, 2.0 * w, 0.08 * w)
        want_ring = native.boundary_ring(mask, 5)
    finally:
        native.set_enabled(True)
    assert np.array_equal(got_ring, want_ring)
    dx = ndi.gaussian_filter(rx, 0.08 * w, mode="constant", cval=0) * 2.0 * w
    dy = ndi.gaussian_filter(ry, 0.08 * w, mode="constant", cval=0) * 2.0 * w
    x, y = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    sy, sx = x + dx, y + dy
    band = ((np.abs(sy) < 1e-3) | (np.abs(sy - (h - 1)) < 1e-3)
            | (np.abs(sx) < 1e-3) | (np.abs(sx - (w - 1)) < 1e-3))
    diff = np.abs(got_img.astype(int) - want_img.astype(int)).max(-1)
    assert diff[~band].max() <= 1
    assert np.abs(got_lbl.astype(int) - want_lbl.astype(int))[~band].max() <= 1


@pytest.mark.parametrize("post", [False, True])
def test_evaluate_on_the_card_equals_the_cpu(card, post):
    metrics = {}
    for device in ("cpu", "cuda"):
        gen = _model().to(device)
        ds = SyntheticFundus(8, SIZE + 28, transform=eval_transforms(SIZE))
        loader = BatchLoader(ds, 2, shuffle=False, drop_last=False, num_workers=1)
        metrics[device] = evaluate.evaluate(gen, loader, postprocess=post)
    gap = max(abs(metrics["cuda"][k] - v) for k, v in metrics["cpu"].items())
    print(f"evaluate post={post}: card vs CPU metrics {gap:.3g} apart")
    for k, v in metrics["cpu"].items():
        assert abs(metrics["cuda"][k] - v) <= METRIC_ATOL, (k, metrics["cuda"][k], v)


@pytest.mark.parametrize("norm", ["bn", "tn"])
def test_artifact_on_the_card(card, norm, tmp_path):
    """A u8 artifact exported on the card reloads, serves batch 2 and 3 from
    one program equal to the live model (<= 1e-6), and equals the CPU
    model within PROB_ATOL."""
    gen = _model(norm).to(card)
    path = str(tmp_path / "m.uda.pt2")
    export.save_artifact(export.export_serving(gen, SIZE, "u8"), path, {"norm": norm})
    _, program = export.load_artifact(path)
    served = program.module()
    cpu_fn = export.make_serving_fn(_model(norm), "u8")
    for b in (2, 3):
        x = torch.from_numpy(export.selftest_input("u8", b, SIZE, seed=b))
        with torch.no_grad():
            got = served(x.to(card))
            live = export.make_serving_fn(gen, "u8")(x.to(card))
            on_cpu = cpu_fn(x)
        assert got["mask_probs"].device.type == "cuda"
        assert export.max_abs_err(got, live) <= 1e-6
        err = export.max_abs_err({k: v.cpu() for k, v in got.items()}, on_cpu)
        print(f"artifact {norm} batch {b}: card vs CPU {err:.3g}")
        assert err <= PROB_ATOL
