"""The port's evaluation and export tools (uda_clr_tpu_torch/tools/
{evaluate,export}.py) and postprocessing against the JAX package's, from
the same weights (the port's seeded init, read into JAX by its own
importer of the reference's state_dicts), at 64^2 with batches of 2 of the
synthetic dataset.

The mask logits are spread (mask_out x10) and the running stats drawn at
random (TransNorm's source and target stats apart), so that the 0.75
threshold cuts through the predictions and a model that read the wrong
stats would differ. Under TransNorm the norms' scales are halved: eval
mode's 1 + alpha averages 2 over the channels, so at random init every
norm site doubles the activations and the eval forward is ill-conditioned
(the port's own float32 logits 33% from its float64 ones, JAX's alike);
halved, they are 8.2e-6 apart, and port vs JAX 8.9e-6. Tolerances stand
beside each check with the value measured here (torch 2.13 CPU, jax 0.9
CPU at matmul precision 'highest')."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uda_clr_tpu.data import pipeline as jax_pipeline
from uda_clr_tpu.data import synthetic as jax_synthetic
from uda_clr_tpu.data import transforms as JT
from uda_clr_tpu.models.deeplab import DeepLab as JaxDeepLab
from uda_clr_tpu.tools import evaluate as jax_evaluate
from uda_clr_tpu.tools import export as jax_export
from uda_clr_tpu.utils import postprocess as jax_post
from uda_clr_tpu.convert.torch_import import convert_deeplab_state_dict
from uda_clr_tpu_torch.data import transforms as PT
from uda_clr_tpu_torch.data.pipeline import BatchLoader
from uda_clr_tpu_torch.data.png import read_png
from uda_clr_tpu_torch.data.synthetic import SyntheticFundus
from uda_clr_tpu_torch.models.deeplab import DeepLab
from uda_clr_tpu_torch.models.norm import DomainNorm2d
from uda_clr_tpu_torch.tools import evaluate, export
from uda_clr_tpu_torch.utils import postprocess

SIZE, B = 64, 2
# metric means over the 8 synthetic images: the eval forwards differ by
# float32 noise, which can flip a pixel at the 0.75 threshold; one flip
# moves a PA by 1/32768 = 3.05e-5 and a Dice by about as much. Measured:
# no flip under BN (0.0), one under TransNorm (3.08e-5); about 5 allowed
METRIC_ATOL = 1.5e-4
SERVE_ATOL = 3e-4  # probabilities, port vs JAX serving function (measured 9.1e-5)
RELOAD_ATOL = 1e-6  # the artifact vs the live model (the JAX tool's bar; measured 0.0)


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


_MODELS = {}


def models(norm):
    """(JAX model, its variables, the port's generator) under ``norm``,
    built once per module."""
    if norm not in _MODELS:
        gen = DeepLab(num_classes=2, backbone="mobilenet", seed=0, norm=norm).eval()
        rng = np.random.default_rng(1)
        with torch.no_grad():
            gen.decoder.last_conv[3].weight.mul_(10.0)
            for m in gen.modules():
                if isinstance(m, DomainNorm2d):
                    if norm == "tn":
                        m.weight.mul_(0.5)
                    for name, buf in m.named_buffers():
                        buf.copy_(torch.from_numpy(
                            rng.uniform(0.5, 1.5, buf.shape) if "var" in name
                            else rng.normal(0, 0.1, buf.shape)))
        params, stats = convert_deeplab_state_dict(gen.state_dict())
        model = JaxDeepLab(num_classes=2, backbone="mobilenet", norm=norm)
        variables = jax.tree.map(jnp.asarray, {"params": params, "batch_stats": stats})
        _MODELS[norm] = (model, variables, gen)
    return _MODELS[norm]


@pytest.mark.parametrize("dataset", ["Drishti-GS", "refuge"])
def test_postprocessing_equals_jax(dataset):
    """Bitwise, at the Drishti thresholds (disc 0.5, cup 0.1) and the
    single 0.75 threshold of the other datasets."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[:96, :96]
    for _ in range(3):
        cy, cx, r = rng.uniform(35, 60), rng.uniform(35, 60), rng.uniform(15, 30)
        blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))
        pred = np.clip(np.stack([blob * 0.9, blob], -1) + rng.normal(0, 0.1, (96, 96, 2)), 0, 1)
        got = postprocess.postprocessing(pred, dataset=dataset)
        want = jax_post.postprocessing(pred, dataset=dataset)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert 0 < got.sum() < got.size  # the blob survives, the noise does not
    np.testing.assert_array_equal(postprocess.diamond(7), jax_post.diamond(7))


def _loaders():
    jds = jax_synthetic.SyntheticFundus(8, SIZE + 28, transform=JT.eval_transforms(SIZE))
    pds = SyntheticFundus(8, SIZE + 28, transform=PT.eval_transforms(SIZE))
    kw = dict(shuffle=False, drop_last=False, num_workers=2)
    return jax_pipeline.BatchLoader(jds, B, **kw), BatchLoader(pds, B, **kw)


@pytest.mark.parametrize("post", [False, True])
@pytest.mark.parametrize("norm", ["bn", "tn"])
def test_evaluate_equals_jax(norm, post, tmp_path):
    """``evaluate`` from converted weights equals JAX's ``evaluate`` on the
    same synthetic split, with and without ``--postprocess``; with
    ``--save-viz`` both write the same files, the original images equal
    after decoding."""
    model, variables, gen = models(norm)
    jl, pl = _loaders()
    viz = post and norm == "bn"
    jdir, pdir = (str(tmp_path / "jax"), str(tmp_path / "port")) if viz else (None, None)
    want = jax_evaluate.evaluate(model, variables, jl, "Drishti-GS", post, jdir)
    got = evaluate.evaluate(gen, pl, "Drishti-GS", post, pdir)
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - float(want[k])) <= METRIC_ATOL, (k, got[k], float(want[k]))
    assert 0.0 < got["disc_dice"] < 1.0  # the threshold cuts through the predictions
    if viz:
        names = lambda d: sorted(os.path.relpath(os.path.join(r, f), d)
                                 for r, _, fs in os.walk(d) for f in fs)
        assert names(pdir) == names(jdir) and len(names(pdir)) == 16
        for name in names(pdir):
            if name.startswith("original_image"):
                assert np.array_equal(read_png(os.path.join(pdir, name))[0],
                                      read_png(os.path.join(jdir, name))[0]), name


@pytest.mark.parametrize("norm", ["bn", "tn"])
@torch.no_grad()
def test_serving_fn_equals_jax(norm):
    """The live serving function (f32 and u8 wires) equals JAX's
    ``make_serving_fn`` from the same weights; under TransNorm the source
    and target running stats are told apart."""
    model, variables, gen = models(norm)
    x = export.selftest_input("u8", B, SIZE, seed=3)
    for wire in ("f32", "u8"):
        inp = x if wire == "u8" else (x.astype(np.float32) / np.float32(127.5) - 1.0)
        want = jax.jit(jax_export.make_serving_fn(model, variables, wire))(jnp.asarray(inp))
        got = export.make_serving_fn(gen, wire)(torch.from_numpy(inp))
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == torch.float32 and got[k].shape == want[k].shape
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0,
                                       atol=SERVE_ATOL, err_msg=f"{wire} {k}")
    if norm == "tn":
        # the source and target stats are apart and not interchangeable, so
        # the agreement with JAX (target stats, alpha from both) pins them
        sd = gen.state_dict()
        swap = {"source": "target", "target": "source"}
        other = DeepLab(num_classes=2, backbone="mobilenet", seed=0, norm="tn").eval()
        other.load_state_dict({re.sub(r"(source|target)$", lambda m: swap[m.group(1)], k): v
                               for k, v in sd.items()})
        x32 = torch.from_numpy(x.astype(np.float32) / np.float32(127.5) - 1.0)
        base = export.make_serving_fn(gen)(x32)["mask_probs"]
        swapped = export.make_serving_fn(other)(x32)["mask_probs"]
        assert float(torch.max(torch.abs(swapped - base))) > 1e-2


def test_artifact_round_trip(tmp_path):
    """One TransNorm u8 artifact: it reloads and equals the live model at
    batch 2 and 3 (one program, a symbolic batch), equals the f32 model on
    the decoded input, carries its header, and a bad magic is refused
    (chip_smoke.py serves the payload with ``torch.export.load`` alone, in
    an interpreter that refuses the port)."""
    _, _, gen = models("tn")
    path = str(tmp_path / "m.uda.pt2")
    meta = {"input": {"wire": "u8"}, "norm": "tn"}
    assert export.save_artifact(export.export_serving(gen, SIZE, "u8"), path, meta) > 0
    got_meta, program = export.load_artifact(path)
    assert got_meta == meta
    served = program.module()
    for b in (2, 3):
        x = torch.from_numpy(export.selftest_input("u8", b, SIZE, seed=b))
        with torch.no_grad():
            got = served(x)
            live = export.make_serving_fn(gen, "u8")(x)
            f32 = export.make_serving_fn(gen, "f32")(x.float() / torch.tensor(127.5) - 1.0)
        assert got["mask_probs"].shape == (b, SIZE, SIZE, 2)
        assert got["boundary_probs"].shape == (b, SIZE, SIZE, 1)
        assert export.max_abs_err(got, live) <= RELOAD_ATOL
        assert export.max_abs_err(live, f32) == 0.0
    with open(path, "r+b") as f:
        f.write(b"XXXX")
    with pytest.raises(ValueError, match="bad magic"):
        export.load_artifact(path)
