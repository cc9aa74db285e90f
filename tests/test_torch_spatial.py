"""The ``('data', 'space')`` mesh of the port (uda_clr_tpu_torch/parallel/
spatial.py and the layers that read across stripes) on the CPU, in gloo
ranks spawned as tests/test_torch_parallel*.py spawn them
(tests/torch_dp_ranks.py; no JAX in the ranks):

* each halo primitive, its output and its input's gradient, on 2 and 4
  stripes against the same op on the whole image in this process, in
  float64: convs at stride 1 and 2 with dilations 1, 6 and 18 (a halo wider
  than a stripe and than the image), the 7x7 stem and a strided 1x1,
  ``fixed_padding``, the max pool, bilinear align-corners up and down, the
  reflect blur, ``masked_pool_mean``, MobileNet's inverted residual (its
  expansion's norm counts the image's padding rows once) and ASPP (the
  image pool through ``space_sum``) under bn and tn with ``domains=2``,
  with their running stats, and a discriminator on its gathered input;
* ResNet-101, Aligned Xception and DRN-D-54 on 2 stripes against the
  whole image;
* the CLI with ``run.mesh_shape: [1, 2]`` in two ranks, a warmup epoch and
  a resumed prototype-phase epoch;
* the loader's stripes, on both wire formats;
* ``check_mesh``'s and ``check_stripes``' errors;
* the train step on the ``(1, 2)``, ``(2, 2)`` and ``(1, 4)`` meshes against
  one process on the same global batch (8 + 8 images at 64^2, float32,
  dropout off), for the cases of ``torch_dp_ranks.CASES`` (the flagship
  under bn and tn, bcdm, mean_teacher with its input noise, posal, the disk
  bank, prototype_mt, and under tn the baseline, whose source-only batch
  TransNorm splits over the global batch, and prototype_mt), held as
  tests/test_torch_parallel_steps.py holds the data-parallel ranks, with the metrics' tolerances of
  tests/test_mesh_spatial.py (tight 2e-5 there, 1e-5 here; loose 2e-3) and
  its absolute bound on the running stats (2e-3).

The three meshes' rank groups (2 + 4 + 4 ranks) run at once, while this
process runs the whole-image and one-process cases."""

import csv
import math
import os
from unittest import mock

import numpy as np
import pytest
import torch

from tests import torch_dp_ranks as dp
from uda_clr_tpu_torch.data.pipeline import BatchLoader
from uda_clr_tpu_torch.data.synthetic import SyntheticFundus
from uda_clr_tpu_torch.data.transforms import train_transforms
from uda_clr_tpu_torch.models import norm
from uda_clr_tpu_torch.parallel import mesh

MESHES = {"1x2": (2, 2), "2x2": (4, 2), "1x4": (4, 4)}  # name: (world, n_space)

# the primitives against the whole op, relative to the largest entry: pure
# halo ops in float64 (measured <= 2.4e-15 output, 6.4e-16 gradient), ops
# through a norm, whose moments are float32 sums in another order (measured
# <= 6.8e-7 output, 3.0e-7 gradient), running stats (measured <= 5.1e-7)
PURE_RTOL, NORM_RTOL, PRIM_STATS_RTOL = 1e-12, 4e-6, 2e-6
# the steps, measured over the three meshes and seven cases: the metrics by
# JAX's classes (tight <= 4.3e-6, tn's loss_seg; loose <= 4.6e-6,
# loss_aug; post <= 1.8e-5, bcdm's loss_cdd_after), the running stats'
# largest absolute gap (tests/test_mesh_spatial.py's 2e-3; measured <=
# 8.7e-4, bcdm on (1, 4)); torch_dp_ranks' own bounds hold the rest:
# gradients |diff| / |grad| <= 0.085 (bcdm, after its five updates) and
# largest <= 0.156 (tn), stats <= 6.8e-5 of their largest entry (bcdm
# 0.063), parameters' median 0 lr, banks <= 2.4e-5, discriminator <= 8.4e-8
STEP_METRIC_ATOL = {"tight": 1e-5, "loose": 2e-3, "post": 2e-3}
STEP_STATS_ATOL = 2e-3
STEP_CASES = dp.SPATIAL_CASES


def _moments_by_halves(xs, dims):
    """``norm._moments`` in one process with each sum taken as the two
    stripes' sums added, as the ranks of a (1, 2) mesh sum them."""
    out = []
    for x in xs:
        x32 = x.float()
        halves = x32.chunk(2, dim=x.dim() - 2)
        s1 = halves[0].sum(dims) + halves[1].sum(dims)
        s2 = (halves[0] * halves[0]).sum(dims) + (halves[1] * halves[1]).sum(dims)
        n = math.prod(x.shape[d] for d in dims)
        mean = s1 / n
        out.append((mean, torch.clamp(s2 / n - mean * mean, min=0.0), n))
    return out


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Every mesh's rank group at once (:func:`torch_dp_ranks.mesh_units`:
    the step cases, on (1, n) the primitives, on (1, 2) the backbones and
    the CLI after them), while this process runs the whole-image
    primitives, the one-process cases and the whole-image backbones.
    Returns (this process's results, {mesh: its ranks' results}, the
    CLI's directory)."""
    cli_tmp = tmp_path_factory.mktemp("cli")
    here, got = {}, {}

    def single():
        threads = torch.get_num_threads()
        torch.set_num_threads(min(2, threads))
        try:
            here["whole"] = dp.run_primitives()
            here["one"] = {name: dp.run_case(name) for name in STEP_CASES}
            with mock.patch.object(norm, "_moments", _moments_by_halves):
                here["backbones"] = dp.run_backbones()
        finally:
            torch.set_num_threads(threads)

    def chain(names):
        if not names:
            return single()
        name, (world, n_space) = names[0], MESHES[names[0]]
        args = (n_space, STEP_CASES) + ((str(cli_tmp),) if name == "1x2" else ())
        got[name] = dp.spawn(dp.mesh_units, tmp_path_factory.mktemp(f"mesh{name}"), args,
                             world=world, meanwhile=lambda: chain(names[1:]))

    chain(list(MESHES))
    return here, got, cli_tmp


@pytest.fixture(scope="module")
def primitives(spawned):
    """(this process's whole-image results, {stripes: each rank's}, the
    CLI's runs in two ranks, the CLI's directory)."""
    here, got, cli_tmp = spawned
    return (here["whole"], {2: [r["primitives"] for r in got["1x2"]],
                            4: [r["primitives"] for r in got["1x4"]]},
            [r["cli"] for r in got["1x2"]], cli_tmp)


@pytest.mark.parametrize("stripes", [2, 4])
@pytest.mark.parametrize("name", dp.PRIMITIVE_NAMES)
def test_primitive_equals_whole_op(name, stripes, primitives):
    whole, striped, _, _ = primitives
    want_y, want_g, want_stats, is_striped = whole[name]
    ranks = striped[stripes]
    if is_striped:
        got_y = torch.cat([r[name][0] for r in ranks], dim=2)
    else:  # a value every rank holds: the same bits on each
        got_y = ranks[0][name][0]
        assert all(torch.equal(r[name][0], got_y) for r in ranks)
    got_g = torch.cat([r[name][1] for r in ranks], dim=2)
    rtol = NORM_RTOL if want_stats else PURE_RTOL
    for what, got, want in (("output", got_y, want_y), ("gradient", got_g, want_g)):
        assert got.shape == want.shape, f"{what} {tuple(got.shape)} vs {tuple(want.shape)}"
        err = float((got - want).abs().max()) / float(want.abs().max())
        assert err <= rtol, f"{name} on {stripes} stripes: {what} {err:.3g} of its largest entry"
    for r in ranks:
        for k, v in want_stats.items():
            err = float((r[name][2][k] - v).abs().max()) / float(v.abs().max())
            assert err <= PRIM_STATS_RTOL, f"{name}: running stat {k} {err:.3g}"


def test_cli_on_the_spatial_mesh_writes_once_and_resumes(primitives):
    """The CLI with ``run.mesh_shape: [1, 2]`` in two ranks at 32^2: a warmup
    epoch, then a resume for a prototype-phase epoch; one writer, the
    parameters equal bit for bit, validation on whole images."""
    *_, cli, tmp = primitives
    first, resumed = zip(*(res["runs"] for res in cli))
    for trained in (first, resumed):
        assert [(t["world"], t["mesh"], t["gap"]) for t in trained] == [(2, True, 0.0)] * 2
        p0, p1 = trained[0]["params"], trained[1]["params"]
        assert all(torch.equal(p0[k], p1[k]) for k in p0)
    assert [(s["epoch"], s["proto_phase"]) for s in first[0]["epochs"]] == [(0, False)]
    assert [(s["epoch"], s["proto_phase"]) for s in resumed[0]["epochs"]] == [(1, True)]
    assert first[0]["iteration"] == 0 and resumed[0]["iteration"] == 1
    with open(tmp / "run" / "log.csv") as f:
        rows = list(csv.reader(f))
    # one writer: the header, 1 step + 1 validation per epoch, 2 epochs
    assert len(rows) == 1 + 2 * 2 and [r[1] for r in rows[1:] if r[2]] == ["0", "1"]
    assert sorted(os.listdir(tmp / "run" / "checkpoints")) == sorted(
        f"checkpoint_{e}.{ext}" for e in (1, 2) for ext in ("meta.json", "pth.tar"))


@pytest.mark.parametrize("backbone", dp.BACKBONES)
def test_backbone_on_two_stripes_equals_whole(backbone, spawned):
    """ResNet-101 (its 7x7 stem and -inf max pool), Aligned Xception
    (``fixed_padding`` before each depthwise conv) and DRN-D-54 (output
    stride 8) in train mode on 2 stripes of 2 + 2 images at 32^2 (float64)
    against the whole image in this process. At this size ~100 norms over
    a few values each amplify the order of their float32 sums into 1e-2 of
    the deepest outputs; the whole image here sums each norm's moments as
    two halves, as the two ranks do, which leaves the halos' own error:
    measured <= 1.4e-6 on the outputs, 4.5e-3 on the input's gradient (the
    norms' backward sums in another order), 1.8e-7 on the running stats.
    On an AMD EPYC host xception's ``high`` reads 1.005e-5 (resnet's
    6.3e-6): with the moments summed in float64 the stripes equal the
    whole image to 9.0e-12, and both float32 runs lie 1.2e-3 from that
    float64 result, so the gap is the float32 sums' order, not the halos.
    There the running stats' gap varies from call to call, 3.0e-6 to
    3.5e-5 (xception's ``block20.skipbn.running_mean``), against 1.4e-4
    for either float32 run from float64 and 1.6e-12 with float64 sums."""
    here, got, _ = spawned
    want = here["backbones"][backbone]
    ranks = [r["backbones"][backbone] for r in got["1x2"]]
    # high: measured 1.4e-6, 1.005e-5 (AMD EPYC)
    for i, (what, rtol) in enumerate((("high", 3e-5), ("low", 1e-5), ("gradient", 2e-2))):
        got = torch.cat([r[i] for r in ranks], dim=2)
        err = float((got - want[i]).abs().max()) / float(want[i].abs().max())
        assert err <= rtol, f"{backbone} {what}: {err:.3g} of its largest entry"
    for k, v in want[3].items():
        err = float((ranks[0][3][k] - v).abs().max()) / max(float(v.abs().max()), 1e-3)
        # measured 1.8e-7, 3.5e-5 (AMD EPYC)
        assert err <= 1.2e-4, f"{backbone} running stat {k}: {err:.3g}"


@pytest.mark.parametrize("wire", ["f32", "u8"])
def test_loader_stripes_join_to_the_data_index_batch(wire):
    """On a (2, 2) mesh each rank's loader gives its data index's rows of
    every global batch (as data parallelism over 2 ranks would) cut to its
    stripe of rows; the stripes of a data index join to its batch, on
    either wire format."""
    ds = SyntheticFundus(8, 36, seed=1, transform=train_transforms(32, wire=wire))

    def batches(**shard):
        return list(BatchLoader(ds, 4, seed=3, num_workers=1, **shard).epoch(0))

    for d in range(2):
        whole = batches(process_index=d, process_count=2)
        stripes = [batches(process_index=d, process_count=2, space_index=s, space_count=2)
                   for s in range(2)]
        assert len(whole) == len(stripes[0]) == 2
        for i, batch in enumerate(whole):
            for k in ("image", "map", "boundary"):
                assert stripes[0][i][k].shape[1] == 16 and stripes[0][i][k].dtype == batch[k].dtype
                np.testing.assert_array_equal(
                    np.concatenate([st[i][k] for st in stripes], axis=1), batch[k])
    with pytest.raises(ValueError, match="space_index 2"):
        BatchLoader(ds, 4, space_index=2, space_count=2)


def test_check_mesh_and_stripes_raise():
    mesh.check_mesh((2, 2), 4), mesh.check_mesh((1, 4), 4), mesh.check_mesh((4, 1), 4)
    with pytest.raises(ValueError, match="dist_num_processes 8"):
        mesh.check_mesh((4, 2), 4)
    with pytest.raises(ValueError, match="two positive integers"):
        mesh.check_mesh((0, 2), 0)
    with pytest.raises(ValueError, match=r"\('data', 'space'\)"):
        mesh.check_mesh((1, 2, 2), 4)
    mesh.check_stripes(512, 2, 16), mesh.check_stripes(64, 4, 16)
    with pytest.raises(ValueError, match="multiple of 32 .* e.g. 480 or 512"):
        mesh.check_stripes(500, 2, 16)
    with pytest.raises(ValueError, match="multiple of 64"):
        mesh.check_stripes(96, 4, 16)
    assert mesh.local_stripe(512, 1, 2) == slice(256, 512)
    assert mesh.mesh_coords(5, 2) == (2, 1)


@pytest.fixture(scope="module")
def steps(spawned):
    """{case: (one-process result, {mesh: its ranks' results})}."""
    here, got, _ = spawned
    return {case: (here["one"][case], {m: [r["cases"][case] for r in got[m]] for m in MESHES})
            for case in STEP_CASES}


@pytest.mark.parametrize("case", STEP_CASES)
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_mesh_step_equals_one_process(mesh_name, case, steps):
    one, meshes = steps[case]
    ranks = meshes[mesh_name]
    bad = dp.compare_case(case, one, ranks, STEP_METRIC_ATOL)
    gap = max(float((v - ranks[0]["buffers"][k]).abs().max()) for k, v in one["buffers"].items())
    if not gap <= STEP_STATS_ATOL:
        bad.append(f"running stats: largest gap {gap:.3g}")
    assert not bad, f"{case} on {mesh_name}: " + "; ".join(bad)
