"""The Xception cell's reference and K4 byte count, and the host-fed cell's
feed, at 64^2, B 2 + 2, float32 on the CPU.

* ``reference/clr_deeplab_xception.py`` against the port: from the same
  weights, batches and seed they take the same first step (the losses,
  every gradient, the running statistics, the MC std map), as
  ``test_bench_reference.py`` holds the other backbones.
* ``kernel.k4_roofline_pct``'s byte count against a count by hand of
  Xception's norm sites and the MC suffix.
* ``feeds/hostfed.py``: the batches its serial replay rebuilds equal, byte
  for byte, what the loaders' workers delivered; the reference trained on
  them passes the cell's check, and trained on a replay with the first
  source and target images exchanged fails it; a whole traced run of the
  cell is ``correct`` and reads the loop's wait.

On the card (``python -m pytest -m cuda benchmark/tests``) a whole run of
each of the two cells at 128^2, B 4 + 4, T 8, bf16, untraced and traced.
"""

from __future__ import annotations

import numpy as np
import pytest

from benchmark.harness import check, core, sides
from conftest import small_copy

SEED = 2**31 + 11  # a seed above 32 signed bits


def _first_steps(cell, root, seed, keep=None):
    """The program's first steps of ``cell`` through its feed; returns
    (config, traffic, the feed, the program's readings, the replay keys).
    ``keep``: a list that receives what each pull delivered on the host."""
    spec, config, traffic = core.load_cell(cell, root)
    feed = core.load_py("feeds", traffic["feed"], root).Feed(traffic, config, seed, "cpu")
    if keep is not None:
        take = feed.take

        def recorded():
            host = take()
            keep.append({k: v.copy() for k, v in host.items()})
            return host

        feed.take = recorded
    program = sides.Program(config, traffic, seed, "cpu")
    try:
        prog, keys = core.first_steps(core.Loop(feed, program, core.Record(config, traffic,
                                                                           "cpu", 2)))
    finally:
        feed.close()
    return spec, config, traffic, feed, prog, keys


def test_xception_reference_follows_the_port(small):
    _, config, traffic, feed, prog, keys = _first_steps("clr-xception-staged", small, 11)
    ref = sides.reference_readings(config, traffic, 11, "cpu", [feed.replay(k) for k in keys])
    numbers = check.compare(prog, ref)
    # measured: loss1 0, grad 1.6e-6, stats1 0, viz 1.2e-8, std 2.5e-11
    assert numbers["loss1"][0] < 1e-5, numbers["loss1"]
    assert numbers["grad"][0] < 1e-4, numbers["grad"]
    assert numbers["stats1"][0] < 1e-4, numbers["stats1"]
    viz = {k: v for k, v in numbers.items() if k.startswith("viz.")}
    assert viz and max(v[0] for v in viz.values()) < 1e-4, viz
    assert numbers["std"][0] < 1e-4, numbers["std"]
    # later steps only within float32's chaos after Adam's first step
    # (measured: change_median 0.011 gen, 0.0065 dis, 0.012 dis2)
    for m in ("gen", "dis", "dis2"):
        assert numbers[f"change_median.{m}"][0] < 0.1, m
    assert set(prog["losses"][0]) == set(ref["losses"][0])
    assert len(ref["stats1"]) == 2 * 142  # every norm site's running mean and variance


def _xception_sites(s: int) -> list[tuple[int, int]]:
    """(channels, side) of each of Xception DeepLabv3+'s norm sites at
    ``s``^2, counted from the architecture: a separable conv's norm on its
    depthwise output and the norm after it, a block's shortcut norm."""
    h2, h4, h8, h16 = s // 2, s // 4, s // 8, s // 16
    sites = [(32, h2), (64, h2)]  # the stem
    # block 1, 64 -> 128: two convs at H/2, the stride-2 conv, the shortcut
    sites += [(64, h2), (128, h2), (128, h2), (128, h2), (128, h4), (128, h4), (128, h4)]
    # block 2, 128 -> 256
    sites += [(128, h4), (256, h4), (256, h4), (256, h4), (256, h8), (256, h8), (256, h8)]
    # block 3, 256 -> 728
    sites += [(256, h8), (728, h8), (728, h8), (728, h8), (728, h16), (728, h16), (728, h16)]
    sites += [(728, h16)] * (16 * 3 * 2)  # the middle flow
    # block 20: 728 -> 728, 728 -> 1024, 1024 -> 1024, the shortcut
    sites += [(728, h16), (728, h16), (728, h16), (1024, h16), (1024, h16), (1024, h16),
              (1024, h16)]
    sites += [(1024, h16), (1536, h16), (1536, h16), (1536, h16), (1536, h16), (2048, h16)]
    # ASPP: four branches, the image pool, the projection; the decoder's
    # low-level projection, boundary head (2) and mask head
    sites += [(256, h16)] * 4 + [(256, 1), (256, h16)]
    sites += [(48, h4), (256, h4), (256, h4), (305, h4)]
    return sites


def test_k4_bytes_against_a_hand_count(small):
    k4 = core.load_py("metrics", "kernel.k4_roofline_pct", small)
    _, config, traffic = core.load_cell("clr-xception-staged", small)
    data = config["program"]["data"]
    n, s = 2 * data["batch_size"], data["image_size"]
    t, itemsize = config["program"]["method"]["mc_samples"], 4  # float32 here
    sites = _xception_sites(s)
    assert len(sites) == 142
    train = sum(n * c * side * side for c, side in sites) * (1 + 2 + 2 + 3)
    # the MC suffix on T / 2 copies of the S || T rows at H/4: the boundary
    # head's two norms (moments, normalize), the mask head's moments
    mc = t // 2 * n * (s // 4) ** 2 * (2 * 256 * (1 + 2) + 305)
    assert k4.k4_bytes(config, traffic) == (train + mc) * itemsize


@pytest.fixture(scope="module")
def hostfed(tmp_path_factory):
    """The host-fed cell's first steps at 64^2 B 2 + 2 (what the pulls
    delivered recorded), and the reference's readings on the serial replay
    and on a replay with the first source and target images exchanged."""
    root = small_copy(tmp_path_factory.mktemp("bench"))
    delivered = []
    spec, config, traffic, feed, prog, keys = _first_steps("clr-mbv2-hostfed", root, SEED,
                                                           delivered)
    replayed = [feed.replay_host(k) for k in keys]
    swapped = [dict(b) for b in replayed]
    first = swapped[0]
    first["image_s"], first["image_t"] = first["image_s"].copy(), first["image_t"].copy()
    first["image_s"][0], first["image_t"][0] = replayed[0]["image_t"][0], \
        replayed[0]["image_s"][0]
    readings = {name: sides.reference_readings(config, traffic, SEED, "cpu",
                                               [feed.put(b) for b in batches])
                for name, batches in (("sound", replayed), ("swapped", swapped))}
    return {"root": root, "limits": spec["limits"], "delivered": delivered,
            "replayed": replayed, "prog": prog, "ref": readings}


def test_the_replay_is_what_the_workers_delivered(hostfed):
    delivered, replayed = hostfed["delivered"], hostfed["replayed"]
    assert len(delivered) == len(replayed) == check.STEPS
    for got, again in zip(delivered, replayed):
        assert got.keys() == again.keys()
        for k in got:
            assert got[k].dtype == again[k].dtype == np.uint8, k
            assert np.array_equal(got[k], again[k]), k
    # distinct batches: the streams moved on between pulls
    assert not np.array_equal(delivered[0]["image_s"], delivered[1]["image_s"])


def test_a_swapped_replay_fails_the_check(hostfed):
    limits = hostfed["limits"]
    sound = check.compare(hostfed["prog"], hostfed["ref"]["sound"])
    swapped = check.compare(hostfed["prog"], hostfed["ref"]["swapped"])
    assert check.verdict(sound, limits), {k: sound[k][0] for k in limits}
    # measured: sound at most 0.033 (bank, limit 0.48), the rest under 0.01
    # of their limits; swapped stats1_first 0.12 (limit 0.0087) and
    # stats1_median 0.0053 (0.0016): the domains' moments moved
    failed = {k: swapped[k][0] for k, lim in limits.items() if swapped[k][0] > lim}
    assert failed, {k: swapped[k][0] for k in limits}


def test_a_traced_hostfed_run(hostfed):
    """A whole traced run of the cell on the CPU: ``correct``, and the
    loop's wait on the loaders read."""
    result = core.run_cell("clr-mbv2-hostfed", SEED, 0.5, True, "cpu", root=hostfed["root"],
                           log=lambda m: None)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0
    assert result["metrics"]["hostfeed.wait_ms"]["value"] >= 0


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", ["clr-xception-staged", "clr-mbv2-hostfed"])
def test_small_run_on_the_card(cell, trace, card, tmp_path):
    root = small_copy(tmp_path / "bench", size=128, batch=4, mc_samples=8, dtype="bfloat16")
    spec = core.load_json("workloads", cell, root)
    result = core.run_cell(cell, SEED, 1.0, trace, card, root=root, log=lambda m: None)
    assert result["device"]["platform"] == "gpu" and result["attempted"] >= 1
    assert set(result["metrics"]) <= set(spec["per_layer" if trace else "end_to_end"])
    if trace:
        assert result["device"]["busy_s"] > 0
        assert "device.idle_pct" in result["metrics"]
