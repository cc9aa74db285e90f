"""Data parallelism of the port (uda_clr_tpu_torch/parallel/, the sharded
BatchLoader, the Trainer and checkpoints across processes) on the CPU:

* the loader: the union of two ranks' streams is the one-process stream bit
  for bit, on both backends, and equals the JAX package's
  ``BatchLoader(process_index=..., process_count=2)`` (numpy only, no JAX
  program); it raises JAX's errors;
* world size 1: a train step and a checkpoint launch no collective, with a
  process group of one rank or none, and compute the same bits;
* the configuration: nccl without a card or with two ranks on one card,
  a ``('data', 'space')`` mesh that is not the group's size, a mesh wider
  than the group, and several processes without a coordinator raise;
* two gloo ranks (one spawn for the file): the collectives and their
  gradients, rank 0's K1/K3 seeds against one process's, a checkpoint that
  rank 0 alone writes with each rank's generator, and the CLI in two ranks
  (one writer, parameters equal bit for bit) with a two-rank resume.

The train steps themselves: tests/test_torch_parallel_steps.py."""

import csv
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tests import torch_dp_ranks as dp
from uda_clr_tpu.data.pipeline import BatchLoader as JaxBatchLoader
from uda_clr_tpu_torch.config import Config
from uda_clr_tpu_torch.data.pipeline import BatchLoader
from uda_clr_tpu_torch.parallel import distributed as dist_lib
from uda_clr_tpu_torch.parallel import mesh, reduce
from uda_clr_tpu_torch.train import checkpoint as ckpt_lib
from uda_clr_tpu_torch.train import steps as steps_lib
from uda_clr_tpu_torch.train.state import create_train_state


class _Draws:
    """Samples that are draws of their rng (and carry their index), so a
    stream shows which key each sample took."""

    def __init__(self, n: int):
        self.n = n

    def __len__(self):
        return self.n

    def get(self, idx, rng):
        return {"image": rng.standard_normal((3, 3, 3)).astype(np.float32) + idx,
                "map": rng.uniform(size=(3, 3, 2)).astype(np.float32),
                "boundary": rng.uniform(size=(3, 3, 1)).astype(np.float32),
                "img_name": f"{idx}.png"}


def _stream(loader_cls, backend, **shard):
    loader = loader_cls(_Draws(20), 4, seed=3, num_workers=2, backend=backend, **shard)
    return list(loader.epoch(1)) + list(loader.epoch(2, start=2))


@pytest.mark.parametrize("backend", ["thread", "process"])
def test_rank_streams_union_is_the_one_process_stream(backend):
    one = _stream(BatchLoader, backend)
    ranks = [_stream(BatchLoader, backend, process_index=r, process_count=2) for r in range(2)]
    jax = [_stream(JaxBatchLoader, backend, process_index=r, process_count=2) for r in range(2)]
    assert len(one) == len(ranks[0]) == len(ranks[1]) == 5 + 3
    for i, batch in enumerate(one):
        for r in range(2):
            assert ranks[r][i]["img_name"] == jax[r][i]["img_name"]
        assert ranks[0][i]["img_name"] + ranks[1][i]["img_name"] == batch["img_name"]
        for k in ("image", "map", "boundary"):
            np.testing.assert_array_equal(
                np.concatenate([ranks[0][i][k], ranks[1][i][k]]), batch[k])
            for r in range(2):
                np.testing.assert_array_equal(ranks[r][i][k], jax[r][i][k])


@pytest.mark.parametrize("kwargs", [
    dict(batch_size=5, process_count=2),
    dict(drop_last=False, process_count=2),
    dict(process_index=2, process_count=2),
])
def test_loader_raises_jax_errors(kwargs):
    kwargs = {"batch_size": 4, **kwargs}
    with pytest.raises(ValueError) as want:
        JaxBatchLoader(_Draws(8), **kwargs)
    with pytest.raises(ValueError) as got:
        BatchLoader(_Draws(8), **kwargs)
    assert str(got.value) == str(want.value)


class _Count:
    """Counts every collective the port could launch."""

    def __init__(self, monkeypatch):
        self.calls = []
        for name in ("all_reduce", "broadcast", "barrier", "all_gather"):
            real = getattr(dist, name)
            monkeypatch.setattr(dist, name, self._wrap(name, real))

    def _wrap(self, name, real):
        def call(*args, **kwargs):
            self.calls.append(name)
            return real(*args, **kwargs)
        return call


def _small_step(tmp_path, tag: str):
    """A flagship prototype-phase step at 32^2 (1 + 1 images, T=2) and a
    checkpoint of its state; returns the metrics and the parameters."""
    cfg = Config()
    cfg.method.mc_samples = 2
    state = create_train_state(cfg, seed=0, device="cpu")
    step = steps_lib.make_train_step(cfg, "prototype_full", proto_phase=True)
    batch = dp.rows(dp.global_batch(b=1, size=32), 0, 1)
    state, m = step(state, batch, 1e-3, 2.5e-5, 30)
    m.pop("_viz")
    ckpt_lib.save_checkpoint(str(tmp_path / tag), state, 0, 0.0, "checkpoint_1")
    return m, {k: v.clone() for k, v in state.gen.state_dict().items()}


def test_world_size_one_launches_no_collective(tmp_path, monkeypatch):
    torch.set_num_threads(min(2, torch.get_num_threads()))
    count = _Count(monkeypatch)
    assert not dist.is_initialized() and dist_lib.world_size() == 1
    m0, p0 = _small_step(tmp_path, "none")
    dist_lib.initialize(f"file://{tmp_path / 'init'}", 1, 0, backend="gloo", device="cpu")
    try:
        assert dist_lib.world_size() == 1
        m1, p1 = _small_step(tmp_path, "one_rank")
    finally:
        dist_lib.shutdown()
    assert count.calls == []
    assert {k: float(v) for k, v in m0.items()} == {k: float(v) for k, v in m1.items()}
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    saved = ckpt_lib.load_file(str(tmp_path / "one_rank" / "checkpoint_1.pth.tar"))
    assert "generator_states" not in saved and "noise_generator_state" not in saved


def test_config_raises(monkeypatch):
    """nccl without CUDA, nccl with two ranks on one card (both name
    ``dist_backend: gloo``), the spatial mesh, a mesh wider than the group,
    several processes without a coordinator."""
    with pytest.raises(ValueError, match="dist_backend: gloo"):
        dist_lib.resolve_backend("nccl", "cpu", 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="dist_backend: gloo"):
        dist_lib.resolve_backend(None, "cuda", 2)
    assert dist_lib.resolve_backend("gloo", "cuda", 2) == "gloo"
    assert dist_lib.resolve_backend(None, "cuda", 1) == "nccl"
    assert dist_lib.resolve_backend(None, "cpu", 2) == "gloo"
    mesh.check_mesh((4, 2), 8)  # the ('data', 'space') mesh, ported since
    with pytest.raises(ValueError, match="dist_num_processes"):
        mesh.check_mesh((4, 2), 4)
    with pytest.raises(ValueError, match="dist_num_processes"):
        mesh.check_mesh((2,), 1)
    mesh.check_mesh(None, 1), mesh.check_mesh((1,), 2), mesh.check_mesh((2,), 2)
    cfg = Config()
    cfg.run.dist_num_processes = 2
    with pytest.raises(ValueError, match="dist_coordinator"):
        dist_lib.maybe_initialize(cfg.run, "cpu")
    assert mesh.local_rows(8, 1, 2) == slice(4, 8)
    assert dist_lib.rank_seed(12345, 0) == 12345 != dist_lib.rank_seed(12345, 1)


# ---- two gloo ranks (tests/torch_dp_ranks.py:units) ----------------------


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_units")
    return dp.spawn(dp.units, tmp, (str(tmp),)), tmp


def test_collectives_and_their_gradients(two_ranks):
    ranks, _ = two_ranks
    for r, res in enumerate(ranks):
        c = res["collectives"]
        assert torch.equal(c["sum"], torch.tensor([3.0, 6.0]))
        # d/dx_r of sum_q (q+1) * sum(all_sum(x)): 1 + 2 on every rank
        assert torch.equal(c["sum_grad"], torch.tensor([3.0, 3.0]))
        # min 0 and max 5 both on rank 0: averaged, d(lo + 2 hi) = [1, 2] there
        assert c["min_max"] == (0.0, 5.0)
        assert torch.equal(c["min_max_grad"], torch.tensor([1.0, 2.0]))
        assert c["metrics"] == {"a": 0.5, "b": 2.0}
        assert torch.equal(c["broadcast"][0], torch.zeros(3)) and c["broadcast"][1] is True
        assert c["gap_equal"] == 0.0 and c["gap_apart"] == 0.5
        assert [row.tolist() for row in c["rows"]] == [[0, 7], [1, 7]]


def test_rank_zero_draws_the_one_process_streams(two_ranks):
    """Rank 0 hands K1 and K3 the seeds one process hands them (K1's is
    PR 7's ``kernel_seed(seed, step)``); rank 1's differ."""
    ranks, _ = two_ranks
    one = dp.seeded_step(0, 1)
    assert one["k1"] == [steps_lib.kernel_seed(0, 0)] and len(one["k3"]) == 4
    assert ranks[0]["seeds"] == one
    assert set(ranks[1]["seeds"]["k1"]).isdisjoint(one["k1"])
    assert set(ranks[1]["seeds"]["k3"]).isdisjoint(one["k3"])


def test_checkpoint_written_by_rank_zero_with_each_ranks_generator(two_ranks):
    ranks, tmp = two_ranks
    assert sorted(os.listdir(tmp / "ckpt")) == ["checkpoint_1.meta.json",
                                                "checkpoint_1.pth.tar"]
    saved = ckpt_lib.load_file(str(tmp / "ckpt" / "checkpoint_1.pth.tar"))
    states = saved["generator_states"]
    assert len(states) == 2 and not torch.equal(states[0], states[1])
    assert torch.equal(saved["generator_state"], states[0])
    for res in ranks:
        assert res["checkpoint"]["restored_own"]
        assert torch.equal(res["checkpoint"]["noise_alike"], ranks[0]["checkpoint"]["noise_alike"])


def test_cli_in_two_ranks_writes_once_and_resumes(two_ranks):
    ranks, tmp = two_ranks
    run = tmp / "run"
    first, resumed = zip(*(res["cli"]["runs"] for res in ranks))
    for trained in (first, resumed):
        assert [t["world"] for t in trained] == [2, 2]
        assert [t["gap"] for t in trained] == [0.0, 0.0]  # parameters equal bit for bit
        p0, p1 = trained[0]["params"], trained[1]["params"]
        assert all(torch.equal(p0[k], p1[k]) for k in p0)
        assert trained[0]["viz_every"] == 0
    assert [(s["epoch"], s["proto_phase"]) for s in first[0]["epochs"]] == [(0, False)]
    assert [(s["epoch"], s["proto_phase"]) for s in resumed[0]["epochs"]] == [(1, True)]
    assert first[0]["iteration"] == 0 and resumed[0]["iteration"] == 1
    # global img/s: each rank counts the global batch of 2
    assert all(s["img_per_s"] > 0 and s["steps"] == 1 for s in first[1]["epochs"])
    with open(run / "log.csv") as f:
        rows = list(csv.reader(f))
    # one writer: the header, 1 step + 1 validation per epoch, 2 epochs
    assert len(rows) == 1 + 2 * 2 and [r[1] for r in rows[1:] if r[2]] == ["0", "1"]
    assert sorted(os.listdir(run / "checkpoints")) == sorted(
        f"checkpoint_{e}.{ext}" for e in (1, 2) for ext in ("meta.json", "pth.tar"))
    assert not os.path.exists(run / "tensorboard" / "images")
    with open(run / "tensorboard" / "scalars.jsonl") as f:
        steps = [json.loads(line)["step"] for line in f if '"train/loss_seg"' in line]
    assert steps == [0, 1]
