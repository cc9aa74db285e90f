"""Data parallelism of the port's train steps: two gloo ranks against one
process on the same global batch of 8 source + 8 target images at 64^2,
float32, dropout off (the CPU counterpart of tests/test_mesh_equivalence.py).

Cases: the flagship ``prototype_full`` under ``bn`` and ``tn``, and the
method surface ``bcdm``, ``mean_teacher`` (with the teacher's input noise
on, now drawn for the global batch), ``posal``, ``prototype`` (the disk
bank, with the distance-weighted pseudo-labels) and ``prototype_mt`` with
``use_trg_cons``; and under ``tn`` the one-domain batches, whose TransNorm
halves are those of the global batch: ``baseline`` (the source alone),
``bcdm`` (every forward) and ``prototype_mt`` (the augmented target
forward, its ``loss_aug`` tight). Each holds the metrics by JAX's tight/loose/post
classification, the averaged gradients, the running statistics, the
parameters after the step and the banks (tests/torch_dp_ranks.py has the
tolerances with their measured values), and requires the two ranks to hold
the same metrics, parameters, statistics and banks bit for bit.

Two groups of two ranks, spawned at once and shared by the file, run the
cases between them (each collective waits on the other rank, so one group
would idle most of its time), while this process runs the one-process
cases."""

import pytest
import torch

from tests import torch_dp_ranks as dp


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """{case: (one-process result, [rank 0's, rank 1's])}."""
    one = {}

    def single():
        threads = torch.get_num_threads()
        torch.set_num_threads(min(2, threads))
        try:
            one.update({name: dp.run_case(name) for name in dp.CASES})
        finally:
            torch.set_num_threads(threads)

    names = list(dp.CASES)
    groups = names[0::2], names[1::2]
    second = []
    first = dp.spawn(dp.run_cases, tmp_path_factory.mktemp("dp_steps"), (groups[0],),
                     meanwhile=lambda: second.extend(dp.spawn(
                         dp.run_cases, tmp_path_factory.mktemp("dp_steps"), (groups[1],),
                         meanwhile=single)))
    ranks = [{**a, **b} for a, b in zip(first, second)]
    return {name: (one[name], [r[name] for r in ranks]) for name in dp.CASES}


@pytest.mark.parametrize("name", list(dp.CASES))
def test_two_ranks_equal_one_process(name, results):
    one, ranks = results[name]
    bad = dp.compare_case(name, one, ranks)
    assert not bad, f"{name}: " + "; ".join(bad)
