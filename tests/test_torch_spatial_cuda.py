"""The ``('data', 'space')`` mesh on the card: two gloo ranks on the ``(1,
2)`` mesh sharing one card, each with the top or bottom half of every image,
against one process on it, the cases of tests/test_torch_spatial.py
(``torch_dp_ranks.SPATIAL_CASES``; 64^2,
8 + 8 images, float32 with TF32 off, dropout off) with its tolerances; and,
on a machine with two cards or more, the same with two nccl ranks, one per
card, whose halo rows cross card to card (skipped with one card).
Imports neither JAX nor the JAX package, so it runs where only PyTorch is
installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_spatial_cuda.py

Without a card every test skips. The helpers are imported by module name
(pytest puts tests/ on the path): a machine may hold another package named
``tests``."""

import pytest
import torch
import torch_dp_ranks as dp

pytestmark = pytest.mark.cuda

# tests/test_torch_spatial.py's tolerances
METRIC_ATOL = {"tight": 1e-5, "loose": 2e-3, "post": 2e-3}
STATS_ATOL = 2e-3


@pytest.fixture(scope="module")
def one():
    """The cases in one process on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        return {name: dp.run_case(name, device="cuda") for name in dp.SPATIAL_CASES}
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _ranks(one, tmp, backend):
    ranks = dp.spawn(dp.run_cases, tmp, (dp.SPATIAL_CASES, "cuda", 2), backend=backend)
    return {name: (one[name], [r[name] for r in ranks]) for name in dp.SPATIAL_CASES}


@pytest.fixture(scope="module")
def results(one, tmp_path_factory):
    return _ranks(one, tmp_path_factory.mktemp("spatial_cuda"), "gloo")


@pytest.fixture(scope="module")
def nccl_results(one, tmp_path_factory):
    if torch.cuda.device_count() < 2:
        pytest.skip("nccl ranks need two cards; this machine has one")
    return _ranks(one, tmp_path_factory.mktemp("spatial_nccl"), "nccl")


def _check(name, results):
    one, ranks = results[name]
    bad = dp.compare_case(name, one, ranks, METRIC_ATOL)
    gap = max(float((v - ranks[0]["buffers"][k]).abs().max()) for k, v in one["buffers"].items())
    if not gap <= STATS_ATOL:
        bad.append(f"running stats: largest gap {gap:.3g}")
    assert not bad, f"{name}: " + "; ".join(bad)


@pytest.mark.parametrize("name", dp.SPATIAL_CASES)
def test_spatial_ranks_on_the_card_equal_one_process(name, results):
    _check(name, results)


@pytest.mark.parametrize("name", dp.SPATIAL_CASES)
def test_nccl_ranks_on_two_cards_equal_one_process(name, nccl_results):
    _check(name, nccl_results)
