"""Data parallelism on the card: two gloo ranks sharing one card against
one process on it, the cases of tests/test_torch_parallel_steps.py (64^2,
8 + 8 images, float32 with TF32 off, dropout off) with its tolerances.
Imports neither JAX nor the JAX package, so it runs where only PyTorch is
installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_parallel_cuda.py

Without a card every test skips. The helpers are imported by module name
(pytest puts tests/ on the path): a machine may hold another package named
``tests``."""

import pytest
import torch
import torch_dp_ranks as dp

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        one = {name: dp.run_case(name, device="cuda") for name in dp.CASES}
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    ranks = dp.spawn(dp.run_cases, tmp_path_factory.mktemp("dp_cuda"), (list(dp.CASES), "cuda"))
    return {name: (one[name], [r[name] for r in ranks]) for name in dp.CASES}


@pytest.mark.parametrize("name", list(dp.CASES))
def test_two_ranks_on_the_card_equal_one_process(name, results):
    one, ranks = results[name]
    bad = dp.compare_case(name, one, ranks)
    assert not bad, f"{name}: " + "; ".join(bad)
