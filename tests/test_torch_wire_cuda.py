"""The uint8 wire decode (uda_clr_tpu_torch/data/wire.py) on the card.
Imports neither JAX nor the JAX package, so it runs where only PyTorch is
installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_wire_cuda.py

Without a card every test skips. The decode divides by a 0-d float32
tensor on the card, a real IEEE divide, so it must equal numpy's
``x / np.float32(scale)`` bitwise; a train step fed the uint8 batch must
then see exactly the float32 batch."""

import numpy as np
import pytest
import torch

from uda_clr_tpu_torch.config import Config
from uda_clr_tpu_torch.data import wire
from uda_clr_tpu_torch.train.state import create_train_state
from uda_clr_tpu_torch.train.steps import make_train_step

pytestmark = pytest.mark.cuda

KEYS = ["image", "image_s", "image_t", "map", "map_s", "map_t",
        "boundary", "boundary_s", "boundary_t"]


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("key", KEYS)
def test_decode_on_the_card_equals_numpy_bitwise(card, key):
    u = np.arange(256, dtype=np.uint8).reshape(16, 16)
    want = wire.decode_array(key, u)
    got = wire.decode_batch({key: torch.from_numpy(u).to(card)})[key]
    assert got.device.type == "cuda" and got.dtype == torch.float32
    assert np.array_equal(got.cpu().numpy().view(np.uint32), want.view(np.uint32))


def test_uint8_and_f32_batches_give_the_same_first_step(card):
    """What the forward computes, bitwise (cuDNN deterministic): every
    metric and every batch-norm running statistic. The updated weights are
    not compared: the backward of the bilinear upsampling accumulates with
    atomics, and Adam's first step turns a near-zero gradient's sign noise
    into a full +-lr difference."""
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        cfg = Config()
        cfg.method.mc_samples = 2
        rng = np.random.default_rng(3)
        u8 = {"image_s": rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8),
              "map_s": (rng.random((2, 64, 64, 2)) > 0.5).astype(np.uint8),
              "boundary_s": rng.integers(0, 256, (2, 64, 64, 1), dtype=np.uint8),
              "image_t": rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)}
        runs = []
        for batch in ({k: torch.from_numpy(v) for k, v in u8.items()},
                      {k: torch.from_numpy(wire.decode_array(k, v)) for k, v in u8.items()}):
            state = create_train_state(cfg, seed=1, device=card)
            batch = {k: v.to(card) for k, v in batch.items()}
            state, m = make_train_step(cfg, "prototype_full", proto_phase=False)(
                state, batch, 1e-3, 2.5e-5)
            runs.append((m, dict(state.gen.named_buffers())))
        (m_u8, stats_u8), (m_f32, stats_f32) = runs
        m_u8.pop("_viz"), m_f32.pop("_viz")
        assert m_u8.keys() == m_f32.keys()
        for k in m_f32:
            assert torch.equal(m_u8[k], m_f32[k]), k
        for k in stats_f32:
            assert torch.equal(stats_u8[k], stats_f32[k]), k
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
