"""The port's DeepLab on every backbone and output stride carries the
reference's state_dict keys, torch only: its keys and shapes equal those of
the torch transcription of the reference (tests/torch_ref.py, less
``num_batches_tracked``), it loads that module's state_dict as it is, and
its eval forward then equals the transcription's at 32^2 (float32, the same
convolutions on the CPU; measured <= 5.3e-7 of the largest entry).
So reference ``.pth.tar`` files, and the ImageNet resnet101 file in
torchvision's layout, load into the port directly."""

import numpy as np
import pytest
import torch

from tests.torch_ref import TorchDeepLab
from uda_clr_tpu_torch.models.deeplab import DeepLab

@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two torch threads (the suite runs files side by side on a few cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


CASES = [("mobilenet", 16), ("mobilenet", 8), ("resnet", 16), ("resnet", 8),
         ("xception", 16), ("xception", 8), ("drn", 8)]


@pytest.mark.parametrize("backbone, output_stride", CASES)
def test_reference_keys_load_and_forward(backbone, output_stride):
    torch.manual_seed(0)
    ref = TorchDeepLab(backbone=backbone, output_stride=output_stride).eval()
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():  # random norm affine and running stats
        for m in ref.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.weight.copy_(1.0 + 0.1 * torch.randn(c, generator=g))
                m.bias.copy_(0.1 * torch.randn(c, generator=g))
                m.running_mean.copy_(0.1 * torch.randn(c, generator=g))
                m.running_var.copy_(0.5 + torch.rand(c, generator=g))
    want_sd = {k: v for k, v in ref.state_dict().items() if not k.endswith("num_batches_tracked")}
    port = DeepLab(backbone=backbone, output_stride=output_stride)
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in want_sd.items()}
    port.load_state_dict(want_sd)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 32, 32, 3))
                         .astype(np.float32))
    with torch.no_grad():
        got = port(x, False)
        want = ref(x.permute(0, 3, 1, 2))
    for name, a, b in zip(got._fields, got, want):
        b = b.permute(0, 2, 3, 1)
        assert a.shape == b.shape, name
        err = float((a - b).abs().max() / b.abs().max())
        assert err <= 1e-5, f"{name}: {err:.2e}"
