"""PyTorch/CUDA port of uda_clr_tpu for one NVIDIA H100.

The JAX package ``uda_clr_tpu`` is the reference; this package imports
nothing from it (nor JAX) and keeps its own copies of what it needs. Module
layout and names follow the reference so each counterpart is easy to find.

Entry points run on ``device="cuda"`` unless the caller asks for the CPU;
on the CPU every hand-written kernel is replaced by its plain PyTorch
version (the tests run that way).
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on; raises if CUDA is asked for but
    absent (no silent fallback to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain versions"
        )
    return device
