"""Published peaks of the cards the benchmark runs on: dense bfloat16
tensor-core FLOP/s and HBM bytes/s at the part's full power limit (NVIDIA's
H100 data sheet: SXM5 1,979 TFLOP/s with sparsity, so 989.5 dense, and 3.35
TB/s; PCIe 756.5 and 2.0 TB/s; NVL 835.5 and 3.9 TB/s). Keyed by a
lower-case part of the name ``torch.cuda.get_device_name()`` gives, the NVL
and PCIe names before the SXM5's; an unknown card has no peak."""

from __future__ import annotations

import subprocess

import torch

PEAK_FLOPS = {"h100 nvl": 835.5e12, "h100 pcie": 756.5e12, "h100 80gb hbm3": 989.5e12}
PEAK_BYTES = {"h100 nvl": 3.9e12, "h100 pcie": 2.0e12, "h100 80gb hbm3": 3.35e12}


def _lookup(table: dict, name: str):
    low = name.lower()
    return next((v for k, v in table.items() if k in low), None)


def peak_flops(name: str):
    return _lookup(PEAK_FLOPS, name)


def peak_bytes(name: str):
    return _lookup(PEAK_BYTES, name)


def device_name(device) -> str:
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type


def card_line(index: int = 0) -> str:
    """nvidia-smi's name, power limit and SM clock of card ``index``, or
    what went wrong."""
    try:
        proc = subprocess.run(["nvidia-smi", f"--id={index}",
                               "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                               "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return proc.stdout.strip() or proc.stderr.strip()
