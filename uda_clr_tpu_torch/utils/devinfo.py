"""Per-card peak numbers and the baseline denominator shared by the port's
benchmarks (``bench.py``, ``bench_eval.py``; the counterpart of
uda_clr_tpu/utils/devinfo.py), so a corrected peak or a new card lands in
one place.

The tables are keyed by a lower-case substring of the name that
``torch.cuda.get_device_name()`` gives, which is also the name
``nvidia-smi --query-gpu=name`` prints. An unknown card gives ``None``: its
benchmarks report no ``mfu``, and raise no error.
"""

from __future__ import annotations

# The reference's estimated A100 throughput for the flagship configuration
# (a documented estimate, not a measurement: derivation in bench.py's
# docstring and BASELINE.md). Every "vs_baseline" ratio divides by this.
A100_REFERENCE_IMG_PER_SEC = 20.0

# Dense bf16 tensor-core TFLOP/s (the data sheet's "with sparsity" figure
# halved) and HBM GB/s, from NVIDIA's H100 Tensor Core GPU data sheet: SXM5
# 1,979 / 2 and 3.35 TB/s; PCIe 1,513 / 2 and 2.0 TB/s; NVL 1,671 / 2 and
# 3.9 TB/s. Each at the part's full power limit. First match wins, so the
# NVL and PCIe names come before the SXM5's.
PEAK_TFLOPS = {
    "h100 nvl": 835.5,
    "h100 pcie": 756.5,
    "h100 80gb hbm3": 989.5,
}
PEAK_HBM_GBS = {
    "h100 nvl": 3900.0,
    "h100 pcie": 2000.0,
    "h100 80gb hbm3": 3350.0,
}


def _lookup(table: dict, name: str):
    low = name.lower()
    return next((v for k, v in table.items() if k in low), None)


def peak_tflops(name: str):
    """Dense bf16 TFLOP/s of the card called ``name``, or None."""
    return _lookup(PEAK_TFLOPS, name)


def peak_hbm_gbs(name: str):
    """HBM GB/s of the card called ``name``, or None."""
    return _lookup(PEAK_HBM_GBS, name)


def device_name(device) -> str:
    """The card's name (``torch.cuda.get_device_name``) for a CUDA device,
    else ``'cpu'``."""
    import torch

    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def power_limit_w(index: int = 0):
    """The card's power limit in watts as nvidia-smi reads it, or None where
    nvidia-smi is missing or fails (a CPU-only machine)."""
    import subprocess

    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
             f"--id={index}"], capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if proc.returncode != 0:
        return None
    try:
        return float(proc.stdout.strip().splitlines()[0])
    except (IndexError, ValueError):
        return None


def card_fields(device) -> dict:
    """The card a result was measured on, as every benchmark's JSON line
    names it: ``device_kind`` (:func:`device_name`) and ``power_limit_w``
    (None on the CPU)."""
    import torch

    device = torch.device(device)
    return {"device_kind": device_name(device),
            "power_limit_w": power_limit_w(device.index or 0) if device.type == "cuda" else None}
