"""uint8 wire format for host->device batches (uda_clr_tpu/data/wire.py).

The three training tensors are exact in uint8: ``image`` is ``u/127.5 - 1``
of a uint8 image, ``map`` is binary, ``boundary`` is ``u/255`` of a blurred
uint8 ring. The loader ships them as uint8 (a quarter of the bytes) and the
train and eval steps decode on the device, bit-equal to the numpy decode.

Bit-equality needs a real IEEE divide. On the card PyTorch turns a division
by a Python scalar (or a CPU scalar tensor) into a multiply by its
reciprocal, 1 ulp off numpy on ~15% of the values; so the divisor is a 0-d
float32 tensor on the batch's own device.
"""

from __future__ import annotations

import numpy as np
import torch

# scale/offset per batch key; None means plain cast (binary masks)
_DECODE = {
    "image": (127.5, -1.0),
    "image_s": (127.5, -1.0),
    "image_t": (127.5, -1.0),
    "map": None,
    "map_s": None,
    "map_t": None,
    "boundary": (255.0, 0.0),
    "boundary_s": (255.0, 0.0),
    "boundary_t": (255.0, 0.0),
}


def _is_u8(x) -> bool:
    return getattr(x, "dtype", None) in (np.uint8, torch.uint8)


def _assert_decodable(key: str, x) -> None:
    """A uint8 array under an unknown key would pass through undecoded and
    feed 0..255 values to a loss: refuse it."""
    if _is_u8(x) and key not in _DECODE:
        raise KeyError(
            f"wire: no decode rule for uint8 batch key {key!r} "
            f"(known: {sorted(_DECODE)}) — add it to wire._DECODE"
        )


def _decode_tensor(key: str, x: torch.Tensor) -> torch.Tensor:
    rule = _DECODE[key]
    y = x.to(torch.float32)
    if rule is None:
        return y
    scale, offset = rule
    y = y / torch.tensor(scale, dtype=torch.float32, device=y.device)
    return y + offset if offset else y


def decode_batch(batch: dict) -> dict:
    """Decode the uint8 tensors of a batch to float32 on their device; other
    entries (float32 tensors, Python scalars) pass through untouched."""
    for k, v in batch.items():
        _assert_decodable(k, v)
    return {k: _decode_tensor(k, v) if _is_u8(v) else v for k, v in batch.items()}


def decode_array(key: str, x: np.ndarray) -> np.ndarray:
    """Host-side (numpy) decode of one sample or batch array."""
    x = np.asarray(x)
    _assert_decodable(key, x)
    if x.dtype != np.uint8:
        return x
    rule = _DECODE[key]
    y = x.astype(np.float32)
    if rule is None:
        return y
    scale, offset = rule
    y = y / np.float32(scale)
    return y + np.float32(offset) if offset else y


def encode_array(key: str, x: np.ndarray) -> np.ndarray:
    """Exact inverse of the decode for arrays of the float32 pipeline:
    float32 -> uint8 wire. Raises on values outside the uint8 range."""
    x = np.asarray(x)
    if x.dtype == np.uint8 or key not in _DECODE:
        return x
    rule = _DECODE[key]
    if rule is None:
        u = x
    else:
        scale, offset = rule
        u = (x - offset) * scale
    u = np.rint(u)
    if not (u.min() >= 0 and u.max() <= 255):
        raise ValueError(f"{key}: values outside uint8 wire range [{u.min()}, {u.max()}]")
    return u.astype(np.uint8)
