"""A PNG reader and writer on zlib and numpy, for the fundus datasets and
the images the tools and the Trainer write (the port needs no Pillow or
cv2).

It reads 8-bit, non-interlaced PNGs of colour types 0 (gray), 2 (RGB),
3 (palette), 4 (gray + alpha) and 6 (RGBA), with all five line filters,
and converts as Pillow does:

* ``read_rgb`` is ``Image.open(path).convert("RGB")``: gray is replicated,
  alpha dropped, a palette looked up;
* ``read_mask`` is the array of the dataset's mask image: ``convert("L")``
  of an RGB mask (Pillow's integer luma ``(R*19595 + G*38470 + B*7471 +
  0x8000) >> 16``), the palette indices of a palette mask, and the stored
  channels otherwise.

``write_png`` writes 8-bit gray ([H, W]) or RGB ([H, W, 3]) with filter 0.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError("truncated PNG chunk")
        yield kind, body
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError("PNG without IEND")


def _paeth_row(cur: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF


def _average_row(cur: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        cur[i] = (cur[i] + ((a + prev[i]) >> 1)) & 0xFF


def unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-line filters of ``height`` lines of ``stride`` bytes
    (each line prefixed by its filter type); returns [height, stride] uint8."""
    if len(raw) < height * (stride + 1):
        raise ValueError("PNG image data is shorter than its header says")
    lines = np.frombuffer(raw, np.uint8, height * (stride + 1)).reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, line = int(lines[y, 0]), lines[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:  # Sub: running sum per byte lane, modulo 256
            pad = (-stride) % bpp
            lanes = np.concatenate([line, np.zeros(pad, np.uint8)]).reshape(-1, bpp)
            cur = np.cumsum(lanes, axis=0, dtype=np.uint8).reshape(-1)[:stride]
        elif kind == 2:
            cur = line + prev
        elif kind in (3, 4):
            buf = bytearray(line.tobytes())
            (_average_row if kind == 3 else _paeth_row)(buf, prev.tobytes(), bpp)
            cur = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"unknown PNG filter type {kind}")
        out[y] = cur
        prev = out[y]
    return out


def read_png(path: str) -> tuple[np.ndarray, int, np.ndarray | None]:
    """(pixels [H, W, channels] uint8, colour type, palette [n, 3] or None)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise NotImplementedError(
            f"{path}: bit depth {depth}, colour type {ctype}, interlace {interlace}; "
            f"the reader takes 8-bit non-interlaced colour types {sorted(_CHANNELS)}")
    if ctype == 3 and palette is None:
        raise ValueError(f"{path}: palette PNG without PLTE")
    ch = _CHANNELS[ctype]
    pixels = unfilter(zlib.decompress(b"".join(idat)), height, width * ch, ch)
    return pixels.reshape(height, width, ch), ctype, palette


def _palette(pixels, palette):
    full = np.zeros((256, 3), np.uint8)
    full[: len(palette)] = palette
    return full[pixels[..., 0]]


def read_rgb(path: str) -> np.ndarray:
    """``Image.open(path).convert("RGB")`` as [H, W, 3] uint8."""
    pixels, ctype, palette = read_png(path)
    if ctype in (0, 4):
        return np.repeat(pixels[..., :1], 3, axis=2)
    if ctype == 3:
        return _palette(pixels, palette)
    return np.ascontiguousarray(pixels[..., :3])


def luma(rgb: np.ndarray) -> np.ndarray:
    """Pillow's RGB -> L conversion (integer ITU-R 601-2 luma)."""
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)


def read_mask(path: str) -> np.ndarray:
    """A mask as the fundus dataset keeps it: ``np.asarray`` of the image,
    after ``convert("L")`` when it is RGB ([H, W] for gray and palette,
    [H, W, C] for the alpha modes)."""
    pixels, ctype, _ = read_png(path)
    if ctype == 2:
        return luma(pixels)
    if ctype in (0, 3):
        return pixels[..., 0]
    return pixels


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, image: np.ndarray) -> None:
    """Write a uint8 [H, W] (gray) or [H, W, 3] (RGB, in that channel
    order) image as a non-interlaced 8-bit PNG, every line with filter 0."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or not (image.ndim == 2 or (image.ndim == 3
                                                           and image.shape[2] == 3)):
        raise ValueError(f"write_png takes uint8 [H, W] or [H, W, 3], got "
                         f"{image.dtype} {image.shape}")
    height, width = image.shape[:2]
    ctype = 0 if image.ndim == 2 else 2
    rows = np.ascontiguousarray(image).reshape(height, -1)
    raw = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1).tobytes()
    ihdr = struct.pack(">IIBBBBB", width, height, 8, ctype, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(raw, 6))
                + _chunk(b"IEND", b""))
