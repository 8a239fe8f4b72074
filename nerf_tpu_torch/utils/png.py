"""A minimal PNG encoder on the standard library (``zlib`` + ``struct``)."""

from __future__ import annotations

import struct
import zlib

import numpy as np

_COLOR_TYPE = {1: 0, 3: 2, 4: 6}  # channels -> grey, RGB, RGBA


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def png_bytes(image: np.ndarray) -> bytes:
    """A uint8 (H, W), (H, W, 1), (H, W, 3) or (H, W, 4) array as the bytes
    of an 8-bit PNG (no filtering, zlib level 6)."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise ValueError(f"png_bytes wants uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[-1] not in _COLOR_TYPE:
        raise ValueError(f"png_bytes wants (H, W[, 1|3|4]), got {image.shape}")
    h, w, c = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)
    return b"".join([
        b"\x89PNG\r\n\x1a\n",
        _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)),
        _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)),
        _chunk(b"IEND", b""),
    ])


def write_png(path: str, image: np.ndarray) -> None:
    """Write ``png_bytes(image)`` to ``path``."""
    data = png_bytes(image)
    with open(path, "wb") as f:
        f.write(data)
