"""An animated GIF writer on the standard library and numpy: what
``imageio.mimwrite(path, frames, duration=0.05, loop=0)`` writes for the
eval CLI's ``--gif``.

Each frame gets its own 256-colour palette: the frame's colours exactly when
it has at most 256, else a median cut of them with every pixel mapped to its
nearest entry. The pixels are LZW-coded with variable-width codes (9 to 12
bits) and a clear code when the table is full; a NETSCAPE2.0 block sets the
loop count, and each frame's graphic control block its delay.
"""

from __future__ import annotations

import struct
from typing import Iterable, List

import numpy as np


def _median_cut(colors: np.ndarray, counts: np.ndarray, n: int) -> np.ndarray:
    """Up to ``n`` representative colours of (K, 3) ``colors`` weighted by
    ``counts``: split the box of most pixels along its widest channel at the
    weighted median until there are ``n`` boxes; each box's weighted mean."""

    def entry(box):
        widest = np.ptp(colors[box], axis=0)
        return box, int(np.argmax(widest)), (counts[box].sum() if widest.max() > 0 else -1)

    boxes = [entry(np.arange(len(colors)))]
    while len(boxes) < n:
        i = max(range(len(boxes)), key=lambda k: boxes[k][2])
        if boxes[i][2] < 0:
            break
        box, axis, _ = boxes.pop(i)
        order = box[np.argsort(colors[box, axis], kind="stable")]
        cum = np.cumsum(counts[order])
        cut = int(np.clip(np.searchsorted(cum, cum[-1] / 2), 0, len(order) - 2)) + 1
        boxes += [entry(order[:cut]), entry(order[cut:])]
    return np.stack([(colors[b] * counts[b, None]).sum(0) / counts[b].sum()
                     for b, _, _ in boxes])


def quantize(frame: np.ndarray):
    """(palette (256, 3) uint8, indices (H, W) uint8) of an (H, W, 3) uint8
    frame. Past 256 colours, the median cut runs on the frame's colours
    bucketed to 5 bits a channel (each bucket at its pixels' mean colour),
    and every pixel takes its bucket's nearest palette entry."""
    flat = np.ascontiguousarray(frame[..., :3]).reshape(-1, 3).astype(np.int64)
    keys = (flat[:, 0] << 16) | (flat[:, 1] << 8) | flat[:, 2]
    uniq, inverse = np.unique(keys, return_inverse=True)
    if len(uniq) <= 256:
        palette = np.stack([(uniq >> 16) & 255, (uniq >> 8) & 255, uniq & 255], axis=1)
        index = inverse
    else:
        buckets = ((flat[:, 0] >> 3) << 10) | ((flat[:, 1] >> 3) << 5) | (flat[:, 2] >> 3)
        ids, inverse, counts = np.unique(buckets, return_inverse=True, return_counts=True)
        means = np.stack([np.bincount(inverse, flat[:, k], len(ids)) for k in range(3)],
                         axis=1) / counts[:, None]
        palette = np.clip(np.rint(_median_cut(means, counts, 256)), 0, 255)
        nearest = ((means[:, None, :] - palette[None]) ** 2).sum(-1).argmin(1)
        index = nearest[inverse]
    full = np.zeros((256, 3), np.uint8)
    full[:len(palette)] = palette
    return full, index.reshape(frame.shape[:2]).astype(np.uint8)


def lzw_encode(indices: bytes, min_code_size: int = 8) -> bytes:
    """GIF's LZW of ``indices`` (one byte a pixel), packed LSB first."""
    clear, end = 1 << min_code_size, (1 << min_code_size) + 1
    out = bytearray()
    acc = nbits = 0

    def emit(code: int, size: int) -> None:
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    def reset():
        return {bytes([i]): i for i in range(clear)}, end + 1, min_code_size + 1

    table, next_code, size = reset()
    emit(clear, size)
    prefix = b""
    for byte in indices:
        word = prefix + bytes([byte])
        if word in table:
            prefix = word
            continue
        emit(table[prefix], size)
        table[word] = next_code
        next_code += 1
        # The decoder adds its entries one code later than this table does,
        # so it widens its codes one code later: when this table's next code
        # passes the width's last value.
        if next_code > (1 << size) and size < 12:
            size += 1
        if next_code == 4096:
            emit(clear, size)
            table, next_code, size = reset()
        prefix = bytes([byte])
    if prefix:
        emit(table[prefix], size)
    emit(end, size)
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def _sub_blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\x00"


def gif_bytes(frames: Iterable[np.ndarray], delay_cs: int = 5, loop: int = 0) -> bytes:
    """The bytes of an animated GIF of (H, W, 3) uint8 ``frames``, each shown
    ``delay_cs`` hundredths of a second, looping ``loop`` times (0: forever)."""
    frames: List[np.ndarray] = [np.asarray(f) for f in frames]
    if not frames:
        raise ValueError("gif_bytes needs at least one frame")
    h, w = frames[0].shape[:2]
    parts = [b"GIF89a", struct.pack("<HHBBB", w, h, 0, 0, 0),
             b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", loop) + b"\x00"]
    for frame in frames:
        if frame.dtype != np.uint8 or frame.shape[:2] != (h, w) or frame.ndim != 3:
            raise ValueError(f"gif frames must be uint8 (H, W, 3) of one size, got "
                             f"{frame.dtype} {frame.shape}")
        palette, index = quantize(frame)
        parts += [
            b"\x21\xf9\x04\x00" + struct.pack("<H", delay_cs) + b"\x00\x00",
            b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0x87),   # local table, 256 entries
            palette.tobytes(),
            b"\x08" + _sub_blocks(lzw_encode(index.tobytes())),
        ]
    parts.append(b"\x3b")
    return b"".join(parts)


def write_gif(path: str, frames: Iterable[np.ndarray], delay_cs: int = 5, loop: int = 0) -> None:
    """Write ``gif_bytes(frames, delay_cs, loop)`` to ``path``."""
    data = gif_bytes(frames, delay_cs, loop)
    with open(path, "wb") as f:
        f.write(data)


def gif_frame_count(data: bytes) -> int:
    """The number of image descriptors in a GIF's bytes, found by walking its
    blocks (a reader's check that needs no decoder)."""
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError("not a GIF")
    flags = data[10]
    pos = 13 + (3 << ((flags & 7) + 1) if flags & 0x80 else 0)
    count = 0
    while pos < len(data):
        tag = data[pos]
        if tag == 0x3B:
            return count
        if tag == 0x21:
            pos += 2
        elif tag == 0x2C:
            count += 1
            flags = data[pos + 9]
            pos += 10 + (3 << ((flags & 7) + 1) if flags & 0x80 else 0) + 1
        else:
            raise ValueError(f"bad GIF block 0x{tag:02x} at byte {pos}")
        while data[pos]:
            pos += data[pos] + 1
        pos += 1
    raise ValueError("GIF without a trailer")
