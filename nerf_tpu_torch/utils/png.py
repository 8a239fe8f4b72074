"""A minimal PNG encoder and decoder on the standard library (``zlib`` +
``struct``) and numpy.

The decoder reads every standard PNG the datasets can hold: bit depths 1, 2,
4 and 8 for grey (colour type 0) and palette (3) files, 8 and 16 for grey
too and for RGB (2), grey + alpha (4) and RGBA (6), plain or Adam7
interlaced, any number of ``IDAT`` chunks and all five row filters. It
returns the array ``imageio.v2.imread`` (Pillow) returns for the file: its
dtype, shape and values. So ancillary chunks are ignored: ``gAMA``, as
imageio applies no gamma, and ``tRNS``, which imageio drops when it expands
a palette to RGB. Other bit depths, CRC errors and truncated files raise
:class:`PNGError`.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPE = {1: 0, 3: 2, 4: 6}  # channels -> grey, RGB, RGBA
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples a pixel
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7: (first row, first column, row step, column step) of the seven passes.
_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2),
          (0, 1, 2, 2), (1, 0, 2, 1))


class PNGError(ValueError):
    """A PNG file this decoder cannot read: corrupt, truncated or of a kind
    it does not support."""


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _filter_rows(rows: np.ndarray, bpp: int, filters) -> np.ndarray:
    """Filter (H, stride) uint8 scanlines, row r with ``filters[r % len]``;
    returns (H, 1 + stride) with the filter byte in front of each row."""
    h, stride = rows.shape
    x = rows.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    out = np.empty((h, 1 + stride), np.uint8)
    for r in range(h):
        f = filters[r % len(filters)]
        if f == 0:
            pred = 0
        elif f == 1:
            pred = a[r]
        elif f == 2:
            pred = b[r]
        elif f == 3:
            pred = (a[r] + b[r]) >> 1
        else:
            pred = _paeth(a[r], b[r], c[r])
        out[r, 0] = f
        out[r, 1:] = (x[r] - pred) & 0xFF
    return out


def png_bytes(image: np.ndarray, filters=(0,)) -> bytes:
    """A uint8 (H, W), (H, W, 1), (H, W, 3) or (H, W, 4) array as the bytes
    of an 8-bit PNG (zlib level 6). ``filters``: the row filter types
    (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth), cycled over the rows."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise ValueError(f"png_bytes wants uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[-1] not in _COLOR_TYPE:
        raise ValueError(f"png_bytes wants (H, W[, 1|3|4]), got {image.shape}")
    h, w, c = img.shape
    if tuple(filters) == (0,):
        rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)
    else:
        rows = _filter_rows(img.reshape(h, w * c), c, tuple(filters))
    return b"".join([
        _SIGNATURE,
        _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)),
        _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)),
        _chunk(b"IEND", b""),
    ])


def write_png(path: str, image: np.ndarray, filters=(0,)) -> None:
    """Write ``png_bytes(image, filters)`` to ``path``."""
    data = png_bytes(image, filters)
    with open(path, "wb") as f:
        f.write(data)


def _paeth(a, b, c):
    """The Paeth predictor on int16 arrays."""
    da, db = a - c, b - c
    pa, pb, pc = np.abs(db), np.abs(da), np.abs(da + db)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _chunks(data: bytes):
    """Yield (tag, payload) of every chunk, checking lengths and CRCs."""
    if data[:8] != _SIGNATURE:
        raise PNGError("not a PNG file (bad signature)")
    pos = 8
    while True:
        if pos + 8 > len(data):
            raise PNGError("truncated PNG: no IEND chunk")
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        end = pos + 12 + length
        if end > len(data):
            raise PNGError(f"truncated PNG: chunk {tag!r} runs past the end of the file")
        payload = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[end - 4:end])
        if zlib.crc32(tag + payload) & 0xFFFFFFFF != crc:
            raise PNGError(f"CRC error in chunk {tag!r}")
        yield tag, payload
        if tag == b"IEND":
            return
        pos = end


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the row filters of (h, 1 + stride) filtered scanlines; returns
    (h, stride) uint8.

    Rows of None, Sub and Up alone are undone row by row, each vectorized
    (Sub as a wrapping cumulative sum over the bpp lanes). Average and Paeth
    make byte (r, c) depend on (r, c - bpp), (r - 1, c) and
    (r - 1, c - bpp); pixels on one anti-diagonal r + c/bpp = d depend only
    on earlier diagonals, so a file with such rows is undone a diagonal at a
    time, every row at once.
    """
    ftype = raw[:, 0]
    if ftype.size and ftype.max() > 4:
        raise PNGError(f"unknown row filter type {int(ftype.max())}")
    data = raw[:, 1:]
    out = np.zeros((h, stride), np.uint8)
    if not np.isin(ftype, (3, 4)).any():
        prev = np.zeros(stride, np.uint8)
        for r in range(h):
            f = ftype[r]
            row = data[r]
            if f == 1:
                row = np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
            elif f == 2:
                row = row + prev
            out[r] = row
            prev = out[r]
        return out
    w = stride // bpp
    # Skewed grid, diagonal-major: pixel (r, c) at [r + c + 2, r + 1], zeros
    # around it. Diagonal t = r + c is the contiguous row t + 2; the left and
    # up neighbours of its pixels lie on row t + 1, the up-left ones on row t.
    grid = np.zeros((h + w + 2, h + 1, bpp), np.int16)
    x = np.zeros((h + w, h, bpp), np.int16)
    rr = np.arange(h)[:, None]
    x[rr + np.arange(w), rr] = data.reshape(h, w, bpp)
    masks = [(ftype == k)[:, None].astype(np.int16) for k in range(5)]
    for t in range(h + w - 1):
        r0, r1 = max(0, t - w + 1), min(h, t + 1)
        a = grid[t + 1, r0 + 1:r1 + 1]
        b = grid[t + 1, r0:r1]
        c = grid[t, r0:r1]
        pred = (a * masks[1][r0:r1] + b * masks[2][r0:r1]
                + ((a + b) >> 1) * masks[3][r0:r1] + _paeth(a, b, c) * masks[4][r0:r1])
        np.bitwise_and(x[t, r0:r1] + pred, 0xFF, out=grid[t + 2, r0 + 1:r1 + 1])
    out = grid[rr + 2 + np.arange(w), rr + 1]
    return out.reshape(h, stride).astype(np.uint8)


def _unpack(rows: np.ndarray, width: int, channels: int, depth: int) -> np.ndarray:
    """Unfiltered (h, stride) scanlines -> (h, width, channels) samples:
    uint8 for depths up to 8 (sub-byte samples packed most significant bits
    first), (h, width, channels, 2) big-endian byte pairs for 16."""
    h = rows.shape[0]
    if depth == 16:
        return rows.reshape(h, width, channels, 2)
    if depth == 8:
        return rows.reshape(h, width, channels)
    bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    samples = (bits * weights).sum(axis=-1, dtype=np.uint8)
    return samples[:, :width * channels].reshape(h, width, channels)


def _passes(w: int, h: int, interlace: int):
    """(r0, c0, dr, dc, rows, columns) of each non-empty pass."""
    for r0, c0, dr, dc in (_ADAM7 if interlace else ((0, 0, 1, 1),)):
        ph, pw = -(-(h - r0) // dr), -(-(w - c0) // dc)
        if ph > 0 and pw > 0:
            yield r0, c0, dr, dc, ph, pw


def decode_png(data: bytes) -> np.ndarray:
    """The pixels of a PNG file's bytes, as ``imageio.v2.imread`` gives them:
    grey (H, W), grey + alpha (H, W, 2), RGB (H, W, 3) or RGBA (H, W, 4),
    palette files expanded to RGB; uint8 at bit depth 8, uint16 for 16-bit
    grey, and 16-bit colour files reduced to their high bytes (uint8),
    16-bit grey + alpha as RGBA. Sub-byte grey is ``bool`` at depth 1 and
    uint8 scaled to 0..255 at depths 2 and 4 (x85, x17); sub-byte palette
    files expand like 8-bit ones."""
    header = None
    palette = None
    idat = []
    for tag, payload in _chunks(bytes(data)):
        if tag == b"IHDR":
            if len(payload) != 13:
                raise PNGError("bad IHDR chunk")
            header = struct.unpack(">IIBBBBB", payload)
        elif tag == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(payload)
    if header is None:
        raise PNGError("no IHDR chunk")
    w, h, depth, ctype, compression, filt, interlace = header
    if ctype not in _CHANNELS or compression != 0 or filt != 0 or interlace > 1:
        raise PNGError(f"unsupported PNG: colour type {ctype}, compression {compression}, "
                       f"filter method {filt}, interlace method {interlace}")
    if depth not in _DEPTHS[ctype]:
        raise PNGError(f"unsupported bit depth {depth} for colour type {ctype}")
    if not idat:
        raise PNGError("no IDAT chunk")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise PNGError(f"corrupt image data: {e}") from None
    channels = _CHANNELS[ctype]
    bits = channels * depth                     # bits a pixel
    bpp = max(1, bits // 8)                     # the filters' byte distance
    passes = list(_passes(w, h, interlace))
    need = sum(ph * (1 + -(-pw * bits // 8)) for *_, ph, pw in passes)
    if len(raw) < need:
        raise PNGError(f"truncated image data: {len(raw)} bytes for {need}")
    shape = (h, w, channels) + ((2,) if depth == 16 else ())
    pix = np.zeros(shape, np.uint8)
    pos = 0
    for r0, c0, dr, dc, ph, pw in passes:
        stride = -(-pw * bits // 8)
        filtered = np.frombuffer(raw, np.uint8, ph * (1 + stride), pos).reshape(ph, 1 + stride)
        pos += ph * (1 + stride)
        pix[r0::dr, c0::dc] = _unpack(_unfilter(filtered, ph, stride, bpp), pw, channels, depth)
    if depth == 16:
        if ctype == 0:
            return (pix[..., 0, 0].astype(np.uint16) << 8) | pix[..., 0, 1]
        if ctype == 4:   # grey + alpha: RGBA, grey in R, G and B
            return np.ascontiguousarray(pix[..., [0, 0, 0, 1], 0])
        return np.ascontiguousarray(pix[..., 0])
    if ctype == 3:
        if palette is None:
            raise PNGError("palette image without a PLTE chunk")
        idx = pix[..., 0]
        if idx.size and idx.max() >= len(palette):
            raise PNGError(f"palette index {int(idx.max())} past the {len(palette)}-entry PLTE")
        return palette[idx]
    if ctype == 0:
        grey = pix[..., 0]
        if depth == 1:
            return grey != 0
        return grey * np.uint8(255 // (2 ** depth - 1))
    return pix


def read_png(path: str) -> np.ndarray:
    """``decode_png`` of the file at ``path``."""
    with open(path, "rb") as f:
        return decode_png(f.read())
