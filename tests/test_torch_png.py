"""The port's stdlib PNG decoder (``nerf_tpu_torch/utils/png.py``) against
``imageio.v2.imread`` on PNGs this test writes: every filter type and a mix
of them, colour types 0, 2, 3 (with and without ``tRNS``), 4 and 6, bit
depths 8 and 16, several ``IDAT`` chunks and a ``gAMA`` chunk, Adam7
interlacing at every colour type and depth, and bit depths 1, 2 and 4 of
grey and palette files. The arrays must be equal, dtype and shape included.
Corrupt and truncated files and bad bit depths raise ``PNGError``.

The encoder here is the test's own (filters computed by a per-byte loop), so
a fault shared by the port's filtering writer and its decoder still shows.
"""

import io
import struct
import warnings
import zlib

import imageio.v2 as imageio
import numpy as np
import pytest

from nerf_tpu_torch.utils.png import PNGError, decode_png, png_bytes, read_png

CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(tag, data):
    return struct.pack(">I", len(data)) + tag + data + struct.pack(
        ">I", zlib.crc32(tag + data) & 0xFFFFFFFF)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else b if pb <= pc else c


def _filter(rows, bpp, filters):
    out = bytearray()
    prev = bytes(len(rows[0]))
    for r, row in enumerate(rows):
        f = filters[r % len(filters)]
        out.append(f)
        for i, x in enumerate(row):
            a = row[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[f]
            out.append((x - pred) % 256)
        prev = row
    return bytes(out)


ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2),
         (0, 1, 2, 2), (1, 0, 2, 1))


def _pack_rows(samples, depth):
    """(h, w, ch) samples -> scanlines of bytes: big-endian at 16 bits,
    sub-byte samples packed from the most significant bit, each row padded
    to a whole byte."""
    h, w = samples.shape[:2]
    flat = samples.reshape(h, -1)
    if depth == 16:
        return [bytes(r) for r in flat.astype(">u2").view(np.uint8).reshape(h, -1)]
    rows = []
    for r in flat:
        bits = "".join(format(int(v), f"0{depth}b") for v in r)
        bits += "0" * (-len(bits) % 8)
        rows.append(bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8)))
    return rows


def encode(samples, depth, ctype, filters=(0,), n_idat=1, palette=None, trns=None,
           gama=False, interlace=0):
    h, w = samples.shape[:2]
    bpp = max(1, CHANNELS[ctype] * depth // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    data = b""
    for r0, c0, dr, dc in passes:
        sub = samples[r0::dr, c0::dc]
        if sub.shape[0] and sub.shape[1]:       # an empty pass has no bytes at all
            data += _filter(_pack_rows(sub, depth), bpp, filters)
    z = zlib.compress(data, 6)
    parts = [b"\x89PNG\r\n\x1a\n",
             _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))]
    if gama:
        parts.append(_chunk(b"gAMA", struct.pack(">I", 45455)))
    if palette is not None:
        parts.append(_chunk(b"PLTE", palette.astype(np.uint8).tobytes()))
    if trns is not None:
        parts.append(_chunk(b"tRNS", trns))
    step = len(z) // n_idat + 1
    parts += [_chunk(b"IDAT", z[i:i + step]) for i in range(0, len(z), step)]
    parts.append(_chunk(b"IEND", b""))
    return b"".join(parts)


def imageio_read(data):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # Pillow on palette files with tRNS
        return imageio.imread(io.BytesIO(data))


FILTERS = [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4), (4, 3, 1, 1, 2)]
KINDS = [(8, 0), (8, 2), (8, 3), (8, 4), (8, 6), (16, 0), (16, 2), (16, 4), (16, 6)]


def _samples(depth, ctype, rng, shape=(7, 9)):
    hi = min(20, 2 ** depth) if ctype == 3 else 2 ** depth
    return rng.integers(0, hi, shape + (CHANNELS[ctype],))


@pytest.mark.parametrize("filters", FILTERS, ids=lambda f: "".join(map(str, f)))
@pytest.mark.parametrize("depth,ctype", KINDS, ids=lambda k: str(k))
def test_decoder_matches_imageio(depth, ctype, filters):
    rng = np.random.default_rng(depth * 10 + ctype)
    palette = rng.integers(0, 256, (20, 3)) if ctype == 3 else None
    data = encode(_samples(depth, ctype, rng), depth, ctype, filters, n_idat=3,
                  palette=palette, gama=True)
    want, got = imageio_read(data), decode_png(data)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("trns", [b"\x10\x80\x00", bytes(range(20))], ids=["short", "full"])
def test_palette_with_trns_matches_imageio(trns):
    """imageio (Pillow) expands a palette file to its palette's RGB and
    drops tRNS; the decoder returns the same array."""
    rng = np.random.default_rng(5)
    data = encode(_samples(8, 3, rng), 8, 3, (0, 1, 2, 3, 4), palette=rng.integers(0, 256, (20, 3)),
                  trns=trns)
    want, got = imageio_read(data), decode_png(data)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(1, 1), (1, 13), (13, 1), (40, 23), (23, 40)])
def test_diagonal_unfiltering_at_edge_shapes(shape):
    """The anti-diagonal pass at images of one row, one column, and wider or
    taller than square; RGBA through the Average and Paeth filters."""
    rng = np.random.default_rng(sum(shape))
    data = encode(_samples(8, 6, rng, shape), 8, 6, (3, 4, 0, 4, 1, 2, 3))
    np.testing.assert_array_equal(decode_png(data), imageio_read(data))


def test_filtering_writer_reads_back(tmp_path):
    """``png_bytes(..., filters)`` (the writer chip_smoke.py uses for its
    blender dataset) against imageio, and ``read_png`` of the file."""
    img = np.random.default_rng(1).integers(0, 256, (31, 17, 4), dtype=np.uint8)
    data = png_bytes(img, filters=(0, 1, 2, 3, 4))
    np.testing.assert_array_equal(imageio_read(data), img)
    path = tmp_path / "a.png"
    path.write_bytes(data)
    np.testing.assert_array_equal(read_png(str(path)), img)


def test_bad_files_raise():
    img = np.random.default_rng(2).integers(0, 256, (6, 5, 3))
    good = encode(img, 8, 2, (1,))
    corrupt = bytearray(good)
    corrupt[40] ^= 0xFF                     # inside IDAT: its CRC no longer holds
    with pytest.raises(PNGError, match="CRC"):
        decode_png(bytes(corrupt))
    with pytest.raises(PNGError, match="truncated"):
        decode_png(good[:-20])
    with pytest.raises(PNGError, match="signature"):
        decode_png(b"GIF89a" + good[6:])
    idat = good.index(b"IDAT") - 4
    (length,) = struct.unpack(">I", good[idat:idat + 4])
    cut = zlib.compress(zlib.decompress(good[idat + 8:idat + 8 + length])[:-7], 6)
    with pytest.raises(PNGError, match="truncated image data"):
        decode_png(good[:idat] + _chunk(b"IDAT", cut) + good[idat + 12 + length:])
    ihdr_end = 8 + 12 + 13
    four_bit_rgb = _chunk(b"IHDR", struct.pack(">IIBBBBB", 5, 6, 4, 2, 0, 0, 0))
    with pytest.raises(PNGError, match="bit depth"):
        decode_png(good[:8] + four_bit_rgb + good[ihdr_end:])
    interlace_2 = _chunk(b"IHDR", struct.pack(">IIBBBBB", 5, 6, 8, 2, 0, 0, 2))
    with pytest.raises(PNGError, match="interlace method"):
        decode_png(good[:8] + interlace_2 + good[ihdr_end:])
    cut_adam7 = encode(img, 8, 2, (4,), interlace=1)
    idat = cut_adam7.index(b"IDAT") - 4
    (length,) = struct.unpack(">I", cut_adam7[idat:idat + 4])
    cut = zlib.compress(zlib.decompress(cut_adam7[idat + 8:idat + 8 + length])[:-3], 6)
    with pytest.raises(PNGError, match="truncated image data"):
        decode_png(cut_adam7[:idat] + _chunk(b"IDAT", cut) + cut_adam7[idat + 12 + length:])


def _assert_like_imageio(data):
    want, got = imageio_read(data), decode_png(data)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(7, 9), (1, 1), (3, 2), (8, 8), (17, 12)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("depth,ctype", KINDS, ids=lambda k: str(k))
def test_adam7_matches_imageio(depth, ctype, shape):
    """Adam7 at every colour type and depth 8/16; the shapes leave passes
    empty (1x1 has one pass of seven, 3x2 three) and give each pass its own
    row width. Rows cycle all five filters within each pass."""
    rng = np.random.default_rng(depth * 10 + ctype + shape[0])
    palette = rng.integers(0, 256, (20, 3)) if ctype == 3 else None
    _assert_like_imageio(encode(_samples(depth, ctype, rng, shape), depth, ctype,
                                (0, 1, 2, 3, 4), n_idat=2, palette=palette, interlace=1))


@pytest.mark.parametrize("interlace", [0, 1], ids=["plain", "adam7"])
@pytest.mark.parametrize("shape", [(7, 9), (5, 13), (16, 3)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("depth,ctype", [(1, 0), (2, 0), (4, 0), (1, 3), (2, 3), (4, 3)],
                         ids=lambda k: str(k))
def test_sub_byte_depths_match_imageio(depth, ctype, shape, interlace):
    """Bit depths 1, 2 and 4 of grey and palette files: imageio gives a 1-bit
    grey file as bool, 2- and 4-bit grey scaled to 0..255 as uint8, and a
    palette file expanded to uint8 RGB. Row widths that end mid-byte, with
    and without Adam7, every filter on the 1-byte pixel distance."""
    rng = np.random.default_rng(depth * 10 + ctype + shape[1])
    palette = rng.integers(0, 256, (2 ** depth, 3)) if ctype == 3 else None
    _assert_like_imageio(encode(_samples(depth, ctype, rng, shape), depth, ctype,
                                (4, 3, 2, 1, 0), palette=palette, interlace=interlace))
