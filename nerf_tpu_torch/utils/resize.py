"""Area downscaling: ``cv2.resize(img, (width, height),
interpolation=cv2.INTER_AREA)`` on numpy alone.

Each output pixel is the mean of the source area it covers, weighted by the
fraction of each source pixel inside it: separable weight matrices built as
OpenCV builds its area table (``computeResizeAreaTab``), which reduce to a
box mean when the factor is an integer. ``uint8`` results are rounded as
OpenCV rounds them: half up for its factor-2 path, to the nearest even
otherwise.
"""

from __future__ import annotations

import numpy as np


def _area_weights(src: int, dst: int) -> np.ndarray:
    """(dst, src) weights: row d spreads output pixel d over the source
    pixels the interval [d * scale, (d + 1) * scale) covers."""
    scale = src / dst
    weights = np.zeros((dst, src), np.float64)
    for d in range(dst):
        f1 = d * scale
        f2 = f1 + scale
        s1 = min(int(np.ceil(f1)), src - 1)
        s2 = min(int(np.floor(f2)), src - 1)
        s1 = min(s1, s2)
        cell = min(scale, src - f1)
        if s1 - f1 > 1e-3:
            weights[d, s1 - 1] = (s1 - f1) / cell
        weights[d, s1:s2] = 1.0 / cell
        if f2 - s2 > 1e-3:
            weights[d, s2] = min(min(f2 - s2, 1.0), cell) / cell
    return weights


def resize_area(image: np.ndarray, dsize) -> np.ndarray:
    """Downscale an (H, W) or (H, W, C) float32 or uint8 image to
    ``dsize = (width, height)`` (OpenCV's order) by area averaging."""
    img = np.asarray(image)
    if img.dtype not in (np.float32, np.uint8):
        raise ValueError(f"resize_area wants float32 or uint8, got {img.dtype}")
    h, w = img.shape[:2]
    dw, dh = int(dsize[0]), int(dsize[1])
    if not (0 < dw <= w and 0 < dh <= h):
        raise ValueError(f"resize_area only shrinks: {w}x{h} -> {dw}x{dh}")
    fy, fx = h / dh, w / dw
    src = img.reshape(h, w, -1)
    if fy == int(fy) and fx == int(fx):
        fy, fx = int(fy), int(fx)
        sums = src.reshape(dh, fy, dw, fx, -1).sum(axis=(1, 3), dtype=np.float64)
        if img.dtype == np.uint8:
            if fy * fx == 4:
                out = (sums.astype(np.int64) + 2) >> 2
            else:
                out = np.rint(sums * (1.0 / (fy * fx)))
        else:
            out = sums / (fy * fx)
    else:
        wy, wx = _area_weights(h, dh), _area_weights(w, dw)
        out = np.einsum("yh,hwc->ywc", wy, src.astype(np.float64))
        out = np.einsum("xw,ywc->yxc", wx, out)
        if img.dtype == np.uint8:
            out = np.rint(out)
    if img.dtype == np.uint8:
        out = np.clip(out, 0, 255)
    return out.astype(img.dtype).reshape((dh, dw) + img.shape[2:])
