"""The port's area resize (``nerf_tpu_torch/utils/resize.py``) against
``cv2.resize(..., interpolation=cv2.INTER_AREA)``, the call the JAX loaders
make: blender's half_res (x2) and debug (x32), LLFF's factor 8 and its
``round(w / r)`` and explicit ``{w}x{h}`` targets, which need not divide the
source.

Tolerances: float32 within 1e-6 (4e-7 measured: the sums run in float64
here, in float32 in OpenCV); uint8 within 1 level, and bitwise at every case
below, as measured (the rounding follows OpenCV's: half up on its factor-2
path, to the nearest even elsewhere).
"""

import cv2
import numpy as np
import pytest

from nerf_tpu_torch.utils.resize import resize_area

CASES = [
    ((64, 64, 4), (32, 32)),      # x2, blender half_res (RGBA)
    ((80, 64, 3), (10, 8)),       # x8, LLFF factor 8
    ((800, 800, 4), (25, 25)),    # x32, blender debug at lego's size
    ((96, 64), (3, 2)),           # x32, grey
    ((16, 16, 3), (5, 5)),        # 16 -> 5
    ((75, 100, 3), (13, 9)),      # 100x75 -> 13x9
    ((100, 75, 4), (9, 13)),
    ((33, 47, 3), (16, 23)),      # round(47 / 2) x round(33 / 2), odd sources
    ((64, 48, 3), (48, 32)),      # x4/3 by x1
    ((21, 30), (10, 7)),
]


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
@pytest.mark.parametrize("shape,dsize", CASES, ids=[f"{s}->{d}" for s, d in CASES])
def test_resize_area_matches_cv2(shape, dsize, dtype):
    rng = np.random.default_rng(sum(shape) + dsize[0])
    if dtype == "float32":
        img = rng.uniform(0, 1, shape).astype(np.float32)
    else:
        img = rng.integers(0, 256, shape).astype(np.uint8)
    want = cv2.resize(img, dsize, interpolation=cv2.INTER_AREA)
    got = resize_area(img, dsize)
    assert got.dtype == want.dtype and got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


def test_resize_area_refuses_enlarging_and_other_dtypes():
    with pytest.raises(ValueError, match="shrinks"):
        resize_area(np.zeros((4, 4, 3), np.float32), (8, 4))
    with pytest.raises(ValueError, match="float32 or uint8"):
        resize_area(np.zeros((4, 4, 3), np.float64), (2, 2))
