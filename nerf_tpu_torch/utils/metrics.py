"""Quality metrics and a running average (port of
``nerf_tpu/utils/metrics.py``).

``ScalarMetric`` is the working rebuild of the reference's ``nerf/metrics.py``;
``psnr`` and ``ssim`` are the host-side image metrics the evaluation CLIs
report. All three are numpy only and copied from the JAX package operation
for operation, so their numbers are its numbers bitwise: the SSIM's separable
Gaussian filter sums its taps in the same order, and a different filter would
move the fourth decimal the JSON summaries round to.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class ScalarMetric:
    """Running average of a scalar (fixed rebuild of nerf/metrics.py:6-28)."""

    def __init__(self, initial_value: Optional[float] = None):
        self.value = 0.0
        self.count = 0
        if initial_value is not None:
            self.update(initial_value)

    def update(self, new_value: float) -> None:
        self.value += float(new_value)
        self.count += 1

    def reset(self) -> None:
        self.value = 0.0
        self.count = 0

    def peek(self) -> float:
        """Current running average (0 if nothing recorded)."""
        return self.value / self.count if self.count > 0 else 0.0

    def __repr__(self) -> str:
        return f"ScalarMetric(avg={self.peek():.6g}, n={self.count})"


def psnr(img_src, img_tgt, max_val: float = 1.0) -> float:
    """Peak signal-to-noise ratio between two images in [0, max_val], in
    float64 on the host; an MSE <= 0 is clamped to 1e-5 as the reference
    does (nerf/nerf_helpers.py:14-16)."""
    a = np.asarray(img_src, np.float64) / max_val
    b = np.asarray(img_tgt, np.float64) / max_val
    mse = float(np.mean((a - b) ** 2))
    if mse <= 0.0:
        mse = 1e-5
    return float(-10.0 * np.log10(mse))


def ssim(
    img_src,
    img_tgt,
    max_val: float = 1.0,
    filter_size: int = 11,
    filter_sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
) -> float:
    """Structural similarity (mean over channels), Gaussian-windowed.

    Standard Wang et al. formulation over (H, W, C) float images.
    """
    a = np.asarray(img_src, np.float64) / max_val
    b = np.asarray(img_tgt, np.float64) / max_val
    if a.ndim == 2:
        a = a[..., None]
        b = b[..., None]

    hw = filter_size // 2
    offsets = np.arange(-hw, hw + 1)
    g = np.exp(-(offsets ** 2) / (2.0 * filter_sigma ** 2))
    g = g / g.sum()

    def conv1d(x: np.ndarray, axis: int) -> np.ndarray:
        # Separable Gaussian along one axis with edge replication.
        x = np.moveaxis(x, axis, 0)
        padded = np.concatenate(
            [np.repeat(x[:1], hw, axis=0), x, np.repeat(x[-1:], hw, axis=0)], axis=0
        )
        out = np.zeros_like(x)
        for i, w in enumerate(g):
            out += w * padded[i : i + x.shape[0]]
        return np.moveaxis(out, 0, axis)

    def filt(x):
        return conv1d(conv1d(x, 0), 1)

    mu_a = filt(a)
    mu_b = filt(b)
    var_a = filt(a * a) - mu_a * mu_a
    var_b = filt(b * b) - mu_b * mu_b
    cov = filt(a * b) - mu_a * mu_b

    c1 = (k1 ** 2)
    c2 = (k2 ** 2)
    num = (2 * mu_a * mu_b + c1) * (2 * cov + c2)
    den = (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2)
    return float(np.mean(num / den))
