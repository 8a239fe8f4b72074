"""Experiment logging (port of ``nerf_tpu/utils/logging.py``): scalars to a
``metrics.jsonl`` and images to PNG files under ``images/``.

The JAX package also mirrors both to TensorBoard when it is installed; the
port writes JSONL and PNG only (the card's machine has no TensorBoard), with
the same tags.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np

from .png import write_png


class MetricWriter:
    """Scalar and image logger: ``<logdir>/metrics.jsonl`` + ``<logdir>/images``."""

    def __init__(self, logdir: str):
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")

    def scalar(self, tag: str, value: float, step: int) -> None:
        record = {"tag": tag, "value": float(value), "step": int(step), "time": time.time()}
        self._jsonl.write(json.dumps(record) + "\n")

    def scalars(self, values: Dict[str, float], step: int) -> None:
        for tag, value in values.items():
            self.scalar(tag, value, step)

    def image(self, tag: str, img: np.ndarray, step: int) -> str:
        """img: (H, W, 3) float in [0, 1]; written as ``<tag>_<step>.png``.
        Returns the path."""
        img = np.clip(np.asarray(img, np.float32), 0.0, 1.0)
        img_dir = os.path.join(self.logdir, "images")
        os.makedirs(img_dir, exist_ok=True)
        path = os.path.join(img_dir, f"{tag.replace('/', '_')}_{step:06d}.png")
        write_png(path, (img * 255).astype(np.uint8))
        return path

    def flush(self) -> None:
        self._jsonl.flush()

    def close(self) -> None:
        self._jsonl.close()


class RateMeter:
    """Rays per second over a sliding window of updates."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times: list = []
        self._counts: list = []

    def update(self, num_rays: int) -> None:
        self._times.append(time.time())
        self._counts.append(num_rays)
        if len(self._times) > self.window:
            self._times.pop(0)
            self._counts.pop(0)

    def rate(self) -> float:
        if len(self._times) < 2:
            return 0.0
        dt = self._times[-1] - self._times[0]
        if dt <= 0:
            return 0.0
        return sum(self._counts[1:]) / dt
