"""PSNR and SSIM between two image sets (port of ``evaluate_metrics.py``).

Point it at a directory of rendered frames and a directory (or ``.npz``) of
ground-truth frames; it prints the JSON report the JAX CLI prints. PNGs are
read by ``utils/png.read_png``, not imageio, and the metrics are
``utils/metrics.py``'s, the JAX package's numbers bitwise.

Usage:
  python -m nerf_tpu_torch.evaluate_metrics --pred rendered/ --target gt_dir/
  python -m nerf_tpu_torch.evaluate_metrics --pred rendered/ --target gt.npz --target-key images
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

import numpy as np

from .utils.metrics import psnr, ssim
from .utils.png import read_png


def load_images(path: str, key: str = "images") -> np.ndarray:
    """(N, H, W, C) float32 in [0, 1]: an ``.npz`` array (uint8 or > 2.0
    scaled by 1/255), or a directory's PNGs in name order."""
    if path.endswith(".npz"):
        arr = np.load(path)[key]
        out = arr.astype(np.float32)
        if arr.dtype == np.uint8 or out.max() > 2.0:
            out = out / 255.0
        return out
    files = sorted(f for f in os.listdir(path) if f.endswith((".png", ".jpg", ".jpeg")))
    non_png = [f for f in files if not f.endswith(".png")]
    if non_png:
        raise ValueError(f"{path}: only PNG files are read here, not {non_png[0]!r}")
    imgs = [read_png(os.path.join(path, f)) for f in files]
    return np.stack([np.asarray(im, np.float32) / 255.0 for im in imgs])


def evaluate(pred: np.ndarray, target: np.ndarray) -> Dict:
    """The report of the first ``min(len)`` image pairs' RGB channels."""
    pred, target = pred[..., :3], target[..., :3]
    n = min(len(pred), len(target))
    if len(pred) != len(target):
        print(f"warning: {len(pred)} pred vs {len(target)} target; comparing first {n}")
    psnrs = [psnr(pred[i], target[i]) for i in range(n)]
    ssims = [ssim(pred[i], target[i]) for i in range(n)]
    return {
        "num_images": n,
        "psnr_mean": float(np.mean(psnrs)),
        "psnr_per_image": [round(float(p), 3) for p in psnrs],
        "ssim_mean": float(np.mean(ssims)),
        "ssim_per_image": [round(float(s), 4) for s in ssims],
    }


def main(argv: Optional[List[str]] = None) -> Dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--pred", required=True, help="Rendered images (dir or npz).")
    parser.add_argument("--target", required=True, help="Ground truth (dir or npz).")
    parser.add_argument("--target-key", default="images")
    parser.add_argument("--pred-key", default="images")
    args = parser.parse_args(argv)
    result = evaluate(load_images(args.pred, args.pred_key),
                      load_images(args.target, args.target_key))
    print(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
