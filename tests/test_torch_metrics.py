"""nerf_tpu_torch.utils.metrics and evaluate_metrics against the JAX package.

``psnr`` and ``ssim`` are numpy in both packages and must agree bitwise on
seeded images (grey and RGB, odd sizes smaller than the 11-tap window,
``max_val`` 255, identical images); ``ScalarMetric`` keeps the same running
average. ``evaluate_metrics`` on PNG directories and ``.npz`` files gives the
JAX CLI's report, value for value (the JAX CLI reads through imageio, the
port through ``utils/png.py``).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from nerf_tpu.utils import metrics as jmetrics
from nerf_tpu_torch import evaluate_metrics
from nerf_tpu_torch.utils import metrics as tmetrics
from nerf_tpu_torch.utils.png import write_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pair(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, scale, shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05 * scale, shape), 0, scale).astype(np.float32)
    return a, b


@pytest.mark.parametrize("shape", [(16, 16, 3), (23, 17, 3), (7, 5, 3), (12, 9), (30, 30, 4)])
@pytest.mark.parametrize("seed", [0, 1])
def test_psnr_ssim_bitwise(shape, seed):
    a, b = _pair(shape, seed)
    assert tmetrics.psnr(a, b) == jmetrics.psnr(a, b)
    assert tmetrics.ssim(a, b) == jmetrics.ssim(a, b)
    a255, b255 = a * 255, b * 255
    assert tmetrics.psnr(a255, b255, max_val=255.0) == jmetrics.psnr(a255, b255, max_val=255.0)
    assert tmetrics.ssim(a255, b255, max_val=255.0) == jmetrics.ssim(a255, b255, max_val=255.0)


def test_identical_images_and_scalar_metric():
    a, _ = _pair((9, 9, 3), 4)
    assert tmetrics.psnr(a, a) == jmetrics.psnr(a, a) == 50.0
    assert tmetrics.ssim(a, a) == jmetrics.ssim(a, a)
    t, j = tmetrics.ScalarMetric(2.0), jmetrics.ScalarMetric(2.0)
    for v in (1.0, 4.5):
        t.update(v)
        j.update(v)
    assert (t.peek(), t.count, repr(t)) == (j.peek(), j.count, repr(j))
    t.reset()
    assert t.peek() == 0.0 and t.count == 0


def _run_jax_cli(args):
    out = subprocess.run([sys.executable, os.path.join(REPO, "evaluate_metrics.py"), *args],
                         capture_output=True, text=True, check=True, cwd=REPO,
                         env={**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO})
    return json.loads(out.stdout[out.stdout.index("{"):])


def test_evaluate_metrics_matches_the_jax_cli(tmp_path, capsys):
    rng = np.random.default_rng(7)
    pred_dir, gt_dir = tmp_path / "pred", tmp_path / "gt"
    pred_dir.mkdir()
    gt_dir.mkdir()
    gts = rng.integers(0, 256, (3, 14, 18, 4), dtype=np.uint8)
    for i, gt in enumerate(gts):
        noisy = np.clip(gt[..., :3].astype(int) + rng.integers(-9, 10, gt[..., :3].shape), 0, 255)
        write_png(str(pred_dir / f"val_{i:03d}.png"), noisy.astype(np.uint8))
        write_png(str(gt_dir / f"r_{i}.png"), gt)
    np.savez(tmp_path / "gt.npz", images=gts)
    for target in (str(gt_dir), str(tmp_path / "gt.npz")):
        args = ["--pred", str(pred_dir), "--target", target]
        want = _run_jax_cli(args)
        got = evaluate_metrics.main(args)
        assert got == want
        printed = capsys.readouterr().out
        assert json.loads(printed) == want
