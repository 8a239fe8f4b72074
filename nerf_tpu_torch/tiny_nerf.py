"""Tiny-NeRF demo: the smallest end-to-end NeRF, self-contained (port of
``tiny_nerf.py``).

One ``VeryTinyNeRFModel``, a coarse pass only, uniform depths and no view
directions, Adam at 5e-3 on 4096-ray batches; every ``--display-every``
iterations the held-out view is rendered and its PSNR logged, and at the
end a PSNR curve is written as a PNG. The scene is the procedural synthetic
one by default, or an ``.npz`` of ``images``, ``poses`` and ``focal`` (the
reference's ``tiny_nerf_data.npz``) read by ``numpy.load``.

Usage:
  python -m nerf_tpu_torch.tiny_nerf [--npz tiny_nerf_data.npz] [--iters 1000] [--size 64]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from .data import flatten_rays, make_synthetic_dataset
from .data.synthetic import SyntheticDataset
from .engine.renderer import RenderSettings, make_image_render_fn
from .engine.train import (
    create_train_state,
    make_optimizer,
    make_train_step,
    sample_ray_batch,
    step_generator,
)
from .models import VeryTinyNeRFModel
from .ops import get_ray_bundle, img2mse, mse2psnr
from .utils import MetricWriter
from .utils.png import write_png

BATCH = 4096
SEED = 0


def load_npz_dataset(path: str) -> SyntheticDataset:
    """The reference's ``tiny_nerf_data.npz`` layout (tiny_nerf.py:197-209)."""
    data = np.load(path)
    images = data["images"].astype(np.float32)
    poses = data["poses"].astype(np.float32)
    focal = float(data["focal"])
    h, w = images.shape[1:3]
    return SyntheticDataset(images, poses, (h, w, focal), 2.0, 6.0)


def tiny_settings(near: float, far: float, chunksize: int) -> RenderSettings:
    """Coarse only, no view directions, uniform depths (tiny_nerf.py:111-160)."""
    return RenderSettings(num_coarse=32, num_fine=0, perturb=False, use_viewdirs=False,
                          white_background=False, near=near, far=far, num_encoding_fn_xyz=6,
                          include_input_xyz=True, chunksize=chunksize)


@dataclasses.dataclass
class TinyResult:
    val_psnrs: List[Tuple[int, float]]   # (iteration, held-out PSNR)
    seconds: float
    rays_per_sec: float


def main(argv: Optional[List[str]] = None) -> TinyResult:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--npz", type=str, default="", help="tiny_nerf_data.npz path")
    parser.add_argument("--iters", type=int, default=1000)
    parser.add_argument("--size", type=int, default=64, help="synthetic image size")
    parser.add_argument("--logdir", type=str, default="logs/tiny_nerf")
    parser.add_argument("--display-every", type=int, default=100)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    if args.iters < 1 or args.display_every < 1:
        parser.error("--iters and --display-every must be >= 1")
    device = torch.device(args.device)

    if args.npz:
        dataset = load_npz_dataset(args.npz)
    else:
        dataset = make_synthetic_dataset(num_views=12, height=args.size, width=args.size,
                                         device=device)
    h, w, focal = dataset.hwf
    n_heldout = max(1, len(dataset.images) - 1)
    train_ds = SyntheticDataset(dataset.images[:n_heldout], dataset.poses[:n_heldout],
                                dataset.hwf, dataset.near, dataset.far)
    test_img = torch.as_tensor(dataset.images[-1][..., :3], device=device)
    test_pose = torch.as_tensor(dataset.poses[-1][:3, :4], device=device)
    ro, rd, targets = (torch.from_numpy(a).to(device) for a in flatten_rays(train_ds))
    print(f"tiny-nerf: {ro.shape[0]:,} rays, {h}x{w}, on {device}", flush=True)

    settings = tiny_settings(dataset.near, dataset.far, h * w)
    model = VeryTinyNeRFModel(num_encoding_functions=6, use_viewdirs=False,
                              generator=torch.Generator().manual_seed(SEED)).to(device)
    state = create_train_state(model, None, make_optimizer("adam", 5e-3))
    step = make_train_step(model, None, settings)
    render_image = make_image_render_fn(model, None, settings)

    writer = MetricWriter(args.logdir)
    result = TinyResult([], 0.0, 0.0)
    t0 = time.perf_counter()
    for i in range(args.iters):
        gen = step_generator(SEED + 1, i, device)
        batch = sample_ray_batch(gen, ro, rd, targets, BATCH)
        state, metrics = step(state, *batch, gen)
        if i % args.display_every == 0 or i == args.iters - 1:
            maps = render_image(*get_ray_bundle(h, w, focal, test_pose))
            val_psnr = float(mse2psnr(img2mse(maps["rgb_coarse"], test_img)))
            result.val_psnrs.append((i, val_psnr))
            writer.scalar("tiny/val_psnr", val_psnr, i)
            writer.image("tiny/render", maps["rgb_coarse"].cpu().numpy(), i)
            print(f"iter {i:5d} train_psnr {float(metrics.psnr):6.2f} "
                  f"val_psnr {val_psnr:6.2f}", flush=True)
    result.seconds = time.perf_counter() - t0
    result.rays_per_sec = args.iters * BATCH / result.seconds
    print(f"{args.iters} iters in {result.seconds:.1f}s = {result.rays_per_sec:,.0f} rays/s")

    # The PSNR curve as a PNG, drawn without a plotting package.
    curve = np.full((128, 256, 3), 255, np.uint8)
    if len(result.val_psnrs) > 1:
        xs = np.array([p[0] for p in result.val_psnrs], np.float64)
        ys = np.array([p[1] for p in result.val_psnrs], np.float64)
        xi = ((xs - xs.min()) / max(xs.max() - xs.min(), 1) * 255).astype(int)
        yi = 127 - ((ys - ys.min()) / max(ys.max() - ys.min(), 1e-6) * 127).astype(int)
        curve[yi.clip(0, 127), xi.clip(0, 255)] = [200, 30, 30]
    os.makedirs(args.logdir, exist_ok=True)
    write_png(os.path.join(args.logdir, "psnr_curve.png"), curve)
    writer.close()
    print(f"final val PSNR: {result.val_psnrs[-1][1]:.2f} dB; logs in {args.logdir}")
    return result


if __name__ == "__main__":
    main()
