"""Distill a trained NeRF checkpoint into a dataset on disk (port of
``distill_dataset.py``).

A trained field is a scene: rendering it from new cameras gives a training
set whose ground truth is the teacher's field. The output follows
``--config``'s dataset type:

blender: ``savedir/transforms_{train,val,test}.json`` (``camera_angle_x`` and
  frames) and ``savedir/{train,val,test}/r_{i}.png`` (RGB teacher renders);
  seeded random upper-hemisphere cameras at the blender synthetic radius.
llff: ``savedir/images/image{i}.png``, ``savedir/poses_bounds.npy`` (N, 17)
  and ``savedir/holdout/{k}.png`` (the llffhold-stride views again, in
  ``eval_nerf --split val`` order); jittered forward-facing cameras built
  with the reference spiral's math, recentred and bound-calibrated so the
  loader's recentre and rescale give them back exactly.

Cameras, ``transforms_*.json`` and ``poses_bounds.npy`` are the JAX CLI's
bitwise (numpy from the same seed); the PNGs are written by ``utils/png.py``.
``--renderer pallas`` renders the teacher through the hand-written CUDA
kernel of its family (#1 ``fused_mlp_t`` for the 4x128 10/4 FlexibleNeRF),
``--renderer xla`` (the default, as in the JAX CLI) through encoding + the
module.

Usage:
  python -m nerf_tpu_torch.distill_dataset --config cfg.py --checkpoint ckpt.ntc \\
      --savedir distilled --num-train 100 --num-val 8
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import os
import time
from typing import List, Optional

import numpy as np
import torch

from .config import load_config, render_settings_from_config
from .data.llff import recenter_poses
from .data.poses import normalize, pose_spherical, viewmatrix
from .engine.checkpoint import load_models_and_params
from .engine.renderer import make_pose_render_fn
from .utils.png import write_png

BLENDER_CAMERA_ANGLE_X = 0.6911112070083618  # the synthetic scenes' FOV
BLENDER_RADIUS = 4.0311289

# A typical LLFF capture's focal ratio (fern: 3261.55 px at 4032 px wide)
# and aspect, so the distilled NDC frustum is shaped like the teacher's.
LLFF_FOCAL_RATIO = 3261.55 / 4032.0
LLFF_ASPECT = 3024.0 / 4032.0


def random_hemisphere_poses(rng: np.random.Generator, n: int,
                            radius: float = BLENDER_RADIUS) -> np.ndarray:
    """n seeded random upper-hemisphere camera-to-world poses (n, 4, 4)."""
    poses = []
    for _ in range(n):
        theta = float(rng.uniform(-180.0, 180.0))
        phi = float(rng.uniform(-80.0, -5.0))
        poses.append(np.asarray(pose_spherical(theta, phi, radius)))
    return np.stack(poses)


def forward_facing_poses(rng: np.random.Generator, n: int, rads=(0.35, 0.1, 0.12),
                         focus_depth: float = 4.4) -> np.ndarray:
    """n jittered forward-facing c2w poses (n, 3, 4) in the LLFF recentred
    frame: centres on two sweeps of an ellipse of radii ``rads`` plus seeded
    jitter, each looking at [0, 0, -focus_depth] (reference
    load_llff.py:169-183), then recentred so their average pose is the
    identity and the loader's recentring changes nothing."""
    up = np.array([0.0, 1.0, 0.0])
    poses = []
    for i in range(n):
        th = 2.0 * np.pi * 2.0 * i / n  # two sweeps, like the spiral's rots=2
        c = np.array([np.cos(th) * rads[0], -np.sin(th) * rads[1], -np.sin(th * 0.5) * rads[2]])
        c = c + rng.uniform(-0.15, 0.15, 3) * np.asarray(rads)
        z = normalize(c - np.array([0.0, 0.0, -focus_depth]))
        poses.append(viewmatrix(z, up, c))
    poses = np.stack(poses).astype(np.float64)  # (n, 3, 4)
    return recenter_poses(poses)[:, :3, :4]


def write_llff_poses_bounds(savedir: str, poses_c2w: np.ndarray, hwf, bds) -> None:
    """Write ``poses_bounds.npy`` so that ``load_llff_data`` gives back
    ``poses_c2w``: the loader's column swap inverted (loaded col0 = raw col1,
    loaded col1 = -raw col0) and bounds whose minimum makes the bd_factor
    rescale ``1 / (bds.min() * 0.75)`` equal 1."""
    n = poses_c2w.shape[0]
    raw = np.concatenate(
        [-poses_c2w[:, :, 1:2], poses_c2w[:, :, 0:1], poses_c2w[:, :, 2:4]], axis=2)
    hwf_col = np.broadcast_to(np.asarray(hwf, np.float64).reshape(1, 3, 1), (n, 3, 1))
    flat = np.concatenate([raw, hwf_col], axis=2).reshape(n, 15)
    out = np.concatenate([flat, np.tile(np.asarray(bds, np.float64), (n, 1))], axis=1)
    np.save(os.path.join(savedir, "poses_bounds.npy"), out)


@dataclasses.dataclass
class DistillResult:
    views: int
    seconds: float          # every render and PNG write, the writes overlapping renders
    frame_seconds: List[float]   # per view: render + fetch to the host


def distill(cfg, checkpoint: str, savedir: str, num_train: int = 100, num_val: int = 8,
            num_test: Optional[int] = None, size: int = 400, seed: int = 2026,
            precision: str = "float32", renderer: str = "xla",
            device: str = "cuda") -> DistillResult:
    """Render the teacher ``checkpoint`` into ``savedir`` (the CLI's work)."""
    if renderer not in ("pallas", "xla"):
        raise ValueError(f"renderer must be 'pallas' or 'xla', got {renderer!r}")
    is_llff = getattr(cfg.dataset, "type", "blender") == "llff"
    if is_llff:
        w = size
        h = int(round(w * LLFF_ASPECT))
        focal = w * LLFF_FOCAL_RATIO
    else:
        h = w = size
        focal = 0.5 * w / np.tan(0.5 * BLENDER_CAMERA_ANGLE_X)
    model_coarse, model_fine, _ = load_models_and_params(checkpoint, cfg, device)
    settings = dataclasses.replace(
        render_settings_from_config(cfg, "validation", hwf=(h, w, focal)),
        compute_dtype=precision, use_pallas=(renderer == "pallas"))
    render_u8 = make_pose_render_fn(model_coarse, model_fine, settings, h, w, focal,
                                    output="u8")
    result = DistillResult(0, 0.0, [])

    def render_views(poses, write_out):
        """Render and fetch each view, and ``write_out(i, image)`` it on a
        worker thread while the next view renders (the JAX CLI's 2-deep
        pipeline, for the same overlap of PNG encoding with the device)."""
        with concurrent.futures.ThreadPoolExecutor(max_workers=1) as writer:
            pending = None
            for i, pose in enumerate(poses):
                t0 = time.perf_counter()
                img = render_u8(torch.as_tensor(np.asarray(pose)[:3, :4], dtype=torch.float32,
                                                device=device)).cpu().numpy()
                result.frame_seconds.append(time.perf_counter() - t0)
                if pending is not None:
                    pending.result()
                pending = writer.submit(write_out, i, img)
                result.views += 1
            if pending is not None:
                pending.result()

    rng = np.random.default_rng(seed)
    t_start = time.perf_counter()
    if is_llff:
        # Flat images/ + poses_bounds.npy; every llffhold-th view is held out
        # by the training protocol and copied to holdout/ in eval order.
        if num_test is not None:
            raise SystemExit("--num-test is not defined for LLFF datasets (val == test, "
                             "reference train_nerf.py:75-84); use --num-val")
        llffhold = int(getattr(cfg.dataset, "llffhold", 8))
        total = num_train + num_val
        nv = len(range(0, total, llffhold))
        if nv != num_val:
            print(f"note: llffhold={llffhold} over {total} views holds out {nv} views, "
                  f"not --num-val={num_val}")
        poses = forward_facing_poses(rng, total)
        imgdir = os.path.join(savedir, "images")
        holddir = os.path.join(savedir, "holdout")
        os.makedirs(imgdir, exist_ok=True)
        os.makedirs(holddir, exist_ok=True)

        def write_llff_view(i, img):
            write_png(os.path.join(imgdir, f"image{i:03d}.png"), img)
            if i % llffhold == 0:
                write_png(os.path.join(holddir, f"{i // llffhold:04d}.png"), img)

        render_views(poses, write_llff_view)
        write_llff_poses_bounds(savedir, poses, (h, w, focal), (4.0 / 3.0, 8.0))
        result.seconds = time.perf_counter() - t_start
        print(f"distilled LLFF set: {total} views at {w}x{h} ({total - nv} train / {nv} "
              f"holdout, llffhold={llffhold}) into {savedir} in {result.seconds:.1f}s")
        return result

    splits = {
        "train": random_hemisphere_poses(rng, num_train),
        "val": random_hemisphere_poses(rng, num_val),
        "test": random_hemisphere_poses(rng, 8 if num_test is None else num_test),
    }
    for split, poses in splits.items():
        os.makedirs(os.path.join(savedir, split), exist_ok=True)

        def write_split_view(i, img, split=split):
            write_png(os.path.join(savedir, split, f"r_{i}.png"), img)

        render_views(poses, write_split_view)
        frames = [{"file_path": f"./{split}/r_{i}",
                   "transform_matrix": np.asarray(pose, np.float64).tolist()}
                  for i, pose in enumerate(poses)]
        with open(os.path.join(savedir, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": BLENDER_CAMERA_ANGLE_X, "frames": frames}, f, indent=1)
        print(f"[{split}] {len(poses)} views written")
    result.seconds = time.perf_counter() - t_start
    print(f"distilled {result.views} views at {h}x{w} into {savedir} in "
          f"{result.seconds:.1f}s ({result.seconds / max(result.views, 1):.2f}s/view)")
    return result


def main(argv: Optional[List[str]] = None) -> DistillResult:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--savedir", required=True)
    parser.add_argument("--num-train", type=int, default=100)
    parser.add_argument("--num-val", type=int, default=8)
    parser.add_argument("--num-test", type=int, default=None,
                        help="Test views (blender layout only; default 8). LLFF has no "
                             "separate test split (val == test); passing this with an LLFF "
                             "config is an error.")
    parser.add_argument("--size", type=int, default=400,
                        help="Rendered image side (blender half-res = 400).")
    parser.add_argument("--seed", type=int, default=2026)
    parser.add_argument("--precision", choices=["bfloat16", "float32"], default="float32",
                        help="Teacher render dtype (float32: exact teacher).")
    parser.add_argument("--renderer", choices=["pallas", "xla"], default="xla",
                        help="xla (default): encoding + the module. pallas: the family's "
                             "CUDA kernel; the fine pass differs at a few "
                             "resample-boundary pixels.")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    cfg = load_config(args.config)
    return distill(cfg, args.checkpoint, args.savedir, num_train=args.num_train,
                   num_val=args.num_val, num_test=args.num_test, size=args.size,
                   seed=args.seed, precision=args.precision, renderer=args.renderer,
                   device=args.device)


if __name__ == "__main__":
    main()
