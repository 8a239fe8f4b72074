"""Precompute a ray cache for training (port of ``cache_dataset.py``).

Expands a blender or LLFF dataset's training views into one flat ray store
and writes it as the JAX script does: ``npz`` (``rays.npz``, with the
validation views and their poses), ``binary`` (``rays.nrc``, the native
single-file cache) or ``reference`` (per-image ``torch.save`` files under
``train/`` and ``val/``, the layout the reference's own cachedir training
reads).

Usage:
  python -m nerf_tpu_torch.cache_dataset --datapath data/lego --type blender \\
      --savedir cache/legocache [--half-res] [--blender-white-background] [--format binary]

``main(argv)`` parses the flags; ``cache_nerf_dataset(args)`` does the work.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np
import torch

from . import native
from .data import (
    build_ray_store,
    composite_white_background,
    llff_holdout_split,
    load_blender_data,
    load_llff_data,
    save_ray_cache,
)


def cache_nerf_dataset(args) -> str:
    """Write the cache ``args`` asks for; returns its path."""
    if args.type == "blender":
        images, poses, _, hwf, (i_train, i_val, _) = load_blender_data(
            args.datapath, half_res=args.half_res, testskip=args.testskip)
        if args.blender_white_background:
            images = composite_white_background(images)
        near, far = 2.0, 6.0
        poses = poses[:, :3, :4]
    elif args.type == "llff":
        images, poses, bds, _, i_holdout = load_llff_data(
            args.datapath, factor=args.factor, spherify=args.spherify,
            path_zflat=args.path_zflat)
        hwf = [int(poses[0, 0, 4]), int(poses[0, 1, 4]), float(poses[0, 2, 4])]
        poses = poses[:, :3, :4]
        i_train, i_val = llff_holdout_split(images.shape[0], args.llffhold, i_holdout)
        near, far = float(bds.min() * 0.9), float(bds.max())
    else:
        raise ValueError(f"Unknown dataset type {args.type!r}")

    h, w, focal = int(hwf[0]), int(hwf[1]), float(hwf[2])
    if args.format == "reference":
        return _write_reference_cache(args, images, poses, i_train, i_val, h, w, focal)
    ro, rd, targets = build_ray_store(images[i_train], poses[i_train], h, w, focal)
    if args.num_random_rays > 0:
        # Keep a seeded subset of num_random_rays x num_variations rays a view.
        rng = np.random.default_rng(args.seed)
        total = args.num_random_rays * args.num_variations * len(i_train)
        if total < ro.shape[0]:
            idx = rng.choice(ro.shape[0], size=total, replace=False)
            ro, rd, targets = ro[idx], rd[idx], targets[idx]

    os.makedirs(args.savedir, exist_ok=True)
    if args.format == "binary":
        path = os.path.join(args.savedir, "rays.nrc")
        native.pack_ray_cache(path, ro, rd, targets, h, w, focal, near, far)
    else:
        path = os.path.join(args.savedir, "rays.npz")
        save_ray_cache(path, ro, rd, targets,
                       meta={"height": h, "width": w, "focal": focal, "near": near, "far": far,
                             "type": args.type},
                       val_images=images[i_val][..., :3], val_poses=poses[i_val])
    print(f"cached {ro.shape[0]:,} rays -> {path}")
    return path


def _write_reference_cache(args, images, poses, i_train, i_val, h, w, focal) -> str:
    """Per-image ``torch.save`` dicts: ``train/NNNN.data`` with a stacked
    ``ray_bundle`` (2, ..., 3) and its ``target`` (``--num-random-rays`` of
    them when set, else the whole (H, W) image), ``val/NNNN.data`` with the
    whole image's ``ray_origins``, ``ray_directions`` and ``target``."""
    rng = np.random.default_rng(args.seed)
    count = 0
    for split, idxs in (("train", i_train), ("val", i_val)):
        outdir = os.path.join(args.savedir, split)
        os.makedirs(outdir, exist_ok=True)
        for i in idxs:
            ro, rd, tgt = build_ray_store(images[i:i + 1], poses[i:i + 1], h, w, focal)
            d = {"height": h, "width": w, "focal_length": focal}
            if split == "train":
                if args.num_random_rays > 0:
                    sel = rng.choice(ro.shape[0], size=args.num_random_rays, replace=False)
                    ro, rd, tgt = ro[sel], rd[sel], tgt[sel]
                else:
                    ro, rd, tgt = (x.reshape(h, w, 3) for x in (ro, rd, tgt))
                d["ray_bundle"] = torch.stack([torch.from_numpy(ro), torch.from_numpy(rd)], dim=0)
                d["target"] = torch.from_numpy(tgt)
            else:
                d["ray_origins"] = torch.from_numpy(ro.reshape(h, w, 3))
                d["ray_directions"] = torch.from_numpy(rd.reshape(h, w, 3))
                d["target"] = torch.from_numpy(tgt.reshape(h, w, 3))
            torch.save(d, os.path.join(outdir, f"{int(i):04d}.data"))
            count += 1
    print(f"cached {count} reference-format .data files -> {args.savedir}")
    return args.savedir


def main(argv: Optional[List[str]] = None) -> str:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--datapath", type=str, required=True)
    parser.add_argument("--type", type=str, required=True, choices=["blender", "llff"])
    parser.add_argument("--savedir", type=str, required=True)
    parser.add_argument("--half-res", action="store_true")
    parser.add_argument("--testskip", type=int, default=1)
    parser.add_argument("--factor", type=int, default=8, help="LLFF downsample factor")
    parser.add_argument("--llffhold", type=int, default=8)
    parser.add_argument("--spherify", action="store_true",
                        help="Spherify 360-degree LLFF captures.")
    parser.add_argument("--path-zflat", action="store_true",
                        help="Flatten the LLFF spiral render path in z (the cache keeps no "
                             "render path, so the cached rays do not change).")
    parser.add_argument("--blender-white-background", action="store_true")
    parser.add_argument("--num-random-rays", type=int, default=0,
                        help="Rays per (image, variation) to keep; 0 = keep every pixel.")
    parser.add_argument("--num-variations", type=int, default=1)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--format", choices=["npz", "binary", "reference"], default="npz",
                        help="npz (with the validation views), the native single-file binary "
                             "cache, or per-image torch.save .data files (reference).")
    return cache_nerf_dataset(parser.parse_args(argv))


if __name__ == "__main__":
    main()
