"""Extract a mesh or coloured point cloud from a trained NeRF checkpoint
(port of ``extract_geometry.py``).

The R^3 density sweep runs on the device, chunk after chunk, with the sample
coordinates made there from each chunk's index (only the final float32 sigma
grid comes back to the host); then a host-side vectorized marching-tetrahedra
pass (``engine/geometry.py``) builds a watertight, consistently wound mesh
with vertex colours and normals baked from the radiance field.

Reads native ``.ntc`` checkpoints and reference ``.ckpt`` files:

  python -m nerf_tpu_torch.extract_geometry --config configs/lego_lowres.yml \\
      --checkpoint checkpoint199999.ckpt --output lego.ply --resolution 256 --iso 50

  python -m nerf_tpu_torch.extract_geometry --config ... --checkpoint ... \\
      --mode pointcloud --threshold 50 --max-points 500000 --output lego_pc.ply

Bounded (blender/synthetic) scenes only: LLFF forward-facing scenes have no
natural world-space box; pass an explicit --bbox if you know one. The sweep
runs on ``--device`` (default ``cuda``); ``--num-devices N`` shards its
chunks over N ranks (``engine.geometry.make_sigma_grid_fn`` with a mesh;
under ``torchrun`` its group, else N spawned ranks), bitwise the serial
grid, and rank 0 alone builds and writes the mesh.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import List, Optional

import numpy as np

from .config import load_config, render_settings_from_config
from .engine.checkpoint import load_models_and_params
from .engine.geometry import extract_mesh, extract_pointcloud, make_sigma_grid_fn, save_ply
from .parallel.distributed import add_mesh_args, run_cli
from .parallel.mesh import make_mesh


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--checkpoint", type=str, required=True)
    parser.add_argument("--output", type=str, required=True, help="Output .ply path.")
    parser.add_argument("--mode", choices=["mesh", "pointcloud"], default="mesh")
    parser.add_argument("--resolution", type=int, default=256,
                        help="Density-grid vertices per axis.")
    parser.add_argument("--bbox", type=float, nargs=6, default=None,
                        metavar=("X0", "Y0", "Z0", "X1", "Y1", "Z1"),
                        help="World-space sampling box (default: [-1.5, 1.5]^3, the blender "
                             "synthetic-scene convention).")
    parser.add_argument("--iso", type=float, default=50.0,
                        help="Mesh isosurface sigma level (NeRF extract_mesh convention: 50).")
    parser.add_argument("--threshold", type=float, default=None,
                        help="Point-cloud sigma threshold (default: --iso).")
    parser.add_argument("--max-points", type=int, default=1_000_000,
                        help="Subsample the point cloud to at most this many points "
                             "(0 = keep all).")
    parser.add_argument("--model", choices=["fine", "coarse"], default="fine",
                        help="Which network to query (fine falls back to coarse when the "
                             "checkpoint has no fine model).")
    parser.add_argument("--chunk", type=int, default=262_144,
                        help="Grid points per batched field evaluation.")
    parser.add_argument("--no-colors", action="store_true", help="Skip baking vertex colors.")
    parser.add_argument("--no-normals", action="store_true",
                        help="Skip the autograd density-gradient vertex normals (mesh mode).")
    parser.add_argument("--save-grid", type=str, default="",
                        help="Also save the raw sigma grid to this .npz.")
    parser.add_argument("--precision", choices=["bfloat16", "float32"], default="float32")
    parser.add_argument("--overrides", type=str, nargs="*", default=None)
    parser.add_argument("--device", type=str, default="cuda")
    add_mesh_args(parser, "Ranks to shard the sweep over.")
    run_cli(extract, parser.parse_args(argv))


def extract(args: argparse.Namespace) -> None:
    """One rank of ``extract_geometry``: its part of the sweep; rank 0 (or
    the only process) then builds and writes the geometry."""
    mesh = make_mesh(args.num_devices, args.device, args.dist_backend)
    cfg = load_config(args.config, args.overrides)
    if cfg.dataset.type == "llff" and args.bbox is None:
        raise SystemExit(
            "LLFF scenes have no default world-space bounding box; pass an "
            "explicit --bbox X0 Y0 Z0 X1 Y1 Z1"
        )
    bbox = args.bbox if args.bbox is not None else [-1.5] * 3 + [1.5] * 3
    bbox_min, bbox_max = tuple(bbox[:3]), tuple(bbox[3:])
    if not all(hi > lo for lo, hi in zip(bbox_min, bbox_max)):
        raise SystemExit(f"degenerate --bbox: min {bbox_min} !< max {bbox_max}")

    model_coarse, model_fine, _ = load_models_and_params(args.checkpoint, cfg, mesh.device)
    model = model_fine if args.model == "fine" and model_fine is not None else model_coarse

    # Grid sampling happens in WORLD space whatever the scene renders in, so
    # NDC is off here (and a dummy hwf lets NDC configs build settings).
    settings = dataclasses.replace(
        render_settings_from_config(cfg, "validation", hwf=(1, 1, 1.0)).eval_variant(),
        compute_dtype=args.precision,
        use_ndc=False, height=0, width=0, focal_length=0.0,
    )

    t0 = time.time()
    if mesh.world_size > 1 and mesh.is_primary:
        print(f"sharding the grid sweep over {mesh.world_size} devices", flush=True)
    sigma_grid = make_sigma_grid_fn(model, settings, args.resolution, bbox_min, bbox_max,
                                    args.chunk, mesh=mesh)()
    if not mesh.is_primary:
        return
    n = args.resolution ** 3
    dt = time.time() - t0
    print(
        f"sigma grid {args.resolution}^3 = {n:,} points in {dt:.1f} s "
        f"({n / dt / 1e6:.2f}M pts/s); "
        f"sigma max {sigma_grid.max():.1f}, "
        f"frac > iso: {(sigma_grid > args.iso).mean():.4f}",
        flush=True,
    )
    if args.save_grid:
        # float32: relu'd sigma is unbounded, and trained fields pass f16's
        # range in dense regions.
        np.savez_compressed(args.save_grid, sigma=sigma_grid, bbox_min=bbox_min,
                            bbox_max=bbox_max)
        print(f"wrote {args.save_grid}", flush=True)

    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    if args.mode == "mesh":
        t0 = time.time()
        verts, faces, colors, normals = extract_mesh(
            model, settings, bbox_min, bbox_max, args.resolution, args.iso, args.chunk,
            with_colors=not args.no_colors, with_normals=not args.no_normals,
            sigma_grid=sigma_grid,
        )
        if verts.shape[0] == 0:
            raise SystemExit(
                f"no isosurface at sigma={args.iso} inside bbox {bbox_min}..."
                f"{bbox_max} (sigma max {sigma_grid.max():.2f}) — lower --iso "
                "or widen --bbox"
            )
        save_ply(args.output, verts, faces=faces, colors=colors, normals=normals)
        print(f"mesh: {verts.shape[0]:,} vertices, {faces.shape[0]:,} faces "
              f"in {time.time() - t0:.1f} s -> {args.output}", flush=True)
    else:
        threshold = args.iso if args.threshold is None else args.threshold
        pts, colors, sigmas = extract_pointcloud(
            model, settings, bbox_min, bbox_max, args.resolution, threshold, args.chunk,
            max_points=args.max_points, sigma_grid=sigma_grid,
        )
        if pts.shape[0] == 0:
            raise SystemExit(f"no points with sigma > {threshold} (max "
                             f"{sigma_grid.max():.2f}) — lower --threshold")
        save_ply(args.output, pts, colors=colors)
        print(f"point cloud: {pts.shape[0]:,} points "
              f"(sigma {sigmas.min():.1f}..{sigmas.max():.1f}) -> {args.output}", flush=True)


if __name__ == "__main__":
    main()
