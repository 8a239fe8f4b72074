"""Render novel views from a trained NeRF checkpoint (port of ``eval_nerf.py``).

Loads a native ``.ntc`` (the JAX trainer's) or a reference ``.ckpt``,
renders the dataset's render-pose trajectory (``--split render``) or the
camera poses of one of its splits (``--split train|val|test``) to PNGs,
optionally with disparity maps and a GIF of the frames, and reports the time
per frame; on a split, also each frame's PSNR against its ground-truth image.

Usage:
  python -m nerf_tpu_torch.eval_nerf --config cfg.yml --checkpoint ckpt --savedir out/ \
      [--split test] [--gif out.gif]

``--tighten-aabb TAU`` sweeps the checkpoint's coarse density field once
(64^3, ``engine/geometry.density_aabb``) and cuts every ray's sample
interval to its crossing of the box around sigma > TAU; the kernel path
then renders those intervals.

``--renderer kernel`` (the default) evaluates the radiance field with the
hand-written CUDA kernel of the model's family, FlexibleNeRF or PaperNeRF
(the JAX CLI's ``pallas``); ``--renderer plain``
with positional encoding + the module (the JAX CLI's ``xla``). ``main(argv)``
parses the flags; ``render_trajectory(cfg, ...)`` does the work and takes a
``CfgNode``, so a caller can drive it without a YAML file.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .config import load_config, render_settings_from_config
from .data.eval_poses import load_render_split
from .engine.checkpoint import load_models_and_params
from .engine.geometry import tighten_to_density_aabb
from .engine.renderer import make_pose_render_fn
from .utils.gif import write_gif
from .utils.png import write_png


def cast_to_disparity_image(disp: np.ndarray) -> np.ndarray:
    """Min-max normalized uint8 disparity."""
    img = np.nan_to_num(np.asarray(disp), nan=0.0, posinf=0.0)
    img = (img - img.min()) / max(img.max() - img.min(), 1e-10)
    return (img * 255).astype(np.uint8)


@dataclasses.dataclass
class EvalResult:
    """What a trajectory render produced."""

    height: int
    width: int
    focal: float
    seconds: List[float]        # per frame: render + fetch to the host
    finite: List[bool]          # per frame: every map finite
    first_maps: Dict[str, torch.Tensor]  # frame 0's maps, on the CPU
    psnrs: List[float] = dataclasses.field(default_factory=list)  # per frame, on a split
    aabb: Optional[tuple] = None        # the --tighten-aabb box, when swept
    aabb_seconds: float = 0.0           # the sweep's host seconds

    @property
    def steady_seconds(self) -> float:
        """Mean seconds per frame after the first (the first, when alone)."""
        rest = self.seconds[1:] or self.seconds
        return sum(rest) / len(rest)


def render_trajectory(
    cfg,
    checkpoint: str,
    savedir: str,
    num_poses: int = 0,
    precision: str = "float32",
    renderer: str = "kernel",
    device: str = "cuda",
    save_disparity_image: bool = False,
    split: str = "render",
    gif: str = "",
    tighten_aabb: Optional[float] = None,
    aabb_sweep_bounds: Optional[List[float]] = None,
) -> EvalResult:
    """Render the config's trajectory, or the poses of dataset split
    ``split``, from ``checkpoint`` into ``savedir`` (and ``gif``);
    ``tighten_aabb``: the density threshold of ``--tighten-aabb``."""
    if renderer not in ("kernel", "plain"):
        raise ValueError(f"renderer must be 'kernel' or 'plain', got {renderer!r}")
    render_poses, h, w, focal, truth = load_render_split(
        cfg, split, white_background=bool(cfg.nerf.validation.white_background))
    model_coarse, model_fine, ckpt = load_models_and_params(checkpoint, cfg, device)
    if "height" in ckpt:
        # Optional intrinsics stored in a reference checkpoint win.
        h, w, focal = int(ckpt["height"]), int(ckpt["width"]), float(ckpt["focal_length"])
    settings = dataclasses.replace(
        render_settings_from_config(cfg, "validation", hwf=(h, w, focal)),
        compute_dtype=precision,
        use_pallas=(renderer == "kernel"),
    )
    box, box_seconds = None, 0.0
    if tighten_aabb is not None:
        if settings.use_ndc:
            raise SystemExit("--tighten-aabb is incompatible with NDC (LLFF) scenes")
        box, box_seconds = tighten_to_density_aabb(model_coarse, settings, tighten_aabb,
                                                   aabb_sweep_bounds)
        settings = dataclasses.replace(settings, aabb=box)
    render = make_pose_render_fn(model_coarse, model_fine, settings, h, w, focal, output="maps")

    os.makedirs(savedir, exist_ok=True)
    if save_disparity_image:
        os.makedirs(os.path.join(savedir, "disparity"), exist_ok=True)
    poses = render_poses[:num_poses] if num_poses > 0 else render_poses

    result = EvalResult(h, w, focal, [], [], {}, aabb=box, aabb_seconds=box_seconds)
    frames = []
    for i, pose in enumerate(poses):
        t0 = time.perf_counter()
        maps = render(torch.as_tensor(pose, dtype=torch.float32, device=device))
        maps = {k: v.cpu() for k, v in maps.items()}
        result.seconds.append(time.perf_counter() - t0)
        result.finite.append(all(bool(torch.isfinite(v.float()).all()) for v in maps.values()))
        if i == 0:
            result.first_maps = maps
        write_png(os.path.join(savedir, f"{i:04d}.png"), maps["rgb_u8"].numpy())
        if gif:
            frames.append(maps["rgb_u8"].numpy())
        if truth is not None:
            rgb = maps.get("rgb_fine", maps["rgb_coarse"]).double()
            mse = float(((rgb - torch.from_numpy(truth[i]).double()) ** 2).mean())
            result.psnrs.append(-10.0 * float(np.log10(max(mse, 1e-20))))
        if save_disparity_image:
            disp = maps.get("disp_fine", maps["disp_coarse"])
            write_png(os.path.join(savedir, "disparity", f"{i:04d}.png"),
                      cast_to_disparity_image(disp.numpy()))
        print(f"[{i:04d}] done ({result.seconds[-1]:.3f}s"
              + (f", PSNR {result.psnrs[-1]:.2f} dB)" if truth is not None else ")"), flush=True)
    if gif:
        write_gif(gif, frames, delay_cs=5, loop=0)
        print(f"wrote {gif} ({len(frames)} frames)", flush=True)
    return result


def main(argv: Optional[List[str]] = None) -> EvalResult:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--checkpoint", type=str, required=True)
    parser.add_argument("--savedir", type=str, default="rendered")
    parser.add_argument("--save-disparity-image", action="store_true")
    parser.add_argument("--num-poses", type=int, default=0,
                        help="Render only the first N poses (0 = all).")
    parser.add_argument("--gif", type=str, default="",
                        help="Also write the frames as a GIF at this path (50 ms a frame, "
                             "looping).")
    parser.add_argument("--split", choices=["render", "train", "val", "test"], default="render",
                        help="'render' = the orbit/spiral trajectory; train/val/test = that "
                             "split's camera poses, each frame's PSNR reported.")
    parser.add_argument("--overrides", type=str, nargs="*", default=None,
                        help="Dotted-key value pairs, e.g. dataset.basedir /tmp/x")
    parser.add_argument("--precision", choices=["float32", "bfloat16"], default="float32",
                        help="MLP matmul input dtype; sums stay float32.")
    parser.add_argument("--renderer", choices=["kernel", "plain"], default="kernel",
                        help="kernel (default): the fused CUDA encode+MLP kernel of "
                             "the model's family (the 4x128 10/4 FlexibleNeRF, the 8x256 "
                             "PaperNeRF; other shapes use plain); plain: positional "
                             "encoding + the module.")
    parser.add_argument("--tighten-aabb", type=float, default=None, metavar="TAU",
                        help="Sweep the checkpoint's density field once, bound the region "
                             "with post-ReLU sigma > TAU (1.0 is a good default), and "
                             "tighten every ray's sample interval to its crossing of that "
                             "box. Blender scenes only (NDC rays are incompatible).")
    parser.add_argument("--aabb-sweep-bounds", type=float, nargs=6, default=None,
                        metavar=("X0", "Y0", "Z0", "X1", "Y1", "Z1"),
                        help="Density-sweep cube for --tighten-aabb (default (-1.5, 1.5)^3, "
                             "which covers the blender scenes). The sweep warns if the "
                             "occupied region touches these bounds (clipped geometry).")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    cfg = load_config(args.config, args.overrides)
    result = render_trajectory(
        cfg, args.checkpoint, args.savedir,
        num_poses=args.num_poses, precision=args.precision, renderer=args.renderer,
        device=args.device, save_disparity_image=args.save_disparity_image,
        split=args.split, gif=args.gif, tighten_aabb=args.tighten_aabb,
        aabb_sweep_bounds=args.aabb_sweep_bounds,
    )
    n = len(result.seconds)
    rays = result.height * result.width
    print(f"rendered {n} poses at {result.height}x{result.width} on {args.device} in "
          f"{sum(result.seconds):.3f}s; steady-state {result.steady_seconds:.4f}s/img = "
          f"{rays / result.steady_seconds:,.0f} rays/s"
          + (f"; mean PSNR {np.mean(result.psnrs):.3f} dB" if result.psnrs else ""))
    if not all(result.finite):
        raise SystemExit(f"non-finite maps in frames {[i for i, ok in enumerate(result.finite) if not ok]}")
    return result


if __name__ == "__main__":
    main()
