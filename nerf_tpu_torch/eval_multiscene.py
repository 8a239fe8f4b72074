"""Score every scene of a multi-scene run in one process (port of
``eval_multiscene.py``).

Given a root of per-scene checkpoint directories (``train_multiscene
--save-dir``'s layout) and a root of per-scene datasets, renders each
scene's held-out split from its newest ``.ntc`` and reports per-scene PSNR
and SSIM against the ground truth (``utils/metrics.py``, the JAX package's
numbers bitwise), then one JSON summary line. LLFF scenes are found by a
``poses_bounds.npy`` in the scene's data directory and scored under
``--llff-config``'s NDC protocol, so one call scores a mixed blender + LLFF
run. Scenes that share a protocol and intrinsics share their render
settings; a scene with other intrinsics gets its own.

``--renderer pallas`` (the default) evaluates the field through the
hand-written CUDA kernel of the model's family (#1 ``fused_mlp_t`` for the
4x128 10/4 FlexibleNeRF, #4 for PaperNeRF; other shapes run plain), and
``--renderer xla`` through positional encoding + the module: the JAX CLI's
names for the two paths.

Usage:
  python -m nerf_tpu_torch.eval_multiscene --config cfg.py \\
    --ckpt-root ckpts --data-root distilled --split val [--savedir renders]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .config import load_config, render_settings_from_config
from .data import (
    composite_white_background,
    llff_holdout_split,
    load_blender_data,
    load_llff_data,
)
from .engine.checkpoint import latest_checkpoint, load_models_and_params
from .engine.renderer import make_pose_render_fn
from .utils.metrics import psnr, ssim
from .utils.png import write_png


def evaluate(cfg, ckpt_root: str, data_root: str, scenes: Optional[List[str]] = None,
             split: str = "val", half_res: bool = True, savedir: str = "",
             precision: str = "float32", renderer: str = "pallas",
             llff_config: str = "configs/fern_lowres.yml", llff_factor: int = 1,
             device: str = "cuda") -> Dict:
    """Score the scenes and return the JSON summary; ``llff_config`` is read
    at the first LLFF scene."""
    if renderer not in ("pallas", "xla"):
        raise ValueError(f"renderer must be 'pallas' or 'xla', got {renderer!r}")
    if scenes is None:
        scenes = sorted(d for d in os.listdir(ckpt_root)
                        if os.path.isdir(os.path.join(ckpt_root, d)))
    if not scenes:
        raise SystemExit(f"no scene dirs under {ckpt_root}")
    settings_cache = {}
    llff_cfg = None

    def get_settings(scene_cfg, tag, h, w, focal):
        key = (tag, h, w, round(focal, 6))
        if key not in settings_cache:
            settings_cache[key] = dataclasses.replace(
                render_settings_from_config(scene_cfg, "validation", hwf=(h, w, focal)),
                compute_dtype=precision, use_pallas=(renderer == "pallas"))
        return settings_cache[key]

    results = {}
    t0 = time.time()
    for scene in scenes:
        scene_dir = os.path.join(data_root, scene)
        if os.path.exists(os.path.join(scene_dir, "poses_bounds.npy")):
            if llff_cfg is None:
                llff_cfg = load_config(llff_config)
            images, poses_full, _bds, _rp, _ = load_llff_data(scene_dir, factor=llff_factor)
            hwf = poses_full[0, :3, -1]
            poses = poses_full[:, :3, :4]
            images = images[..., :3]
            i_train, i_hold = llff_holdout_split(images.shape[0])
            sel = i_train if split == "train" else i_hold
            scene_cfg, tag = llff_cfg, "llff"
        else:
            images, poses, _, hwf, i_split = load_blender_data(scene_dir, half_res=half_res)
            # Onto white only when the renderer composites onto white too.
            if bool(cfg.nerf.validation.white_background):
                images = composite_white_background(images)
            sel = i_split[{"train": 0, "val": 1, "test": 2}[split]]
            scene_cfg, tag = cfg, "blender"
        if len(sel) == 0:
            raise SystemExit(f"scene {scene!r} has no views in split {split!r}")
        h, w, focal = int(hwf[0]), int(hwf[1]), float(hwf[2])
        settings = get_settings(scene_cfg, tag, h, w, focal)

        ckpt_path = latest_checkpoint(os.path.join(ckpt_root, scene), suffix=".ntc")
        if ckpt_path is None:
            raise FileNotFoundError(
                f"no .ntc checkpoints under {os.path.join(ckpt_root, scene)}")
        model_coarse, model_fine, ckpt = load_models_and_params(ckpt_path, scene_cfg, device)
        render = make_pose_render_fn(model_coarse, model_fine, settings, h, w, focal,
                                     output="f32")
        outdir = os.path.join(savedir, scene) if savedir else ""
        if outdir:
            os.makedirs(outdir, exist_ok=True)
        psnrs, ssims = [], []
        for k, i in enumerate(sel):
            pose34 = torch.as_tensor(poses[i, :3, :4], dtype=torch.float32, device=device)
            pred = render(pose34).cpu().numpy()
            gt = np.asarray(images[i][..., :3], np.float32)
            psnrs.append(float(psnr(pred, gt)))
            ssims.append(float(ssim(pred, gt)))
            if outdir:
                write_png(os.path.join(outdir, f"{split}_{k:03d}.png"),
                          (pred * 255).astype(np.uint8))
        results[scene] = {
            "checkpoint": os.path.basename(ckpt_path),
            "step": int(np.asarray(ckpt.get("step", -1))),
            "num_views": len(sel),
            "psnr_mean": round(float(np.mean(psnrs)), 3),
            "psnr_min": round(float(np.min(psnrs)), 3),
            "ssim_mean": round(float(np.mean(ssims)), 4),
        }
        r = results[scene]
        print(f"[{scene}] {r['checkpoint']} {split} x{r['num_views']}: psnr "
              f"{r['psnr_mean']:.2f} (min {r['psnr_min']:.2f}) ssim {r['ssim_mean']:.4f}",
              flush=True)
    return {
        "split": split,
        "scenes": results,
        "psnr_mean_over_scenes": round(
            float(np.mean([r["psnr_mean"] for r in results.values()])), 3),
        "elapsed_s": round(time.time() - t0, 1),
    }


def main(argv: Optional[List[str]] = None) -> Dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", required=True,
                        help="Protocol config (model shape + sampling settings); must match "
                             "what the scenes were trained with.")
    parser.add_argument("--ckpt-root", required=True,
                        help="Directory of per-scene checkpoint dirs (train_multiscene "
                             "--save-dir layout).")
    parser.add_argument("--data-root", required=True,
                        help="Directory of per-scene datasets (one subdir per scene, names "
                             "matching --ckpt-root).")
    parser.add_argument("--scenes", nargs="*", default=None,
                        help="Scene names (default: every subdir of --ckpt-root).")
    parser.add_argument("--split", choices=["train", "val", "test"], default="val")
    parser.add_argument("--half-res", action=argparse.BooleanOptionalAction, default=True,
                        help="Load datasets at half resolution (train_multiscene's default); "
                             "--no-half-res for datasets at the target resolution.")
    parser.add_argument("--savedir", default="",
                        help="If set, also write rendered PNGs to savedir/<scene>/.")
    parser.add_argument("--precision", choices=["bfloat16", "float32"], default="float32")
    parser.add_argument("--renderer", choices=["pallas", "xla"], default="pallas",
                        help="pallas: the family's CUDA kernel; xla: encoding + the module.")
    parser.add_argument("--llff-config", default="configs/fern_lowres.yml",
                        help="Protocol config for LLFF scenes (found by a poses_bounds.npy "
                             "in the scene's data dir).")
    parser.add_argument("--llff-factor", type=int, default=1,
                        help="LLFF image downsample factor (1 for distilled sets).")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    if args.scenes is not None and not args.scenes:
        raise SystemExit("--scenes given but empty")
    summary = evaluate(
        load_config(args.config), args.ckpt_root, args.data_root, scenes=args.scenes,
        split=args.split, half_res=args.half_res, savedir=args.savedir,
        precision=args.precision, renderer=args.renderer, llff_config=args.llff_config,
        llff_factor=args.llff_factor, device=args.device)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
