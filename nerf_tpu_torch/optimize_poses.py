"""Refine camera poses against a trained NeRF (port of ``optimize_poses.py``).

Per-image se(3) twists are optimized by Adam against the photometric loss
with the NeRF weights frozen, differentiating through ray synthesis,
encoding, both MLPs, hierarchical resampling and compositing
(``engine/pose_opt.py``); ``--joint-train`` trains the NeRF weights with the
cameras. Every render takes the plain path (the pose gradient needs the
gradient with respect to the sample points).

Two modes:
  # Refine a split's (possibly miscalibrated) poses:
  python -m nerf_tpu_torch.optimize_poses --config cfg.yml --checkpoint ckpt \\
      --split train --save-poses refined.npz

  # Self-validating demo: perturb the poses by a KNOWN amount, then recover
  # them; reports rotation/translation error before and after:
  python -m nerf_tpu_torch.optimize_poses --config cfg.yml --checkpoint ckpt \\
      --perturb-rot-deg 2.0 --perturb-trans 0.05

The final line is one JSON record with the before/after photometric loss (a
fixed-seed evaluation) and, in perturb mode, the mean/max pose errors. It
runs on ``--device`` (default ``cuda``); ``--num-devices N`` shards the images
over N ranks (``engine.pose_opt``'s loops with a mesh; under ``torchrun`` its
group, else N spawned ranks) with the cameras replicated and one all-reduce
a step, when N divides the images (else every rank runs the serial loop, as
the JAX CLI falls back); rank 0 alone prints and writes.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import List, Optional

import numpy as np
import torch

from .config import load_config, model_from_config, optimizer_from_config
from .config import render_settings_from_config
from .data import (
    composite_white_background,
    llff_holdout_split,
    load_blender_data,
    load_llff_data,
    make_synthetic_dataset,
)
from .engine.checkpoint import convert_torch_state_dict, load_models_and_params, save_checkpoint
from .engine.pose_opt import (
    align_poses_umeyama,
    as_homogeneous,
    init_joint_train_state,
    init_pose_opt_state,
    joint_train_state,
    make_joint_train_loop,
    make_photometric_loss_fn,
    make_pose_opt_loop,
    perturb_poses,
    pose_errors,
    pose_optimizer,
    twists_to_poses,
)
from .engine.train import fold_seed
from .parallel.distributed import add_mesh_args, run_cli
from .parallel.mesh import make_mesh, replicate_params, shard_rows


def load_split_images_and_poses(cfg, split: str, device="cpu"):
    """(images (N, H, W, 3) f32, poses (N, 3, 4) f32, (h, w, focal)) of a
    split, with ``train_nerf``'s loading conventions: in particular the
    white-background compositing gate, so the targets match what the
    checkpoint was trained against."""
    ds = cfg.dataset
    if ds.type == "blender":
        images, poses, _, hwf, i_split = load_blender_data(ds.basedir, half_res=ds.half_res,
                                                           testskip=ds.testskip)
        images = (composite_white_background(images) if cfg.nerf.train.white_background
                  else images[..., :3])
        idx = i_split[{"train": 0, "val": 1, "test": 2}[split]]
        return images[idx], poses[idx, :3, :4], (int(hwf[0]), int(hwf[1]), float(hwf[2]))
    if ds.type == "llff":
        images, poses, _, _, i_holdout = load_llff_data(
            ds.basedir, factor=getattr(ds, "downsample_factor", 8),
            spherify=bool(getattr(ds, "spherify", False)),
            path_zflat=bool(getattr(ds, "path_zflat", False)))
        hwf = poses[0, :3, -1]
        i_train, i_test = llff_holdout_split(images.shape[0], int(getattr(ds, "llffhold", 8)),
                                             i_holdout)
        idx = i_train if split == "train" else i_test
        return images[idx], poses[idx, :3, :4], (int(hwf[0]), int(hwf[1]), float(hwf[2]))
    if ds.type == "synthetic":
        size = int(getattr(ds, "image_size", 64))
        dataset = make_synthetic_dataset(num_views=int(getattr(ds, "num_views", 20)),
                                         height=size, width=size, device=device)
        return dataset.images, dataset.poses[:, :3, :4], dataset.hwf
    raise ValueError(f"Unsupported dataset type {ds.type!r} for pose refinement")


def _anneal_alpha(iters_done: int, anneal: int, n_freq: float) -> float:
    """The coarse-to-fine window's alpha at ``iters_done``, quantized to
    quarter-spectrum steps as the JAX CLI quantizes it; -1 = fully open."""
    if anneal <= 0 or iters_done >= anneal:
        return -1.0
    alpha = n_freq * (round(iters_done / anneal * 4) / 4)
    return -1.0 if alpha >= n_freq else alpha


def main(argv: Optional[List[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--checkpoint", type=str, default="",
                        help="Trained checkpoint to refine against (required unless "
                             "--joint-train, where it optionally seeds the NeRF params).")
    parser.add_argument("--joint-train", action="store_true",
                        help="BARF/NeRF-- mode: train the NeRF params JOINTLY with the camera "
                             "refinement (from scratch, or finetuning --checkpoint) instead "
                             "of keeping them frozen.")
    parser.add_argument("--nerf-lr", type=float, default=0.0,
                        help="NeRF-param learning rate for --joint-train (0 = the config's "
                             "optimizer.lr).")
    parser.add_argument("--save-checkpoint", type=str, default="",
                        help="Write the jointly-trained NeRF to this .ntc (--joint-train only).")
    parser.add_argument("--anneal-iters", type=int, default=-1,
                        help="Coarse-to-fine encoding annealing horizon for --joint-train "
                             "(BARF eq. 14): xyz frequency bands ramp in linearly over this "
                             "many iters. -1 = iters/2 (default), 0 = disabled.")
    parser.add_argument("--split", choices=["train", "val", "test"], default="train")
    parser.add_argument("--iters", type=int, default=200)
    parser.add_argument("--rays-per-image", type=int, default=64,
                        help="Pixels sampled from EVERY image per step.")
    parser.add_argument("--lr", type=float, default=1.0e-3)
    parser.add_argument("--lr-final", type=float, default=0.0,
                        help="Exponentially decay the camera lr from --lr to this value over "
                             "--iters (0 = constant).")
    parser.add_argument("--steps-per-loop", type=int, default=25,
                        help="Refinement steps per loop call (one loss fetch each).")
    parser.add_argument("--max-images", type=int, default=0,
                        help="Refine only the first N images of the split (0 = all).")
    parser.add_argument("--perturb-rot-deg", type=float, default=0.0,
                        help="Demo mode: rotate every pose by this many degrees about a random "
                             "axis before refining (ground truth then known).")
    parser.add_argument("--perturb-trans", type=float, default=0.0,
                        help="Demo mode: translate every pose by this distance in a random "
                             "direction before refining.")
    parser.add_argument("--refine-focal", action="store_true",
                        help="Jointly refine a shared focal-length correction "
                             "(focal * exp(log_focal)). Non-NDC scenes only.")
    parser.add_argument("--perturb-focal", type=float, default=1.0,
                        help="Demo mode: multiply the assumed focal by this factor before "
                             "refining (use with --refine-focal).")
    parser.add_argument("--perturb-seed", type=int, default=0)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--save-poses", type=str, default="",
                        help="Write refined poses + twists to this .npz.")
    parser.add_argument("--overrides", type=str, nargs="*", default=None,
                        help="Dotted-key value pairs, e.g. dataset.basedir /tmp/distilled")
    parser.add_argument("--device", type=str, default="cuda")
    add_mesh_args(parser, "Ranks to shard the images over.")
    args = parser.parse_args(argv)
    if not args.joint_train:
        for flag, val, unset in [("--nerf-lr", args.nerf_lr, 0.0),
                                 ("--anneal-iters", args.anneal_iters, -1),
                                 ("--save-checkpoint", args.save_checkpoint, "")]:
            if val != unset:
                parser.error(f"{flag} requires --joint-train")
        if not args.checkpoint:
            parser.error("--checkpoint is required unless --joint-train")
    if args.perturb_focal != 1.0 and not args.refine_focal:
        parser.error("--perturb-focal requires --refine-focal")
    return run_cli(refine, args)


def refine(args: argparse.Namespace) -> dict:
    """One rank of ``optimize_poses``: the refinement on this rank's images
    (or all of them, serially); returns the JSON report."""
    mesh = make_mesh(args.num_devices, args.device, args.dist_backend)
    device = mesh.device
    log = print if mesh.is_primary else (lambda *a, **k: None)

    cfg = load_config(args.config, args.overrides)
    images, poses, (h, w, focal) = load_split_images_and_poses(cfg, args.split, device)
    if args.max_images > 0:
        images, poses = images[:args.max_images], poses[:args.max_images]
    n = images.shape[0]
    log(f"refining {n} {args.split} poses at {h}x{w} (focal {focal:.1f})", flush=True)
    # The JAX CLI's layout: the images shard when the devices divide them;
    # else every rank runs the serial loop.
    dp = n % mesh.world_size == 0
    loop_mesh = mesh if dp else None
    if not dp and not args.joint_train:
        log(f"serial fallback: {n} images not divisible by {mesh.world_size} devices",
            flush=True)

    if args.checkpoint:
        model_coarse, model_fine, _ = load_models_and_params(args.checkpoint, cfg, device)
    else:
        model_coarse = model_from_config(cfg.models.coarse).to(device)
        model_fine = (model_from_config(cfg.models.fine).to(device)
                      if "fine" in cfg.models else None)

    # Deterministic f32 plain settings: z-perturbation and noise would only
    # add variance to the pose gradient.
    settings = dataclasses.replace(
        render_settings_from_config(cfg, "validation", hwf=(h, w, focal)).eval_variant(),
        use_pallas=False, compute_dtype="float32")
    # Joint training keeps the TRAIN stage's stochasticity: sigma noise is
    # load-bearing against the white-background empty-scene collapse.
    train_settings = dataclasses.replace(
        render_settings_from_config(cfg, "train", hwf=(h, w, focal)),
        use_pallas=False, use_pallas_train=False, compute_dtype="float32")

    true_focal = focal
    if args.perturb_focal != 1.0:
        # The optimizer is told the wrong focal; the targets reflect the true one.
        focal = focal * args.perturb_focal
        log(f"perturbed focal: {focal:.2f} (true {true_focal:.2f})", flush=True)

    true_poses = torch.as_tensor(np.asarray(poses), dtype=torch.float32, device=device)
    ground_truth_known = args.perturb_rot_deg > 0.0 or args.perturb_trans > 0.0
    base34 = (perturb_poses(true_poses, args.perturb_seed, args.perturb_rot_deg,
                            args.perturb_trans) if ground_truth_known else true_poses)
    base44 = as_homogeneous(base34)
    images = torch.as_tensor(np.asarray(images), dtype=torch.float32, device=device)
    optimizer = pose_optimizer(args.lr, args.iters, args.lr_final)

    if args.joint_train:
        nerf_lr = args.nerf_lr if args.nerf_lr > 0 else float(cfg.optimizer.lr)
        # The training run's optimizer (schedule and clipping included) with
        # only the lr overridden.
        nerf_opt = dataclasses.replace(optimizer_from_config(cfg), lr=float(nerf_lr))
        if args.checkpoint:
            state = joint_train_state(model_coarse, model_fine, n, nerf_opt, optimizer)
        else:
            state = init_joint_train_state(model_coarse, model_fine, 1000 + args.seed, n,
                                           nerf_opt, optimizer)
        replicate_params(mesh, model_coarse, model_fine)
        # Coarse-to-fine annealing is a from-scratch device: on a pretrained
        # checkpoint, alpha < n_freq feeds the converged MLP band-masked
        # encodings it never saw, so finetuning defaults to none.
        if args.anneal_iters >= 0:
            anneal = args.anneal_iters
            if anneal > 0 and args.checkpoint:
                log("WARNING: --anneal-iters > 0 with a pretrained --checkpoint masks "
                    "encoding bands the checkpoint was trained with; expect transient "
                    "corruption.", flush=True)
        else:
            anneal = 0 if args.checkpoint else args.iters // 2
        n_freq = float(train_settings.num_encoding_fn_xyz)
        joint_loops = {}

        def joint_loop_for(iters_done: int):
            alpha = _anneal_alpha(iters_done, anneal, n_freq)
            if alpha not in joint_loops:
                st = (train_settings if alpha < 0
                      else dataclasses.replace(train_settings, pe_alpha_xyz=alpha))
                joint_loops[alpha] = make_joint_train_loop(
                    model_coarse, model_fine, st, h, w, focal, args.rays_per_image,
                    args.steps_per_loop, refine_focal=args.refine_focal, mesh=loop_mesh)
            return joint_loops[alpha]

        log(f"joint NeRF+camera training (nerf lr {nerf_lr:g}, anneal {anneal} iters)",
            flush=True)
        pose_state = state.pose
    else:
        state = pose_state = init_pose_opt_state(n, optimizer, device)
        loop = make_pose_opt_loop(model_coarse, model_fine, settings, h, w, focal,
                                  args.rays_per_image, args.steps_per_loop,
                                  refine_focal=args.refine_focal, mesh=loop_mesh)
    loop_base44, loop_images = base44, images
    if dp:
        loop_base44, loop_images = shard_rows(mesh, base44, images)
    if dp and mesh.world_size > 1:
        log(f"data-parallel over {mesh.world_size} devices", flush=True)
    # Fixed-seed evaluation: the SAME pixel sample before and after, so the
    # reported improvement is camera movement, not sampling luck.
    eval_fn = make_photometric_loss_fn(model_coarse, model_fine, settings, h, w, focal,
                                       max(args.rays_per_image, 256),
                                       refine_focal=args.refine_focal)
    eval_seed = 10_000 + args.seed

    def eval_loss() -> float:
        with torch.no_grad():
            return float(eval_fn(pose_state.opt_params, base44, images, eval_seed))

    initial_loss = eval_loss()
    t0 = time.time()
    num_loops = max(1, -(-args.iters // args.steps_per_loop))
    for i in range(num_loops):
        step_seed = fold_seed(args.seed, i)
        if args.joint_train:
            state, losses = joint_loop_for(i * args.steps_per_loop)(
                state, loop_base44, loop_images, step_seed)
        else:
            state, losses = loop(state, loop_base44, loop_images, step_seed)
        log(f"[{(i + 1) * args.steps_per_loop:5d}] loss {float(losses[-1]):.6f} "
            f"({time.time() - t0:.1f}s)", flush=True)
    final_loss = eval_loss()

    with torch.no_grad():
        refined = twists_to_poses(pose_state.xi, base44)
        report = {
            "num_poses": n,
            "iters": num_loops * args.steps_per_loop,
            "initial_loss": initial_loss,
            "final_loss": final_loss,
            "wall_s": round(time.time() - t0, 1),
        }
        if args.refine_focal:
            refined_focal = focal * float(torch.exp(pose_state.log_focal))
            report.update(initial_focal=focal, refined_focal=refined_focal,
                          true_focal=true_focal,
                          focal_error_pct=round(100.0 * abs(refined_focal - true_focal)
                                                / true_focal, 3))
        if ground_truth_known:
            before = {k: v.cpu().numpy() for k, v in pose_errors(base34, true_poses).items()}
            after = {k: v.cpu().numpy() for k, v in pose_errors(refined, true_poses).items()}
            report.update(
                initial_rot_deg_mean=float(before["rot_deg"].mean()),
                final_rot_deg_mean=float(after["rot_deg"].mean()),
                final_rot_deg_max=float(after["rot_deg"].max()),
                initial_trans_mean=float(before["trans"].mean()),
                final_trans_mean=float(after["trans"].mean()),
                final_trans_max=float(after["trans"].max()),
            )
            if args.joint_train:
                # Scene and cameras drift together under joint training: only
                # Sim(3)-aligned errors mean anything.
                aligned = {k: v.cpu().numpy() for k, v in pose_errors(
                    align_poses_umeyama(refined, true_poses), true_poses).items()}
                report.update(aligned_rot_deg_mean=float(aligned["rot_deg"].mean()),
                              aligned_trans_mean=float(aligned["trans"].mean()))
    if args.joint_train:
        report["mode"] = "joint"
        if args.save_checkpoint and mesh.is_primary:
            os.makedirs(os.path.dirname(args.save_checkpoint) or ".", exist_ok=True)
            save_checkpoint(args.save_checkpoint, {
                "step": np.asarray(num_loops * args.steps_per_loop),
                "params_coarse": convert_torch_state_dict(model_coarse.state_dict()),
                "params_fine": (convert_torch_state_dict(model_fine.state_dict())
                                if model_fine is not None else None),
                "loss": np.asarray(final_loss),
            })
        if args.save_checkpoint:
            report["saved_checkpoint"] = args.save_checkpoint
    if args.save_poses and mesh.is_primary:
        os.makedirs(os.path.dirname(args.save_poses) or ".", exist_ok=True)
        np.savez(args.save_poses, poses=refined.cpu().numpy(),
                 xi=pose_state.xi.detach().cpu().numpy(),
                 log_focal=pose_state.log_focal.detach().cpu().numpy(),
                 base_poses=base34.cpu().numpy())
    if args.save_poses:
        report["saved"] = args.save_poses
    log(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
