#!/usr/bin/env python3
"""Drive the PyTorch port's render and training paths on one NVIDIA GPU and check them.

Run from the root of a checkout, with one card:

    python3 chip_smoke.py

Phases, one or more lines each:
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
  2. build: compile ``nerf_tpu_torch/csrc`` with nvcc for sm_90a;
  3. kernel vs plain: the fused encode+MLP kernel against its plain PyTorch
     version at the render path's shapes, float32 and bfloat16;
  4. main path: ``nerf_tpu_torch.eval_nerf.render_trajectory`` renders three
     400x400 orbit frames of the flagship 4x128 FlexibleNeRF
     (``configs/lego_fused.yml``, seeded random weights saved as a reference
     ``.ckpt``), and must have gone through the kernel; frame 0 is held
     against the plain path;
  5. times on this card: the kernel against the plain version at one
     fine-pass chunk, and seconds per 400x400 frame for both paths;
  6. training kernels vs plain: the fused FlexibleNeRF forward + backward
     pair against its plain PyTorch version at the training path's shapes,
     float32 and bfloat16: the forward, every parameter gradient and ddc;
  7. training main path: ``nerf_tpu_torch.train_nerf.train`` trains the
     flagship model at the ``configs/lego_fused.yml`` train protocol (bf16,
     training kernels on) on the procedural synthetic scene (20 views of
     400x400) for TRAIN_STEPS steps, through both training kernels; the loss
     must fall; the checkpoint it writes is rendered at a novel orbit pose
     through ``eval_nerf.render_trajectory`` and the forward kernel, and must
     clear PSNR_FLOOR_TRAINED_DB against the analytic scene; a float32
     trajectory through the kernels must track the plain path's;
  8. times on this card: the training kernels against the plain pair, and
     rays per second of a training step on the kernel and plain paths.

Then one JSON line of per-kernel results and, last, the JSON device line.
Any failure raises: the script exits non-zero and prints no result. There is
no CPU path: without CUDA it exits with code 2.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

F32_TOL = 1e-4          # kernel vs plain, float32: summation order, sincosf vs sin
BF16_TOL = 2e-2         # kernel vs bf16-emulating plain: bf16 roundings that flip
RENDER_RGB_TOL = 1e-3   # float32 frame, kernel path vs plain path
PSNR_FLOOR_DB = 37.5    # bf16 kernel frame vs float32 plain frame (bench.py guard floor)
MAX_RESAMPLE_PIXELS = 160  # fine-pass pixels whose resampled depths may move (0.1%)
NUM_POSES = 3
SEED = 0
KERNEL_CHUNK = (131072, 128)   # one fine-pass chunk: rays x samples
TRAIN_CHECK_SHAPES = ((1024, 64), (1024, 128), (333, 61))   # coarse, fine, ragged
TRAIN_SHAPE = (1024, 128)      # the fine pass of a 1024-ray training step
TRAIN_STEPS = 300
TRAJECTORY_STEPS = 20
TRAJECTORY_RTOL = 2e-3         # f32 loss per step, kernel path vs plain path
PSNR_FLOOR_TRAINED_DB = 30.0   # novel view after TRAIN_STEPS steps (37.64 dB measured on an H100)
TIMED_STEPS = 30
# The render path's shapes, and one whose points end mid-tile.
CHECK_SHAPES = ((2048, 64), (2048, 128), (1000, 128), (333, 61))
DEVICE = "cuda"
# Multiply-adds per point of the 4x128 10/4 FlexibleNeRF forward, dir
# contribution excluded: 63x128 + 3x128x128 + 128x129 + 128x64 + 64x3.
MACS_PER_POINT = 63 * 128 + 3 * 128 * 128 + 128 * 129 + 128 * 64 + 64 * 3


def lego_fused_config():
    """``configs/lego_fused.yml``'s values merged over the defaults, in code
    (no YAML reader needed)."""
    from nerf_tpu_torch.config import get_default_config

    cfg = get_default_config()
    cfg.set_new_allowed(True)
    pairs = [
        "dataset.type", "blender", "dataset.basedir", "cache/nerf_synthetic/lego",
        "dataset.half_res", True, "dataset.testskip", 1, "dataset.no_ndc", True,
        "dataset.near", 2, "dataset.far", 6, "dataset.height", 400, "dataset.width", 400,
    ]
    model = {
        "type": "FlexibleNeRFModel", "num_layers": 4, "hidden_size": 128,
        "skip_connect_every": 4, "num_encoding_fn_xyz": 10, "num_encoding_fn_dir": 4,
        "use_viewdirs": True,
    }
    for which in ("coarse", "fine"):
        for key, value in model.items():
            pairs += [f"models.{which}.{key}", value]
    validation = {
        "chunksize": 131072, "perturb": False, "num_coarse": 64, "num_fine": 64,
        "white_background": True, "radiance_field_noise_std": 0.0, "lindisp": False,
    }
    for key, value in validation.items():
        pairs += [f"nerf.validation.{key}", value]
    train = dict(validation, num_random_rays=1024, perturb=True, radiance_field_noise_std=0.2,
                 compute_dtype="bfloat16", use_pallas_train=True)
    for key, value in train.items():
        pairs += [f"nerf.train.{key}", value]
    pairs += [
        "experiment.id", "lego-fused", "experiment.logdir", "logs", "experiment.randomseed", 42,
        "experiment.train_iters", 200000, "experiment.validate_every", 1000,
        "experiment.save_every", 5000, "experiment.print_every", 100,
        "optimizer.type", "Adam", "optimizer.lr", 5.0e-3,
        "scheduler.lr_decay", 250, "scheduler.lr_decay_factor", 0.1,
    ]
    cfg.merge_from_list(pairs)
    return cfg


def synthetic_train_config(train_iters: int):
    """The flagship protocol with its dataset replaced by the procedural
    synthetic scene (20 views of 400x400, a 3.2M-ray store), cut to
    ``train_iters`` steps."""
    cfg = lego_fused_config()
    cfg.merge_from_list(["dataset.type", "synthetic", "dataset.num_views", 20,
                         "dataset.image_size", 400, "experiment.train_iters", train_iters])
    return cfg


def seeded_model(seed: int, opacify: bool):
    """The flagship FlexibleNeRF with weights from ``seed``.

    ``opacify`` scales every weight by 3 and adds 2 to the density bias, as
    bench.py's numerics guard does: plain random fields render almost empty,
    and a white frame would make every image comparison pass trivially.
    """
    import torch

    from nerf_tpu_torch.models import FlexibleNeRFModel

    model = FlexibleNeRFModel(num_encoding_fn_xyz=10, num_encoding_fn_dir=4,
                              generator=torch.Generator().manual_seed(seed))
    if opacify:
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(3.0)
            model.fc_alpha.bias.add_(2.0)
    return model.eval()


def orbit_points(num_rays: int, num_samples: int, device, seed: int):
    """Points as the render path makes them: random pixels of the 400x400
    orbit frames, at sorted depths in [near, far] = [2, 6]."""
    import torch

    from nerf_tpu_torch.data import spherical_render_poses
    from nerf_tpu_torch.ops import get_ray_bundle

    gen = torch.Generator(device=device).manual_seed(seed)
    side = 400
    focal = 0.5 * side / math.tan(0.5 * 0.6911112070083618)
    poses = torch.as_tensor(spherical_render_poses(40, phi=-30.0, radius=4.0),
                            dtype=torch.float32, device=device)
    pose = poses[int(torch.randint(40, (1,), generator=gen, device=device))][:3, :4]
    ro, rd = get_ray_bundle(side, side, focal, pose)
    pick = torch.randint(side * side, (num_rays,), generator=gen, device=device)
    ro, rd = ro.reshape(-1, 3)[pick], rd.reshape(-1, 3)[pick]
    z, _ = torch.sort(2.0 + 4.0 * torch.rand(num_rays, num_samples, generator=gen,
                                             device=device), dim=-1)
    pts = ro[:, None, :] + rd[:, None, :] * z[..., None]
    return pts, rd / torch.linalg.norm(rd, dim=-1, keepdim=True)


def check_resample_outliers(cfg, pixels, hwf) -> None:
    """Hold the fine pass at the pixels where the two paths' frames differ
    against itself on common depth samples, and fail if they still differ.

    ``sample_pdf`` keeps the reference's ``denom < 1e-5`` guard, so a fine
    sample jumps across a bin when a coarse weight sits on that edge (a bin
    of weight ~6e-9 has a floored pdf of ~1e-5). Coarse weights that agree to
    1e-7 can then give depths a bin apart, and fine colours that differ. So
    at each such pixel the fine stage is run again, through the kernel and
    through the plain model, on the same depths (the kernel path's), and the
    two composited colours must agree to ``RENDER_RGB_TOL``.
    """
    import torch

    from nerf_tpu_torch.config import render_settings_from_config
    from nerf_tpu_torch.data import resolve_render_poses
    from nerf_tpu_torch.engine.renderer import encode_points, render_rays
    from nerf_tpu_torch.kernels.mlp_t import fused_mlp_t
    from nerf_tpu_torch.ops import (
        coarse_z_values, get_ray_bundle, sample_pdf, volume_render_radiance_field,
    )

    h, w, focal = hwf
    poses = resolve_render_poses(cfg)[0]
    ro, rd = get_ray_bundle(h, w, focal, torch.as_tensor(poses[0], device=DEVICE))
    ro, rd = ro.reshape(-1, 3)[pixels], rd.reshape(-1, 3)[pixels]
    vd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    s = render_settings_from_config(cfg, "validation", hwf=hwf)
    mc = seeded_model(SEED, opacify=True).to(DEVICE)
    mf = seeded_model(SEED + 1, opacify=True).to(DEVICE)
    with torch.inference_mode():
        z = coarse_z_values(torch.full((len(pixels),), s.near, device=DEVICE), s.far,
                            s.num_coarse)
        z_mid = 0.5 * (z[:, 1:] + z[:, :-1])
        coarse = {k: render_rays(mc, None, ro, rd, dataclasses.replace(s, use_pallas=k,
                                                                        num_fine=0)).coarse
                  for k in (True, False)}
        z_fine = {k: sample_pdf(z_mid, c.weights[:, 1:-1], s.num_fine, det=True)
                  for k, c in coarse.items()}
        z_all, _ = torch.sort(torch.cat([z, z_fine[True]], dim=-1), dim=-1)
        pts = ro[:, None, :] + rd[:, None, :] * z_all[..., None]
        rgb = {
            "kernel": fused_mlp_t(mf, pts, vd),
            "plain": mf(encode_points(pts, vd, s)),
        }
        rgb = {k: volume_render_radiance_field(v, z_all, rd, white_background=True).rgb
               for k, v in rgb.items()}
    w_err = (coarse[True].weights - coarse[False].weights).abs().amax(dim=-1)
    z_err = (z_fine[True] - z_fine[False]).abs().amax(dim=-1)
    same_z_err = (rgb["kernel"] - rgb["plain"]).abs().amax(dim=-1)
    print(f"[main]   at those pixels: coarse weights differ by at most {float(w_err.max()):.3e}, "
          f"resampled z by {float(z_err.min()):.3e} to {float(z_err.max()):.3e}; "
          f"on common z, rgb_fine kernel vs plain differ by at most "
          f"{float(same_z_err.max()):.3e}")
    check(bool((same_z_err <= RENDER_RGB_TOL).all()),
          "rgb_fine outliers that differ on common depth samples")


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs, by CUDA events,
    after one warm-up run."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def frame_seconds(render, pose) -> float:
    """Host seconds for one frame, ending in a synchronize."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    render(pose)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def psnr(a, b) -> float:
    mse = float(((a.double() - b.double()) ** 2).mean())
    return -10.0 * math.log10(max(mse, 1e-12))


def train_case(n: int, s: int, model, dev, seed: int):
    """Inputs of the training kernel pair at a training pass's shape: orbit
    points, the direction contribution, the packed parameters and a random
    cotangent."""
    import torch

    from nerf_tpu_torch.kernels.mlp_t import dir_contribution, pack_params

    pts, vd = orbit_points(n, s, dev, seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    g = torch.randn(n, s, 4, generator=gen, device=dev)
    return pts, dir_contribution(model, vd).detach(), pack_params(model).detach(), g


def check_training_kernels(model, dev) -> dict:
    """Phase 6: the training kernel pair against its plain version. Returns
    the worst error of each kernel per dtype (gradients scaled by the plain
    gradient's largest entry, per leaf)."""
    import torch

    from nerf_tpu_torch.kernels.flex_train import (
        flex_train_bwd, flex_train_fwd, flex_train_plain_bwd, flex_train_plain_fwd,
        unpack_params,
    )

    worst = {(k, d): 0.0 for k in ("fwd", "bwd") for d in ("float32", "bfloat16")}
    for n, s in TRAIN_CHECK_SHAPES:
        pts, dc, params, g = train_case(n, s, model, dev, seed=n * s)
        for dtype, tol in (("float32", F32_TOL), ("bfloat16", BF16_TOL)):
            out, res = flex_train_fwd(pts, dc, params, dtype)
            grad, ddc = flex_train_bwd(g, res, params, n, s, dtype)
            torch.cuda.synchronize()
            want, want_res = flex_train_plain_fwd(pts, dc, params, dtype)
            want_grad, want_ddc = flex_train_plain_bwd(g, want_res, params, n, s, dtype)
            check(bool(torch.isfinite(out).all() and torch.isfinite(grad).all()
                       and torch.isfinite(ddc).all()), f"training kernels at ({n}, {s}) {dtype}")
            f_err = float((out - want).abs().max())
            errs = {"ddc": float((ddc - want_ddc).abs().max() / want_ddc.abs().max())}
            got_leaves = unpack_params(grad)
            for name, leaves in unpack_params(want_grad).items():
                for leaf, got, ref in zip(("weight", "bias"), got_leaves[name], leaves):
                    errs[f"{name}.{leaf}"] = float((got - ref).abs().max()
                                                   / ref.abs().max().clamp(min=1e-30))
            b_name, b_err = max(errs.items(), key=lambda kv: kv[1])
            worst["fwd", dtype] = max(worst["fwd", dtype], f_err)
            worst["bwd", dtype] = max(worst["bwd", dtype], b_err)
            print(f"[train-kernel] ({n}, {s}) {dtype}: forward max |kernel - plain| = "
                  f"{f_err:.3e}; gradients (16 leaves + ddc) max |kernel - plain| / max |plain| "
                  f"= {b_err:.3e} at {b_name} (tol {tol:g})")
            check(f_err <= tol, f"training forward at ({n}, {s}) {dtype}: {f_err} > {tol}")
            check(b_err <= tol, f"training gradient {b_name} at ({n}, {s}) {dtype}: {b_err} > {tol}")
    return worst


def training_loss_trajectories(cfg, dev):
    """Phase 7, part 3: TRAJECTORY_STEPS float32 steps (perturb off, noise
    0) through the training kernels and through the plain path, from the same
    seeded models, on the same seeded ray batches. Returns both loss lists."""
    import torch

    from nerf_tpu_torch.config import optimizer_from_config, render_settings_from_config
    from nerf_tpu_torch.data import flatten_rays, make_synthetic_dataset
    from nerf_tpu_torch.engine.train import create_train_state, make_train_loop

    data = make_synthetic_dataset(num_views=4, height=100, width=100, device=dev)
    store = [torch.as_tensor(a, device=dev) for a in flatten_rays(data, dev)]
    base = dataclasses.replace(render_settings_from_config(cfg, "train", hwf=data.hwf),
                               perturb=False, radiance_field_noise_std=0.0,
                               compute_dtype="float32")
    losses = {}
    for label, kernel in (("kernel", True), ("plain", False)):
        mc = seeded_model(SEED, opacify=False).train().to(dev)
        mf = seeded_model(SEED + 1, opacify=False).train().to(dev)
        state = create_train_state(mc, mf, optimizer_from_config(cfg))
        loop = make_train_loop(mc, mf, dataclasses.replace(base, use_pallas_train=kernel),
                               int(cfg.nerf.train.num_random_rays), TRAJECTORY_STEPS)
        state, metrics = loop(state, *store, SEED)
        losses[label] = metrics.loss.cpu()
    return losses["kernel"], losses["plain"]


def train_main_path(cfg, tmp: str, dev) -> dict:
    """Phase 7: train through ``train_nerf.train`` and check what it did and
    what it wrote. Returns the launch counts and the numbers it printed."""
    import torch

    from nerf_tpu_torch.data import render_analytic_image, resolve_render_poses
    from nerf_tpu_torch.eval_nerf import render_trajectory
    from nerf_tpu_torch.kernels.flex_train import fused_flex_mlp_train
    from nerf_tpu_torch.kernels.mlp_t import fused_mlp_t
    from nerf_tpu_torch.train_nerf import train

    fused_flex_mlp_train.fwd_launches = fused_flex_mlp_train.bwd_launches = 0
    run = train(cfg, logdir=os.path.join(tmp, "train"), device=DEVICE)
    launches = {"fwd": fused_flex_mlp_train.fwd_launches,
                "bwd": fused_flex_mlp_train.bwd_launches}
    steps = len(run.losses)
    print(f"[train] {steps} steps of {cfg.nerf.train.num_random_rays} rays, "
          f"{cfg.nerf.train.compute_dtype}: {launches['fwd']} forward and {launches['bwd']} "
          f"backward kernel launches (expected {2 * steps} each); "
          f"{run.rays_per_sec:,.0f} rays/s over {run.seconds:.2f} s")
    check(steps == TRAIN_STEPS, f"{steps} steps trained")
    check(launches["fwd"] == 2 * steps and launches["bwd"] == 2 * steps,
          f"training kernel launches {launches} != {2 * steps} each")
    losses = torch.tensor(run.losses)
    check(bool(torch.isfinite(losses).all()), "non-finite training loss")
    first, last = float(losses[:20].mean()), float(losses[-20:].mean())
    print(f"[train] mean loss of the first 20 steps {first:.5f}, of the last 20 {last:.5f}; "
          f"validation PSNR {run.val_psnrs[-1]:.2f} dB")
    check(last < first, f"the loss did not fall: {first} -> {last}")
    check(run.checkpoint is not None and os.path.exists(run.checkpoint), "no checkpoint")

    fused_mlp_t.launches = 0
    rendered = render_trajectory(cfg, run.checkpoint, os.path.join(tmp, "trained"),
                                 num_poses=1, renderer="kernel", device=DEVICE)
    render_launches = fused_mlp_t.launches
    check(render_launches > 0 and all(rendered.finite), "trained render did not use the kernel")
    poses, h, w, focal = resolve_render_poses(cfg)
    truth = torch.as_tensor(render_analytic_image(h, w, focal, poses[0], device=dev))
    db = psnr(rendered.first_maps["rgb_fine"], truth)
    print(f"[train] the trained checkpoint rendered at orbit pose 0 (a novel view) through "
          f"the forward kernel ({render_launches} launches): PSNR {db:.2f} dB against the "
          f"analytic scene (floor {PSNR_FLOOR_TRAINED_DB})")
    check(db >= PSNR_FLOOR_TRAINED_DB, f"trained render PSNR {db} < {PSNR_FLOOR_TRAINED_DB}")

    kernel, plain = training_loss_trajectories(cfg, dev)
    rel = float(((kernel - plain).abs() / plain.abs()).max())
    print(f"[train] {TRAJECTORY_STEPS}-step float32 trajectory, kernel path vs plain path: "
          f"loss {float(kernel[0]):.5f} -> {float(kernel[-1]):.5f}, max relative difference "
          f"per step {rel:.3e} (tol {TRAJECTORY_RTOL:g})")
    check(rel <= TRAJECTORY_RTOL, f"kernel vs plain trajectory: {rel} > {TRAJECTORY_RTOL}")
    return {"launches": launches, "render_launches": render_launches, "psnr": db,
            "rays_per_sec": run.rays_per_sec}


def time_training(cfg, dev, on: str) -> dict:
    """Phase 8: the training kernel pair against the plain pair at
    TRAIN_SHAPE, and training-step rays/s on the kernel and plain paths, in
    turns (plain, kernel, kernel, plain)."""
    import torch

    from nerf_tpu_torch.config import optimizer_from_config, render_settings_from_config
    from nerf_tpu_torch.data import flatten_rays, make_synthetic_dataset
    from nerf_tpu_torch.engine.train import create_train_state, make_train_loop
    from nerf_tpu_torch.kernels.flex_train import (
        flex_train_bwd, flex_train_fwd, flex_train_plain_bwd, flex_train_plain_fwd,
    )

    times = {}
    model = seeded_model(SEED, opacify=False).to(dev)
    n, s = TRAIN_SHAPE
    pts, dc, params, g = train_case(n, s, model, dev, seed=3)
    for dtype in ("float32", "bfloat16"):
        _, res = flex_train_fwd(pts, dc, params, dtype)
        _, plain_res = flex_train_plain_fwd(pts, dc, params, dtype)
        fns = {
            "fwd": (lambda: flex_train_fwd(pts, dc, params, dtype),
                    lambda: flex_train_plain_fwd(pts, dc, params, dtype)),
            "bwd": (lambda: flex_train_bwd(g, res, params, n, s, dtype),
                    lambda: flex_train_plain_bwd(g, plain_res, params, n, s, dtype)),
        }
        for which, (kernel, plain) in fns.items():
            p1, k1, k2, p2 = (cuda_ms(f, 10) for f in (plain, kernel, kernel, plain))
            times[which, dtype] = ((k1 + k2) / 2, (p1 + p2) / 2)
            print(f"[time] fused_flex_mlp_train {which} ({n}, {s}) {dtype}: kernel "
                  f"{k1:.3f} / {k2:.3f} ms, plain {p1:.3f} / {p2:.3f} ms {on}")
        del res, plain_res

    data = make_synthetic_dataset(num_views=4, height=100, width=100, device=dev)
    store = [torch.as_tensor(a, device=dev) for a in flatten_rays(data, dev)]
    batch = int(cfg.nerf.train.num_random_rays)
    base = render_settings_from_config(cfg, "train", hwf=data.hwf)
    loops = {}
    for dtype in ("float32", "bfloat16"):
        for label, kernel in (("plain", False), ("kernel", True)):
            mc = seeded_model(SEED, opacify=False).train().to(dev)
            mf = seeded_model(SEED + 1, opacify=False).train().to(dev)
            settings = dataclasses.replace(base, use_pallas_train=kernel, compute_dtype=dtype)
            state = create_train_state(mc, mf, optimizer_from_config(cfg))
            loop = make_train_loop(mc, mf, settings, batch, TIMED_STEPS)
            state, _ = loop(state, *store, SEED)      # warm-up
            loops[label, dtype] = (loop, state)
    torch.cuda.reset_peak_memory_stats()
    for dtype in ("float32", "bfloat16"):
        secs = {}
        for label in ("plain", "kernel", "kernel", "plain"):
            loop, state = loops[label, dtype]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = loop(state, *store, SEED)
            metrics.loss.cpu()
            torch.cuda.synchronize()
            secs.setdefault(label, []).append(time.perf_counter() - t0)
        for label, turns in secs.items():
            rates = [batch * TIMED_STEPS / t for t in turns]
            times["step", label, dtype] = sum(rates) / len(rates)
            print(f"[time] training step, {batch} rays, {base.num_coarse}+{base.num_fine} "
                  f"samples, {label} path {dtype}: "
                  f"{' / '.join(f'{1e3 * t / TIMED_STEPS:.3f}' for t in turns)} ms/step, "
                  f"{' / '.join(f'{r:,.0f}' for r in rates)} rays/s {on}")
    print(f"[time] peak device memory over those training steps: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB {on}")
    return times


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        return 2

    from nerf_tpu_torch.config import render_settings_from_config
    from nerf_tpu_torch.data import resolve_render_poses
    from nerf_tpu_torch.engine.renderer import make_pose_render_fn
    from nerf_tpu_torch.eval_nerf import render_trajectory
    from nerf_tpu_torch.kernels import _build
    from nerf_tpu_torch.kernels.mlp_t import fused_mlp_t, mlp_t_plain

    dev = torch.device(DEVICE)
    # Phase 1: device.
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[device] {card}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} cards {torch.cuda.device_count()}")
    on = f"({card})"

    # Phase 2: build.
    t0 = time.perf_counter()
    lib = _build.build_library()
    print(f"[build] {lib.name} in {time.perf_counter() - t0:.2f} s")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")

    # Phase 3: kernel vs plain at the render path's shapes.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = seeded_model(SEED, opacify=False).to(dev)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    with torch.inference_mode():
        for n, s in CHECK_SHAPES:
            pts, vd = orbit_points(n, s, dev, seed=n + s)
            for dtype, tol in (("float32", F32_TOL), ("bfloat16", BF16_TOL)):
                got = fused_mlp_t(model, pts, vd, dtype)
                torch.cuda.synchronize()
                want = mlp_t_plain(model, pts, vd, dtype)
                torch.cuda.synchronize()
                check(got.shape == (n, s, 4) and bool(torch.isfinite(got).all()),
                      f"kernel output at ({n}, {s}) {dtype}")
                err = float((got - want).abs().max())
                worst[dtype] = max(worst[dtype], err)
                print(f"[kernel] ({n}, {s}) {dtype}: max |kernel - plain| = {err:.3e} "
                      f"(tol {tol:g}), max |plain| = {float(want.abs().max()):.3e}")
                check(err <= tol, f"kernel vs plain at ({n}, {s}) {dtype}: {err} > {tol}")

    # Phase 4: the main path, through the eval entry point.
    cfg = lego_fused_config()
    rays = int(cfg.dataset.height) * int(cfg.dataset.width)
    chunk = int(cfg.nerf.validation.chunksize)
    expected = 2 * math.ceil(rays / chunk) * NUM_POSES   # coarse + fine per chunk
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "lego_fused_seeded.ckpt")
        torch.save({
            "iter": 0,
            "model_coarse_state_dict": seeded_model(SEED, opacify=True).state_dict(),
            "model_fine_state_dict": seeded_model(SEED + 1, opacify=True).state_dict(),
        }, ckpt)

        fused_mlp_t.launches = 0
        main_run = render_trajectory(cfg, ckpt, os.path.join(tmp, "kernel"),
                                     num_poses=NUM_POSES, precision="float32",
                                     renderer="kernel", device=DEVICE)
        launches = fused_mlp_t.launches
        print(f"[main] {NUM_POSES} frames {main_run.height}x{main_run.width} through "
              f"the kernel: {launches} launches (expected {expected})")
        check(launches == expected, f"kernel launches {launches} != {expected}")
        check(all(main_run.finite), f"non-finite maps: {main_run.finite}")
        pngs = sorted(os.listdir(os.path.join(tmp, "kernel")))
        check(len(pngs) == NUM_POSES, f"PNGs written: {pngs}")
        maps = main_run.first_maps
        check(tuple(maps["rgb_fine"].shape) == (main_run.height, main_run.width, 3),
              f"rgb_fine shape {tuple(maps['rgb_fine'].shape)}")
        print(f"[main] frame 0: acc mean {float(maps['acc_fine'].mean()):.4f}, "
              f"rgb mean {float(maps['rgb_fine'].mean()):.4f}, "
              f"rgb std {float(maps['rgb_fine'].std()):.4f}")

        plain_run = render_trajectory(cfg, ckpt, os.path.join(tmp, "plain"), num_poses=1,
                                      precision="float32", renderer="plain", device=DEVICE)
        ref = plain_run.first_maps
        err = float((maps["rgb_coarse"] - ref["rgb_coarse"]).abs().max())
        print(f"[main] frame 0 rgb_coarse: max |kernel path - plain path| = {err:.3e} "
              f"(tol {RENDER_RGB_TOL:g})")
        check(err <= RENDER_RGB_TOL, f"rgb_coarse kernel vs plain: {err}")
        fine_err = (maps["rgb_fine"] - ref["rgb_fine"]).abs().amax(dim=-1).reshape(-1)
        outliers = torch.nonzero(fine_err > RENDER_RGB_TOL).flatten()
        print(f"[main] frame 0 rgb_fine: max |kernel path - plain path| = "
              f"{float(fine_err.max()):.3e}; {len(outliers)} of {fine_err.numel()} pixels "
              f"over {RENDER_RGB_TOL:g} (at most {MAX_RESAMPLE_PIXELS}, each a moved resample)")
        check(len(outliers) <= MAX_RESAMPLE_PIXELS, f"{len(outliers)} rgb_fine outliers")
        if len(outliers):
            check_resample_outliers(cfg, outliers, (main_run.height, main_run.width,
                                                    main_run.focal))
        for name in ("acc_fine", "depth_fine", "disp_fine"):
            print(f"[main] frame 0 {name}: max |kernel path - plain path| = "
                  f"{float((maps[name] - ref[name]).abs().max()):.3e}")

        bf16_run = render_trajectory(cfg, ckpt, os.path.join(tmp, "bf16"), num_poses=1,
                                     precision="bfloat16", renderer="kernel", device=DEVICE)
        db = psnr(bf16_run.first_maps["rgb_fine"], ref["rgb_fine"])
        print(f"[main] frame 0 bf16 kernel path vs f32 plain path: PSNR {db:.2f} dB "
              f"(floor {PSNR_FLOOR_DB})")
        check(db >= PSNR_FLOOR_DB, f"bf16 PSNR {db} < {PSNR_FLOOR_DB}")

    # Phase 5: times on this card. Plain and kernel alternate in turns.
    times = {}
    with torch.inference_mode():
        n, s = KERNEL_CHUNK
        pts, vd = orbit_points(n, s, dev, seed=1)
        for dtype in ("float32", "bfloat16"):
            p1 = cuda_ms(lambda: mlp_t_plain(model, pts, vd, dtype), 2)
            k1 = cuda_ms(lambda: fused_mlp_t(model, pts, vd, dtype), 3)
            k2 = cuda_ms(lambda: fused_mlp_t(model, pts, vd, dtype), 3)
            p2 = cuda_ms(lambda: mlp_t_plain(model, pts, vd, dtype), 2)
            times[dtype] = ((k1 + k2) / 2, (p1 + p2) / 2)
            gflop = 2 * n * s * MACS_PER_POINT / 1e9
            print(f"[time] fused_mlp_t ({n}, {s}) {dtype}: kernel {k1:.2f} / {k2:.2f} ms "
                  f"({gflop / times[dtype][0]:.1f} TFLOP/s), plain {p1:.2f} / {p2:.2f} ms "
                  f"{on}")
        del pts, vd

        mc = seeded_model(SEED, opacify=True).to(dev)
        mf = seeded_model(SEED + 1, opacify=True).to(dev)
        poses, h, w, focal = resolve_render_poses(cfg)
        pose = torch.as_tensor(poses[1], device=dev)
        base = render_settings_from_config(cfg, "validation", hwf=(h, w, focal))
        renders = {}
        for label, use_kernel, dtype in (("plain f32", False, "float32"),
                                         ("kernel f32", True, "float32"),
                                         ("kernel bf16", True, "bfloat16")):
            settings = dataclasses.replace(base, use_pallas=use_kernel, compute_dtype=dtype)
            renders[label] = make_pose_render_fn(mc, mf, settings, h, w, focal)
            renders[label](pose)   # warm-up
        torch.cuda.reset_peak_memory_stats()
        order = ("plain f32", "kernel f32", "kernel bf16", "kernel bf16", "kernel f32",
                 "plain f32")
        frame = {label: [] for label in renders}
        for label in order:
            frame[label].append(frame_seconds(renders[label], pose))
        for label, secs in frame.items():
            mean = sum(secs) / len(secs)
            print(f"[time] {h}x{w} frame, {base.num_coarse}+{base.num_fine} samples, {label}: "
                  f"{' / '.join(f'{x:.4f}' for x in secs)} s/frame, "
                  f"{h * w / mean:,.0f} rays/s {on}")
        print(f"[time] peak device memory over those frames: "
              f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB {on}")

    # Phase 6: the training kernels vs plain, at the training path's shapes.
    with torch.no_grad():
        train_worst = check_training_kernels(model, dev)

    # Phase 7: the training main path, through the train entry point.
    cfg_train = synthetic_train_config(TRAIN_STEPS)
    with tempfile.TemporaryDirectory() as tmp:
        trained = train_main_path(cfg_train, tmp, dev)

    # Phase 8: times of the training kernels and of a training step.
    train_times = time_training(cfg_train, dev, on)

    k_ms, p_ms = times["float32"]
    entries = [{
        "name": "fused_mlp_t",
        "route": "cuda",
        "source": "nerf_tpu_torch/csrc/mlp_t.cu",
        "replaces": "nerf_tpu/ops/pallas/mlp_t.py:164",
        "launches": launches,
        "max_abs_err": worst["float32"],
        "max_abs_err_bf16": worst["bfloat16"],
        "ms": k_ms,
        "plain_ms": p_ms,
        "ms_bf16": times["bfloat16"][0],
        "plain_ms_bf16": times["bfloat16"][1],
    }]
    for which, line in (("fwd", 197), ("bwd", 241)):
        entries.append({
            "name": f"fused_flex_mlp_train_{which}",
            "route": "cuda",
            "source": "nerf_tpu_torch/csrc/flex_train.cu",
            "replaces": f"nerf_tpu/ops/pallas/train_vjp.py:{line}",
            "launches": trained["launches"][which],
            "max_abs_err": train_worst[which, "float32"],
            "max_abs_err_bf16": train_worst[which, "bfloat16"],
            "ms": train_times[which, "float32"][0],
            "plain_ms": train_times[which, "float32"][1],
            "ms_bf16": train_times[which, "bfloat16"][0],
            "plain_ms_bf16": train_times[which, "bfloat16"][1],
            "shape": list(TRAIN_SHAPE),
        })
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
