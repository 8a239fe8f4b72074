"""Train a NeRF (port of ``train_nerf.py``).

Same config schema, metric tags and checkpoint cadence as the JAX CLI: the
training rays live on the device as one flat store; each loop call takes
``steps_per_call`` steps (ray batch drawn on the device, coarse + fine
render, MSE(coarse) + MSE(fine), backward, update, LR decay) and fetches
their metrics once; validation renders ``val_poses[0]`` at
``validate_every``; at ``save_every`` and at the end it writes
``checkpointNNNNN.ckpt`` (reference format, with the optimizer's state) and
``checkpointNNNNN.ntc`` (the JAX trainer's, with the optax state), and it
resumes from either.

Datasets: blender and LLFF scenes on disk (``data/blender.py``,
``data/llff.py``; RGBA composited onto white at load when
``nerf.train.white_background``; LLFF's ``llffhold`` split), the procedural
synthetic scene, and ray caches (``.npz``, the native ``.nrc``, a reference
cache directory). A scene's training views become one flat ray store
(``build_ray_store``: the C++ builder when it builds).
With ``nerf.train.use_pallas_train`` the radiance field and its gradient go
through the hand-written training kernels of the model's family: the 4x128
10/4 FlexibleNeRF's (``kernels/flex_train.py``) or the 8x256 PaperNeRF's
(``kernels/paper_train.py``, ``configs/lego_paper.yml``).

Usage:
  python -m nerf_tpu_torch.train_nerf --config cfg.yml [--load-checkpoint ckpt] \\
      [--overrides key value ...] [--device cuda]

``--tighten-aabb TAU`` continues a trained run on tightened samples: the
restored coarse field's density is swept once on a 64^3 grid
(``engine/geometry.density_aabb``), and every ray's sample interval, in
training and validation, is cut to its crossing of the box around sigma >
TAU.

``--num-devices N`` trains data-parallel over N ranks of a
``torch.distributed`` group, one a device (``engine.train.make_train_loop``
with a ``parallel.mesh.Mesh``): under ``torchrun`` in its group (N must
equal ``WORLD_SIZE``), else on N ranks it spawns, whose collectives keep
torch's timeout unless ``--dist-timeout`` sets one. The batch is padded to a multiple of N, the store with its own
first rows and then sliced per rank; each step all-reduces the gradients
and losses once. Rank 0 alone writes the config, metrics, validation
images and checkpoints (a barrier follows each save) and renders the
validation frame; on resume every rank loads the same checkpoint. NCCL
needs a card a rank; ranks that share a card (or the CPU) take
``--dist-backend gloo``.

``main(argv)`` parses the flags; ``train(cfg, ...)`` does the work and takes a
``CfgNode``, so a caller can drive it without a YAML file.
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

from . import native
from .config import (
    load_config,
    model_from_config,
    optimizer_from_config,
    render_settings_from_config,
)
from .data import (
    build_ray_store,
    composite_white_background,
    flatten_rays,
    is_reference_cache_dir,
    llff_holdout_split,
    load_blender_data,
    load_llff_data,
    load_ray_cache,
    load_reference_cache_dir,
    make_synthetic_dataset,
    ray_store_builder,
    shuffle_ray_store,
)
from .engine.checkpoint import (
    export_reference_checkpoint,
    latest_checkpoint,
    load_train_checkpoint,
    ntc_train_state,
    save_checkpoint,
)
from .engine.geometry import tighten_to_density_aabb
from .engine.renderer import make_image_render_fn
from .engine.train import create_train_state, make_train_loop, steps_per_call
from .ops import get_ray_bundle, img2mse, mse2psnr
from .parallel.distributed import add_mesh_args, run_ranks, spawn_or_join
from .parallel.mesh import make_mesh, pad_to_devices, replicate_params, shard_rows
from .utils import MetricWriter, RateMeter


def _cached(rays, meta: dict, ds, extras: dict, builder: str) -> dict:
    return {"rays": rays, "hwf": (meta["height"], meta["width"], meta["focal"]),
            "near": meta.get("near", ds.near), "far": meta.get("far", ds.far),
            "val_images": extras.get("val_images"), "val_poses": extras.get("val_poses"),
            "store_builder": builder, "load_seconds": 0.0, "store_seconds": 0.0}


def load_dataset(cfg, device="cpu") -> dict:
    """The training rays and the validation views of ``cfg.dataset``: a dict
    of host arrays (``rays`` = (origins, directions, targets), ``hwf``,
    ``near``, ``far``, ``val_images``, ``val_poses``), which builder made the
    store (``store_builder``: ``native``, ``torch`` or ``cache``), and the
    seconds spent reading the images (``load_seconds``, decode and resize)
    and building the store (``store_seconds``)."""
    ds = cfg.dataset
    if getattr(ds, "cachedir", None):
        path = ds.cachedir
        if os.path.isdir(path):
            if is_reference_cache_dir(path):
                ro, rd, targets, meta, _ = load_reference_cache_dir(path)
                return _cached((ro, rd, targets), meta, ds, {}, "cache")
            for name in ("rays.npz", "rays.nrc"):
                if os.path.exists(os.path.join(path, name)):
                    path = os.path.join(path, name)
                    break
        if path.endswith(".nrc"):
            ro, rd, targets, meta = native.load_ray_cache_native(path)
            extras = {}
        else:
            ro, rd, targets, meta, extras = load_ray_cache(path)
        return _cached((ro, rd, targets), meta, ds, extras, "cache")
    if ds.type == "synthetic":
        dataset = make_synthetic_dataset(num_views=int(getattr(ds, "num_views", 20)),
                                         height=int(getattr(ds, "image_size", 64)),
                                         width=int(getattr(ds, "image_size", 64)), device=device)
        return {"rays": flatten_rays(dataset, device), "hwf": dataset.hwf,
                "near": dataset.near, "far": dataset.far,
                "val_images": dataset.images[:2], "val_poses": dataset.poses[:2],
                "store_builder": ray_store_builder(), "load_seconds": 0.0,
                "store_seconds": 0.0}
    t0 = time.perf_counter()
    if ds.type == "blender":
        images, poses, _, hwf, (i_train, i_val, _) = load_blender_data(
            ds.basedir, half_res=ds.half_res, testskip=ds.testskip)
        images = (composite_white_background(images) if cfg.nerf.train.white_background
                  else images[..., :3])
    elif ds.type == "llff":
        images, poses, _, _, i_holdout = load_llff_data(
            ds.basedir, factor=getattr(ds, "downsample_factor", 8),
            spherify=bool(getattr(ds, "spherify", False)),
            path_zflat=bool(getattr(ds, "path_zflat", False)))
        hwf = poses[0, :3, -1]
        i_train, i_val = llff_holdout_split(images.shape[0], int(getattr(ds, "llffhold", 8)),
                                            i_holdout)
    else:
        raise ValueError(f"Unknown dataset type {ds.type!r}")
    poses = poses[:, :3, :4]
    h, w, focal = int(hwf[0]), int(hwf[1]), float(hwf[2])
    t1 = time.perf_counter()
    rays = build_ray_store(images[i_train], poses[i_train], h, w, focal, device=device)
    return {"rays": rays, "hwf": (h, w, focal), "near": ds.near, "far": ds.far,
            "val_images": images[i_val[:1]], "val_poses": poses[i_val[:1]],
            "store_builder": ray_store_builder(), "load_seconds": t1 - t0,
            "store_seconds": time.perf_counter() - t1}


@dataclasses.dataclass
class TrainResult:
    """What a training run did. Every per-step value was fetched from the
    device once per loop call."""

    logdir: str
    start_step: int
    losses: List[float] = dataclasses.field(default_factory=list)   # every step's loss
    psnrs: List[float] = dataclasses.field(default_factory=list)    # every step's PSNR
    call_losses: List[float] = dataclasses.field(default_factory=list)  # last of each call
    call_psnrs: List[float] = dataclasses.field(default_factory=list)
    val_psnrs: List[float] = dataclasses.field(default_factory=list)
    seconds: float = 0.0        # host seconds in loop calls, each ending in its fetch
    rays_per_sec: float = 0.0   # rays trained / seconds
    checkpoint: Optional[str] = None        # the last .ckpt written (a .ntc beside it)
    store_rays: int = 0                     # rays in the training store
    store_builder: str = ""                 # native, torch or cache
    load_seconds: float = 0.0               # reading the dataset's images
    store_seconds: float = 0.0              # building the store from them
    aabb: Optional[tuple] = None            # the --tighten-aabb box, when swept
    aabb_seconds: float = 0.0               # the sweep's host seconds
    world_size: int = 1                     # data-parallel ranks
    allreduce_ms: float = 0.0               # host ms a step in the gradient all-reduce
    bucket_bytes: int = 0                   # the all-reduce's flat bucket


_NO_FIELD_TO_BOUND = ("--tighten-aabb needs a trained field to bound: resume from a checkpoint "
                      "(train a warmup phase first, or pass --load-checkpoint)")


def train(cfg, logdir: Optional[str] = None, device="cuda", load_checkpoint: str = "",
          num_devices: int = 1, tighten_aabb: Optional[float] = None,
          aabb_sweep_bounds: Optional[List[float]] = None,
          dist_backend: Optional[str] = None, dist_timeout: Optional[float] = None
          ) -> TrainResult:
    """Train the configured models on ``device``; returns a :class:`TrainResult`
    (rank 0's, when it spawned ``num_devices`` ranks).

    ``tighten_aabb``: the density threshold of ``--tighten-aabb``; it needs a
    checkpoint to resume from and a scene without NDC, as in the JAX CLI.
    ``num_devices`` > 1: data-parallel over that many ranks, in the live
    process group or on ranks spawned here with ``dist_backend`` and
    ``dist_timeout`` (seconds; None: torch's default).
    """
    if spawn_or_join(num_devices, dist_backend, device, dist_timeout):
        return run_ranks(train, num_devices, cfg, logdir, device, load_checkpoint, num_devices,
                         tighten_aabb, aabb_sweep_bounds, dist_backend, dist_timeout,
                         backend=dist_backend, device=device, timeout_s=dist_timeout)[0]
    mesh = make_mesh(num_devices, device, dist_backend)
    device = mesh.device
    primary = mesh.is_primary
    log = print if primary else (lambda *a, **k: None)
    if load_checkpoint and not os.path.exists(load_checkpoint):
        raise SystemExit(f"--load-checkpoint {load_checkpoint!r} does not exist")
    cfg = cfg.clone()
    if cfg.is_frozen():
        cfg.defrost()
    logdir = logdir or os.path.join(cfg.experiment.logdir, cfg.experiment.id)
    ckpt_path = load_checkpoint or latest_checkpoint(logdir)
    if tighten_aabb is not None:
        # The JAX CLI's refusals, made before the dataset loads.
        if not cfg.dataset.no_ndc:
            raise SystemExit("--tighten-aabb is incompatible with NDC (LLFF) scenes")
        if not ckpt_path:
            raise SystemExit(_NO_FIELD_TO_BOUND)
    seed = int(cfg.experiment.randomseed)
    data = load_dataset(cfg, device)
    h, w, focal = data["hwf"]
    if cfg.dataset.no_ndc:
        cfg.dataset.near = float(data["near"])
        cfg.dataset.far = float(data["far"])
    ro_store, rd_store, tgt_store = data["rays"]
    sampling = str(getattr(cfg.nerf.train, "ray_sampling", "gather"))
    if sampling == "sliced":
        ro_store, rd_store, tgt_store = shuffle_ray_store(ro_store, rd_store, tgt_store, seed=seed)
    ro_store, rd_store, tgt_store = (torch.as_tensor(np.ascontiguousarray(a), device=device)
                                     for a in (ro_store, rd_store, tgt_store))
    store_rays = ro_store.shape[0]
    log(f"ray store: {store_rays:,} rays on {device} ({sampling} sampling, "
        f"{data['store_builder']} builder)", flush=True)
    # The JAX CLI's layout: the batch padded to the mesh, the store with its
    # own first rows, then each rank keeps its contiguous slice.
    batch = pad_to_devices(int(cfg.nerf.train.num_random_rays), mesh.world_size)
    pad = pad_to_devices(store_rays, mesh.world_size) - store_rays
    if pad:
        ro_store, rd_store, tgt_store = (torch.cat([a, a[:pad]])
                                         for a in (ro_store, rd_store, tgt_store))
    ro_store, rd_store, tgt_store = (x.contiguous() for x in
                                     shard_rows(mesh, ro_store, rd_store, tgt_store))
    if mesh.world_size > 1:
        log(f"data-parallel over {mesh.world_size} devices, batch {batch}", flush=True)

    settings = render_settings_from_config(cfg, "train", hwf=(h, w, focal))
    val_settings = render_settings_from_config(cfg, "validation", hwf=(h, w, focal))
    # Reference checkpoints hold default-shaped models whatever the config says.
    reference_resume = load_checkpoint.endswith(".ckpt")
    model_coarse = model_from_config(cfg.models.coarse, reference_compat_shapes=reference_resume)
    model_fine = (model_from_config(cfg.models.fine, reference_compat_shapes=reference_resume)
                  if "fine" in cfg.models else None)
    for i, model in enumerate((model_coarse, model_fine)):
        if model is not None:
            model.reset_parameters(torch.Generator().manual_seed(seed + i))
            model.to(device)
    spec = optimizer_from_config(cfg)
    state = create_train_state(model_coarse, model_fine, spec)

    if primary:
        os.makedirs(logdir, exist_ok=True)
        with open(os.path.join(logdir, "config.json"), "w") as f:
            json.dump(cfg.to_dict(), f, indent=2, sort_keys=True)
    if ckpt_path:
        info = load_train_checkpoint(ckpt_path, model_coarse, model_fine, state.optimizer, spec)
        state.step = info["step"]
        state.scheduler = spec.make_scheduler(state.optimizer, info["count"])
        log(f"resumed from {ckpt_path} at step {state.step} "
            f"({'with' if info['moments'] else 'without'} optimizer moments)", flush=True)

    replicate_params(mesh, model_coarse, model_fine)
    result = TrainResult(logdir=logdir, start_step=state.step, store_rays=store_rays,
                         world_size=mesh.world_size, store_builder=data["store_builder"],
                         load_seconds=data["load_seconds"], store_seconds=data["store_seconds"])
    if tighten_aabb is not None:
        if state.step == 0:
            raise SystemExit(_NO_FIELD_TO_BOUND)
        result.aabb, result.aabb_seconds = tighten_to_density_aabb(
            model_coarse, val_settings, tighten_aabb, aabb_sweep_bounds)
        settings = dataclasses.replace(settings, aabb=result.aabb)
        val_settings = dataclasses.replace(val_settings, aabb=result.aabb)
    writer = MetricWriter(logdir) if primary else None
    rate = RateMeter()
    train_iters = int(cfg.experiment.train_iters)
    every = {k: int(getattr(cfg.experiment, k)) for k in
             ("print_every", "validate_every", "save_every")}
    k_call = steps_per_call(*every.values(), train_iters - state.step)
    nan_guard = bool(getattr(cfg.experiment, "nan_guard", False))
    loops = {}
    render_image = make_image_render_fn(model_coarse, model_fine, val_settings)
    trained = 0

    while state.step < train_iters:
        k_steps = min(k_call, train_iters - state.step)
        if k_steps not in loops:
            loops[k_steps] = make_train_loop(model_coarse, model_fine, settings, batch, k_steps,
                                             nan_guard=nan_guard, sample_mode=sampling,
                                             mesh=mesh)
        prev_done = state.step
        t0 = time.perf_counter()
        state, metrics = loops[k_steps](state, ro_store, rd_store, tgt_store, seed)
        metrics = type(metrics)(*(x.cpu() for x in metrics))   # the call's one fetch
        result.seconds += time.perf_counter() - t0
        trained += batch * k_steps
        rate.update(batch * k_steps)
        result.losses += metrics.loss.tolist()
        result.psnrs += metrics.psnr.tolist()
        loss, psnr = float(metrics.loss[-1]), float(metrics.psnr[-1])
        result.call_losses.append(loss)
        result.call_psnrs.append(psnr)
        done = state.step
        i_end = done - 1

        def crossed(period: int) -> bool:
            return done // period > prev_done // period

        log(f"[TRAIN] iter {i_end} loss {loss:.6f} psnr {psnr:.3f} "
            f"rays/s {rate.rate():,.0f}", flush=True)
        if not primary:
            if crossed(every["save_every"]) or done >= train_iters:
                mesh.barrier()   # rank 0's checkpoint is whole past here
            continue
        writer.scalars({
            "train/loss": loss,
            "train/coarse_loss": float(metrics.coarse_loss[-1]),
            "train/fine_loss": float(metrics.fine_loss[-1]),
            "train/psnr": psnr,
            "train/rays_per_sec": rate.rate(),
        }, i_end)

        if data["val_images"] is not None and (crossed(every["validate_every"])
                                               or done >= train_iters):
            t_val = time.perf_counter()
            pose = torch.as_tensor(np.asarray(data["val_poses"][0])[:3, :4],
                                   dtype=torch.float32, device=device)
            maps = render_image(*get_ray_bundle(h, w, focal, pose))
            target = torch.as_tensor(np.asarray(data["val_images"][0])[..., :3], device=device)
            coarse_loss = img2mse(maps["rgb_coarse"], target)
            fine_loss = img2mse(maps["rgb_fine"], target) if "rgb_fine" in maps else 0.0
            val_loss = float(coarse_loss + fine_loss)
            val_psnr = float(mse2psnr(torch.tensor(val_loss)))
            result.val_psnrs.append(val_psnr)
            writer.scalars({"validation/loss": val_loss,
                            "validation/coarse_loss": float(coarse_loss),
                            "validation/fine_loss": float(fine_loss),
                            "validation/psnr": val_psnr}, i_end)
            name = "rgb_fine" if "rgb_fine" in maps else "rgb_coarse"
            writer.image(f"validation/{name}", maps[name].cpu().numpy(), i_end)
            print(f"[VAL] iter {i_end} loss {val_loss:.6f} psnr {val_psnr:.3f} "
                  f"({time.perf_counter() - t_val:.2f}s)", flush=True)

        if crossed(every["save_every"]) or done >= train_iters:
            result.checkpoint = os.path.join(logdir, f"checkpoint{done:05d}.ckpt")
            export_reference_checkpoint(result.checkpoint, done, model_coarse, model_fine,
                                        loss, psnr, state.optimizer, hwf=(h, w, focal))
            save_checkpoint(os.path.join(logdir, f"checkpoint{done:05d}.ntc"),
                            ntc_train_state(done, model_coarse, model_fine, state.optimizer,
                                            spec, state.scheduler.last_epoch, loss, psnr))
            mesh.barrier()
        writer.flush()

    if writer is not None:
        writer.close()
    result.rays_per_sec = trained / result.seconds if result.seconds > 0 else 0.0
    if mesh.allreduce_calls:
        result.allreduce_ms = 1e3 * mesh.allreduce_seconds / mesh.allreduce_calls
        result.bucket_bytes = mesh.bucket_bytes
    log(f"done: {state.step - result.start_step} iters in {result.seconds:.1f}s of training "
        f"({result.rays_per_sec:,.0f} rays/s)", flush=True)
    return result


def main(argv: Optional[List[str]] = None) -> TrainResult:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", type=str, required=True, help="YAML or .py config.")
    parser.add_argument("--load-checkpoint", type=str, default="",
                        help="Checkpoint to resume from: a reference .ckpt or a native .ntc.")
    parser.add_argument("--overrides", type=str, nargs="*", default=None,
                        help="Dotted-key value pairs, e.g. optimizer.lr 1e-3")
    parser.add_argument("--device", type=str, default="cuda")
    add_mesh_args(parser, "Data-parallel ranks.")
    parser.add_argument("--tighten-aabb", type=float, default=None, metavar="TAU",
                        help="For CONTINUED training (needs a checkpoint to resume from): "
                             "sweep the restored density field once, bound the sigma > TAU "
                             "region, and tighten every ray's sample interval to its "
                             "crossing of that box (train and validation). Blender scenes "
                             "only (NDC is incompatible).")
    parser.add_argument("--aabb-sweep-bounds", type=float, nargs=6, default=None,
                        metavar=("X0", "Y0", "Z0", "X1", "Y1", "Z1"),
                        help="Density-sweep cube for --tighten-aabb (default (-1.5, 1.5)^3, "
                             "which covers the blender scenes). The sweep warns if the "
                             "occupied region touches these bounds (clipped geometry).")
    args = parser.parse_args(argv)
    cfg = load_config(args.config, args.overrides)
    return train(cfg, device=args.device, load_checkpoint=args.load_checkpoint,
                 num_devices=args.num_devices, tighten_aabb=args.tighten_aabb,
                 aabb_sweep_bounds=args.aabb_sweep_bounds, dist_backend=args.dist_backend,
                 dist_timeout=args.dist_timeout)


if __name__ == "__main__":
    main()
