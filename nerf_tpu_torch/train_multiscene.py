"""Train S NeRF scenes at once (port of ``train_multiscene.py``).

The scene axis is a batch axis over parameters, optimizer state and ray
batches (``parallel/multiscene.py``): one step trains every scene of a
group. Blender (or synthetic) scenes form one group and LLFF scenes
(``--llff-dirs``, the NDC protocol) a second one, each with its own
settings and model; the groups train interleaved, ``--print-every`` steps
at a time, and each call prints every scene's PSNR and the aggregate rays/s.
``--save-dir`` exports one ``.ntc`` a scene (``<save-dir>/<scene>/
checkpointNNNNN.ntc``: the scene's parameters without the scene axis,
``step``, ``loss`` and ``psnr``, and no optimizer state, as the JAX CLI
writes), which ``eval_nerf`` and ``eval_multiscene`` load.

Scenes default to ``--num-scenes`` distinct procedural synthetic scenes;
``--blender-dirs`` and ``--llff-dirs`` take datasets on disk.

Usage:
  python -m nerf_tpu_torch.train_multiscene --num-scenes 6 --iters 2000 [--size 48]
  python -m nerf_tpu_torch.train_multiscene --blender-dirs d1 d2 --llff-dirs fern \\
      --no-half-res --num-coarse 64 --num-fine 64 --n-xyz 10 --save-dir ckpts

Each group's base seed is fixed (the JAX CLI splits a new key per call and
folds the step in); scene ``s`` of a group draws from
``fold_seed(fold_seed(base, s), step)``, so a run is the same whatever the
steps per call.

``--num-devices N`` shards each scene's ray batch over N ranks, one a
device (the data-parallel multi-scene step of ``parallel/multiscene.py``;
under ``torchrun`` its group, else N spawned ranks): every rank holds every
scene's slice of the ray axis, the stacked state is replicated, and one
all-reduce of the (S,)-stacked gradients runs a step. ``--batch`` must
divide by N; rank 0 alone prints and writes.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .data import (
    build_ray_store,
    composite_white_background,
    llff_holdout_split,
    load_blender_data,
    load_llff_data,
    make_synthetic_dataset,
)
from .engine.checkpoint import convert_torch_state_dict, save_checkpoint
from .engine.renderer import RenderSettings
from .engine.train import fold_seed, make_optimizer
from .models import FlexibleNeRFModel
from .parallel.distributed import add_mesh_args, run_cli
from .parallel.mesh import Mesh, make_mesh
from .parallel.multiscene import (
    create_multiscene_state,
    make_multiscene_train_loop,
    shard_multiscene_stores,
)

# The seed the JAX CLI draws its per-call keys from (PRNGKey(1)).
_LOOP_SEED = 1


class SceneGroup:
    """Scenes that share a protocol (settings and model shape) and step as
    one batch; blender and LLFF/NDC scenes form separate groups."""

    def __init__(self, tag: str, names: List[str], stores, settings: RenderSettings,
                 model: FlexibleNeRFModel, spec, batch: int, seed: int, loop_seed: int,
                 mesh: Mesh):
        self.tag = tag
        self.names = names
        self.settings = settings
        self.model = model
        self.batch = batch
        self.loop_seed = loop_seed
        self.mesh = mesh
        self.loops: Dict[int, object] = {}
        n_min = min(st[0].shape[0] for st in stores)
        # The ray axis shards over the mesh: each scene keeps a multiple of it.
        n_min -= n_min % mesh.world_size
        stacked = shard_multiscene_stores(
            mesh, *(np.stack([st[i][:n_min] for st in stores]) for i in range(3)))
        self.ro, self.rd, self.tgt = (torch.from_numpy(np.ascontiguousarray(a)).to(mesh.device)
                                      for a in stacked)
        self.state = create_multiscene_state(model, model, spec, seed, len(names), mesh.device)
        self.metrics = None
        if mesh.is_primary:
            print(f"[{tag}] {len(names)} scenes x {n_min:,} rays ({', '.join(names)})",
                  flush=True)

    def step(self, k_steps: int) -> None:
        if k_steps not in self.loops:
            self.loops[k_steps] = make_multiscene_train_loop(
                self.model, self.model, self.settings, self.batch, k_steps, mesh=self.mesh)
        self.state, metrics = self.loops[k_steps](self.state, self.ro, self.rd, self.tgt,
                                                  self.loop_seed)
        self.metrics = type(metrics)(*(x.cpu() for x in metrics))   # the call's one fetch

    def export_checkpoints(self, save_dir: str, step: int) -> List[str]:
        """One ``eval_nerf``-loadable ``.ntc`` a scene: the scene's slice of
        every parameter, the last step's loss and PSNR."""
        losses, psnrs = self.metrics.loss[-1], self.metrics.psnr[-1]
        paths = []
        for s, name in enumerate(self.names):
            outdir = os.path.join(save_dir, name)
            os.makedirs(outdir, exist_ok=True)
            path = os.path.join(outdir, f"checkpoint{step:05d}.ntc")
            # Scalars as 0-d arrays, as the JAX CLI's save_checkpoint writes them.
            save_checkpoint(path, {
                "step": np.asarray(step),
                "params_coarse": convert_torch_state_dict(self.state.scene_params(s, "coarse")),
                "params_fine": convert_torch_state_dict(self.state.scene_params(s, "fine")),
                "loss": np.asarray(float(losses[s])),
                "psnr": np.asarray(float(psnrs[s])),
            })
            paths.append(path)
        print(f"[{self.tag}] saved {len(self.names)} checkpoints at iter {step} under "
              f"{save_dir}", flush=True)
        return paths


@dataclasses.dataclass
class MultiSceneResult:
    """What a run did: per group, the names and each call's (K, S) losses;
    each call's steps and host seconds (every group stepped, the metrics
    fetched)."""

    groups: Dict[str, List[str]]
    losses: Dict[str, List[np.ndarray]]
    psnrs: Dict[str, List[np.ndarray]]
    seconds: float
    rays_per_sec: float
    checkpoints: List[str]
    call_steps: List[int] = dataclasses.field(default_factory=list)
    call_seconds: List[float] = dataclasses.field(default_factory=list)


def _blender_group(args, device):
    stores, names = [], []
    if args.blender_dirs:
        for d in args.blender_dirs:
            images, poses, _, hwf, i_split = load_blender_data(d, half_res=args.half_res)
            images = composite_white_background(images)
            tr = i_split[0]
            stores.append(build_ray_store(images[tr], poses[tr, :3, :4], int(hwf[0]),
                                          int(hwf[1]), float(hwf[2])))
        names = [os.path.basename(os.path.normpath(d)) for d in args.blender_dirs]
    elif not args.llff_dirs:
        print(f"building {args.num_scenes} synthetic scenes ({args.views} views @ "
              f"{args.size}px)...", flush=True)
        for s in range(args.num_scenes):
            ds = make_synthetic_dataset(num_views=args.views, height=args.size, width=args.size,
                                        phase=0.9 * s, sphere_radius=0.6 + 0.05 * s,
                                        seed=100 + s, device=device)
            h, w, focal = ds.hwf
            stores.append(build_ray_store(ds.images, ds.poses, h, w, focal))
        names = [f"scene{s}" for s in range(args.num_scenes)]
    if not stores:
        return None
    settings = RenderSettings(
        num_coarse=args.num_coarse, num_fine=args.num_fine, perturb=True,
        radiance_field_noise_std=args.noise_std, white_background=True, near=2.0, far=6.0,
        num_encoding_fn_xyz=args.n_xyz, num_encoding_fn_dir=args.n_dir,
        compute_dtype=args.compute_dtype)
    model = FlexibleNeRFModel(num_encoding_fn_xyz=args.n_xyz,
                              num_encoding_fn_dir=args.n_dir).to(device)
    return names, stores, settings, model


def _llff_group(args, device):
    stores, names, hwf0 = [], [], None
    for d in args.llff_dirs:
        images, poses, _bds, _rp, _ = load_llff_data(d, factor=args.llff_factor)
        hwf = poses[0, :3, -1]
        poses = poses[:, :3, :4]
        i_train, _ = llff_holdout_split(images.shape[0])
        h, w, focal = int(hwf[0]), int(hwf[1]), float(hwf[2])
        if hwf0 is None:
            hwf0 = (h, w, focal)
        elif hwf0 != (h, w, focal):
            raise SystemExit(
                f"--llff-dirs intrinsics differ: {hwf0} vs {(h, w, focal)} ({d}) — the NDC "
                "settings are one group's; run mismatched scenes separately")
        stores.append(build_ray_store(images[i_train, ..., :3], poses[i_train], h, w, focal))
        names.append(os.path.basename(os.path.normpath(d)))
    h, w, focal = hwf0
    settings = RenderSettings(
        num_coarse=args.num_coarse, num_fine=args.num_fine, perturb=True,
        radiance_field_noise_std=args.llff_noise_std, white_background=False, near=0.0,
        far=1.0, use_ndc=True, height=h, width=w, focal_length=focal,
        num_encoding_fn_xyz=args.llff_n_xyz, num_encoding_fn_dir=args.n_dir,
        compute_dtype=args.compute_dtype)
    model = FlexibleNeRFModel(num_encoding_fn_xyz=args.llff_n_xyz,
                              num_encoding_fn_dir=args.n_dir).to(device)
    return names, stores, settings, model


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--num-scenes", type=int, default=7)
    parser.add_argument("--iters", type=int, default=2000)
    parser.add_argument("--size", type=int, default=48)
    parser.add_argument("--views", type=int, default=8)
    parser.add_argument("--batch", type=int, default=1024, help="rays per scene per step")
    parser.add_argument("--print-every", type=int, default=200)
    parser.add_argument("--blender-dirs", nargs="*", default=None,
                        help="Optional blender scene dirs (one per scene) instead of synthetic.")
    parser.add_argument("--llff-dirs", nargs="*", default=None,
                        help="Optional LLFF scene dirs (NDC protocol: near/far 0/1, no white "
                             "background, --llff-n-xyz encodings), trained as a second group "
                             "interleaved with the blender/synthetic one.")
    parser.add_argument("--half-res", action=argparse.BooleanOptionalAction, default=True,
                        help="Half-resolution blender loading (--no-half-res for datasets "
                             "already at the target resolution, e.g. distilled sets).")
    # The quick synthetic demo by default; the lowres-blender protocol is
    # --num-coarse 64 --num-fine 64 --n-xyz 10.
    parser.add_argument("--num-coarse", type=int, default=32)
    parser.add_argument("--num-fine", type=int, default=32)
    parser.add_argument("--n-xyz", type=int, default=6)
    parser.add_argument("--n-dir", type=int, default=4)
    parser.add_argument("--noise-std", type=float, default=0.2)
    # The LLFF group's protocol (configs/fern_lowres.yml's; distilled sets at factor 1).
    parser.add_argument("--llff-factor", type=int, default=1)
    parser.add_argument("--llff-n-xyz", type=int, default=6)
    parser.add_argument("--llff-noise-std", type=float, default=1.0)
    parser.add_argument("--compute-dtype", choices=["float32", "bfloat16"], default="float32")
    parser.add_argument("--save-dir", default=None,
                        help="If set, export one native .ntc checkpoint per scene at the end "
                             "(eval_nerf-loadable; named after the scene dir, or scene{i} for "
                             "synthetic scenes).")
    parser.add_argument("--save-every", type=int, default=0,
                        help="Also export per-scene checkpoints every N iters; 0 = only at "
                             "the end.")
    parser.add_argument("--device", type=str, default="cuda")
    add_mesh_args(parser, "Ranks to shard each scene's ray batch over.")
    return parser.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> MultiSceneResult:
    args = parse_args(argv)
    if args.iters < 1:
        raise SystemExit("--iters must be >= 1")
    if args.num_devices > 1 and args.batch % args.num_devices:
        raise SystemExit(f"--batch {args.batch} must be divisible by the "
                         f"{args.num_devices}-device mesh")
    return run_cli(train_scenes, args)


def train_scenes(args: argparse.Namespace) -> MultiSceneResult:
    """One rank of ``train_multiscene`` (or the only process): every group
    trained ``args.iters`` steps; rank 0 prints and exports."""
    mesh = make_mesh(args.num_devices, args.device, args.dist_backend)
    device = mesh.device
    primary = mesh.is_primary
    log = print if primary else (lambda *a, **k: None)
    if mesh.world_size > 1:
        log(f"data-parallel over {mesh.world_size} devices, {args.batch} rays/scene/step",
            flush=True)

    spec = make_optimizer("adam", 5e-3, 250.0, 0.1)
    groups: List[SceneGroup] = []
    blender = _blender_group(args, device)
    if blender is not None:
        groups.append(SceneGroup("blender", *blender, spec, args.batch, seed=0,
                                 loop_seed=fold_seed(_LOOP_SEED, 0), mesh=mesh))
    if args.llff_dirs:
        groups.append(SceneGroup("llff", *_llff_group(args, device), spec, args.batch, seed=10,
                                 loop_seed=fold_seed(_LOOP_SEED, 1), mesh=mesh))
    if not groups:
        raise SystemExit("no scenes: pass --blender-dirs and/or --llff-dirs")
    all_names = [n for g in groups for n in g.names]
    if len(set(all_names)) != len(all_names):
        # a/lego and b/lego would overwrite each other's exports
        raise SystemExit(f"duplicate scene names across groups: {all_names}")
    s_total = len(all_names)
    log(f"{s_total} scenes in {len(groups)} group(s) on {device}", flush=True)

    result = MultiSceneResult({g.tag: g.names for g in groups}, {g.tag: [] for g in groups},
                              {g.tag: [] for g in groups}, 0.0, 0.0, [])
    steps_per_call = max(1, min(args.print_every, args.iters))
    t0 = time.perf_counter()
    t_chunk = t0
    i = 0
    while i < args.iters:
        k_steps = min(steps_per_call, args.iters - i)
        for g in groups:
            g.step(k_steps)
            result.losses[g.tag].append(g.metrics.loss.numpy())
            result.psnrs[g.tag].append(g.metrics.psnr.numpy())
        prev, i = i, i + k_steps
        parts = [f"{g.tag} [{' '.join(f'{p:.1f}' for p in g.metrics.psnr[-1].tolist())}]"
                 for g in groups]
        now = time.perf_counter()
        result.call_steps.append(k_steps)
        result.call_seconds.append(now - t_chunk)
        log(f"iter {i - 1:5d} psnr {' | '.join(parts)} "
            f"rays/s {s_total * args.batch * k_steps / (now - t_chunk):,.0f}"
            f" (cum {s_total * args.batch * i / (now - t0):,.0f})", flush=True)
        t_chunk = now
        if (primary and args.save_dir and args.save_every and i < args.iters
                and i // args.save_every > prev // args.save_every):
            for g in groups:
                result.checkpoints += g.export_checkpoints(args.save_dir, i)
    result.seconds = time.perf_counter() - t0
    result.rays_per_sec = s_total * args.batch * args.iters / result.seconds
    log(f"trained {s_total} scenes x {args.iters} iters in {result.seconds:.1f}s = "
        f"{result.rays_per_sec:,.0f} aggregate rays/s", flush=True)
    if primary and args.save_dir:
        for g in groups:
            result.checkpoints += g.export_checkpoints(args.save_dir, args.iters)
    return result


if __name__ == "__main__":
    main()
