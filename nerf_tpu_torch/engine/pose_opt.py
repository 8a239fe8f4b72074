"""Camera-pose refinement through the frozen differentiable renderer (port
of ``nerf_tpu/engine/pose_opt.py``).

Per-image se(3) twists are left-composed onto the initial camera-to-world
poses and optimized by Adam against the photometric loss with the NeRF
weights frozen, differentiating through ray synthesis, positional encoding,
both MLPs, hierarchical resampling and compositing (the BARF/iNeRF
registration setup); ``make_joint_train_loop`` trains the NeRF weights and
the cameras together.

Every render here takes the plain path: the pose gradient needs d/d(points)
and d/d(view directions), and the training kernels' backward gives the
parameter gradients only. PyTorch runs eagerly, so the JAX package's
``lax.scan`` over K steps is a Python loop whose losses stay on the device.
Random numbers come from ``torch.Generator``s seeded from integers derived
with ``engine.train.fold_seed`` where the JAX package folds indices into a
key; each image's pixel stream is keyed by its global index.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..lie import se3_exp, so3_exp, so3_log
from .renderer import RenderSettings, render_rays
from .train import OptimizerSpec, clip_by_global_norm, fold_seed, make_optimizer


@dataclasses.dataclass
class PoseOptState:
    """Refined camera parameters and their optimizer (the NeRF weights stay
    frozen). ``log_focal`` is a shared log-scale intrinsics correction
    (refined focal = focal * exp(log_focal)); it only moves when the loss was
    built with ``refine_focal=True``, otherwise its gradient is zero and Adam
    leaves it at exactly 0."""

    xi: torch.Tensor            # (N, 6) se(3) twists [v, omega], zeros = initial poses
    log_focal: torch.Tensor     # () shared focal correction, 0 = initial focal
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR

    @property
    def opt_params(self) -> Dict[str, torch.Tensor]:
        return {"xi": self.xi, "log_focal": self.log_focal}


def as_homogeneous(poses: torch.Tensor) -> torch.Tensor:
    """(N, 3, 4) or (N, 4, 4) camera-to-world -> (N, 4, 4)."""
    if poses.shape[-2] == 4:
        return poses
    bottom = torch.zeros_like(poses[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([poses, bottom], dim=-2)


def twists_to_poses(xi: torch.Tensor, base_poses: torch.Tensor) -> torch.Tensor:
    """``T_i = Exp(xi_i) @ base_i``: (N, 6) twists on (N, 3|4, 4) base poses
    -> (N, 3, 4). xi = 0 gives the base poses back."""
    return (se3_exp(xi) @ as_homogeneous(base_poses))[..., :3, :4]


def pose_errors(poses_a: torch.Tensor, poses_b: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-pose geodesic rotation error ``||Log(R_a^T R_b)||`` in degrees and
    translation error ``||t_a - t_b||``."""
    rel = poses_a[..., :3, :3].transpose(-1, -2) @ poses_b[..., :3, :3]
    rot_rad = torch.linalg.norm(so3_log(rel), dim=-1)
    trans = torch.linalg.norm(poses_a[..., :3, 3] - poses_b[..., :3, 3], dim=-1)
    return {"rot_deg": torch.rad2deg(rot_rad), "trans": trans}


def _sample_pixel_rays(poses34: torch.Tensor, images: torch.Tensor, seed: int, height: int,
                       width: int, focal_length, rays_per_image: int,
                       image_index_offset: int = 0,
                       pixel_indices: Optional[torch.Tensor] = None,
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``rays_per_image`` random pixels of EVERY image, their world-frame
    rays from the current (differentiable) poses, and their targets: flat
    (N*R, 3) origins, directions and colours.

    Rays follow ``get_ray_bundle``'s camera convention, built for the sampled
    pixels only. Image i draws its pixels from a generator seeded with
    ``fold_seed(seed, image_index_offset + i)``, its GLOBAL index, so a shard
    holding images [offset, offset + n) draws what the serial run draws for
    them. ``pixel_indices`` (N, R) replaces the draw (tests).
    """
    n = images.shape[0]
    device = poses34.device
    if pixel_indices is None:
        pixel_indices = torch.stack([
            torch.randint(height * width, (rays_per_image,), device=device,
                          generator=torch.Generator(device=device).manual_seed(
                              fold_seed(seed, image_index_offset + i)))
            for i in range(n)
        ])
    idx = pixel_indices.to(device)
    x = (idx % width).to(poses34.dtype)
    y = (idx // width).to(poses34.dtype)
    dirs = torch.stack([(x - width * 0.5) / focal_length, -(y - height * 0.5) / focal_length,
                        -torch.ones_like(x)], dim=-1)                      # (N, R, 3)
    rd = torch.sum(dirs[..., None, :] * poses34[:, None, :3, :3], dim=-1)
    ro = poses34[:, None, :3, -1].expand(rd.shape)
    tgt = images.reshape(n, -1, images.shape[-1])[torch.arange(n, device=device)[:, None], idx]
    return ro.reshape(-1, 3), rd.reshape(-1, 3), tgt.reshape(-1, 3)


def make_photometric_loss_fn(model_coarse, model_fine, settings: RenderSettings, height: int,
                             width: int, focal_length: float, rays_per_image: int,
                             refine_focal: bool = False):
    """Build ``loss(opt_params, base_poses, images, seed, image_index_offset=0,
    render_key_fold=None, pixel_indices=None) -> scalar tensor`` with
    ``opt_params = {"xi": (N, 6), "log_focal": ()}``.

    The training objective restricted to camera variables: coarse MSE + fine
    MSE over ``rays_per_image`` pixels sampled per image. With a fixed seed
    it doubles as a deterministic before/after metric. The render draws its
    sigma noise and z jitter (when ``settings`` has them) from a generator
    seeded with ``fold_seed(seed, 1)``, further folded with
    ``render_key_fold`` when given, so each data-parallel shard draws its
    own.

    ``refine_focal=True`` differentiates through a shared intrinsics
    correction too (rays built from ``focal * exp(log_focal)``). Refused for
    NDC scenes: the NDC projection inside ``render_rays`` uses the static
    ``settings.focal_length``.
    """
    if refine_focal and settings.use_ndc:
        raise ValueError(
            "refine_focal is not supported for NDC scenes: the NDC projection "
            "uses the static settings.focal_length. Refine poses only, or "
            "disable NDC."
        )
    settings = dataclasses.replace(settings, use_pallas=False, use_pallas_train=False)
    needs_rng = settings.perturb or settings.radiance_field_noise_std > 0.0

    def photometric_loss(opt_params, base_poses, images, seed: int, image_index_offset: int = 0,
                         render_key_fold: Optional[int] = None,
                         pixel_indices: Optional[torch.Tensor] = None) -> torch.Tensor:
        poses34 = twists_to_poses(opt_params["xi"], base_poses)
        focal = focal_length * torch.exp(opt_params["log_focal"]) if refine_focal else focal_length
        ro, rd, tgt = _sample_pixel_rays(poses34, images, fold_seed(seed, 0), height, width,
                                         focal, rays_per_image, image_index_offset,
                                         pixel_indices)
        generator = None
        if needs_rng:
            render_seed = fold_seed(seed, 1)
            if render_key_fold is not None:
                render_seed = fold_seed(render_seed, render_key_fold)
            generator = torch.Generator(device=ro.device).manual_seed(render_seed)
        out = render_rays(model_coarse, model_fine, ro, rd, settings, generator)
        loss = torch.mean((out.coarse.rgb - tgt) ** 2)
        if out.fine is not None:
            loss = loss + torch.mean((out.fine.rgb - tgt) ** 2)
        return loss

    return photometric_loss


def _step(optimizer, scheduler, params: List[torch.Tensor], grads) -> None:
    """One optimizer update of ``params`` with ``grads`` (None = zero)."""
    for p, g in zip(params, grads):
        p.grad = torch.zeros_like(p) if g is None else g
    optimizer.step()
    scheduler.step()


def _image_shard(mesh, local_n: int) -> Tuple[int, Optional[int]]:
    """This rank's first global image index and its render-number fold: (0,
    None) without a mesh or on one rank."""
    if mesh is None or mesh.world_size == 1:
        return 0, None
    return mesh.rank * local_n, mesh.rank


def _local_view(opt_params: Dict[str, torch.Tensor], offset: int, local_n: int
                ) -> Dict[str, torch.Tensor]:
    """The camera variables of a rank's images: its rows of the replicated
    twists (the gradient is zero outside them) and the shared focal."""
    return {"xi": opt_params["xi"][offset:offset + local_n],
            "log_focal": opt_params["log_focal"]}


def mesh_grad_reduce(mesh) -> Callable:
    """The data-parallel ``grad_reduce(grads, loss) -> (grads, loss)`` hook:
    one ``all_reduce_mean`` of the gradients (tensors, not None) and the
    loss over ``mesh``. Each twist row is non-zero on one rank only, so its
    mean is the serial gradient of a mean of W equal-size rank means; the
    focal correction genuinely averages."""

    def reduce(grads, loss):
        loss = loss.reshape(1)
        mesh.all_reduce_mean(list(grads) + [loss])
        return grads, loss[0]

    return reduce


def make_pose_opt_step(model_coarse, model_fine, settings: RenderSettings, height: int,
                       width: int, focal_length: float, rays_per_image: int,
                       refine_focal: bool = False, mesh=None):
    """Build one pose-refinement step: ``step(state, base_poses (N, 4, 4),
    images (N, H, W, 3), seed, pixel_indices=None) -> (state, loss)``. The
    NeRF weights get no gradient; the state's optimizer updates ``xi`` and
    ``log_focal``.

    Pass a deterministic ``settings`` (``settings.eval_variant()``):
    z-perturbation only adds sampling noise to the pose gradient.

    ``mesh`` (``parallel.mesh.Mesh``): data-parallel over images. The state
    (all N twists) is replicated and ``base_poses`` / ``images`` are this
    rank's contiguous n = N / W of them; its pixels are the serial run's for
    the same global images, its render numbers folded with the rank, and
    one all-reduce (:func:`mesh_grad_reduce`) precedes the update.
    """
    photometric_loss = make_photometric_loss_fn(
        model_coarse, model_fine, settings, height, width, focal_length, rays_per_image,
        refine_focal=refine_focal)
    reduce = None if mesh is None else mesh_grad_reduce(mesh)

    def step(state: PoseOptState, base_poses, images, seed: int,
             pixel_indices: Optional[torch.Tensor] = None):
        params = [state.xi, state.log_focal]
        local_n = images.shape[0]
        offset, fold = _image_shard(mesh, local_n)
        opt_params = (state.opt_params if fold is None
                      else _local_view(state.opt_params, offset, local_n))
        loss = photometric_loss(opt_params, base_poses, images, seed, image_index_offset=offset,
                                render_key_fold=fold, pixel_indices=pixel_indices)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        loss = loss.detach()
        if reduce is not None:
            # log_focal has no gradient without refine_focal: reduce a zero.
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
            grads, loss = reduce(grads, loss)
        _step(state.optimizer, state.scheduler, params, grads)
        return state, loss

    return step


def make_pose_opt_loop(model_coarse, model_fine, settings: RenderSettings, height: int,
                       width: int, focal_length: float, rays_per_image: int,
                       steps_per_loop: int, refine_focal: bool = False, mesh=None):
    """K refinement steps: ``loop(state, base_poses, images, base_seed,
    pixel_indices=None) -> (state, losses (K,))``, step i seeded with
    ``fold_seed(base_seed, i)``; the losses stay on the device.
    ``pixel_indices`` (K, n, R) replaces the pixel draws (tests); ``mesh``:
    ``make_pose_opt_step``'s, with this rank's images."""
    step = make_pose_opt_step(model_coarse, model_fine, settings, height, width, focal_length,
                              rays_per_image, refine_focal=refine_focal, mesh=mesh)

    def loop(state, base_poses, images, base_seed: int,
             pixel_indices: Optional[torch.Tensor] = None):
        losses = []
        for i in range(steps_per_loop):
            state, loss = step(state, base_poses, images, fold_seed(base_seed, i),
                               None if pixel_indices is None else pixel_indices[i])
            losses.append(loss)
        return state, torch.stack(losses)

    return loop


def pose_optimizer(lr: float, iters: int = 0, lr_final: float = 0.0) -> Callable:
    """The camera optimizer: ``optax.adam(lr)`` as the port's Adam
    (``engine.train.make_optimizer``), or with ``lr_final > 0``
    ``optax.adam(optax.exponential_decay(lr, iters, lr_final / lr))``, the
    decay a ``LambdaLR``. Returns ``init(params) -> (optimizer, scheduler)``."""
    spec = make_optimizer("adam", lr)
    if lr_final <= 0:
        return spec.init
    rate = float(lr_final) / float(lr)

    def init(params):
        opt, _ = spec.init(params)
        return opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda t: rate ** (t / iters))

    return init


def init_pose_opt_state(num_poses: int, optimizer_init: Callable, device="cpu") -> PoseOptState:
    """Zero twists + zero focal correction (= the initial cameras) and a
    fresh optimizer over both, from ``optimizer_init`` (``pose_optimizer``'s
    result)."""
    xi = torch.zeros((num_poses, 6), dtype=torch.float32, device=device, requires_grad=True)
    log_focal = torch.zeros((), dtype=torch.float32, device=device, requires_grad=True)
    opt, sched = optimizer_init([xi, log_focal])
    return PoseOptState(xi, log_focal, opt, sched)


def align_poses_umeyama(poses_a: torch.Tensor, poses_b: torch.Tensor,
                        with_scale: bool = True) -> torch.Tensor:
    """Gauge-align camera set ``a`` to ``b`` with one global Sim(3) (SE(3)
    when ``with_scale`` is off).

    Joint scene + camera optimization is free up to a rigid (plus scale)
    transform of every camera and the scene, so raw pose errors against
    ground truth mean nothing after joint training. This solves the Umeyama
    similarity ``min_{s,R,t} sum_i ||s R c_a_i + t - c_b_i||^2`` over the
    camera CENTERS in closed form (SVD) and applies it to ``a``'s poses (the
    one R also rotates the orientations). Takes (N, 3|4, 4) sets, N >= 3;
    returns the aligned copy of ``poses_a``, (N, 3, 4).
    """
    ca, cb = poses_a[..., :3, 3], poses_b[..., :3, 3]
    mu_a, mu_b = ca.mean(0), cb.mean(0)
    da, db = ca - mu_a, cb - mu_b
    cov = db.T @ da / ca.shape[0]
    u, s, vt = torch.linalg.svd(cov)
    d = torch.sign(torch.linalg.det(u @ vt))
    flip = torch.stack([torch.ones_like(d), torch.ones_like(d), d])
    R = (u * flip) @ vt
    if with_scale:
        scale = (s * flip).sum() / ((da ** 2).sum() / ca.shape[0])
    else:
        scale = torch.ones((), dtype=ca.dtype, device=ca.device)
    t = mu_b - scale * (R @ mu_a)
    new_R = R @ poses_a[..., :3, :3]
    new_c = scale * (ca @ R.T) + t
    return torch.cat([new_R, new_c[..., :, None]], dim=-1)


@dataclasses.dataclass
class JointTrainState:
    """NeRF weights (the modules) and camera params, each with its own
    optimizer; the NeRF optimizer clips by global norm when the config
    asks (``grad_clip_norm``)."""

    model_coarse: torch.nn.Module
    model_fine: Optional[torch.nn.Module]
    nerf_optimizer: torch.optim.Optimizer
    nerf_scheduler: torch.optim.lr_scheduler.LambdaLR
    pose: PoseOptState
    grad_clip_norm: Optional[float] = None

    @property
    def nerf_params(self) -> List[torch.nn.Parameter]:
        return self.nerf_optimizer.param_groups[0]["params"]


def joint_train_state(model_coarse, model_fine, num_poses: int, nerf_optimizer: OptimizerSpec,
                      pose_optimizer_init: Callable) -> JointTrainState:
    """A joint state over the modules' current weights (the coarse model's
    parameters, then the fine model's) and fresh camera parameters on the
    modules' device."""
    params = list(model_coarse.parameters())
    if model_fine is not None:
        params += list(model_fine.parameters())
    opt, sched = nerf_optimizer.init(params)
    return JointTrainState(model_coarse, model_fine, opt, sched,
                           init_pose_opt_state(num_poses, pose_optimizer_init,
                                               params[0].device),
                           nerf_optimizer.grad_clip_norm)


def init_joint_train_state(model_coarse, model_fine, seed: int, num_poses: int,
                           nerf_optimizer: OptimizerSpec,
                           pose_optimizer_init: Callable) -> JointTrainState:
    """Re-initialize the modules' weights from ``seed`` (the coarse model
    from ``fold_seed(seed, 0)``, the fine from ``fold_seed(seed, 1)``), then
    :func:`joint_train_state`."""
    for i, model in enumerate((model_coarse, model_fine)):
        if model is not None:
            model.reset_parameters(torch.Generator().manual_seed(fold_seed(seed, i)))
    return joint_train_state(model_coarse, model_fine, num_poses, nerf_optimizer,
                             pose_optimizer_init)


def joint_update(carry: JointTrainState, loss: Callable[[Dict[str, torch.Tensor]], torch.Tensor],
                 anchor_first: bool, grad_reduce: Optional[Callable] = None
                 ) -> Tuple[JointTrainState, torch.Tensor]:
    """One joint scene + camera update: ``loss(opt_params) -> scalar`` closes
    over this step's data and seed and renders through the state's modules;
    ``grad_reduce(grads, loss) -> (grads, loss)`` is the data-parallel hook
    (``parallel/pose_dp.py``: one all-reduce of the camera and NeRF
    gradients, camera first, and the loss), applied before the anchor;
    ``anchor_first`` zeroes camera 0's twist gradient."""
    pose_params = [carry.pose.xi, carry.pose.log_focal]
    nerf_params = carry.nerf_params
    loss_val = loss(carry.pose.opt_params)
    grads = torch.autograd.grad(loss_val, pose_params + nerf_params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(pose_params + nerf_params,
                                                                      grads)]
    loss_val = loss_val.detach()
    if grad_reduce is not None:
        grads, loss_val = grad_reduce(grads, loss_val)
    g_pose, g_nerf = grads[:2], grads[2:]
    if anchor_first:
        g_pose[0] = torch.cat([torch.zeros_like(g_pose[0][:1]), g_pose[0][1:]])
    if carry.grad_clip_norm:
        clip_by_global_norm(g_nerf, carry.grad_clip_norm)
    _step(carry.nerf_optimizer, carry.nerf_scheduler, nerf_params, g_nerf)
    _step(carry.pose.optimizer, carry.pose.scheduler, pose_params, g_pose)
    return carry, loss_val


def make_joint_train_loop(model_coarse, model_fine, settings: RenderSettings, height: int,
                          width: int, focal_length: float, rays_per_image: int,
                          steps_per_loop: int, refine_focal: bool = False,
                          anchor_first: bool = True, mesh=None):
    """Joint NeRF + camera training (the BARF/NeRF-- setting): the scene and
    the cameras that observed it are optimized together, so a NeRF can be
    trained from scratch with miscalibrated poses.

    One autograd pass differentiates the photometric loss with respect to
    both; the NeRF weights take the state's NeRF optimizer (the config's
    Adam, schedule and clipping), the cameras the pose optimizer.
    ``anchor_first`` pins camera 0 (its twist gradient is zeroed), removing
    most of the rigid gauge freedom; without it only gauge-aligned errors
    (``align_poses_umeyama``) mean anything.

    ``loop(state, base_poses (N, 4, 4), images, base_seed, pixel_indices=None)
    -> (state, losses (K,))``, step i seeded with ``fold_seed(base_seed, i)``.
    ``mesh``: data-parallel over images as ``make_pose_opt_step``, the NeRF
    weights, cameras and both optimizers replicated, one all-reduce of both
    gradients a step (``joint_update``'s ``grad_reduce``) before the anchor,
    the clipping and the two updates.
    """
    loss_fn = make_photometric_loss_fn(model_coarse, model_fine, settings, height, width,
                                       focal_length, rays_per_image, refine_focal=refine_focal)
    reduce = None if mesh is None else mesh_grad_reduce(mesh)

    def loop(state: JointTrainState, base_poses, images, base_seed: int,
             pixel_indices: Optional[torch.Tensor] = None):
        local_n = images.shape[0]
        offset, fold = _image_shard(mesh, local_n)
        losses = []
        for i in range(steps_per_loop):
            seed = fold_seed(base_seed, i)
            pixels = None if pixel_indices is None else pixel_indices[i]

            def loss(opt_params):
                if fold is not None:
                    opt_params = _local_view(opt_params, offset, local_n)
                return loss_fn(opt_params, base_poses, images, seed, image_index_offset=offset,
                               render_key_fold=fold, pixel_indices=pixels)

            state, l = joint_update(state, loss, anchor_first, grad_reduce=reduce)
            losses.append(l)
        return state, torch.stack(losses)

    return loop


def perturb_poses(poses: torch.Tensor, seed: int, rot_deg: float, trans: float,
                  axes: Optional[torch.Tensor] = None,
                  directions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A random rigid perturbation of KNOWN magnitude on every pose.

    Rotation: R is left-multiplied by Exp(axis * rot_rad) about a random
    unit axis (``pose_errors`` reads back exactly ``rot_deg``). Translation:
    a random unit direction scaled by ``trans`` is added (not folded into
    the twist, so the translation error is exactly ``trans``). The axes and
    directions are standard normal draws of a CPU generator seeded with
    ``seed``, normalized; ``axes`` / ``directions`` (N, 3) replace the draws
    (tests inject the JAX package's). Returns (N, 3, 4).
    """
    n = poses.shape[0]
    gen = torch.Generator().manual_seed(int(seed))
    if axes is None:
        axes = torch.randn((n, 3), generator=gen)
    if directions is None:
        directions = torch.randn((n, 3), generator=gen)
    axes = axes.to(poses)
    directions = directions.to(poses)
    axes = axes / torch.linalg.norm(axes, dim=-1, keepdim=True)
    directions = directions / torch.linalg.norm(directions, dim=-1, keepdim=True)
    R = so3_exp(axes * math.radians(rot_deg)) @ poses[..., :3, :3]
    t = poses[..., :3, 3] + directions * trans
    return torch.cat([R, t[..., :, None]], dim=-1)
