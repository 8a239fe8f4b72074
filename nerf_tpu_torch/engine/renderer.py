"""Hierarchical coarse->fine NeRF rendering (port of
``nerf_tpu/engine/renderer.py``).

PyTorch runs eagerly, so the JAX package's compiled ``lax.map`` over ray
megabatches becomes a Python loop over ``chunksize``-ray chunks under
``torch.inference_mode()``. Models are ``nn.Module``s that hold their
weights, so the functions here take modules where the JAX ones take
(model, params) pairs. Random numbers come from one ``torch.Generator``
where the JAX package splits a key.

The radiance field of the 4x128 10/4 FlexibleNeRF and of the 8x256
PaperNeRF goes through hand-written training kernels (``kernels/flex_train.py``,
``kernels/paper_train.py``: forward and backward) when
``RenderSettings.use_pallas_train`` is on, else through a forward-only kernel
(``kernels/mlp_t.py``, ``kernels/paper_t.py``) when ``use_pallas`` is on;
otherwise, and for every other model shape, through positional encoding +
the module. The hash-grid field (``models/hashgrid.py``) takes the points as
they are, its encoding on the hash-encoding kernel pair
(``kernels/hashgrid.py``) under either flag. Compositing and resampling are
plain PyTorch, as they are plain XLA on the JAX package's kernel path.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.utils.checkpoint

from ..kernels.flex_train import fused_flex_mlp_train
from ..kernels.hashgrid import fused_hash_encode
from ..kernels.mlp_t import fused_mlp_t, supports_fused
from ..kernels.paper_t import fused_paper_mlp_t, supports_fused_paper
from ..kernels.paper_train import fused_paper_mlp_train
from ..models.hashgrid import HashGridNeRFModel
from ..ops.encoding import coarse_to_fine_window, positional_encoding
from ..ops.rays import ndc_rays, pixel_rays, ray_aabb_interval
from ..ops.sampling import coarse_z_values, perturb_z_values, sample_pdf
from ..ops.volume import RenderOutputs, volume_render_radiance_field
from ..utils.profiling import RENDER_FIELD, RENDER_IMAGE, annotate


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Per-mode render configuration (the config's ``nerf.{train,validation}``
    section plus the dataset and encoding fields the render path needs)."""

    num_coarse: int = 64
    num_fine: int = 64
    chunksize: int = 16384
    perturb: bool = True
    radiance_field_noise_std: float = 0.0
    white_background: bool = False
    lindisp: bool = False
    near: float = 2.0
    far: float = 6.0
    use_viewdirs: bool = True
    use_ndc: bool = False
    # NDC needs the camera intrinsics.
    height: int = 0
    width: int = 0
    focal_length: float = 0.0
    num_encoding_fn_xyz: int = 6
    num_encoding_fn_dir: int = 4
    include_input_xyz: bool = True
    include_input_dir: bool = True
    log_sampling_xyz: bool = True
    log_sampling_dir: bool = True
    # Coarse-to-fine encoding window (BARF); negative = off. Plain path only.
    pe_alpha_xyz: float = -1.0
    # (xmin, ymin, zmin, xmax, ymax, zmax): tighten every ray's sample
    # interval to its crossing of this box; misses keep [near, far].
    aabb: Optional[Tuple[float, float, float, float, float, float]] = None
    # Fused encode+MLP kernel for radiance-field evaluation (forward only).
    use_pallas: bool = False
    # Fused training kernels (forward + backward); pts and viewdirs get no
    # gradient through them, so never for pose optimization.
    use_pallas_train: bool = False
    # Recompute the plain evaluation's activations in the backward.
    remat: bool = False
    # MLP matmul input dtype: "float32" or "bfloat16" (f32 sums either way).
    compute_dtype: str = "float32"

    def eval_variant(self) -> "RenderSettings":
        """Deterministic copy for validation/eval rendering."""
        return dataclasses.replace(self, perturb=False, radiance_field_noise_std=0.0)


class RayRenderResult(NamedTuple):
    """Coarse + (optional) fine composited maps for a ray batch."""

    coarse: RenderOutputs
    fine: Optional[RenderOutputs]

    @property
    def rgb(self) -> torch.Tensor:
        """The displayable map: fine if present, else coarse."""
        return self.fine.rgb if self.fine is not None else self.coarse.rgb


def render_maps_dict(out: RayRenderResult) -> Dict[str, torch.Tensor]:
    """rgb/disp/acc/depth for coarse (and fine when present); the per-sample
    weights are left out (S times larger than every other map)."""
    res = {
        "rgb_coarse": out.coarse.rgb,
        "disp_coarse": out.coarse.disp,
        "acc_coarse": out.coarse.acc,
        "depth_coarse": out.coarse.depth,
    }
    if out.fine is not None:
        res.update(
            rgb_fine=out.fine.rgb,
            disp_fine=out.fine.disp,
            acc_fine=out.fine.acc,
            depth_fine=out.fine.depth,
        )
    return res


def encode_points(pts: torch.Tensor, viewdirs: Optional[torch.Tensor],
                  s: RenderSettings) -> torch.Tensor:
    """Positional-encode (..., S, 3) sample points and append the encoded
    (..., 3) viewdirs broadcast over the samples: (..., S, D)."""
    enc = positional_encoding(pts, s.num_encoding_fn_xyz, s.include_input_xyz, s.log_sampling_xyz)
    if s.pe_alpha_xyz >= 0.0 and s.num_encoding_fn_xyz > 0:
        w = coarse_to_fine_window(s.num_encoding_fn_xyz, s.pe_alpha_xyz, enc.dtype, enc.device)
        c = pts.shape[-1]
        mask = torch.cat([
            torch.ones(c if s.include_input_xyz else 0, dtype=enc.dtype, device=enc.device),
            torch.repeat_interleave(w, 2 * c),  # per-freq [sin(C), cos(C)] blocks
        ])
        enc = enc * mask
    if viewdirs is not None:
        enc_dir = positional_encoding(
            viewdirs, s.num_encoding_fn_dir, s.include_input_dir, s.log_sampling_dir
        )
        enc_dir = enc_dir[..., None, :].expand(*pts.shape[:-1], enc_dir.shape[-1])
        enc = torch.cat([enc, enc_dir], dim=-1)
    return enc


def _eval_radiance_field(model, pts: torch.Tensor, viewdirs: Optional[torch.Tensor],
                         s: RenderSettings) -> torch.Tensor:
    """Radiance field at sample points: a fused kernel when enabled and the
    model's shape is one it takes, else positional encoding + the module.
    The JAX package's order: the training kernels first (FlexibleNeRF, then
    PaperNeRF), then the forward-only ones (the same order). The hash-grid
    field encodes its points itself, through the kernel pair when either
    flag is on (which raises for a grid the kernels do not take)."""
    with annotate(RENDER_FIELD):
        if isinstance(model, HashGridNeRFModel):
            kernel = s.use_pallas_train or s.use_pallas
            return model(pts, viewdirs, s.compute_dtype,
                         encode=fused_hash_encode if kernel else None)
        fusable = (viewdirs is not None and s.log_sampling_xyz and s.log_sampling_dir
                   and s.pe_alpha_xyz < 0.0 and pts.ndim == 3)
        if s.use_pallas_train and fusable:
            if supports_fused(model):
                return fused_flex_mlp_train(model, pts, viewdirs, compute_dtype=s.compute_dtype)
            if supports_fused_paper(model):
                return fused_paper_mlp_train(model, pts, viewdirs, compute_dtype=s.compute_dtype)
        if s.use_pallas and fusable:
            if supports_fused(model):
                return fused_mlp_t(model, pts, viewdirs, compute_dtype=s.compute_dtype)
            if supports_fused_paper(model):
                return fused_paper_mlp_t(model, pts, viewdirs, compute_dtype=s.compute_dtype)

        def eval_fn(pts_, viewdirs_):
            enc = encode_points(pts_, viewdirs_, s)
            if s.compute_dtype != "float32":
                # The encoding stays f32 (high-frequency phases); only the MLP's
                # matmuls drop to the compute dtype.
                enc = enc.to(getattr(torch, s.compute_dtype))
            return model(enc).float()

        if s.remat:
            return torch.utils.checkpoint.checkpoint(eval_fn, pts, viewdirs, use_reentrant=False)
        return eval_fn(pts, viewdirs)


class RenderDraws(NamedTuple):
    """The random numbers one ``render_rays`` call uses, drawn before it:
    None where the settings draw nothing."""

    t_rand: Optional[torch.Tensor]        # (N, num_coarse) stratified jitter
    noise_coarse: Optional[torch.Tensor]  # (N, num_coarse) sigma noise
    u_fine: Optional[torch.Tensor]        # (N, num_fine) resample uniforms
    noise_fine: Optional[torch.Tensor]    # (N, num_coarse + num_fine) sigma noise


def draw_render_randoms(generator: Optional[torch.Generator], num_rays: int,
                        settings: RenderSettings, device=None,
                        dtype: torch.dtype = torch.float32) -> RenderDraws:
    """What ``render_rays(..., generator)`` would draw from ``generator`` for
    ``num_rays`` rays, drawn now in its order, so ``render_rays(...,
    draws=...)`` renders the same batch."""
    s = settings
    noisy = s.radiance_field_noise_std > 0.0

    def rand(n):
        return torch.rand((num_rays, n), generator=generator, dtype=dtype, device=device)

    def randn(n):
        return torch.randn((num_rays, n), generator=generator, dtype=dtype, device=device)

    t_rand = rand(s.num_coarse) if s.perturb else None
    noise_coarse = randn(s.num_coarse) if noisy else None
    u_fine = noise_fine = None
    if s.num_fine > 0:
        u_fine = rand(s.num_fine) if s.perturb else None
        noise_fine = randn(s.num_coarse + s.num_fine) if noisy else None
    return RenderDraws(t_rand, noise_coarse, u_fine, noise_fine)


def _composite(rf, z_vals, rd, s: RenderSettings, generator, final_dists=None,
               noise=None) -> RenderOutputs:
    return volume_render_radiance_field(
        rf, z_vals, rd,
        radiance_field_noise_std=s.radiance_field_noise_std,
        white_background=s.white_background,
        generator=generator,
        final_dists=final_dists,
        noise=noise,
    )


def render_rays(
    model_coarse,
    model_fine,
    ray_origins: torch.Tensor,
    ray_directions: torch.Tensor,
    settings: RenderSettings,
    generator: Optional[torch.Generator] = None,
    draws: Optional[RenderDraws] = None,
) -> RayRenderResult:
    """Render a flat (N, 3) batch of rays through the coarse->fine hierarchy.

    ``model_fine`` None reuses the coarse model for the fine pass. The
    random numbers come from ``generator``, or from ``draws``
    (``draw_render_randoms``) when given: then nothing is drawn here, so the
    call works under ``torch.func.vmap``.
    """
    s = settings
    if draws is None:
        draws = RenderDraws(None, None, None, None)
    viewdirs = None
    if s.use_viewdirs:
        viewdirs = ray_directions / torch.linalg.norm(ray_directions, dim=-1, keepdim=True)

    if s.use_ndc:
        ro, rd = ndc_rays(s.height, s.width, s.focal_length, 1.0, ray_origins, ray_directions)
    else:
        ro, rd = ray_origins, ray_directions

    tightened = None
    if s.aabb is not None and not s.use_ndc:
        if s.num_coarse < 2:
            raise ValueError(f"RenderSettings.aabb needs num_coarse >= 2 (got {s.num_coarse})")
        near, far = ray_aabb_interval(ro, rd, s.aabb[:3], s.aabb[3:], s.near, s.far)
        # Only rays that end before the far plane know the space past their
        # last sample is empty; the others keep the 1e10 sentinel.
        tightened = far < s.far
    else:
        near = torch.full(ro.shape[:1], s.near, dtype=ro.dtype, device=ro.device)
        far = torch.full(ro.shape[:1], s.far, dtype=ro.dtype, device=ro.device)

    def last_bin_or_sentinel(z):
        if tightened is None:
            return None
        return torch.where(tightened, z[..., -1] - z[..., -2], torch.full_like(z[..., -1], 1e10))

    z_vals = coarse_z_values(near, far, s.num_coarse, s.lindisp, dtype=ro.dtype)
    if s.perturb:
        z_vals = perturb_z_values(z_vals, generator, t_rand=draws.t_rand)

    pts = ro[..., None, :] + rd[..., None, :] * z_vals[..., :, None]
    rf = _eval_radiance_field(model_coarse, pts, viewdirs, s)
    coarse = _composite(rf, z_vals, rd, s, generator, last_bin_or_sentinel(z_vals),
                        draws.noise_coarse)

    fine = None
    if s.num_fine > 0:
        z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        z_samples = sample_pdf(
            z_mid, coarse.weights[..., 1:-1], s.num_fine,
            det=not s.perturb, generator=generator, u=draws.u_fine,
        ).detach()
        z_all, _ = torch.sort(torch.cat([z_vals, z_samples], dim=-1), dim=-1)
        pts = ro[..., None, :] + rd[..., None, :] * z_all[..., :, None]
        fine_model = model_fine if model_fine is not None else model_coarse
        rf = _eval_radiance_field(fine_model, pts, viewdirs, s)
        fine = _composite(rf, z_all, rd, s, generator, last_bin_or_sentinel(z_all),
                          draws.noise_fine)
    return RayRenderResult(coarse, fine)


def make_render_fn(model_coarse, model_fine, settings: RenderSettings
                   ) -> Callable[..., RayRenderResult]:
    """``render(ray_origins, ray_directions, generator=None) -> RayRenderResult``."""

    def render(ray_origins, ray_directions, generator=None):
        return render_rays(model_coarse, model_fine, ray_origins, ray_directions,
                           settings, generator)

    return render


def render_chunks(model_coarse, model_fine, ray_origins, ray_directions,
                  settings: RenderSettings, generator=None) -> Dict[str, torch.Tensor]:
    """Flat (N, 3) rays rendered ``chunksize`` at a time (the last chunk holds
    the remainder), without autograd: the flat maps of ``render_maps_dict``."""
    chunks = []
    with torch.inference_mode():
        for start in range(0, ray_origins.shape[0], settings.chunksize):
            out = render_rays(
                model_coarse, model_fine,
                ray_origins[start:start + settings.chunksize],
                ray_directions[start:start + settings.chunksize],
                settings, generator,
            )
            chunks.append(render_maps_dict(out))
        return {name: torch.cat([c[name] for c in chunks]) for name in chunks[0]}


def rank_rows(mesh, n: int, device) -> torch.Tensor:
    """Row indices of this rank's contiguous range of ``n`` rows split over
    a ``mesh`` (``parallel.mesh.Mesh``; None = all rows): ``ceil(n / W)``
    a rank, the padded tail clamped to row ``n - 1`` (JAX ``dp.py:312-326``)."""
    if mesh is None or mesh.world_size == 1:
        return torch.arange(n, device=device)
    shard = -(-n // mesh.world_size)
    return torch.clamp(torch.arange(mesh.rank * shard, (mesh.rank + 1) * shard, device=device),
                       max=n - 1)


def gather_maps(mesh, maps: Dict[str, torch.Tensor], n: int
                ) -> Optional[Dict[str, torch.Tensor]]:
    """Every rank's flat maps (one dtype) of its :func:`rank_rows`, as the
    first ``n`` rows on rank 0, in one gather (the maps side by side as
    columns); None on the other ranks. Without a mesh (or on one rank), the
    maps."""
    if mesh is None or mesh.world_size == 1:
        return maps
    names = list(maps)
    widths = [1 if maps[k].ndim == 1 else maps[k].shape[1] for k in names]
    cols = mesh.gather_rows(torch.cat([maps[k].reshape(maps[k].shape[0], w)
                                       for k, w in zip(names, widths)], 1))
    if cols is None:
        return None
    out, c = {}, 0
    for k, w in zip(names, widths):
        out[k] = cols[:n, c] if maps[k].ndim == 1 else cols[:n, c:c + w]
        c += w
    return out


def make_image_render_fn(model_coarse, model_fine, settings: RenderSettings, mesh=None
                         ) -> Callable[..., Optional[Dict[str, torch.Tensor]]]:
    """Full-image renderer: ``render_image(ray_origins, ray_directions,
    generator=None) -> dict`` of (H, W[, 3]) maps, rendering ``chunksize``
    rays at a time (the last chunk holds the remainder).

    ``mesh`` (``parallel.mesh.Mesh``): each rank renders its contiguous range
    of the H*W rays (:func:`rank_rows`) and rank 0 assembles the image; the
    other ranks get None.
    """

    def render_image(ray_origins, ray_directions, generator=None):
        h, w = ray_origins.shape[0], ray_origins.shape[1]
        ro = ray_origins.reshape(-1, 3)
        rd = ray_directions.reshape(-1, 3)
        if mesh is not None and mesh.world_size > 1:
            rows = rank_rows(mesh, h * w, ro.device)
            ro, rd = ro[rows], rd[rows]
        maps = gather_maps(mesh, render_chunks(model_coarse, model_fine, ro, rd, settings,
                                               generator), h * w)
        if maps is None:
            return None
        return {name: v.reshape((h, w) + v.shape[1:]) for name, v in maps.items()}

    return render_image


def make_pose_render_fn(model_coarse, model_fine, settings: RenderSettings,
                        height: int, width: int, focal: float,
                        output: str = "maps", mesh=None) -> Callable[..., Any]:
    """``render(pose34) -> out``: rays for a (3, 4) camera-to-world pose are
    made on the pose's device, then rendered as one image.

    ``output``: "maps" = all (H, W[, 3]) maps plus ``rgb_u8``; "u8" = the
    uint8 displayed image; "f32" = the [0, 1]-clipped float image.

    ``mesh`` (``parallel.mesh.Mesh``): only the pose reaches a rank, which
    makes and renders the rays of its own pixel range (:func:`rank_rows`)
    and sends its slice to rank 0 ("u8" sends uint8); the other ranks get
    None. This is ``serve_nerf``'s multi-device path.
    """
    if output not in ("maps", "u8", "f32"):
        raise ValueError(f"unknown output mode {output!r}")
    n = height * width

    def render(pose34, generator=None):
        with annotate(RENDER_IMAGE):
            ro, rd = pixel_rays(height, width, focal, pose34, rank_rows(mesh, n, pose34.device))
            maps = render_chunks(model_coarse, model_fine, ro, rd, settings, generator)
            if output != "maps":
                rgb = torch.clamp(maps.get("rgb_fine", maps["rgb_coarse"]), 0.0, 1.0)
                maps = {output: rgb if output == "f32" else (rgb * 255.0).to(torch.uint8)}
            maps = gather_maps(mesh, maps, n)
            if maps is None:
                return None
            maps = {name: v.reshape((height, width) + v.shape[1:]) for name, v in maps.items()}
            if output != "maps":
                return maps[output]
            rgb = maps.get("rgb_fine", maps["rgb_coarse"])
            maps["rgb_u8"] = (torch.clamp(rgb, 0.0, 1.0) * 255.0).to(torch.uint8)
            return maps

    return render
