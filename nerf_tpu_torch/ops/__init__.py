"""Core NeRF ops on tensors: encoding, rays, sampling, compositing."""

from .encoding import coarse_to_fine_window, encoding_dim, frequency_bands, positional_encoding
from .math import cumprod_exclusive, img2mse, mse2psnr
from .rays import get_ray_bundle, meshgrid_xy, ndc_rays, ray_aabb_interval
from .sampling import coarse_z_values, perturb_z_values, sample_pdf
from .volume import RenderOutputs, volume_render_radiance_field

__all__ = [
    "coarse_to_fine_window",
    "encoding_dim",
    "frequency_bands",
    "positional_encoding",
    "cumprod_exclusive",
    "img2mse",
    "mse2psnr",
    "get_ray_bundle",
    "meshgrid_xy",
    "ndc_rays",
    "ray_aabb_interval",
    "coarse_z_values",
    "perturb_z_values",
    "sample_pdf",
    "RenderOutputs",
    "volume_render_radiance_field",
]
