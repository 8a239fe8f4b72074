"""Camera poses, the procedural synthetic scene and flat ray stores."""

from .eval_poses import resolve_render_poses
from .poses import pose_spherical, spherical_render_poses
from .rays_store import (
    build_ray_store,
    is_reference_cache_dir,
    load_ray_cache,
    load_reference_cache_dir,
    save_ray_cache,
    shuffle_ray_store,
)
from .synthetic import (
    SyntheticDataset,
    analytic_radiance_field,
    flatten_rays,
    make_synthetic_dataset,
    render_analytic_image,
)

__all__ = [
    "resolve_render_poses",
    "pose_spherical",
    "spherical_render_poses",
    "build_ray_store",
    "is_reference_cache_dir",
    "load_ray_cache",
    "load_reference_cache_dir",
    "save_ray_cache",
    "shuffle_ray_store",
    "SyntheticDataset",
    "analytic_radiance_field",
    "flatten_rays",
    "make_synthetic_dataset",
    "render_analytic_image",
]
