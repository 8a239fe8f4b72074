"""Camera poses, the dataset loaders, the procedural synthetic scene and flat
ray stores."""

from .blender import composite_white_background, load_blender_data
from .eval_poses import RenderSplit, load_render_split, resolve_render_poses
from .llff import ImageReaderMissing, llff_holdout_split, load_llff_data
from .poses import pose_spherical, spherical_render_poses
from .rays_store import (
    build_ray_store,
    is_reference_cache_dir,
    load_ray_cache,
    load_reference_cache_dir,
    ray_store_builder,
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
    "composite_white_background",
    "load_blender_data",
    "RenderSplit",
    "load_render_split",
    "resolve_render_poses",
    "ImageReaderMissing",
    "llff_holdout_split",
    "load_llff_data",
    "pose_spherical",
    "spherical_render_poses",
    "build_ray_store",
    "is_reference_cache_dir",
    "load_ray_cache",
    "load_reference_cache_dir",
    "ray_store_builder",
    "save_ray_cache",
    "shuffle_ray_store",
    "SyntheticDataset",
    "analytic_radiance_field",
    "flatten_rays",
    "make_synthetic_dataset",
    "render_analytic_image",
]
