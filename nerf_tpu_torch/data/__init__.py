"""Camera poses for rendering (host-side numpy)."""

from .eval_poses import resolve_render_poses
from .poses import pose_spherical, spherical_render_poses

__all__ = ["resolve_render_poses", "pose_spherical", "spherical_render_poses"]
