"""Model registry: model classes looked up by the reference's class name."""

from __future__ import annotations

from typing import Any, Dict, Type

from .mlp import FlexibleNeRFModel, PaperNeRFModel

MODEL_REGISTRY: Dict[str, Type[Any]] = {
    "FlexibleNeRFModel": FlexibleNeRFModel,
    "PaperNeRFModel": PaperNeRFModel,
}

# Families the JAX package has and this package does not yet.
_NOT_PORTED = ("VeryTinyNeRFModel", "MultiHeadNeRFModel", "ReplicateNeRFModel")


def get_model(name: str, **kwargs):
    """Instantiate a model family by its reference class name."""
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"{name} is not ported to nerf_tpu_torch yet "
            "(ROADMAP.md, open items §1 item 3)"
        )
    try:
        cls = MODEL_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"Unknown model type {name!r}; available: {sorted(MODEL_REGISTRY)}"
        ) from None
    return cls(**kwargs)


__all__ = ["MODEL_REGISTRY", "get_model", "FlexibleNeRFModel", "PaperNeRFModel"]
