"""Model registry: model classes looked up by the reference's class name."""

from __future__ import annotations

from typing import Any, Dict, Type

from .hashgrid import HashGridNeRFModel
from .mlp import (
    FlexibleNeRFModel,
    MultiHeadNeRFModel,
    PaperNeRFModel,
    ReplicateNeRFModel,
    VeryTinyNeRFModel,
)

MODEL_REGISTRY: Dict[str, Type[Any]] = {
    "VeryTinyNeRFModel": VeryTinyNeRFModel,
    "MultiHeadNeRFModel": MultiHeadNeRFModel,
    "ReplicateNeRFModel": ReplicateNeRFModel,
    "PaperNeRFModel": PaperNeRFModel,
    "FlexibleNeRFModel": FlexibleNeRFModel,
    "HashGridNeRFModel": HashGridNeRFModel,
}


def get_model(name: str, **kwargs):
    """Instantiate a model family by its reference class name."""
    try:
        cls = MODEL_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"Unknown model type {name!r}; available: {sorted(MODEL_REGISTRY)}"
        ) from None
    return cls(**kwargs)


__all__ = [
    "MODEL_REGISTRY",
    "get_model",
    "FlexibleNeRFModel",
    "HashGridNeRFModel",
    "MultiHeadNeRFModel",
    "PaperNeRFModel",
    "ReplicateNeRFModel",
    "VeryTinyNeRFModel",
]
