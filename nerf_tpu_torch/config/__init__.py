"""Configuration system: YACS-style CfgNode + schema + engine builders."""

from .cfgnode import CfgNode, load_cfg
from .schema import (
    get_default_config,
    load_config,
    migrate_legacy_schema,
    model_from_config,
    optimizer_from_config,
    render_settings_from_config,
)

__all__ = [
    "CfgNode",
    "load_cfg",
    "get_default_config",
    "load_config",
    "migrate_legacy_schema",
    "model_from_config",
    "optimizer_from_config",
    "render_settings_from_config",
]
