"""Default configuration schema and the config -> engine builders (port of
``nerf_tpu/config/schema.py``).

YAML keys are the JAX package's, key for key, so ``configs/*.yml`` load
unchanged. One naming difference: this package calls the radiance-field
kernel "fused" or "kernel" where the JAX package says "pallas". It still
reads the ``nerf.<mode>.use_pallas`` key, which turns on the hand-written
CUDA kernel (``RenderSettings.use_pallas``, ``kernels/mlp_t.py``), and
``nerf.train.use_pallas_train``, which turns on the training kernels
(``kernels/flex_train.py``).

Reference quirk: the reference never passes num_layers/hidden_size/
skip_connect_every to its model constructors, so all its checkpoints are
default-shaped (4x128). ``model_from_config`` passes sizes through;
``reference_compat_shapes=True`` reproduces the reference's construction
for loading its checkpoints.

``optimizer_from_config`` builds the ``torch.optim`` rule, its LR schedule
and its clipping from ``cfg.optimizer`` / ``cfg.scheduler``.
"""

from __future__ import annotations

import inspect
from typing import Optional, Tuple

from ..engine.renderer import RenderSettings
from ..engine.train import OptimizerSpec, make_optimizer
from ..models import MODEL_REGISTRY, get_model
from .cfgnode import CfgNode


def get_default_config() -> CfgNode:
    """The full default config tree (reference config/lego.yml schema)."""
    return CfgNode(
        {
            "experiment": {
                "id": "experiment",
                "logdir": "logs",
                "randomseed": 42,
                "train_iters": 200000,
                "validate_every": 100,
                "save_every": 5000,
                "print_every": 100,
                "nan_guard": False,
            },
            "dataset": {
                "type": "blender",
                "basedir": "",
                "cachedir": None,
                "half_res": True,
                "testskip": 1,
                "no_ndc": True,
                "near": 2.0,
                "far": 6.0,
                "downsample_factor": 1,
                "llffhold": 8,
                "spherify": False,
                "path_zflat": False,
            },
            "models": {
                "coarse": _default_model_cfg(),
                "fine": _default_model_cfg(),
            },
            "optimizer": {"type": "Adam", "lr": 5.0e-3, "grad_clip_norm": 0.0},
            "scheduler": {"lr_decay": 250, "lr_decay_factor": 0.1},
            "nerf": {
                "use_viewdirs": True,
                "encode_position_fn": "positional_encoding",
                "encode_direction_fn": "positional_encoding",
                "train": _default_mode_cfg(train=True),
                "validation": _default_mode_cfg(train=False),
            },
        }
    )


def _default_model_cfg() -> dict:
    return {
        "type": "FlexibleNeRFModel",
        "num_layers": 4,
        "hidden_size": 128,
        "skip_connect_every": 4,
        "num_encoding_fn_xyz": 10,
        "num_encoding_fn_dir": 4,
        "include_input_xyz": True,
        "include_input_dir": True,
        "log_sampling_xyz": True,
        "log_sampling_dir": True,
        "use_viewdirs": True,
    }


def _default_mode_cfg(train: bool) -> dict:
    cfg = {
        "chunksize": 131072,
        "perturb": train,
        "num_coarse": 64,
        "num_fine": 64,
        "white_background": False,
        "radiance_field_noise_std": 0.2 if train else 0.0,
        "lindisp": False,
        "use_pallas": False,   # the fused radiance-field kernel (eval only)
        "remat": False,
        "compute_dtype": "float32",
    }
    if train:
        cfg["num_random_rays"] = 1024
        cfg["use_pallas_train"] = False
        cfg["ray_sampling"] = "gather"
    return cfg


def load_config(path: str, overrides: Optional[list] = None) -> CfgNode:
    """Load a YAML (or Python-source) config merged over the defaults (new keys
    permitted); the reference's pre-rename schema is migrated at merge time.
    Legacy keys arriving through ``overrides`` raise with the new name."""
    cfg = get_default_config()
    cfg.set_new_allowed(True)
    cfg.register_renamed_key(
        "models.coarse.num_encoding_functions",
        "models.coarse.num_encoding_fn_xyz",
        "the encoding count is now split into xyz and dir variants",
    )
    cfg.register_renamed_key(
        "models.fine.num_encoding_functions", "models.fine.num_encoding_fn_xyz"
    )
    cfg.register_renamed_key("nerf.ndc", "dataset.no_ndc", "note the inverted sense")
    from .cfgnode import _load_cfg_py_source, load_cfg

    if path.endswith(".py"):
        loaded = _load_cfg_py_source(path)
    else:
        with open(path, "r") as f:
            loaded = load_cfg(f)
    migrations = migrate_legacy_schema(loaded)
    if migrations:
        import warnings

        warnings.warn(f"{path}: migrated pre-rename schema keys: " + "; ".join(migrations))
    cfg.merge_from_other_cfg(loaded)
    if overrides:
        cfg.merge_from_list(overrides)
    _validate_encoding_fns(cfg)
    return cfg


def migrate_legacy_schema(loaded: CfgNode) -> list:
    """Rewrite the reference's pre-rename schema keys in place, returning a
    description of each migration applied:
      - models.*.num_encoding_functions: N -> num_encoding_fn_xyz = _dir = N
      - nerf.ndc: B -> dataset.no_ndc = not B
      - nerf.near / nerf.far -> dataset.near / dataset.far
    An explicit current-schema key in the same file wins.
    """
    applied = []
    models = loaded.get("models")
    if isinstance(models, dict):
        for which in ("coarse", "fine"):
            m = models.get(which)
            if isinstance(m, dict) and "num_encoding_functions" in m:
                n = m.pop("num_encoding_functions")
                for new in ("num_encoding_fn_xyz", "num_encoding_fn_dir"):
                    if new not in m:
                        m[new] = n
                applied.append(
                    f"models.{which}.num_encoding_functions={n} -> "
                    "num_encoding_fn_xyz/num_encoding_fn_dir"
                )
    nerf = loaded.get("nerf")
    if isinstance(nerf, dict):
        if "dataset" not in loaded and any(k in nerf for k in ("ndc", "near", "far")):
            loaded["dataset"] = CfgNode({})
        if "ndc" in nerf:
            ndc = nerf.pop("ndc")
            if "no_ndc" not in loaded["dataset"]:
                loaded["dataset"]["no_ndc"] = not bool(ndc)
            applied.append(f"nerf.ndc={ndc} -> dataset.no_ndc={not bool(ndc)}")
        for k in ("near", "far"):
            if k in nerf:
                v = nerf.pop(k)
                if k not in loaded["dataset"]:
                    loaded["dataset"][k] = v
                applied.append(f"nerf.{k}={v} -> dataset.{k}")
    return applied


# Encoding functions selectable via nerf.encode_position_fn /
# nerf.encode_direction_fn; a config naming another one fails loudly.
ENCODING_FNS = ("positional_encoding",)


def _validate_encoding_fns(cfg: CfgNode) -> None:
    for key in ("encode_position_fn", "encode_direction_fn"):
        name = getattr(cfg.nerf, key, "positional_encoding")
        if name not in ENCODING_FNS:
            raise ValueError(
                f"nerf.{key}={name!r} is not a known encoding function; "
                f"available: {ENCODING_FNS}"
            )


def render_settings_from_config(
    cfg: CfgNode,
    mode: str = "train",
    hwf: Optional[Tuple[int, int, float]] = None,
) -> RenderSettings:
    """RenderSettings from cfg.nerf.<mode> + cfg.dataset + the coarse model's
    encoding; any falsy ``dataset.no_ndc`` means NDC."""
    mode_cfg = getattr(cfg.nerf, mode)
    model_cfg = cfg.models.coarse
    use_ndc = not cfg.dataset.no_ndc
    height, width, focal = (0, 0, 0.0) if hwf is None else hwf
    if use_ndc and hwf is None:
        raise ValueError("NDC rendering requires hwf=(height, width, focal)")
    return RenderSettings(
        num_coarse=int(mode_cfg.num_coarse),
        num_fine=int(mode_cfg.num_fine),
        chunksize=int(mode_cfg.chunksize),
        perturb=bool(mode_cfg.perturb),
        radiance_field_noise_std=float(mode_cfg.radiance_field_noise_std),
        white_background=bool(mode_cfg.white_background),
        lindisp=bool(mode_cfg.lindisp),
        near=float(cfg.dataset.near),
        far=float(cfg.dataset.far),
        use_viewdirs=bool(cfg.nerf.use_viewdirs),
        use_ndc=use_ndc,
        height=int(height),
        width=int(width),
        focal_length=float(focal),
        num_encoding_fn_xyz=int(model_cfg.num_encoding_fn_xyz),
        num_encoding_fn_dir=int(model_cfg.num_encoding_fn_dir),
        include_input_xyz=bool(model_cfg.include_input_xyz),
        include_input_dir=bool(model_cfg.include_input_dir),
        log_sampling_xyz=bool(model_cfg.log_sampling_xyz),
        log_sampling_dir=bool(model_cfg.log_sampling_dir),
        use_pallas=bool(getattr(mode_cfg, "use_pallas", False)),
        use_pallas_train=bool(getattr(mode_cfg, "use_pallas_train", False)),
        remat=bool(getattr(mode_cfg, "remat", False)),
        compute_dtype=str(getattr(mode_cfg, "compute_dtype", "float32")),
    )


_SIZE_KEYS = (
    "num_layers", "hidden_size", "skip_connect_every", "num_encoding_fn_xyz",
    "num_encoding_fn_dir", "include_input_xyz", "include_input_dir", "use_viewdirs",
    # HashGridNeRFModel's grid and heads
    "num_levels", "features_per_level", "log2_hashmap_size", "base_resolution",
    "max_resolution", "density_outputs", "sh_degree", "box",
)


def model_from_config(model_cfg: CfgNode, reference_compat_shapes: bool = False):
    """Instantiate a model family from a cfg.models.{coarse,fine} section.

    The kwargs are the JAX package's (``nerf_tpu/config/schema.py:280-322``):
    the size keys a family accepts, VeryTiny and MultiHead's one encoding
    count from ``num_encoding_fn_xyz``, and VeryTiny's ``filter_size`` from
    ``hidden_size``."""
    name = model_cfg.type
    if reference_compat_shapes and name != "HashGridNeRFModel":
        # The reference's constructor call: encoding and viewdir arguments
        # only; sizes keep the class defaults. The reference has no hash
        # grid: a .ckpt of one is the port's, built as configured.
        if name in ("VeryTinyNeRFModel", "MultiHeadNeRFModel"):
            return get_model(name, num_encoding_functions=model_cfg.num_encoding_fn_xyz)
        keys = ("num_encoding_fn_xyz", "num_encoding_fn_dir", "include_input_xyz",
                "include_input_dir")
        if name in ("PaperNeRFModel", "FlexibleNeRFModel"):
            keys += ("use_viewdirs",)
        return get_model(name, **{k: model_cfg[k] for k in keys})
    cls = MODEL_REGISTRY.get(name)
    if cls is None:
        return get_model(name)  # raises, naming the families there are
    accepted = inspect.signature(cls).parameters
    kwargs = {k: model_cfg[k] for k in _SIZE_KEYS if k in model_cfg and k in accepted}
    if "num_encoding_functions" in accepted and "num_encoding_fn_xyz" in model_cfg:
        kwargs["num_encoding_functions"] = model_cfg["num_encoding_fn_xyz"]
    if "filter_size" in accepted and "hidden_size" in model_cfg:
        kwargs["filter_size"] = model_cfg["hidden_size"]
    return get_model(name, **kwargs)


def optimizer_from_config(cfg: CfgNode) -> OptimizerSpec:
    """The optimizer + schedule from cfg.optimizer / cfg.scheduler."""
    lr_decay = cfg.scheduler.lr_decay if "scheduler" in cfg else None
    lr_decay_factor = cfg.scheduler.lr_decay_factor if "scheduler" in cfg else None
    return make_optimizer(
        cfg.optimizer.type, float(cfg.optimizer.lr), lr_decay, lr_decay_factor,
        grad_clip_norm=float(getattr(cfg.optimizer, "grad_clip_norm", 0.0)) or None,
    )
