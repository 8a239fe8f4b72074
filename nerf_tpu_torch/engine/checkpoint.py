"""Checkpoint conversion, loading and writing (port of
``nerf_tpu/engine/checkpoint.py``).

Reference checkpoints are ``torch.save`` dicts with ``iter``,
``model_coarse_state_dict``, ``model_fine_state_dict`` (or None),
``optimizer_state_dict``, ``loss`` and ``psnr``, and optionally
``height``/``width``/``focal_length``; they are read with
``torch.load(..., weights_only=True)``. ``optimizer_state_dict`` is a
``torch.optim.Adam.state_dict()`` over ``list(coarse.parameters()) +
list(fine.parameters())``: the layout the JAX package's
``reference_optimizer_state_dict`` writes from its optax state, so a
checkpoint either package exported resumes training here with its moments.

Native ``.ntc`` checkpoints are the JAX package's: flax msgpack of a plain
dict (``step``, ``params_coarse``, ``params_fine``, and from its trainer
``opt_state``, ``loss`` and ``psnr``), read and written here by
``utils/msgpack.py`` without flax. Their params render here
(``load_models_and_params``) and training resumes from them with their optax
state (``load_train_checkpoint``); the trainer writes them with its own
state in the same layout (``ntc_train_state``), so either package resumes
the other's run. The JAX optimizer is ``optax.flatten`` of its rule: Adam's
``mu`` and ``nu`` are each one vector, the ``jax.flatten_util.ravel_pytree``
of ``{"coarse": params, "fine": params}`` (dict keys sorted, ``bias`` before
``kernel``, list entries in order, kernels (in, out)), and tuples of states
are lists in the file.

The JAX package's params layout (nested dicts of ``{"kernel": (in, out),
"bias": (out,)}``, lists for ``layers_xyz``/``layers_dir``) is kept as the
interchange format: ``load_jax_params`` puts such a dict of numpy arrays into
a module of this package, so both packages can compute with the same weights.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..utils.msgpack import msgpack_restore, msgpack_serialize
from .optimizers import OPTAX_RULES, TORCH_KEY

Params = Dict[str, Any]


def convert_torch_state_dict(state_dict: Dict[str, Any]) -> Params:
    """A reference ``state_dict`` (tensors or numpy arrays) -> params pytree of
    numpy arrays: ``*.weight`` (out, in) becomes ``kernel`` (in, out), a layer
    without a bias has none; a top-level leaf of its own (a hash-grid
    field's ``table``) keeps its name and layout."""
    params: Params = {}
    list_sizes: Dict[str, int] = {}
    for key in state_dict:
        parts = key.split(".")
        if len(parts) == 3 and parts[1].isdigit():
            list_sizes[parts[0]] = max(list_sizes.get(parts[0], 0), int(parts[1]) + 1)
    for name, size in list_sizes.items():
        params[name] = [{} for _ in range(size)]

    for key, value in state_dict.items():
        arr = value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)
        parts = key.split(".")
        if len(parts) == 1:
            params[key] = arr.copy()
            continue
        if parts[-1] == "weight":
            leaf_name, leaf = "kernel", arr.T.copy()
        elif parts[-1] == "bias":
            leaf_name, leaf = "bias", arr.copy()
        else:
            raise ValueError(f"Unrecognized state-dict leaf: {key}")
        if len(parts) == 2:
            params.setdefault(parts[0], {})[leaf_name] = leaf
        elif len(parts) == 3 and parts[1].isdigit():
            params[parts[0]][int(parts[1])][leaf_name] = leaf
        else:
            raise ValueError(f"Unrecognized state-dict key structure: {key}")
    return params


def to_torch_state_dict(params: Params) -> Dict[str, np.ndarray]:
    """Inverse of :func:`convert_torch_state_dict` (values are numpy arrays)."""
    out: Dict[str, np.ndarray] = {}

    def emit(prefix: str, layer: Dict[str, Any]) -> None:
        out[f"{prefix}.weight"] = np.asarray(layer["kernel"]).T.copy()
        if "bias" in layer:
            out[f"{prefix}.bias"] = np.asarray(layer["bias"]).copy()

    for name, value in params.items():
        if isinstance(value, (list, tuple)):
            for i, layer in enumerate(value):
                emit(f"{name}.{i}", layer)
        elif isinstance(value, dict):
            emit(name, value)
        else:
            out[name] = np.asarray(value).copy()
    return out


def load_jax_params(module: torch.nn.Module, params: Params) -> torch.nn.Module:
    """Load a JAX-layout params dict (numpy ``kernel`` (in, out) and ``bias``)
    into ``module`` in place, key for key (strict). Returns ``module``."""
    state = {
        k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
        for k, v in to_torch_state_dict(params).items()
    }
    module.load_state_dict(state, strict=True)
    return module


def load_reference_checkpoint(path: str) -> Dict[str, Any]:
    """Read a reference ``.ckpt`` into numpy params pytrees.

    Returns ``step``, ``params_coarse``, ``params_fine`` (or None), ``loss``,
    ``psnr`` and the optional ``height``/``width``/``focal_length`` keys.
    """
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    out: Dict[str, Any] = {
        "step": int(ckpt.get("iter", 0)),
        "params_coarse": convert_torch_state_dict(ckpt["model_coarse_state_dict"]),
        "params_fine": (
            convert_torch_state_dict(ckpt["model_fine_state_dict"])
            if ckpt.get("model_fine_state_dict") is not None
            else None
        ),
        "loss": float(ckpt["loss"]) if "loss" in ckpt else None,
        "psnr": float(ckpt["psnr"]) if "psnr" in ckpt else None,
    }
    for extra in ("height", "width", "focal_length"):
        if extra in ckpt:
            out[extra] = ckpt[extra]
    return out


def save_checkpoint(path: str, state: Dict[str, Any]) -> None:
    """Write ``state`` (a dict of dicts, lists, scalars, numpy arrays and
    tensors) as a native ``.ntc``: the bytes ``flax.serialization.
    msgpack_serialize`` gives, written to a temporary file and moved into
    place, so a reader never sees a partial file."""
    data = msgpack_serialize(_to_numpy(state))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Read a native ``.ntc``: the dict it holds, arrays as numpy arrays."""
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


def load_models_and_params(checkpoint_path: str, cfg, device="cpu"):
    """Build the configured models on ``device`` and load a checkpoint into
    them: a native ``.ntc`` or a reference ``.ckpt``.

    Reference checkpoints get default-shaped models
    (``reference_compat_shapes``): the reference never passed size
    hyperparameters to its constructors. Native ones get the models as
    configured, as in the JAX package. Returns ``(model_coarse, model_fine,
    ckpt)``, ``ckpt`` the checkpoint's dict; ``model_fine`` is None when the
    config or the checkpoint has no fine model, and the coarse model then
    renders both passes.
    """
    from ..config.schema import model_from_config  # config imports engine

    reference = checkpoint_path.endswith(".ckpt")
    if reference:
        ckpt = load_reference_checkpoint(checkpoint_path)
    elif checkpoint_path.endswith(".ntc"):
        ckpt = load_checkpoint(checkpoint_path)
    else:
        raise ValueError(f"{checkpoint_path}: want a native .ntc or a reference .ckpt")
    model_coarse = model_from_config(cfg.models.coarse, reference_compat_shapes=reference)
    load_jax_params(model_coarse, ckpt["params_coarse"])
    model_fine = None
    if "fine" in cfg.models and ckpt.get("params_fine") is not None:
        model_fine = model_from_config(cfg.models.fine, reference_compat_shapes=reference)
        model_fine = load_jax_params(model_fine, ckpt["params_fine"]).to(device).eval()
    return model_coarse.to(device).eval(), model_fine, ckpt


def _to_numpy(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_numpy(v) for v in obj]
    return obj


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _write_reference_checkpoint(path: str, step: int, state_coarse: Dict[str, Any],
                                state_fine: Optional[Dict[str, Any]],
                                optimizer_state_dict: Dict[str, Any], loss: float, psnr: float,
                                hwf: Optional[tuple]) -> None:
    """The one writer of a reference-schema ``.ckpt``: ``torch.save`` to a
    temporary file, then an atomic rename."""
    ckpt: Dict[str, Any] = {
        "iter": int(step),
        "model_coarse_state_dict": state_coarse,
        "model_fine_state_dict": state_fine,
        "optimizer_state_dict": optimizer_state_dict,
        "loss": float(loss),
        "psnr": float(psnr),
    }
    if hwf is not None:
        ckpt["height"], ckpt["width"], ckpt["focal_length"] = hwf
    tmp = path + ".tmp"
    torch.save(ckpt, tmp)
    os.replace(tmp, path)


def export_reference_checkpoint(path: str, step: int, model_coarse: torch.nn.Module,
                                model_fine: Optional[torch.nn.Module], loss: float,
                                psnr: float, optimizer: torch.optim.Optimizer,
                                hwf: Optional[tuple] = None) -> None:
    """Write a reference-schema ``.ckpt`` (tensors on the CPU): the modules'
    state dicts, ``optimizer.state_dict()`` and the loss and PSNR of the
    last step."""
    _write_reference_checkpoint(
        path, step, _to_cpu(model_coarse.state_dict()),
        _to_cpu(model_fine.state_dict()) if model_fine is not None else None,
        _to_cpu(optimizer.state_dict()), loss, psnr,
        (int(hwf[0]), int(hwf[1]), float(hwf[2])) if hwf is not None else None)


def _module_prefix_order(params: Params) -> list:
    """The reference's attribute registration order of each family
    (nerf/models.py), which is its ``parameters()`` order."""
    prefixes = set(params.keys())
    if "table" in prefixes:                        # HashGridNeRFModel
        return ["table", "density_net", "color_net"]
    if "fc_out" in prefixes:                       # FlexibleNeRF, no viewdirs
        return ["layer1", "layers_xyz", "fc_out"]
    if "layer1" in prefixes and "layers_xyz" in prefixes:  # FlexibleNeRF
        return ["layer1", "layers_xyz", "layers_dir", "fc_alpha", "fc_rgb", "fc_feat"]
    if "layers_xyz" in prefixes:                   # PaperNeRFModel
        return ["layers_xyz", "fc_feat", "fc_alpha", "layers_dir", "fc_rgb"]
    if "layer3_1" in prefixes:                     # MultiHeadNeRFModel
        return ["layer1", "layer2", "layer3_1", "layer3_2", "layer4", "layer5", "layer6"]
    if "fc_alpha" in prefixes:                     # ReplicateNeRFModel
        return ["layer1", "layer2", "layer3", "fc_alpha", "layer4", "layer5", "fc_rgb"]
    return ["layer1", "layer2", "layer3"]          # VeryTinyNeRFModel


def reference_state_dict_order(params: Params) -> list:
    """The reference model's state-dict keys in its ``parameters()`` order."""
    keys = []
    for prefix in _module_prefix_order(params):
        value = params.get(prefix)
        if isinstance(value, (list, tuple)):
            for i, layer in enumerate(value):
                keys += [f"{prefix}.{i}.weight"] + ([f"{prefix}.{i}.bias"] if "bias" in layer
                                                    else [])
        elif isinstance(value, dict):
            keys += [f"{prefix}.weight"] + ([f"{prefix}.bias"] if "bias" in value else [])
        elif value is not None:
            keys.append(prefix)
    return keys


def reference_optimizer_state_dict(opt_state: Any, params_coarse: Params,
                                   params_fine: Optional[Params], lr: float = 5.0e-3,
                                   betas: tuple = (0.9, 0.999), eps: float = 1e-8
                                   ) -> Dict[str, Any]:
    """A ``torch.optim.Adam`` state dict over the reference's parameter order
    from a ``.ntc``'s optax state (the JAX package's
    ``reference_optimizer_state_dict``): the Adam moments, weight moments in
    torch's (out, in) layout, or, with no Adam moments, a valid empty state.

    The JAX trainer's state is ``optax.flatten``'s, so Adam's ``count``,
    ``mu`` and ``nu`` are three leaves in a row: a scalar, then two vectors
    raveled over every parameter in ``ravel_order``'s order."""
    trees = [to_torch_state_dict(p) for p in (params_coarse, params_fine) if p is not None]
    keys = [reference_state_dict_order(p) for p in (params_coarse, params_fine) if p is not None]
    size = sum(int(np.size(v)) for sd in trees for v in sd.values())
    leaves = _leaves(opt_state)
    found = next((leaves[i:i + 3] for i in range(len(leaves) - 2)
                  if np.ndim(leaves[i]) == 0
                  and np.shape(leaves[i + 1]) == np.shape(leaves[i + 2]) == (size,)), None)
    state: Dict[int, Dict[str, Any]] = {}
    if found is not None:
        count, mu, nu = (np.asarray(leaf) for leaf in found)
        moments: Dict[tuple, tuple] = {}
        offset = 0
        for which, sd in enumerate(trees):
            for key in sorted(sd, key=_ravel_key):
                shape = np.shape(sd[key])
                n = int(np.prod(shape))

                def take(flat):
                    if key.endswith(".weight"):       # raveled as the (in, out) kernel
                        return np.ascontiguousarray(flat[offset:offset + n].reshape(shape[::-1]).T)
                    return flat[offset:offset + n].reshape(shape)

                moments[which, key] = take(mu), take(nu)
                offset += n
        step_t = torch.tensor(float(count))
        ordered = [moments[which, key] for which, ks in enumerate(keys) for key in ks]
        for i, (m, v) in enumerate(ordered):
            state[i] = {"step": step_t,
                        "exp_avg": torch.from_numpy(np.array(m, np.float32)),
                        "exp_avg_sq": torch.from_numpy(np.array(v, np.float32))}
    return {
        "state": state,
        "param_groups": [{"lr": float(lr), "betas": tuple(betas), "eps": float(eps),
                          "weight_decay": 0, "amsgrad": False,
                          "params": list(range(sum(len(ks) for ks in keys)))}],
    }


def export_reference_params(path: str, step: int, params_coarse: Params,
                            params_fine: Optional[Params], loss: float, psnr: float,
                            hwf: Optional[tuple] = None, opt_state: Any = None,
                            lr: float = 5.0e-3) -> None:
    """Write a reference-schema ``.ckpt`` from params pytrees (a ``.ntc``'s),
    as the JAX package's ``export_reference_checkpoint`` does: readable by
    the reference's eval_nerf.py and resumable by its train_nerf.py."""
    def state_dict(params):
        return {k: torch.from_numpy(np.asarray(v)) for k, v in to_torch_state_dict(params).items()}

    _write_reference_checkpoint(
        path, step, state_dict(params_coarse),
        state_dict(params_fine) if params_fine is not None else None,
        reference_optimizer_state_dict(opt_state, params_coarse, params_fine, lr=lr),
        loss, psnr, hwf)


def latest_checkpoint(logdir: str, prefix: str = "checkpoint",
                      suffix: Optional[str] = None) -> Optional[str]:
    """The highest-step ``<prefix>NNNNN<suffix>`` file in ``logdir``, or
    None. ``suffix`` None takes ``.ntc`` and ``.ckpt`` files alike, the
    ``.ntc`` at a step that has both."""
    if not os.path.isdir(logdir):
        return None
    suffixes = (suffix,) if suffix else (".ckpt", ".ntc")
    best, best_key = None, None
    for name in os.listdir(logdir):
        for rank, sfx in enumerate(suffixes):
            if name.startswith(prefix) and name.endswith(sfx):
                digits = "".join(ch for ch in name[len(prefix):-len(sfx)] if ch.isdigit())
                key = (int(digits) if digits else 0, rank)
                if best_key is None or key > best_key:
                    best, best_key = os.path.join(logdir, name), key
    return best


def _leaves(tree: Any) -> list:
    """The array leaves of an optax state in its list form, in
    ``jax.tree.leaves`` order (dict keys sorted)."""
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [] if tree is None else [tree]


def _ravel_key(name: str) -> tuple:
    """A state-dict key's place in ``ravel_pytree``'s order of the JAX
    params: module names sorted, list entries in order, ``bias`` before
    ``kernel``."""
    parts = name.split(".")
    return (parts[0], int(parts[1]) if len(parts) == 3 else -1,
            "kernel" if parts[-1] == "weight" else "bias")


def ravel_order(model_coarse: torch.nn.Module, model_fine: Optional[torch.nn.Module]) -> list:
    """The parameters in the order ``ravel_pytree`` lays out the JAX params
    ``{"coarse": ..., "fine": ...}``: ``[(parameter, is_weight)]``, a weight
    raveled as its (in, out) transpose."""
    out = []
    for model in (model_coarse, model_fine):     # "coarse" sorts before "fine"
        if model is None:
            continue
        named = dict(model.named_parameters())
        out += [(named[name], name.endswith(".weight")) for name in sorted(named, key=_ravel_key)]
    return out


def _optax_layout(spec) -> list:
    """The JAX trainer's ``optax.flatten(make_optimizer(...))`` state for
    ``spec`` (an ``engine.train.OptimizerSpec``) in its list form, each leaf
    named: "count" (the rule's update count), "schedule" (the schedule's),
    or the rule's slot (a vector raveled over every parameter). The rule's
    state comes in its ``optax.chain``'s place (AdamW's weight decay,
    RMSprop's momentum and Adadelta's weight decay hold empty states, a
    constant rate an empty ``scale``, rprop's ``scale(-1)`` one too),
    behind the clipping's empty state when clipping is on."""
    if spec.name in ("adam", "adamw"):
        rule = ["count", "mu", "nu"]
    else:
        rule = list(OPTAX_RULES[spec.name].SLOTS) if spec.name in OPTAX_RULES else []
    schedule = ["schedule"] if spec.lr_decay and spec.lr_decay_factor else []
    inner = {
        "adamw": [rule, [], schedule],
        "rmsprop": [rule, schedule, []],
        "adadelta": [[], rule, schedule],
        "rprop": [rule, []],
    }.get(spec.name, [rule, schedule])
    return [[], inner] if spec.grad_clip_norm else inner


def _optax_state(layout: list, values: Dict[str, np.ndarray]) -> list:
    """``layout`` with each named leaf replaced by ``values[name]``."""
    if isinstance(layout, list):
        return [_optax_state(v, values) for v in layout]
    return values[layout]


def _slot_key(name: str) -> str:
    """The state key this package keeps an optax slot under."""
    return TORCH_KEY.get(name, name)


def ntc_train_state(step: int, model_coarse: torch.nn.Module,
                    model_fine: Optional[torch.nn.Module], optimizer: torch.optim.Optimizer,
                    spec, count: int, loss: float, psnr: float) -> Dict[str, Any]:
    """The dict the JAX trainer saves as ``checkpointNNNNN.ntc``, of this
    package's training state: params in the JAX layout and ``opt_state`` as
    the optax state of ``spec`` after ``count`` updates, each slot raveled
    from the optimizer's state (its initial value before the first update)."""
    layout = _optax_layout(spec)
    group = optimizer.param_groups[0]
    values: Dict[str, Any] = {"count": np.asarray(int(count), np.int32),
                              "schedule": np.asarray(int(count), np.int32)}
    for name in _leaves(layout):
        if name in values:
            continue
        parts = []
        for p, is_weight in ravel_order(model_coarse, model_fine):
            m = optimizer.state.get(p, {}).get(_slot_key(name))
            if m is None:
                m = (optimizer.initial_slot(name, p, group) if hasattr(optimizer, "initial_slot")
                     else torch.zeros_like(p))
            parts.append((m.t() if is_weight else m).detach().reshape(-1).cpu())
        values[name] = torch.cat(parts).numpy().astype(np.float32)
    return {
        "step": np.asarray(int(step)),
        "params_coarse": convert_torch_state_dict(model_coarse.state_dict()),
        "params_fine": (convert_torch_state_dict(model_fine.state_dict())
                        if model_fine is not None else None),
        "opt_state": _optax_state(layout, values),
        "loss": np.asarray(float(loss)),
        "psnr": np.asarray(float(psnr)),
    }


def _ntc_optimizer_state_dict(ckpt: Dict[str, Any], model_coarse, model_fine,
                              optimizer: torch.optim.Optimizer, spec) -> Optional[Dict[str, Any]]:
    """A ``.ntc``'s optax state as an ``optimizer.state_dict()`` to load, or
    None (with the JAX trainer's message) when it has none or its layout is
    not this optimizer's."""
    restored = _leaves(ckpt.get("opt_state"))
    order = ravel_order(model_coarse, model_fine)
    size = sum(p.numel() for p, _ in order)
    names = _leaves(_optax_layout(spec))
    template = [np.zeros((), np.int32) if n in ("count", "schedule") else np.zeros(size)
                for n in names]
    if not restored:
        print("checkpoint has no optimizer state; starting Adam fresh", flush=True)
        return None
    if len(restored) != len(template) or any(
            np.shape(a) != np.shape(b) for a, b in zip(restored, template)):
        print("checkpoint optimizer layout differs; starting Adam fresh", flush=True)
        return None
    values = {n: np.asarray(v) for n, v in zip(names, restored)}
    count = int(values.get("schedule", values.get("count", 0)))
    slots = [n for n in names if n not in ("count", "schedule")]
    sd = optimizer.state_dict()
    if not slots:
        # No moments (sgd): the leaves are the schedule's count alone.
        return {"state": {}, "param_groups": sd["param_groups"], "count": count}
    index = {id(p): i for i, p in enumerate(optimizer.param_groups[0]["params"])}
    state: Dict[int, Dict[str, Any]] = {}
    offset = 0
    for p, is_weight in order:
        n = p.numel()
        shape = tuple(reversed(p.shape)) if is_weight else tuple(p.shape)

        def take(flat):
            leaf = torch.from_numpy(np.array(flat[offset:offset + n], np.float32)).reshape(shape)
            return leaf.t().contiguous() if is_weight else leaf

        entry = {_slot_key(name): take(values[name]) for name in slots}
        if "count" in values:
            entry["step"] = torch.tensor(float(values["count"]))
        state[index[id(p)]] = entry
        offset += n
    return {"state": state, "param_groups": sd["param_groups"], "count": count}


def load_train_checkpoint(path: str, model_coarse: torch.nn.Module,
                          model_fine: Optional[torch.nn.Module],
                          optimizer: torch.optim.Optimizer, spec=None) -> Dict[str, Any]:
    """Restore a checkpoint into the modules and, where it holds them and
    they fit, the optimizer's moments.

    A reference ``.ckpt``: its ``optimizer_state_dict`` when it holds
    moments shaped like ``optimizer``'s parameters. A native ``.ntc``: its
    params (the JAX layout) and its optax state, whose layout must be the one
    ``spec`` (the ``OptimizerSpec`` that built ``optimizer``) gives, as the
    JAX trainer checks; otherwise the moments start fresh.

    Every parameter gets its own ``step`` tensor: ``torch.optim.Adam`` adds
    to it in place, so one tensor shared by all would count each update once
    per parameter. Returns ``{"step": steps taken, "count": updates the
    restored moments (or schedule) have seen, 0 when they restart fresh,
    "moments": whether moments were restored}``.
    """
    if path.endswith(".ntc"):
        ckpt = load_checkpoint(path)
        load_jax_params(model_coarse, ckpt["params_coarse"])
        if model_fine is not None:
            if ckpt.get("params_fine") is None:
                raise ValueError(f"{path} has no fine model, but a fine model is configured")
            load_jax_params(model_fine, ckpt["params_fine"])
        step = int(np.asarray(ckpt.get("step", 0)))
        if spec is None:
            raise ValueError("resuming from a .ntc needs the OptimizerSpec of the optimizer")
        sd = _ntc_optimizer_state_dict(ckpt, model_coarse, model_fine, optimizer, spec)
        if sd is None:
            return {"step": step, "count": 0, "moments": False}
        count = sd.pop("count")
        if sd["state"]:
            _load_optimizer_state(optimizer, sd)
        return {"step": step, "count": count, "moments": bool(sd["state"])}
    if not path.endswith(".ckpt"):
        raise ValueError(f"{path}: want a native .ntc or a reference .ckpt")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    model_coarse.load_state_dict(ckpt["model_coarse_state_dict"])
    if model_fine is not None:
        if ckpt.get("model_fine_state_dict") is None:
            raise ValueError(f"{path} has no fine model, but a fine model is configured")
        model_fine.load_state_dict(ckpt["model_fine_state_dict"])
    params = optimizer.param_groups[0]["params"]
    moments = (ckpt.get("optimizer_state_dict") or {}).get("state") or {}
    slots = [_slot_key(n) for n in _leaves(_optax_layout(spec)) if n not in ("count", "schedule")
             ] if spec is not None else ["exp_avg", "exp_avg_sq"]
    fits = bool(slots) and len(moments) == len(params) and all(
        i in moments and all(k in moments[i] and tuple(moments[i][k].shape) == tuple(p.shape)
                             for k in slots)
        for i, p in enumerate(params)
    )
    count = 0
    if fits:
        _load_optimizer_state(optimizer, ckpt["optimizer_state_dict"])
        count = int(float(moments[0].get("step", 0)))
    return {"step": int(ckpt.get("iter", 0)), "count": count, "moments": fits}


def _load_optimizer_state(optimizer: torch.optim.Optimizer, state_dict: Dict[str, Any]) -> None:
    """Load the moments of ``state_dict`` into ``optimizer``, each with its
    own ``step`` tensor where the rule counts; the hyperparameters stay the
    optimizer's own (the file's are its writer's)."""
    own = [{k: v for k, v in g.items() if k != "params"} for g in optimizer.param_groups]
    for entry in state_dict["state"].values():
        if "step" in entry:
            entry["step"] = torch.as_tensor(entry["step"], dtype=torch.float32).clone()
    optimizer.load_state_dict(state_dict)
    for group, hyper in zip(optimizer.param_groups, own):
        group.update(hyper)
