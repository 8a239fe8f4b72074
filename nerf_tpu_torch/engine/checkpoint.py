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

Params = Dict[str, Any]


def convert_torch_state_dict(state_dict: Dict[str, Any]) -> Params:
    """A reference ``state_dict`` (tensors or numpy arrays) -> params pytree of
    numpy arrays: ``*.weight`` (out, in) becomes ``kernel`` (in, out)."""
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
        out[f"{prefix}.bias"] = np.asarray(layer["bias"]).copy()

    for name, value in params.items():
        if isinstance(value, (list, tuple)):
            for i, layer in enumerate(value):
                emit(f"{name}.{i}", layer)
        else:
            emit(name, value)
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


def export_reference_checkpoint(path: str, step: int, model_coarse: torch.nn.Module,
                                model_fine: Optional[torch.nn.Module], loss: float,
                                psnr: float, optimizer: torch.optim.Optimizer,
                                hwf: Optional[tuple] = None) -> None:
    """Write a reference-schema ``.ckpt`` (``torch.save``, tensors on the CPU):
    the modules' state dicts, ``optimizer.state_dict()`` and the loss and
    PSNR of the last step."""
    ckpt: Dict[str, Any] = {
        "iter": int(step),
        "model_coarse_state_dict": _to_cpu(model_coarse.state_dict()),
        "model_fine_state_dict": (_to_cpu(model_fine.state_dict())
                                  if model_fine is not None else None),
        "optimizer_state_dict": _to_cpu(optimizer.state_dict()),
        "loss": float(loss),
        "psnr": float(psnr),
    }
    if hwf is not None:
        ckpt["height"], ckpt["width"], ckpt["focal_length"] = int(hwf[0]), int(hwf[1]), float(hwf[2])
    tmp = path + ".tmp"
    torch.save(ckpt, tmp)
    os.replace(tmp, path)


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
    ``jax.tree.leaves`` order."""
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [] if tree is None else [tree]


def ravel_order(model_coarse: torch.nn.Module, model_fine: Optional[torch.nn.Module]) -> list:
    """The parameters in the order ``ravel_pytree`` lays out the JAX params
    ``{"coarse": ..., "fine": ...}``: ``[(parameter, is_weight)]``, a weight
    raveled as its (in, out) transpose."""
    out = []
    for model in (model_coarse, model_fine):     # "coarse" sorts before "fine"
        if model is None:
            continue
        named = dict(model.named_parameters())

        def key(name: str):
            parts = name.split(".")
            return (parts[0], int(parts[1]) if len(parts) == 3 else -1,
                    "kernel" if parts[-1] == "weight" else "bias")

        out += [(named[name], name.endswith(".weight")) for name in sorted(named, key=key)]
    return out


def _optax_state(spec, count: np.ndarray, mu: np.ndarray, nu: np.ndarray) -> list:
    """The JAX trainer's ``optax.flatten(make_optimizer(...))`` state for
    ``spec`` (an ``engine.train.OptimizerSpec``) in its list form: the rule's
    state, then the schedule's count (an empty state for a constant rate),
    behind the clipping's empty state when clipping is on."""
    schedule = [count] if spec.lr_decay and spec.lr_decay_factor else []
    if spec.name == "adam":
        inner = [[count, mu, nu], schedule]
    elif spec.name == "adamw":
        inner = [[count, mu, nu], [], schedule]
    else:                                        # sgd without momentum
        inner = [[], schedule]
    return [[], inner] if spec.grad_clip_norm else inner


def ntc_train_state(step: int, model_coarse: torch.nn.Module,
                    model_fine: Optional[torch.nn.Module], optimizer: torch.optim.Optimizer,
                    spec, count: int, loss: float, psnr: float) -> Dict[str, Any]:
    """The dict the JAX trainer saves as ``checkpointNNNNN.ntc``, of this
    package's training state: params in the JAX layout and ``opt_state`` as
    the optax state of ``spec`` after ``count`` updates, ``mu``/``nu`` raveled
    from the Adam moments (zeros before the first update)."""
    moments = {"exp_avg": [], "exp_avg_sq": []}
    for p, is_weight in ravel_order(model_coarse, model_fine):
        state = optimizer.state.get(p, {})
        for name, parts in moments.items():
            m = state.get(name)
            m = torch.zeros_like(p) if m is None else m
            parts.append((m.t() if is_weight else m).detach().reshape(-1).cpu())
    mu, nu = (torch.cat(parts).numpy().astype(np.float32) for parts in moments.values())
    return {
        "step": np.asarray(int(step)),
        "params_coarse": convert_torch_state_dict(model_coarse.state_dict()),
        "params_fine": (convert_torch_state_dict(model_fine.state_dict())
                        if model_fine is not None else None),
        "opt_state": _optax_state(spec, np.asarray(int(count), np.int32), mu, nu),
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
    template = _leaves(_optax_state(spec, np.zeros((), np.int32), np.zeros(size, np.float32),
                                    np.zeros(size, np.float32)))
    if not restored:
        print("checkpoint has no optimizer state; starting Adam fresh", flush=True)
        return None
    if len(restored) != len(template) or any(
            np.shape(a) != np.shape(b) for a, b in zip(restored, template)):
        print("checkpoint optimizer layout differs; starting Adam fresh", flush=True)
        return None
    sd = optimizer.state_dict()
    if spec.name == "sgd":
        # No moments: the leaves are the schedule's count alone.
        return {"state": {}, "param_groups": sd["param_groups"], "count": int(restored[0])}
    # The layout is the template's, so its first three leaves are Adam's.
    count, mu, nu = (np.asarray(x) for x in restored[:3])
    index = {id(p): i for i, p in enumerate(optimizer.param_groups[0]["params"])}
    state: Dict[int, Dict[str, Any]] = {}
    offset = 0
    for p, is_weight in order:
        n = p.numel()
        shape = tuple(reversed(p.shape)) if is_weight else tuple(p.shape)

        def take(flat):
            leaf = torch.from_numpy(np.array(flat[offset:offset + n], np.float32)).reshape(shape)
            return leaf.t().contiguous() if is_weight else leaf

        state[index[id(p)]] = {"step": torch.tensor(float(count)),
                               "exp_avg": take(mu), "exp_avg_sq": take(nu)}
        offset += n
    return {"state": state, "param_groups": sd["param_groups"], "count": int(count)}


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
    fits = len(moments) == len(params) and all(
        i in moments and tuple(moments[i]["exp_avg"].shape) == tuple(p.shape)
        for i, p in enumerate(params)
    )
    count = 0
    if fits:
        _load_optimizer_state(optimizer, ckpt["optimizer_state_dict"])
        count = int(float(moments[0]["step"]))
    return {"step": int(ckpt.get("iter", 0)), "count": count, "moments": fits}


def _load_optimizer_state(optimizer: torch.optim.Optimizer, state_dict: Dict[str, Any]) -> None:
    """Load the moments of ``state_dict`` into ``optimizer``, each with its
    own ``step`` tensor; the hyperparameters stay the optimizer's own (the
    file's are its writer's)."""
    own = [{k: v for k, v in g.items() if k != "params"} for g in optimizer.param_groups]
    for entry in state_dict["state"].values():
        entry["step"] = torch.as_tensor(entry["step"], dtype=torch.float32).clone()
    optimizer.load_state_dict(state_dict)
    for group, hyper in zip(optimizer.param_groups, own):
        group.update(hyper)
