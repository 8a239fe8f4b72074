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
(``load_models_and_params``); resuming training from one, with its optax
Adam state, is not ported yet (ROADMAP.md, open items §1 item 7).

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


def latest_checkpoint(logdir: str, prefix: str = "checkpoint", suffix: str = ".ckpt"
                      ) -> Optional[str]:
    """The highest-step ``<prefix>NNNNN<suffix>`` file in ``logdir``, or None."""
    if not os.path.isdir(logdir):
        return None
    best, best_step = None, -1
    for name in os.listdir(logdir):
        if name.startswith(prefix) and name.endswith(suffix):
            digits = "".join(ch for ch in name[len(prefix):-len(suffix)] if ch.isdigit())
            step = int(digits) if digits else 0
            if step > best_step:
                best, best_step = os.path.join(logdir, name), step
    return best


def load_train_checkpoint(path: str, model_coarse: torch.nn.Module,
                          model_fine: Optional[torch.nn.Module],
                          optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
    """Restore a reference ``.ckpt`` into the modules and, when its
    ``optimizer_state_dict`` holds moments shaped like ``optimizer``'s
    parameters, into ``optimizer``.

    Returns ``{"step": iter, "count": updates the restored moments have
    seen (0 when they restart fresh), "moments": whether they were
    restored}``.
    """
    if not path.endswith(".ckpt"):
        raise NotImplementedError(
            f"{path}: training resumes from reference .ckpt files only; resuming from a "
            "native .ntc with its optax Adam state is not ported yet (ROADMAP.md, open "
            "items §1 item 7)"
        )
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
        # The moments come from the file; the hyperparameters stay this
        # optimizer's own (the file's are the exporter's).
        own = [{k: v for k, v in g.items() if k != "params"} for g in optimizer.param_groups]
        # The JAX package's exporter writes one `step` tensor shared by every
        # parameter's state; torch's Adam adds to each state's `step` in
        # place, so a shared one would count every update once per parameter.
        for entry in moments.values():
            entry["step"] = torch.as_tensor(entry["step"], dtype=torch.float32).clone()
        optimizer.load_state_dict(ckpt["optimizer_state_dict"])
        for group, hyper in zip(optimizer.param_groups, own):
            group.update(hyper)
        count = int(float(moments[0]["step"]))
    return {"step": int(ckpt.get("iter", 0)), "count": count, "moments": fits}
