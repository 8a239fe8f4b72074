"""Flat ray stores and the offline ray-cache format (port of
``nerf_tpu/data/rays_store.py``).

A store is three (N, 3) float32 arrays, ray origins, ray directions and rgb
targets, covering every training pixel; training moves it to the device once
and draws its ray batches there (``engine.train.sample_ray_batch``). The
cache is one ``.npz`` of those arrays plus json-encoded meta (height, width,
focal, near, far), and optionally validation images with their poses. A
reference-format cache directory (``train/*.data`` ``torch.save`` files) is
read with ``torch.load(..., weights_only=True)``.

``build_ray_store`` takes the threaded C++ builder (``native/raystore.cpp``)
first, as the JAX package does, and runs the ray generation in PyTorch on the
device given where that library does not build.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.rays import get_ray_bundle


def ray_store_builder(use_native: bool = True) -> str:
    """Which builder ``build_ray_store(..., use_native)`` runs here:
    ``"native"`` (the C++ library, built at first use) or ``"torch"``."""
    from .. import native

    return "native" if use_native and native.available() else "torch"


@torch.no_grad()
def build_ray_store(images: np.ndarray, poses: np.ndarray, height: int, width: int,
                    focal: float, device="cpu", use_native: bool = True
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Expand (N, H, W, 3+) images and (N, 3+, 4) poses into flat ray arrays:
    (ray_origins, ray_directions, targets), each (N*H*W, 3) float32 numpy.

    The C++ builder (``ray_store_builder``) computes the directions as
    ``x * (1 / focal)`` in another order of sums than the PyTorch path below,
    its executable spec: they agree to 1.2e-7.
    """
    if ray_store_builder(use_native) == "native":
        from .. import native

        return native.build_ray_store_native(np.asarray(poses), np.asarray(images),
                                             height, width, focal)
    origins, directions, targets = [], [], []
    for img, pose in zip(images, poses):
        c2w = torch.as_tensor(np.asarray(pose)[:3, :4], dtype=torch.float32, device=device)
        ro, rd = get_ray_bundle(height, width, focal, c2w)
        origins.append(ro.reshape(-1, 3).cpu().numpy())
        directions.append(rd.reshape(-1, 3).cpu().numpy())
        targets.append(np.asarray(img[..., :3], np.float32).reshape(-1, 3))
    return (
        np.concatenate(origins).astype(np.float32),
        np.concatenate(directions).astype(np.float32),
        np.concatenate(targets).astype(np.float32),
    )


def shuffle_ray_store(ray_origins: np.ndarray, ray_directions: np.ndarray,
                      targets: np.ndarray, seed: int = 0):
    """One seeded permutation applied to all three arrays (the store that
    ``sliced`` sampling needs)."""
    perm = np.random.default_rng(seed).permutation(ray_origins.shape[0])
    return ray_origins[perm], ray_directions[perm], targets[perm]


def save_ray_cache(path: str, ray_origins: np.ndarray, ray_directions: np.ndarray,
                   targets: np.ndarray, meta: Dict, val_images: Optional[np.ndarray] = None,
                   val_poses: Optional[np.ndarray] = None) -> None:
    """Write the single-file ray cache (.npz + json-encoded meta)."""
    arrays = {
        "ray_origins": ray_origins.astype(np.float32),
        "ray_directions": ray_directions.astype(np.float32),
        "targets": targets.astype(np.float32),
        "meta_json": np.frombuffer(json.dumps(meta, sort_keys=True).encode(), dtype=np.uint8),
    }
    if val_images is not None:
        arrays["val_images"] = val_images.astype(np.float32)
        arrays["val_poses"] = val_poses.astype(np.float32)
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, **arrays)
    os.replace(tmp, path)


def load_ray_cache(path: str):
    """Read a ray cache: (ray_origins, ray_directions, targets, meta, extras)."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["meta_json"]).decode())
        extras = {}
        if "val_images" in data:
            extras["val_images"] = data["val_images"]
            extras["val_poses"] = data["val_poses"]
        return data["ray_origins"], data["ray_directions"], data["targets"], meta, extras


def is_reference_cache_dir(path: str) -> bool:
    """True when ``path`` holds a ``train/`` directory of ``*.data`` files
    (the reference's ``cache_dataset.py`` output)."""
    train_dir = os.path.join(path, "train")
    if not os.path.isdir(train_dir):
        return False
    return any(name.endswith(".data") for name in os.listdir(train_dir))


def load_reference_cache_dir(path: str):
    """Ingest a reference-format cache directory into a flat ray store.

    Each ``train/**/*.data`` file is a ``torch.save`` dict with ``height``,
    ``width``, ``focal_length``, ``ray_bundle`` (2, ..., 3) and ``target``
    (..., 3 or 4); every file is read once. Returns the
    :func:`load_ray_cache` tuple; ``extras`` is empty (the reference cache
    keeps no validation poses).
    """
    train_dir = os.path.join(path, "train")
    files = sorted(
        os.path.join(root, name)
        for root, _dirs, names in os.walk(train_dir)
        for name in names
        if name.endswith(".data")
    )
    if not files:
        raise FileNotFoundError(f"no .data files under {train_dir} (not a reference cache dir?)")
    origins, directions, targets = [], [], []
    meta = None
    for fname in files:
        d = torch.load(fname, map_location="cpu", weights_only=True)
        bundle = np.asarray(d["ray_bundle"], np.float32)
        origins.append(bundle[0].reshape(-1, 3))
        directions.append(bundle[1].reshape(-1, 3))
        targets.append(np.asarray(d["target"], np.float32)[..., :3].reshape(-1, 3))
        if meta is None:
            meta = {"height": int(d["height"]), "width": int(d["width"]),
                    "focal": float(d["focal_length"])}
    return (np.concatenate(origins), np.concatenate(directions), np.concatenate(targets),
            meta, {})
