"""The native (C++) ray-store builder and ``.nrc`` ray cache (port of
``nerf_tpu/native``).

``raystore.cpp`` is built at first use with ``g++ -O3 -shared -fPIC
-std=c++17 -pthread`` into ``build/nerf_tpu_torch/`` at the root of the
checkout, under a name keyed by a hash of the source and the flags, and bound
with ``ctypes``. It exposes:

  - :func:`build_ray_store_native`: ray expansion of N images, threaded
    across images;
  - :func:`pack_ray_cache` / :func:`load_ray_cache_native`: the single-file
    ``.nrc`` ray cache (a fixed little-endian header, then the three arrays),
    the bytes the JAX package's functions write and read;
  - :func:`available`: whether the library builds and loads here.

Processes that start cold at once build it once: a file lock beside the
library serializes them (``_build``). When ``g++`` fails, the three
functions raise with its message;
``data.rays_store.build_ray_store`` then takes the PyTorch builder.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "raystore.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "nerf_tpu_torch"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes())
    return BUILD_DIR / f"libraystore_{h.hexdigest()[:16]}.so"


def _build() -> Path:
    """Build the library unless it exists. Processes that start cold at once
    (the ranks of a process group) take a file lock in turn, and each looks
    for the library again once it holds the lock, so one of them builds."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(out.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp")
        proc = subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed to build {SOURCE.name}:\n{proc.stderr}")
        os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    """Build (if needed) and load the library once per process; raise with
    the build's error when it cannot."""
    global _lib, _error
    with _lock:
        if _lib is not None:
            return _lib
        if _error is not None:
            raise RuntimeError(f"native raystore library unavailable: {_error}")
        try:
            try:
                lib = ctypes.CDLL(str(_build()))
            except OSError:
                # A library built on another machine (a copied build/): rebuild.
                library_path().unlink(missing_ok=True)
                lib = ctypes.CDLL(str(_build()))
        except (OSError, RuntimeError) as e:
            _error = str(e)
            raise RuntimeError(f"native raystore library unavailable: {_error}") from None
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.nerf_build_ray_store.argtypes = [
            f32p, f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, f32p, f32p, f32p, ctypes.c_int,
        ]
        lib.nerf_build_ray_store.restype = None
        lib.nerf_pack_ray_cache.argtypes = [
            ctypes.c_char_p, f32p, f32p, f32p, ctypes.c_uint64,
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ]
        lib.nerf_pack_ray_cache.restype = ctypes.c_int
        lib.nerf_ray_cache_info.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32), f32p, f32p, f32p,
        ]
        lib.nerf_ray_cache_info.restype = ctypes.c_int
        lib.nerf_load_ray_cache.argtypes = [ctypes.c_char_p, f32p, f32p, f32p, ctypes.c_uint64]
        lib.nerf_load_ray_cache.restype = ctypes.c_int
        _lib = lib
        return lib


def available() -> bool:
    """True when the library is (or can be) built and loaded."""
    try:
        _load()
    except RuntimeError:
        return False
    return True


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def build_ray_store_native(poses: np.ndarray, images: Optional[np.ndarray], height: int,
                           width: int, focal: float, num_threads: int = 0
                           ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """(ray_origins, ray_directions, targets), each (N*H*W, 3) float32, of
    (N, 3, 4+) c2w ``poses`` and (N, H, W, 3+) float32 ``images`` (targets
    None when ``images`` is None)."""
    lib = _load()
    poses = np.ascontiguousarray(np.asarray(poses)[:, :3, :4], np.float32)
    n = poses.shape[0]
    total = n * height * width
    ro = np.empty((total, 3), np.float32)
    rd = np.empty((total, 3), np.float32)
    rgb = img_ptr = None
    if images is not None:
        images = np.ascontiguousarray(np.asarray(images)[..., :3], np.float32)
        rgb = np.empty((total, 3), np.float32)
        img_ptr = _f32p(images)
    lib.nerf_build_ray_store(_f32p(poses), img_ptr, n, height, width, float(focal),
                             _f32p(ro), _f32p(rd), None if rgb is None else _f32p(rgb),
                             int(num_threads))
    return ro, rd, rgb


def pack_ray_cache(path: str, ray_origins: np.ndarray, ray_directions: np.ndarray,
                   targets: np.ndarray, height: int, width: int, focal: float, near: float,
                   far: float) -> None:
    """Write the three (N, 3) arrays and their meta as a ``.nrc`` file."""
    lib = _load()
    ro, rd, rgb = (np.ascontiguousarray(a, np.float32)
                   for a in (ray_origins, ray_directions, targets))
    rc = lib.nerf_pack_ray_cache(str(path).encode(), _f32p(ro), _f32p(rd), _f32p(rgb),
                                 ro.shape[0], height, width, float(focal), float(near),
                                 float(far))
    if rc != 0:
        raise IOError(f"nerf_pack_ray_cache failed with code {rc} for {path}")


def load_ray_cache_native(path: str):
    """Read a ``.nrc`` file: (ray_origins, ray_directions, targets, meta)."""
    lib = _load()
    num_rays, height, width = ctypes.c_uint64(), ctypes.c_uint32(), ctypes.c_uint32()
    focal, near, far = ctypes.c_float(), ctypes.c_float(), ctypes.c_float()
    rc = lib.nerf_ray_cache_info(str(path).encode(), ctypes.byref(num_rays),
                                 ctypes.byref(height), ctypes.byref(width),
                                 ctypes.byref(focal), ctypes.byref(near), ctypes.byref(far))
    if rc != 0:
        raise IOError(f"invalid ray cache {path} (code {rc})")
    n = int(num_rays.value)
    ro, rd, rgb = (np.empty((n, 3), np.float32) for _ in range(3))
    rc = lib.nerf_load_ray_cache(str(path).encode(), _f32p(ro), _f32p(rd), _f32p(rgb), n)
    if rc != 0:
        raise IOError(f"nerf_load_ray_cache failed with code {rc} for {path}")
    meta = {"height": int(height.value), "width": int(width.value), "focal": float(focal.value),
            "near": float(near.value), "far": float(far.value)}
    return ro, rd, rgb, meta
