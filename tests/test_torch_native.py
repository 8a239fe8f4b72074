"""The port's native ray store (``nerf_tpu_torch/native``) against the JAX
package's (``nerf_tpu/native``): the same C++ source, built by each package
with g++, must give ``.nrc`` files byte-equal both ways and equal stores; the
port's ``build_ray_store`` takes it first, and its rays agree with the
PyTorch builder to 1e-6 (measured: up to 1.2e-7, a direction computed as
``x * (1/f)`` against ``x / f``, summed in another order). The library is
built under ``build/nerf_tpu_torch/``, never beside its source.
"""

import os

import numpy as np
import pytest
import torch

from nerf_tpu import native as jax_native
from nerf_tpu.data import pose_spherical
from nerf_tpu_torch import native
from nerf_tpu_torch.data import build_ray_store, ray_store_builder

torch.set_num_threads(1)


def _fixture(n=3, h=16, w=20):
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 1, (n, h, w, 4)).astype(np.float32)
    poses = np.stack([pose_spherical(30.0 * i, -20.0 - 5 * i, 4.0) for i in range(n)])
    return images, poses, h, w, 25.0


def test_library_builds_under_build_dir():
    assert native.available()
    path = native.library_path()
    assert path.exists() and path.parent.parts[-2:] == ("build", "nerf_tpu_torch")
    src_dir = os.path.dirname(native.__file__)
    assert not [f for f in os.listdir(src_dir) if f.endswith(".so")]


def test_native_store_matches_jax_and_the_torch_builder():
    images, poses, h, w, focal = _fixture()
    assert ray_store_builder() == "native" and ray_store_builder(False) == "torch"
    got = build_ray_store(images, poses, h, w, focal)
    want = jax_native.build_ray_store_native(poses[:, :3, :4], images, h, w, focal)
    for a, b in zip(got, want):
        assert a.dtype == np.float32 and a.shape == (3 * h * w, 3)
        np.testing.assert_array_equal(a, b)
    spec = build_ray_store(images, poses, h, w, focal, use_native=False)
    for a, b in zip(got, spec):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[2], images[..., :3].reshape(-1, 3))


def test_nrc_files_are_byte_equal_both_ways(tmp_path):
    images, poses, h, w, focal = _fixture()
    ro, rd, rgb = build_ray_store(images, poses, h, w, focal)
    ours, theirs = str(tmp_path / "port.nrc"), str(tmp_path / "jax.nrc")
    native.pack_ray_cache(ours, ro, rd, rgb, h, w, focal, 2.0, 6.0)
    jax_native.pack_ray_cache(theirs, ro, rd, rgb, h, w, focal, 2.0, 6.0)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    for path, reader in ((ours, jax_native.load_ray_cache_native),
                         (theirs, native.load_ray_cache_native)):
        ro2, rd2, rgb2, meta = reader(path)
        for a, b in zip((ro2, rd2, rgb2), (ro, rd, rgb)):
            np.testing.assert_array_equal(a, b)
        assert meta == {"height": h, "width": w, "focal": focal, "near": 2.0, "far": 6.0}


def test_nrc_rejects_garbage(tmp_path):
    bad = tmp_path / "bad.nrc"
    bad.write_bytes(b"not a cache file at all, definitely" * 4)
    with pytest.raises(IOError, match="invalid ray cache"):
        native.load_ray_cache_native(str(bad))


def test_failed_build_raises_in_the_nrc_functions(monkeypatch, tmp_path):
    """A source g++ refuses: the .nrc functions raise with its message and
    the store falls back to the PyTorch builder, as in the JAX package."""
    broken = tmp_path / "raystore.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.load_ray_cache_native(str(tmp_path / "x.nrc"))
    assert not native.available() and ray_store_builder() == "torch"
    images, poses, h, w, focal = _fixture(n=1)
    ro, rd, rgb = build_ray_store(images, poses, h, w, focal)
    assert ro.shape == (h * w, 3)
