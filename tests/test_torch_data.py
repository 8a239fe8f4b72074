"""nerf_tpu_torch's synthetic scene, ray stores and metric writer against
the JAX package's.

The synthetic dataset's poses come from the same numpy seed in both
packages, and its images from the same analytic field rendered by each
package's own volume renderer: images, poses and flattened rays agree to
1e-5.
"""

import json
import os

import imageio.v2 as imageio
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.data import rays_store as jstore
from nerf_tpu.data import synthetic as jsyn
from nerf_tpu_torch.data import rays_store as tstore
from nerf_tpu_torch.data import synthetic as tsyn
from nerf_tpu_torch.utils import MetricWriter, RateMeter

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def datasets():
    kw = dict(num_views=3, height=32, width=32)
    return jsyn.make_synthetic_dataset(**kw), tsyn.make_synthetic_dataset(**kw)


def test_analytic_field_matches_jax():
    pts = np.random.default_rng(0).uniform(-1.5, 1.5, (7, 5, 3)).astype(np.float32)
    for phase, radius in ((0.0, 0.8), (0.7, 0.5)):
        want = np.asarray(jsyn.analytic_radiance_field(jnp.asarray(pts), phase, radius))
        got = tsyn.analytic_radiance_field(torch.from_numpy(pts), phase, radius).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_synthetic_dataset_matches_jax(datasets):
    want, got = datasets
    assert got.images.shape == (3, 32, 32, 3) and got.images.dtype == np.float32
    np.testing.assert_allclose(got.poses, want.poses, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.images, want.images, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.hwf, want.hwf)
    assert (got.near, got.far) == (want.near, want.far)
    # A white-background render of a sphere: background pixels are white.
    assert got.images.max() <= 1.0 + 1e-6 and got.images[:, 0, 0].min() > 0.99


def test_flatten_rays_matches_jax(datasets):
    want, got = datasets
    for a, b in zip(tsyn.flatten_rays(got), jsyn.flatten_rays(want)):
        assert a.shape == (3 * 32 * 32, 3) and a.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_build_and_shuffle_ray_store_match_jax(datasets):
    data, _ = datasets
    poses34 = data.poses[:, :3, :4]
    want = jstore.build_ray_store(data.images, poses34, 32, 32, data.hwf[2], use_native=False)
    got = tstore.build_ray_store(data.images, poses34, 32, 32, data.hwf[2])
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    for a, b in zip(tstore.shuffle_ray_store(*got, seed=3), jstore.shuffle_ray_store(*got, seed=3)):
        np.testing.assert_array_equal(a, b)


def test_ray_cache_round_trip(tmp_path, datasets):
    data, _ = datasets
    rays = jsyn.flatten_rays(data)
    meta = {"height": 32, "width": 32, "focal": float(data.hwf[2]), "near": 2.0, "far": 6.0}
    path = str(tmp_path / "rays.npz")
    tstore.save_ray_cache(path, *rays, meta, val_images=data.images[:1], val_poses=data.poses[:1])
    ro, rd, tgt, got_meta, extras = tstore.load_ray_cache(path)
    assert got_meta == meta
    for a, b in zip((ro, rd, tgt), rays):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(extras["val_images"], data.images[:1])
    # The JAX package reads the port's cache, and the other way round.
    jro, _, _, jmeta, jextras = jstore.load_ray_cache(path)
    assert jmeta == meta and "val_poses" in jextras
    np.testing.assert_array_equal(jro, ro)
    jpath = str(tmp_path / "jax_rays.npz")
    jstore.save_ray_cache(jpath, *rays, meta)
    assert tstore.load_ray_cache(jpath)[3] == meta and tstore.load_ray_cache(jpath)[4] == {}


def test_reference_cache_dir(tmp_path, datasets):
    data, _ = datasets
    ro, rd, _ = jsyn.flatten_rays(data)
    train = tmp_path / "cache" / "train"
    train.mkdir(parents=True)
    for i in range(2):
        sl = slice(i * 1024, (i + 1) * 1024)
        torch.save({
            "height": 32, "width": 32, "focal_length": float(data.hwf[2]),
            "ray_bundle": torch.stack([torch.from_numpy(ro[sl]), torch.from_numpy(rd[sl])]
                                      ).reshape(2, 32, 32, 3),
            "target": torch.from_numpy(data.images[i]),
        }, str(train / f"{i:04d}.data"))
    path = str(tmp_path / "cache")
    assert tstore.is_reference_cache_dir(path) and not tstore.is_reference_cache_dir(str(tmp_path))
    got = tstore.load_reference_cache_dir(path)
    want = jstore.load_reference_cache_dir(path)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
    assert got[3] == want[3] and got[4] == {}
    with pytest.raises(FileNotFoundError, match="no .data files"):
        tstore.load_reference_cache_dir(str(tmp_path))


def test_metric_writer_and_rate_meter(tmp_path):
    writer = MetricWriter(str(tmp_path))
    writer.scalars({"train/loss": 0.5, "train/psnr": 3.0}, 7)
    img = np.linspace(0, 1, 4 * 5 * 3, dtype=np.float32).reshape(4, 5, 3)
    path = writer.image("validation/rgb_fine", img, 7)
    writer.close()
    records = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert [(r["tag"], r["value"], r["step"]) for r in records] == [
        ("train/loss", 0.5, 7), ("train/psnr", 3.0, 7)]
    assert os.path.basename(path) == "validation_rgb_fine_000007.png"
    np.testing.assert_array_equal(imageio.imread(path), (img * 255).astype(np.uint8))
    meter = RateMeter(window=3)
    assert meter.rate() == 0.0
    for _ in range(5):
        meter.update(100)
    assert meter.rate() >= 0.0 and len(meter._times) == 3
