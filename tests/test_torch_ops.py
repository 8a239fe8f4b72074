"""nerf_tpu_torch.ops against nerf_tpu.ops on the same numpy inputs.

Tolerance 1e-5: the same float32 formulas, run by two libraries whose
elementwise functions and reductions round differently in the last bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu import ops as jops
from nerf_tpu.ops import encoding as jenc
from nerf_tpu.data.poses import pose_spherical
from nerf_tpu_torch import ops as tops

torch.set_num_threads(1)
TOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("num_fns,include_input,log_sampling", [
    (10, True, True), (4, True, True), (6, False, True), (4, True, False), (0, True, True),
])
def test_positional_encoding(num_fns, include_input, log_sampling):
    x = np.random.default_rng(0).uniform(-1.5, 1.5, (7, 5, 3)).astype(np.float32)
    want = jops.positional_encoding(jnp.asarray(x), num_fns, include_input, log_sampling)
    got = tops.positional_encoding(_t(x), num_fns, include_input, log_sampling)
    assert got.shape == want.shape == (7, 5, tops.encoding_dim(3, num_fns, include_input))
    _close(got, want)
    _close(tops.frequency_bands(num_fns, log_sampling),
           jops.frequency_bands(num_fns, log_sampling))


def test_coarse_to_fine_window():
    for alpha in (0.0, 2.5, 10.0):
        _close(tops.coarse_to_fine_window(10, alpha), jenc.coarse_to_fine_window(10, alpha))


def test_math():
    rng = np.random.default_rng(1)
    a, b = rng.random((6, 9)).astype(np.float32), rng.random((6, 9)).astype(np.float32)
    _close(tops.img2mse(_t(a), _t(b)), jops.img2mse(jnp.asarray(a), jnp.asarray(b)))
    _close(tops.mse2psnr(torch.tensor(0.01)), jops.mse2psnr(0.01))
    _close(tops.mse2psnr(torch.tensor(0.0)), jops.mse2psnr(0.0))
    _close(tops.cumprod_exclusive(_t(a)), jops.cumprod_exclusive(jnp.asarray(a)))


def test_get_ray_bundle():
    pose = pose_spherical(37.0, -30.0, 4.0)[:3, :4]
    ro_j, rd_j = jops.get_ray_bundle(12, 10, 13.7, jnp.asarray(pose))
    ro_t, rd_t = tops.get_ray_bundle(12, 10, 13.7, _t(pose))
    assert ro_t.shape == rd_t.shape == (12, 10, 3)
    _close(ro_t, ro_j)
    _close(rd_t, rd_j)
    ii, jj = tops.meshgrid_xy(torch.arange(4.0), torch.arange(3.0))
    ii_j, jj_j = jops.meshgrid_xy(jnp.arange(4.0), jnp.arange(3.0))
    _close(ii, ii_j)
    _close(jj, jj_j)


def test_ndc_rays():
    rng = np.random.default_rng(2)
    ro = rng.uniform(-0.3, 0.3, (32, 3)).astype(np.float32)
    rd = rng.normal(size=(32, 3)).astype(np.float32)
    rd[:, 2] = -np.abs(rd[:, 2]) - 0.5
    want = jops.ndc_rays(24, 32, 30.0, 1.0, jnp.asarray(ro), jnp.asarray(rd))
    got = tops.ndc_rays(24, 32, 30.0, 1.0, _t(ro), _t(rd))
    for g, w in zip(got, want):
        _close(g, w)


def test_ray_aabb_interval():
    rng = np.random.default_rng(3)
    ro = rng.uniform(-4, 4, (64, 3)).astype(np.float32)
    rd = rng.normal(size=(64, 3)).astype(np.float32)
    rd[:4, 1] = 0.0                       # slab-parallel rays
    box = ((-1.0, -0.8, -1.2), (1.1, 0.9, 1.0))
    want = jops.ray_aabb_interval(jnp.asarray(ro), jnp.asarray(rd), box[0], box[1], 2.0, 6.0)
    got = tops.ray_aabb_interval(_t(ro), _t(rd), box[0], box[1], 2.0, 6.0)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("lindisp", [False, True])
def test_coarse_z_values(lindisp):
    near = np.random.default_rng(4).uniform(1.5, 2.5, (9,)).astype(np.float32)
    want = jops.coarse_z_values(jnp.asarray(near), 6.0, 16, lindisp)
    got = tops.coarse_z_values(_t(near), 6.0, 16, lindisp)
    assert got.shape == (9, 16)
    _close(got, want)


def test_perturb_z_values_stays_in_bins():
    z = tops.coarse_z_values(torch.full((50,), 2.0), 6.0, 32)
    got = tops.perturb_z_values(z, torch.Generator().manual_seed(0))
    mids = 0.5 * (z[..., 1:] + z[..., :-1])
    lower = torch.cat([z[..., :1], mids], -1)
    upper = torch.cat([mids, z[..., -1:]], -1)
    assert bool(((got >= lower) & (got <= upper)).all())
    again = tops.perturb_z_values(z, torch.Generator().manual_seed(0))
    assert torch.equal(got, again)


def _pdf_inputs(seed):
    rng = np.random.default_rng(seed)
    bins = np.sort(rng.uniform(2.0, 6.0, (40, 17)), axis=-1).astype(np.float32)
    weights = rng.random((40, 16)).astype(np.float32)
    weights[:5] = 0.0                     # empty rays: the 1e-5 floor decides
    # Mass in the last bins only: the denom < 1e-5 guard fires over the empty
    # bins. (Empty last bins would make u = 1 a tie with cdf[-1] = 1, where
    # the result jumps a bin on the last bit of the cumsum.)
    weights[5:10, :-3] = 0.0
    return bins, weights


def test_sample_pdf_det():
    bins, weights = _pdf_inputs(5)
    want = jops.sample_pdf(jnp.asarray(bins), jnp.asarray(weights), 24, det=True)
    got = tops.sample_pdf(_t(bins), _t(weights), 24, det=True)
    assert got.shape == (40, 24)
    _close(got, want)


def test_sample_pdf_random_uses_the_same_uniforms():
    bins, weights = _pdf_inputs(6)
    key = jax.random.PRNGKey(7)
    want = jops.sample_pdf(jnp.asarray(bins), jnp.asarray(weights), 24, key=key, det=False)
    u = jax.random.uniform(key, (40, 24), dtype=jnp.float32)   # sampling.py:111's call
    got = tops.sample_pdf(_t(bins), _t(weights), 24, det=False, u=_t(u))
    _close(got, want)
    drawn = tops.sample_pdf(_t(bins), _t(weights), 24, generator=torch.Generator().manual_seed(0))
    assert bool(((drawn >= _t(bins[:, :1])) & (drawn <= _t(bins[:, -1:]))).all())


def _volume_inputs(seed):
    rng = np.random.default_rng(seed)
    rf = rng.normal(size=(10, 12, 4)).astype(np.float32) * 2.0
    z = np.sort(rng.uniform(2.0, 6.0, (10, 12)), axis=-1).astype(np.float32)
    rd = rng.normal(size=(10, 3)).astype(np.float32)
    return rf, z, rd


@pytest.mark.parametrize("white_background", [False, True])
def test_volume_render(white_background):
    rf, z, rd = _volume_inputs(8)
    rf[0, :, 3] = -5.0                    # an empty ray: guarded disparity
    want = jops.volume_render_radiance_field(
        jnp.asarray(rf), jnp.asarray(z), jnp.asarray(rd), white_background=white_background)
    got = tops.volume_render_radiance_field(
        _t(rf), _t(z), _t(rd), white_background=white_background)
    for name in tops.RenderOutputs._fields:
        _close(getattr(got, name), getattr(want, name))
    assert np.isfinite(got.disp.numpy()).all()


def test_volume_render_final_dists():
    rf, z, rd = _volume_inputs(9)
    final = np.random.default_rng(10).uniform(0.01, 0.3, (10,)).astype(np.float32)
    want = jops.volume_render_radiance_field(
        jnp.asarray(rf), jnp.asarray(z), jnp.asarray(rd), white_background=True,
        final_dists=jnp.asarray(final))
    got = tops.volume_render_radiance_field(
        _t(rf), _t(z), _t(rd), white_background=True, final_dists=_t(final))
    for name in tops.RenderOutputs._fields:
        _close(getattr(got, name), getattr(want, name))


def test_volume_render_noise_draws_from_the_generator():
    rf, z, rd = _volume_inputs(11)
    outs = [tops.volume_render_radiance_field(
        _t(rf), _t(z), _t(rd), radiance_field_noise_std=1.0,
        generator=torch.Generator().manual_seed(3)).rgb for _ in range(2)]
    assert torch.equal(outs[0], outs[1])
    clean = tops.volume_render_radiance_field(_t(rf), _t(z), _t(rd)).rgb
    assert not torch.equal(outs[0], clean)
