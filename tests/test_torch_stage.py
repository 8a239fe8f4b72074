"""The whole-render-stage kernel's wrapper of nerf_tpu_torch against the JAX
kernel, and the slice as a whole: a coarse stage, resampling and a fine
stage, each through the three kernel functions of both packages.

On the CPU ``fused_render_stage`` runs its plain version (``mlp_t_plain``
then ``volume_render_plain``); here it is held against
``nerf_tpu.ops.pallas.stage.fused_render_stage`` in Pallas interpret mode on
the same weights (``load_jax_params``) and numpy inputs, at float32 to the
JAX package's own tolerances for that kernel (tests/test_pallas_stage.py):
rtol 1e-4, atol 1e-5, depth 1e-3. The JAX kernel takes the transmittance in
log space through a triangular matmul, the port as a product.

JAX's CPU backend has no bf16 x bf16 -> f32 dot, so the interpret-mode
kernel cannot run in bfloat16 here; the bfloat16 case is held against the
JAX package's bf16 evaluator (``model.apply`` on a bf16 encoding) composited
by its XLA volume renderer, to 2e-2, as tests/test_torch_mlp_t.py does for
the field alone.

The bf16 kernel runs #1's tensor-core tile and #5's scan, so on the card its
maps are bitwise those of ``fused_volume_render`` on ``fused_mlp_t``'s bf16
field; here the plain versions are held to that same identity.

The kernel itself runs only on the card: tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.engine.renderer import RenderSettings, encode_points
from nerf_tpu.models import FlexibleNeRFModel as JaxFlexible
from nerf_tpu.ops import volume_render_radiance_field as jax_volume_render
from nerf_tpu.ops.pallas.resample import fused_sample_pdf as jax_fused_sample_pdf
from nerf_tpu.ops.pallas.stage import fused_render_stage as jax_fused_render_stage
from nerf_tpu_torch.engine.checkpoint import load_jax_params
from nerf_tpu_torch.kernels import fused_render_stage, fused_sample_pdf, render_stage_plain
from nerf_tpu_torch.kernels.composite import volume_render_plain
from nerf_tpu_torch.kernels.mlp_t import mlp_t_plain
from nerf_tpu_torch.models import FlexibleNeRFModel
from nerf_tpu_torch.ops import coarse_z_values

torch.set_num_threads(1)

# (rtol, atol) per map, as tests/test_pallas_stage.py holds the JAX kernel.
TOLS = {"rgb": (1e-4, 1e-5), "weights": (1e-4, 1e-5), "acc": (1e-4, 1e-5),
        "depth": (1e-3, 1e-3)}


def _pair(seed):
    params = JaxFlexible(num_encoding_fn_xyz=10, num_encoding_fn_dir=4).init(
        jax.random.PRNGKey(seed))
    return params, load_jax_params(
        FlexibleNeRFModel(num_encoding_fn_xyz=10, num_encoding_fn_dir=4), params)


@pytest.fixture(scope="module")
def flagship():
    return _pair(0)


def _rays(r, seed):
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-1, 1, (r, 3)).astype(np.float32)
    rd = (rng.uniform(-1, 1, (r, 3)) - [0, 0, 1.5]).astype(np.float32)
    return ro, rd, rd / np.linalg.norm(rd, axis=-1, keepdims=True)


def _inputs(r, s, seed):
    ro, rd, vd = _rays(r, seed)
    z = np.sort(np.random.default_rng(seed + 1).uniform(2, 6, (r, s)).astype(np.float32), -1)
    pts = (ro[:, None, :] + rd[:, None, :] * z[..., None]).astype(np.float32)
    return pts, vd, z, rd


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("white_background", [True, False])
@pytest.mark.parametrize("r,s", [(20, 8), (20, 16)])
def test_cpu_path_matches_the_jax_kernel(flagship, r, s, white_background):
    params, tmodel = flagship
    pts, vd, z, rd = _inputs(r, s, seed=r * s)
    want = jax_fused_render_stage(params, *map(jnp.asarray, (pts, vd, z, rd)),
                                  white_background=white_background, rays_per_tile=16,
                                  interpret=True)
    before = fused_render_stage.launches
    with torch.no_grad():
        got = fused_render_stage(tmodel, *_torch(pts, vd, z, rd), white_background)
    assert fused_render_stage.launches == before   # the CPU never launches the kernel
    for name, (rtol, atol) in TOLS.items():
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=rtol,
                                   atol=atol, err_msg=name)
    np.testing.assert_allclose(got["disp"].numpy(), np.asarray(want["disp"]), rtol=1e-3)


def test_bf16_matches_the_jax_bf16_path(flagship):
    params, tmodel = flagship
    pts, vd, z, rd = _inputs(12, 16, seed=5)
    settings = RenderSettings(num_encoding_fn_xyz=10, num_encoding_fn_dir=4)
    enc = encode_points(jnp.asarray(pts), jnp.asarray(vd), settings).astype(jnp.bfloat16)
    rf = JaxFlexible(num_encoding_fn_xyz=10, num_encoding_fn_dir=4).apply(params, enc)
    want = jax_volume_render(rf.astype(jnp.float32), jnp.asarray(z), jnp.asarray(rd),
                             white_background=True)
    with torch.no_grad():
        got = fused_render_stage(tmodel, *_torch(pts, vd, z, rd), True, "bfloat16")
    for name in ("rgb", "weights", "acc"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(getattr(want, name)),
                                   atol=2e-2, err_msg=name)


def test_opaque_samples_stay_finite():
    """alpha == 1 at every sample (fc_alpha's bias + 100): finite maps and the
    first sample takes (nearly) everything, in both packages."""
    params, tmodel = _pair(0)
    params["fc_alpha"]["bias"] = params["fc_alpha"]["bias"] + 100.0
    with torch.no_grad():
        tmodel.fc_alpha.bias.add_(100.0)
    r, s = 16, 8
    rd = np.tile(np.array([0.0, 0.0, -1.0], np.float32), (r, 1))
    z = np.broadcast_to(np.linspace(2.0, 6.0, s, dtype=np.float32), (r, s))
    pts = rd[:, None, :] * z[..., None]
    want = jax_fused_render_stage(params, *map(jnp.asarray, (pts, rd, z, rd)),
                                  rays_per_tile=16, interpret=True)
    with torch.no_grad():
        got = fused_render_stage(tmodel, *_torch(pts, rd, z, rd))
    for out in (got, {k: torch.from_numpy(np.array(v)) for k, v in want.items()}):
        assert all(bool(torch.isfinite(v).all()) for v in out.values())
        assert float(out["weights"][:, 0].min()) > 0.99
    np.testing.assert_allclose(got["rgb"].numpy(), np.asarray(want["rgb"]), atol=1e-5)


def test_plain_is_the_field_then_compositing(flagship):
    _, tmodel = flagship
    pts, vd, z, rd = _torch(*_inputs(6, 16, seed=3))
    with torch.no_grad():
        got = fused_render_stage(tmodel, pts, vd, z, rd, True)
        want = render_stage_plain(tmodel, pts, vd, z, rd, True)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_the_slice_chain_matches_the_jax_chain():
    """The slice as a whole on 24 rays at full width (4x128, 64 coarse + 64
    fine samples, white background): a coarse stage, det resampling of the
    coarse weights' inner bins, a sort, and a fine stage, in both packages
    through their kernel functions. The fine depths and colours agree."""
    (pc, mc), (pf, mf) = _pair(0), _pair(1)
    ro, rd, vd = _rays(24, seed=11)
    z = coarse_z_values(2.0, 6.0, 64).expand(24, 64).numpy()
    pts = ro[:, None, :] + rd[:, None, :] * z[..., None]

    def jax_chain():
        j = dict(interpret=True, rays_per_tile=16)
        coarse = jax_fused_render_stage(pc, *map(jnp.asarray, (pts, vd, z, rd)),
                                        white_background=True, **j)
        z_mid = 0.5 * (z[:, 1:] + z[:, :-1])
        z_s = jax_fused_sample_pdf(jnp.asarray(z_mid), coarse["weights"][:, 1:-1], 64, det=True,
                                   interpret=True)
        z_all = jnp.sort(jnp.concatenate([jnp.asarray(z), z_s], -1), -1)
        fine_pts = ro[:, None, :] + rd[:, None, :] * z_all[..., None]
        fine = jax_fused_render_stage(pf, fine_pts, jnp.asarray(vd), z_all, jnp.asarray(rd),
                                      white_background=True, **j)
        return np.asarray(z_all), {k: np.asarray(v) for k, v in fine.items()}

    def port_chain():
        ro_t, rd_t, vd_t, z_t = _torch(ro, rd, vd, z)
        coarse = fused_render_stage(mc, *_torch(pts), vd_t, z_t, rd_t, True)
        z_mid = 0.5 * (z_t[:, 1:] + z_t[:, :-1])
        z_s = fused_sample_pdf(z_mid, coarse["weights"][:, 1:-1], 64, det=True)
        z_all, _ = torch.sort(torch.cat([z_t, z_s], -1), -1)
        fine_pts = ro_t[:, None, :] + rd_t[:, None, :] * z_all[..., None]
        return z_all, fused_render_stage(mf, fine_pts, vd_t, z_all, rd_t, True)

    want_z, want = jax_chain()
    with torch.no_grad():
        got_z, got = port_chain()
    np.testing.assert_allclose(got_z.numpy(), want_z, atol=2e-4)
    np.testing.assert_allclose(got["rgb"].numpy(), want["rgb"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["acc"].numpy(), want["acc"], rtol=1e-4, atol=1e-4)


def test_wrapper_raises_instead_of_falling_back(flagship):
    _, tmodel = flagship
    pts, vd, z, rd = _torch(*_inputs(2, 8, seed=4))
    narrow = FlexibleNeRFModel(num_layers=2, hidden_size=32, num_encoding_fn_xyz=4,
                               num_encoding_fn_dir=2)
    with pytest.raises(ValueError, match="4x128"):
        fused_render_stage(narrow, pts, vd, z, rd)
    six = FlexibleNeRFModel(num_encoding_fn_xyz=6, num_encoding_fn_dir=4)
    with pytest.raises(ValueError, match="4x128 10/4"):
        fused_render_stage(six, pts, vd, z, rd)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fused_render_stage(tmodel, pts.to("meta"), vd.to("meta"), z.to("meta"), rd.to("meta"))
    with pytest.raises(ValueError, match="compute_dtype"):
        fused_render_stage(tmodel, pts, vd, z, rd, compute_dtype="float16")


@pytest.mark.parametrize("white_background", [False, True])
@pytest.mark.parametrize("r,s", [(1, 1), (9, 64), (5, 61)])
def test_bf16_plain_stage_is_the_bf16_field_composited(flagship, r, s, white_background):
    _, tmodel = flagship
    pts, vd, z, rd = (torch.from_numpy(a) for a in _inputs(r, s, seed=r + s))
    with torch.no_grad():
        got = render_stage_plain(tmodel, pts, vd, z, rd, white_background, "bfloat16")
        want = volume_render_plain(mlp_t_plain(tmodel, pts, vd, "bfloat16"), z, rd,
                                   white_background)
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
