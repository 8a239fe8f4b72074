"""The compositing kernel's wrapper of nerf_tpu_torch against the JAX kernel.

On the CPU ``fused_volume_render`` runs its plain version (the deterministic
branch of ``ops/volume.volume_render_radiance_field``); here it is held
against ``nerf_tpu.ops.pallas.composite.fused_volume_render`` in Pallas
interpret mode on the same numpy inputs, to the JAX package's own tolerances
for that kernel (tests/test_pallas_composite.py): the two take the
transmittance product in another order.

The kernel itself runs only on the card: tests/test_torch_cuda.py.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.ops.pallas.composite import fused_volume_render as jax_fused_volume_render
from nerf_tpu_torch.kernels.composite import MAP_NAMES, fused_volume_render, volume_render_plain
from nerf_tpu_torch.ops import volume_render_radiance_field

torch.set_num_threads(1)

# (rtol, atol) per map, as tests/test_pallas_composite.py holds the JAX kernel.
TOLS = {"rgb": (1e-5, 1e-6), "weights": (1e-5, 1e-6), "acc": (1e-5, 1e-6),
        "depth": (1e-4, 1e-4), "disp": (1e-3, 1e-4)}


def _inputs(n, s, seed):
    rng = np.random.default_rng(seed)
    rf = rng.standard_normal((n, s, 4)).astype(np.float32) * 2
    z = np.sort(rng.uniform(2, 6, (n, s)).astype(np.float32), -1)
    rd = rng.standard_normal((n, 3)).astype(np.float32)
    return rf, z, rd


def _jax(rf, z, rd, white_background):
    out = jax_fused_volume_render(jnp.asarray(rf), jnp.asarray(z), jnp.asarray(rd),
                                  white_background=white_background, rays_per_tile=32,
                                  interpret=True)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("white_background", [False, True])
@pytest.mark.parametrize("n,s,seed", [(70, 16, 0), (33, 5, 1)])
def test_cpu_path_matches_the_jax_kernel(n, s, seed, white_background):
    rf, z, rd = _inputs(n, s, seed)
    rf[3, :, 3] = 1e8       # one ray with alpha = 1 at every sample
    want = _jax(rf, z, rd, white_background)
    before = fused_volume_render.launches
    got = fused_volume_render(torch.from_numpy(rf), torch.from_numpy(z), torch.from_numpy(rd),
                              white_background)
    assert fused_volume_render.launches == before   # the CPU never launches the kernel
    assert set(got) == set(MAP_NAMES) == set(want)
    for name, (rtol, atol) in TOLS.items():
        assert got[name].dtype == torch.float32 and got[name].shape == want[name].shape
        np.testing.assert_allclose(got[name].numpy(), want[name], rtol=rtol, atol=atol,
                                   err_msg=name)
    # The opaque ray: the first sample takes everything, nothing is NaN.
    assert float(got["weights"][3, 0]) == 1.0 and float(got["acc"][3]) == 1.0
    assert all(bool(torch.isfinite(v).all()) for v in got.values())


def test_plain_is_the_deterministic_volume_render():
    rf, z, rd = (torch.from_numpy(a) for a in _inputs(9, 12, 2))
    ref = volume_render_radiance_field(rf, z, rd, radiance_field_noise_std=0.0,
                                       white_background=True)
    got = volume_render_plain(rf, z, rd, white_background=True)
    for name in MAP_NAMES:
        assert torch.equal(got[name], getattr(ref, name)), name


def test_empty_rays_get_a_finite_disparity():
    """A ray with sigma <= 0 everywhere: acc 0, disp 1e10 (the guard), as in
    the JAX kernel; white background gives white."""
    rf, z, rd = _inputs(4, 8, 3)
    rf[:, :, 3] = -5.0
    want = _jax(rf, z, rd, True)
    got = fused_volume_render(*(torch.from_numpy(a) for a in (rf, z, rd)), True)
    np.testing.assert_allclose(got["disp"].numpy(), want["disp"], rtol=1e-6)
    assert float(got["acc"].abs().max()) == 0.0 and bool((got["rgb"] == 1.0).all())


def test_wrapper_raises_instead_of_falling_back():
    rf, z, rd = (torch.from_numpy(a) for a in _inputs(2, 8, 4))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fused_volume_render(rf.to("meta"), z.to("meta"), rd.to("meta"))


def test_kernels_import_without_nvcc():
    """Importing the kernels package builds nothing: with no nvcc on PATH and
    none at the toolkit's default place, the import and every CPU path run."""
    code = (
        "import torch\n"
        "from nerf_tpu_torch.kernels import _build\n"
        "_build.NVCC_FALLBACK = '/nonexistent/nvcc'\n"
        "import nerf_tpu_torch.kernels as k\n"
        "rf = torch.zeros(2, 4, 4); z = torch.linspace(2, 6, 4).expand(2, 4)\n"
        "out = k.fused_volume_render(rf, z, torch.ones(2, 3))\n"
        "k.fused_sample_pdf(z, out['weights'][:, :3], 5, det=True)\n"
        "try:\n"
        "    _build.find_nvcc()\n"
        "except RuntimeError:\n"
        "    print('no nvcc')\n"
    )
    env = dict(os.environ, PATH="")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=os.path.dirname(os.path.dirname(__file__)), timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "no nvcc"
