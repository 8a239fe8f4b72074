"""``python -m nerf_tpu_torch.eval_nerf --split test --gif`` on a blender
fixture, and the stdlib GIF writer (``nerf_tpu_torch/utils/gif.py``).

The CLI renders the test split's poses (the JAX loader's, bitwise), reports
each frame's PSNR against the split's images composited onto white (as the
JAX loader and compositing give them), and writes the GIF that the JAX CLI
writes with ``imageio.mimwrite(..., duration=0.05, loop=0)``: read back by
imageio, its frame count, 50 ms duration and loop 0 match, and each frame
reads back at 30 dB or more against the PNG it was made from (a per-frame
256-colour palette: the CLI's 12x12 frames have fewer colours and read back
exactly; smooth 64x80 gradients measured 32.8 and 33.1 dB). Frames of at
most 256 colours, and LZW streams long enough to fill the 4096-code table
several times over, read back exactly.
"""

import io
import os

import imageio.v2 as imageio
import imageio.v3 as iio
import numpy as np
import pytest
import torch

from nerf_tpu.data import composite_white_background as jax_composite
from nerf_tpu.data import load_blender_data as jax_load_blender
from nerf_tpu_torch import eval_nerf
from nerf_tpu_torch.engine.checkpoint import convert_torch_state_dict, save_checkpoint
from nerf_tpu_torch.models import FlexibleNeRFModel
from nerf_tpu_torch.utils.gif import gif_bytes, gif_frame_count, lzw_encode, write_gif
from tests.test_torch_llff_blender import write_blender

torch.set_num_threads(1)
GIF_PSNR_FLOOR_DB = 30.0

TINY_YAML = """
dataset:
  type: blender
  basedir: {basedir}
  half_res: True
  testskip: 1
  no_ndc: True
  near: 2
  far: 6
models:
  coarse:
    type: FlexibleNeRFModel
    num_encoding_fn_xyz: 10
    num_encoding_fn_dir: 4
  fine:
    type: FlexibleNeRFModel
    num_encoding_fn_xyz: 10
    num_encoding_fn_dir: 4
nerf:
  validation:
    chunksize: 64
    num_coarse: 8
    num_fine: 8
    white_background: True
"""


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    d = tmp_path_factory.mktemp("eval_split")
    basedir = write_blender(d / "scene", size=24,
                            counts=(("train", 2), ("val", 1), ("test", 3)), seed=4)
    cfg = d / "cfg.yml"
    cfg.write_text(TINY_YAML.format(basedir=basedir))
    ckpt = str(d / "seeded.ntc")
    models = []
    for i in range(2):
        m = FlexibleNeRFModel(num_encoding_fn_xyz=10, num_encoding_fn_dir=4,
                              generator=torch.Generator().manual_seed(i))
        with torch.no_grad():          # an opaque field, so frames are not flat white
            for p in m.parameters():
                p.mul_(3.0)
            m.fc_alpha.bias.add_(2.0)
        models.append(convert_torch_state_dict(m.state_dict()))
    save_checkpoint(ckpt, {"step": 0, "params_coarse": models[0], "params_fine": models[1]})
    return str(cfg), ckpt, basedir, d


def test_eval_split_test_with_gif(scene, tmp_path):
    cfg, ckpt, basedir, _ = scene
    gif = str(tmp_path / "out.gif")
    result = eval_nerf.main(["--config", cfg, "--checkpoint", ckpt, "--savedir",
                             str(tmp_path / "frames"), "--split", "test", "--gif", gif,
                             "--device", "cpu", "--renderer", "plain"])
    assert (result.height, result.width) == (12, 12) and all(result.finite)
    assert sorted(os.listdir(tmp_path / "frames")) == ["0000.png", "0001.png", "0002.png"]

    imgs, _, _, _, i_split = jax_load_blender(basedir, half_res=True)
    truth = jax_composite(imgs[i_split[2]])
    rgb = result.first_maps["rgb_fine"].double().numpy()
    want = -10 * np.log10(((rgb - truth[0]) ** 2).mean())
    assert len(result.psnrs) == 3
    np.testing.assert_allclose(result.psnrs[0], want, rtol=1e-6)

    data = open(gif, "rb").read()
    assert gif_frame_count(data) == 3
    meta = iio.immeta(gif)
    assert meta["loop"] == 0 and meta["duration"] == 50
    frames = imageio.mimread(gif)
    assert len(frames) == 3
    for i, frame in enumerate(frames):
        png = imageio.imread(tmp_path / "frames" / f"{i:04d}.png")
        mse = ((frame[..., :3].astype(float) - png) ** 2).mean()
        assert mse == 0 or 10 * np.log10(255 ** 2 / mse) >= GIF_PSNR_FLOOR_DB


def test_split_without_a_dataset_raises(scene, tmp_path):
    cfg, ckpt, _, _ = scene
    with pytest.raises(ValueError, match="on-disk dataset"):
        eval_nerf.main(["--config", cfg, "--checkpoint", ckpt, "--split", "val",
                        "--savedir", str(tmp_path), "--device", "cpu",
                        "--overrides", "dataset.basedir", str(tmp_path / "none")])


def _smooth(h, w, phase):
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    f = np.stack([np.sin(6 * xx + phase) * 0.5 + 0.5, yy, np.cos(5 * yy * xx) * 0.5 + 0.5], -1)
    return (f * 255).astype(np.uint8)


def test_gif_reads_back_through_imageio(tmp_path):
    rng = np.random.default_rng(0)
    palette = rng.integers(0, 256, (256, 3)).astype(np.uint8)
    exact = [palette[rng.integers(0, 256, (90, 130))] for _ in range(3)]
    data = gif_bytes(exact)
    back = imageio.mimread(io.BytesIO(data))
    assert len(back) == 3 and gif_frame_count(data) == 3
    for got, want in zip(back, exact):
        np.testing.assert_array_equal(got[..., :3], want)

    smooth = [_smooth(64, 80, p) for p in (0.0, 1.0)]
    path = str(tmp_path / "smooth.gif")
    write_gif(path, smooth)
    ours = iio.immeta(path)
    imageio.mimwrite(str(tmp_path / "theirs.gif"), smooth, duration=0.05, loop=0)
    theirs = imageio.mimread(str(tmp_path / "theirs.gif"))
    assert ours["loop"] == iio.immeta(str(tmp_path / "theirs.gif"))["loop"] == 0
    assert ours["duration"] == 50 and len(theirs) == 2
    for got, want in zip(imageio.mimread(path), smooth):
        mse = ((got[..., :3].astype(float) - want) ** 2).mean()
        assert 10 * np.log10(255 ** 2 / mse) >= GIF_PSNR_FLOOR_DB


@pytest.mark.parametrize("shape", [(1, 1), (1, 2), (1, 255), (50, 100), (280, 250)])
def test_lzw_codes_decode(shape):
    """Frames of random indices (many new codes: the table fills and clears
    past 4096) and of one index (long runs), decoded by imageio."""
    rng = np.random.default_rng(shape[0] * shape[1])
    for idx in (rng.integers(0, 256, shape), np.full(shape, 7)):
        frame = np.repeat(idx[..., None], 3, axis=-1).astype(np.uint8)
        got = imageio.mimread(io.BytesIO(gif_bytes([frame])))[0]
        if got.ndim == 2:                        # Pillow reads a grey palette as "L"
            got = np.repeat(got[..., None], 3, axis=-1)
        np.testing.assert_array_equal(got[..., :3], frame)
    assert lzw_encode(b"")[:1] == bytes([0])     # a clear code, then the end code
