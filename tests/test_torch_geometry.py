"""nerf_tpu_torch.engine.geometry and the ``--tighten-aabb`` / geometry CLIs
against the JAX package.

The same weights (JAX ``init`` carried by ``load_jax_params``) and the same
grids go through both packages:
- the sigma sweep of a Flexible and a Paper field at R = 12, f32, to 1e-5;
- ``density_aabb`` on an analytic blob whose grid holds no value within a
  margin of tau, equal to the JAX box, with its warning and its fallback;
- ``marching_tetrahedra`` on the same numpy grid (vertices and faces equal),
  and the sphere / exact-iso cases of ``tests/test_geometry.py``;
- the vertex colour (1e-5) and normal (1e-4) queries, and the PLY bytes;
- ``train_nerf`` / ``eval_nerf --tighten-aabb`` and ``extract_geometry`` on
  ``--device cpu`` against the JAX CLIs (run in this process) and the JAX
  library on one checkpoint.

The CLI field is an octahedral density ``c - |x|_1`` built into a narrow
Flexible model's weights, so its boxes and isosurfaces are known, and no
grid vertex lies near the threshold or the iso.
"""

import collections
import dataclasses
import importlib
import os
import sys
import warnings

import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.config import load_config as jax_load_config
from nerf_tpu.config import render_settings_from_config as jax_settings_from_config
from nerf_tpu.engine import geometry as jgeo
from nerf_tpu.engine.checkpoint import save_checkpoint as jax_save_checkpoint
from nerf_tpu.engine.renderer import RenderSettings as JaxSettings
from nerf_tpu.engine.renderer import make_pose_render_fn as jax_pose_render_fn
from nerf_tpu.models import FlexibleNeRFModel as JaxFlexible
from nerf_tpu.models import PaperNeRFModel as JaxPaper
from nerf_tpu_torch import eval_nerf, extract_geometry, train_nerf
from nerf_tpu_torch.config import load_config
from nerf_tpu_torch.data import resolve_render_poses
from nerf_tpu_torch.engine import geometry as tgeo
from nerf_tpu_torch.engine.checkpoint import load_jax_params
from nerf_tpu_torch.engine.renderer import RenderSettings
from nerf_tpu_torch.models import FlexibleNeRFModel, PaperNeRFModel

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NARROW = dict(num_layers=2, hidden_size=32, num_encoding_fn_xyz=4, num_encoding_fn_dir=2)
ENC = dict(num_encoding_fn_xyz=4, num_encoding_fn_dir=2)


def _pair(kind="flexible", seed=0):
    if kind == "paper":
        kw = dict(num_encoding_fn_xyz=4, num_encoding_fn_dir=2)
        jmodel, tmodel = JaxPaper(**kw), PaperNeRFModel(**kw)
    else:
        jmodel, tmodel = JaxFlexible(**NARROW), FlexibleNeRFModel(**NARROW)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(seed)))
    params["fc_alpha"]["bias"] = params["fc_alpha"]["bias"] + 2.0   # a field with a surface
    return jmodel, params, load_jax_params(tmodel, params)


def _settings(**kw):
    return JaxSettings(**ENC, **kw), RenderSettings(**ENC, **kw)


@pytest.mark.parametrize("kind", ["flexible", "paper"])
def test_sigma_grid_matches_jax(kind):
    jmodel, params, tmodel = _pair(kind)
    js, ts = _settings()
    box = ((-1.0, -0.8, -1.2), (1.1, 0.9, 1.0))
    want = np.asarray(jgeo.make_sigma_grid_fn(jmodel, js, 12, *box, chunk=500)(params))
    got = tgeo.make_sigma_grid_fn(tmodel, ts, 12, *box, chunk=500)()
    assert got.shape == (12, 12, 12) and got.dtype == np.float32
    assert want.max() > 1.0                    # a field with something in it
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# density_aabb on an analytic blob
# ---------------------------------------------------------------------------


class _TorchBlob(torch.nn.Module):
    """sigma = peak * relu(1 - |x - c|^2 / r^2)^2, constant colour (the
    ``_BlobModel`` of ``tests/test_aabb.py``): the encoding's first three
    features are the raw coordinates."""

    use_viewdirs = False
    dim_dir = 0

    def __init__(self, center=(0.0, 0.0, 0.0), r=0.5, sigma_peak=4.0):
        super().__init__()
        self.register_buffer("center", torch.tensor(center, dtype=torch.float32))
        self.dummy = torch.nn.Parameter(torch.zeros(()))
        self.r, self.sigma_peak = r, sigma_peak

    def forward(self, enc):
        d2 = ((enc[..., :3] - self.center) ** 2).sum(-1)
        sigma = self.sigma_peak * torch.relu(1.0 - d2 / self.r ** 2) ** 2
        return torch.cat([torch.full(enc.shape[:-1] + (3,), 2.0), sigma[..., None]], dim=-1)


class _JaxBlob:
    use_viewdirs = False
    dim_dir = 0

    def __init__(self, center=(0.0, 0.0, 0.0), r=0.5, sigma_peak=4.0):
        self.center, self.r, self.sigma_peak = jnp.asarray(center), r, sigma_peak

    def apply(self, params, enc):
        d2 = jnp.sum((enc[..., :3] - self.center) ** 2, axis=-1)
        sigma = self.sigma_peak * jax.nn.relu(1.0 - d2 / self.r ** 2) ** 2
        return jnp.concatenate([jnp.full(enc.shape[:-1] + (3,), 2.0), sigma[..., None]], -1)


BLOB_SETTINGS = dict(num_coarse=8, num_fine=0, use_viewdirs=False, num_encoding_fn_xyz=4,
                     num_encoding_fn_dir=0, include_input_dir=False)


def _blob_boxes(center, r, res, tau, sweep=((-1.5,) * 3, (1.5,) * 3)):
    js, ts = JaxSettings(**BLOB_SETTINGS), RenderSettings(**BLOB_SETTINGS)
    tmodel = _TorchBlob(center, r)
    grid = tgeo.make_sigma_grid_fn(tmodel, ts, res, *sweep)()
    want = jgeo.density_aabb(_JaxBlob(center, r), {}, js, resolution=res, bbox_min=sweep[0],
                             bbox_max=sweep[1], tau=tau)
    got = tgeo.density_aabb(tmodel, ts, resolution=res, bbox_min=sweep[0], bbox_max=sweep[1],
                            tau=tau)
    return grid, got, want


def test_density_aabb_matches_jax_on_a_blob():
    grid, got, want = _blob_boxes((0.2, -0.1, 0.0), 0.3, 33, tau=0.2)
    # No grid value within 1e-2 of tau: f32 differences cannot move the box.
    assert np.abs(grid - 0.2).min() > 1e-2
    assert got == want
    lo, hi = np.array(got[:3]), np.array(got[3:])
    center = np.array([0.2, -0.1, 0.0])
    assert np.all(lo < center - 0.2) and np.all(hi > center + 0.2)
    assert np.all(lo > -1.2) and np.all(hi < 1.2)


def test_density_aabb_warns_naming_the_faces_it_touches():
    with pytest.warns(UserWarning, match=r"touches the sweep bounds on face\(s\) x\+ —"):
        _, got, want = _blob_boxes((1.5, 0.0, 0.0), 0.4, 17, tau=0.1)
    assert got == want and got[3] == 1.5
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _blob_boxes((0.0, 0.0, 0.0), 0.3, 17, tau=0.1)


def test_density_aabb_empty_field_falls_back_to_sweep_bounds():
    ts = RenderSettings(**BLOB_SETTINGS)
    box = tgeo.density_aabb(_TorchBlob(sigma_peak=0.0), ts, resolution=9,
                            bbox_min=(-1.0,) * 3, bbox_max=(1.0,) * 3, tau=1.0)
    assert box == (-1.0,) * 3 + (1.0,) * 3


# ---------------------------------------------------------------------------
# Marching tetrahedra
# ---------------------------------------------------------------------------


def _sphere_values(r=0.62, res=25, lim=1.0):
    ax = np.linspace(-lim, lim, res)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    return r - np.sqrt(x * x + y * y + z * z), (-lim,) * 3, (2 * lim / (res - 1),) * 3


def _directed_edges(faces):
    directed = collections.Counter()
    for tri in faces:
        for a, b in ((tri[0], tri[1]), (tri[1], tri[2]), (tri[2], tri[0])):
            directed[(a, b)] += 1
    return directed


@pytest.mark.parametrize("case", ["random", "sphere", "exact_iso"])
def test_marching_tetrahedra_matches_jax(case):
    if case == "random":
        values = np.random.default_rng(0).normal(size=(9, 7, 8))
        args = (0.3, (0.5, -1.0, 2.0), (0.1, 0.2, 0.15))
    elif case == "sphere":
        values, origin, spacing = _sphere_values()
        args = (0.0, origin, spacing)
    else:
        values = np.zeros((6, 6, 6))
        values[2:4, 2:4, 2:4] = 1.0
        args = (0.0, (0.0,) * 3, (1.0,) * 3)
    want_v, want_f = jgeo.marching_tetrahedra(values, *args)
    got_v, got_f = tgeo.marching_tetrahedra(values, *args)
    assert got_v.dtype == np.float32 and got_f.dtype == np.int64 and got_f.shape[0] > 0
    np.testing.assert_array_equal(got_v, want_v)
    np.testing.assert_array_equal(got_f, want_f)


def test_sphere_mesh_is_watertight_and_wound_outward():
    values, origin, spacing = _sphere_values()
    verts, faces = tgeo.marching_tetrahedra(values, 0.0, origin, spacing)
    assert np.all(np.abs(np.linalg.norm(verts, axis=1) - 0.62) < 0.05)
    directed = _directed_edges(faces)
    for (a, b), count in directed.items():
        assert count == 1 and (b, a) in directed
    assert verts.shape[0] - len(directed) // 2 + faces.shape[0] == 2
    p0, p1, p2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    assert np.all(np.einsum("ij,ij->i", np.cross(p1 - p0, p2 - p0), (p0 + p1 + p2) / 3) > 0)


def test_exact_iso_corners_weld_and_stay_watertight():
    values = np.zeros((6, 6, 6))
    values[2:4, 2:4, 2:4] = 1.0
    verts, faces = tgeo.marching_tetrahedra(values, 0.0)
    assert np.unique(np.round(verts, 6), axis=0).shape[0] == verts.shape[0]
    p0, p1, p2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    assert np.all(np.linalg.norm(np.cross(p1 - p0, p2 - p0), axis=1) > 1e-12)
    directed = _directed_edges(faces)
    for (a, b), count in directed.items():
        assert count == 1 and (b, a) in directed
    for fill in (-1.0, 1.0):
        v, f = tgeo.marching_tetrahedra(np.full((4, 4, 4), fill), 0.0)
        assert v.shape == (0, 3) and f.shape == (0, 3)
    with pytest.raises(ValueError, match="3-D grid"):
        tgeo.marching_tetrahedra(np.zeros((1, 4, 4)), 0.0)


# ---------------------------------------------------------------------------
# Vertex queries, extraction, PLY
# ---------------------------------------------------------------------------


def test_rgb_and_normal_queries_match_jax():
    jmodel, params, tmodel = _pair("flexible", seed=3)
    js, ts = _settings()
    pts = np.random.default_rng(1).uniform(-1, 1, (1500, 3)).astype(np.float32)
    want_rgb = np.asarray(jgeo.make_rgb_query_fn(jmodel, js, chunk=1024)(params, pts))
    got_rgb = tgeo.make_rgb_query_fn(tmodel, ts, chunk=1024)(pts)
    assert got_rgb.shape == (1500, 3)
    np.testing.assert_allclose(got_rgb, want_rgb, rtol=0, atol=1e-5)
    want_n = np.asarray(jgeo.make_normals_query_fn(jmodel, js, chunk=1024)(params, pts))
    got_n = tgeo.make_normals_query_fn(tmodel, ts, chunk=1024)(pts)
    np.testing.assert_allclose(np.linalg.norm(got_n, axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got_n, want_n, rtol=0, atol=1e-4)
    assert tgeo.make_rgb_query_fn(tmodel, ts)(np.zeros((0, 3))).shape == (0, 3)


def test_extract_mesh_and_pointcloud_match_jax():
    jmodel, params, tmodel = _pair("flexible")
    js, ts = _settings()
    kw = dict(bbox_min=(-1,) * 3, bbox_max=(1,) * 3, resolution=12, chunk=128)
    grid = tgeo.make_sigma_grid_fn(tmodel, ts, 12, (-1,) * 3, (1,) * 3)()
    iso = 2.0
    assert np.abs(grid - iso).min() > 1e-4
    want = jgeo.extract_mesh(jmodel, params, js, iso=iso, **kw)
    got = tgeo.extract_mesh(tmodel, ts, iso=iso, **kw)
    assert got[0].shape[0] > 0
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    assert np.abs(got[2].astype(int) - want[2].astype(int)).max() <= 1
    np.testing.assert_allclose(got[3], want[3], rtol=0, atol=1e-4)
    want_pc = jgeo.extract_pointcloud(jmodel, params, js, threshold=iso, max_points=50,
                                      seed=4, sigma_grid=grid, **kw)
    got_pc = tgeo.extract_pointcloud(tmodel, ts, threshold=iso, max_points=50, seed=4,
                                     sigma_grid=grid, **kw)
    assert got_pc[0].shape == (50, 3)
    np.testing.assert_array_equal(got_pc[0], want_pc[0])
    np.testing.assert_array_equal(got_pc[2], want_pc[2])
    assert np.abs(got_pc[1].astype(int) - want_pc[1].astype(int)).max() <= 1


@pytest.mark.parametrize("parts", ["all", "vertices", "faces_only", "colors_only"])
def test_ply_bytes_equal_jax_and_load_both_ways(tmp_path, parts):
    rng = np.random.default_rng(2)
    verts = rng.normal(size=(30, 3)).astype(np.float32)
    faces = rng.integers(0, 30, (17, 3)) if parts in ("all", "faces_only") else None
    colors = rng.integers(0, 256, (30, 3)).astype(np.uint8) if parts in ("all", "colors_only") \
        else None
    normals = rng.normal(size=(30, 3)).astype(np.float32) if parts == "all" else None
    tpath, jpath = str(tmp_path / "t.ply"), str(tmp_path / "j.ply")
    tgeo.save_ply(tpath, verts, faces=faces, colors=colors, normals=normals)
    jgeo.save_ply(jpath, verts, faces=faces, colors=colors, normals=normals)
    assert open(tpath, "rb").read() == open(jpath, "rb").read()
    for loader, path in ((tgeo.load_ply, jpath), (jgeo.load_ply, tpath)):
        v, f, c, n = loader(path)
        np.testing.assert_array_equal(v, verts)
        for got, want in ((f, faces), (c, colors), (n, normals)):
            if want is None:
                assert got is None
            else:
                np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# The CLIs on an octahedral field
# ---------------------------------------------------------------------------

OCTA_C = 3.0          # sigma = relu(3 - |x|_1) inside the octahedron


def octahedron_params(seed=0):
    """A narrow Flexible model whose pre-ReLU alpha is ``3 - |x|_1``: layer1
    passes x, y, z through, layers_xyz.0 makes relu(+-x_k), fc_alpha sums
    them with weight -1. Every other weight is random (colour, direction)."""
    params = jax.tree.map(np.array, JaxFlexible(**NARROW).init(jax.random.PRNGKey(seed)))
    k1 = params["layer1"]["kernel"]
    k1[:] = 0.0
    k1[0:3, 0:3] = np.eye(3)                 # encoding features 0-2 are x, y, z
    params["layer1"]["bias"][:] = 0.0
    k2 = params["layers_xyz"][0]["kernel"]
    k2[:, :6] = 0.0
    k2[0:3, 0:3], k2[0:3, 3:6] = np.eye(3), -np.eye(3)
    params["layers_xyz"][0]["bias"][:6] = 0.0
    ka = params["fc_alpha"]["kernel"]
    ka[:] = 0.0
    ka[:6] = -1.0
    params["fc_alpha"]["bias"][:] = OCTA_C
    return params


CLI_YAML = """
experiment:
  id: octa
  logdir: {logdir}
  randomseed: 3
  train_iters: 7
  print_every: 1
  validate_every: 1
  save_every: 100
dataset:
  type: {dtype}
  basedir: {basedir}
  num_views: 3
  image_size: 10
  no_ndc: True
  near: 2
  far: 6
  height: 10
  width: 8
models:
  coarse:
    type: FlexibleNeRFModel
    num_layers: 2
    hidden_size: 32
    num_encoding_fn_xyz: 4
    num_encoding_fn_dir: 2
  fine:
    type: FlexibleNeRFModel
    num_layers: 2
    hidden_size: 32
    num_encoding_fn_xyz: 4
    num_encoding_fn_dir: 2
nerf:
  train:
    num_random_rays: 16
    num_coarse: 8
    num_fine: 8
    white_background: True
  validation:
    chunksize: 40
    num_coarse: 8
    num_fine: 8
    white_background: True
"""


@pytest.fixture(scope="module")
def octa(tmp_path_factory):
    d = tmp_path_factory.mktemp("octa")
    cfgs = {}
    for dtype in ("synthetic", "blender"):
        path = d / f"{dtype}.yml"
        path.write_text(CLI_YAML.format(logdir=d / "logs", dtype=dtype, basedir=d / "none"))
        cfgs[dtype] = str(path)
    ckpt = str(d / "octa.ntc")
    jax_save_checkpoint(ckpt, {"step": np.asarray(5), "params_coarse": octahedron_params(0),
                               "params_fine": octahedron_params(1)})
    return cfgs, ckpt, d


# sigma > 2 where |x|_1 < 1. The 64^3 sweep of [-1.5, 1.5]^3 puts vertices at
# odd multiples of 1/42, where |x|_1 is an odd multiple of 1/42 too: every
# vertex is 1/42 or more from the threshold.
TAU = 2.0


def _jax_box(cfg_path, ckpt, mode):
    from nerf_tpu.engine.checkpoint import load_models_and_params as jax_load

    cfg = jax_load_config(cfg_path)
    jmodel, _, pc, _, _ = jax_load(ckpt, cfg)
    js = jax_settings_from_config(cfg, mode, hwf=(10, 8, 10.0))
    return jmodel, pc, js, jgeo.density_aabb(jmodel, pc, js, tau=TAU)


SWEEP = ["--aabb-sweep-bounds", "-1.5", "-1.5", "-1.5", "1.5", "1.5", "1.5"]


def test_train_cli_tightens_to_the_jax_box(octa, capsys):
    cfgs, ckpt, d = octa
    result = train_nerf.main(["--config", cfgs["synthetic"], "--device", "cpu",
                              "--load-checkpoint", ckpt, "--tighten-aabb", str(TAU), *SWEEP])
    *_, want = _jax_box(cfgs["synthetic"], ckpt, "validation")
    out = capsys.readouterr().out
    assert result.aabb == want and result.start_step == 5 and len(result.losses) == 2
    assert f"density AABB (tau={TAU}): [{want[0]:.2f},{want[1]:.2f},{want[2]:.2f}] - " in out
    assert np.all(np.isfinite(result.losses)) and len(result.val_psnrs) == 2
    # the octahedron |x|_1 < 1, padded by a voxel, inside the sweep cube
    ax = (np.arange(64) - 31.5) / 21.0
    l1 = np.abs(ax)[:, None, None] + np.abs(ax)[None, :, None] + np.abs(ax)[None, None, :]
    assert np.abs(l1 - 1.0).min() > 1.0 / 43
    edge = ax[l1.min(axis=(1, 2)) < 1.0].max() + 1.0 / 21
    np.testing.assert_allclose(want, (-edge,) * 3 + (edge,) * 3, rtol=0, atol=1e-12)


def _run_jax_cli(script, argv, monkeypatch):
    """A root JAX CLI (``eval_nerf.py``, ``extract_geometry.py``) in this
    process, its ``main()`` reading ``sys.argv``."""
    monkeypatch.syspath_prepend(REPO)
    module = importlib.import_module(script)
    monkeypatch.setattr(sys, "argv", [f"{script}.py", *argv])
    module.main()


def test_eval_cli_tightened_frames_match_jax(octa, monkeypatch, capsys):
    cfgs, ckpt, d = octa
    args = ["--config", cfgs["blender"], "--checkpoint", ckpt, "--num-poses", "2",
            "--tighten-aabb", str(TAU), *SWEEP]
    _run_jax_cli("eval_nerf", [*args, "--savedir", str(d / "jax_eval"), "--renderer", "xla"],
                 monkeypatch)
    jax_line = [ln for ln in capsys.readouterr().out.splitlines() if "density AABB" in ln]
    result = eval_nerf.main([*args, "--savedir", str(d / "eval"), "--device", "cpu"])
    port_line = [ln for ln in capsys.readouterr().out.splitlines() if "density AABB" in ln]
    # the same printed box line, up to its seconds
    assert len(jax_line) == 1 == len(port_line)
    assert jax_line[0].rsplit(" (", 1)[0] == port_line[0].rsplit(" (", 1)[0]
    for name in ("0000.png", "0001.png"):
        jax_png = imageio.imread(d / "jax_eval" / name).astype(int)
        assert np.abs(imageio.imread(d / "eval" / name).astype(int) - jax_png).max() <= 1
    jmodel, pc, js, want_box = _jax_box(cfgs["blender"], ckpt, "validation")
    assert result.aabb == want_box
    from nerf_tpu.engine.checkpoint import load_models_and_params as jax_load

    _, _, _, pf, _ = jax_load(ckpt, jax_load_config(cfgs["blender"]))
    poses, h, w, focal = resolve_render_poses(load_config(cfgs["blender"]))
    render = jax_pose_render_fn(jmodel, jmodel, dataclasses.replace(js, aabb=want_box),
                                h, w, focal, output="maps")
    want = render(pc, pf, jnp.asarray(poses[0], jnp.float32))
    base = jax_pose_render_fn(jmodel, jmodel, js, h, w, focal, output="maps")(
        pc, pf, jnp.asarray(poses[0], jnp.float32))
    assert np.abs(np.asarray(base["rgb_fine"]) - np.asarray(want["rgb_fine"])).max() > 1e-3
    for name in ("rgb_coarse", "rgb_fine", "disp_fine", "acc_fine"):
        np.testing.assert_allclose(result.first_maps[name].numpy(), np.asarray(want[name]),
                                   rtol=1e-4, atol=1e-4)
    assert np.abs(result.first_maps["rgb_u8"].numpy().astype(int)
                  - np.asarray(want["rgb_u8"]).astype(int)).max() <= 1


@pytest.mark.parametrize("argv,error", [
    (["--tighten-aabb", "1.0", "--overrides", "dataset.no_ndc", "False"],
     (SystemExit, "incompatible with NDC")),
])
def test_eval_cli_keeps_the_jax_refusals(octa, argv, error):
    cfgs, ckpt, d = octa
    with pytest.raises(error[0], match=error[1]):
        eval_nerf.main(["--config", cfgs["blender"], "--checkpoint", ckpt, "--savedir",
                        str(d / "x"), "--device", "cpu", *argv])


def test_extract_geometry_cli_matches_jax(octa, monkeypatch, capsys):
    cfgs, ckpt, d = octa
    # R = 16 over [-1.5, 1.5]^3: |x|_1 takes multiples of 0.1 on the grid and
    # the iso 1.95 puts the surface at |x|_1 = 1.05, 0.05 from every vertex.
    args = ["--config", cfgs["blender"], "--checkpoint", ckpt, "--resolution", "16",
            "--iso", "1.95", "--chunk", "1000"]
    tmodel = load_jax_params(FlexibleNeRFModel(**NARROW), octahedron_params(1))
    grid = tgeo.make_sigma_grid_fn(tmodel, RenderSettings(**ENC), 16, (-1.5,) * 3,
                                   (1.5,) * 3)()
    assert np.abs(grid - 1.95).min() > 1e-4
    jpath, tpath = str(d / "jax.ply"), str(d / "port.ply")
    _run_jax_cli("extract_geometry", [*args, "--output", jpath], monkeypatch)
    extract_geometry.main([*args, "--output", tpath, "--device", "cpu",
                           "--save-grid", str(d / "grid.npz")])
    out = capsys.readouterr().out
    assert "sigma grid 16^3 = 4,096 points in" in out and "mesh: " in out
    jv, jf, jc, jn = tgeo.load_ply(jpath)
    tv, tf, tc, tn = tgeo.load_ply(tpath)
    assert tv.shape[0] > 100
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-5)
    # on the octahedron |x|_1 = 1.05, up to a grid step where an edge crosses
    # a coordinate plane (the field is linear within each octant only)
    assert np.abs(np.abs(tv).sum(axis=1) - 1.05).max() < 0.2
    assert np.abs(tc.astype(int) - jc.astype(int)).max() <= 1
    np.testing.assert_allclose(tn, jn, rtol=0, atol=1e-4)
    np.testing.assert_allclose(np.load(d / "grid.npz")["sigma"], grid, rtol=0, atol=0)
    pc = str(d / "pc.ply")
    extract_geometry.main([*args, "--output", pc, "--device", "cpu", "--mode", "pointcloud",
                           "--max-points", "30", "--no-colors"])
    v, f, c, n = tgeo.load_ply(pc)
    assert v.shape == (30, 3) and f is None and c is not None and n is None


@pytest.mark.parametrize("argv,error", [
    (["--bbox", "0", "0", "0", "1", "-1", "1"], "degenerate --bbox"),
    (["--overrides", "dataset.type", "llff"], "no default world-space bounding box"),
    (["--iso", "100"], "no isosurface"),
])
def test_extract_geometry_cli_refusals(octa, argv, error):
    cfgs, ckpt, d = octa
    with pytest.raises(SystemExit, match=error):
        extract_geometry.main(["--config", cfgs["blender"], "--checkpoint", ckpt, "--output",
                               str(d / "r.ply"), "--device", "cpu", "--resolution", "8", *argv])
