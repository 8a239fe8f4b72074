"""The port's CLIs with ``--num-devices 2`` on the CPU (gloo ranks they spawn
themselves), the two-rank render server, and the build locks.

- ``train_nerf``: one checkpoint set written by rank 0, a resume from it,
  the all-reduce's bucket and time reported;
- ``extract_geometry``: the grid and the PLY bytes of the 2-rank run equal
  the serial run's;
- ``optimize_poses``: the 2-rank refinement follows the serial trajectory,
  falls back to the serial loop (as the JAX CLI does) when the ranks do not
  divide the images, and ``--joint-train`` writes one checkpoint;
- ``train_multiscene``: two scenes on two ranks, one export a scene;
- ``serve_nerf``: the 2-rank service's PNG equals the one-rank service's,
  a ``--logdir`` reload reaches the follower, stop releases it; the CLI
  serves over HTTP and every process is gone after Ctrl-C;
- two processes building the native library (and the kernel library, its
  compile stubbed) at once: one build.

Every spawn has a deadline: the CLIs run with ``--dist-timeout 60`` (their
own default is torch's timeout), ``run_ranks`` joins them within
``DEADLINE_S`` and kills the ranks when one fails; subprocesses are killed
past theirs.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from nerf_tpu_torch import extract_geometry, optimize_poses, serve_nerf, train_multiscene
from nerf_tpu_torch import train_nerf
from nerf_tpu_torch.config import load_config
from nerf_tpu_torch.engine.checkpoint import latest_checkpoint, save_checkpoint
from nerf_tpu_torch.engine.geometry import make_sigma_grid_fn
from nerf_tpu_torch.parallel import distributed as tdist
from nerf_tpu_torch.parallel import mesh as tmesh
from nerf_tpu_torch.utils.png import decode_png

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = ["--dist-timeout", "60"]
DEADLINE_S = 240


@pytest.fixture(scope="module", autouse=True)
def _rank_deadline():
    """The ranks a CLI spawns are joined within DEADLINE_S."""
    real = tdist.run_ranks

    def bounded(*args, **kwargs):
        kwargs.setdefault("deadline_s", DEADLINE_S)
        return real(*args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdist, "run_ranks", bounded)
        mp.setattr(train_nerf, "run_ranks", bounded)
        yield

TINY_PY = """
_model = {{"type": "FlexibleNeRFModel", "num_layers": 2, "hidden_size": 16,
          "num_encoding_fn_xyz": 4, "num_encoding_fn_dir": 2}}
cfg = {{
    "experiment": {{"id": "tiny", "logdir": {logdir!r}, "randomseed": 3, "train_iters": 6,
                    "print_every": 3, "validate_every": 3, "save_every": 6}},
    "dataset": {{"type": "synthetic", "num_views": 3, "image_size": 12}},
    "models": {{"coarse": dict(_model), "fine": dict(_model)}},
    "nerf": {{
        "train": {{"num_random_rays": 30, "num_coarse": 8, "num_fine": 8,
                   "white_background": True, "radiance_field_noise_std": 0.2}},
        "validation": {{"num_coarse": 8, "num_fine": 8, "chunksize": 64,
                        "white_background": True}},
    }},
}}
"""


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``train_nerf --num-devices 2`` on the CPU: 6 steps of a 30-ray batch
    (padded to 30: it divides), validation at 3 and 6, one save at 6."""
    d = tmp_path_factory.mktemp("dp_train")
    cfg = d / "tiny.py"
    cfg.write_text(TINY_PY.format(logdir=str(d / "logs")))
    result = train_nerf.main(["--config", str(cfg), "--device", "cpu", "--num-devices", "2",
                              "--dist-backend", "gloo", *TIMEOUT])
    return str(cfg), str(d / "logs" / "tiny"), result


def test_train_nerf_two_ranks_writes_one_checkpoint_set(trained):
    cfg, logdir, result = trained
    assert result.world_size == 2 and result.start_step == 0 and len(result.losses) == 6
    assert all(np.isfinite(result.losses)) and len(result.val_psnrs) == 2
    assert result.checkpoint == os.path.join(logdir, "checkpoint00006.ckpt")
    assert sorted(os.listdir(logdir)) == ["checkpoint00006.ckpt", "checkpoint00006.ntc",
                                          "config.json", "images", "metrics.jsonl"]
    records = [json.loads(line) for line in open(os.path.join(logdir, "metrics.jsonl"))]
    # One writer: each tag once a call, not once a rank.
    assert [r["step"] for r in records if r["tag"] == "train/loss"] == [2, 5]
    assert [r["step"] for r in records if r["tag"] == "validation/psnr"] == [2, 5]
    # The flat bucket: every parameter of both models and the three losses, f32.
    model = train_nerf.model_from_config(load_config(cfg).models.coarse)
    assert result.bucket_bytes == 4 * (2 * sum(p.numel() for p in model.parameters()) + 3)
    assert result.allreduce_ms > 0


def test_train_nerf_two_ranks_resume_from_their_checkpoint(trained, tmp_path, capfd):
    cfg, logdir, _ = trained
    out = str(tmp_path / "resumed")
    result = train_nerf.train(load_config(cfg, ["experiment.train_iters", 8,
                                                "experiment.save_every", 8]),
                              logdir=out, device="cpu", num_devices=2, dist_timeout=60,
                              load_checkpoint=os.path.join(logdir, "checkpoint00006.ntc"))
    assert result.start_step == 6 and len(result.losses) == 2 and result.world_size == 2
    assert latest_checkpoint(out) == os.path.join(out, "checkpoint00008.ntc")
    text = capfd.readouterr().out
    assert text.count("resumed from") == 1     # rank 0 alone prints
    assert "data-parallel over 2 devices, batch 30" in text


def _opaque_checkpoint(path):
    """A checkpoint of the tiny config's models with a surface in the box."""
    model = train_nerf.model_from_config(load_config(path[0]).models.coarse)
    gen = torch.Generator().manual_seed(5)
    params = {}
    for which in ("params_coarse", "params_fine"):
        model.reset_parameters(gen)
        from nerf_tpu_torch.engine.checkpoint import convert_torch_state_dict

        p = convert_torch_state_dict({k: v * 3.0 for k, v in model.state_dict().items()})
        p["fc_alpha"]["bias"] = p["fc_alpha"]["bias"] + 2.0
        params[which] = p
    save_checkpoint(path[1], {"step": np.asarray(6), **params})
    return model


def test_extract_geometry_two_ranks_writes_the_serial_mesh(trained, tmp_path):
    cfg = trained[0]
    ckpt = str(tmp_path / "opaque.ntc")
    _opaque_checkpoint((cfg, ckpt))
    from nerf_tpu_torch.engine.checkpoint import load_models_and_params

    _, mf, _ = load_models_and_params(ckpt, load_config(cfg), "cpu")
    from nerf_tpu_torch.config import render_settings_from_config

    settings = render_settings_from_config(load_config(cfg), "validation", hwf=(1, 1, 1.0))
    iso = float(np.median(make_sigma_grid_fn(mf, settings, 12, (-1.5,) * 3, (1.5,) * 3)()))
    outs = {}
    for n in (1, 2):
        d = tmp_path / f"n{n}"
        d.mkdir()
        extract_geometry.main(["--config", cfg, "--checkpoint", ckpt, "--device", "cpu",
                               "--resolution", "12", "--chunk", "500", "--iso", str(iso),
                               "--output", str(d / "mesh.ply"), "--save-grid",
                               str(d / "grid.npz"), "--num-devices", str(n), *TIMEOUT])
        outs[n] = (np.load(d / "grid.npz")["sigma"], (d / "mesh.ply").read_bytes())
        assert sorted(os.listdir(d)) == ["grid.npz", "mesh.ply"]
    np.testing.assert_array_equal(outs[2][0], outs[1][0])
    assert outs[2][1] == outs[1][1] and len(outs[1][1]) > 1000


POSE_ARGS = ["--perturb-rot-deg", "2", "--perturb-trans", "0.05", "--iters", "4",
             "--rays-per-image", "16", "--steps-per-loop", "2", "--device", "cpu", *TIMEOUT]
FOCAL_ARGS = ["--refine-focal", "--perturb-focal", "1.05"]


@pytest.mark.parametrize("focal", [FOCAL_ARGS, []], ids=["refine_focal", "poses_only"])
def test_optimize_poses_two_ranks_follow_the_serial_trajectory(trained, tmp_path, focal):
    """Both ranks' pose loops on their image, against one device; without
    --refine-focal the focal has no gradient and the ranks reduce a zero."""
    cfg, logdir, _ = trained
    ckpt = os.path.join(logdir, "checkpoint00006.ntc")
    reports = {}
    for n in (1, 2):
        reports[n] = optimize_poses.main(["--config", cfg, "--checkpoint", ckpt, *POSE_ARGS,
                                          *focal, "--max-images", "2", "--num-devices", str(n),
                                          "--save-poses", str(tmp_path / f"p{n}.npz")])
    assert set(reports[2]) == set(reports[1]) and reports[2]["num_poses"] == 2
    for key in ["initial_loss", "final_loss", "final_rot_deg_mean"] + (["refined_focal"]
                                                                        if focal else []):
        np.testing.assert_allclose(reports[2][key], reports[1][key], rtol=1e-5)
    xi = {n: np.load(tmp_path / f"p{n}.npz")["xi"] for n in (1, 2)}
    np.testing.assert_allclose(xi[2], xi[1], rtol=0, atol=1e-5)
    assert np.abs(xi[1]).max() > 1e-4


def test_optimize_poses_falls_back_to_serial_when_ranks_do_not_divide(trained, capfd):
    cfg, logdir, _ = trained
    ckpt = os.path.join(logdir, "checkpoint00006.ntc")
    want = optimize_poses.main(["--config", cfg, "--checkpoint", ckpt, *POSE_ARGS,
                                *FOCAL_ARGS, "--max-images", "3"])
    got = optimize_poses.main(["--config", cfg, "--checkpoint", ckpt, *POSE_ARGS,
                               *FOCAL_ARGS, "--max-images", "3", "--num-devices", "2"])
    assert "serial fallback: 3 images not divisible by 2 devices" in capfd.readouterr().out
    for key in ("initial_loss", "final_loss", "final_rot_deg_mean", "refined_focal"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6)


def test_optimize_poses_joint_two_ranks_write_one_checkpoint(trained, tmp_path):
    cfg, _, _ = trained
    out = tmp_path / "joint" / "joint.ntc"
    report = optimize_poses.main(["--config", cfg, "--joint-train", "--perturb-rot-deg", "1",
                                  "--perturb-trans", "0.02", "--iters", "2",
                                  "--rays-per-image", "8", "--steps-per-loop", "1",
                                  "--max-images", "2", "--device", "cpu", "--num-devices", "2",
                                  *TIMEOUT, "--save-checkpoint", str(out)])
    assert report["mode"] == "joint" and np.isfinite(report["final_loss"])
    assert os.listdir(out.parent) == ["joint.ntc"]


def test_train_multiscene_two_ranks(tmp_path):
    result = train_multiscene.main([
        "--num-scenes", "2", "--iters", "3", "--print-every", "2", "--size", "8", "--views",
        "2", "--batch", "16", "--num-coarse", "4", "--num-fine", "4", "--n-xyz", "2",
        "--n-dir", "1", "--save-dir", str(tmp_path), "--device", "cpu", "--num-devices", "2",
        *TIMEOUT])
    assert result.groups == {"blender": ["scene0", "scene1"]}
    assert [a.shape for a in result.losses["blender"]] == [(2, 2), (1, 2)]
    assert all(np.isfinite(a).all() for a in result.losses["blender"])
    assert sorted(os.listdir(tmp_path)) == ["scene0", "scene1"]
    assert os.listdir(tmp_path / "scene0") == ["checkpoint00003.ntc"]


# --------------------------------------------------------------------------
# The server


def _serve_rank(cfg_path, logdir, pose, newer):
    """Rank 0 renders ``pose``, then (a newer checkpoint landing in the
    watched logdir) again, and stops; the follower follows."""
    import shutil

    mesh = tmesh.make_mesh(2, "cpu")
    service = serve_nerf.RenderService(load_config(cfg_path), renderer="plain",
                                       watch_logdir=logdir, device="cpu", mesh=mesh)
    if not mesh.is_primary:
        service.follow()
        return {"checkpoint": service.checkpoint_path}
    from nerf_tpu_torch.utils.png import png_bytes

    first = png_bytes(service.render_pose(pose))
    shutil.copy(newer, os.path.join(logdir, "checkpoint00009.ntc"))
    second = png_bytes(service.render_pose(pose))
    health = service.health()
    service.stop()
    return {"first": first, "second": second, "health": health,
            "checkpoint": service.checkpoint_path}


def test_two_rank_service_matches_one_rank_and_reloads_on_both(trained, tmp_path):
    from nerf_tpu_torch.utils.png import png_bytes

    cfg, logdir, _ = trained
    watch = tmp_path / "watch"
    watch.mkdir()
    first_ckpt = watch / "checkpoint00006.ntc"
    first_ckpt.write_bytes(open(os.path.join(logdir, "checkpoint00006.ntc"), "rb").read())
    newer = str(tmp_path / "opaque.ntc")
    _opaque_checkpoint((cfg, newer))
    pose = np.asarray(serve_nerf.pose_spherical(40.0, -30.0, 4.0), np.float32)
    r0, r1 = tdist.run_ranks(_serve_rank, 2, cfg, str(watch), pose, newer, backend="gloo",
                             device="cpu", timeout_s=60)
    want = {}
    for name, path in (("first", str(first_ckpt)), ("second", newer)):
        one = serve_nerf.RenderService(load_config(cfg), path, renderer="plain", device="cpu")
        want[name] = png_bytes(one.render_pose(pose))
    assert r0["first"] == want["first"] and r0["second"] == want["second"]
    assert r0["first"] != r0["second"]
    assert r0["health"]["devices"] == 2 and r0["health"]["frames_served"] == 2
    assert r0["checkpoint"] == r1["checkpoint"] == str(watch / "checkpoint00009.ntc")


def _read_lines(stream, lines):
    for line in stream:
        lines.append(line)


def test_serve_cli_two_ranks_over_http_and_ctrl_c(trained):
    cfg, logdir, _ = trained
    ckpt = os.path.join(logdir, "checkpoint00006.ntc")
    proc = subprocess.Popen(
        [sys.executable, "-m", "nerf_tpu_torch.serve_nerf", "--config", cfg, "--checkpoint",
         ckpt, "--renderer", "plain", "--device", "cpu", "--num-devices", "2", "--port", "0",
         *TIMEOUT],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}, start_new_session=True)
    lines = []
    threading.Thread(target=_read_lines, args=(proc.stdout, lines), daemon=True).start()
    try:
        end = time.monotonic() + 120
        while not any("serving" in line for line in lines):
            assert proc.poll() is None and time.monotonic() < end, "".join(lines)[-3000:]
            time.sleep(0.2)
        url = next(line for line in lines if "serving" in line).split()[4].rstrip("/")
        health = json.loads(urllib.request.urlopen(url + "/health", timeout=60).read())
        assert health["devices"] == 2
        body = urllib.request.urlopen(url + "/render?theta=40&phi=-30&radius=4",
                                      timeout=60).read()
        one = serve_nerf.RenderService(load_config(cfg), ckpt, precision="bfloat16",
                                       renderer="plain", device="cpu")
        np.testing.assert_array_equal(decode_png(body), one.render_spherical(40.0, -30.0, 4.0))
        os.killpg(proc.pid, signal.SIGINT)
        proc.wait(timeout=60)
        time.sleep(0.5)
        with pytest.raises(ProcessLookupError):
            os.killpg(proc.pid, 0)      # no rank outlives the server
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(timeout=30)
    assert proc.returncode == 0, "".join(lines)[-3000:]


# --------------------------------------------------------------------------
# Collective timeouts


def _slow_primary(pause_s):
    """Rank 0 works ``pause_s`` seconds between two collectives (as it
    renders a validation frame or writes a checkpoint) while rank 1 waits
    in the barrier after that work."""
    mesh = tmesh.make_mesh(2, "cpu")
    mesh.barrier()
    if mesh.is_primary:
        time.sleep(pause_s)
    mesh.barrier()
    return mesh.rank


@pytest.mark.parametrize("timeout_s", [4.0, None])
def test_rank0_work_between_collectives_outlasts_only_a_shorter_timeout(timeout_s):
    """Rank 0's 8 s of work aborts its peer under a 4 s group timeout, and
    passes under the default a CLI's spawned group keeps (torch's)."""
    def run():
        return tdist.run_ranks(_slow_primary, 2, 8.0, backend="gloo", device="cpu",
                               timeout_s=timeout_s)

    if timeout_s is None:
        assert run() == [0, 1]
    else:
        with pytest.raises(RuntimeError, match="(?i)timed out|timeout"):
            run()


def _cli_spawn(name, tmp_path, extra):
    """``name``'s main with ``--num-devices 2`` up to its spawn."""
    cfg = tmp_path / "tiny.py"
    cfg.write_text(TINY_PY.format(logdir=str(tmp_path / "logs")))
    common = ["--device", "cpu", "--num-devices", "2", *extra]
    argv = {
        "train_nerf": ["--config", str(cfg)],
        "extract_geometry": ["--config", str(cfg), "--checkpoint", "c.ntc", "--output", "m.ply"],
        "optimize_poses": ["--config", str(cfg), "--checkpoint", "c.ntc"],
        "train_multiscene": ["--batch", "16"],
        "serve_nerf": ["--config", str(cfg), "--checkpoint", "c.ntc"],
    }[name]
    module = {"train_nerf": train_nerf, "extract_geometry": extract_geometry,
              "optimize_poses": optimize_poses, "train_multiscene": train_multiscene,
              "serve_nerf": serve_nerf}[name]
    module.main(argv + common)


@pytest.mark.parametrize("timeout", [None, 7.0])
@pytest.mark.parametrize("name", ["train_nerf", "extract_geometry", "optimize_poses",
                                  "train_multiscene", "serve_nerf"])
def test_cli_spawns_its_ranks_with_torchs_timeout_unless_asked(name, timeout, tmp_path,
                                                              monkeypatch):
    seen = []

    def spawn(fn, world_size, *args, **kwargs):
        seen.append((world_size, kwargs["timeout_s"]))
        return [None] * world_size

    monkeypatch.setattr(tdist, "run_ranks", spawn)
    monkeypatch.setattr(train_nerf, "run_ranks", spawn)
    for name_ in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(name_, raising=False)
    _cli_spawn(name, tmp_path, [] if timeout is None else ["--dist-timeout", str(timeout)])
    assert seen == [(2, timeout)]


# --------------------------------------------------------------------------
# Build locks


_BUILDER = """
import pathlib, subprocess, sys, time
from nerf_tpu_torch import native
from nerf_tpu_torch.kernels import _build
d = pathlib.Path(sys.argv[2])
native.BUILD_DIR = _build.BUILD_DIR = d
log = d / "builds.log"
if sys.argv[1] == "native":
    real = subprocess.run
    def counting(cmd, *a, **k):
        if cmd[0] == "g++":
            with open(log, "a") as f:
                f.write("g++\\n")
        return real(cmd, *a, **k)
    subprocess.run = counting
    build = native._build
else:
    def compile_stub(out):
        with open(log, "a") as f:
            f.write("nvcc\\n")
        time.sleep(1.0)
        out.write_bytes(b"stub")
    _build._compile = compile_stub
    build = _build.build_library
while not (d / "go").exists():
    time.sleep(0.01)
print(build())
"""


@pytest.mark.parametrize("which", ["native", "kernels"])
def test_two_cold_processes_build_one_library(tmp_path, which):
    procs = [subprocess.Popen([sys.executable, "-c", _BUILDER, which, str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              cwd=REPO, env={**os.environ, "PYTHONPATH": REPO})
             for _ in range(2)]
    try:
        time.sleep(2.0)        # both imported and waiting
        (tmp_path / "go").write_text("")
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1
    assert (tmp_path / "builds.log").read_text().count("\n") == 1
    libs = [f for f in os.listdir(tmp_path) if f.endswith(".so")]
    assert libs == [os.path.basename(paths.pop())]
