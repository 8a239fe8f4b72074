"""``python -m nerf_tpu_torch.train_nerf`` on the CPU, on a tiny synthetic
config written as a Python config file (no YAML reader needed).

The CLI trains with the training kernels' plain pair (the tensors lie on the
CPU), writes the metrics JSONL, validation PNGs and a reference ``.ckpt``
with the optimizer's state, which ``eval_nerf`` then renders and a second
run resumes from.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from nerf_tpu_torch import eval_nerf, train_nerf
from nerf_tpu_torch.config import load_config

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY_PY = """
_model = {{"type": "FlexibleNeRFModel", "num_encoding_fn_xyz": 10, "num_encoding_fn_dir": 4}}
cfg = {{
    "experiment": {{"id": "tiny", "logdir": {logdir!r}, "randomseed": 3, "train_iters": 6,
                    "print_every": 3, "validate_every": 3, "save_every": 6}},
    "dataset": {{"type": "synthetic", "num_views": 3, "image_size": 12}},
    "models": {{"coarse": dict(_model), "fine": dict(_model)}},
    "nerf": {{
        "train": {{"num_random_rays": 32, "num_coarse": 8, "num_fine": 8,
                   "white_background": True, "use_pallas_train": True,
                   "compute_dtype": "bfloat16"}},
        "validation": {{"num_coarse": 8, "num_fine": 8, "chunksize": 64,
                        "white_background": True}},
    }},
}}
"""


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One CLI run in a subprocess: 6 steps, validation at 3 and 6."""
    d = tmp_path_factory.mktemp("train_cli")
    cfg_path = d / "tiny.py"
    cfg_path.write_text(TINY_PY.format(logdir=str(d / "logs")))
    proc = subprocess.run(
        [sys.executable, "-m", "nerf_tpu_torch.train_nerf", "--config", str(cfg_path),
         "--device", "cpu"],
        cwd=str(d), capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "2"},
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return str(cfg_path), str(d / "logs" / "tiny"), proc.stdout


def test_cli_writes_metrics_images_and_a_checkpoint(trained):
    _, logdir, stdout = trained
    assert "[TRAIN] iter 5" in stdout and "[VAL] iter 5" in stdout
    records = [json.loads(line) for line in open(os.path.join(logdir, "metrics.jsonl"))]
    losses = [r["value"] for r in records if r["tag"] == "train/loss"]
    assert [r["step"] for r in records if r["tag"] == "train/loss"] == [2, 5]
    assert all(np.isfinite(losses))
    assert [r["step"] for r in records if r["tag"] == "validation/psnr"] == [2, 5]
    assert sorted(os.listdir(os.path.join(logdir, "images"))) == [
        "validation_rgb_fine_000002.png", "validation_rgb_fine_000005.png"]
    ckpt = torch.load(os.path.join(logdir, "checkpoint00006.ckpt"), weights_only=True)
    assert ckpt["iter"] == 6 and (ckpt["height"], ckpt["width"]) == (12, 12)
    assert len(ckpt["optimizer_state_dict"]["state"]) == 2 * 16
    assert float(ckpt["optimizer_state_dict"]["state"][0]["step"]) == 6
    with open(os.path.join(logdir, "config.json")) as f:
        assert json.load(f)["nerf"]["train"]["use_pallas_train"] is True


def test_eval_renders_the_trained_checkpoint(trained, tmp_path):
    cfg_path, logdir, _ = trained
    ckpt = os.path.join(logdir, "checkpoint00006.ckpt")
    result = eval_nerf.render_trajectory(load_config(cfg_path), ckpt, str(tmp_path / "plain"),
                                         num_poses=1, renderer="plain", device="cpu")
    assert all(result.finite) and result.first_maps["rgb_fine"].shape == (12, 12, 3)
    assert os.listdir(tmp_path / "plain") == ["0000.png"]
    cli = eval_nerf.main(["--config", cfg_path, "--checkpoint", ckpt, "--savedir",
                          str(tmp_path / "cli"), "--num-poses", "1", "--device", "cpu"])
    torch.testing.assert_close(cli.first_maps["rgb_fine"], result.first_maps["rgb_fine"])


def test_cli_resumes_from_its_checkpoint(trained, tmp_path):
    cfg_path, logdir, _ = trained
    cfg = load_config(cfg_path, ["experiment.train_iters", 8, "experiment.save_every", 8])
    run = train_nerf.train(cfg, logdir=str(tmp_path), device="cpu",
                           load_checkpoint=os.path.join(logdir, "checkpoint00006.ckpt"))
    assert run.start_step == 6 and len(run.losses) == 2
    assert run.checkpoint == str(tmp_path / "checkpoint00008.ckpt")
    ckpt = torch.load(run.checkpoint, weights_only=True)
    assert float(ckpt["optimizer_state_dict"]["state"][0]["step"]) == 8
    assert run.rays_per_sec > 0 and len(run.val_psnrs) == 1


@pytest.mark.parametrize("argv,error", [
    (["--tighten-aabb", "2.0", "--overrides", "experiment.id", "fresh"],
     (SystemExit, "needs a trained field to bound")),
    (["--num-devices", "2", "--dist-backend", "nccl"],
     (ValueError, "NCCL backend needs a CUDA device")),
    (["--overrides", "dataset.type", "blender", "dataset.basedir", "{tmp}/none"],
     (FileNotFoundError, "transforms_train.json")),
    (["--overrides", "dataset.type", "llff", "dataset.basedir", "{tmp}/none"],
     (FileNotFoundError, "poses_bounds.npy")),
    (["--overrides", "dataset.cachedir", "{tmp}/rays.nrc"], (OSError, "invalid ray cache")),
    (["--load-checkpoint", "{tmp}/checkpoint00003.ntc"], (ValueError, "truncated msgpack")),
], ids=["tighten-aabb", "num-devices", "blender", "llff", "nrc-cache", "ntc-resume"])
def test_unported_options_raise_naming_the_roadmap(trained, tmp_path, argv, error):
    """What is not ported raises naming its ROADMAP.md item. --tighten-aabb
    is ported (tests/test_torch_geometry.py) and keeps the JAX CLI's refusal
    of a run with no checkpoint to bound. The dataset
    loaders, the .nrc cache and .ntc resume are ported
    (tests/test_torch_train_disk.py, tests/test_torch_ntc_resume.py): on a
    missing dataset, an empty .nrc or an empty .ntc they raise for the
    file."""
    cfg_path, _, _ = trained
    argv = [a.format(tmp=tmp_path) for a in argv]
    (tmp_path / "checkpoint00003.ntc").write_bytes(b"")
    (tmp_path / "rays.nrc").write_bytes(b"")
    with pytest.raises(error[0], match=error[1]):
        train_nerf.main(["--config", cfg_path, "--device", "cpu", *argv])
