"""The plain reference against the system's own plain float32 path on the
CPU at a tiny size (the draws, the fields, compositing, resampling, the
loss, the gradients and Adam), and the benchmark's scene against the
system's synthetic scene."""

import copy

import numpy as np
import pytest
import torch

from benchmark.drivers.render import RenderRun
from benchmark.drivers.train import TrainRun
from benchmark.harness import spec
from benchmark.reference import nerf_plain
from benchmark.traffic import scene

SIZES = dict(rays=48, samples=12, views=2, height=12, width=12, steps_per_call=3)


def float32_cell(name, kernel_path=True):
    cell = spec.find_cell(name)
    cell.config = copy.deepcopy(cell.config)
    for mode in ("train", "validation"):
        cell.config["nerf"][mode]["compute_dtype"] = "float32"
    cell.config["nerf"]["train"]["use_pallas_train"] = kernel_path
    return cell


@pytest.mark.parametrize("workload", ["flex_train", "paper_train"])
@pytest.mark.parametrize("kernel_path", [True, False], ids=["kernel_plain", "module"])
def test_training_steps_match_the_system_in_float32(workload, kernel_path):
    run = TrainRun(float32_cell(workload, kernel_path), 2147483659, "cpu", sizes=SIZES)
    run.setup()
    run.warm_up()
    run.release()
    ref = run.reference("float32")
    np.testing.assert_allclose(run.first_losses, ref["losses"], rtol=2e-6)
    for k in run.init:
        scale = float(ref["grad"][k].abs().max()) + 1e-30
        assert float((run.first_grad[k] - ref["grad"][k]).abs().max()) <= 1e-4 * scale, k
    # Adam moves an element whose gradient is round-off by the whole step
    # either way, so the leaves after the steps are held by norm.
    got = run.readings()
    assert got["loss_gap"] < 1e-5 and got["grad_gap"] < 1e-5 and got["change_gap"] < 1e-4


@pytest.mark.parametrize("workload", ["flex_render", "paper_render"])
def test_frames_match_the_system_in_float32(workload):
    run = RenderRun(float32_cell(workload), 7, "cpu",
                    sizes=dict(samples=12, image=12, warmup_frames=0, checked_frames=2))
    run.setup()
    run.window(0, frames=2)
    run.release()
    assert run.readings()["frame_mad_rel"] == 0.0


def test_the_control_is_rounded_and_the_reference_is_not():
    x = torch.linspace(-3, 3, 1001)
    assert torch.equal(nerf_plain.round_bf16(x), x.bfloat16().float())
    q = nerf_plain.round_fp8(x, torch.float8_e4m3fn)
    assert 0 < float((q - x).abs().max()) < 3 / 8
    assert len(torch.unique(q)) < len(torch.unique(nerf_plain.round_bf16(x)))
    w = {"l.weight": torch.randn(5, 7), "l.bias": torch.randn(5)}
    h = torch.randn(3, 7)
    exact = nerf_plain.dense(h, w, "l", "float32")
    torch.testing.assert_close(exact, h @ w["l.weight"].T + w["l.bias"])
    assert not torch.equal(nerf_plain.dense(h, w, "l", "bfloat16"), exact)


def test_the_scene_is_the_systems_synthetic_scene():
    from nerf_tpu_torch.data import flatten_rays, make_synthetic_dataset

    ds = make_synthetic_dataset(num_views=3, height=10, width=12, seed=5)
    ro, rd, rgb = (torch.as_tensor(a) for a in flatten_rays(ds))
    poses = torch.as_tensor(ds.poses)
    want = scene.render_views(poses, 10, 12)
    # Same rays from the same poses, the same colours of the same field
    # (the system's focal is its width's too).
    torch.testing.assert_close(want[0], ro, atol=1e-6, rtol=0)
    torch.testing.assert_close(want[1], rd, atol=2e-6, rtol=0)
    torch.testing.assert_close(want[2], rgb, atol=2e-5, rtol=0)
    np.testing.assert_allclose(scene.view_poses(3, 5), ds.poses, atol=1e-6)
