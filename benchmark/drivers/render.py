"""The ``render`` driver: frames served by ``serve_nerf.RenderService``.

Set-up makes both fields' weights from the seed on the device (opacified,
so that the frames are not empty), writes them as the system's ``.ntc``
checkpoint under ``TMPDIR``, and starts the service on it, at the
configuration's validation precision through the kernels; the service
renders one frame before it takes traffic, and ``warmup_frames`` more follow.
The window is a closed loop of one client, a viewer: each pose of the
orbit in turn, from an offset drawn from the seed, is handed to
``RenderService.render_pose`` and waited for until its uint8 image is on
the host, until ``--seconds`` have passed.

What is compared, once the window has closed and the service is freed:
``checked_frames`` frames of the window drawn from the seed against the
plain reference's frames of the same poses from the same weights.
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..harness import trace as tr
from ..reference import nerf_plain
from ..traffic.scene import focal_length, pose_spherical
from .common import (check, launch_checks, program_config, read_counters, seed_fields, sized,
                     sync, zero_counters)


def orbit(poses: int, phi: float, radius: float) -> np.ndarray:
    """(poses, 3, 4): the render orbit, thetas evenly spaced over the circle."""
    thetas = np.linspace(-180.0, 180.0, poses + 1)[:-1]
    return np.stack([pose_spherical(t, phi, radius)[:3, :4] for t in thetas])


class RenderRun:
    def __init__(self, cell, seed: int, device, faults: Sequence[str] = (),
                 sizes: Optional[Dict] = None):
        self.seed = int(seed)
        self.device = torch.device(device)
        self.faults = set(faults)
        self.model_type = cell.model
        self.config, self.traffic = sized(cell.config, cell.traffic, sizes)
        self.frames: List[np.ndarray] = []
        self.pose_ids: List[int] = []
        self.frames_done = 0
        self.phases = {}

    def setup(self) -> None:
        t0 = time.perf_counter()
        from nerf_tpu_torch.config import model_from_config
        from nerf_tpu_torch.engine.checkpoint import convert_torch_state_dict, save_checkpoint
        from nerf_tpu_torch.serve_nerf import RenderService

        self.phases["import"] = time.perf_counter() - t0
        t, cfg, dev = self.traffic, program_config(self.config), self.device
        ds = self.config["dataset"]
        self.height, self.width = int(ds["height"]), int(ds["width"])
        self.focal = focal_length(self.width)
        self.poses = orbit(int(t["poses"]), float(t["phi"]), float(t["radius"]))
        self.offset = self.seed % len(self.poses)
        mc = model_from_config(cfg.models.coarse).to(dev)
        mf = model_from_config(cfg.models.fine).to(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        seed_fields(self.model_type, [mc, mf], self.seed, dev, opacify=True)
        self.weights = ({k: p.detach().clone() for k, p in mc.named_parameters()},
                        {k: p.detach().clone() for k, p in mf.named_parameters()})
        fd, path = tempfile.mkstemp(suffix=".ntc", prefix="bench_weights_")
        os.close(fd)
        try:
            save_checkpoint(path, {"step": 0,
                                   "params_coarse": convert_torch_state_dict(mc.state_dict()),
                                   "params_fine": convert_torch_state_dict(mf.state_dict())})
            del mc, mf
            t1 = time.perf_counter()
            self.service = RenderService(
                cfg, path, precision=str(cfg.nerf.validation.compute_dtype),
                renderer="kernel", device=str(dev))
            self.phases["service"] = time.perf_counter() - t1
        finally:
            os.unlink(path)
        self.counters = self.model_type.plugin.render_counters()
        if "altered" in self.faults:
            produce = self.service._render_on_device
            self.service._render_on_device = lambda pose: produce(pose)[:, ::-1]
        chunk = int(cfg.nerf.validation.chunksize)
        # Each chunk of a frame's rays evaluates the coarse and the fine field once.
        self.evaluations_per_frame = 2 * -(-self.height * self.width // chunk)

    def warm_up(self) -> None:
        for i in range(int(self.traffic["warmup_frames"])):
            self.service.render_pose(self.poses[(self.offset + i) % len(self.poses)])
        sync(self.device)
        zero_counters(self.counters)

    def _frame(self, i: int):
        pid = (self.offset + i) % len(self.poses)
        return pid, self.service.render_pose(self.poses[pid])

    def window(self, seconds: float, frames: Optional[int] = None) -> Dict:
        """The closed loop: frames until ``seconds`` have passed (or
        ``frames`` frames)."""
        lat = []
        t0 = time.perf_counter()
        while True:
            s = time.perf_counter()
            pid, img = self._frame(len(self.frames))
            lat.append(time.perf_counter() - s)
            self.frames.append(img)
            self.pose_ids.append(pid)
            done = len(self.frames) >= frames if frames else time.perf_counter() - t0 >= seconds
            if done:
                break
        elapsed = time.perf_counter() - t0
        n = len(self.frames)
        self.frames_done += n
        bad = sum(1 for f in self.frames if f is None or f.shape != (self.height, self.width, 3))
        return {"seconds": elapsed, "frames": n, "failed": bad,
                "frame_ms": 1e3 * elapsed / n,
                "frame_p95_ms": 1e3 * float(np.quantile(np.asarray(lat), 0.95)),
                "frame_p50_ms": 1e3 * float(np.median(lat))}

    def traced(self) -> Dict:
        n = int(self.traffic["traced_frames"])
        start = self.frames_done

        def body():
            for i in range(n):
                self._frame(start + i)
            sync(self.device)

        trace = tr.record(body, self.device.type == "cuda")
        self.frames_done += n
        return {"trace": trace, "frames": n}

    def release(self) -> None:
        self.counts = read_counters(self.counters)
        del self.service
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def checked(self) -> List[int]:
        """Indices of the window's frames that are compared, drawn from the
        seed."""
        rng = np.random.default_rng(self.seed)
        k = min(int(self.traffic["checked_frames"]), len(self.frames))
        return sorted(rng.choice(len(self.frames), size=k, replace=False).tolist())

    def reference_frame(self, pid: int, precision: str) -> np.ndarray:
        pose = torch.as_tensor(self.poses[pid], device=self.device)
        return nerf_plain.render_frame(
            self.model_type.field, self.config, self.weights[0], self.weights[1], pose,
            self.height, self.width, self.focal, precision,
            chunk=int(self.traffic["reference_chunk"])).cpu().numpy()

    @property
    def precision(self) -> str:
        return str(self.config["nerf"]["validation"].get("compute_dtype", "float32"))

    def readings(self, control: str = "") -> Dict:
        """``frame_mad_rel``: over the checked frames, the worst frame's mean
        absolute difference from the reference's frame at the
        configuration's precision, in uint8 levels, over the difference
        between the reference's frames at that precision and at float32 (how
        far rounding to the configured precision moves this frame at all; a
        floor of 0.01 levels, which a float32 configuration divides by).
        With ``control``, of the reference at that precision in the
        system's place."""
        rel = 0.0
        for i in self.checked():
            pid = self.pose_ids[i]
            want = self.reference_frame(pid, self.precision).astype(np.float64)
            got = (self.reference_frame(pid, control) if control
                   else self.frames[i]).astype(np.float64)
            exact = (want if self.precision == "float32"
                     else self.reference_frame(pid, "float32").astype(np.float64))
            rounding = max(float(np.abs(want - exact).mean()), 0.01)
            rel = max(rel, float(np.abs(got - want).mean()) / rounding)
        return {"frame_mad_rel": rel}

    def checks(self, limits: Dict, readings: Dict) -> List[Dict]:
        return [*(check(k, readings[k], limit) for k, limit in limits.items()),
                *launch_checks(self.counters, self.counts,
                               self.evaluations_per_frame * self.frames_done)]
