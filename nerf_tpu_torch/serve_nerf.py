"""Serve novel-view renders of a trained NeRF checkpoint over HTTP (port of
``serve_nerf.py``).

Load a checkpoint once, then serve frames on demand: each request is one
(3, 4) pose upload, one render on the device through the renderer's kernel
path (``engine.renderer.make_pose_render_fn(..., output="u8")``, so the
4x128 FlexibleNeRF's frames run ``kernels/mlp_t.fused_mlp_t``) and one uint8
image fetch, encoded as PNG on the host (``utils/png.py``).

Endpoints:
  GET  /                render?theta/phi/radius orbit viewer (HTML, no deps)
  GET  /render?frame=i  i-th pose of the dataset's render trajectory
  GET  /render?theta=45&phi=-30&radius=4
                        spherical pose (non-NDC scenes; NDC scenes must use
                        frame= or POST /pose: an orbit exits their frustum)
  POST /pose            body {"pose": [[...], [...], [...]]} (3x4 or 4x4
                        camera-to-world) -> PNG
  GET  /health          JSON status + per-frame latency stats

Client errors answer 400 with a JSON ``error``, a checkpoint that vanished
between the logdir listing and the open 503, an unknown route 404.

Socket I/O is threaded (``ThreadingHTTPServer``): a stalled or slow-reading
client holds only its own connection thread, never the device, so
``/health`` and other renders keep answering. Renders are serialized by one
device lock.

``--num-devices N`` shards each frame over N ranks, one a device
(``engine.renderer.make_pose_render_fn`` with a mesh; under ``torchrun`` its group,
else N spawned ranks): rank 0 runs the HTTP server and the device lock, and
for each frame broadcasts a small command (render this pose, reload this
checkpoint, stop) to the other ranks, which wait in
``RenderService.follow``; every rank renders its slice of the pixels and
rank 0 assembles the frame and writes the PNG. ``/health`` reports
``"devices": N``. While idle, rank 0 sends a no-op every ``HEARTBEAT_S``
seconds, so the followers' waits stay inside the group's timeout, and on
the way out it always sends stop.

``--logdir`` (instead of ``--checkpoint``) watches a training run: each
request renders the run's newest ``checkpoint*.ntc`` (what either package's
trainer writes), or, in a logdir that holds none, its newest
``checkpoint*.ckpt``, loading new weights into the live modules when one
lands.

Usage:
  python -m nerf_tpu_torch.serve_nerf --config cfg.yml --checkpoint ckpt.ntc
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import signal
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch
import torch.distributed as dist

from .config import load_config, render_settings_from_config
from .data import pose_spherical, resolve_render_poses
from .engine.checkpoint import (
    latest_checkpoint,
    load_checkpoint,
    load_jax_params,
    load_models_and_params,
    load_reference_checkpoint,
)
from .engine.renderer import make_pose_render_fn
from .parallel.distributed import add_mesh_args, run_cli
from .parallel.mesh import Mesh, make_mesh
from .utils.png import png_bytes
from .utils.profiling import SERVE_REQUEST, annotate

HEARTBEAT_S = 10.0   # an idle mesh server's no-op period (inside the group's timeout)

_VIEWER_STYLE = """<style>
body{font-family:sans-serif;margin:2em;background:#111;color:#eee}
img{image-rendering:auto;border:1px solid #444;max-width:90vw}
label{margin-right:1.5em}</style>"""

_VIEWER_SCRIPT = """<script>
const img=document.getElementById('img');let busy=false,queued=null;
function done(u){busy=false;if(u)img.src=u;if(queued){queued=null;go()}}
function go(){if(busy){queued=url();return}busy=true;
  const u=url();const i=new Image();
  i.onload=()=>done(u);
  i.onerror=()=>done(null);  // a failed frame must not wedge the viewer
  i.src=u}
for(const el of controls) el.addEventListener('input',go);
</script></body></html>"""


def viewer_html(ndc: bool, num_frames: int) -> str:
    """The / page: orbit sliders for free-orbit scenes; a trajectory-frame
    slider for NDC (forward-facing) scenes, whose frustum an orbit exits."""
    head = (f"<!doctype html><html><head><title>nerf_tpu viewer</title>"
            f"{_VIEWER_STYLE}</head><body>"
            f"<h3>nerf_tpu — live checkpoint viewer</h3>")
    if ndc:
        return (
            head
            + f"""<div>
<label>frame <input id="f" type="range" min="0" max="{num_frames - 1}" value="0"></label>
</div>
<p><img id="img" src="/render?frame=0" alt="render"></p>
<script>const controls=[f];
function url(){{return `/render?frame=${{f.value}}`}}</script>"""
            + _VIEWER_SCRIPT
        )
    return (
        head
        + """<div>
<label>theta <input id="t" type="range" min="0" max="360" value="45"></label>
<label>phi <input id="p" type="range" min="-90" max="0" value="-30"></label>
<label>radius <input id="r" type="range" min="2" max="8" step="0.25" value="4"></label>
</div>
<p><img id="img" src="/render?theta=45&phi=-30&radius=4" alt="render"></p>
<script>const controls=[t,p,r];
function url(){return `/render?theta=${t.value}&phi=${p.value}&radius=${r.value}`}</script>"""
        + _VIEWER_SCRIPT
    )


def newest_checkpoint(logdir: str) -> Optional[str]:
    """The logdir's highest-step ``checkpoint*.ntc``, else its highest-step
    ``checkpoint*.ckpt``, else None."""
    return latest_checkpoint(logdir, suffix=".ntc") or latest_checkpoint(logdir, suffix=".ckpt")


def _read_params(path: str) -> dict:
    return load_reference_checkpoint(path) if path.endswith(".ckpt") else load_checkpoint(path)


class RenderService:
    """Checkpoint + pose renderer + render-trajectory poses, on one device or
    a mesh of ranks.

    Separated from the HTTP layer so tests (and other frontends) can drive
    it directly: ``render_pose`` takes any (3|4, 4) camera-to-world matrix,
    ``render_spherical`` builds the standard orbit pose. ``renderer`` is
    "kernel" (the model family's CUDA kernel on a CUDA device) or "plain".
    With a ``mesh`` of more than one rank, rank 0's service renders (and
    commands the others) and every other rank's runs ``follow()`` until
    rank 0's ``stop()``.
    """

    def __init__(self, cfg, checkpoint_path: Optional[str] = None,
                 precision: str = "float32", renderer: str = "kernel",
                 watch_logdir: Optional[str] = None, device: str = "cuda",
                 mesh: Optional[Mesh] = None):
        if renderer not in ("kernel", "plain"):
            raise ValueError(f"renderer must be 'kernel' or 'plain', got {renderer!r}")
        self.watch_logdir = watch_logdir
        if checkpoint_path is None:
            if watch_logdir is None:
                raise ValueError("need checkpoint_path or watch_logdir")
            checkpoint_path = newest_checkpoint(watch_logdir)
            if checkpoint_path is None:
                raise ValueError(f"no .ntc (or .ckpt) checkpoints under {watch_logdir}")
        if mesh is not None and mesh.world_size > 1:
            # Every rank serves rank 0's checkpoint (a logdir may gain one
            # between the ranks' listings).
            box = [checkpoint_path]
            dist.broadcast_object_list(box, src=0, group=mesh.group)
            checkpoint_path = box[0]
        self.checkpoint_path = checkpoint_path
        self.device = torch.device(device)
        self.poses, h, w, focal = resolve_render_poses(cfg, "render")
        self.model_coarse, self.model_fine, ckpt = load_models_and_params(
            checkpoint_path, cfg, self.device)
        if checkpoint_path.endswith(".ckpt") and "height" in ckpt:
            # Optional hwf override keys (reference eval_nerf.py:138-143).
            h, w = int(ckpt["height"]), int(ckpt["width"])
            focal = float(ckpt["focal_length"])
        self.height, self.width, self.focal = h, w, focal
        self.settings = dataclasses.replace(
            render_settings_from_config(cfg, "validation", hwf=(h, w, focal)),
            compute_dtype=precision,
            use_pallas=(renderer == "kernel"),
        )
        self.use_ndc = self.settings.use_ndc
        # One rank commands no others: the service is then the serial one.
        self.mesh = mesh if mesh is not None and mesh.world_size > 1 else None
        self.num_devices = 1 if self.mesh is None else self.mesh.world_size
        self._render = make_pose_render_fn(self.model_coarse, self.model_fine, self.settings,
                                           h, w, focal, output="u8", mesh=self.mesh)
        step = ckpt.get("step", ckpt.get("iter"))
        self.checkpoint_step = None if step is None else int(step)
        self.frames_served = 0
        self.last_render_s: Optional[float] = None
        # One device, one render at a time: request handlers run in threads,
        # so the reload check, the render and the latency bookkeeping are
        # serialized here. Socket I/O stays outside the lock.
        self._device_lock = threading.Lock()
        self._stopped = threading.Event()
        self._last_command = time.monotonic()
        self.compile_s = 0.0
        if self.mesh is not None and not self.mesh.is_primary:
            return   # a follower renders what rank 0 commands (follow)
        # Warm up (the kernels' build and first launch) before accepting
        # traffic, so the first request does not look like an outage.
        t0 = time.perf_counter()
        self.render_pose(self.poses[0])
        self.compile_s = time.perf_counter() - t0
        self.frames_served = 0
        if self.mesh is not None:
            threading.Thread(target=self._heartbeat, daemon=True).start()

    def _on_device(self):
        """The current device is per thread: set it in the caller's thread."""
        return (torch.cuda.device(self.device) if self.device.type == "cuda"
                else contextlib.nullcontext())

    def _command(self, cmd: tuple) -> None:
        """Rank 0: send one command to every other rank (under the lock)."""
        if self.mesh is None:
            return
        with self._on_device():
            dist.broadcast_object_list([cmd], src=0, group=self.mesh.group)
        self._last_command = time.monotonic()

    def _heartbeat(self) -> None:
        while not self._stopped.wait(HEARTBEAT_S / 2):
            with self._device_lock:
                if (not self._stopped.is_set()
                        and time.monotonic() - self._last_command >= HEARTBEAT_S / 2):
                    self._command(("noop",))

    def stop(self) -> None:
        """Rank 0: tell the other ranks to leave ``follow`` (once)."""
        with self._device_lock:
            if self.mesh is not None and not self._stopped.is_set():
                self._command(("stop",))
            self._stopped.set()

    def follow(self) -> None:
        """A rank other than 0: carry out rank 0's commands until stop."""
        while True:
            cmd = [None]
            with self._on_device():
                dist.broadcast_object_list(cmd, src=0, group=self.mesh.group)
            op = cmd[0][0]
            if op == "render":
                self._render_on_device(cmd[0][1])
            elif op == "reload":
                self._load(cmd[0][1])
            elif op == "stop":
                return

    def _load(self, path: str) -> None:
        """Load ``path``'s weights into the live modules (strictly: a
        checkpoint of another shape raises)."""
        ckpt = _read_params(path)
        if self.model_fine is not None and ckpt.get("params_fine") is None:
            raise RuntimeError(f"{path} has no fine model, but one is being served")
        load_jax_params(self.model_coarse, ckpt["params_coarse"])
        if self.model_fine is not None:
            load_jax_params(self.model_fine, ckpt["params_fine"])
        self.checkpoint_path = path
        step = ckpt.get("step")
        self.checkpoint_step = None if step is None else int(step)

    def _render_on_device(self, pose34: np.ndarray) -> Optional[np.ndarray]:
        """This rank's part of one frame; the (H, W, 3) uint8 image on rank 0."""
        with self._on_device(), torch.inference_mode():
            img = self._render(torch.as_tensor(pose34, device=self.device))
            return None if img is None else img.cpu().numpy()

    def _maybe_reload(self) -> None:
        """Watch mode: load the logdir's newest checkpoint, if it is new, into
        the live modules, then have the other ranks load it too."""
        if self.watch_logdir is None:
            return
        newest = newest_checkpoint(self.watch_logdir)
        if newest is None or newest == self.checkpoint_path:
            return
        self._load(newest)
        self._command(("reload", newest))
        print(f"[serve] reloaded {newest} (step {self.checkpoint_step})", flush=True)

    def render_pose(self, pose) -> np.ndarray:
        """(3|4, 4) camera-to-world -> (H, W, 3) uint8."""
        with annotate(SERVE_REQUEST):
            pose = np.asarray(pose, np.float32)
            if pose.shape not in ((3, 4), (4, 4)):
                raise ValueError(f"pose must be (3, 4) or (4, 4), got {pose.shape}")
            with self._device_lock:
                if self._stopped.is_set():
                    raise RuntimeError("the render service has stopped")
                self._maybe_reload()
                t0 = time.perf_counter()
                pose34 = np.ascontiguousarray(pose[:3, :4])
                self._command(("render", pose34))
                img = self._render_on_device(pose34)
                self.last_render_s = time.perf_counter() - t0
                self.frames_served += 1
            return img

    def render_frame(self, index: int) -> np.ndarray:
        return self.render_pose(self.poses[index % len(self.poses)])

    def render_spherical(self, theta: float, phi: float, radius: float) -> np.ndarray:
        if self.use_ndc:
            raise ValueError(
                "spherical orbit poses exit an NDC (forward-facing) scene's "
                "frustum; use frame= or POST /pose"
            )
        return self.render_pose(pose_spherical(theta, phi, radius))

    def health(self) -> dict:
        return {
            "status": "ok",
            "devices": self.num_devices,
            "device": str(self.device),
            "checkpoint": self.checkpoint_path,
            "checkpoint_step": self.checkpoint_step,
            "watching": self.watch_logdir,
            "height": self.height,
            "width": self.width,
            "focal": round(self.focal, 2),
            "ndc": bool(self.use_ndc),
            "trajectory_frames": int(len(self.poses)),
            "frames_served": self.frames_served,
            "compile_s": round(self.compile_s, 1),
            "last_render_s": (round(self.last_render_s, 3)
                              if self.last_render_s is not None else None),
        }


def make_handler(service: RenderService):
    class Handler(BaseHTTPRequestHandler):
        # A silent client (connected, never sends a request line) must not
        # hold its handler thread forever: close the connection after this
        # many seconds of socket inactivity.
        timeout = 120

        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code: int, obj) -> None:
            self._send(code, json.dumps(obj).encode(), "application/json")

        def _respond(self, fn) -> None:
            """Shared error contract for GET and POST: client-caused
            failures -> 400; the watch-mode checkpoint-vanished race -> 503
            (the newest checkpoint was pruned between the logdir listing and
            the open: the next request finds a newer one)."""
            try:
                fn()
            except (ValueError, KeyError, TypeError, json.JSONDecodeError) as e:
                # TypeError covers a non-object JSON body (body["pose"] on a
                # bare list): still the client's malformed input.
                self._send_json(400, {"error": str(e)})
            except FileNotFoundError as e:
                self._send_json(503, {"error": f"checkpoint vanished: {e}"})

        def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler API
            url = urlparse(self.path)

            def handle():
                if url.path == "/":
                    html = viewer_html(service.use_ndc, len(service.poses))
                    self._send(200, html.encode(), "text/html")
                elif url.path == "/health":
                    self._send_json(200, service.health())
                elif url.path == "/render":
                    q = parse_qs(url.query)
                    if "frame" in q:
                        img = service.render_frame(int(q["frame"][0]))
                    else:
                        img = service.render_spherical(
                            float(q.get("theta", ["45"])[0]),
                            float(q.get("phi", ["-30"])[0]),
                            float(q.get("radius", ["4"])[0]),
                        )
                    self._send(200, png_bytes(img), "image/png")
                else:
                    self._send_json(404, {"error": f"no route {url.path}"})

            self._respond(handle)

        def do_POST(self):  # noqa: N802
            url = urlparse(self.path)
            if url.path != "/pose":
                self._send_json(404, {"error": f"no route {url.path}"})
                return

            def handle():
                length = int(self.headers.get("Content-Length", "0"))
                body = json.loads(self.rfile.read(length) or b"{}")
                img = service.render_pose(np.asarray(body["pose"], np.float32))
                self._send(200, png_bytes(img), "image/png")

            self._respond(handle)

        def log_message(self, fmt, *fmt_args):
            print(f"[serve] {self.address_string()} {fmt % fmt_args}", flush=True)

    return Handler


def serve(service: RenderService, host: str, port: int) -> ThreadingHTTPServer:
    """Bind and return the HTTP server; the caller runs ``serve_forever()``
    (a test binds port 0 and serves from a thread)."""
    class Server(ThreadingHTTPServer):
        daemon_threads = True  # a hung client thread never blocks exit

        def handle_error(self, request, client_address):
            # A client that disconnects mid-response (or times out mid-
            # request) is routine at this layer: one log line, no traceback.
            exc = sys.exception()
            if isinstance(exc, (BrokenPipeError, ConnectionResetError, TimeoutError)):
                print(f"[serve] {client_address[0]} dropped: {exc!r}", flush=True)
                return
            super().handle_error(request, client_address)

    return Server((host, port), make_handler(service))


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", type=str, required=True)
    src = parser.add_mutually_exclusive_group(required=True)
    src.add_argument("--checkpoint", type=str,
                     help="Serve this checkpoint (.ntc or reference .ckpt).")
    src.add_argument("--logdir", type=str,
                     help="Watch a training run's logdir: serve its newest .ntc (else "
                          ".ckpt) checkpoint and load newer weights as they land.")
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8642)
    parser.add_argument("--precision", choices=["bfloat16", "float32"], default="bfloat16",
                        help="MLP matmul input dtype (sums stay float32); serving "
                             "defaults to bfloat16.")
    parser.add_argument("--renderer", choices=["kernel", "plain"], default="kernel",
                        help="kernel: the model family's CUDA kernel (the JAX CLI's "
                             "pallas); plain: positional encoding + the module.")
    parser.add_argument("--device", type=str, default="cuda")
    add_mesh_args(parser, "Ranks to shard each frame over.")
    parser.add_argument("--overrides", type=str, nargs="*", default=None,
                        help="Dotted-key config overrides, e.g. nerf.validation.num_coarse 32")
    try:
        run_cli(serve_rank, parser.parse_args(argv))
    except KeyboardInterrupt:   # the spawning launcher's; a rank 0 stops its followers
        print("\nshut down")


def serve_rank(args: argparse.Namespace) -> None:
    """One rank of the server: rank 0 (or the only process) serves HTTP
    until interrupted and then stops the other ranks, which follow it."""
    mesh = make_mesh(args.num_devices, args.device, args.dist_backend)
    cfg = load_config(args.config, args.overrides)
    if mesh.is_primary:
        print("loading checkpoint + warming up the renderer...", flush=True)
    service = RenderService(cfg, args.checkpoint, precision=args.precision,
                            renderer=args.renderer, watch_logdir=args.logdir,
                            device=mesh.device, mesh=mesh)
    if not mesh.is_primary:
        # Ctrl-C reaches every rank; a follower leaves on rank 0's stop.
        signal.signal(signal.SIGINT, signal.SIG_IGN)
        service.follow()
        return
    try:
        httpd = serve(service, args.host, args.port)
        h = service.health()
        print(f"serving {h['height']}x{h['width']} renders on "
              f"http://{args.host}:{httpd.server_address[1]}/ on {h['device']} x "
              f"{h['devices']} (warm-up {h['compile_s']}s; open in a browser for the orbit "
              "viewer)", flush=True)
        try:
            httpd.serve_forever()
        except KeyboardInterrupt:
            print("\nshutting down", flush=True)
        finally:
            httpd.server_close()
    finally:
        service.stop()


if __name__ == "__main__":
    main()
