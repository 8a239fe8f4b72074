"""nerf_tpu_torch.serve_nerf, the HTTP render server, against the JAX server.

The port's ``RenderService`` on the CPU (``renderer="plain"``) serves a
checkpoint the JAX package wrote (the fixture of tests/test_serve.py) and
must render the frames the JAX ``RenderService(renderer="xla")`` renders:
u8 values within one level everywhere (f32 sums in another order move a
value across a truncation boundary) and equal at >= 99% of values. Requests
go through a real socket (urllib): routes, PNG payloads, the 400/404/503
contract, the --logdir hot swap and a stalled client.
"""

import io
import json
import os
import socket
import sys
import threading
import urllib.error
import urllib.request

import imageio.v2 as imageio
import jax
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import serve_nerf as jax_serve  # noqa: E402
from nerf_tpu.config import load_config as jax_load_config  # noqa: E402
from nerf_tpu.engine.checkpoint import save_checkpoint as jax_save_checkpoint  # noqa: E402
from nerf_tpu.models import FlexibleNeRFModel as JaxFlexible  # noqa: E402
from nerf_tpu_torch import serve_nerf  # noqa: E402
from nerf_tpu_torch.config import load_config  # noqa: E402
from nerf_tpu_torch.engine.checkpoint import save_checkpoint  # noqa: E402
from nerf_tpu_torch.models import FlexibleNeRFModel  # noqa: E402
from nerf_tpu_torch.utils.profiling import RENDER_FIELD, RENDER_IMAGE, SERVE_REQUEST  # noqa: E402
from tests.test_torch_profiling import chrome_spans  # noqa: E402

torch.set_num_threads(1)
NARROW = dict(num_layers=2, hidden_size=16, num_encoding_fn_xyz=2, num_encoding_fn_dir=1)

_CFG = """
experiment:
  id: serve-test
  logdir: logs
  randomseed: 1
  train_iters: 1
  validate_every: 1
  save_every: 1
  print_every: 1
dataset:
  type: synthetic
  basedir: ""
  num_views: 2
  image_size: 24
  no_ndc: True
  near: 2
  far: 6
models:
  coarse:
    type: FlexibleNeRFModel
    num_layers: 2
    hidden_size: 16
    num_encoding_fn_xyz: 2
    num_encoding_fn_dir: 1
    use_viewdirs: True
optimizer:
  type: Adam
  lr: 5.0E-3
nerf:
  use_viewdirs: True
  train:
    num_random_rays: 32
    chunksize: 1024
    perturb: True
    num_coarse: 4
    num_fine: 0
    white_background: False
    radiance_field_noise_std: 0.0
    lindisp: False
  validation:
    chunksize: 1024
    perturb: False
    num_coarse: 4
    num_fine: 0
    white_background: False
    radiance_field_noise_std: 0.0
    lindisp: False
"""


def _jax_params(seed):
    return jax.tree.map(np.asarray, JaxFlexible(**NARROW).init(jax.random.PRNGKey(seed)))


def _service(cfg_path, **kwargs):
    return serve_nerf.RenderService(load_config(str(cfg_path)), renderer="plain", device="cpu",
                                    **kwargs)


def _assert_same_frame(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.99


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX-written checkpoint, both services, and the port's server."""
    cfg_path = tmp_path_factory.mktemp("cfg") / "serve.yml"
    cfg_path.write_text(_CFG)
    ckpt_path = str(tmp_path_factory.mktemp("ckpt") / "checkpoint00001.ntc")
    jax_save_checkpoint(ckpt_path, {"step": 1, "params_coarse": _jax_params(0),
                                    "params_fine": None})
    service = _service(cfg_path, checkpoint_path=ckpt_path)
    jax_service = jax_serve.RenderService(jax_load_config(str(cfg_path)), ckpt_path,
                                          renderer="xla")
    httpd = serve_nerf.serve(service, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}", service, jax_service, cfg_path
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=5)
    assert not thread.is_alive()


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as resp:
        return resp.status, resp.headers.get("Content-Type"), resp.read()


def _post_pose(base, pose):
    req = urllib.request.Request(base + "/pose", data=json.dumps({"pose": pose}).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.status, resp.read()


def _png(body):
    assert body[:8] == b"\x89PNG\r\n\x1a\n"
    return imageio.imread(io.BytesIO(body))


@pytest.mark.parametrize("which", ["frame0", "frame7", "orbit"])
def test_frames_match_the_jax_server(setup, which):
    _, service, jax_service, _ = setup
    if which == "orbit":
        got, want = (s.render_spherical(70.0, -20.0, 3.5) for s in (service, jax_service))
    else:
        index = int(which[len("frame"):])
        got, want = (s.render_frame(index) for s in (service, jax_service))
    assert got.shape == (service.height, service.width, 3) == (24, 24, 3)
    _assert_same_frame(got, want)


def test_endpoints_serve_the_services_frames(setup):
    base, service, _, _ = setup
    status, ctype, body = _get(base + "/")
    assert status == 200 and ctype == "text/html" and b"/render?theta=" in body
    status, ctype, body = _get(base + "/render?frame=3")
    assert status == 200 and ctype == "image/png"
    np.testing.assert_array_equal(_png(body), service.render_frame(3))
    status, _, body = _get(base + "/render?theta=30&phi=-30&radius=4")
    np.testing.assert_array_equal(_png(body), service.render_spherical(30.0, -30.0, 4.0))
    pose = np.asarray(service.poses[1], np.float32)[:3].tolist()
    status, body = _post_pose(base, pose)
    assert status == 200
    np.testing.assert_array_equal(_png(body), service.render_frame(1))
    status, ctype, body = _get(base + "/health")
    health = json.loads(body)
    assert status == 200 and ctype == "application/json"
    assert health["status"] == "ok" and health["devices"] == 1 and health["device"] == "cpu"
    assert health["checkpoint_step"] == 1 and health["frames_served"] >= 3
    assert health["last_render_s"] is not None and (health["height"], health["width"]) == (24, 24)


@pytest.mark.parametrize("path,data", [
    ("/render?frame=notanint", None),
    ("/pose", json.dumps({"pose": [[1.0, 2.0]]}).encode()),
    ("/pose", b"not json"),
    ("/pose", json.dumps([[1.0, 0.0, 0.0, 0.0]]).encode()),
], ids=["frame", "pose-shape", "not-json", "not-an-object"])
def test_bad_requests_are_400(setup, path, data):
    base = setup[0]
    req = urllib.request.Request(base + path, data=data,
                                 method="POST" if data is not None else "GET")
    with pytest.raises(urllib.error.HTTPError) as exc_info:
        urllib.request.urlopen(req, timeout=30)
    assert exc_info.value.code == 400
    assert "error" in json.loads(exc_info.value.read())


@pytest.mark.parametrize("method", ["GET", "POST"])
def test_unknown_route_404(setup, method):
    base = setup[0]
    req = urllib.request.Request(base + "/nope", data=b"{}" if method == "POST" else None,
                                 method=method)
    with pytest.raises(urllib.error.HTTPError) as exc_info:
        urllib.request.urlopen(req, timeout=30)
    assert exc_info.value.code == 404


def test_watch_logdir_hot_swaps_weights(setup, tmp_path):
    """A newer .ntc landing in the logdir changes what the next request
    renders, loaded into the live modules: the frame is the one a service
    built on the new checkpoint renders. The JAX writer writes the first, the
    port's writer the second."""
    cfg_path = setup[3]
    logdir = tmp_path / "run"
    logdir.mkdir()
    jax_save_checkpoint(str(logdir / "checkpoint00010.ntc"),
                        {"step": 10, "params_coarse": _jax_params(0), "params_fine": None})
    service = _service(cfg_path, watch_logdir=str(logdir))
    assert service.checkpoint_step == 10
    coarse = service.model_coarse
    img1 = service.render_frame(0)
    save_checkpoint(str(logdir / "checkpoint00020.ntc"),
                    {"step": 20, "params_coarse": _jax_params(123), "params_fine": None})
    img2 = service.render_frame(0)
    assert service.checkpoint_step == 20 and service.model_coarse is coarse
    assert service.checkpoint_path.endswith("checkpoint00020.ntc")
    assert not np.array_equal(img1, img2)
    fresh = _service(cfg_path, checkpoint_path=str(logdir / "checkpoint00020.ntc"))
    np.testing.assert_array_equal(img2, fresh.render_frame(0))
    np.testing.assert_array_equal(img2, service.render_frame(0))


def test_watch_logdir_takes_the_ports_ckpt_files(setup, tmp_path):
    """A logdir without .ntc files (a run of this package's trainer) is
    watched through its .ckpt files, read as reference checkpoints."""
    cfg_path = setup[3]
    logdir = tmp_path / "run"
    logdir.mkdir()

    def write(step, seed):
        model = FlexibleNeRFModel(num_encoding_fn_xyz=2, num_encoding_fn_dir=1,
                                  generator=torch.Generator().manual_seed(seed))
        torch.save({"iter": step, "model_coarse_state_dict": model.state_dict(),
                    "model_fine_state_dict": None}, str(logdir / f"checkpoint{step:05d}.ckpt"))

    write(5, 0)
    service = _service(cfg_path, watch_logdir=str(logdir))
    assert service.checkpoint_step == 5 and service.checkpoint_path.endswith(".ckpt")
    img1 = service.render_frame(2)
    write(6, 1)
    img2 = service.render_frame(2)
    assert service.checkpoint_step == 6 and not np.array_equal(img1, img2)


def test_watch_logdir_empty_raises(setup, tmp_path):
    with pytest.raises(ValueError, match="no .ntc"):
        _service(setup[3], watch_logdir=str(tmp_path))
    with pytest.raises(ValueError, match="need checkpoint_path or watch_logdir"):
        _service(setup[3])


def test_watch_checkpoint_vanished_is_503(setup, tmp_path, monkeypatch):
    """The newest checkpoint pruned between the logdir listing and the open:
    a structured 503 for GET and POST, not a 500."""
    cfg_path = setup[3]
    logdir = tmp_path / "run"
    logdir.mkdir()
    save_checkpoint(str(logdir / "checkpoint00010.ntc"),
                    {"step": 10, "params_coarse": _jax_params(0), "params_fine": None})
    service = _service(cfg_path, watch_logdir=str(logdir))
    monkeypatch.setattr(serve_nerf, "newest_checkpoint",
                        lambda d: os.path.join(d, "checkpoint00020.ntc"))
    httpd = serve_nerf.serve(service, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        with pytest.raises(urllib.error.HTTPError) as exc_info:
            urllib.request.urlopen(base + "/render?frame=0", timeout=30)
        assert exc_info.value.code == 503
        assert "checkpoint vanished" in json.loads(exc_info.value.read())["error"]
        with pytest.raises(urllib.error.HTTPError) as exc_info:
            _post_pose(base, np.eye(4, dtype=np.float32)[:3].tolist())
        assert exc_info.value.code == 503
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=5)
    assert not thread.is_alive()


def test_stalled_client_does_not_wedge_health(setup):
    """A client that connects and never finishes its request holds only its
    own handler thread: /health and renders keep answering."""
    base = setup[0]
    host, port = base.removeprefix("http://").split(":")
    stalled = socket.create_connection((host, int(port)), timeout=30)
    try:
        stalled.sendall(b"GET /health HTTP/1.1\r\nHost: x\r\n")
        status, _, body = _get(base + "/health")
        assert status == 200 and json.loads(body)["status"] == "ok"
        status, ctype, _ = _get(base + "/render?frame=1")
        assert status == 200 and ctype == "image/png"
    finally:
        stalled.close()


def test_concurrent_renders_serialize_on_the_device_lock(setup):
    base, service = setup[0], setup[1]
    before = service.frames_served
    results = [None] * 4

    def fetch(i):
        results[i] = _get(base + f"/render?theta={40 + 10 * i}&phi=-30&radius=4")

    threads = [threading.Thread(target=fetch, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert all(r[0] == 200 and r[2][:8] == b"\x89PNG\r\n\x1a\n" for r in results)
    assert service.frames_served == before + 4



def test_a_request_spans_the_service_the_image_and_its_fields(setup, tmp_path):
    service = setup[1]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        service.render_pose(service.poses[3])
    spans = chrome_spans(prof, tmp_path)
    (request, r0, r1), (image, i0, i1) = spans[:2]
    assert (request, image) == (SERVE_REQUEST, RENDER_IMAGE)
    assert r0 <= i0 and i1 <= r1 + 1e-3
    fields = spans[2:]
    chunks = -(-service.height * service.width // service.settings.chunksize)
    assert [f[0] for f in fields] == [RENDER_FIELD] * chunks     # coarse alone: num_fine 0
    assert all(i0 <= f[1] and f[2] <= i1 + 1e-3 for f in fields)

def test_viewer_html_variants():
    orbit = serve_nerf.viewer_html(ndc=False, num_frames=40)
    assert "/render?theta=" in orbit and "/render?frame" not in orbit
    ndc = serve_nerf.viewer_html(ndc=True, num_frames=120)
    assert "/render?frame=" in ndc and 'max="119"' in ndc and "theta" not in ndc


def test_cli_takes_the_ports_flags():
    with pytest.raises(SystemExit):
        serve_nerf.main(["--config", "x.yml", "--checkpoint", "c.ntc", "--renderer", "pallas"])
    with pytest.raises(SystemExit):
        serve_nerf.main(["--config", "x.yml"])     # neither --checkpoint nor --logdir
