"""Instant-NGP's hash-grid field in the port (``models/hashgrid.py``,
``ops/encoding.py``, ``kernels/hashgrid.py``) against the benchmark's plain
reference field (``benchmark/reference/fields/HashGridNeRFModel.py``), which
imports nothing of the port, at a small size: 4 levels, T = 2^10 rows a
level, resolutions 4 to 64 (level 0 dense, levels 1-3 hashed).

The cases marked ``cuda`` hold the kernel pair to the plain version on the
card and skip without one; there, where JAX is not installed, run

    python -m pytest tests/test_torch_hashgrid.py -m cuda --noconftest -q

This file imports torch, the port, the benchmark's reference and
``chip_smoke`` (its config and its bound for the atomics' order) only.
"""

import dataclasses
import math
import os

import numpy as np
import pytest
import torch

import chip_smoke
from benchmark.reference.fields import HashGridNeRFModel as reference
from nerf_tpu_torch.config import get_default_config, load_config, model_from_config
from nerf_tpu_torch.engine import train as engine_train
from nerf_tpu_torch.engine.checkpoint import (convert_torch_state_dict,
                                              export_reference_checkpoint,
                                              load_models_and_params, save_checkpoint,
                                              to_torch_state_dict)
from nerf_tpu_torch.engine.renderer import RenderSettings, render_rays
from nerf_tpu_torch.kernels import hashgrid
from nerf_tpu_torch.models import HashGridNeRFModel
from nerf_tpu_torch.ops import encoding

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(num_levels=4, features_per_level=2, log2_hashmap_size=10, base_resolution=4,
             max_resolution=64, hidden_size=64, density_outputs=16, sh_degree=4, box=1.5)
PUBLISHED = dict(num_levels=16, features_per_level=2, log2_hashmap_size=19, base_resolution=16,
                 max_resolution=2048, hidden_size=64, density_outputs=16, sh_degree=4, box=1.5)


def grid_of(shape):
    keys = ("num_levels", "features_per_level", "log2_hashmap_size", "base_resolution",
            "max_resolution", "box")
    return encoding.hash_grid(**{k: shape[k] for k in keys})


def small_model(seed=0, table_scale=1.0, **kw):
    """The small field, its table drawn U(-scale, scale) so that features
    are not near 0 and a wrong row shows."""
    gen = torch.Generator().manual_seed(seed)
    m = HashGridNeRFModel(**dict(SMALL, **kw), generator=gen)
    with torch.no_grad():
        m.table.uniform_(-table_scale, table_scale, generator=gen)
    return m


def inputs(n=6, s=40, seed=1, spread=1.8):
    """Points (n, s, 3) in [-spread, spread]^3 (some outside the cube) and
    unit directions (n, 3)."""
    gen = torch.Generator().manual_seed(seed)
    pts = (torch.rand(n, s, 3, generator=gen) * 2 - 1) * spread
    vd = torch.nn.functional.normalize(torch.randn(n, 3, generator=gen), dim=-1)
    return pts, vd


def reference_out(model, pts, vd, precision="float32"):
    weights = {k: v for k, v in model.named_parameters()}
    return reference.field(SMALL, weights, pts, vd, precision)


def test_plain_field_equals_the_reference_in_f32():
    model = small_model()
    pts, vd = inputs()
    cot = torch.randn(pts.shape[0], pts.shape[1], 4, generator=torch.Generator().manual_seed(2))
    got = model(pts, vd)
    names = [k for k, _ in model.named_parameters()]
    grads = torch.autograd.grad((got * cot).sum(), list(model.parameters()))
    want = reference_out(model, pts, vd)
    want_grads = torch.autograd.grad((want * cot).sum(), list(model.parameters()))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    # Each gradient sums 240 points' terms, in other orders and from
    # positions that part by an ulp (the port multiplies by 1 / (2 box), the
    # reference divides): f32 rounding, 1e-5 of the leaf's largest element.
    for name, g, w in zip(names, grads, want_grads):
        assert w.abs().max() > 0, name
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5 * float(w.abs().max()), msg=name)


def test_levels_of_the_published_field():
    grid = grid_of(PUBLISHED)
    assert grid.resolutions == (16, 22, 30, 42, 58, 80, 111, 153, 212, 294, 406, 561, 776, 1072,
                                1482, 2048)
    assert grid.dense == (True,) * 5 + (False,) * 11
    assert grid.sizes[:6] == (4913, 12167, 29791, 79507, 205379, 2 ** 19)
    assert grid.num_entries == 6_098_925
    assert [r for r, _, _ in reference.grid_levels(PUBLISHED)] == list(grid.resolutions)


def test_the_dense_hashed_boundary_and_the_primes_on_hand_computed_corners():
    grid = grid_of(SMALL)
    assert grid.resolutions == (4, 10, 25, 64)
    assert grid.dense == (True, False, False, False)     # 5^3 = 125 <= 1024 < 11^3
    assert grid.sizes == (125, 1024, 1024, 1024) and grid.offsets == (0, 125, 1149, 2173)
    pts = torch.tensor([[0.13, -0.71, 1.07]])
    # u = (x + 1.5) / 3; level 0 (N = 4): p = (2.17, 1.05, 3.43), lower corner
    # (2, 1, 3), dense rows x + 5 (y + 5 z): 2 + 5 (1 + 15) = 82, ..., 113.
    rows, w = encoding.hash_corners(pts, grid, 0)
    assert rows[0].tolist() == [82, 83, 87, 88, 107, 108, 112, 113]
    torch.testing.assert_close(w.sum(), torch.tensor(1.0))
    # Level 1 (N = 10): p = (5.43, 2.63, 8.57), corner 0 = (5, 2, 8):
    # 2 * 2654435761 mod 2^32 = 1013904226, 8 * 805459861 mod 2^32 =
    # 2148711592; mod 1024: 866 and 168; 5 xor 866 xor 168 = 975; + 125.
    rows, _ = encoding.hash_corners(pts, grid, 1)
    assert (rows[0] - 125).tolist() == [975, 972, 446, 445, 858, 857, 299, 296]
    # The upper face: the lower corner is held to N - 1 and the far corner,
    # row (N, N, N), takes the whole weight.
    rows, w = encoding.hash_corners(torch.tensor([[1.5, 1.5, 1.5]]), grid, 0)
    assert rows[0, 7].item() == 4 + 5 * (4 + 5 * 4) and w[0, 7].item() == 1.0


def real_sh(l, m, d):
    """The real spherical harmonic Y_lm of unit vectors d (P, 3) from its
    closed form: sqrt(2) Re / Im of the complex Y_l^|m| with the
    Condon-Shortley phase, the associated Legendre function by its
    recurrence."""
    x, y, z = (d[:, i].numpy() for i in range(3))
    phi = np.arctan2(y, x)
    am = abs(m)
    pmm = (-1) ** am * math.prod(range(1, 2 * am, 2)) * (1 - z * z) ** (am / 2)
    if l == am:
        plm = pmm
    else:
        p1 = z * (2 * am + 1) * pmm
        prev, plm = pmm, p1
        for ll in range(am + 2, l + 1):
            prev, plm = plm, ((2 * ll - 1) * z * plm - (ll + am - 1) * prev) / (ll - am)
    norm = math.sqrt((2 * l + 1) / (4 * math.pi) * math.factorial(l - am) / math.factorial(l + am))
    if m == 0:
        return norm * plm
    trig = np.cos(am * phi) if m > 0 else np.sin(am * phi)
    return math.sqrt(2) * norm * plm * trig


def test_sh_against_closed_forms():
    gen = torch.Generator().manual_seed(3)
    d = torch.nn.functional.normalize(torch.randn(200, 3, generator=gen, dtype=torch.float64),
                                      dim=-1)
    got = encoding.sh_encode(d, 4).numpy()
    for l in range(4):
        for m in range(-l, l + 1):
            np.testing.assert_allclose(got[:, l * l + l + m], real_sh(l, m, d), atol=1e-12)
    torch.testing.assert_close(reference._sh16(d), torch.from_numpy(got))


def test_density_is_zero_outside_the_cube():
    model = small_model()
    pts, vd = inputs(spread=3.0)
    sigma = model(pts, vd)[..., 3]
    outside = (pts.abs() > 1.5).any(-1)
    assert outside.any() and (~outside).any()
    assert (sigma[outside] == 0).all() and (sigma[~outside] > 0).all()


def test_a_wrong_prime_fails_the_comparison(monkeypatch):
    model = small_model()
    pts, vd = inputs()
    want = reference_out(model, pts, vd)
    monkeypatch.setattr(encoding, "HASH_PRIMES", (1, 2654435761, 805459863))
    got = model(pts, vd)
    assert (got - want).abs().max() > 1e-3


def test_the_entry_on_the_cpu_is_the_plain_pair_and_refuses_point_gradients():
    model = small_model()
    pts, _ = inputs()
    flat = pts.reshape(-1, 3)
    g = torch.randn(flat.shape[0], 8, generator=torch.Generator().manual_seed(4))
    got = hashgrid.fused_hash_encode(model.table, flat, model.grid)
    (dt,) = torch.autograd.grad((got * g).sum(), [model.table])
    want = encoding.hash_encode(model.table, flat, model.grid)
    (wdt,) = torch.autograd.grad((want * g).sum(), [model.table])
    assert torch.equal(got, want)
    torch.testing.assert_close(dt, wdt, rtol=1e-6, atol=1e-7)
    assert hashgrid.fused_hash_encode(model.table, flat, model.grid, "bfloat16").dtype == \
        torch.bfloat16
    with pytest.raises(ValueError, match="no gradient for the points"):
        hashgrid.fused_hash_encode(model.table, flat.requires_grad_(True), model.grid)


def test_the_renderer_routes_the_encoding_by_the_flags(monkeypatch):
    calls = []
    plain = hashgrid.hash_encode_plain
    monkeypatch.setattr(hashgrid, "hash_encode_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    model = small_model()
    ro = torch.zeros(4, 3) + torch.tensor([0.0, 0.0, 4.0])
    rd = torch.nn.functional.normalize(torch.tensor([[0.0, 0.1, -1.0]]).expand(4, 3), dim=-1)
    s = RenderSettings(num_coarse=8, num_fine=8, perturb=False)
    plain_out = render_rays(model, model, ro, rd, s).rgb
    assert not calls
    kernel_out = render_rays(model, model, ro, rd, dataclasses.replace(s, use_pallas=True)).rgb
    assert len(calls) == 2 and torch.equal(plain_out, kernel_out)


def tiny_store(n=4096, seed=5):
    gen = torch.Generator().manual_seed(seed)
    ro = torch.tensor([0.0, 0.0, 4.0]).expand(n, 3).contiguous()
    rd = torch.nn.functional.normalize(
        torch.cat([torch.rand(n, 2, generator=gen) * 0.6 - 0.3, -torch.ones(n, 1)], 1), dim=-1)
    return ro, rd, torch.rand(n, 3, generator=gen)


def test_three_steps_of_the_train_loop_from_the_shipped_config(monkeypatch):
    calls = {"fwd": 0, "bwd": 0}
    for name, key in (("hash_encode_plain", "fwd"), ("hash_encode_plain_bwd", "bwd")):
        fn = getattr(hashgrid, name)

        def counted(*a, _fn=fn, _key=key, **k):
            calls[_key] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(hashgrid, name, counted)
    cfg = load_config(os.path.join(REPO, "configs", "lego_hashgrid.yml"))
    assert cfg.models.coarse.type == "HashGridNeRFModel"
    torch.manual_seed(0)
    mc, mf = model_from_config(cfg.models.coarse), model_from_config(cfg.models.fine)
    assert mc.grid.num_entries == 6_098_925
    from nerf_tpu_torch.config import optimizer_from_config, render_settings_from_config

    s = dataclasses.replace(render_settings_from_config(cfg, "train"), num_coarse=8, num_fine=8)
    assert s.use_pallas_train and s.compute_dtype == "bfloat16"
    state = engine_train.create_train_state(mc, mf, optimizer_from_config(cfg))
    before = mc.table.detach().clone()
    loop = engine_train.make_train_loop(mc, mf, s, 32, 3)
    state, metrics = loop(state, *tiny_store(), 7)
    assert torch.isfinite(metrics.loss).all() and metrics.loss.shape == (3,)
    assert calls == {"fwd": 6, "bwd": 6}       # 2 fields x 3 steps, each way
    assert not torch.equal(before, state.model_coarse.table.detach())


def test_chip_smoke_config_is_lego_hashgrid():
    want = load_config(os.path.join(REPO, "configs", "lego_hashgrid.yml"))
    got = chip_smoke.lego_hashgrid_config()
    for section in ("dataset", "models", "experiment", "optimizer", "scheduler"):
        assert got[section].to_dict() == want[section].to_dict(), section
    for mode in ("train", "validation"):
        assert got.nerf[mode].to_dict() == want.nerf[mode].to_dict(), mode
    assert got.nerf.use_viewdirs == want.nerf.use_viewdirs


def test_a_hash_field_checkpoint_loads_and_serves(tmp_path):
    from nerf_tpu_torch import serve_nerf

    cfg = get_default_config()
    cfg.set_new_allowed(True)
    cfg.merge_from_other_cfg(type(cfg)({
        "dataset": {"type": "synthetic", "num_views": 2, "image_size": 8},
        "models": {"coarse": dict(SMALL, type="HashGridNeRFModel"),
                   "fine": dict(SMALL, type="HashGridNeRFModel")},
        "nerf": {"validation": {"num_coarse": 8, "num_fine": 8, "chunksize": 1024}},
    }))
    mc, mf = small_model(seed=1, table_scale=0.5), small_model(seed=2, table_scale=0.5)
    params = {"step": np.asarray(7), "params_coarse": convert_torch_state_dict(mc.state_dict()),
              "params_fine": convert_torch_state_dict(mf.state_dict())}
    assert set(params["params_coarse"]) == {"table", "density_net", "color_net"}
    assert set(to_torch_state_dict(params["params_coarse"])) == set(mc.state_dict())
    path = str(tmp_path / "checkpoint00007.ntc")
    save_checkpoint(path, params)
    # The reference-schema .ckpt the trainer writes beside it loads as well.
    ckpt = str(tmp_path / "checkpoint00007.ckpt")
    export_reference_checkpoint(ckpt, 7, mc, mf, 0.1, 10.0,
                                torch.optim.Adam([*mc.parameters(), *mf.parameters()]))
    for which in (path, ckpt):
        lc, lf, _ = load_models_and_params(which, cfg)
        for a, b in ((lc, mc), (lf, mf)):
            for k, v in b.state_dict().items():
                assert torch.equal(a.state_dict()[k], v), (which, k)
    service = serve_nerf.RenderService(cfg, path, renderer="plain", device="cpu")
    frame = service.render_frame(0)
    assert frame.shape == (8, 8, 3) and frame.dtype == np.uint8 and frame.std() > 0
    assert service.checkpoint_step == 7


# -- on the card -------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; run on the card (see module docstring)")
    return torch.device("cuda")


def _card_inputs(grid, n, seed, spread=1.7):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    pts = (torch.rand(n, 3, generator=gen, device="cuda") * 2 - 1) * spread
    table = torch.rand(grid.num_entries, 2, generator=gen, device="cuda") * 2 - 1
    return pts, table


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["small", "published"])
@pytest.mark.parametrize("n", [1, 1000, 65_536 + 37])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_pair_against_plain(card, shape, n, dtype):
    grid = grid_of(SMALL if shape == "small" else PUBLISHED)
    pts, table = _card_inputs(grid, n, seed=n)
    got = hashgrid.fused_hash_encode(table, pts, grid, dtype)
    want = hashgrid.hash_encode_plain(table, pts, grid, dtype)
    # Each step of the forward is one IEEE rounding in the plain version's
    # order: bitwise in f32, and so in bf16 after the same rounding.
    assert torch.equal(got, want)
    gen = torch.Generator(device="cuda").manual_seed(n + 1)
    grad = torch.randn(n, 2 * grid.num_levels, generator=gen, device="cuda").to(
        getattr(torch, dtype))
    grad[::7] = 0          # whole points whose gradient is 0
    dt = hashgrid._backward(grad.contiguous(), pts, grid)
    want_dt = hashgrid.hash_encode_plain_bwd(grad, pts, grid)
    # The atomics add a row's terms in another order than index_add_.
    assert ((dt - want_dt).abs() <= chip_smoke.hash_atomic_bound(grad, pts, grid)).all()
    assert torch.equal(dt == 0, want_dt == 0)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["small", "published"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_on_samples_packed_along_rays(card, shape, dtype):
    """Samples packed along rays, as training gathers them at surfaces:
    neighbouring points add into the same rows (and a stretch of zero
    gradients, and a partial last block)."""
    grid = grid_of(SMALL if shape == "small" else PUBLISHED)
    gen = torch.Generator(device="cuda").manual_seed(11)
    rays, samples = 301, 45
    o = (torch.rand(rays, 1, 3, generator=gen, device="cuda") * 2 - 1) * 1.2
    d = torch.nn.functional.normalize(torch.randn(rays, 1, 3, generator=gen, device="cuda"),
                                      dim=-1)
    t = torch.linspace(0.0, 0.02, samples, device="cuda")[None, :, None]
    pts = (o + d * t).reshape(-1, 3).contiguous()
    grad = torch.randn(pts.shape[0], 2 * grid.num_levels, generator=gen, device="cuda").to(
        getattr(torch, dtype))
    grad[100:164] = 0
    dt = hashgrid._backward(grad.contiguous(), pts, grid)
    want = hashgrid.hash_encode_plain_bwd(grad, pts, grid)
    assert ((dt - want).abs() <= chip_smoke.hash_atomic_bound(grad, pts, grid)).all()
    assert torch.equal(dt == 0, want == 0)


@pytest.mark.cuda
def test_autograd_entry_counts_one_launch_each_way(card):
    model = HashGridNeRFModel(**SMALL).cuda()
    pts, _ = _card_inputs(model.grid, 5000, seed=9)
    f0, b0 = hashgrid.fused_hash_encode.fwd_launches, hashgrid.fused_hash_encode.bwd_launches
    out = hashgrid.fused_hash_encode(model.table, pts, model.grid, "bfloat16")
    out.float().square().sum().backward()
    assert (hashgrid.fused_hash_encode.fwd_launches - f0,
            hashgrid.fused_hash_encode.bwd_launches - b0) == (1, 1)
    assert model.table.grad is not None and model.table.grad.abs().sum() > 0
    with pytest.raises(ValueError, match="no gradient for the points"):
        hashgrid.fused_hash_encode(model.table, pts.requires_grad_(True), model.grid)
