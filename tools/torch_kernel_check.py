#!/usr/bin/env python3
"""Compile-and-check the PyTorch port's CUDA kernels on one NVIDIA GPU.

Run from the root of a checkout, with one card:

    python3 tools/torch_kernel_check.py [--parent-csrc DIR]

Builds ``nerf_tpu_torch/csrc`` (printing each kernel's registers and spills,
and the tensor-core instructions of each kernel by ``cuobjdump -sass``),
holds the point-major (#2) and ray-major (#3) 4x128 forwards against their
plain versions at the render path's shapes and a few ragged ones, #3 against
``fused_mlp_t`` (#1, the same function: bitwise in f32 and bf16), the whole render
stage (#7) against its plain version and, in bf16, bitwise against #5 on
#1's bf16 field, and times #1-#3 once; then holds the 8x256 PaperNeRF
kernels, #4 ``fused_paper_mlp_t`` and the #9 training pair, against their
plain versions in f32 and bf16 at chip_smoke.py's phase 9 shapes, points
ending mid-tile, and 0, 6, 10 and 16 encoding frequencies, #4's bf16
instance also at a 400x400 frame's four shapes and ragged ones, one wgmma
launch each (``fused_paper_mlp_t.wgmma_launches``); and the
scene-batched #8 and #9 pairs at phase 19's shape (MS_SCENES scenes of
TRAIN_SHAPE), bitwise the single-scene launches, each pass timed as one
batched call beside MS_SCENES single-scene calls in turns. With
``--parent-csrc`` (another tree's ``nerf_tpu_torch/csrc``, e.g. unpacked with
``git archive``) it also builds that tree, prints both trees' registers and
spills of the tensor-core instances and of the f32 4x128 and Paper
instances, checks that the outputs ``bitwise_results`` lists (the f32 Paper
ones among them, and the bf16 #9 pair's at paper_train's two shapes) and #1's bf16 outputs at a frame's four shapes and ragged
ones are bitwise the same from both, each tree through its own wrappers
(its package, imported under another name), and #4's bf16 outputs
within chip_smoke.py's BF16_TOL of the other tree's (its wgmma body sums in
another order than the mma.sync tile), times #1, #2, #3, #4, #7
and the #8 and #9 pairs in f32 and bf16, #6 (det, by the
profiler's device time too) from both in turns (parent, this tree, this
tree, parent), and each launch of #8's and #9's f32 and bf16 forward and
backward by the profiler: the training pairs' launches at one scene, beside
the other tree's. A short first call for a new kernel; ``chip_smoke.py`` is
the full check.
"""

import argparse
import importlib
import importlib.util
import os
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from nerf_tpu_torch.kernels import (  # noqa: E402
    _build, composite, mlp, mlp_t, paper_t, paper_train, stage,
)
from nerf_tpu_torch.models import PaperNeRFModel  # noqa: E402

PAPER_FREQS = (0, 6, 10, 16)


def check_new_kernels(model, dev) -> bool:
    """#2 and #3 against their plain versions and #3 against #1 (True when
    both are within chip_smoke.py's tolerances, the bf16 instances on the
    tensor cores to TC_BF16_FWD_TOL, and #3 is bitwise #1 in f32 and
    bf16)."""
    worst = 0.0
    with torch.inference_mode():
        for n, s in ((2048, 64), (2048, 128), (333, 61), (1, 1), (5, 33), (131072, 128)):
            pts, vd = cs.orbit_points(n, s, dev, n + s)
            flat_vd = vd[:, None, :].expand(n, s, 3).reshape(-1, 3)
            for dt, tol in (("float32", cs.F32_TOL), ("bfloat16", cs.TC_BF16_FWD_TOL)):
                rays = mlp.fused_flexible_mlp_rays(model, pts, vd, dt)
                points = mlp.fused_flexible_mlp(model, pts.reshape(-1, 3), flat_vd, dt)
                one = mlp_t.fused_mlp_t(model, pts, vd, dt)
                torch.cuda.synchronize()
                e3 = float((rays - mlp.flexible_mlp_rays_plain(model, pts, vd, dt)).abs().max())
                e2 = float((points - mlp.flexible_mlp_plain(model, pts.reshape(-1, 3), flat_vd,
                                                            dt)).abs().max())
                e31 = float((rays - one).abs().max())
                print(f"({n}, {s}) {dt}: #3 vs plain {e3:.3e}, #2 vs plain {e2:.3e} (tol "
                      f"{tol:g}), #3 vs #1 {e31:.3e} bitwise {torch.equal(rays, one)}",
                      flush=True)
                if not torch.equal(rays, one):
                    worst = float("inf")
                worst = max(worst, e3 / tol, e2 / tol)
        n, s = cs.KERNEL_CHUNK
        pts, vd = cs.orbit_points(n, s, dev, 1)
        flat_pts, flat_vd = pts.reshape(-1, 3), vd[:, None, :].expand(n, s, 3).reshape(-1, 3)
        for dt in ("float32", "bfloat16"):
            fns = {"#3": lambda: mlp.fused_flexible_mlp_rays(model, pts, vd, dt),
                   "#2": lambda: mlp.fused_flexible_mlp(model, flat_pts, flat_vd, dt),
                   "#1": lambda: mlp_t.fused_mlp_t(model, pts, vd, dt)}
            print(f"ms {dt}: " + " ".join(f"{k} {cs.cuda_ms(fn, 2):.2f}" for k, fn in fns.items()),
                  flush=True)
    return worst <= 1.0


def check_stage_kernel(dev) -> bool:
    """#7 against its plain version (chip_smoke.py's phase 12 tolerances) on
    its opacified model, and in bf16 bitwise against #5 on #1's bf16 field,
    at the render path's chunks, ragged shapes and both backgrounds. True
    when all hold."""
    model = cs.seeded_model(cs.SEED, opacify=True).to(dev)
    tols = {"float32": cs.MAP_TOLS, "bfloat16": {k: cs.BF16_TOL for k in cs.MAP_TOLS}}
    ok = True
    with torch.inference_mode():
        for n, s in cs.STAGE_CHECK_SHAPES + ((1, 1), (5, 33), (77, 200)):
            pts, vd, z, rd = cs.orbit_rays(n, s, dev, seed=n + s)
            parts = []
            for white in (False, True):
                got = {}
                for dt in ("float32", "bfloat16"):
                    got[dt] = stage.fused_render_stage(model, pts, vd, z, rd, white, dt)
                    torch.cuda.synchronize()
                    e = cs.map_errors(got[dt], stage.render_stage_plain(model, pts, vd, z, rd,
                                                                         white, dt))
                    ok &= all(e[k] <= tols[dt][k] for k in e)
                    parts.append(f"{dt} {max(e.values()):.2e}")
                want = composite.fused_volume_render(mlp_t.fused_mlp_t(model, pts, vd, "bfloat16"),
                                                     z, rd, white)
                same = all(torch.equal(got["bfloat16"][k], want[k]) for k in want)
                ok &= same
                parts.append(f"bf16 bitwise #5(#1) {same}")
            print(f"#7 ({n}, {s}) vs plain, black / white: {'; '.join(parts)}", flush=True)
    return ok


def paper_models(dev) -> dict:
    """Seeded 8x256 PaperNeRFs at each encoding depth of PAPER_FREQS."""
    return {f: PaperNeRFModel(num_encoding_fn_xyz=f, num_encoding_fn_dir=4,
                              generator=torch.Generator().manual_seed(cs.SEED + f)).to(dev)
            for f in PAPER_FREQS}


def check_paper_kernels(dev) -> bool:
    """#4 and the #9 pair against their plain versions, f32 and bf16, at
    chip_smoke.py's phase 9 shapes (F = 10) and a few ragged ones at each
    depth (the backward against the plain backward on the forward kernel's
    residuals, as phase 9 holds it); two backward calls bitwise equal. True
    when all are within chip_smoke.py's tolerances (TC_BF16_FWD_TOL for
    the bf16 forwards)."""
    models = paper_models(dev)
    ok = True
    tols = (("float32", cs.F32_TOL), ("bfloat16", cs.BF16_TOL))
    fwd_tols = {"float32": cs.F32_TOL, "bfloat16": cs.TC_BF16_FWD_TOL}
    cases = [(10, shape) for shape in cs.PAPER_CHECK_SHAPES] + [
        (f, shape) for f in PAPER_FREQS for shape in ((1, 1), (5, 33), (333, 61))]
    with torch.inference_mode():
        for f, (n, s) in cases:
            pts, vd, _, _, _ = cs.paper_case(n, s, models[f], dev, seed=n + s + f)
            errs = []
            for dt in fwd_tols:
                got = paper_t.fused_paper_mlp_t(models[f], pts, vd, dt)
                torch.cuda.synchronize()
                errs.append(float((got - paper_t.paper_t_plain(models[f], pts, vd, dt)
                                   ).abs().max()))
                ok &= errs[-1] <= fwd_tols[dt]
            print(f"#4 ({n}, {s}) F={f}: f32 {errs[0]:.3e}, bf16 {errs[1]:.3e}", flush=True)
        # The bf16 instance (paper_wg.cuh's wgmma body) alone at a frame's four
        # shapes and ragged ones (samples that do not divide a consumer's 64
        # points), each one launch through the wgmma body.
        ragged = ((777, 48), (333, 100))
        for f, (n, s) in [(10, shape) for shape in cs.PAPER_FRAME_SHAPES + ragged] + [
                (f, (100, 48)) for f in PAPER_FREQS]:
            pts, vd, _, _, _ = cs.paper_case(n, s, models[f], dev, seed=n + s + f + 1)
            fn = paper_t.fused_paper_mlp_t
            before = (fn.launches, fn.wgmma_launches)
            got = fn(models[f], pts, vd, "bfloat16")
            torch.cuda.synchronize()
            one = (fn.launches, fn.wgmma_launches) == (before[0] + 1, before[1] + 1)
            err = max(float((got[i:i + cs.PLAIN_CHUNK] - paper_t.paper_t_plain(
                models[f], pts[i:i + cs.PLAIN_CHUNK], vd[i:i + cs.PLAIN_CHUNK], "bfloat16")
                             ).abs().max()) for i in range(0, n, cs.PLAIN_CHUNK))
            ok &= one and bool(torch.isfinite(got).all()) and err <= cs.TC_BF16_FWD_TOL
            print(f"#4 bf16 ({n}, {s}) F={f}: {err:.3e}, one wgmma launch {one}", flush=True)
            del pts, vd, got
    train_cases = [(10, shape) for shape in cs.TRAIN_CHECK_SHAPES] + [
        (f, shape) for f in PAPER_FREQS for shape in ((1, 1), (5, 33), (333, 61))]
    with torch.no_grad():
        for f, (n, s) in train_cases:
            pts, _, dc, params, g = cs.paper_case(n, s, models[f], dev, seed=n * s + f)
            parts = []
            for dt, tol in tols:
                out, res = paper_train.paper_train_fwd(pts, dc, params, dt, f)
                grad, ddc = paper_train.paper_train_bwd(g, res, params, n, s, dt, f)
                again = paper_train.paper_train_bwd(g, res, params, n, s, dt, f)
                torch.cuda.synchronize()
                same = torch.equal(grad, again[0]) and torch.equal(ddc, again[1])
                want = paper_train.paper_train_plain_fwd(pts, dc, params, dt, f)[0]
                kernel_res = paper_train.residuals_as_plain(res, n * s, f, dt)
                want_grad, want_ddc = paper_train.paper_train_plain_bwd(g, kernel_res, params, n,
                                                                        s, dt, f)
                f_err = float((out - want).abs().max())
                b_name, b_err = max(cs.paper_grad_errors(grad, ddc, want_grad, want_ddc,
                                                         f).items(), key=lambda kv: kv[1])
                ok &= same and f_err <= fwd_tols[dt] and b_err <= tol
                parts.append(f"{dt} {f_err:.3e} / {b_err:.3e} at {b_name}, repeatable {same}")
            print(f"#9 ({n}, {s}) F={f}: {'; '.join(parts)}", flush=True)
    return ok


def check_flex_tc_kernels(dev) -> bool:
    """The bf16 tensor-core instances of #1 and the #8 pair against their
    plain versions: #1 at chip_smoke.py's phase 3 shapes, a frame's four
    shapes and ragged ones, one launch each through its wgmma body, the
    pair at its phase 6 shapes and ragged ones (the forward and its
    residuals against the plain forward's, the backward against the plain
    backward on the forward kernel's residuals), two backward calls bitwise
    equal. True when all are within chip_smoke.py's tolerances."""
    model = cs.seeded_model(cs.SEED, opacify=False).to(dev)
    ok = True
    fn = mlp_t.fused_mlp_t
    with torch.inference_mode():
        for n, s in cs.CHECK_SHAPES + ((1, 1), (5, 33)) + cs.FRAME_SHAPES + cs.RAGGED_SHAPES:
            pts, vd = cs.orbit_points(n, s, dev, n + s)
            before = (fn.launches, fn.wgmma_launches)
            got = fn(model, pts, vd, "bfloat16")
            torch.cuda.synchronize()
            one = (fn.launches, fn.wgmma_launches) == (before[0] + 1, before[1] + 1)
            err = float((got - mlp_t.mlp_t_plain(model, pts, vd, "bfloat16")).abs().max())
            ok &= one and bool(torch.isfinite(got).all()) and err <= cs.TC_BF16_FWD_TOL
            print(f"#1 bf16 ({n}, {s}): {err:.3e}, one wgmma launch {one}", flush=True)
            del pts, vd, got
    with torch.no_grad():
        for n, s in cs.TRAIN_CHECK_SHAPES + ((1, 1), (5, 33)):
            pts, dc, params, g = cs.train_case(n, s, model, dev, seed=n * s)
            errs = cs.flex_pair_errors(pts, dc, params, g, n, s, "bfloat16")
            ok &= (errs["repeatable"] and errs["fwd"] <= cs.TC_BF16_FWD_TOL
                   and errs["res"] <= cs.BF16_TOL and errs["bwd"] <= cs.BF16_TOL)
            print(f"#8 bf16 ({n}, {s}): forward {errs['fwd']:.3e}, residuals {errs['res']:.3e}, "
                  f"gradients {errs['bwd']:.3e} at {errs['bwd_at']}, repeatable "
                  f"{errs['repeatable']}", flush=True)
    return ok


def time_scene_batches(dev) -> bool:
    """#8's and #9's pairs on MS_SCENES scenes of TRAIN_SHAPE, f32 and bf16:
    bitwise the single-scene launches (``chip_smoke.scene_pair_bitwise``),
    then each pass as one scene-batched call and as MS_SCENES single-scene
    calls, by CUDA events in turns (single, batched, batched, single). True
    when all are bitwise."""
    scenes, (n, s) = cs.MS_SCENES, cs.TRAIN_SHAPE
    ok = True
    with torch.no_grad():
        for family, tag in (("flex", "#8"), ("paper", "#9")):
            cases = cs.scene_pair_cases(family, scenes, n, s, 10, dev, seed=7)
            pts, dc, params, g = (torch.stack(x) for x in zip(*cases))
            fwd_scenes, bwd_scenes, fwd, bwd = cs.scene_pair_fns(family, 10)
            for dt, short in (("float32", "f32"), ("bfloat16", "bf16")):
                same = cs.scene_pair_bitwise(family, scenes, n, s, 10, dt, dev, seed=7)
                ok &= same
                res = fwd_scenes(pts, dc, params, dt)[1]
                single_res = [fwd(p_, d_, w_, dt)[1] for p_, d_, w_, _ in cases]
                calls = {
                    "fwd": {"single": lambda: [fwd(*c[:3], dt) for c in cases],
                            "batched": lambda: fwd_scenes(pts, dc, params, dt)},
                    "bwd": {"single": lambda: [bwd(c[3], r, c[2], n, s, dt)
                                               for c, r in zip(cases, single_res)],
                            "batched": lambda: bwd_scenes(g, res, params, dt)},
                }
                for which, by in calls.items():
                    times = {"single": [], "batched": []}
                    for label in ("single", "batched", "batched", "single"):
                        times[label].append(cs.cuda_ms(by[label], 5))
                    batched, single = (" / ".join(f"{t:.4f}" for t in times[k])
                                       for k in ("batched", "single"))
                    print(f"ms {tag} {which} {short}, {scenes} scenes of ({n}, {s}) (bitwise "
                          f"{same}): one batched call {batched}; {scenes} single-scene calls "
                          f"{single}", flush=True)
    return ok


_MODULES = ("kernels.mlp_t", "kernels.mlp", "kernels.flex_train", "kernels.stage",
            "kernels.paper_t", "kernels.paper_train", "kernels.resample", "models")
# #6's cases: bin edges M, stochastic u of each shape's S; det takes S = 64.
RESAMPLE_CASES = ((131072, 63, 64), (1000, 129, 128), (333, 768, 61))


def import_package(pkg_dir: Path, name: str) -> dict:
    """The package at ``pkg_dir`` imported as ``name`` (another tree's
    ``nerf_tpu_torch`` beside this one's): its kernel wrappers and models,
    by module name; they build and load that tree's library."""
    spec = importlib.util.spec_from_file_location(name, pkg_dir / "__init__.py",
                                                  submodule_search_locations=[str(pkg_dir)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return {sub.split(".")[-1]: importlib.import_module(f"{name}.{sub}") for sub in _MODULES}


def tree_models(mods: dict, dev):
    """chip_smoke.py's opacified flagship and Paper check models as the
    tree's own classes (their wrappers check the model's class)."""
    flex = mods["models"].FlexibleNeRFModel(num_encoding_fn_xyz=10, num_encoding_fn_dir=4)
    flex.load_state_dict(cs.seeded_model(cs.SEED, opacify=True).state_dict())
    paper = mods["models"].PaperNeRFModel(num_encoding_fn_xyz=10, num_encoding_fn_dir=4)
    paper.load_state_dict(cs.seeded_model(cs.SEED, opacify=False,
                                          family="PaperNeRFModel").state_dict())
    return flex.to(dev).eval(), paper.to(dev).eval()


def resample_case(n: int, m: int, s: int, dev):
    """#6's inputs: sorted bin edges (n, m), peaked weights (n, m - 1)
    (rand**4, one all-zero ray) and uniforms (n, s) with 1.0 and 0.0."""
    gen = torch.Generator(device=dev).manual_seed(n + m)
    bins = torch.sort(2.0 + 4.0 * torch.rand(n, m, generator=gen, device=dev), dim=-1)[0]
    w = torch.rand(n, m - 1, generator=gen, device=dev) ** 4
    w[0] = 0.0
    u = torch.rand(n, s, generator=gen, device=dev)
    u[:, 0], u[:, 1] = 1.0, 0.0
    return bins, w, u


def bitwise_results(m: dict, dev):
    """Through one tree's wrappers: the f32 and bf16 outputs of #1, the #8
    pair and the #9 pair (forward output, residuals, gradient, ddc), the f32
    ones of #2, #3, #4 and #7, at a render shape and a ragged one; the bf16 #9
    pair's at chip_smoke.py's PAPER_TRAIN_SHAPES (its weight gradients on wgmma); #6's det
    and stochastic outputs at RESAMPLE_CASES. Returns them and, apart, #4's
    bf16 outputs at the same shapes (paper_wg.cuh's wgmma body, which sums
    in another order than the mma.sync tile before it)."""
    flex, paper = tree_models(m, dev)
    out, paper_bf16 = [], []
    with torch.no_grad():
        for n, s in ((2048, 128), (333, 61)):
            pts, vd = cs.orbit_points(n, s, dev, n)
            flat_pts, flat_vd = pts.reshape(-1, 3), vd[:, None, :].expand(n, s, 3).reshape(-1, 3)
            g = torch.randn(n, s, 4, generator=torch.Generator(device=dev).manual_seed(1),
                            device=dev)
            z = torch.sort(2.0 + 4.0 * torch.rand(n, s, device=dev, generator=torch.Generator(
                device=dev).manual_seed(2)), dim=-1)[0]
            params = m["mlp"].pack_params(flex)
            dc = m["mlp"].dir_contribution(flex, vd)
            out.append(m["mlp"].fused_flexible_mlp_rays(flex, pts, vd, "float32"))
            for dt in ("float32", "bfloat16"):
                out.append(m["mlp_t"].fused_mlp_t(flex, pts, vd, dt))
                fo, r = m["flex_train"].flex_train_fwd(pts, dc, params, dt)
                out += [fo, r[0], *m["flex_train"].flex_train_bwd(g, r, params, n, s, dt)]
            out.append(m["mlp"].fused_flexible_mlp(flex, flat_pts, flat_vd, "float32"))
            maps = m["stage"].fused_render_stage(flex, pts, vd, z, vd, True, "float32")
            out += [maps[k] for k in sorted(maps)]
            dc, pp = m["paper_t"].dir_contribution(paper, vd), m["paper_t"].pack_params(paper)
            for dt in ("bfloat16", "float32"):
                (paper_bf16 if dt == "bfloat16" else out).append(
                    m["paper_t"].fused_paper_mlp_t(paper, pts, vd, dt))
                po, r = m["paper_train"].paper_train_fwd(pts, dc, pp, dt, 10)
                out += [po, r[0], *m["paper_train"].paper_train_bwd(g, r, pp, n, s, dt, 10)]
        # #9's bf16 pair at paper_train's coarse and fine passes.
        for n, s in cs.PAPER_TRAIN_SHAPES:
            pts, vd = cs.orbit_points(n, s, dev, n + s)
            g = torch.randn(n, s, 4, generator=torch.Generator(device=dev).manual_seed(3),
                            device=dev)
            dc, pp = m["paper_t"].dir_contribution(paper, vd), m["paper_t"].pack_params(paper)
            po, r = m["paper_train"].paper_train_fwd(pts, dc, pp, "bfloat16", 10)
            out += [po, r[0], *m["paper_train"].paper_train_bwd(g, r, pp, n, s, "bfloat16", 10)]
        for n, mb, s in RESAMPLE_CASES:
            bins, w, u = resample_case(n, mb, s, dev)
            out.append(m["resample"].fused_sample_pdf(bins, w, 64, det=True))
            out.append(m["resample"].fused_sample_pdf(bins, w, s, u=u))
    torch.cuda.synchronize()
    return out, paper_bf16


def timed_calls(m: dict, dev) -> dict:
    """Through one tree's wrappers, at the main path's shapes: name -> (fn,
    reps) for #1, #2, #3, #4 and #7 in f32 and bf16 (one fine-pass
    chunk), #6 det (one coarse chunk's resample, M 63 -> 64), the #8 and #9
    pairs in f32 and bf16 (one training pass, F = 10)."""
    flex, paper = tree_models(m, dev)
    pts, vd, z, rd = cs.orbit_rays(*cs.KERNEL_CHUNK, dev, 1)
    flat_pts, flat_vd = pts.reshape(-1, 3), vd[:, None, :].expand(*pts.shape).reshape(-1, 3)
    tp, tvd = cs.orbit_points(*cs.TRAIN_SHAPE, dev, 3)
    params, dc = m["mlp"].pack_params(flex).detach(), m["mlp"].dir_contribution(flex, tvd).detach()
    g = torch.randn(*cs.TRAIN_SHAPE, 4, device=dev, generator=torch.Generator(
        device=dev).manual_seed(4))
    res = {dt: m["flex_train"].flex_train_fwd(tp, dc, params, dt)[1]
           for dt in ("float32", "bfloat16")}
    bins, w, _ = resample_case(cs.KERNEL_CHUNK[0], 63, 64, dev)
    calls = {"#6 det": (lambda: m["resample"].fused_sample_pdf(bins, w, 64, det=True), 50)}
    pp = m["paper_t"].pack_params(paper).detach()
    pdc = m["paper_t"].dir_contribution(paper, tvd).detach()
    pres = {dt: m["paper_train"].paper_train_fwd(tp, pdc, pp, dt, 10)[1]
            for dt in ("float32", "bfloat16")}
    calls["#4 f32"] = (lambda: m["paper_t"].fused_paper_mlp_t(paper, pts, vd, "float32"), 2)
    calls["#4 bf16"] = (lambda: m["paper_t"].fused_paper_mlp_t(paper, pts, vd, "bfloat16"), 3)
    for dt, tag, reps in (("float32", "f32", 2), ("bfloat16", "bf16", 3)):
        calls.update({
            f"#9 fwd {tag}": (lambda dt=dt: m["paper_train"].paper_train_fwd(tp, pdc, pp, dt, 10),
                              10),
            f"#9 bwd {tag}": (lambda dt=dt: m["paper_train"].paper_train_bwd(
                g, pres[dt], pp, *cs.TRAIN_SHAPE, dt, 10), 10),
            f"#1 {tag}": (lambda dt=dt: m["mlp_t"].fused_mlp_t(flex, pts, vd, dt), reps),
            f"#2 {tag}": (lambda dt=dt: m["mlp"].fused_flexible_mlp(flex, flat_pts, flat_vd, dt),
                          reps),
            f"#3 {tag}": (lambda dt=dt: m["mlp"].fused_flexible_mlp_rays(flex, pts, vd, dt), reps),
            f"#7 {tag}": (lambda dt=dt: m["stage"].fused_render_stage(flex, pts, vd, z, rd, True,
                                                                       dt), reps),
            f"#8 fwd {tag}": (lambda dt=dt: m["flex_train"].flex_train_fwd(tp, dc, params, dt),
                              10),
            f"#8 bwd {tag}": (lambda dt=dt: m["flex_train"].flex_train_bwd(
                g, res[dt], params, *cs.TRAIN_SHAPE, dt), 10),
        })
    return calls


def time_in_turns(calls: dict, order, use=lambda label: None) -> None:
    """Print the time of each of ``calls[label]`` (``timed_calls``) by CUDA
    events, and #6's kernel by the profiler's device time too, for each
    label in the turns ``order``; ``use(label)`` runs before each turn."""
    times = {}
    for label in order:
        use(label)
        for name, (fn, reps) in calls[label].items():
            times.setdefault(name, {}).setdefault(label, []).append(cs.cuda_ms(fn, reps))
        fn, reps = calls[label]["#6 det"]
        times.setdefault("#6 det, device", {}).setdefault(label, []).append(
            cs.kernel_device_ms(fn, reps, "resample_kernel").get("resample_kernel", 0.0))
    for name, by in times.items():
        print(f"ms {name}: " + "; ".join(f"{k} {' / '.join(f'{t:.4f}' for t in v)}"
                                        for k, v in by.items()), flush=True)


def check_bitwise_against(parent_csrc: Path, dev) -> bool:
    """The outputs ``bitwise_results`` lists, from both trees, bitwise; the
    parent's ptxas report; then ``timed_calls`` from both in turns (parent,
    this tree, this tree, parent) by CUDA events, #6's kernel by the
    profiler's device time in the same turns, and each launch of #8's and
    #9's f32 and bf16 forward and backward by the profiler."""
    trees = {"parent": import_package(parent_csrc.resolve().parent, "parent_nerf_tpu_torch"),
             "this tree": {sub.split(".")[-1]: importlib.import_module(f"nerf_tpu_torch.{sub}")
                           for sub in _MODULES}}
    parent_path = importlib.import_module("parent_nerf_tpu_torch.kernels._build").build_library()
    print("parent", cs.ptxas_summary(parent_path.with_suffix(".log").read_text(), frames=True),
          flush=True)
    watched = (cs.TENSOR_CORE_KERNELS + cs.F32_FLEX_KERNELS + cs.F32_FLEX_BWD_KERNELS
               + cs.F32_PAPER_KERNELS)
    for label, path in (("parent", parent_path), ("this tree", _build.build_library())):
        regs = cs.ptxas_summary(path.with_suffix(".log").read_text()).split(", ")
        print(f"registers (spills) of the tensor-core instances and the f32 ones, {label}: "
              + ", ".join(r for r in regs if r.rsplit(" ", 1)[0].split(" (")[0] in watched),
              flush=True)
    outs = {label: bitwise_results(m, dev) for label, m in trees.items()}
    same = [torch.equal(a, b) for a, b in zip(outs["parent"][0], outs["this tree"][0])]
    print(f"bitwise equal to parent: {all(same)} ({sum(same)} of {len(same)} outputs)",
          flush=True)
    flex = {label: tree_models(m, dev)[0] for label, m in trees.items()}
    parts, frame_same = [], True
    with torch.no_grad():
        for n, s in cs.FRAME_SHAPES + cs.RAGGED_SHAPES:
            pts, vd = cs.orbit_points(n, s, dev, n + s + 2)
            got = {label: m["mlp_t"].fused_mlp_t(flex[label], pts, vd, "bfloat16")
                   for label, m in trees.items()}
            diff = float((got["parent"] - got["this tree"]).abs().max())
            frame_same &= torch.equal(got["parent"], got["this tree"])
            parts.append(f"({n}, {s}) {diff:.3e}")
            del pts, vd, got
    print(f"#1 bf16 against the parent's at a frame's shapes, max |difference|: "
          f"{', '.join(parts)}; bitwise {frame_same}", flush=True)
    errs = [float((a - b).abs().max()) for a, b in zip(outs["parent"][1], outs["this tree"][1])]
    near = all(e <= cs.BF16_TOL for e in errs)
    print(f"#4 bf16 against the parent's (tol {cs.BF16_TOL:g}): "
          + ", ".join(f"{e:.3e}" for e in errs) + f", within {near}, bitwise "
          + str(all(e == 0.0 for e in errs)), flush=True)

    calls = {label: timed_calls(m, dev) for label, m in trees.items()}
    with torch.no_grad():
        time_in_turns(calls, ("parent", "this tree", "this tree", "parent"))
        for name in ("#8 fwd f32", "#8 fwd bf16", "#9 fwd f32", "#9 fwd bf16", "#8 bwd f32",
                     "#8 bwd bf16", "#9 bwd f32", "#9 bwd bf16"):
            for label in ("parent", "this tree"):
                per = cs.kernel_device_ms(calls[label][name][0], 10, r"train_\w+?_kernel")
                print(f"ms {name} by launch, {label}: "
                      + ", ".join(f"{k} {v:.4f}" for k, v in per.items()), flush=True)
    return all(same) and near and frame_same


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent-csrc", type=Path, default=None,
                    help="another tree's nerf_tpu_torch/csrc to compare bitwise against")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_check: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    t0 = time.time()
    lib_path = _build.build_library()
    print("build", round(time.time() - t0, 2), flush=True)
    print(cs.ptxas_summary(lib_path.with_suffix(".log").read_text(), frames=True))
    mma = cs.sass_mma_counts(lib_path)
    print("HMMA/HGMMA (cuobjdump -sass): "
          + ", ".join(f"{k} {v}" for k, v in mma.items() if v), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    tc_ok = check_flex_tc_kernels(dev)
    print("#1 and #8 bf16 within tolerance of plain, backward repeatable:", tc_ok, flush=True)
    paper_ok = check_paper_kernels(dev)
    print("#4 and #9 within tolerance of plain, backward repeatable:", paper_ok, flush=True)
    # #2 and #3 on chip_smoke.py's phase 14 model.
    flex_ok = check_new_kernels(cs.seeded_model(0, opacify=False).to(dev), dev)
    print("#2 and #3 within tolerance of plain:", flex_ok, flush=True)
    stage_ok = check_stage_kernel(dev)
    print("#7 within tolerance of plain, bf16 bitwise #5 on #1's field:", stage_ok, flush=True)
    scenes_ok = time_scene_batches(dev)
    print("#8 and #9 scene-batched pairs bitwise the single-scene launches:", scenes_ok,
          flush=True)
    ok = tc_ok and flex_ok and paper_ok and stage_ok and scenes_ok
    if args.parent_csrc is not None and not check_bitwise_against(args.parent_csrc, dev):
        return 1
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
