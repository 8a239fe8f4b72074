#!/usr/bin/env python3
"""Compile-and-check the PyTorch port's CUDA kernels on one NVIDIA GPU.

Run from the root of a checkout, with one card:

    python3 tools/torch_kernel_check.py [--parent-csrc DIR]

Builds ``nerf_tpu_torch/csrc`` (printing each kernel's registers and spills,
and the tensor-core instructions of each kernel by ``cuobjdump -sass``),
holds the point-major (#2) and ray-major (#3) 4x128 forwards against their
plain versions at the render path's shapes and a few ragged ones, #3 against
``fused_mlp_t`` (#1, the same function: bitwise), and times each once beside
its plain version and #1; then holds the 8x256 PaperNeRF kernels, #4
``fused_paper_mlp_t`` and the #9 training pair, against their plain versions
in f32 and bf16 at chip_smoke.py's phase 9 shapes, points ending mid-tile,
and 0, 6, 10 and 16 encoding frequencies. With ``--parent-csrc`` (another
tree's ``nerf_tpu_torch/csrc``, e.g. unpacked with ``git archive``) it also
builds that tree and checks that ``fused_mlp_t``, the 4x128 training pair,
the whole render stage and the f32 Paper kernels give bitwise the same
results from both, the Paper ones through that tree's own wrappers (its
package, imported under another name); then it times them from both in
turns (parent, this tree, this tree, parent), the bf16 Paper kernels at the
main path's shapes included. A short first call for a new kernel;
``chip_smoke.py`` is the full check.
"""

import argparse
import ctypes
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
from nerf_tpu_torch.kernels import _build, flex_train, mlp, mlp_t  # noqa: E402
from nerf_tpu_torch.kernels import paper_t, paper_train, stage  # noqa: E402
from nerf_tpu_torch.models import PaperNeRFModel  # noqa: E402

PAPER_FREQS = (0, 6, 10, 16)


def check_new_kernels(model, dev) -> bool:
    """#2 and #3 against their plain versions (True when both are within
    chip_smoke.py's tolerances) and #3 against #1."""
    worst = 0.0
    with torch.inference_mode():
        for n, s in ((2048, 64), (2048, 128), (333, 61), (1, 1), (5, 33), (131072, 128)):
            pts, vd = cs.orbit_points(n, s, dev, n + s)
            flat_vd = vd[:, None, :].expand(n, s, 3).reshape(-1, 3)
            for dt, tol in (("float32", cs.F32_TOL), ("bfloat16", cs.BF16_TOL)):
                rays = mlp.fused_flexible_mlp_rays(model, pts, vd, dt)
                points = mlp.fused_flexible_mlp(model, pts.reshape(-1, 3), flat_vd, dt)
                one = mlp_t.fused_mlp_t(model, pts, vd, dt)
                torch.cuda.synchronize()
                e3 = float((rays - mlp.flexible_mlp_rays_plain(model, pts, vd, dt)).abs().max())
                e2 = float((points - mlp.flexible_mlp_plain(model, pts.reshape(-1, 3), flat_vd,
                                                            dt)).abs().max())
                e31 = float((rays - one).abs().max())
                print(f"({n}, {s}) {dt}: #3 vs plain {e3:.3e}, #2 vs plain {e2:.3e}, "
                      f"#3 vs #1 {e31:.3e} bitwise {torch.equal(rays, one)}", flush=True)
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
    when all are within chip_smoke.py's tolerances (PAPER_BF16_FWD_TOL for
    the bf16 forwards)."""
    models = paper_models(dev)
    ok = True
    tols = (("float32", cs.F32_TOL), ("bfloat16", cs.BF16_TOL))
    fwd_tols = {"float32": cs.F32_TOL, "bfloat16": cs.PAPER_BF16_FWD_TOL}
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


def use_library(lib) -> None:
    """Make the kernel wrappers launch from ``lib``."""
    _build.load_library = lambda: lib
    for cached in (mlp_t._kernel, flex_train._kernels, stage._kernel, paper_t._kernel,
                   paper_train._kernels):
        cached.cache_clear()


def import_package(pkg_dir: Path, name: str):
    """The package at ``pkg_dir`` imported as ``name`` (another tree's
    ``nerf_tpu_torch`` beside this one's); returns its paper_t, paper_train
    and models modules."""
    spec = importlib.util.spec_from_file_location(name, pkg_dir / "__init__.py",
                                                  submodule_search_locations=[str(pkg_dir)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return tuple(importlib.import_module(f"{name}.{sub}")
                 for sub in ("kernels.paper_t", "kernels.paper_train", "models"))


def paper_calls(pt, ptr, model, dev):
    """#4 at KERNEL_CHUNK and the #9 pair at TRAIN_SHAPE through one tree's
    wrappers (``pt``, ``ptr``: its paper_t and paper_train): name -> (fn,
    reps) at bf16, and the f32 results at two shapes for the bitwise check."""
    results = []
    with torch.no_grad():
        for n, s in ((2048, 128), (333, 61)):
            pts, vd, dc, params, g = cs.paper_case(n, s, model, dev, seed=n)
            results.append(pt.fused_paper_mlp_t(model, pts, vd, "float32"))
            out, res = ptr.paper_train_fwd(pts, dc, params, "float32", 10)
            results += [out, res[0], *ptr.paper_train_bwd(g, res, params, n, s, "float32", 10)]
    n, s = cs.KERNEL_CHUNK
    pts, vd, _, _, _ = cs.paper_case(n, s, model, dev, seed=1)
    tp, _, dc, params, g = cs.paper_case(*cs.TRAIN_SHAPE, model, dev, seed=3)
    res = ptr.paper_train_fwd(tp, dc, params, "bfloat16", 10)[1]
    fns = {
        "#4 bf16": (lambda: pt.fused_paper_mlp_t(model, pts, vd, "bfloat16"), 2),
        "#9 fwd bf16": (lambda: ptr.paper_train_fwd(tp, dc, params, "bfloat16", 10), 10),
        "#9 bwd bf16": (lambda: ptr.paper_train_bwd(g, res, params, *cs.TRAIN_SHAPE,
                                                    "bfloat16", 10), 10),
    }
    return results, fns


def check_bitwise_against(parent_csrc: Path, lib_path: Path, model, dev):
    """fused_mlp_t, the training pair, the render stage and the f32 Paper
    kernels from both trees, bitwise; then their times at the main paths'
    shapes from both in turns (parent, this tree, this tree, parent)."""
    load = _build.load_library
    parent = import_package(parent_csrc.resolve().parent, "parent_nerf_tpu_torch")
    parent_build = importlib.import_module("parent_nerf_tpu_torch.kernels._build")
    parent_path = parent_build.build_library()
    print("parent", cs.ptxas_summary(parent_path.with_suffix(".log").read_text(), frames=True),
          flush=True)
    libs = {"parent": ctypes.CDLL(str(parent_path)), "this tree": ctypes.CDLL(str(lib_path))}
    paper = cs.seeded_model(cs.SEED, opacify=False, family="PaperNeRFModel").to(dev)
    parent_paper = parent[2].PaperNeRFModel(num_encoding_fn_xyz=10, num_encoding_fn_dir=4)
    parent_paper.load_state_dict(paper.state_dict())
    parent_paper = parent_paper.to(dev).eval()
    paper_trees = {"parent": (parent[0], parent[1], parent_paper),
                   "this tree": (paper_t, paper_train, paper)}
    paper_fns = {}
    outs = {}
    for label, lib in libs.items():
        use_library(lib)
        res = []
        with torch.no_grad():
            for n, s in ((2048, 128), (333, 61)):
                pts, vd = cs.orbit_points(n, s, dev, n)
                g = torch.randn(n, s, 4, generator=torch.Generator(device=dev).manual_seed(1),
                                device=dev)
                for dt in ("float32", "bfloat16"):
                    res.append(mlp_t.fused_mlp_t(model, pts, vd, dt))
                    params = mlp_t.pack_params(model)
                    out, r = flex_train.flex_train_fwd(pts, mlp_t.dir_contribution(model, vd),
                                                       params, dt)
                    grad, ddc = flex_train.flex_train_bwd(g, r, params, n, s, dt)
                    res += [out, r[0], grad, ddc]
                    z = torch.sort(2.0 + 4.0 * torch.rand(n, s, device=dev,
                                                          generator=torch.Generator(
                                                              device=dev).manual_seed(2)),
                                   dim=-1)[0]
                    maps = stage.fused_render_stage(model, pts, vd, z, vd, True, dt)
                    res += [maps[k] for k in sorted(maps)]
        paper_res, paper_fns[label] = paper_calls(*paper_trees[label], dev)
        torch.cuda.synchronize()
        outs[label] = res + paper_res
    same = all(torch.equal(a, b) for a, b in zip(outs["parent"], outs["this tree"]))
    print("bitwise equal to parent:", same, len(outs["this tree"]), flush=True)

    with torch.no_grad():
        n, s = cs.KERNEL_CHUNK
        pts, vd = cs.orbit_points(n, s, dev, 1)
        z = torch.sort(2.0 + 4.0 * torch.rand(n, s, device=dev), dim=-1)[0]
        tp, tvd = cs.orbit_points(*cs.TRAIN_SHAPE, dev, 3)
        params, dc = mlp_t.pack_params(model), mlp_t.dir_contribution(model, tvd)
        g = torch.randn(*cs.TRAIN_SHAPE, 4, device=dev)
        fns = {
            "#1 f32": (lambda: mlp_t.fused_mlp_t(model, pts, vd), 2),
            "#7 f32": (lambda: stage.fused_render_stage(model, pts, vd, z, vd, True), 2),
            "#7 bf16": (lambda: stage.fused_render_stage(model, pts, vd, z, vd, True,
                                                         "bfloat16"), 2),
            "#8 fwd f32": (lambda: flex_train.flex_train_fwd(tp, dc, params, "float32"), 10),
        }
        times = {}
        for label in ("parent", "this tree", "this tree", "parent"):
            use_library(libs[label])
            _, res = flex_train.flex_train_fwd(tp, dc, params, "float32")
            fns["#8 bwd f32"] = (lambda: flex_train.flex_train_bwd(g, res, params,
                                                                   *cs.TRAIN_SHAPE, "float32"), 10)
            for name, (fn, reps) in {**fns, **paper_fns[label]}.items():
                times.setdefault(name, {}).setdefault(label, []).append(cs.cuda_ms(fn, reps))
        for name, by in times.items():
            print(f"ms {name}: " + "; ".join(f"{k} {' / '.join(f'{t:.3f}' for t in v)}"
                                            for k, v in by.items()), flush=True)
    use_library(libs["this tree"])
    _build.load_library = load
    return same


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
          + ", ".join(f"{k} {v}" for k, v in mma.items() if k.startswith("paper")), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    paper_ok = check_paper_kernels(dev)
    print("#4 and #9 within tolerance of plain, backward repeatable:", paper_ok, flush=True)
    # #2 and #3 on chip_smoke.py's phase 14 model; the bitwise check on the
    # opacified one, whose fields are dense.
    flex_ok = check_new_kernels(cs.seeded_model(0, opacify=False).to(dev), dev)
    model = cs.seeded_model(0, opacify=True).to(dev)
    print("#2 and #3 within tolerance of plain:", flex_ok, flush=True)
    ok = flex_ok and paper_ok
    if args.parent_csrc is not None and not check_bitwise_against(args.parent_csrc, lib_path,
                                                                   model, dev):
        return 1
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
