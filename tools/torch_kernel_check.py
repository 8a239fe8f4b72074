#!/usr/bin/env python3
"""Compile-and-check the PyTorch port's CUDA kernels on one NVIDIA GPU.

Run from the root of a checkout, with one card:

    python3 tools/torch_kernel_check.py [--parent-csrc DIR]

Builds ``nerf_tpu_torch/csrc`` (printing each kernel's registers and spills),
holds the point-major (#2) and ray-major (#3) 4x128 forwards against their
plain versions at the render path's shapes and a few ragged ones, #3 against
``fused_mlp_t`` (#1, the same function: bitwise), and times each once beside
its plain version and #1. With ``--parent-csrc`` (another tree's
``nerf_tpu_torch/csrc``, e.g. unpacked with ``git archive``) it also builds
that tree and checks that ``fused_mlp_t``, the training pair and the whole
render stage give bitwise the same results from both: the check a change to
the shared device code (``flex_mlp.cuh``) needs. A short first call for a
new kernel; ``chip_smoke.py`` is the full check.
"""

import argparse
import ctypes
import os
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from nerf_tpu_torch.kernels import _build, flex_train, mlp, mlp_t, stage  # noqa: E402


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


def use_library(lib) -> None:
    """Make the kernel wrappers launch from ``lib``."""
    _build.load_library = lambda: lib
    for cached in (mlp_t._kernel, flex_train._kernels, stage._kernel):
        cached.cache_clear()


def check_bitwise_against(parent_csrc: Path, lib_path: Path, model, dev):
    """fused_mlp_t, the training pair and the render stage from both
    libraries, bitwise; then their times at the main paths' shapes from both
    libraries in turns (parent, this tree, this tree, parent)."""
    csrc, build_dir, load = _build.CSRC, _build.BUILD_DIR, _build.load_library
    _build.CSRC, _build.BUILD_DIR = parent_csrc.resolve(), _build.BUILD_DIR / "parent"
    parent_path = _build.build_library()
    _build.CSRC, _build.BUILD_DIR = csrc, build_dir
    print("parent", cs.ptxas_summary(parent_path.with_suffix(".log").read_text(), frames=True),
          flush=True)
    libs = {"parent": ctypes.CDLL(str(parent_path)), "this tree": ctypes.CDLL(str(lib_path))}
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
        torch.cuda.synchronize()
        outs[label] = res
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
            for name, (fn, reps) in fns.items():
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
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    # #2 and #3 on chip_smoke.py's phase 14 model; the bitwise check on the
    # opacified one, whose fields are dense.
    ok = check_new_kernels(cs.seeded_model(0, opacify=False).to(dev), dev)
    model = cs.seeded_model(0, opacify=True).to(dev)
    print("#2 and #3 within tolerance of plain:", ok, flush=True)
    if args.parent_csrc is not None and not check_bitwise_against(args.parent_csrc, lib_path,
                                                                   model, dev):
        return 1
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
