#!/usr/bin/env python3
"""Compile-and-check the PyTorch port's CUDA kernels on one NVIDIA GPU.

Run from the root of a checkout, with one card:

    python3 tools/torch_kernel_check.py [--parent-csrc DIR]

Builds ``nerf_tpu_torch/csrc`` (printing each kernel's registers and spills),
holds the compositing (#5), resampling (#6) and whole-stage (#7) kernels
against their plain versions at the render path's shapes and a few ragged
ones, and times each once beside its plain version. With ``--parent-csrc``
(another tree's ``nerf_tpu_torch/csrc``, e.g. unpacked with ``git archive``)
it also builds that tree and checks that ``fused_mlp_t`` and the training
pair give bitwise the same results from both: the check a change to the
shared device code (``flex_mlp.cuh``) needs. A short first call for a new
kernel; ``chip_smoke.py`` is the full check.
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
from nerf_tpu_torch.kernels import _build, composite, flex_train, mlp_t, resample, stage  # noqa: E402


def rays(n, s, dev, seed):
    """Orbit points and viewdirs, sorted depths in [2, 6] and directions."""
    pts, vd = cs.orbit_points(n, s, dev, seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    z = torch.sort(2.0 + 4.0 * torch.rand(n, s, generator=g, device=dev), dim=-1)[0]
    return pts, vd, z, vd * (1.0 + torch.rand(n, 1, generator=g, device=dev))


def errs(got, want):
    return {k: float((got[k] - want[k]).abs().max()) for k in got}


def check_new_kernels(model, dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.inference_mode():
        for n, s in ((131072, 64), (131072, 128), (333, 61), (1, 1), (5, 33)):
            pts, vd, z, rd = rays(n, s, dev, n + s)
            rf = mlp_t.fused_mlp_t(model, pts, vd)
            for wb in (False, True):
                got = composite.fused_volume_render(rf, z, rd, wb)
                torch.cuda.synchronize()
                print("composite", n, s, wb, errs(got, composite.volume_render_plain(rf, z, rd, wb)),
                      flush=True)
            rnd = torch.randn(n, s, 4, generator=gen, device=dev) * 2
            got = composite.fused_volume_render(rnd, z, rd, True)
            print("composite rand", n, s,
                  errs(got, composite.volume_render_plain(rnd, z, rd, True)))
            for dt in ("float32", "bfloat16"):
                got = stage.fused_render_stage(model, pts, vd, z, rd, True, dt)
                torch.cuda.synchronize()
                print("stage", n, s, dt,
                      errs(got, stage.render_stage_plain(model, pts, vd, z, rd, True, dt)),
                      flush=True)
        for n, m, s in ((131072, 63, 64), (333, 61, 61), (7, 2, 5), (3, 700, 130)):
            z = rays(n, m, dev, n + m)[2]
            w = torch.rand(n, m - 1, generator=gen, device=dev) ** 4
            w[0] = 0
            for kw in ({"det": True}, {"u": torch.rand(n, s, generator=gen, device=dev)}):
                if "u" in kw:
                    kw["u"][0, 0] = 1.0
                got = resample.fused_sample_pdf(z, w, s, **kw)
                torch.cuda.synchronize()
                e = (got - resample.sample_pdf(z, w, s, **kw)).abs()
                print("resample", n, m, s, list(kw)[0], "max", float(e.max()), "over 1e-5",
                      int((e > 1e-5).sum()), flush=True)

        n, s = 131072, 128
        pts, vd, z, rd = rays(n, s, dev, 1)
        rf = mlp_t.fused_mlp_t(model, pts, vd)
        print("ms composite", cs.cuda_ms(lambda: composite.fused_volume_render(rf, z, rd, True), 20),
              "plain", cs.cuda_ms(lambda: composite.volume_render_plain(rf, z, rd, True), 5))
        w = torch.rand(n, 62, generator=gen, device=dev)
        zz = torch.sort(2.0 + 4.0 * torch.rand(n, 63, generator=gen, device=dev), dim=-1)[0]
        print("ms resample", cs.cuda_ms(lambda: resample.fused_sample_pdf(zz, w, 64, det=True), 20),
              "plain", cs.cuda_ms(lambda: resample.sample_pdf(zz, w, 64, det=True), 5))
        print("ms stage", cs.cuda_ms(lambda: stage.fused_render_stage(model, pts, vd, z, rd, True), 2),
              "mlp_t", cs.cuda_ms(lambda: mlp_t.fused_mlp_t(model, pts, vd), 2), flush=True)


def check_bitwise_against(parent_csrc: Path, lib_path: Path, model, dev):
    """fused_mlp_t and the training pair from both libraries, bitwise."""
    csrc, build_dir, load = _build.CSRC, _build.BUILD_DIR, _build.load_library
    _build.CSRC, _build.BUILD_DIR = parent_csrc.resolve(), _build.BUILD_DIR / "parent"
    parent = ctypes.CDLL(str(_build.build_library()))
    _build.CSRC, _build.BUILD_DIR = csrc, build_dir
    outs = {}
    for label, lib in (("parent", parent), ("this tree", ctypes.CDLL(str(lib_path)))):
        _build.load_library = lambda lib=lib: lib
        mlp_t._kernel.cache_clear()
        flex_train._kernels.cache_clear()
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
        torch.cuda.synchronize()
        outs[label] = res
    _build.load_library = load
    mlp_t._kernel.cache_clear()
    flex_train._kernels.cache_clear()
    same = all(torch.equal(a, b) for a, b in zip(outs["parent"], outs["this tree"]))
    print("bitwise equal to parent:", same, len(outs["this tree"]))
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
    print(cs.ptxas_summary(lib_path.with_suffix(".log").read_text()))
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    model = cs.seeded_model(0, opacify=True).to(dev)
    check_new_kernels(model, dev)
    if args.parent_csrc is not None and not check_bitwise_against(args.parent_csrc, lib_path,
                                                                   model, dev):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
