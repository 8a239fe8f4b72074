#!/usr/bin/env python3
"""Time variants of the port's kernels against this tree's, on one NVIDIA GPU.

Run from the root of a checkout, with one card:

    python3 tools/torch_kernel_variants.py [--probe NAME ...] [--csrc NAME=DIR ...]

Builds this tree's ``nerf_tpu_torch/csrc`` ("base"), each ``--csrc`` tree (the
``csrc`` of another checkout or of an earlier state, with the same C
interface) and each ``--probe``: a copy of this tree's ``csrc`` with one
named edit (PROBES below; the probes marked so compute wrong results on
purpose, to show what one part of a kernel costs). Each library is loaded in
turn under this tree's wrappers. For each it prints the flagship kernels'
and Paper kernels' registers, the hottest loop of each f32 4x128 kernel (the
forwards and #8's backward passes) and f32 Paper kernel in its SASS, #1 and #3 bf16 and the #8 bf16 pair against
their plain versions (``chip_smoke.flex_pair_errors``), whether #3 bf16 is
bitwise #1 bf16, and whether its outputs (the f32 #1, #3 and #8 forward's
too, and ``torch_kernel_check.bitwise_results``) equal base's bitwise; then
it times ``torch_kernel_check.timed_calls`` (#1, #2, #3, #4 and #7 in f32
and bf16 at one fine-pass chunk, #6 det also by the profiler's
device time, the #8 and #9 pairs in f32 and bf16 at one training pass) in
turns (base, variants, the variants again in reverse, base), and each
launch of #8's and #9's f32 and bf16 backward by the profiler. Builds go
under ``build/variants/``.
"""

import argparse
import ctypes
import importlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from nerf_tpu_torch.kernels import _build, flex_train, mlp, mlp_t  # noqa: E402
from torch_kernel_check import (  # noqa: E402
    _MODULES, bitwise_results, time_in_turns, timed_calls,
)

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "variants"

# name -> [(file in csrc, text, replacement)].
PROBES = {
    # Wrong results: every B fragment read from k-step 0, so L1-resident.
    "l1_weights": [("tc_mma.cuh",
                    "for (int u = 0; u < kU; ++u) nxt[u] = __ldg(wp + kn * kStep + u);",
                    "for (int u = 0; u < kU; ++u) nxt[u] = __ldg(wp + (kn & 0) * kStep + u);")],
    # Wrong results: the encoding without sincosf.
    "no_sincos": [("flex_tc.cuh", "      sincosf(x * scale, &s, &co);",
                   "      s = x * scale;\n      co = s + 1.f;")],
    # #1's wgmma body (flex_wg.cuh) with one producer warpgroup for three
    # consumers; without the consumers' turns; and, with wrong results,
    # without sincosf or without the heads' sums.
    "wg_one_producer": [("flex_wg.cuh", "constexpr int kConsumers = 2;",
                         "constexpr int kConsumers = 3;"),
                        ("flex_wg.cuh", "constexpr int kProducers = 2;",
                         "constexpr int kProducers = 1;")],
    "wg_no_turns": [("flex_wg.cuh", "{ named_sync(1 + wg, 256); }", "{}"),
                    ("flex_wg.cuh", "    named_arrive(1 + (wg + 1) % kConsumers, 256);\n", ""),
                    ("flex_wg.cuh", "if (wg == kConsumers - 1) named_arrive(1, 256);", ""),
                    ("flex_wg.cuh", "if (wg == 0) named_sync(1, 256);", "")],
    "wg_no_sincos": [("flex_wg.cuh",
                      "        sincosf(x[c] * static_cast<float>(1 << f), &s, &co);",
                      "        s = x[c] * static_cast<float>(1 << f);\n        co = s + 1.f;")],
    "wg_no_heads": [("flex_wg.cuh", "  for (int k = 0; k < KS; ++k) {",
                     "  for (int k = 0; k < 0; ++k) {")],
    # The trunk's k-steps unrolled by 4 instead of 2.
    "unroll4": [("flex_tc.cuh",
                 "a.mac<2>(w + kWx0 + i * kHidden * kHidden, act, kStride, kHidden / 16);",
                 "a.mac<4>(w + kWx0 + i * kHidden * kHidden, act, kStride, kHidden / 16);")],
    # The direction layer's dc rows (DirRayRow: #1, #3, #7, #8 bf16) found by
    # a 32-bit division a row, (tile0 % S + p) / S past tile0 / S, instead
    # of a 64-bit one: the same rows, so the same results.
    "ray_div32": [("tc_mma.cuh",
                   "    float2 b[NT];\n#pragma unroll\n    for (int n = 0; n < NT; ++n) {\n"
                   "      b[n] = make_float2(",
                   "    const long long ray0 = tile0 / samples;\n"
                   "    const int rem = static_cast<int>(tile0 - ray0 * samples);\n"
                   "    float2 b[NT];\n#pragma unroll\n    for (int n = 0; n < NT; ++n) {\n"
                   "      b[n] = make_float2("),
                  ("tc_mma.cuh", "dc + (gp / samples) * kN : nullptr;",
                   "dc + (ray0 + (rem + static_cast<int>(gp - tile0)) / samples) * kN\n"
                   "                                                       : nullptr;")],
    # Wrong results: no dc term at all, neither its division nor its reads.
    "no_dc_rows": [("tc_mma.cuh", "dc + (gp / samples) * kN : nullptr;",
                    "nullptr : nullptr;")],
    # #6's edge copies unrolled by the segment count, not a loop over m.
    "rs_unrolled_edges": [
        ("resample.cu",
         "  for (int i = lane; i < m; i += 32) {\n"
         "    const auto dst = static_cast<unsigned>(__cvta_generic_to_shared(edge + i));\n"
         "    asm volatile(\"cp.async.ca.shared.global [%0], [%1], 4;\\n\" ::\"r\"(dst), "
         "\"l\"(bins + ray * m + i));\n  }",
         "#pragma unroll\n  for (int k = 0; k < 2 * kSegs + 1; ++k) {\n"
         "    const int i = lane + 32 * k;\n    if (i < m) {\n"
         "      const auto dst = static_cast<unsigned>(__cvta_generic_to_shared(edge + i));\n"
         "      asm volatile(\"cp.async.ca.shared.global [%0], [%1], 4;\\n\" ::\"r\"(dst), "
         "\"l\"(bins + ray * m + i));\n    }\n  }")],
    # Wrong results: #6 without its search (one compare), without its scan's
    # shuffles, or without the sum's butterfly.
    "rs_no_search": [("resample.cu", "for (int len = m; len > 1;) {",
                      "for (int len = 1; len > 1;) {")],
    "rs_no_scan": [("resample.cu", "for (int o = 1; o < 32; o <<= 1) {",
                    "for (int o = 32; o < 32; o <<= 1) {")],
    "rs_no_sum": [("resample.cu", "for (int o = 16; o > 0; o >>= 1) sum +=",
                   "for (int o = 0; o > 0; o >>= 1) sum +=")],
    # The f32 4x128 forward (flex_mlp.cuh) with its FMA loop unrolled by 4
    # instead of 2; with ring slots of 16 rows a 128-wide slice instead of 32;
    # or with slots of 8 rows, 72 KB a block and so three blocks an SM (#7's
    # field keeps it at two). The same sums in the same order, so the same
    # results.
    "f32_unroll4": [("flex_mlp.cuh", "#pragma unroll 2\n  for (int k = 0; k < rows; ++k) {",
                     "#pragma unroll 4\n  for (int k = 0; k < rows; ++k) {")],
    "f32_slot16": [("flex_mlp.cuh", "kSlotFloats = 32 * kHidden;",
                    "kSlotFloats = 16 * kHidden;")],
    "f32_three_blocks": [("flex_mlp.cuh", "kSlotFloats = 32 * kHidden;",
                          "kSlotFloats = 8 * kHidden;")],
    # fc_rgb by one thread a point, its three sums interleaved (the same sums).
    "f32_rgb_per_point": [("flex_mlp.cuh", """  for (int i = threadIdx.x; i < 3 * kTile; i += kThreads) {
    const int c = i / kTile;
    const int p = i % kTile;
    float acc = 0.f;
    for (int k = 0; k < kDirHidden; ++k) {
      acc = fmaf(__ldg(params + kOffWr + k * 3 + c), buf_a[k * kTile + p], acc);
    }
    if (tile0 + p < n_points) out[(tile0 + p - out0) * 4 + c] = acc + __ldg(params + kOffBr + c);
  }""", """  if (threadIdx.x < kTile) {
    const int p = threadIdx.x;
    float acc[3] = {0.f, 0.f, 0.f};
    for (int k = 0; k < kDirHidden; ++k) {
      const float h = buf_a[k * kTile + p];
#pragma unroll
      for (int c = 0; c < 3; ++c) acc[c] = fmaf(__ldg(params + kOffWr + k * 3 + c), h, acc[c]);
    }
    if (tile0 + p < n_points) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        out[(tile0 + p - out0) * 4 + c] = acc[c] + __ldg(params + kOffBr + c);
      }
    }
  }""")],
    # The encoding as one item per (frequency, point, coordinate), spread
    # over every thread (x * 2^f and sincosf as before: the same values).
    "f32_encode_flat": [("flex_mlp.cuh", """  for (int i = threadIdx.x; i < kTile * 3; i += kThreads) {
    const int p = i / 3;
    const int c = i % 3;
    const float x = tile0 + p < n_points ? pts[tile0 * 3 + i] : 0.f;
    act[c * kTile + p] = x;
    float scale = 1.f;
#pragma unroll
    for (int f = 0; f < kFreq; ++f) {
      float s, co;
      sincosf(x * scale, &s, &co);
      act[(3 + 6 * f + c) * kTile + p] = s;
      act[(6 + 6 * f + c) * kTile + p] = co;
      scale *= 2.f;
    }
  }""", """  for (int i = threadIdx.x; i < kTile * 3 * (kFreq + 1); i += kThreads) {
    const int f = i / (kTile * 3) - 1;
    const int pc = i % (kTile * 3);
    const int p = pc / 3;
    const int c = pc % 3;
    const float x = tile0 + p < n_points ? pts[tile0 * 3 + pc] : 0.f;
    if (f < 0) {
      act[c * kTile + p] = x;
    } else {
      float s, co;
      sincosf(x * static_cast<float>(1 << f), &s, &co);
      act[(3 + 6 * f + c) * kTile + p] = s;
      act[(6 + 6 * f + c) * kTile + p] = co;
    }
  }""")],
    # Wrong results: the f32 4x128 forward without fc_alpha and fc_rgb, or
    # without sincosf in its encoding.
    "f32_no_heads": [("flex_mlp.cuh", "  if (threadIdx.x < kTile) {\n    const int p = threadIdx.x;",
                      "  if (threadIdx.x < 0) {\n    const int p = threadIdx.x;"),
                     ("flex_mlp.cuh", "for (int i = threadIdx.x; i < 3 * kTile; i += kThreads) {",
                      "for (int i = threadIdx.x; i < 0; i += kThreads) {")],
    "f32_no_sincos": [("flex_mlp.cuh", "      sincosf(x * scale, &s, &co);",
                       "      s = x * scale;\n      co = s + 1.f;")],
    # The f32 weight-gradient pass of #8 and #9 (fma_wgrad.cuh; the same sums
    # in the same order, so the same results): its point loop unrolled by 2
    # (#9's then spills at two blocks an SM), and so at one block an SM.
    "wgrad_unroll2": [("fma_wgrad.cuh", "#pragma unroll 1\n    for (int p = 0; p < kPoints;",
                       "#pragma unroll 2\n    for (int p = 0; p < kPoints;")],
    "wgrad_one_block": [
        ("fma_wgrad.cuh", "#pragma unroll 1\n    for (int p = 0; p < kPoints;",
         "#pragma unroll 2\n    for (int p = 0; p < kPoints;"),
        ("paper_train.cu", "__launch_bounds__(kWThreads, 2)\ntrain_bwd_wgrad_kernel",
         "__launch_bounds__(kWThreads, kBf16 ? 2 : 1)\ntrain_bwd_wgrad_kernel"),
        ("flex_train.cu", "template <bool kBf16>\n__global__ void __launch_bounds__(kWThreads, 2)\n"
                          "train_bwd_wgrad_kernel",
         "template <bool kBf16>\n__global__ void __launch_bounds__(kWThreads, 1)\n"
         "train_bwd_wgrad_kernel")],
    # The weight-gradient pass with three stages in flight (108 KB a block,
    # still two an SM): each copy has two stages' sums to land in.
    "wgrad_three_stages": [
        ("fma_wgrad.cuh", "kSmem = 4 * kBuf * sizeof(float);", "kSmem = 6 * kBuf * sizeof(float);"),
        ("fma_wgrad.cuh",
         "  stage<A, B>(smem, smem + kBuf, res, res_rows, delta, d_rows, job, t_begin, 0, i0, o0);\n",
         "  stage<A, B>(smem, smem + kBuf, res, res_rows, delta, d_rows, job, t_begin, 0, i0, o0);\n"
         "  if (n_stages > 1) {\n"
         "    stage<A, B>(smem + 2 * kBuf, smem + 3 * kBuf, res, res_rows, delta, d_rows, job,"
         " t_begin, 1, i0, o0);\n  }\n"),
        ("fma_wgrad.cuh", "    asm volatile(\"cp.async.wait_group 0;\\n\" ::: \"memory\");\n"
                          "    __syncthreads();\n    const float* xs = smem + (s % 2)",
         "    if (s + 1 < n_stages) {\n"
         "      asm volatile(\"cp.async.wait_group 1;\\n\" ::: \"memory\");\n    } else {\n"
         "      asm volatile(\"cp.async.wait_group 0;\\n\" ::: \"memory\");\n    }\n"
         "    __syncthreads();\n    const float* xs = smem + (s % 3)"),
        ("fma_wgrad.cuh", "    if (s + 1 < n_stages) {\n      float* nx = smem + ((s + 1) % 2) * 2 * kBuf;\n"
                          "      stage<A, B>(nx, nx + kBuf, res, res_rows, delta, d_rows, job, t_begin, s + 1,"
                          " i0, o0);",
         "    if (s + 2 < n_stages) {\n      float* nx = smem + ((s + 2) % 3) * 2 * kBuf;\n"
         "      stage<A, B>(nx, nx + kBuf, res, res_rows, delta, d_rows, job, t_begin, s + 2,"
         " i0, o0);")],
    # Wrong results: the weight-gradient pass stages its first two stages
    # only and sums them over and over: its time without the staging.
    "wgrad_no_staging": [("fma_wgrad.cuh", "    if (s + 1 < n_stages) {\n      float* nx",
                          "    if (s + 1 < 2) {\n      float* nx")],
    # The weight-gradient pass reading two points a step (float2 operands,
    # half the registers of X), its loop unrolled by 2.
    "wgrad_pairs": [("fma_wgrad.cuh", """#pragma unroll 1
    for (int p = 0; p < kPoints; p += 4) {
      float4 x[A];""", """#pragma unroll 2
    for (int p = 0; p < kPoints; p += 2) {
      float2 x[A];"""), ("fma_wgrad.cuh", """        x[a] = *reinterpret_cast<const float4*>(xs + (ty + 16 * a) * kStride + p);""",
                         """        x[a] = *reinterpret_cast<const float2*>(xs + (ty + 16 * a) * kStride + p);"""),
                    ("fma_wgrad.cuh", """        const float4 y = *reinterpret_cast<const float4*>(ys + (tx + 16 * b) * kStride + p);""",
                     """        const float2 y = *reinterpret_cast<const float2*>(ys + (tx + 16 * b) * kStride + p);"""),
                    ("fma_wgrad.cuh", """#pragma unroll
        for (int a = 0; a < A; ++a) acc[a][b] = fmaf(x[a].z, y.z, acc[a][b]);
#pragma unroll
        for (int a = 0; a < A; ++a) acc[a][b] = fmaf(x[a].w, y.w, acc[a][b]);
""", "")],
    # #8's weight-gradient pass on whole 128 x 128 tiles of 8 x 8 a thread
    # for every matrix, not cut to its extent (the same sums, so the same
    # results): what the 15,104 padded products a point would cost.
    "f8_wgrad_square": [("flex_train.cu", "  if (job.in_dim > 64) {\n    if (job.out_dim > 64) {",
                         "  if (true) {\n    if (true) {")],
    # The layer-gradient pass asking L2 for each layer's ReLU-mask rows when
    # its sum starts (prefetch.global.L2, no registers held), so the mask
    # reads after the sum find them there.
    "p9_act_mask_prefetch": [
        ("paper_train.cu", "  float* act = smem;\n  Ring ring{smem + kActFloats, 0};\n",
         "  float* act = smem;\n  Ring ring{smem + kActFloats, 0};\n"
         "  auto prefetch = [](const float* rows, int n) {\n"
         "    for (int i = threadIdx.x; i < n * kTile / 32; i += kThreads) {\n"
         "      asm volatile(\"prefetch.global.L2 [%0];\" ::\"l\"(rows + 32 * i));\n"
         "    }\n  };\n")] + [
        ("paper_train.cu", f"    Block<{w}> b;\n    dense_sum<{w}>(ring, Rows{{wt + {at},",
         f"    Block<{w}> b;\n    prefetch(rrow({row}), {w});\n"
         f"    dense_sum<{w}>(ring, Rows{{wt + {at},")
        for w, at, row in (("kDirWidth", "kTWr", "res_d(dim, 2)"),
                           ("kDirWidth", "kTWd2", "res_d(dim, 1)"),
                           ("kDirWidth", "kTWd1", "res_d(dim, 0)"),
                           ("kWidth", "kTWf", "res_h(dim, 7)"),
                           ("kWidth", "tw_x(i)", "res_h(dim, i - 1)"))],
    "p9_slot32": [("paper_mlp.cuh", "kSlotFloats = 16 * kWidth;", "kSlotFloats = 32 * kWidth;")],
    "p9_unroll2": [("paper_mlp.cuh", "#pragma unroll 4\n  for (int k = 0; k < rows; ++k) {",
                    "#pragma unroll 2\n  for (int k = 0; k < rows; ++k) {")],
    # The layer-gradient pass with each layer's ReLU-mask rows brought into
    # shared memory by cp.async while its product runs.
    "mask_prefetch": [
        ("flex_train.cu",
         "constexpr size_t kActSmemTc = static_cast<size_t>(kBStride) * kTile * "
         "sizeof(__nv_bfloat16);",
         "constexpr size_t kActSmemTc =\n"
         "    static_cast<size_t>(kBStride + tc::kStride) * kTile * sizeof(__nv_bfloat16);"),
        ("flex_train.cu", "              mask + p * tc::kRows + n0 + 8 * n));",
         "              mask + p * tc::kStride + n0 + 8 * n));"),
        ("flex_train.cu",
         "                                              float* __restrict__ drow, bf16* act) {\n"
         "  const int lane = threadIdx.x & 31;",
         "                                              float* __restrict__ drow, bf16* act) {\n"
         "  if (mask != nullptr) {\n"
         "    asm volatile(\"cp.async.wait_group 0;\\n\" ::);\n"
         "    __syncthreads();\n"
         "  }\n"
         "  const int lane = threadIdx.x & 31;"),
        ("flex_train.cu",
         "  float* dt = delta + tile0 * kDRows;\n\n  // Cotangent: drgb into act columns",
         "  float* dt = delta + tile0 * kDRows;\n"
         "  bf16* mk = act + kTile * kBStride;\n"
         "  auto fetch = [&](int row, int cols) {\n"
         "    for (int i = threadIdx.x; i < kTile * (cols / 8); i += kThreads) {\n"
         "      const int p = i / (cols / 8), c = i % (cols / 8);\n"
         "      const uint32_t s = static_cast<uint32_t>(\n"
         "          __cvta_generic_to_shared(mk + p * tc::kStride + 8 * c));\n"
         "      asm volatile(\"cp.async.cg.shared.global [%0], [%1], 16;\\n\" ::\"r\"(s),\n"
         "                   \"l\"(rt + p * tc::kRows + row + 8 * c));\n"
         "    }\n"
         "    asm volatile(\"cp.async.commit_group;\\n\" ::);\n"
         "  };\n\n  // Cotangent: drgb into act columns"),
    ] + [
        ("flex_train.cu", f"    a.mac(w + {b}, act, kBStride, {k});\n"
                          f"    store_grad_tc(a, rt + tc::{row}, dt + {d}, act);",
         f"    fetch(tc::{row}, {cols});\n    a.mac(w + {b}, act, kBStride, {k});\n"
         f"    store_grad_tc(a, mk, dt + {d}, act);")
        for b, k, row, d, cols in (
            ("tc::kBRgb", "1", "kRowHd", "kDHd", "kDirHidden"),
            ("tc::kBDir", "kDirHidden / 16", "kRowFeat", "kDFeat", "kHidden"),
            ("tc::kBHead", "144 / 16", "kRowH3", "kDH3", "kHidden"),
            ("tc::kbx(2)", "kHidden / 16", "kRowH2", "kDH2", "kHidden"),
            ("tc::kbx(1)", "kHidden / 16", "kRowH1", "kDH1", "kHidden"))],
}


def hottest_loops(lib: Path, kernels) -> dict:
    """For each kernel named (``chip_smoke.kernel_label``) in the library's
    SASS (``cuobjdump -sass``): of its innermost loops (a backward branch
    and its target, no other backward branch between them), the one holding
    the most FFMAs, as its instruction count and its FFMA, LDS and other
    counts: how many issue slots its sums take."""
    import re

    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    code, name = {}, None
    for line in sass.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            name = cs.kernel_label(head.group(1))
            code[name] = []
            continue
        ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if name and ins:
            code[name].append((int(ins.group(1), 16), ins.group(2)))
    out = {}
    for k in kernels:
        loops = []
        for at, text in code.get(k, []):
            jump = re.search(r"\bBRA\s+(?:`\(\S+\)\s*)?0x([0-9a-f]+)", text)
            if jump and int(jump.group(1), 16) < at:
                loops.append((int(jump.group(1), 16), at))
        best = None
        for start, end in loops:
            if any(start <= s0 and e0 < end for s0, e0 in loops if (s0, e0) != (start, end)):
                continue
            body = [t.split()[0] if not t.startswith("@") else t.split()[1]
                    for a, t in code[k] if start <= a <= end]
            ffma = sum(op.startswith("FFMA") for op in body)
            if best is None or ffma > best[1]:
                lds = sum(op.startswith("LDS") for op in body)
                best = (len(body), ffma, lds)
        if best:
            out[k] = (f"{best[0]} instructions, {best[1]} FFMA, {best[2]} LDS, "
                      f"{best[0] - best[1] - best[2]} other")
    return out


def probe_csrc(name: str) -> Path:
    """A copy of this tree's csrc with the probe's edits."""
    d = OUT / name / "csrc"
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(ROOT / "nerf_tpu_torch" / "csrc", d)
    for fname, old, new in PROBES[name]:
        path = d / fname
        text = path.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"probe {name}: {fname} holds {text.count(old)} of {old!r}")
        path.write_text(text.replace(old, new))
    return d


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--probe", action="append", default=[], choices=sorted(PROBES))
    ap.add_argument("--csrc", action="append", default=[], metavar="NAME=DIR",
                    help="another tree's nerf_tpu_torch/csrc with this tree's C interface")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    trees = {"base": ROOT / "nerf_tpu_torch" / "csrc"}
    trees.update({name: probe_csrc(name) for name in args.probe})
    trees.update(dict((n, Path(d)) for n, d in (a.split("=", 1) for a in args.csrc)))
    libs = {}
    for name, csrc in trees.items():
        _build.CSRC, _build.BUILD_DIR = csrc, OUT / name / "lib"
        path = _build.build_library()
        libs[name] = ctypes.CDLL(str(path))
        regs = cs.ptxas_summary(path.with_suffix(".log").read_text()).split(", ")
        print(name, ", ".join(r for r in regs if r.startswith(
            ("mlp_t:", "flex_train:", "mlp:", "stage:", "paper_t:", "paper_train:"))), flush=True)
        print(f"{name} hottest loop of each f32 4x128 and f32 Paper kernel: " + "; ".join(
            f"{k} {v}" for k, v in hottest_loops(
                path, cs.F32_FLEX_KERNELS + cs.F32_FLEX_BWD_KERNELS + cs.F32_PAPER_KERNELS
            ).items()), flush=True)

    def use(name):
        _build.load_library = lambda: libs[name]
        for sub in _MODULES:
            mod = importlib.import_module(f"nerf_tpu_torch.{sub}")
            for attr in ("_kernel", "_kernels"):
                if hasattr(mod, attr):
                    getattr(mod, attr).cache_clear()

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    model = cs.seeded_model(cs.SEED, opacify=False).to(dev)
    mods = {sub.split(".")[-1]: importlib.import_module(f"nerf_tpu_torch.{sub}")
            for sub in _MODULES}
    outs = {}
    with torch.no_grad():
        for name in trees:
            use(name)
            res = []
            for n, s in ((1024, 128), (333, 61)):
                pts, dc, params, g = cs.train_case(n, s, model, dev, seed=n * s)
                e = cs.flex_pair_errors(pts, dc, params, g, n, s, "bfloat16")
                out, r = flex_train.flex_train_fwd(pts, dc, params, "bfloat16")
                res += [out, r[0], *flex_train.flex_train_bwd(g, r, params, n, s, "bfloat16")]
                pv, vd = cs.orbit_points(n, s, dev, n + s)
                res.append(mlp_t.fused_mlp_t(model, pv, vd, "bfloat16"))
                res.append(mlp.fused_flexible_mlp_rays(model, pv, vd, "bfloat16"))
                want = mlp_t.mlp_t_plain(model, pv, vd, "bfloat16")
                err, err3 = (float((r - want).abs().max()) for r in res[-2:])
                print(f"{name} ({n}, {s}) bf16: #1 {err:.3e}; #3 {err3:.3e}, bitwise #1 "
                      f"{torch.equal(res[-1], res[-2])}; #8 forward {e['fwd']:.3e}, "
                      f"residuals {e['res']:.3e}, gradients {e['bwd']:.3e}", flush=True)
                f32 = flex_train.flex_train_fwd(pts, dc, params, "float32")
                res += [mlp_t.fused_mlp_t(model, pv, vd, "float32"),
                        mlp.fused_flexible_mlp_rays(model, pv, vd, "float32"), f32[0], f32[1][0]]
            same_code, paper_bf16 = bitwise_results(mods, dev)
            outs[name] = res + same_code + paper_bf16
        for name in list(trees)[1:]:
            same = all(torch.equal(a, b) for a, b in zip(outs["base"], outs[name]))
            print(f"{name} bitwise equal to base: {same}", flush=True)
        calls = {}
        for name in trees:
            use(name)
            calls[name] = timed_calls(mods, dev)
        time_in_turns(calls, list(trees) + list(trees)[::-1], use)
        for call in ("#8 bwd f32", "#8 bwd bf16", "#9 bwd f32", "#9 bwd bf16"):
            for name in trees:
                use(name)
                per = cs.kernel_device_ms(calls[name][call][0], 20, r"train_bwd_\w+?_kernel")
                print(f"ms {call} by launch, {name}: "
                      + ", ".join(f"{k} {v:.4f}" for k, v in per.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
