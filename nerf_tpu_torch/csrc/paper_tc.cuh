// Tensor-core device code of the bf16 PaperNeRF (8x256) training kernels:
// paper_train.cu's forward, layer-gradient pass and weight-gradient pass, at
// compute dtype bf16. The f32 instances keep paper_mlp.cuh's FMA design; the
// bf16 render forward (paper_t.cu) runs paper_wg.cuh's wgmma body.
//
// Every wide product is mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32:
// bf16 operands, f32 sums, the semantics of the TPU kernel's
// preferred_element_type=f32 (only the summation order differs from the FMA
// loop). mma.sync keeps a warp's accumulators in registers, which the
// in-place design needs: a layer's whole output tile sits in registers, the
// block synchronises, and the tile is written over its own input. The
// instruction wrappers and that accumulator tile (Acc) are tc_mma.cuh's,
// shared with the 4x128 kernels' flex_tc.cuh.
//
// Forward and layer-gradient pass (one block of 256 threads = 8 warps per
// tile of kTile = 64 points): activations live in shared memory as bf16,
// point-major, act[point][feature] with rows of 256 + 8 (the 16-byte pad puts
// the 8 rows an ldmatrix reads on distinct banks). M = the 64 points, N = the
// layer's outputs, K = its inputs: each warp computes all 64 points x
// N / 8 outputs (4 x NT m16n8 tiles, NT = N / 64), its A fragments read with
// ldmatrix from the shared tile, its B fragments read straight from device
// memory (L2-resident: ~1.2 MB of bf16 weights) in fragment order. The
// wrapper packs each weight once per call in that order (kernels/paper_t.py
// pack_tc_forward, kernels/paper_train.py pack_tc_backward): for k-step ks,
// warp w and lane l, the NT x 4 bf16 that lane l's b0..b3 registers hold, so
// a warp reads 256 x NT contiguous bytes a k-step, 16 or 32 per lane. Each
// block reads every weight once per tile (the warps split N), one k-step
// ahead of the products. K is padded to a multiple of 16 with zero rows: the
// encoding width 3 + 6F (63 -> 64 at F = 10, the skip's 319 -> 320).
//
// Narrow products stay on FMA, in f32 from the bf16 tile: sigma = feat .
// W_alpha (256 -> 1) and rgb = d2 . W_rgb (128 -> 3), 4 threads a point. The
// layer-gradient pass pads its narrow product instead: drgb . W_rgb^T is a
// K = 3 -> 16 product, and [dd0; dsigma] . [W_d0; W_alpha]^T one K = 129 ->
// 144 product.
//
// Weight-gradient pass: dW = X^T dY over the points, M = a weight block's
// inputs, N = its outputs, K = points. A block owns a 128 x 128 output tile
// of one weight block and a chunk of point tiles; per 64-point tile it stages
// X (the bf16 residual rows) and dY (the f32 delta rows, rounded to bf16 as
// they are staged) point-major in shared memory and reads both operands with
// ldmatrix.trans. Its bias sums add the unrounded f32 deltas as they pass.
//
// Why mma.sync here: the training forward writes every layer's output to
// the residual rows as it goes, and this tile's in-place structure (a
// layer's whole output in registers, then written over its input) serves
// that and the backward passes alike. The render forward writes no
// residuals and runs paper_wg.cuh's persistent wgmma body instead: on an
// H100 80GB HBM3 at 700 W a 131072 x 128 chunk takes ~31 ms there against
// ~62 ms on this tile (~335 TFLOP/s), which the instruction rate of
// mma.sync and ldmatrix, the per-layer barriers and the L2 weight stream
// (~14%, by a probe that served the weight fragments from L1) hold back.
// Moving #9's forward onto a wgmma body is later work.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "paper_mlp.cuh"
#include "tc_mma.cuh"

namespace paper {
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kWarps = kThreads / 32;   // 8
constexpr int kStride = kWidth + 8;     // act row, bf16

__host__ __device__ constexpr int pad16(int x) { return (x + 15) & ~15; }
__host__ __device__ constexpr int enc_stride(int dim) { return pad16(dim) + 8; }

// Training residual rows of a point, bf16, point-major: res[point][row] with
// enc padded to a multiple of 16 (zero pad), h0..h7, feat, d0..d2.
__host__ __device__ constexpr int res_h(int dim, int i) { return pad16(dim) + kWidth * i; }
__host__ __device__ constexpr int res_feat(int dim) { return pad16(dim) + 8 * kWidth; }
__host__ __device__ constexpr int res_d(int dim, int i) {
  return pad16(dim) + 9 * kWidth + kDirWidth * i;
}
__host__ __device__ constexpr int res_rows(int dim) { return res_d(dim, 3); }

// Offsets (bf16 elements) of the forward weights: each wide layer in fragment
// order (K rows padded to 16; layers_xyz.4 is [enc rows, zero pad, h rows]),
// then fc_alpha (256) and fc_rgb as (3, 128), plain.
struct FwdLayout {
  int w[8], wf, wd[3], wa, wr, total;
};

__host__ __device__ inline FwdLayout make_fwd_layout(int dim) {
  const int kin = pad16(dim);
  FwdLayout t{};
  int off = 0;
  for (int i = 0; i < 8; ++i) {
    t.w[i] = off;
    off += (i == 0 ? kin : i == 4 ? kin + kWidth : kWidth) * kWidth;
  }
  t.wf = off;
  off += kWidth * kWidth;
  t.wd[0] = off;
  off += kWidth * kDirWidth;
  for (int i = 1; i < 3; ++i) {
    t.wd[i] = off;
    off += kDirWidth * kDirWidth;
  }
  t.wa = off;
  off += kWidth;
  t.wr = off;
  off += 3 * kDirWidth;
  t.total = off;
  return t;
}

// Offsets (bf16 elements) of the backward weights, fragment order, for
// dX = dY W (N = the layer's inputs, K = its outputs): fc_rgb (K 3 -> 16),
// layers_dir.2, .1, [layers_dir.0 feat; fc_alpha] (K 129 -> 144), fc_feat,
// layers_xyz.7 .. .1 (layer 4: its h rows).
constexpr int kBRgb = 0;
constexpr int kBD2 = kBRgb + 16 * kDirWidth;
constexpr int kBD1 = kBD2 + kDirWidth * kDirWidth;
constexpr int kBHead = kBD1 + kDirWidth * kDirWidth;
constexpr int kBFeat = kBHead + 144 * kWidth;
__host__ __device__ constexpr int kbx(int i) { return kBFeat + kWidth * kWidth * (8 - i); }
constexpr int kBTotal = kbx(1) + kWidth * kWidth;   // 595968

// Dynamic shared memory of a forward block: the encoding and the activation
// tile, bf16.
inline size_t fwd_smem_bytes(int dim) {
  return static_cast<size_t>(enc_stride(dim) + kStride) * kTile * sizeof(bf16);
}
constexpr size_t kActSmem = static_cast<size_t>(kStride) * kTile * sizeof(bf16);

using tcmma::ldsm4;
using tcmma::ldsm4t;
using tcmma::mma;

// A warp's share of a layer over the tile (tc_mma.cuh): 8 warps, rows of
// kStride.
template <int NT>
using Acc = tcmma::Acc<NT, kWarps, kStride>;

// Copy `cols` (a multiple of 8) bf16 columns of the tile's rows in shared
// memory to the tile's residual rows res[(tile * kTile + point) * rows + r].
__device__ __forceinline__ void save_rows(const bf16* src, int stride, int cols, bf16* res,
                                          int rows, int r) {
  bf16* dst = res + static_cast<long long>(blockIdx.x) * kTile * rows + r;
  const int chunks = cols / 8;
  for (int i = threadIdx.x; i < kTile * chunks; i += kThreads) {
    const int p = i / chunks;
    const int c = i - p * chunks;
    *reinterpret_cast<uint4*>(dst + p * rows + 8 * c) =
        *reinterpret_cast<const uint4*>(src + p * stride + 8 * c);
  }
}

// out = sum_k act[p][k] w[k] for the tile point p = threadIdx.x / 4, in f32,
// from the bf16 tile; the 4 threads of a point take interleaved pairs of k
// (bank-conflict free) and the sum is complete in all four.
__device__ __forceinline__ float head_dot(const bf16* act, const bf16* __restrict__ w, int k_len) {
  const int p = threadIdx.x >> 2;
  const int q = threadIdx.x & 3;
  float s = 0.f;
  for (int k = 2 * q; k < k_len; k += 8) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
        act + p * kStride + k));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(w + k));
    s = fmaf(a.x, b.x, s);
    s = fmaf(a.y, b.y, s);
  }
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  return s;
}

// The bf16 forward over the tile blockIdx.x, paper_mlp.cuh's forward_tile on
// the tensor cores: encoding into `enc` (64 x enc_stride), the trunk, fc_feat,
// sigma, the direction branch and fc_rgb over `act` (64 x kStride). Biases
// come from the f32 parameters (layout L), weights from the bf16 fragments
// (layout T). With res non-null every layer's stored output is also written
// to the tile's residual rows (res_rows(dim) a point).
__device__ __forceinline__ void forward_tile(const float* __restrict__ pts,
                                             const float* __restrict__ dc,
                                             const float* __restrict__ params,
                                             const bf16* __restrict__ w, const Layout& L,
                                             const FwdLayout& T, float* __restrict__ out,
                                             bf16* res, long long n_points, int samples,
                                             int num_freq, bf16* enc, bf16* act) {
  const long long tile0 = static_cast<long long>(blockIdx.x) * kTile;
  const int dim = L.dim;
  const int kin = pad16(dim);
  const int es = enc_stride(dim);
  const int rows = res_rows(dim);
  auto save = [&](const bf16* src, int stride, int cols, int r) {
    if (res != nullptr) save_rows(src, stride, cols, res, rows, r);
  };

  // Encoding, point-major, as paper_mlp.cuh's encode_tile computes it;
  // points past n_points encode x = 0; columns dim .. kin - 1 are zero.
  for (int i = threadIdx.x; i < kTile * 3; i += kThreads) {
    const int p = i / 3;
    const int c = i % 3;
    const float x = tile0 + p < n_points ? pts[tile0 * 3 + i] : 0.f;
    bf16* e = enc + p * es;
    e[c] = __float2bfloat16_rn(x);
    float scale = 1.f;
    for (int f = 0; f < num_freq; ++f) {
      float s, co;
      sincosf(x * scale, &s, &co);
      e[3 + 6 * f + c] = __float2bfloat16_rn(s);
      e[6 + 6 * f + c] = __float2bfloat16_rn(co);
      scale *= 2.f;
    }
  }
  for (int i = threadIdx.x; i < kTile * (kin - dim); i += kThreads) {
    enc[(i / (kin - dim)) * es + dim + i % (kin - dim)] = __float2bfloat16_rn(0.f);
  }
  __syncthreads();
  save(enc, es, kin, 0);

  // The layer loops are unrolled (layer offsets and biases then come from
  // the kernel's parameters as constants).
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    Acc<4> a;
    if (i == 0) {
      a.mac<2>(w + T.w[0], enc, es, kin / 16);
    } else if (i == 4) {
      // Skip: [enc; h3] . W4 as one K = kin + 256 product.
      a.mac<2>(w + T.w[4], enc, es, kin / 16);
      a.mac<2>(w + T.w[4] + kin * kWidth, act, kStride, kWidth / 16);
    } else {
      a.mac<2>(w + T.w[i], act, kStride, kWidth / 16);
    }
    a.bias_act<true>(params + L.b[i], nullptr, tile0, samples, n_points);
    a.write(act);
    save(act, kStride, kWidth, res_h(dim, i));
  }
  {  // feat = fc_feat(h7), not ReLU'd.
    Acc<4> a;
    a.mac<2>(w + T.wf, act, kStride, kWidth / 16);
    a.bias_act<false>(params + L.bf, nullptr, tile0, samples, n_points);
    a.write(act);
    save(act, kStride, kWidth, res_feat(dim));
  }
  {  // sigma from feat; layers_dir.0's write waits for every thread.
    const float s = head_dot(act, w + T.wa, kWidth);
    const long long gp = tile0 + (threadIdx.x >> 2);
    if ((threadIdx.x & 3) == 0 && gp < n_points) out[gp * 4 + 3] = s + __ldg(params + L.ba);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    Acc<2> a;
    a.mac<2>(w + T.wd[i], act, kStride, (i == 0 ? kWidth : kDirWidth) / 16);
    a.bias_act<true>(params + L.bd[i], i == 0 ? dc : nullptr, tile0, samples, n_points);
    a.write(act);
    save(act, kStride, kDirWidth, res_d(dim, i));
  }
  const long long gp = tile0 + (threadIdx.x >> 2);
#pragma unroll
  for (int c = 0; c < 3; ++c) {  // fc_rgb
    const float s = head_dot(act, w + T.wr + c * kDirWidth, kDirWidth);
    if ((threadIdx.x & 3) == 0 && gp < n_points) out[gp * 4 + c] = s + __ldg(params + L.br + c);
  }
}

}  // namespace tc
}  // namespace paper
