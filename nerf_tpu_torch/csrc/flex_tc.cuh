// Tensor-core device code of the bf16 4x128 FlexibleNeRF kernels:
// flex_train.cu's training forward, layer-gradient pass and weight-gradient
// pass, mlp.cu's point-major and ray-major forwards and stage.cu's whole
// render stage, at compute dtype bf16. The f32 instances keep flex_mlp.cuh's
// FMA design; mlp_t.cu's bf16 render forward (#1) runs flex_wg.cuh's wgmma
// body, bitwise this tile.
//
// paper_tc.cuh's design at the flagship's widths. Every wide product is
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 (tc_mma.cuh): bf16
// operands, f32 sums, the TPU kernel's preferred_element_type=f32; only the
// summation order differs from the FMA loop. One block of 128 threads = 4
// warps per tile of kTile = 64 points; activations live in shared memory as
// bf16, point-major, act[point][feature], rows of 128 + 8 (a 64-point tile is
// 17 KB, against the FMA design's 64 KB f32 ping-pong pair, so the SM holds
// 4 blocks at 128 registers). M = the 64 points, N = the layer's outputs,
// K = its inputs: each warp computes all 64 points x N / 4 outputs (4 x NT
// m16n8 tiles; NT = 4 for the 128-wide layers, 2 for the 64-wide direction
// layer), its A fragments read with ldmatrix from the shared tile, its B
// fragments from device memory (the whole bf16 weight set is 164 KB and
// stays L2-resident) in fragment order, one k-step ahead. The wrapper packs
// the weights once per call (kernels/mlp.py pack_tc_forward and, with the
// point-major forward's direction rows, pack_tc_forward_points;
// kernels/flex_train.py pack_tc_backward). Layer 1's K is padded 63 -> 64
// with a zero column in the encoding tile and a zero row in the weights.
//
// The forwards share one tile body, forward_tile_with: its caller gives the
// tile's first point, the end of its points and the first row of its output
// (stage.cu runs several tiles a block into a field in shared memory), and
// the direction layer as a policy: DirRayRow adds the ray's row of the
// wrapper's dc (#3, #8, #7); mlp.cu's encodes each point's direction
// into the free encoding tile and sums its 27 rows into the same
// accumulator (#2).
//
// In place: a layer's output tile sits in f32 registers, the block
// synchronises, and the tile is written over its own input (Acc::write).
// The narrow products stay on FMA, in f32 from the bf16 tile: sigma = h3 .
// W_alpha (128 -> 1, read before fc_feat's output is written over h3) and
// rgb = hd . W_rgb (64 -> 3), 2 threads a point.
//
// The encoding is sincosf of x * 2^f in f32 (exact scaling, no fast math: at
// 2^9 the phase must stay f32), rounded to bf16 once, where it is stored.
//
// What bounds it: a 131072 x 128 chunk of the ray-major forward (#3; the
// render forward's body until flex_wg.cuh) takes ~11.8 ms on an NVIDIA H100
// 80GB HBM3 at 700 W, ~233 TFLOP/s, 24% of the bf16 peak.
// tools/torch_kernel_variants.py's probes, in one call on an H100 against
// 12.05-12.17 ms: every weight fragment served from L1 (wrong results)
// 9.8-10.1 ms, so the L2 weight stream costs ~18%; no sincosf (wrong
// results) 11.1-11.2 ms, ~8%; 3 blocks an SM 12.0 ms; the k-steps unrolled
// by 4, 11.7 ms, but the training forward then spills. The rest is the issue
// rate of mma.sync and ldmatrix and the per-layer barriers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "flex_mlp.cuh"
#include "tc_mma.cuh"

namespace flex {
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kWarps = kThreads / 32;     // 4
constexpr int kEncK = 64;                 // kEnc padded to 16
constexpr int kEncStride = kEncK + 8;     // encoding row, bf16
constexpr int kStride = kHidden + 8;      // act row, bf16

// A warp's share of a 128-wide and of a 64-wide layer.
using Acc128 = tcmma::Acc<4, kWarps, kStride>;
using Acc64 = tcmma::Acc<2, kWarps, kStride>;

// Training residual rows of a point, bf16, point-major: res[point][row], enc
// padded to 64 (zero pad), a0 (layer1's output, not ReLU'd), h1, h2, h3,
// feat, hd (post-ReLU).
constexpr int kRowEnc = 0;
constexpr int kRowA0 = kEncK;
constexpr int kRowH1 = kRowA0 + kHidden;
constexpr int kRowH2 = kRowH1 + kHidden;
constexpr int kRowH3 = kRowH2 + kHidden;
constexpr int kRowFeat = kRowH3 + kHidden;
constexpr int kRowHd = kRowFeat + kHidden;
constexpr int kRows = kRowHd + kDirHidden;                 // 768

// Offsets (bf16 elements) of the forward weights: each wide layer in
// fragment order as (N = out, K = in), then fc_alpha (128) and fc_rgb as
// (3, 64), plain.
constexpr int kW1 = 0;                                     // layer1, K 63 -> 64
constexpr int kWx0 = kW1 + kEncK * kHidden;                // layers_xyz.0 .. .2
constexpr int kWf = kWx0 + 3 * kHidden * kHidden;          // fc_feat
constexpr int kWd = kWf + kHidden * kHidden;               // layers_dir.0 feat rows
constexpr int kWa = kWd + kHidden * kDirHidden;            // fc_alpha
constexpr int kWr = kWa + kHidden;                         // fc_rgb
constexpr int kFwdWeights = kWr + 3 * kDirHidden;          // 82240
// The point-major forward (mlp.cu) appends layers_dir.0's direction rows,
// K 27 -> 32 (zero rows), in fragment order.
constexpr int kDirK = 32;
constexpr int kWdDir = kFwdWeights;
constexpr int kFwdWeightsPoints = kWdDir + kDirK * kDirHidden;   // 84288

// Offsets (bf16 elements) of the backward weights, fragment order, for
// dX = dY W (N = the layer's inputs, K = its outputs): fc_rgb (K 3 -> 16),
// layers_dir.0's feat rows, [fc_feat; fc_alpha] (K 129 -> 144),
// layers_xyz.2 .. .0.
constexpr int kBRgb = 0;
constexpr int kBDir = kBRgb + 16 * kDirHidden;
constexpr int kBHead = kBDir + kDirHidden * kHidden;
__host__ __device__ constexpr int kbx(int i) {   // layers_xyz.2 .. .0
  return kBHead + 144 * kHidden + kHidden * kHidden * (2 - i);
}
constexpr int kBwdWeights = kbx(0) + kHidden * kHidden;    // 76800

// Dynamic shared memory of a forward block: the encoding and the activation
// tile, bf16.
constexpr size_t kFwdSmem = static_cast<size_t>(kEncStride + kStride) * kTile * sizeof(bf16);

// Copy `cols` (a multiple of 8) bf16 columns of the tile's rows in shared
// memory to the tile's residual rows res[(tile0 + point) * kRows + r].
__device__ __forceinline__ void save_rows(const bf16* src, int stride, int cols, bf16* res,
                                          long long tile0, int r) {
  if (res == nullptr) return;
  bf16* dst = res + tile0 * kRows + r;
  const int chunks = cols / 8;
  for (int i = threadIdx.x; i < kTile * chunks; i += kThreads) {
    const int p = i / chunks;
    const int c = i - p * chunks;
    *reinterpret_cast<uint4*>(dst + p * kRows + 8 * c) =
        *reinterpret_cast<const uint4*>(src + p * stride + 8 * c);
  }
}

// sum_k act[p][k] w[k] for the tile point p = threadIdx.x / 2, in f32, from
// the bf16 tile; the 2 threads of a point take interleaved pairs of k and the
// sum is complete in both.
__device__ __forceinline__ float head_dot(const bf16* act, const bf16* __restrict__ w, int k_len) {
  const int p = threadIdx.x >> 1;
  float s = 0.f;
  for (int k = 2 * (threadIdx.x & 1); k < k_len; k += 4) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
        act + p * kStride + k));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(w + k));
    s = fmaf(a.x, b.x, s);
    s = fmaf(a.y, b.y, s);
  }
  return s + __shfl_xor_sync(0xffffffffu, s, 1);
}

// The direction layer whose term is the ray's row of dc (rays, 64) f32, the
// ray of point gp being gp / samples (mlp.cu's ray-major kernel,
// flex_train.cu, stage.cu):
// hd = relu(feat . W_dir[:128] + b + dc[ray]) written over feat in `act`.
struct DirRayRow {
  const float* dc;
  int samples;
  __device__ __forceinline__ void operator()(const float* __restrict__ params,
                                             const bf16* __restrict__ w, bf16* /*enc*/,
                                             bf16* act, long long tile0,
                                             long long n_points) const {
    Acc64 a;
    a.mac<2>(w + kWd, act, kStride, kHidden / 16);
    a.bias_act<true>(params + kOffBd, dc, tile0, samples, n_points);
    a.write(act);
  }
};

// The bf16 forward over the tile of points tile0 .. tile0 + kTile - 1,
// flex_mlp.cuh's forward_tile_with on the tensor cores: encoding into `enc`
// (64 x kEncStride), layer1 (no activation), the ReLU trunk, fc_feat (ReLU)
// and sigma (from h3), the direction layer and fc_rgb over `act` (64 x
// kStride) -> row (point - out0) of out (.., 4) [r, g, b, sigma], for the
// points below n_points. Biases come from the f32 parameters (flex_mlp.cuh's
// layout), weights from the bf16 fragments (kW* above). With res non-null
// every layer's stored output is also written to the tile's residual rows.
// It ends without a barrier: a caller that reads `out` from other threads
// syncs first.
//
// dir_layer(params, w, enc, act, tile0, n_points), a struct as DirRayRow,
// writes hd (64 wide) over feat in `act` and returns when it is visible to
// the block. `enc` is free by then (layer1 read it before its output's
// barrier), so the layer may use it.
template <typename DirLayer>
__device__ __forceinline__ void forward_tile_with(const float* __restrict__ pts,
                                                  const float* __restrict__ params,
                                                  const bf16* __restrict__ w,
                                                  float* __restrict__ out, long long out0,
                                                  bf16* res, long long tile0, long long n_points,
                                                  bf16* enc, bf16* act, DirLayer dir_layer) {
  // Encoding, point-major, in the checkpoint's order [x | sin f0 | cos f0 |
  // ...]; points past n_points encode x = 0; column 63 is zero.
  for (int i = threadIdx.x; i < kTile * 3; i += kThreads) {
    const int p = i / 3;
    const int c = i % 3;
    const float x = tile0 + p < n_points ? pts[tile0 * 3 + i] : 0.f;
    bf16* e = enc + p * kEncStride;
    e[c] = __float2bfloat16_rn(x);
    float scale = 1.f;
#pragma unroll
    for (int f = 0; f < kFreqXyz; ++f) {
      float s, co;
      sincosf(x * scale, &s, &co);
      e[3 + 6 * f + c] = __float2bfloat16_rn(s);
      e[6 + 6 * f + c] = __float2bfloat16_rn(co);
      scale *= 2.f;
    }
  }
  if (threadIdx.x < kTile) enc[threadIdx.x * kEncStride + kEnc] = __float2bfloat16_rn(0.f);
  __syncthreads();
  save_rows(enc, kEncStride, kEncK, res, tile0, kRowEnc);

  {  // a0 = layer1(enc), not ReLU'd.
    Acc128 a;
    a.mac<2>(w + kW1, enc, kEncStride, kEncK / 16);
    a.bias_act<false>(params + kOffB1, nullptr, tile0, 1, n_points);
    a.write(act);
    save_rows(act, kStride, kHidden, res, tile0, kRowA0);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {  // h1..h3 = relu(layers_xyz.i(...))
    Acc128 a;
    a.mac<2>(w + kWx0 + i * kHidden * kHidden, act, kStride, kHidden / 16);
    a.bias_act<true>(params + kOffWx + i * kLayerX + kHidden * kHidden, nullptr, tile0, 1,
                     n_points);
    a.write(act);
    save_rows(act, kStride, kHidden, res, tile0, kRowH1 + i * kHidden);
  }
  {  // feat = relu(fc_feat(h3)); sigma = fc_alpha(h3) before feat replaces h3.
    Acc128 a;
    a.mac<2>(w + kWf, act, kStride, kHidden / 16);
    a.bias_act<true>(params + kOffBf, nullptr, tile0, 1, n_points);
    const float s = head_dot(act, w + kWa, kHidden);
    const long long gp = tile0 + (threadIdx.x >> 1);
    if ((threadIdx.x & 1) == 0 && gp < n_points) {
      out[(gp - out0) * 4 + 3] = s + __ldg(params + kOffBa);
    }
    a.write(act);
    save_rows(act, kStride, kHidden, res, tile0, kRowFeat);
  }
  dir_layer(params, w, enc, act, tile0, n_points);
  save_rows(act, kStride, kDirHidden, res, tile0, kRowHd);
  const long long gp = tile0 + (threadIdx.x >> 1);
#pragma unroll
  for (int c = 0; c < 3; ++c) {  // fc_rgb
    const float s = head_dot(act, w + kWr + c * kDirHidden, kDirHidden);
    if ((threadIdx.x & 1) == 0 && gp < n_points) {
      out[(gp - out0) * 4 + c] = s + __ldg(params + kOffBr + c);
    }
  }
}

// The forward over the tile blockIdx.x with DirRayRow, into out (n_points,
// 4) (flex_train.cu).
__device__ __forceinline__ void forward_tile(const float* __restrict__ pts,
                                             const float* __restrict__ dc,
                                             const float* __restrict__ params,
                                             const bf16* __restrict__ w,
                                             float* __restrict__ out, bf16* res,
                                             long long n_points, int samples, bf16* enc,
                                             bf16* act) {
  forward_tile_with(pts, params, w, out, 0, res, static_cast<long long>(blockIdx.x) * kTile,
                    n_points, enc, act, DirRayRow{dc, samples});
}

}  // namespace tc
}  // namespace flex
