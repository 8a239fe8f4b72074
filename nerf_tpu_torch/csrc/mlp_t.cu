// Fused positional encoding + 4x128 FlexibleNeRF forward, for Hopper (sm_90a).
//
// Replaces nerf_tpu/ops/pallas/mlp_t.py:fused_mlp_t. Same function at the
// public layout: pts (N, S, 3) f32, the per-ray direction contribution
// dc = enc(viewdirs) @ W_dir[128:] (N, 64) f32 (computed by the wrapper, as
// the TPU version computes it outside its kernel) -> raw (N, S, 4) f32
// [r, g, b, sigma].
//
// What bounds it on the card: arithmetic. One point costs ~82k multiply-adds
// (63x128 + 3x128x128 + 128x129 + 128x64 + 64x3) against 12 B read and 16 B
// written, so the kernel is far above the memory roofline; what matters is
// keeping the activations out of device memory and the multipliers fed.
//
// compute dtype f32: flex_mlp.cuh's forward_tile on the FMA pipes, which the
// training forward (flex_train.cu), the render stage (stage.cu) and the
// point-major and ray-major forwards (mlp.cu) run too. The f32 FMA rate
// bounds it: 67 TFLOP/s on an H100 SXM at 700 W, ~41 ms for a 131072 x 128
// chunk. The design keeps the FMA pipes fed from registers:
//   * one block of 128 threads per tile of kTile = 64 points; the tile's
//     activations ping-pong between two feature-major shared buffers
//     act[feature][point] of 128 x 64 f32, beside a ring of two 16 KB weight
//     slots: 96 KB of dynamic shared memory, two blocks an SM;
//   * each thread sums an 8-feature x 8-point block of a 128-wide layer's
//     outputs (4 x 8 of the 64-wide direction layer) in registers: per input
//     row it reads two float4s of activations and two of weights from
//     shared memory, each load one conflict-free wavefront, and issues 64
//     FMAs. The design before it gave each thread one feature of a run of 64
//     points: one LDS.128 for every 4 FMAs saturated the shared-memory pipe,
//     and 3 blocks of 64 KB (12 warps) hid little of its latency, ~24
//     TFLOP/s;
//   * the weights reach shared memory by cp.async, 32 rows a slice (64 at
//     the direction layer), the next slice (at a layer's end the next
//     layer's first) in flight while one is summed, one barrier a slice;
//   * every output's sum keeps its order (fmaf over k from 0, + bias, + dc,
//     ReLU), so the outputs are bitwise the one-feature design's;
//   * the encoding is written in the checkpoint's interleaved order
//     [x | sin f0 | cos f0 | sin f1 | ...], so layer 1 takes the checkpoint's
//     rows as they are; the sinusoids are sincosf of x * 2^f (exact in f32),
//     without fast math and without the TPU's double-angle recurrence;
//   * fc_alpha is a 1-wide dot product per point, fc_rgb 3 per point, done
//     by one thread each; the ragged tail of the last tile is masked.
// It runs a 131072 x 128 chunk in 68-69 ms on an NVIDIA H100 80GB HBM3 at
// 700 W, ~40 TFLOP/s, 60% of the f32 FMA peak (the one-feature design
// 115-117 ms; tools/torch_kernel_check.py --parent-csrc). Its innermost loop
// is 83% FFMAs; two blocks an SM (8 warps) leave the per-slice barriers,
// the serial heads and the encoding less to hide behind than three would,
// but three (8-row slices) ran slower (tools/torch_kernel_variants.py).
//
// compute dtype bf16: flex_tc.cuh's forward_tile on the tensor cores
// (mma.sync m16n8k16, bf16 operands, f32 sums, bf16 point-major tiles of
// 17 KB), its weights a bf16 copy in fragment order that the wrapper packs
// once per call (kernels/mlp.py pack_tc_forward). Activations are rounded
// once, where they are stored as the next layer's input, as the TPU kernel's
// preferred_element_type=f32 products with bf16 operands do.

#include "flex_mlp.cuh"
#include "flex_tc.cuh"

namespace {

using namespace flex;

template <bool kBf16>
__device__ __forceinline__ void mlp_t_tile(const float* __restrict__ pts,
                                           const float* __restrict__ dc,
                                           const float* __restrict__ params,
                                           const __nv_bfloat16* __restrict__ wbf,
                                           float* __restrict__ out, long long n_points,
                                           int samples) {
  extern __shared__ float4 smem[];
  if constexpr (kBf16) {
    auto* enc = reinterpret_cast<__nv_bfloat16*>(smem);
    tc::forward_tile(pts, dc, params, wbf, out, nullptr, n_points, samples, enc,
                     enc + tc::kEncStride * kTile);
  } else {
    forward_tile(pts, dc, params, out, nullptr, n_points, samples,
                 reinterpret_cast<float*>(smem));
  }
}

// The f32 instance keeps the FMA design's bounds; the bf16 one is held to
// 128 registers, so that 4 blocks share an SM.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
mlp_t_kernel(const float* __restrict__ pts, const float* __restrict__ dc,
             const float* __restrict__ params, const __nv_bfloat16* __restrict__ wbf,
             float* __restrict__ out, long long n_points, int samples) {
  mlp_t_tile<kBf16>(pts, dc, params, wbf, out, n_points, samples);
}

template <>
__global__ void __launch_bounds__(kThreads, 4)
mlp_t_kernel<true>(const float* __restrict__ pts, const float* __restrict__ dc,
                   const float* __restrict__ params, const __nv_bfloat16* __restrict__ wbf,
                   float* __restrict__ out, long long n_points, int samples) {
  mlp_t_tile<true>(pts, dc, params, wbf, out, n_points, samples);
}

template <bool kBf16>
cudaError_t launch(const float* pts, const float* dc, const float* params,
                   const __nv_bfloat16* wbf, float* out, long long n_points, int samples,
                   cudaStream_t stream) {
  const size_t smem = kBf16 ? tc::kFwdSmem : kForwardSmem;
  cudaError_t err = cudaFuncSetAttribute(
      mlp_t_kernel<kBf16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long tiles = (n_points + kTile - 1) / kTile;
  mlp_t_kernel<kBf16><<<static_cast<unsigned int>(tiles), kThreads, smem,
                        stream>>>(pts, dc, params, wbf, out, n_points, samples);
  return cudaGetLastError();
}

}  // namespace

// Number of floats the packed parameter buffer must hold, and of bf16 values
// in the tensor-core forward's weights.
extern "C" int nerf_mlp_t_num_params() { return kParams; }
extern "C" int nerf_mlp_t_tc_weights() { return tc::kFwdWeights; }

// pts (n_points, 3), dc (n_points / samples, 64), params (kParams,),
// out (n_points, 4): contiguous f32 device buffers, dc 8-byte aligned; with
// bf16 != 0 also wbf (tc::kFwdWeights,), the bf16 weights in fragment order,
// 16-byte aligned (ignored for f32). Returns a cudaError_t.
extern "C" int nerf_mlp_t_forward(const float* pts, const float* dc,
                                  const float* params, long long n_params,
                                  const void* wbf, long long n_wbf,
                                  float* out, long long n_points, int samples,
                                  int bf16, void* stream) {
  if (n_params != kParams || samples <= 0 || n_points <= 0 ||
      (bf16 && (wbf == nullptr || n_wbf != tc::kFwdWeights)) ||
      n_points % samples != 0 ||
      (n_points + kTile - 1) / kTile > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const __nv_bfloat16*>(wbf);
  const cudaError_t err =
      bf16 ? launch<true>(pts, dc, params, w, out, n_points, samples, s)
           : launch<false>(pts, dc, params, w, out, n_points, samples, s);
  return static_cast<int>(err);
}
