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
// compute dtype bf16: flex_wg.cuh's forward on wgmma: one persistent,
// warp-specialised block of 512 threads an SM; the wide layers' bf16 images
// (kernels/mlp.py pack_wg_forward, packed once per call) resident in shared
// memory for the launch; two producer warpgroups encode the next tiles while
// two consumer warpgroups run m64nNk16 products from registers, each on a
// 64-point tile. Bitwise flex_tc.cuh's mma.sync tile, which the other bf16
// 4x128 kernels still run: bf16 operands, f32 sums in the same k order,
// activations rounded once, where they become the next layer's input, as the
// TPU kernel's preferred_element_type=f32 products with bf16 operands do.

#include "flex_mlp.cuh"
#include "flex_wg.cuh"

namespace {

using namespace flex;

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
mlp_t_kernel(const float* __restrict__ pts, const float* __restrict__ dc,
             const float* __restrict__ params, const __nv_bfloat16* __restrict__ wbf,
             float* __restrict__ out, long long n_points, int samples) {
  extern __shared__ float4 smem[];
  forward_tile(pts, dc, params, out, nullptr, n_points, samples, reinterpret_cast<float*>(smem));
}

// The persistent bf16 kernel: one block an SM.
template <>
__global__ void __launch_bounds__(wg::kThreads, 1)
mlp_t_kernel<true>(const float* __restrict__ pts, const float* __restrict__ dc,
                   const float* __restrict__ params, const __nv_bfloat16* __restrict__ wbf,
                   float* __restrict__ out, long long n_points, int samples) {
  extern __shared__ float4 smem[];
  wg::forward(pts, dc, params, wbf, out, n_points, samples,
              reinterpret_cast<unsigned char*>(smem));
}

cudaError_t launch_f32(const float* pts, const float* dc, const float* params, float* out,
                       long long n_points, int samples, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      mlp_t_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kForwardSmem));
  if (err != cudaSuccess) return err;
  const long long tiles = (n_points + kTile - 1) / kTile;
  mlp_t_kernel<false><<<static_cast<unsigned int>(tiles), kThreads, kForwardSmem, stream>>>(
      pts, dc, params, nullptr, out, n_points, samples);
  return cudaGetLastError();
}

// As many blocks as fit on the card at once, at most one a unit of
// wg::kConsumers tiles.
cudaError_t launch_bf16(const float* pts, const float* dc, const float* params,
                        const __nv_bfloat16* wbf, float* out, long long n_points, int samples,
                        cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      mlp_t_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, wg::kSmemBytes);
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mlp_t_kernel<true>,
                                                        wg::kThreads, wg::kSmemBytes);
  }
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long unit = static_cast<long long>(wg::kConsumers) * wg::kRows;
  const long long units = (n_points + unit - 1) / unit;
  const long long blocks = static_cast<long long>(sms) * per_sm;
  mlp_t_kernel<true><<<static_cast<unsigned int>(units < blocks ? units : blocks), wg::kThreads,
                       wg::kSmemBytes, stream>>>(pts, dc, params, wbf, out, n_points, samples);
  return cudaGetLastError();
}

}  // namespace

// Number of floats the packed parameter buffer must hold, and of bf16 values
// in the wgmma forward's weight image.
extern "C" int nerf_mlp_t_num_params() { return kParams; }
extern "C" int nerf_mlp_t_wg_weights() { return wg::kNumWeights; }

// pts (n_points, 3), dc (n_points / samples, 64), params (kParams,),
// out (n_points, 4): contiguous f32 device buffers, dc 8-byte and out
// 16-byte aligned; with bf16 != 0 also wbf (wg::kNumWeights,), the bf16
// weight image, 16-byte aligned (ignored for f32). Returns a cudaError_t.
extern "C" int nerf_mlp_t_forward(const float* pts, const float* dc,
                                  const float* params, long long n_params,
                                  const void* wbf, long long n_wbf,
                                  float* out, long long n_points, int samples,
                                  int bf16, void* stream) {
  if (n_params != kParams || samples <= 0 || n_points <= 0 ||
      (bf16 && (wbf == nullptr || n_wbf != wg::kNumWeights)) ||
      n_points % samples != 0 ||
      (n_points + kTile - 1) / kTile > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const __nv_bfloat16*>(wbf);
  const cudaError_t err =
      bf16 ? launch_bf16(pts, dc, params, w, out, n_points, samples, s)
           : launch_f32(pts, dc, params, out, n_points, samples, s);
  return static_cast<int>(err);
}
