// A whole render stage of the 4x128 FlexibleNeRF, for Hopper (sm_90a):
// positional encoding + MLP + compositing, with the radiance field kept on
// chip.
//
// Replaces nerf_tpu/ops/pallas/stage.py:fused_render_stage. Same function
// at the public layout: sample points (N, S, 3), depths (N, S), un-normalized
// directions (N, 3) and the per-ray direction contribution
// dc = enc(viewdirs) @ W_dir[128:] (N, 64) (computed by the wrapper, as the
// TPU version computes it outside its kernel) -> rgb (N, 3), disp, acc,
// depth (N,), weights (N, S), all f32. Matmul operands f32 or bf16 (f32
// sums), compositing f32.
//
// What bounds it on the card: arithmetic, as for mlp_t.cu (~82k
// multiply-adds a point); the compositing adds ~25 operations and no device
// traffic for the field, which is the stage's whole point: the (N, S, 4)
// field never reaches device memory.
//
// Design: a block of 128 threads owns R = max(1, 512 / S) whole rays (512
// points at S = 64 or 128: 8 tiles of 64), because its scan must see every
// sample of a ray. It runs the ceil(R * S / 64) tiles of its points in order,
// each writing its rows of the field into shared memory (R * S x 4 f32);
// points of the last tile that belong to the next block are masked. Then each
// of the 4 warps composites rays of the block from shared memory with
// composite.cuh's warp scan and writes the maps and weights.
//   * f32: the MLP is flex_mlp.cuh's forward_tile_at (mlp_t.cu's note), its
//     96 KB of activation buffers and weight ring before the field: 104 KB
//     at R * S = 512, so two blocks an SM, as for mlp_t.cu's f32 kernel;
//   * bf16: the MLP is flex_tc.cuh's tensor-core tile (forward_tile_with
//     with DirRayRow), whose sums mlp_t.cu's bf16 body (flex_wg.cuh) takes in
//     the same order, on bf16 weight fragments (kernels/mlp.py
//     pack_tc_forward): 26 KB of bf16 tiles + 8 KB of field at R * S = 512,
//     so four blocks an SM at 128 registers. Per point it computes what
//     mlp_t.cu's bf16 kernel computes
//     (the mma rows are independent, the heads per point, the epilogue
//     elementwise) and per ray what composite.cu computes, so its maps are
//     bitwise those of #5 on #1's bf16 field.
// The TPU kernel takes the exclusive transmittance in log space as a
// triangular matmul; here it is the product scan of composite.cu: only the
// association of the product differs.

#include "composite.cuh"
#include "flex_mlp.cuh"
#include "flex_tc.cuh"

namespace {

using namespace flex;
using bf16 = __nv_bfloat16;

constexpr int kPointsPerBlock = 512;
constexpr int kMaxSamples = 4096;   // field rows of one ray: 64 KB of shared memory

// Each warp composites rays of the block's field (rays * samples, 4) in
// shared memory and writes their maps.
__device__ __forceinline__ void composite_block(const float* field, const float* __restrict__ z,
                                                const float* __restrict__ dirs,
                                                float* __restrict__ rgb, float* __restrict__ disp,
                                                float* __restrict__ acc,
                                                float* __restrict__ depth,
                                                float* __restrict__ weights, long long ray0,
                                                int rays, int samples, bool white_background) {
  for (int r = threadIdx.x / 32; r < rays; r += kThreads / 32) {
    const long long ray = ray0 + r;
    const long long at = ray * samples;
    composite::composite_ray(reinterpret_cast<const float4*>(field) + r * samples, z + at,
                             composite::norm3(dirs + ray * 3), samples, white_background,
                             weights + at, rgb + ray * 3, disp + ray, acc + ray, depth + ray);
  }
}

// The primary template is the f32 instance (wbf unused); the bf16 one is
// specialized below.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
stage_kernel(const float* __restrict__ pts, const float* __restrict__ z,
             const float* __restrict__ dirs, const float* __restrict__ dc,
             const float* __restrict__ params, const bf16* __restrict__ wbf,
             float* __restrict__ rgb, float* __restrict__ disp, float* __restrict__ acc,
             float* __restrict__ depth, float* __restrict__ weights, long long n_rays,
             int samples, int rays_per_block, bool white_background) {
  static_assert(!kBf16, "the bf16 instance is the specialization below");
  extern __shared__ float4 smem[];
  float* mlp = reinterpret_cast<float*>(smem);
  float* field = mlp + kForwardSmem / sizeof(float);  // (rays * samples, 4), the block's field
  const long long ray0 = static_cast<long long>(blockIdx.x) * rays_per_block;
  const int rays = static_cast<int>(min(static_cast<long long>(rays_per_block), n_rays - ray0));
  const long long p0 = ray0 * samples;
  const long long p_end = p0 + static_cast<long long>(rays) * samples;
  for (long long tile0 = p0; tile0 < p_end; tile0 += kTile) {
    forward_tile_at(pts, dc, params, field, p0, nullptr, tile0, p_end, samples, mlp);
    __syncthreads();
  }
  composite_block(field, z, dirs, rgb, disp, acc, depth, weights, ray0, rays, samples,
                  white_background);
}

// The bf16 instance: the tensor-core tile, held to 128 registers so that 4
// blocks share an SM. Tiles need no barrier between them: a tile's first
// writes go to `enc`, whose last reader (layer 1 of the tile before) passed
// two barriers since, and its first writes to `act` follow a barrier that
// ends the tile before's reads; only the field needs one before the scan.
template <>
__global__ void __launch_bounds__(kThreads, 4)
stage_kernel<true>(const float* __restrict__ pts, const float* __restrict__ z,
                   const float* __restrict__ dirs, const float* __restrict__ dc,
                   const float* __restrict__ params, const bf16* __restrict__ wbf,
                   float* __restrict__ rgb, float* __restrict__ disp, float* __restrict__ acc,
                   float* __restrict__ depth, float* __restrict__ weights, long long n_rays,
                   int samples, int rays_per_block, bool white_background) {
  extern __shared__ float4 smem[];
  auto* enc = reinterpret_cast<bf16*>(smem);
  bf16* act = enc + tc::kEncStride * kTile;
  float* field = reinterpret_cast<float*>(smem) + tc::kFwdSmem / sizeof(float);
  const long long ray0 = static_cast<long long>(blockIdx.x) * rays_per_block;
  const int rays = static_cast<int>(min(static_cast<long long>(rays_per_block), n_rays - ray0));
  const long long p0 = ray0 * samples;
  const long long p_end = p0 + static_cast<long long>(rays) * samples;
  for (long long tile0 = p0; tile0 < p_end; tile0 += kTile) {
    tc::forward_tile_with(pts, params, wbf, field, p0, nullptr, tile0, p_end, enc, act,
                          tc::DirRayRow{dc, samples});
  }
  __syncthreads();
  composite_block(field, z, dirs, rgb, disp, acc, depth, weights, ray0, rays, samples,
                  white_background);
}

template <bool kBf16>
cudaError_t launch(const float* pts, const float* z, const float* dirs, const float* dc,
                   const float* params, const bf16* wbf, float* rgb, float* disp, float* acc,
                   float* depth, float* weights, long long n_rays, int samples,
                   bool white_background, cudaStream_t stream) {
  const int rays_per_block = samples >= kPointsPerBlock ? 1 : kPointsPerBlock / samples;
  const size_t smem = (kBf16 ? tc::kFwdSmem : kForwardSmem) +
                      static_cast<size_t>(rays_per_block) * samples * 4 * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      stage_kernel<kBf16>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long blocks = (n_rays + rays_per_block - 1) / rays_per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  stage_kernel<kBf16><<<static_cast<unsigned int>(blocks), kThreads, smem, stream>>>(
      pts, z, dirs, dc, params, wbf, rgb, disp, acc, depth, weights, n_rays, samples,
      rays_per_block, white_background);
  return cudaGetLastError();
}

}  // namespace

// The largest number of samples a ray the kernel takes.
extern "C" int nerf_stage_max_samples() { return kMaxSamples; }

// pts (n_rays, samples, 3), z (n_rays, samples), dirs (n_rays, 3),
// dc (n_rays, 64), params (kParams,) in; rgb (n_rays, 3), disp, acc, depth
// (n_rays,), weights (n_rays, samples) out: contiguous f32 device buffers, dc
// 8-byte aligned; with bf16 != 0 also wbf (tc::kFwdWeights,), mlp_t.cu's bf16
// weights in fragment order, 16-byte aligned (ignored for f32). Returns a
// cudaError_t.
extern "C" int nerf_stage_forward(const float* pts, const float* z, const float* dirs,
                                  const float* dc, const float* params, long long n_params,
                                  const void* wbf, long long n_wbf, float* rgb, float* disp,
                                  float* acc, float* depth, float* weights, long long n_rays,
                                  int samples, int white_background, int bf16, void* stream) {
  if (n_params != kParams || n_rays <= 0 || samples <= 0 || samples > kMaxSamples ||
      (bf16 && (wbf == nullptr || n_wbf != tc::kFwdWeights))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool white = white_background != 0;
  const auto* w = static_cast<const __nv_bfloat16*>(wbf);
  const cudaError_t err =
      bf16 ? launch<true>(pts, z, dirs, dc, params, w, rgb, disp, acc, depth, weights, n_rays,
                          samples, white, s)
           : launch<false>(pts, z, dirs, dc, params, w, rgb, disp, acc, depth, weights, n_rays,
                           samples, white, s);
  return static_cast<int>(err);
}
