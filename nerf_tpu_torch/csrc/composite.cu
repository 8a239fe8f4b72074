// One-pass volume compositing of a sampled radiance field, for Hopper (sm_90a).
//
// Replaces nerf_tpu/ops/pallas/composite.py:fused_volume_render. Same
// function at the public layout: raw (N, S, 4) f32 [r, g, b, sigma] (as
// mlp_t.cu writes it), depths (N, S), un-normalized directions (N, 3) ->
// rgb (N, 3), disp (N,), acc (N,), depth (N,), weights (N, S), all f32;
// deterministic (no sigma noise), optional white background.
//
// What bounds it on the card: bytes. A sample is read once (16 B of field,
// 4 B of depth) and its weight written once (4 B), against ~25 operations,
// so the least time is the traffic over the memory rate (~0.12 ms at
// 131072 x 128). The design reads everything once, coalesced:
//   * one warp per ray, 8 rays a block of 256 threads;
//   * lane l takes samples l, l + 32, ... (a warp's float4 loads of the
//     field are 512 contiguous bytes); the transmittance is a product scan
//     across the warp with shuffles, carried over chunks of 32 samples, so
//     there is no serial walk over S (composite.cuh);
//   * rgb, depth and acc are per-lane sums reduced across the warp at the
//     end; the TPU kernel's sequential fori_loop becomes this scan.

#include "composite.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRaysPerBlock = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
composite_kernel(const float4* __restrict__ rf, const float* __restrict__ z,
                 const float* __restrict__ dirs, float* __restrict__ rgb,
                 float* __restrict__ disp, float* __restrict__ acc,
                 float* __restrict__ depth, float* __restrict__ weights,
                 long long n_rays, int samples, bool white_background) {
  const long long ray = static_cast<long long>(blockIdx.x) * kRaysPerBlock + threadIdx.x / 32;
  if (ray >= n_rays) return;  // the whole warp leaves together
  const long long at = ray * samples;
  composite::composite_ray(rf + at, z + at, composite::norm3(dirs + ray * 3), samples,
                           white_background, weights + at, rgb + ray * 3, disp + ray,
                           acc + ray, depth + ray);
}

}  // namespace

// rf (n_rays, samples, 4), z (n_rays, samples), dirs (n_rays, 3) in;
// rgb (n_rays, 3), disp, acc, depth (n_rays,), weights (n_rays, samples) out:
// contiguous f32 device buffers. Returns a cudaError_t.
extern "C" int nerf_composite_forward(const float* rf, const float* z, const float* dirs,
                                      float* rgb, float* disp, float* acc, float* depth,
                                      float* weights, long long n_rays, int samples,
                                      int white_background, void* stream) {
  if (n_rays <= 0 || samples <= 0 ||
      (n_rays + kRaysPerBlock - 1) / kRaysPerBlock > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = (n_rays + kRaysPerBlock - 1) / kRaysPerBlock;
  composite_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(rf), z, dirs, rgb, disp, acc, depth, weights, n_rays,
      samples, white_background != 0);
  return static_cast<int>(cudaGetLastError());
}
