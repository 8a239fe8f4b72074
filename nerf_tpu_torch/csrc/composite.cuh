// Device code shared by composite.cu (the compositing scan over a radiance
// field in device memory) and stage.cu (the same scan over a field that the
// block has just computed into shared memory): one ray composited by one
// warp.
//
// Semantics of nerf_tpu/ops/pallas/composite.py (and of the deterministic
// branch of ops/volume.py): dists = z[i+1] - z[i] with a 1e10 sentinel after
// the last sample, scaled by ||ray_dir||; alpha = 1 - exp(-relu(sigma) *
// dist); weight = alpha * T, T the exclusive product of
// max(1 - alpha + 1e-10, 1e-10) (the floor keeps T finite should the compiler
// ever reassociate 1 - alpha + 1e-10 to 0 at alpha = 1; without fast math it
// does not); rgb = sum w * sigmoid(raw); a disparity guarded against empty
// rays; optional white background.

#pragma once

#include <cuda_runtime.h>

namespace composite {

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFullMask, x, o);
  return x;
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// Composites one ray with the calling warp; all 32 lanes must call it. rf:
// the ray's S raw rows [r, g, b, sigma] (device or shared memory); z: its S
// depths; dnorm: ||ray_dir||. Lane l takes samples l, l + 32, ...: the
// transmittance runs as a product scan across the warp (shuffles) within a
// chunk of 32 samples and is carried from chunk to chunk. Writes weights (S,)
// and, from lane 0, rgb (3,), disp, acc and depth.
__device__ __forceinline__ void composite_ray(const float4* rf, const float* __restrict__ z,
                                              float dnorm, int samples, bool white_background,
                                              float* __restrict__ weights,
                                              float* __restrict__ rgb, float* __restrict__ disp,
                                              float* __restrict__ acc,
                                              float* __restrict__ depth) {
  const int lane = threadIdx.x & 31;
  float carry = 1.f;  // transmittance in front of the chunk
  float r = 0.f, g = 0.f, b = 0.f, d = 0.f, a = 0.f;
  for (int c0 = 0; c0 < samples; c0 += 32) {
    const int i = c0 + lane;
    float alpha = 0.f;
    float keep = 1.f;
    float zi = 0.f;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < samples) {
      zi = z[i];
      const float dist = (i + 1 < samples ? z[i + 1] - zi : 1e10f) * dnorm;
      v = rf[i];
      alpha = 1.f - expf(-fmaxf(v.w, 0.f) * dist);
      keep = fmaxf(1.f - alpha + 1e-10f, 1e-10f);
    }
    float inc = keep;  // inclusive product over the chunk's lanes 0..lane
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(kFullMask, inc, o);
      if (lane >= o) inc *= y;
    }
    float excl = __shfl_up_sync(kFullMask, inc, 1);
    if (lane == 0) excl = 1.f;
    if (i < samples) {
      const float w = alpha * (carry * excl);
      weights[i] = w;
      r += w * sigmoid(v.x);
      g += w * sigmoid(v.y);
      b += w * sigmoid(v.z);
      d += w * zi;
      a += w;
    }
    carry *= __shfl_sync(kFullMask, inc, 31);
  }
  r = warp_sum(r);
  g = warp_sum(g);
  b = warp_sum(b);
  d = warp_sum(d);
  a = warp_sum(a);
  if (lane == 0) {
    if (white_background) {
      r += 1.f - a;
      g += 1.f - a;
      b += 1.f - a;
    }
    rgb[0] = r;
    rgb[1] = g;
    rgb[2] = b;
    acc[0] = a;
    depth[0] = d;
    disp[0] = 1.f / fmaxf(1e-10f, d / fmaxf(a, 1e-10f));
  }
}

// ||dir|| of a ray's (3,) direction.
__device__ __forceinline__ float norm3(const float* __restrict__ dir) {
  return sqrtf(dir[0] * dir[0] + dir[1] * dir[1] + dir[2] * dir[2]);
}

}  // namespace composite
