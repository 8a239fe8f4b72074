// The point-major and the ray-major fused encode + 4x128 FlexibleNeRF
// forwards, for Hopper (sm_90a).
//
// Replace nerf_tpu/ops/pallas/mlp.py's two kernels, at their public layouts:
//   * fused_flexible_mlp (point-major): pts (N, 3) f32 with one view
//     direction a point, dirs (N, 3) f32 -> raw (N, 4) f32 [r, g, b, sigma].
//     The kernel encodes each point's direction (3 + 24 sinusoids, the
//     checkpoint's interleaved order) and runs the direction layer as one
//     sum over the 128 feat rows and the 27 direction rows of layers_dir.0;
//   * fused_flexible_mlp_rays (ray-major): pts (R, S, 3) f32 and the per-ray
//     direction contribution dc = enc(dirs) @ W_dir[128:] (R, 64) f32, made
//     by the wrapper as the TPU version makes it outside its kernel -> raw
//     (R, S, 4) f32. The function of mlp_t.cu's kernel, with a ray-major dc:
//     a tile's block stages the dc rows of the rays it touches (at most
//     ceil(63 / S) + 1 <= 64) in shared memory once, and each point's row in
//     that stage is a 32-bit division once per point, where mlp_t.cu reads
//     dc[point / S] from device memory once per (point, feature) after a
//     64-bit division.
//
// What bounds them on the card: arithmetic, as for mlp_t.cu. A point costs
// ~82k multiply-adds (the point-major one 27 x 64 more, and 24 sinusoids)
// against 24-28 B of point traffic. Both run flex_mlp.cuh's forward over
// 64-point tiles, one block of 128 threads a tile, activations in two
// feature-major shared buffers of 128 x 64 f32 (64 KB, dynamic shared
// memory), f32 FMAs from registers; only the direction layer differs
// (flex_mlp.cuh's forward_tile_with takes it as a callback). After the trunk
// buf_a's rows 64..127 are free: the point-major kernel encodes the
// directions there, the ray-major one stages its dc rows there. Tensor cores
// are later work.
//
// compute dtype bf16: both matmul operands are rounded to bf16 and the sums
// stay f32, as on the TPU (preferred_element_type=f32). The point-major
// kernel rounds the direction encoding and the direction rows of W_dir too,
// as the TPU kernel does (mlp.py:130-136); the ray-major dc stays f32.

#include "flex_mlp.cuh"

namespace {

using namespace flex;

constexpr size_t kBufBytes = 2 * kHidden * kTile * sizeof(float);
// The ray-major kernel's table of each point's ray within the tile's stage.
constexpr size_t kRaysSmemBytes = kBufBytes + kTile * sizeof(int);

// #2's direction layer: the tile's direction encoding into buf_a rows
// 64..90, then one sum over the feat rows and the 27 direction rows.
template <bool kBf16>
struct DirLayerEncoded {
  const float* params;
  const float* dirs;
  long long tile0;
  long long n_points;
  __device__ __forceinline__ void operator()(const float* feat, float* hd) const {
    float* denc = hd + kDirHidden * kTile;
    encode_tile<kBf16, kFreqDir>(dirs, tile0, n_points, denc);
    __syncthreads();
    dense2<kDirHidden, true, kBf16>(params + kOffWd, kHidden, feat, params + kOffWdDir, kEncDir,
                                    denc, params + kOffBd, hd);
  }
};

// Adds the ray's dc row from the tile's stage in shared memory.
struct AddStagedRow {
  const float* dc_s;
  const int* ray_of;
  __device__ __forceinline__ float operator()(int p, int j, float y) const {
    return y + dc_s[ray_of[p] * kDirHidden + j];
  }
};

// #3's direction layer: the dc rows of the tile's rays (one contiguous run of
// rays * 64 floats from ray0) staged into buf_a rows 64..127, then added.
template <bool kBf16>
struct DirLayerStaged {
  const float* params;
  const float* dc;
  long long ray0;
  int rays;
  const int* ray_of;
  __device__ __forceinline__ void operator()(const float* feat, float* hd) const {
    float* dc_s = hd + kDirHidden * kTile;
    const float* src = dc + ray0 * kDirHidden;
    for (int i = threadIdx.x; i < rays * kDirHidden; i += kThreads) dc_s[i] = __ldg(src + i);
    __syncthreads();
    dense_with<kDirHidden, true, kBf16>(params + kOffWd, params + kOffBd, kHidden, feat, hd,
                                        AddStagedRow{dc_s, ray_of});
  }
};

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
flexible_mlp_kernel(const float* __restrict__ pts, const float* __restrict__ dirs,
                    const float* __restrict__ params, float* __restrict__ out,
                    long long n_points) {
  extern __shared__ float4 smem[];
  float* buf_a = reinterpret_cast<float*>(smem);
  const long long tile0 = static_cast<long long>(blockIdx.x) * kTile;
  forward_tile_with<kBf16>(pts, params, out, 0, nullptr, tile0, n_points, buf_a,
                                  buf_a + kHidden * kTile,
                                  DirLayerEncoded<kBf16>{params, dirs, tile0, n_points});
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
flexible_mlp_rays_kernel(const float* __restrict__ pts, const float* __restrict__ dc,
                         const float* __restrict__ params, float* __restrict__ out,
                         long long n_points, int samples) {
  extern __shared__ float4 smem[];
  float* buf_a = reinterpret_cast<float*>(smem);
  int* ray_of = reinterpret_cast<int*>(buf_a + 2 * kHidden * kTile);
  const long long tile0 = static_cast<long long>(blockIdx.x) * kTile;
  const long long ray0 = tile0 / samples;
  const int rem = static_cast<int>(tile0 - ray0 * samples);   // tile0's sample in its ray
  const long long last = (tile0 + kTile < n_points ? tile0 + kTile : n_points) - 1;
  const int rays = static_cast<int>(last / samples - ray0) + 1;  // <= kTile
  if (threadIdx.x < kTile) ray_of[threadIdx.x] = (rem + static_cast<int>(threadIdx.x)) / samples;
  forward_tile_with<kBf16>(pts, params, out, 0, nullptr, tile0, n_points, buf_a,
                                  buf_a + kHidden * kTile,
                                  DirLayerStaged<kBf16>{params, dc, ray0, rays, ray_of});
}

bool bad_launch(long long n_points) {
  return n_points <= 0 || (n_points + kTile - 1) / kTile > 0x7fffffffLL;
}

template <bool kBf16>
cudaError_t launch_points(const float* pts, const float* dirs, const float* params, float* out,
                          long long n_points, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(flexible_mlp_kernel<kBf16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kBufBytes));
  if (err != cudaSuccess) return err;
  const long long tiles = (n_points + kTile - 1) / kTile;
  flexible_mlp_kernel<kBf16><<<static_cast<unsigned int>(tiles), kThreads, kBufBytes, stream>>>(
      pts, dirs, params, out, n_points);
  return cudaGetLastError();
}

template <bool kBf16>
cudaError_t launch_rays(const float* pts, const float* dc, const float* params, float* out,
                        long long n_points, int samples, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(flexible_mlp_rays_kernel<kBf16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kRaysSmemBytes));
  if (err != cudaSuccess) return err;
  const long long tiles = (n_points + kTile - 1) / kTile;
  flexible_mlp_rays_kernel<kBf16>
      <<<static_cast<unsigned int>(tiles), kThreads, kRaysSmemBytes, stream>>>(
          pts, dc, params, out, n_points, samples);
  return cudaGetLastError();
}

}  // namespace

// Number of floats the point-major kernel's packed parameter buffer must
// hold (the ray-major one takes mlp_t.cu's, nerf_mlp_t_num_params()).
extern "C" int nerf_flexible_mlp_num_params() { return kParamsDir; }

// pts (n_points, 3), dirs (n_points, 3), params (kParamsDir,), out
// (n_points, 4): contiguous f32 device buffers. Returns a cudaError_t.
extern "C" int nerf_flexible_mlp_forward(const float* pts, const float* dirs,
                                         const float* params, long long n_params, float* out,
                                         long long n_points, int bf16, void* stream) {
  if (n_params != kParamsDir || bad_launch(n_points)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = bf16 ? launch_points<true>(pts, dirs, params, out, n_points, s)
                               : launch_points<false>(pts, dirs, params, out, n_points, s);
  return static_cast<int>(err);
}

// pts (n_points, 3), dc (n_points / samples, 64), params (kParams,), out
// (n_points, 4): contiguous f32 device buffers. Returns a cudaError_t.
extern "C" int nerf_flexible_mlp_rays_forward(const float* pts, const float* dc,
                                              const float* params, long long n_params,
                                              float* out, long long n_points, int samples,
                                              int bf16, void* stream) {
  if (n_params != kParams || samples <= 0 || bad_launch(n_points) ||
      n_points % samples != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch_rays<true>(pts, dc, params, out, n_points, samples, s)
           : launch_rays<false>(pts, dc, params, out, n_points, samples, s);
  return static_cast<int>(err);
}
