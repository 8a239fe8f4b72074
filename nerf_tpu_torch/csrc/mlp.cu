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
//     (R, S, 4) f32. The function of mlp_t.cu's kernel, with a ray-major dc.
//
// What bounds them on the card: arithmetic, as for mlp_t.cu. A point costs
// ~82k multiply-adds (the point-major one 27 x 64 more, and 24 sinusoids)
// against 24-28 B of point traffic.
//
// compute dtype f32: flex_mlp.cuh's forward over 64-point tiles, the design
// mlp_t.cu's note sets out (one block of 128 threads a tile, 8 x 8 output
// blocks a thread summed in registers, weights staged by cp.async, 96 KB of
// dynamic shared memory); only the direction layer differs (flex_mlp.cuh's
// forward_tile_with takes it as a callback, and it runs flex_mlp.cuh's
// dense: #2's over its two blocks of rows, feat's then the direction's).
// After the trunk buf_a's rows 64..127 are free: the point-major kernel
// encodes the directions there; the ray-major one stages the dc rows of the
// rays its tile touches (at most ceil(63 / S) + 1 <= 64) there once, and
// each point's row in that stage is a 32-bit division once per point. Its output is bitwise mlp_t.cu's f32 output. The f32 instances
// stay on the FMA pipes: a product on the tensor cores at f32 accuracy
// (3xTF32) is a change for the whole family, and #3 alone on it would no
// longer be bitwise #1.
//
// compute dtype bf16: flex_tc.cuh's forward_tile_with on the tensor cores
// (mma.sync m16n8k16, 17 KB bf16 point-major tiles, 4 blocks an SM at 128
// registers) with its L2-streamed weight fragments, mlp_t.cu's bf16 body
// until flex_wg.cuh took its place.
//   * ray-major: that tile on the weights kernels/mlp.py pack_tc_forward
//     packs, with DirRayRow (each point's ray is point / S, its dc row read
//     in the direction layer's epilogue): the same sums in the same order as
//     mlp_t.cu's bf16 body (flex_wg.cuh) and the same dc rows, so its output
//     is bitwise mlp_t.cu's bf16 output;
//   * point-major: on pack_tc_forward_points' weights (pack_tc_forward's
//     buffer, then the 27 direction rows of layers_dir.0 padded to K 32 with
//     zero rows). Its direction layer (DirEncodedTc) encodes the tile's
//     directions into the encoding tile, free since layer 1, and accumulates
//     feat (K 128) and the encoding (K 32) into one f32 tile before the bias
//     and the ReLU.
//
// compute dtype bf16: both matmul operands are rounded to bf16 and the sums
// stay f32, as on the TPU (preferred_element_type=f32). The point-major
// kernel rounds the direction encoding and the direction rows of W_dir too,
// as the TPU kernel does (mlp.py:130-136); the ray-major dc stays f32.

#include "flex_mlp.cuh"
#include "flex_tc.cuh"

namespace {

using namespace flex;

// The ray-major kernel's table of each point's ray within the tile's stage
// follows the forward's shared memory.
constexpr size_t kRaysSmemBytes = kForwardSmem + kTile * sizeof(int);

// #2's f32 direction layer: the tile's direction encoding into buf_a rows
// 64..90, then one sum over the feat rows and the 27 direction rows.
struct DirLayerEncoded {
  const float* params;
  const float* dirs;
  long long tile0;
  long long n_points;
  __device__ __forceinline__ void operator()(const float* feat, float* hd, Ring& ring) const {
    float* denc = hd + kDirHidden * kTile;
    encode_tile<kFreqDir>(dirs, tile0, n_points, denc);
    __syncthreads();
    dense<kDirHidden, true>(ring, Rows{params + kOffWd, kHidden, feat},
                            Rows{params + kOffWdDir, kEncDir, denc}, params + kOffBd, hd,
                            AddNothing{}, Slice{nullptr, 0});
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

// #3's f32 direction layer: the dc rows of the tile's rays (one contiguous
// run of rays * 64 floats from ray0) staged into buf_a rows 64..127, then
// added.
struct DirLayerStaged {
  const float* params;
  const float* dc;
  long long ray0;
  int rays;
  const int* ray_of;
  __device__ __forceinline__ void operator()(const float* feat, float* hd, Ring& ring) const {
    float* dc_s = hd + kDirHidden * kTile;
    const float* src = dc + ray0 * kDirHidden;
    for (int i = threadIdx.x; i < rays * kDirHidden; i += kThreads) dc_s[i] = __ldg(src + i);
    __syncthreads();
    dense<kDirHidden, true>(ring, Rows{params + kOffWd, kHidden, feat}, params + kOffBd, hd,
                            AddStagedRow{dc_s, ray_of}, Slice{nullptr, 0});
  }
};

// #2's bf16 direction layer: the tile's view directions encoded into `enc`
// in the checkpoint's order [d | sin f0 | cos f0 | ... f3] (sincosf of
// d * 2^f in f32, rounded to bf16 once where stored; points past n_points
// encode d = 0), columns 27..31 zero, then one f32 sum over feat (K 128) and
// the encoding (K 32) with layers_dir.0's feat and direction rows, the bias
// and the ReLU; hd is written over feat in `act`.
struct DirEncodedTc {
  const float* dirs;
  __device__ __forceinline__ void operator()(const float* __restrict__ params,
                                             const __nv_bfloat16* __restrict__ w,
                                             __nv_bfloat16* enc, __nv_bfloat16* act,
                                             long long tile0, long long n_points) const {
    for (int i = threadIdx.x; i < kTile * 3; i += kThreads) {
      const int p = i / 3;
      const int c = i % 3;
      const float x = tile0 + p < n_points ? dirs[tile0 * 3 + i] : 0.f;
      __nv_bfloat16* e = enc + p * tc::kEncStride;
      e[c] = __float2bfloat16_rn(x);
      float scale = 1.f;
#pragma unroll
      for (int f = 0; f < kFreqDir; ++f) {
        float s, co;
        sincosf(x * scale, &s, &co);
        e[3 + 6 * f + c] = __float2bfloat16_rn(s);
        e[6 + 6 * f + c] = __float2bfloat16_rn(co);
        scale *= 2.f;
      }
    }
    constexpr int kPad = tc::kDirK - kEncDir;   // 5 zero columns: NaN . 0 is NaN
    for (int i = threadIdx.x; i < kTile * kPad; i += kThreads) {
      enc[(i / kPad) * tc::kEncStride + kEncDir + i % kPad] = __float2bfloat16_rn(0.f);
    }
    __syncthreads();
    tc::Acc64 a;
    a.mac<2>(w + tc::kWd, act, tc::kStride, kHidden / 16);
    a.mac<2>(w + tc::kWdDir, enc, tc::kEncStride, tc::kDirK / 16);
    a.bias_act<true>(params + kOffBd, nullptr, tile0, 1, n_points);
    a.write(act);
  }
};

// The primary template is the f32 instance, on the FMA design with its
// bounds (wbf unused); the bf16 one, specialized below, runs on the tensor
// cores, held to 128 registers so that 4 blocks share an SM.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
flexible_mlp_kernel(const float* __restrict__ pts, const float* __restrict__ dirs,
                    const float* __restrict__ params, const __nv_bfloat16* __restrict__ wbf,
                    float* __restrict__ out, long long n_points) {
  static_assert(!kBf16, "the bf16 instance is the specialization below");
  extern __shared__ float4 smem[];
  const long long tile0 = static_cast<long long>(blockIdx.x) * kTile;
  forward_tile_with(pts, params, out, 0, nullptr, tile0, n_points,
                    reinterpret_cast<float*>(smem),
                    DirLayerEncoded{params, dirs, tile0, n_points});
}

template <>
__global__ void __launch_bounds__(kThreads, 4)
flexible_mlp_kernel<true>(const float* __restrict__ pts, const float* __restrict__ dirs,
                          const float* __restrict__ params,
                          const __nv_bfloat16* __restrict__ wbf, float* __restrict__ out,
                          long long n_points) {
  extern __shared__ float4 smem[];
  auto* enc = reinterpret_cast<__nv_bfloat16*>(smem);
  tc::forward_tile_with(pts, params, wbf, out, 0, nullptr,
                        static_cast<long long>(blockIdx.x) * kTile, n_points, enc,
                        enc + tc::kEncStride * kTile, DirEncodedTc{dirs});
}

// As flexible_mlp_kernel: the primary template is the f32 instance on the
// FMA design (wbf unused), the bf16 one the specialization below.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
flexible_mlp_rays_kernel(const float* __restrict__ pts, const float* __restrict__ dc,
                         const float* __restrict__ params,
                         const __nv_bfloat16* __restrict__ wbf, float* __restrict__ out,
                         long long n_points, int samples) {
  static_assert(!kBf16, "the bf16 instance is the specialization below");
  extern __shared__ float4 smem[];
  float* buf = reinterpret_cast<float*>(smem);
  int* ray_of = reinterpret_cast<int*>(buf + kForwardSmem / sizeof(float));
  const long long tile0 = static_cast<long long>(blockIdx.x) * kTile;
  const long long ray0 = tile0 / samples;
  const int rem = static_cast<int>(tile0 - ray0 * samples);   // tile0's sample in its ray
  const long long last = (tile0 + kTile < n_points ? tile0 + kTile : n_points) - 1;
  const int rays = static_cast<int>(last / samples - ray0) + 1;  // <= kTile
  if (threadIdx.x < kTile) ray_of[threadIdx.x] = (rem + static_cast<int>(threadIdx.x)) / samples;
  forward_tile_with(pts, params, out, 0, nullptr, tile0, n_points, buf,
                    DirLayerStaged{params, dc, ray0, rays, ray_of});
}

template <>
__global__ void __launch_bounds__(kThreads, 4)
flexible_mlp_rays_kernel<true>(const float* __restrict__ pts, const float* __restrict__ dc,
                               const float* __restrict__ params,
                               const __nv_bfloat16* __restrict__ wbf, float* __restrict__ out,
                               long long n_points, int samples) {
  extern __shared__ float4 smem[];
  auto* enc = reinterpret_cast<__nv_bfloat16*>(smem);
  tc::forward_tile_with(pts, params, wbf, out, 0, nullptr,
                        static_cast<long long>(blockIdx.x) * kTile, n_points, enc,
                        enc + tc::kEncStride * kTile, tc::DirRayRow{dc, samples});
}

bool bad_launch(long long n_points) {
  return n_points <= 0 || (n_points + kTile - 1) / kTile > 0x7fffffffLL;
}

template <bool kBf16>
cudaError_t launch_points(const float* pts, const float* dirs, const float* params,
                          const __nv_bfloat16* wbf, float* out, long long n_points,
                          cudaStream_t stream) {
  const size_t smem = kBf16 ? tc::kFwdSmem : kForwardSmem;
  cudaError_t err = cudaFuncSetAttribute(flexible_mlp_kernel<kBf16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long tiles = (n_points + kTile - 1) / kTile;
  flexible_mlp_kernel<kBf16><<<static_cast<unsigned int>(tiles), kThreads, smem, stream>>>(
      pts, dirs, params, wbf, out, n_points);
  return cudaGetLastError();
}

template <bool kBf16>
cudaError_t launch_rays(const float* pts, const float* dc, const float* params,
                        const __nv_bfloat16* wbf, float* out, long long n_points, int samples,
                        cudaStream_t stream) {
  const size_t smem = kBf16 ? tc::kFwdSmem : kRaysSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(flexible_mlp_rays_kernel<kBf16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long tiles = (n_points + kTile - 1) / kTile;
  flexible_mlp_rays_kernel<kBf16><<<static_cast<unsigned int>(tiles), kThreads, smem, stream>>>(
      pts, dc, params, wbf, out, n_points, samples);
  return cudaGetLastError();
}

}  // namespace

// Number of floats the point-major kernel's packed parameter buffer must
// hold (the ray-major one takes mlp_t.cu's, nerf_mlp_t_num_params()), and of
// bf16 values in its tensor-core weights.
extern "C" int nerf_flexible_mlp_num_params() { return kParamsDir; }
extern "C" int nerf_flexible_mlp_tc_weights() { return tc::kFwdWeightsPoints; }

// pts (n_points, 3), dirs (n_points, 3), params (kParamsDir,), out
// (n_points, 4): contiguous f32 device buffers; with bf16 != 0 also wbf
// (tc::kFwdWeightsPoints,), the bf16 weights in fragment order, 16-byte
// aligned (ignored for f32). Returns a cudaError_t.
extern "C" int nerf_flexible_mlp_forward(const float* pts, const float* dirs,
                                         const float* params, long long n_params,
                                         const void* wbf, long long n_wbf, float* out,
                                         long long n_points, int bf16, void* stream) {
  if (n_params != kParamsDir || bad_launch(n_points) ||
      (bf16 && (wbf == nullptr || n_wbf != tc::kFwdWeightsPoints))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const __nv_bfloat16*>(wbf);
  const cudaError_t err = bf16 ? launch_points<true>(pts, dirs, params, w, out, n_points, s)
                               : launch_points<false>(pts, dirs, params, w, out, n_points, s);
  return static_cast<int>(err);
}

// pts (n_points, 3), dc (n_points / samples, 64), params (kParams,), out
// (n_points, 4): contiguous f32 device buffers, dc 8-byte aligned; with
// bf16 != 0 also wbf (tc::kFwdWeights,), mlp_t.cu's bf16 weights in fragment
// order, 16-byte aligned (ignored for f32). Returns a cudaError_t.
extern "C" int nerf_flexible_mlp_rays_forward(const float* pts, const float* dc,
                                              const float* params, long long n_params,
                                              const void* wbf, long long n_wbf, float* out,
                                              long long n_points, int samples, int bf16,
                                              void* stream) {
  if (n_params != kParams || samples <= 0 || bad_launch(n_points) ||
      n_points % samples != 0 || (bf16 && (wbf == nullptr || n_wbf != tc::kFwdWeights))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const __nv_bfloat16*>(wbf);
  const cudaError_t err =
      bf16 ? launch_rays<true>(pts, dc, params, w, out, n_points, samples, s)
           : launch_rays<false>(pts, dc, params, w, out, n_points, samples, s);
  return static_cast<int>(err);
}
