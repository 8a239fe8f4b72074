// Inverse-CDF resampling (hierarchical sampling) in one pass, for Hopper (sm_90a).
//
// Replaces nerf_tpu/ops/pallas/resample.py:fused_sample_pdf. Same function
// at the public layout: bin edges (N, M), bin weights (N, M-1) and uniforms
// u (N, S) in [0, 1] -> (N, S) new depths, f32. The chain of the reference's
// sample_pdf: +1e-5 weight floor, pdf = w / sum(w), a zero-prepended
// inclusive CDF, the right-side rank of u in it (searchsorted(right=True)),
// below = max(rank - 1, 0), above = min(rank, M - 1), denom < 1e-5 -> 1, and
// the linear interpolation between the two bin edges. The pdf and the CDF
// never reach device memory.
//
// What bounds it on the card: bytes (each bin, weight, u and output once,
// ~0.75 KB a ray at M = 63, S = 64 with det's shared u row; ~0.03 ms for
// 131072 rays), against a few hundred operations a ray. What a ray costs
// is its latency: a warp does one ray, and all of its steps depend on the
// one before. The design shortens that chain and keeps many rays in flight:
//   * one warp per ray, 8 rays a block of 256 threads; a ray's CDF and bin
//     edges sit in shared memory (2 M floats a warp, so M <= 768);
//   * every read of device memory is issued before any arithmetic, so a ray
//     waits for memory once: the edges by cp.async straight into shared
//     memory, the weights into registers (lane l holds terms 64 g + 2 l and
//     64 g + 2 l + 1 of each 64-term segment g), the lane's first two
//     uniforms too. The kernel is instanced by the number of segments its
//     registers hold (1 for the render path's M <= 65, else 12), so the
//     render path's instance keeps few registers and many warps an SM;
//   * the floored weights (+1e-5 in f32) are summed in f64 (the lane's
//     terms, then shuffles), the sum rounded once to f32, pdf = floored w /
//     sum in f32;
//   * the CDF is an inclusive f64 warp scan of the pdf: the lane's pair sum,
//     5 __shfl_up_sync steps (Kogge-Stone over 32 lanes), the segment's
//     carry from the segments before it; each entry is rounded once to f32
//     and guarded by fmaxf against the entry before it, so the CDF is
//     non-decreasing, which the search relies on. The TPU kernel takes the
//     prefix sum as a triangular matmul on its MXU;
//   * lane l then takes samples l and l + 32 of each 64 together: two
//     binary searches for the right-side rank side by side (the TPU
//     kernel's masked max/min planes over samples x bins), each step a
//     select, as many steps for every lane; two reads of each of CDF and
//     edges, and the guarded interpolation. u need not be sorted; det's
//     linspace row is shared by every ray (row stride 0).
//
// Why the CDF is the one a serial f64 prefix sum gives, bit for bit (the
// earlier design's, and torch.cumsum's on the CPU, which accumulates f32 in
// f64): every pdf term is an f32 value, a multiple of the ulp of the
// smallest one, 1e-5 / sum; every partial sum is below 2. While the floored
// weights sum to at most ~5000 (the smallest term's ulp 2^-52 of 2 or
// coarser; weights of one ray's composited samples sum to at most 1) every
// partial sum is an f64 value exactly, in any order of the adds, and so is
// the sum of the floored weights (multiples of 2^-40 below 2^13). Rounding
// each once to f32 then gives the same CDF whatever the order, and the
// fmaxf guard never acts. Past that, an f64 partial sum may differ by an f64
// ulp, which moves its f32 entry only at an f32 rounding tie. A float32
// scan would differ from this CDF by its own roundings, which move samples
// of bins of small pdf by ~rounding * width / pdf.
//
// Measured (131072 rays, M 63 -> 64, det; NVIDIA H100 80GB HBM3 at 700 W;
// the profiler's device time, tools/torch_kernel_check.py and
// tools/torch_kernel_variants.py): 0.084-0.089 ms, against 0.167-0.172 ms
// for the earlier design in the same calls, which summed the CDF on lane 0
// alone (M - 1 dependent f64 adds through shared memory while 31 lanes
// waited) and read the weights twice; the byte bound is 0.0296 ms. What
// bounds it now is the instructions a ray costs at one warp a ray: ~330
// warp instructions (cuobjdump -sass), ~47 us of issue for 131072 rays at
// one instruction a clock per scheduler, run at about half that rate. The
// probes that drop a part (wrong results): the searches 0.023 ms, the
// scan's shuffles 0.011 ms, the sum's butterfly 0.006-0.008 ms; unrolling the
// edge copies by the segment count changes nothing. Occupancy is full: the
// render path's instance holds 32 registers, 8 blocks an SM. Fewer
// instructions a ray (two rays a warp on half-warp scans) is what would
// move it.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRaysPerBlock = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxBins = 768;  // 8 warps x 2 x 768 floats = 48 KB of shared memory
constexpr int kSeg = 64;       // pdf terms a warp scans at once, 2 a lane
constexpr int kMaxSegs = (kMaxBins - 1 + kSeg - 1) / kSeg;   // 12

// The sample at rank r (the first CDF index above uj): the clamps, the
// denominator guard and the interpolation between the two bin edges.
__device__ __forceinline__ float sample_at(const float* cdf, const float* edge, int m, int r,
                                           float uj) {
  const int below = max(r - 1, 0);
  const int above = min(r, m - 1);
  const float cdf_below = cdf[below];
  float denom = cdf[above] - cdf_below;
  if (denom < 1e-5f) denom = 1.f;
  const float t = (uj - cdf_below) / denom;
  const float e0 = edge[below];
  return e0 + t * (edge[above] - e0);
}

// kSegs: the 64-term segments the lanes hold registers for, at least
// ceil((m - 1) / 64); the loops over them unroll.
template <int kSegs>
__global__ void __launch_bounds__(kThreads)
resample_kernel(const float* __restrict__ bins, const float* __restrict__ weights,
                const float* __restrict__ u, long long u_ray_stride,
                float* __restrict__ out, long long n_rays, int m, int samples) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const long long ray = static_cast<long long>(blockIdx.x) * kRaysPerBlock + warp;
  if (ray >= n_rays) return;  // the whole warp leaves together; no block barrier below
  float* cdf = smem + warp * 2 * m;
  float* edge = cdf + m;
  const float* w = weights + ray * (m - 1);
  const int terms = m - 1;

  // Every read of device memory is issued first, so that the ray waits for
  // memory once: the edges straight into shared memory (cp.async), the
  // weights and the first two uniforms of the lane into registers.
  for (int i = lane; i < m; i += 32) {
    const auto dst = static_cast<unsigned>(__cvta_generic_to_shared(edge + i));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(bins + ray * m + i));
  }
  const float* ur = u + ray * u_ray_stride;
  float next0 = lane < samples ? ur[lane] : 0.f;
  float next1 = lane + 32 < samples ? ur[lane + 32] : 0.f;
  float wa[kSegs], wb[kSegs];   // the floored weights of the lane's pairs, 0 past the row
#pragma unroll
  for (int g = 0; g < kSegs; ++g) {
    const int i = g * kSeg + 2 * lane;
    wa[g] = i < terms ? w[i] + 1e-5f : 0.f;
    wb[g] = i + 1 < terms ? w[i + 1] + 1e-5f : 0.f;
  }

  double sum = 0.0;
#pragma unroll
  for (int g = 0; g < kSegs; ++g) sum += static_cast<double>(wa[g]) + static_cast<double>(wb[g]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kFullMask, sum, o);
  const float total = __double2float_rn(sum);
  if (lane == 0) cdf[0] = 0.f;

  // cdf[i + 1] = pdf[0] + ... + pdf[i], segment by segment.
  double carry = 0.0;   // the sum of the segments before g
  float last = 0.f;     // the CDF entry before segment g's first
#pragma unroll
  for (int g = 0; g < kSegs; ++g) {
    if (g * kSeg < terms) {   // the same for the whole warp
      const float pa = wa[g] / total;
      const double a = static_cast<double>(pa);
      double s = a + static_cast<double>(wb[g] / total);   // the lane's pair
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double t = __shfl_up_sync(kFullMask, s, o);
        if (lane >= o) s += t;
      }
      double before = __shfl_up_sync(kFullMask, s, 1);   // the pairs of the lanes below
      if (lane == 0) before = 0.0;
      float c0 = __double2float_rn(carry + before + a);
      float c1 = __double2float_rn(carry + s);
      float prev = __shfl_up_sync(kFullMask, c1, 1);
      if (lane == 0) prev = last;
      c0 = fmaxf(c0, prev);
      c1 = fmaxf(c1, c0);
      const int i = g * kSeg + 2 * lane;
      if (i < terms) cdf[i + 1] = c0;
      if (i + 1 < terms) cdf[i + 2] = c1;
      carry += __shfl_sync(kFullMask, s, 31);
      last = __shfl_sync(kFullMask, c1, 31);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();

  // Lane l takes samples l and l + 32 of each 64, their two searches side by
  // side: the rank of uj, the first index whose cdf > uj (searchsorted
  // right), is the count of entries <= uj in the non-decreasing CDF. Each
  // step halves the range [r, r + len] that holds it, the same number of
  // steps for every lane.
  for (int j = lane; j < samples; j += 64) {
    const float u0 = next0;
    const float u1 = next1;
    if (j + 64 < samples) next0 = ur[j + 64];
    if (j + 96 < samples) next1 = ur[j + 96];
    int r0 = 0;
    int r1 = 0;
    for (int len = m; len > 1;) {
      const int half = len >> 1;
      r0 = cdf[r0 + half - 1] <= u0 ? r0 + half : r0;
      r1 = cdf[r1 + half - 1] <= u1 ? r1 + half : r1;
      len -= half;
    }
    r0 += cdf[r0] <= u0 ? 1 : 0;
    r1 += cdf[r1] <= u1 ? 1 : 0;
    out[ray * samples + j] = sample_at(cdf, edge, m, r0, u0);
    if (j + 32 < samples) out[ray * samples + j + 32] = sample_at(cdf, edge, m, r1, u1);
  }
}

template <int kSegs>
cudaError_t launch(const float* bins, const float* weights, const float* u,
                   long long u_ray_stride, float* out, long long n_rays, int m, int samples,
                   cudaStream_t stream) {
  const long long blocks = (n_rays + kRaysPerBlock - 1) / kRaysPerBlock;
  const size_t smem = static_cast<size_t>(kRaysPerBlock) * 2 * m * sizeof(float);
  resample_kernel<kSegs><<<static_cast<unsigned int>(blocks), kThreads, smem, stream>>>(
      bins, weights, u, u_ray_stride, out, n_rays, m, samples);
  return cudaGetLastError();
}

}  // namespace

// The largest number of bin edges M the kernel takes.
extern "C" int nerf_resample_max_bins() { return kMaxBins; }

// bins (n_rays, m), weights (n_rays, m - 1), u (n_rays rows of samples
// floats, u_ray_stride apart: samples, or 0 for one row shared by every ray)
// in; out (n_rays, samples): contiguous f32 device buffers. Returns a
// cudaError_t.
extern "C" int nerf_resample(const float* bins, const float* weights, const float* u,
                             long long u_ray_stride, float* out, long long n_rays, int m,
                             int samples, void* stream) {
  if (n_rays <= 0 || samples <= 0 || m < 2 || m > kMaxBins || u_ray_stride < 0 ||
      (n_rays + kRaysPerBlock - 1) / kRaysPerBlock > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // The registers a lane holds weights in: one segment for the render
  // path's M <= 65 (63: the coarse pass's inner bins), all of them else.
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      m - 1 <= kSeg ? launch<1>(bins, weights, u, u_ray_stride, out, n_rays, m, samples, s)
                    : launch<kMaxSegs>(bins, weights, u, u_ray_stride, out, n_rays, m, samples, s);
  return static_cast<int>(err);
}
