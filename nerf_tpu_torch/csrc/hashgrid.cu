// Instant-NGP's multiresolution hash encoding, forward and backward, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no hash-grid field. It serves
// models/hashgrid.HashGridNeRFModel (Mueller et al. 2022, arXiv:2201.05989).
// Points (P, 3) f32 -> features (P, 2L) in f32 or bf16; the backward takes
// the features' gradient (P, 2L) in the same dtype and adds each corner's
// share into the table's gradient (entries, 2) f32, zeroed by the caller.
//
// What bounds it on the card: bytes and latency. A point gathers 8 rows of 8
// bytes at each of L = 16 levels, from a table of ~49 MB whose hashed levels
// scatter the rows, and the backward adds into as many rows; the arithmetic
// is ~10 operations a gather. The design:
//   * one thread a point walks every level, so the 32 points of a warp
//     (consecutive samples along a ray, near each other) meet the coarse
//     levels' rows in L1 and L2, and a corner pair along x (the hash's x
//     prime is 1) mostly shares a 32-byte sector;
//   * the 2L features stay in registers and leave in 16-byte stores, a
//     warp's stores one contiguous span;
//   * the backward adds each corner's two terms with one vector reduction
//     (red.global.add.v2.f32, atomicAdd on float2 since CUDA 12.1 on sm_90),
//     every point, level and corner alike, zero terms included. Shortcuts
//     that depend on the data (skipping zero gradients; summing runs of
//     lanes that share a row in the warp first) made it 1.3-2x faster, but
//     its time then followed the training state (which samples carry a
//     gradient, how closely they gather at surfaces) by up to 2x from seed
//     to seed; without them its work is the same for any state.
// Every operation is one IEEE f32 rounding in the plain version's order
// (ops/encoding.hash_corners, hash_encode): the forward is bitwise the
// plain one; the backward's sums differ by the order of the atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#if CUDART_VERSION >= 12010
#define HASHGRID_VECTOR_RED 1
#else
#define HASHGRID_VECTOR_RED 0
#endif

namespace {

constexpr int kMaxLevels = 16;
constexpr int kThreads = 128;

struct Levels {
  int count;
  float box;       // the cube is [-box, box]^3
  float inv_span;  // 1 / (2 box), rounded to f32
  int res[kMaxLevels];
  unsigned int offset[kMaxLevels];
  unsigned int size[kMaxLevels];
  int dense[kMaxLevels];
};

// The point's place in the unit cube, clamped: u = (x + box) * (1 / (2 box)).
__device__ __forceinline__ void unit_position(const float* __restrict__ pts, long long i,
                                              const Levels& g, float u[3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float v = __fmul_rn(__fadd_rn(pts[i * 3 + a], g.box), g.inv_span);
    u[a] = fminf(fmaxf(v, 0.0f), 1.0f);
  }
}

// The lower corner at level l (held to N - 1 on the upper face) and the
// fractions t within the cell.
__device__ __forceinline__ void cell(const float u[3], int res, unsigned int c0[3],
                                     float t[3]) {
  const float n = static_cast<float>(res);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float p = __fmul_rn(u[a], n);
    const float lo = fminf(floorf(p), n - 1.0f);
    t[a] = __fsub_rn(p, lo);
    c0[a] = static_cast<unsigned int>(lo);
  }
}

// Corner c = (c & 1, c >> 1 & 1, c >> 2) of the cell: its row in the table
// and its trilinear weight ((wx * wy) * wz).
__device__ __forceinline__ unsigned int corner(const Levels& g, int l, int c,
                                               const unsigned int c0[3], const float t[3],
                                               float* w) {
  const unsigned int x = c0[0] + (c & 1), y = c0[1] + ((c >> 1) & 1), z = c0[2] + (c >> 2);
  const float wx = (c & 1) ? t[0] : __fsub_rn(1.0f, t[0]);
  const float wy = ((c >> 1) & 1) ? t[1] : __fsub_rn(1.0f, t[1]);
  const float wz = (c >> 2) ? t[2] : __fsub_rn(1.0f, t[2]);
  *w = __fmul_rn(__fmul_rn(wx, wy), wz);
  if (g.dense[l]) {
    const unsigned int s = static_cast<unsigned int>(g.res[l]) + 1u;
    return g.offset[l] + x + s * (y + s * z);
  }
  return g.offset[l] + ((x ^ (y * 2654435761u) ^ (z * 805459861u)) & (g.size[l] - 1u));
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
hash_encode_fwd_kernel(const float* __restrict__ pts, const float2* __restrict__ table,
                       const Levels g, void* __restrict__ out, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  float u[3];
  unit_position(pts, i, g, u);
  float acc[2 * kMaxLevels];
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    acc[2 * l] = acc[2 * l + 1] = 0.0f;
    if (l < g.count) {
      unsigned int c0[3];
      float t[3];
      cell(u, g.res[l], c0, t);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float w;
        const float2 v = __ldg(table + corner(g, l, c, c0, t, &w));
        if (c == 0) {
          acc[2 * l] = __fmul_rn(w, v.x);
          acc[2 * l + 1] = __fmul_rn(w, v.y);
        } else {
          acc[2 * l] = __fadd_rn(acc[2 * l], __fmul_rn(w, v.x));
          acc[2 * l + 1] = __fadd_rn(acc[2 * l + 1], __fmul_rn(w, v.y));
        }
      }
    }
  }
  const int width = 2 * g.count;
  if constexpr (kBf16) {
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out) + i * width;
    if (width % 8 == 0) {
#pragma unroll
      for (int j = 0; j < 2 * kMaxLevels; j += 8) {
        if (j < width) {
          uint4 pack;
          __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&pack);
#pragma unroll
          for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(acc[j + 2 * k], acc[j + 2 * k + 1]);
          *reinterpret_cast<uint4*>(o + j) = pack;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 2 * kMaxLevels; ++j) {
        if (j < width) o[j] = __float2bfloat16_rn(acc[j]);
      }
    }
  } else {
    float* o = static_cast<float*>(out) + i * width;
    if (width % 4 == 0) {
#pragma unroll
      for (int j = 0; j < 2 * kMaxLevels; j += 4) {
        if (j < width) {
          *reinterpret_cast<float4*>(o + j) =
              make_float4(acc[j], acc[j + 1], acc[j + 2], acc[j + 3]);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 2 * kMaxLevels; ++j) {
        if (j < width) o[j] = acc[j];
      }
    }
  }
}

__device__ __forceinline__ void add_pair(float* p, float a, float b) {
#if HASHGRID_VECTOR_RED && defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  atomicAdd(reinterpret_cast<float2*>(p), make_float2(a, b));
#else
  atomicAdd(p, a);
  atomicAdd(p + 1, b);
#endif
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
hash_encode_bwd_kernel(const float* __restrict__ pts, const void* __restrict__ grad,
                       const Levels g, float* __restrict__ dtable, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  float u[3];
  unit_position(pts, i, g, u);
  const int width = 2 * g.count;
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    if (l < g.count) {
      float g0, g1;
      if constexpr (kBf16) {
        const __nv_bfloat162 h = reinterpret_cast<const __nv_bfloat162*>(
            static_cast<const __nv_bfloat16*>(grad) + i * width)[l];
        g0 = __low2float(h);
        g1 = __high2float(h);
      } else {
        const float2 v =
            reinterpret_cast<const float2*>(static_cast<const float*>(grad) + i * width)[l];
        g0 = v.x;
        g1 = v.y;
      }
      unsigned int c0[3];
      float t[3];
      cell(u, g.res[l], c0, t);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float w;
        const unsigned int r = corner(g, l, c, c0, t, &w);
        add_pair(dtable + 2ull * r, __fmul_rn(w, g0), __fmul_rn(w, g1));
      }
    }
  }
}

// levels: 4 ints a level (resolution, first row, rows, dense) on the host.
int make_levels(const int* levels, int count, float box, float inv_span, Levels* g) {
  if (count < 1 || count > kMaxLevels) return static_cast<int>(cudaErrorInvalidValue);
  g->count = count;
  g->box = box;
  g->inv_span = inv_span;
  for (int l = 0; l < kMaxLevels; ++l) {
    const bool on = l < count;
    g->res[l] = on ? levels[4 * l] : 1;
    g->offset[l] = on ? static_cast<unsigned int>(levels[4 * l + 1]) : 0u;
    g->size[l] = on ? static_cast<unsigned int>(levels[4 * l + 2]) : 1u;
    g->dense[l] = on ? levels[4 * l + 3] : 1;
    if (on && (g->res[l] < 1 || (!g->dense[l] && (g->size[l] & (g->size[l] - 1u)) != 0))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return 0;
}

unsigned int blocks_for(long long n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

}  // namespace

// pts (n, 3) f32, table (entries, 2) f32 in; out (n, 2 * count) f32 or, with
// bf16, bf16: contiguous device buffers. Returns a cudaError_t.
extern "C" int nerf_hash_encode_forward(const float* pts, const float* table, const int* levels,
                                        int count, float box, float inv_span, void* out,
                                        long long n, int bf16, void* stream) {
  Levels g;
  const int rc = make_levels(levels, count, box, inv_span, &g);
  if (rc != 0) return rc;
  if (n <= 0 || (n + kThreads - 1) / kThreads > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* t = reinterpret_cast<const float2*>(table);
  if (bf16) {
    hash_encode_fwd_kernel<true><<<blocks_for(n), kThreads, 0, s>>>(pts, t, g, out, n);
  } else {
    hash_encode_fwd_kernel<false><<<blocks_for(n), kThreads, 0, s>>>(pts, t, g, out, n);
  }
  return static_cast<int>(cudaGetLastError());
}

// pts (n, 3) f32 and grad (n, 2 * count) f32 or bf16 in; dtable (entries, 2)
// f32, zeroed, accumulated into. Returns a cudaError_t.
extern "C" int nerf_hash_encode_backward(const float* pts, const void* grad, int bf16,
                                         const int* levels, int count, float box,
                                         float inv_span, float* dtable, long long n,
                                         void* stream) {
  Levels g;
  const int rc = make_levels(levels, count, box, inv_span, &g);
  if (rc != 0) return rc;
  if (n <= 0 || (n + kThreads - 1) / kThreads > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    hash_encode_bwd_kernel<true><<<blocks_for(n), kThreads, 0, s>>>(pts, grad, g, dtable, n);
  } else {
    hash_encode_bwd_kernel<false><<<blocks_for(n), kThreads, 0, s>>>(pts, grad, g, dtable, n);
  }
  return static_cast<int>(cudaGetLastError());
}

// 1 where the backward adds a corner's two features with one vector
// reduction, 0 where it takes two scalar atomics.
extern "C" int nerf_hash_encode_vector_red() { return HASHGRID_VECTOR_RED; }
