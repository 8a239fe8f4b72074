// Device code shared by the 8x256 PaperNeRF kernels (paper_t.cu, the
// render-path forward, and paper_train.cu, the training forward + backward;
// their f32 instances run this file's FMA design, their bf16 instances the
// tensor-core one of paper_tc.cuh, which shares its parameter layout):
// the packed parameter layout, the residual rows, the positional encoding of
// a point tile at any depth, the register-blocked dense layer over a tile in
// shared memory with its weights staged by cp.async (which paper_train.cu's
// f32 layer-gradient pass runs too), and the whole forward over a tile, which
// saves the training residuals when it is given a buffer for them.
//
// A tile is kTile = 64 consecutive points of the public (N*S) point order,
// held feature-major in shared memory: act[feature][point]. A block of
// kThreads = 256 threads computes a dense layer with each thread keeping an
// 8 x 8 block of its outputs in registers (8 features x 8 points; 4 x 8 at
// the 128-wide direction branch), the layer's weights staged into shared
// memory by cp.async, a slice of rows at a time, through a two-slot ring.
// Because the whole output tile sits in registers, a layer writes it back
// over its own input after a barrier, and its training residuals straight
// from the registers: one 256 x 64 f32 buffer (64 KB) serves the trunk, and
// the encoding (dim x 64) stays resident beside it for the skip at layer 4,
// ~112 KB a block with the ring at 10 frequencies, two blocks an SM.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace paper {

constexpr int kWidth = 256;
constexpr int kDirWidth = 128;
constexpr int kThreads = 256;
constexpr int kTile = 64;
constexpr int kMaxFreq = 16;    // encoding depths the kernels take: 0..16

__host__ __device__ constexpr int pad4(int x) { return (x + 3) & ~3; }
__host__ __device__ constexpr int enc_dim(int num_freq) { return 3 + 6 * num_freq; }

// Offsets (floats) of the packed forward parameters: each layer's (in, out)
// row-major weight, then its bias, every segment padded to a multiple of 4
// floats so that each weight row starts 16-byte aligned. Only the feat rows
// of layers_dir[0] are here; its viewdir rows are folded into dc by the
// wrapper, and layers_dir[3] is never run.
struct Layout {
  int dim;            // encoding width 3 + 6F
  int w[8], b[8];     // layers_xyz.i; w[4] is (dim + 256, 256), rows [enc; h]
  int wf, bf;         // fc_feat (256, 256)
  int wa, ba;         // fc_alpha (256, 1)
  int wd[3], bd[3];   // layers_dir.0 feat rows (256, 128), layers_dir.1, .2 (128, 128)
  int wr, br;         // fc_rgb (128, 3)
  int total;
};

__host__ __device__ inline int take(int* off, int n) {
  const int at = *off;
  *off += pad4(n);
  return at;
}

__host__ __device__ inline Layout make_layout(int num_freq) {
  Layout l{};
  l.dim = enc_dim(num_freq);
  int off = 0;
  for (int i = 0; i < 8; ++i) {
    const int in = i == 0 ? l.dim : i == 4 ? l.dim + kWidth : kWidth;
    l.w[i] = take(&off, in * kWidth);
    l.b[i] = take(&off, kWidth);
  }
  l.wf = take(&off, kWidth * kWidth);
  l.bf = take(&off, kWidth);
  l.wa = take(&off, kWidth);
  l.ba = take(&off, 1);
  l.wd[0] = take(&off, kWidth * kDirWidth);
  l.bd[0] = take(&off, kDirWidth);
  for (int i = 1; i < 3; ++i) {
    l.wd[i] = take(&off, kDirWidth * kDirWidth);
    l.bd[i] = take(&off, kDirWidth);
  }
  l.wr = take(&off, kDirWidth * 3);
  l.br = take(&off, 3);
  l.total = off;
  return l;
}

// Training residual rows of a point, stored per tile: res[tile][row][point]:
// enc (dim), h0..h7 (post-ReLU trunk, 256 each), feat (256, not ReLU'd),
// d0..d2 (post-ReLU direction branch, 128 each).
__host__ __device__ constexpr int res_h(int dim, int i) { return dim + kWidth * i; }
__host__ __device__ constexpr int res_feat(int dim) { return dim + 8 * kWidth; }
__host__ __device__ constexpr int res_d(int dim, int i) { return dim + 9 * kWidth + kDirWidth * i; }
__host__ __device__ constexpr int res_rows(int dim) { return res_d(dim, 3); }

// Encoding of the tile's points into enc rows 0..dim-1, in the checkpoint's
// interleaved order [x | sin f0 | cos f0 | sin f1 | ...]; points past
// n_points encode x = 0. The sinusoids are sincosf of x * 2^f (exact in
// f32), without fast math.
__device__ __forceinline__ void encode_tile(const float* __restrict__ pts, long long tile0,
                                            long long n_points, int num_freq, float* enc) {
  for (int i = threadIdx.x; i < kTile * 3; i += kThreads) {
    const int p = i / 3;
    const int c = i % 3;
    const float x = tile0 + p < n_points ? pts[tile0 * 3 + i] : 0.f;
    enc[c * kTile + p] = x;
    float scale = 1.f;
    for (int f = 0; f < num_freq; ++f) {
      float s, co;
      sincosf(x * scale, &s, &co);
      enc[(3 + 6 * f + c) * kTile + p] = s;
      enc[(6 + 6 * f + c) * kTile + p] = co;
      scale *= 2.f;
    }
  }
}

// ---------------------------------------------------------------------------
// The dense layer.
//
// out[j][p] = act(sum_k in[k][p] * W[k][j] + b[j] (+ dc[ray(p)][j])) over the
// tile, for OUT = 256 or 128 outputs, by the block's 256 threads. Thread t
// owns the kTF = OUT / 32 features j0 .. j0 + kTF - 1 (j0 = (t / 8) * kTF) of
// the 8 points 4g .. 4g + 3 and 32 + 4g .. 32 + 4g + 3 (g = t % 8), summed in
// registers (Block). Per input row k it reads its points' activations as two
// float4s of in[k] and its features' weights as kTF / 4 float4s of the ring's
// copy of W[k], and issues 8 kTF FMAs for those 2 + kTF / 4 shared loads:
// 16 a load at OUT = 256. The 8 lanes of a quarter warp read 128 contiguous
// bytes of in[k] and one weight address; the four quarters read the same
// activations and weights 4 kTF bytes apart: each load is one wavefront.
//
// Each output's sum is acc = fmaf(W[k][j], in[k][p], acc) for k = 0, 1, ...
// from acc = 0.f (at the skip, the enc rows, then the h rows), then + b[j]
// + dc (0.f where there is none), then ReLU: an order that does not depend on
// which thread owns the output, so no tiling changes a result's bits.
//
// W reaches shared memory through a ring of two slots of kSlotFloats, a
// slice of kSlotFloats / OUT rows (16 at OUT = 256, 32 at 128; a block's last
// slice the rows left), copied by cp.async while the slice before it is
// summed. One barrier a slice publishes the slice that landed and frees the
// other slot, into which the next slice is then staged. A layer's last slice
// stages the first slice of the next layer's weights (`next`), so only a
// tile's first layer waits for its weights, and that wait overlaps the
// encoding. A layer ends with a barrier after its last read of the tile, so
// its epilogue writes the outputs over its input (one 256-row buffer), and
// the training residuals go to device memory straight from the registers.

constexpr int kSlotFloats = 16 * kWidth;
constexpr int kActFloats = kWidth * kTile;

// Dynamic shared memory of a forward block: the encoding (dim rows), one
// 256-row activation buffer, then the ring's two slots; 111.75 KB at F = 10
// (two blocks an SM), 120.75 KB at kMaxFreq (one).
inline size_t fwd_smem_bytes(const Layout& L) {
  return static_cast<size_t>(L.dim * kTile + kActFloats + 2 * kSlotFloats) * sizeof(float);
}

// Prefer the most shared memory an SM gives (228 KB, L1 the rest), so that
// two f32 blocks share an SM.
template <typename Kernel>
inline cudaError_t max_shared_carveout(Kernel* kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              static_cast<int>(cudaSharedmemCarveoutMaxShared));
}

// `rows` feature rows of the tile buffer `in` through as many rows of W
// ((rows, OUT) row-major in device memory): one block of a layer's sum.
struct Rows {
  const float* W;
  int rows;
  const float* in;
};

// `floats` consecutive floats of device memory from W, a slice of weights to
// stage; floats = 0 stages nothing.
struct Slice {
  const float* W;
  int floats;
};

// The first slice of a (rows, OUT) weight matrix.
template <int OUT>
__device__ __forceinline__ Slice first_slice(const float* W, int rows) {
  return {W, min(rows, kSlotFloats / OUT) * OUT};
}

// The ring's two slots and the one that holds (or receives) the next slice.
struct Ring {
  float* slots;
  int cur;
  __device__ __forceinline__ float* slot(int i) const { return slots + i * kSlotFloats; }
};

// Copies the slice into dst asynchronously, as one cp.async group of every
// thread, in 16-byte copies: every weight matrix (the forward layout's and
// the backward's) starts 16-byte aligned and a slice is whole rows of 128 or
// 256 floats.
__device__ __forceinline__ void stage_async(float* dst, Slice s) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  for (int i = 4 * threadIdx.x; i < s.floats; i += 4 * kThreads) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d + 4 * i),
                 "l"(s.W + i) : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// One thread's block of a layer's outputs: features j0 .. j0 + kTF - 1 of
// its 8 points (point(q), q = 0..7).
template <int OUT>
struct Block {
  static constexpr int kTF = OUT / 32;
  float v[kTF][8];
  static __device__ __forceinline__ int j0() { return (threadIdx.x / 8) * kTF; }
  static __device__ __forceinline__ int p0() { return 4 * (threadIdx.x % 8); }
  static __device__ __forceinline__ int point(int q) { return (q < 4 ? 0 : 32) + p0() + q % 4; }

  // Row j0 + f of v to the tile buffer rows `rows` (kTile floats a row,
  // shared or device memory), as two float4s.
  __device__ __forceinline__ void store(float* rows, int f) const {
    float* row = rows + (j0() + f) * kTile + p0();
    *reinterpret_cast<float4*>(row) = make_float4(v[f][0], v[f][1], v[f][2], v[f][3]);
    *reinterpret_cast<float4*>(row + 32) = make_float4(v[f][4], v[f][5], v[f][6], v[f][7]);
  }
};

// acc[f][q] += sum over the slice's rows k of w[k][j0 + f] * in[k][point q],
// for N rows (a full slice: a trip count the compiler sees) or, with N = 0,
// n. Registers hold row k's operands while row k + 1's are loaded (the last
// row loads itself again: no read past the slice).
template <int OUT, int N>
__device__ __forceinline__ void mac(float (&acc)[OUT / 32][8], const float* w,
                                    const float* in, int n, int j0, int p0) {
  constexpr int kTF = OUT / 32;
  const int rows = N > 0 ? N : n;
  float4 x0 = *reinterpret_cast<const float4*>(in + p0);
  float4 x1 = *reinterpret_cast<const float4*>(in + 32 + p0);
  float4 w4[kTF / 4];
#pragma unroll
  for (int h = 0; h < kTF / 4; ++h) w4[h] = *reinterpret_cast<const float4*>(w + j0 + 4 * h);
#pragma unroll 4
  for (int k = 0; k < rows; ++k) {
    const int kn = k + 1 < rows ? k + 1 : k;
    const float4 nx0 = *reinterpret_cast<const float4*>(in + kn * kTile + p0);
    const float4 nx1 = *reinterpret_cast<const float4*>(in + kn * kTile + 32 + p0);
    float4 nw4[kTF / 4];
#pragma unroll
    for (int h = 0; h < kTF / 4; ++h) {
      nw4[h] = *reinterpret_cast<const float4*>(w + kn * OUT + j0 + 4 * h);
    }
    const float x[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
    float wf[kTF];
#pragma unroll
    for (int h = 0; h < kTF / 4; ++h) {
      wf[4 * h + 0] = w4[h].x;
      wf[4 * h + 1] = w4[h].y;
      wf[4 * h + 2] = w4[h].z;
      wf[4 * h + 3] = w4[h].w;
    }
#pragma unroll
    for (int f = 0; f < kTF; ++f) {
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[f][q] = fmaf(wf[f], x[q], acc[f][q]);
    }
    x0 = nx0;
    x1 = nx1;
#pragma unroll
    for (int h = 0; h < kTF / 4; ++h) w4[h] = nw4[h];
  }
}

// The sums of a dense layer over the rows of a, then those of b (b.rows = 0:
// none), into the thread's block. The first slice of a's weights is in the
// ring's slot cur (staged, perhaps still in flight); the layer stages `next`
// the same way for the layer after it. Ends with a barrier after every
// thread's last read of a.in and b.in, so the caller may write over them.
template <int OUT>
__device__ __forceinline__ void dense_sum(Ring& ring, Rows a, Rows b, Block<OUT>& blk,
                                          Slice next) {
  constexpr int kTF = OUT / 32;
  constexpr int kSliceRows = kSlotFloats / OUT;
  const int j0 = Block<OUT>::j0();
  const int p0 = Block<OUT>::p0();
#pragma unroll
  for (int f = 0; f < kTF; ++f) {
#pragma unroll
    for (int q = 0; q < 8; ++q) blk.v[f][q] = 0.f;
  }
#pragma unroll
  for (int part = 0; part < 2; ++part) {
    const Rows r = part == 0 ? a : b;
    for (int k0 = 0; k0 < r.rows; k0 += kSliceRows) {
      Slice after = next;
      if (k0 + kSliceRows < r.rows) {
        after = first_slice<OUT>(r.W + (k0 + kSliceRows) * OUT, r.rows - k0 - kSliceRows);
      } else if (part == 0 && b.rows > 0) {
        after = first_slice<OUT>(b.W, b.rows);
      }
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();
      const float* w = ring.slot(ring.cur);
      ring.cur ^= 1;
      stage_async(ring.slot(ring.cur), after);
      const int n = min(kSliceRows, r.rows - k0);
      if (n == kSliceRows) {
        mac<OUT, kSliceRows>(blk.v, w, r.in + k0 * kTile, n, j0, p0);
      } else {
        mac<OUT, 0>(blk.v, w, r.in + k0 * kTile, n, j0, p0);
      }
    }
  }
  __syncthreads();
}

// The single-block layer.
template <int OUT>
__device__ __forceinline__ void dense_sum(Ring& ring, Rows a, Block<OUT>& blk, Slice next) {
  dense_sum<OUT>(ring, a, Rows{nullptr, 0, nullptr}, blk, next);
}

// The forward epilogue: v = act(v + b[j] + d), d = the ray's dc[ray(p)][j]
// for points below n_points when dc (rays, OUT) is given, else 0; then v over
// the tile buffer `act` and, with res_rows non-null, to the tile's residual
// rows in device memory.
template <int OUT, bool kRelu>
__device__ __forceinline__ void bias_act_store(Block<OUT>& blk, const float* __restrict__ bias,
                                               const float* __restrict__ dc, long long tile0,
                                               int samples, long long n_points, float* act,
                                               float* res_rows) {
  constexpr int kTF = OUT / 32;
  const int j0 = Block<OUT>::j0();
  float b[kTF];
#pragma unroll
  for (int h = 0; h < kTF / 4; ++h) {
    const float4 b4 = __ldg(reinterpret_cast<const float4*>(bias + j0 + 4 * h));
    b[4 * h + 0] = b4.x;
    b[4 * h + 1] = b4.y;
    b[4 * h + 2] = b4.z;
    b[4 * h + 3] = b4.w;
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    float d[kTF];
#pragma unroll
    for (int f = 0; f < kTF; ++f) d[f] = 0.f;
    const long long gp = tile0 + Block<OUT>::point(q);
    if (dc != nullptr && gp < n_points) {
#pragma unroll
      for (int h = 0; h < kTF / 4; ++h) {
        const float4 d4 =
            __ldg(reinterpret_cast<const float4*>(dc + (gp / samples) * OUT + j0 + 4 * h));
        d[4 * h + 0] = d4.x;
        d[4 * h + 1] = d4.y;
        d[4 * h + 2] = d4.z;
        d[4 * h + 3] = d4.w;
      }
    }
#pragma unroll
    for (int f = 0; f < kTF; ++f) {
      const float y = blk.v[f][q] + b[f] + d[f];
      blk.v[f][q] = kRelu ? fmaxf(y, 0.f) : y;
    }
  }
#pragma unroll
  for (int f = 0; f < kTF; ++f) {
    blk.store(act, f);
    if (res_rows != nullptr) blk.store(res_rows, f);
  }
}

// Copy `rows` feature rows of a tile from shared memory to its residual rows
// (a no-op without a residual buffer).
__device__ __forceinline__ void save_rows(const float* act, int rows, float* dst) {
  if (dst == nullptr) return;
  for (int i = threadIdx.x; i < rows * kTile; i += kThreads) dst[i] = act[i];
}

// The forward over the tile blockIdx.x: encoding into `enc` (dim rows), the
// 8-layer ReLU trunk with [enc; h3] into layer 4, fc_feat (no ReLU), sigma
// from feat, the direction branch (layers_dir.0 feat rows + the ray's dc,
// then layers_dir.1 and .2, all ReLU'd), fc_rgb -> out (n_points, 4)
// [r, g, b, sigma]. smem is fwd_smem_bytes(L): enc, the activation buffer
// over which every layer writes its output, the weight ring. With res
// non-null the encoding and each layer's stored output also go to the tile's
// residual rows. This is the f32 design: the bf16 one is paper_tc.cuh's.
__device__ __forceinline__ void forward_tile(const float* __restrict__ pts,
                                             const float* __restrict__ dc,
                                             const float* __restrict__ params, const Layout& L,
                                             float* __restrict__ out, float* res,
                                             long long n_points, int samples, int num_freq,
                                             float* smem) {
  const long long tile0 = static_cast<long long>(blockIdx.x) * kTile;
  const int dim = L.dim;
  float* rt = res == nullptr ? nullptr
                             : res + static_cast<long long>(blockIdx.x) * res_rows(dim) * kTile;
  auto row = [rt](int r) { return rt == nullptr ? nullptr : rt + r * kTile; };
  float* enc = smem;
  float* act = smem + dim * kTile;
  Ring ring{act + kActFloats, 0};

  // Layer 0's first slice lands while the tile is encoded.
  stage_async(ring.slot(0), first_slice<kWidth>(params + L.w[0], dim));
  encode_tile(pts, tile0, n_points, num_freq, enc);
  if (rt != nullptr) {
    __syncthreads();
    save_rows(enc, dim, row(0));
  }

  for (int i = 0; i < 8; ++i) {
    const float* W = params + L.w[i];
    const Slice next = i < 7 ? first_slice<kWidth>(params + L.w[i + 1], i == 3 ? dim : kWidth)
                             : first_slice<kWidth>(params + L.wf, kWidth);
    Block<kWidth> blk;
    if (i == 0) {
      dense_sum<kWidth>(ring, Rows{W, dim, enc}, blk, next);
    } else if (i == 4) {
      // Skip: W4 rows [enc; h], one sum, the enc rows first.
      dense_sum<kWidth>(ring, Rows{W, dim, enc}, Rows{W + dim * kWidth, kWidth, act}, blk, next);
    } else {
      dense_sum<kWidth>(ring, Rows{W, kWidth, act}, blk, next);
    }
    bias_act_store<kWidth, true>(blk, params + L.b[i], nullptr, tile0, samples, n_points, act,
                                 row(res_h(dim, i)));
  }

  {  // feat = fc_feat(h7), not ReLU'd.
    Block<kWidth> blk;
    dense_sum<kWidth>(ring, Rows{params + L.wf, kWidth, act}, blk,
                      first_slice<kDirWidth>(params + L.wd[0], kWidth));
    bias_act_store<kWidth, false>(blk, params + L.bf, nullptr, tile0, samples, n_points, act,
                                  row(res_feat(dim)));
  }
  __syncthreads();
  // sigma from feat, one point per thread; every thread is past it before
  // layers_dir.0 writes over feat (its sum ends with a barrier).
  if (threadIdx.x < kTile) {
    const int p = threadIdx.x;
    float acc = 0.f;
    for (int k = 0; k < kWidth; ++k) {
      acc = fmaf(__ldg(params + L.wa + k), act[k * kTile + p], acc);
    }
    if (tile0 + p < n_points) out[(tile0 + p) * 4 + 3] = acc + __ldg(params + L.ba);
  }
  for (int i = 0; i < 3; ++i) {
    Block<kDirWidth> blk;
    dense_sum<kDirWidth>(ring, Rows{params + L.wd[i], i == 0 ? kWidth : kDirWidth, act}, blk,
                         i < 2 ? first_slice<kDirWidth>(params + L.wd[i + 1], kDirWidth)
                               : Slice{nullptr, 0});
    bias_act_store<kDirWidth, true>(blk, params + L.bd[i], i == 0 ? dc : nullptr, tile0, samples,
                                    n_points, act, row(res_d(dim, i)));
  }
  __syncthreads();

  // fc_rgb: one (channel, point) pair per thread.
  for (int i = threadIdx.x; i < 3 * kTile; i += kThreads) {
    const int c = i / kTile;
    const int p = i % kTile;
    float acc = 0.f;
    for (int k = 0; k < kDirWidth; ++k) {
      acc = fmaf(__ldg(params + L.wr + k * 3 + c), act[k * kTile + p], acc);
    }
    if (tile0 + p < n_points) out[(tile0 + p) * 4 + c] = acc + __ldg(params + L.br + c);
  }
}

}  // namespace paper
