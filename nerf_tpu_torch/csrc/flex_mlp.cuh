// Device code shared by the f32 instances of the 4x128 FlexibleNeRF kernels
// (mlp_t.cu, the render-path forward; flex_train.cu, the training forward;
// stage.cu, the forward fused with compositing; mlp.cu, the point-major and
// ray-major forwards): the packed parameter layout, the positional encoding
// of a point tile, the register-blocked dense layer over a tile in shared
// memory with its weights staged by cp.async (whose sum, dense_sum, is also
// flex_train.cu's f32 layer-gradient pass), and the whole forward over a
// tile, which saves the f32 training residuals when it is given a buffer for
// them. The bf16 instances of every kernel run flex_tc.cuh's tensor-core tile,
// which shares the parameter layout and the constants here.
//
// A tile is kTile = 64 consecutive points of the public (N*S) point order,
// held feature-major in shared memory: act[feature][point]. A forward's
// shared memory (kForwardSmem, 96 KB, so two blocks an SM) holds buf_a and
// buf_b, between which the tile's activations ping-pong (128 x 64 f32 each),
// then the weight ring: two slots of kSlotFloats f32.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace flex {

constexpr int kHidden = 128;
constexpr int kDirHidden = 64;
constexpr int kFreqXyz = 10;
constexpr int kFreqDir = 4;
constexpr int kEnc = 3 + 6 * kFreqXyz;     // 63
constexpr int kEncDir = 3 + 6 * kFreqDir;  // 27
constexpr int kThreads = 128;
constexpr int kTile = 64;

// Packed parameter buffer: each layer's (in, out) row-major f32 weight
// followed by its bias. Only the feat rows of layers_dir[0] are here; its
// viewdir rows are folded into dc by the wrapper.
constexpr int kOffW1 = 0;                                  // layer1 (63, 128)
constexpr int kOffB1 = kOffW1 + kEnc * kHidden;
constexpr int kOffWx = kOffB1 + kHidden;                   // layers_xyz.{0,1,2}
constexpr int kLayerX = kHidden * kHidden + kHidden;       // (128, 128) + bias
constexpr int kOffWf = kOffWx + 3 * kLayerX;               // fc_feat (128, 128)
constexpr int kOffBf = kOffWf + kHidden * kHidden;
constexpr int kOffWa = kOffBf + kHidden;                   // fc_alpha (128, 1)
constexpr int kOffBa = kOffWa + kHidden;
constexpr int kOffWd = kOffBa + 1;                         // layers_dir.0 feat rows (128, 64)
constexpr int kOffBd = kOffWd + kHidden * kDirHidden;
constexpr int kOffWr = kOffBd + kDirHidden;                // fc_rgb (64, 3)
constexpr int kOffBr = kOffWr + kDirHidden * 3;
constexpr int kParams = kOffBr + 3;                        // 82820
// The point-major forward (mlp.cu) encodes each point's direction itself: its
// buffer appends layers_dir.0's direction rows (27, 64) to the one above.
constexpr int kOffWdDir = kParams;
constexpr int kParamsDir = kOffWdDir + kEncDir * kDirHidden;   // 84548

// Training residual rows of a point, stored per tile: res[tile][row][point].
constexpr int kResEnc = 0;                       // enc (63)
constexpr int kResA0 = kResEnc + kEnc;           // a0 (128), layer1's output, not ReLU'd
constexpr int kResH1 = kResA0 + kHidden;         // h1, h2, h3 (128 each)
constexpr int kResH2 = kResH1 + kHidden;
constexpr int kResH3 = kResH2 + kHidden;
constexpr int kResFeat = kResH3 + kHidden;       // feat (128)
constexpr int kResHd = kResFeat + kHidden;       // hd (64)
constexpr int kResRows = kResHd + kDirHidden;    // 767

// Shared memory of a forward: buf_a, buf_b, then the two slots of the ring.
constexpr int kBufFloats = kHidden * kTile;
constexpr int kSlotFloats = 32 * kHidden;   // a slice: 32 rows of a 128-wide W, 64 of a 64-wide
constexpr size_t kForwardSmem = (2 * kBufFloats + 2 * kSlotFloats) * sizeof(float);

// Encoding of the tile's 3-vectors (points, or with kFreq = kFreqDir view
// directions) into act rows 0..3 + 6 kFreq - 1, in the checkpoint's
// interleaved order [x | sin f0 | cos f0 | sin f1 | ...]; points past
// n_points encode x = 0. The sinusoids are sincosf of x * 2^f (exact in f32),
// without fast math.
template <int kFreq = kFreqXyz>
__device__ __forceinline__ void encode_tile(const float* __restrict__ pts,
                                            long long tile0, long long n_points,
                                            float* act) {
  for (int i = threadIdx.x; i < kTile * 3; i += kThreads) {
    const int p = i / 3;
    const int c = i % 3;
    const float x = tile0 + p < n_points ? pts[tile0 * 3 + i] : 0.f;
    act[c * kTile + p] = x;
    float scale = 1.f;
#pragma unroll
    for (int f = 0; f < kFreq; ++f) {
      float s, co;
      sincosf(x * scale, &s, &co);
      act[(3 + 6 * f + c) * kTile + p] = s;
      act[(6 + 6 * f + c) * kTile + p] = co;
      scale *= 2.f;
    }
  }
}

// ---------------------------------------------------------------------------
// The dense layer.
//
// out[j][p] = act(add(p, j, sum_k in[k][p] * W[k][j] + b[j])) over the tile,
// for OUT = 128 or 64 outputs, by the block's 128 threads. Thread t owns the
// kTF = OUT / 16 features j0 .. j0 + kTF - 1 (j0 = (t / 8) * kTF) of the 8
// points 4g .. 4g + 3 and 32 + 4g .. 32 + 4g + 3 (g = t % 8), summed in
// registers. Per input row k it reads its points' activations as two float4s
// of in[k] and its features' weights as kTF / 4 float4s of the ring's copy of
// W[k], and issues 8 kTF FMAs: 16 an LDS.128 at OUT = 128, against the 4 of a
// design that gives each thread one feature of a run of points. The 8 lanes
// of a quarter warp read 128 contiguous bytes of in[k] and one weight
// address; the four quarters of a warp read the same activations and weights
// 8 kTF bytes apart, on distinct banks: each load is one wavefront, and each
// store of an output row (4 quarters x 128 contiguous bytes) the four that
// its 512 bytes take.
//
// Each output's sum is acc = fmaf(W[k][j], in[k][p], acc) for k = 0, 1, ...
// from acc = 0.f (a second block of rows after the first), then + b[j], then
// add, then ReLU: only the thread that computes an output differs from the
// one-feature-a-thread design, so the results are bitwise that design's.
//
// W reaches shared memory through the ring, kSlotFloats / OUT rows a slice
// (32 at OUT = 128, 64 at 64; a block's last slice the rows left), copied by
// cp.async while the slice before it is summed. One barrier a slice publishes
// the slice that landed and frees the other slot, into which the next slice
// is then staged. A layer's last slice stages the first slice of the next
// layer's weights (`next`), so only a tile's first layer waits for its
// weights, and that wait overlaps the encoding. The sum is its own entry,
// dense_sum, which the f32 layer-gradient pass runs over the backward
// weights with an epilogue of its own.

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
// thread: 16-byte copies from a 16-byte aligned slice, else 4-byte ones
// (layers_dir.0's feat rows start at an odd float of the packed buffer).
__device__ __forceinline__ void stage_async(float* dst, Slice s) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if ((reinterpret_cast<uintptr_t>(s.W) & 15) == 0) {
    for (int i = 4 * threadIdx.x; i < s.floats; i += 4 * kThreads) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d + 4 * i),
                   "l"(s.W + i) : "memory");
    }
  } else {
    for (int i = threadIdx.x; i < s.floats; i += kThreads) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d + 4 * i),
                   "l"(s.W + i) : "memory");
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// acc[f][q] += sum over the slice's rows k of w[k][j0 + f] * in[k][point q],
// for N rows (a full slice: a trip count the compiler sees) or, with N = 0,
// n. Registers hold row k's operands while row k + 1's are loaded (the last
// row loads itself again: no read past the slice).
template <int OUT, int N>
__device__ __forceinline__ void mac(float (&acc)[OUT / 16][8], const float* w,
                                    const float* in, int n, int j0, int p0) {
  constexpr int kTF = OUT / 16;
  const int rows = N > 0 ? N : n;
  float4 x0 = *reinterpret_cast<const float4*>(in + p0);
  float4 x1 = *reinterpret_cast<const float4*>(in + 32 + p0);
  float4 w4[kTF / 4];
#pragma unroll
  for (int h = 0; h < kTF / 4; ++h) w4[h] = *reinterpret_cast<const float4*>(w + j0 + 4 * h);
#pragma unroll 2
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
// none), into the thread's block acc[f][q] (feature j0 + f, the q-th of its
// 8 points; j0 and the points as above). The first slice of a's weights is
// in the ring's slot cur (staged, perhaps still in flight); the layer stages
// `next` the same way for the layer after it. No barrier follows the last
// slice: a caller that writes over a.in or b.in syncs first.
template <int OUT>
__device__ __forceinline__ void dense_sum(Ring& ring, Rows a, Rows b, float (&acc)[OUT / 16][8],
                                          Slice next) {
  constexpr int kTF = OUT / 16;
  constexpr int kSliceRows = kSlotFloats / OUT;
  const int j0 = (threadIdx.x / 8) * kTF;
  const int p0 = 4 * (threadIdx.x % 8);
#pragma unroll
  for (int f = 0; f < kTF; ++f) {
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[f][q] = 0.f;
  }
#pragma unroll
  for (int blk = 0; blk < 2; ++blk) {
    const Rows r = blk == 0 ? a : b;
    for (int k0 = 0; k0 < r.rows; k0 += kSliceRows) {
      Slice after = next;
      if (k0 + kSliceRows < r.rows) {
        after = first_slice<OUT>(r.W + (k0 + kSliceRows) * OUT, r.rows - k0 - kSliceRows);
      } else if (blk == 0 && b.rows > 0) {
        after = first_slice<OUT>(b.W, b.rows);
      }
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();
      const float* w = ring.slot(ring.cur);
      ring.cur ^= 1;
      stage_async(ring.slot(ring.cur), after);
      const int n = min(kSliceRows, r.rows - k0);
      if (n == kSliceRows) {
        mac<OUT, kSliceRows>(acc, w, r.in + k0 * kTile, n, j0, p0);
      } else {
        mac<OUT, 0>(acc, w, r.in + k0 * kTile, n, j0, p0);
      }
    }
  }
}

// The single-block sum.
template <int OUT>
__device__ __forceinline__ void dense_sum(Ring& ring, Rows a, float (&acc)[OUT / 16][8],
                                          Slice next) {
  dense_sum<OUT>(ring, a, Rows{nullptr, 0, nullptr}, acc, next);
}

// The dense layer: dense_sum, then act(add(p, j, sum + b[j])) into out; add
// returns y plus whatever the caller adds for point p of the tile. The
// callbacks are structs with force-inlined operators, not lambdas: a
// lambda's call is not certain to be inlined.
template <int OUT, bool kRelu, typename Add>
__device__ __forceinline__ void dense(Ring& ring, Rows a, Rows b,
                                      const float* __restrict__ bias, float* out, Add add,
                                      Slice next) {
  constexpr int kTF = OUT / 16;
  const int j0 = (threadIdx.x / 8) * kTF;
  const int p0 = 4 * (threadIdx.x % 8);
  float acc[kTF][8];
  dense_sum<OUT>(ring, a, b, acc, next);
  float bj[kTF];
#pragma unroll
  for (int f = 0; f < kTF; ++f) bj[f] = __ldg(bias + j0 + f);
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int p = (q < 4 ? p0 : 32 + p0) + q % 4;
#pragma unroll
    for (int f = 0; f < kTF; ++f) {
      const float y = add(p, j0 + f, acc[f][q] + bj[f]);
      acc[f][q] = kRelu ? fmaxf(y, 0.f) : y;
    }
  }
#pragma unroll
  for (int f = 0; f < kTF; ++f) {
    float* row = out + (j0 + f) * kTile + p0;
    *reinterpret_cast<float4*>(row) = make_float4(acc[f][0], acc[f][1], acc[f][2], acc[f][3]);
    *reinterpret_cast<float4*>(row + 32) =
        make_float4(acc[f][4], acc[f][5], acc[f][6], acc[f][7]);
  }
}

// The single-block layer.
template <int OUT, bool kRelu, typename Add>
__device__ __forceinline__ void dense(Ring& ring, Rows a, const float* __restrict__ bias,
                                      float* out, Add add, Slice next) {
  dense<OUT, kRelu>(ring, a, Rows{nullptr, 0, nullptr}, bias, out, add, next);
}

struct AddNothing {
  __device__ __forceinline__ float operator()(int, int, float y) const { return y; }
};

// Adds the ray's row of dc (n_points / samples, 64), read from device memory,
// for the tile's points below n_points.
struct AddRayRow {
  const float* dc;
  long long tile0;
  long long n_points;
  int samples;
  __device__ __forceinline__ float operator()(int p, int j, float y) const {
    const long long gp = tile0 + p;
    return gp < n_points ? y + __ldg(dc + (gp / samples) * kDirHidden + j) : y;
  }
};

// Copy `rows` feature rows of a tile from shared memory to its residual rows
// (a no-op without a residual buffer).
__device__ __forceinline__ void save_rows(const float* act, int rows, float* dst) {
  if (dst == nullptr) return;
  for (int i = threadIdx.x; i < rows * kTile; i += kThreads) dst[i] = act[i];
}

// The forward over the tile of points tile0 .. tile0 + kTile - 1: encoding,
// layer1 (no activation), the ReLU trunk, fc_feat (ReLU) and fc_alpha (from
// h3), the direction layer, fc_rgb -> row (point - out0) of out (.., 4)
// [r, g, b, sigma], for the points below n_points. smem is kForwardSmem
// bytes: the tile's activations ping-pong between buf_a and buf_b, the
// weights stream through the ring. With res non-null, each layer's stored
// input is also written to the tile's residual rows (f32, the f32 training
// forward's). It ends without a barrier: a caller that runs a second tile in
// the same block syncs first.
//
// dir_layer(feat, hd, ring), a struct as dense's callbacks are, writes hd =
// relu(feat @ W_dir[:128] + the direction's term + b) into rows 0..63 of hd
// (buf_a) from feat (buf_b) with dense, whose first slice (of layers_dir.0's
// feat rows) fc_feat has staged. Every thread calls it, after a barrier that
// ends the trunk's reads of buf_a, so it may use buf_a's rows 64..127 as
// scratch, with a barrier of its own before its dense layer reads them.
template <typename DirLayer>
__device__ __forceinline__ void forward_tile_with(const float* __restrict__ pts,
                                                  const float* __restrict__ params,
                                                  float* __restrict__ out, long long out0,
                                                  float* res, long long tile0,
                                                  long long n_points, float* smem,
                                                  DirLayer dir_layer) {
  float* rt = res == nullptr ? nullptr : res + (tile0 / kTile) * kResRows * kTile;
  auto row = [rt](int r) { return rt == nullptr ? nullptr : rt + r * kTile; };
  float* buf_a = smem;
  float* buf_b = smem + kBufFloats;
  Ring ring{smem + 2 * kBufFloats, 0};
  const float* wx = params + kOffWx;

  // Layer 1's first slice lands while the tile is encoded into buf_a rows
  // 0..62, checkpoint order. Each layer's first slice begins with a barrier
  // after which its input rows are visible and its output buffer is free;
  // the barriers between layers are for save_rows, which reads a layer's
  // output before the next layer's barrier.
  stage_async(ring.slot(0), first_slice<kHidden>(params + kOffW1, kEnc));
  encode_tile(pts, tile0, n_points, buf_a);
  if (rt != nullptr) __syncthreads();
  save_rows(buf_a, kEnc, row(kResEnc));
  dense<kHidden, false>(ring, Rows{params + kOffW1, kEnc, buf_a}, params + kOffB1, buf_b,
                        AddNothing{}, first_slice<kHidden>(wx, kHidden));
  if (rt != nullptr) __syncthreads();
  save_rows(buf_b, kHidden, row(kResA0));
  dense<kHidden, true>(ring, Rows{wx, kHidden, buf_b}, wx + kHidden * kHidden, buf_a,
                       AddNothing{}, first_slice<kHidden>(wx + kLayerX, kHidden));
  if (rt != nullptr) __syncthreads();
  save_rows(buf_a, kHidden, row(kResH1));
  dense<kHidden, true>(ring, Rows{wx + kLayerX, kHidden, buf_a},
                       wx + kLayerX + kHidden * kHidden, buf_b, AddNothing{},
                       first_slice<kHidden>(wx + 2 * kLayerX, kHidden));
  if (rt != nullptr) __syncthreads();
  save_rows(buf_b, kHidden, row(kResH2));
  dense<kHidden, true>(ring, Rows{wx + 2 * kLayerX, kHidden, buf_b},
                       wx + 2 * kLayerX + kHidden * kHidden, buf_a, AddNothing{},
                       first_slice<kHidden>(params + kOffWf, kHidden));
  if (rt != nullptr) __syncthreads();

  // h3 in buf_a: feat = relu(fc_feat) into buf_b; sigma (raw) per point.
  save_rows(buf_a, kHidden, row(kResH3));
  dense<kHidden, true>(ring, Rows{params + kOffWf, kHidden, buf_a}, params + kOffBf, buf_b,
                       AddNothing{}, first_slice<kDirHidden>(params + kOffWd, kHidden));
  if (threadIdx.x < kTile) {
    const int p = threadIdx.x;
    float acc = 0.f;
    for (int k = 0; k < kHidden; ++k) {
      acc = fmaf(__ldg(params + kOffWa + k), buf_a[k * kTile + p], acc);
    }
    if (tile0 + p < n_points) out[(tile0 + p - out0) * 4 + 3] = acc + __ldg(params + kOffBa);
  }
  __syncthreads();

  // Direction layer into buf_a rows 0..63.
  save_rows(buf_b, kHidden, row(kResFeat));
  dir_layer(buf_b, buf_a, ring);
  __syncthreads();
  save_rows(buf_a, kDirHidden, row(kResHd));

  // fc_rgb: one (channel, point) pair per thread step.
  for (int i = threadIdx.x; i < 3 * kTile; i += kThreads) {
    const int c = i / kTile;
    const int p = i % kTile;
    float acc = 0.f;
    for (int k = 0; k < kDirHidden; ++k) {
      acc = fmaf(__ldg(params + kOffWr + k * 3 + c), buf_a[k * kTile + p], acc);
    }
    if (tile0 + p < n_points) out[(tile0 + p - out0) * 4 + c] = acc + __ldg(params + kOffBr + c);
  }
}

// The direction layer whose term is the ray's row of dc (n_points / samples,
// 64), read from device memory.
struct DirLayerRayRow {
  const float* params;
  const float* dc;
  long long tile0;
  long long n_points;
  int samples;
  __device__ __forceinline__ void operator()(const float* feat, float* hd, Ring& ring) const {
    dense<kDirHidden, true>(ring, Rows{params + kOffWd, kHidden, feat}, params + kOffBd, hd,
                            AddRayRow{dc, tile0, n_points, samples}, Slice{nullptr, 0});
  }
};

// forward_tile_with with DirLayerRayRow (mlp_t.cu, flex_train.cu, stage.cu).
__device__ __forceinline__ void forward_tile_at(const float* __restrict__ pts,
                                                const float* __restrict__ dc,
                                                const float* __restrict__ params,
                                                float* __restrict__ out, long long out0,
                                                float* res, long long tile0,
                                                long long n_points, int samples, float* smem) {
  forward_tile_with(pts, params, out, out0, res, tile0, n_points, smem,
                    DirLayerRayRow{params, dc, tile0, n_points, samples});
}

// The forward over the tile blockIdx.x, into out (n_points, 4).
__device__ __forceinline__ void forward_tile(const float* __restrict__ pts,
                                             const float* __restrict__ dc,
                                             const float* __restrict__ params,
                                             float* __restrict__ out, float* res,
                                             long long n_points, int samples, float* smem) {
  forward_tile_at(pts, dc, params, out, 0, res, static_cast<long long>(blockIdx.x) * kTile,
                  n_points, samples, smem);
}

}  // namespace flex
