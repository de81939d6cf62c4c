// Mamba2 SSD intra-chunk terms, one (batch, head) per block.
//
// Replaces the TPU kernel ssd_chunk_pallas (_kernel,
// src/repro/kernels/ssd_scan/kernel.py).  For one chunk of L positions,
// with cum the inclusive prefix sum of dt * a over the chunk:
//     y_intra[i] = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j   (L, hd)
//     state      = sum_j exp(cum_L - cum_j) dt_j x_j^T B_j                  (hd, ds)
//     decay      = exp(cum_L)
// all in f32 (bf16 inputs are upcast on load, as the TPU kernel upcasts).
// Its caller is models/mamba2._ssd_chunked, once per chunk and layer of a
// Mamba2 prefill (the contiguous engine's admit groups).
//
// What bounds it on an H100: operations.  At the serving shape (L = 256,
// hd = 64, ds = 128, one group) the function needs, over the causal half,
// C . B^T once per (batch, group) (8.4 MFLOP) and the score-weighted x and
// the state product once per (batch, head) (4.2 + 4.2 MFLOP): above the f32
// CUDA cores' ~20 FLOP/byte.  This version runs on the CUDA cores in f32
// and computes C . B^T again in every head's block.  C . B^T on bf16 inputs
// would run on bf16 MMA with f32 accumulation and lose nothing but the
// summation order, and with one group a block could compute it once for
// every head of a batch; the other two products take the f32 decay
// weights, which bf16 or TF32 operands would round.
//
// Design.
//   * The TPU kernel holds the whole (L, .) working set of a head in VMEM
//     (~0.5 MB); x, B and C alone in f32 exceed the 227 KB of a block at
//     the serving shape.  Here the i axis is tiled in 64-row tiles and
//     the j axis streams in 64-row tiles; tiles above the diagonal are
//     never loaded or multiplied.  Shared memory holds one C tile, one B
//     tile, one x tile and one 64 x 64 score tile in f32 (about 101 KB at
//     hd = 64, ds = 128), plus dt and cum over the chunk.
//   * cum is one thread's in-order f32 scan over the chunk, the order of
//     torch.cumsum on the card, so the inter-chunk term that the caller
//     computes from torch.cumsum sees the kernel's own cum.  The chunk's
//     outputs are large beside their rounding (cum reaches -L * dt * |a|,
//     and exp(cum_i - cum_j) takes the difference of two such sums), so a
//     scan in any other order moves y by far more than the products do.
//   * 256 threads in a 16 x 16 layout; each thread keeps 4 x 4 scores,
//     4 x (hd / 16) outputs of the y tile, and (hd / 16) x (ds / 16)
//     entries of the state in registers.  Padded shared rows keep the
//     strided reads free of bank conflicts.
//   * Masking is by select: a score with j > i, or past L, is 0.
//   * x, B, C and dt are read through their batch / sequence / head
//     strides, so B and C may be views expanded over the heads with a
//     head stride of 0 (one group shared by every head is never copied).
#include "common.cuh"

namespace {

using repro::to_f;

constexpr int kThreads = 256;
constexpr int TT = 64;  // rows per i tile and per j tile
constexpr int TPL = TT + 1;

// element strides of a (B, L, H, feature) tensor (feature contiguous) or
// of the (B, L, H) dt
struct Strides {
  long long b, s, h;
};

template <int HD, int DS>
constexpr size_t tile_floats() {
  return (size_t)TT * (DS + 1) * 2 + (size_t)TT * HD + (size_t)TT * TPL;
}

template <int HD, int DS>
size_t smem_bytes(int l) {
  return sizeof(float) * (tile_floats<HD, DS>() + 2 * (size_t)l);
}

// rows [r0, r0 + TT) of a (., L, ., W) tensor slice into dst[TT][LDD] as
// f32; rows at or past l are 0
template <typename T, int W, int LDD>
__device__ __forceinline__ void stage(float* dst, const T* src, long long s_stride, int r0, int l) {
  for (int e = threadIdx.x; e < TT * W; e += kThreads) {
    const int r = e / W, col = e - r * W, pos = r0 + r;
    dst[r * LDD + col] = pos < l ? to_f(src[(size_t)pos * s_stride + col]) : 0.f;
  }
}

template <typename T, int HD, int DS>
__global__ void __launch_bounds__(kThreads)
ssd_chunk(const T* __restrict__ x, const T* __restrict__ bm, const T* __restrict__ cm,
          const float* __restrict__ dt, const float* __restrict__ a, float* __restrict__ y,
          float* __restrict__ st, float* __restrict__ dec, int l, int h, Strides xs, Strides bs,
          Strides cs, Strides dts) {
  constexpr int LDS = DS + 1;
  constexpr int NY = HD / 16;  // y columns per thread
  constexpr int NS = DS / 16;  // state columns per thread
  extern __shared__ float sm[];
  float* c_s = sm;               // [TT][LDS]
  float* b_s = c_s + TT * LDS;   // [TT][LDS]
  float* x_s = b_s + TT * LDS;   // [TT][HD]
  float* p_s = x_s + TT * HD;    // [TT][TPL] masked, decayed scores
  float* dt_s = p_s + TT * TPL;  // [l]
  float* cum_s = dt_s + l;       // [l]

  const int hh = blockIdx.x, bb = blockIdx.y;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const T* x_bh = x + (size_t)bb * xs.b + (size_t)hh * xs.h;
  const T* b_bh = bm + (size_t)bb * bs.b + (size_t)hh * bs.h;
  const T* c_bh = cm + (size_t)bb * cs.b + (size_t)hh * cs.h;
  const float* dt_bh = dt + (size_t)bb * dts.b + (size_t)hh * dts.h;

  // ---- dt and the inclusive prefix sum of dt * a over the chunk ----
  for (int i = tid; i < l; i += kThreads) dt_s[i] = dt_bh[(size_t)i * dts.s];
  __syncthreads();
  if (tid == 0) {
    // in order, product and sum each rounded (no fma contraction): the
    // same bits as torch.cumsum(dt * a, dim=1) on the card, whose scan
    // over a non-innermost axis runs sequentially in f32
    const float a_h = a[hh];
    float acc = 0.f;
    for (int i = 0; i < l; ++i) {
      acc = __fadd_rn(acc, __fmul_rn(dt_s[i], a_h));
      cum_s[i] = acc;
    }
  }
  __syncthreads();

  // ---- y_intra, one 64-row i tile at a time, j tiles up to the diagonal ----
  const int n_t = (l + TT - 1) / TT;
  for (int it = 0; it < n_t; ++it) {
    const int i0 = it * TT;
    float acc[4][NY];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < NY; ++c) acc[r][c] = 0.f;
    __syncthreads();  // the previous tile's readers are done with c_s
    stage<T, DS, LDS>(c_s, c_bh, cs.s, i0, l);
    for (int jt = 0; jt <= it; ++jt) {
      const int j0 = jt * TT;
      __syncthreads();  // b_s, x_s, p_s are free
      stage<T, DS, LDS>(b_s, b_bh, bs.s, j0, l);
      stage<T, HD, HD>(x_s, x_bh, xs.s, j0, l);
      __syncthreads();
      // scores C_i . B_j for rows ty*4 + r, columns tx + 16 c
      float sc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[r][c] = 0.f;
#pragma unroll 4
      for (int k = 0; k < DS; ++k) {
        float cv[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = c_s[(ty * 4 + r) * LDS + k];
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = b_s[(tx + 16 * c) * LDS + k];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) sc[r][c] = fmaf(cv[r], bv[c], sc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty * 4 + r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = j0 + tx + 16 * c;
          const bool keep = j <= i && i < l;  // j <= i < l also puts j inside the chunk
          p_s[(ty * 4 + r) * TPL + tx + 16 * c] =
              keep ? sc[r][c] * expf(cum_s[i] - cum_s[j]) * dt_s[j] : 0.f;
        }
      }
      __syncthreads();
      // y rows ty*4 + r, columns tx + 16 c
#pragma unroll 4
      for (int jj = 0; jj < TT; ++jj) {
        float pv[4], xv[NY];
#pragma unroll
        for (int r = 0; r < 4; ++r) pv[r] = p_s[(ty * 4 + r) * TPL + jj];
#pragma unroll
        for (int c = 0; c < NY; ++c) xv[c] = x_s[jj * HD + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < NY; ++c) acc[r][c] = fmaf(pv[r], xv[c], acc[r][c]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty * 4 + r;
      if (i < l) {
        float* y_row = y + (((size_t)bb * l + i) * h + hh) * HD;
#pragma unroll
        for (int c = 0; c < NY; ++c) y_row[tx + 16 * c] = acc[r][c];
      }
    }
  }

  // ---- chunk state: sum_j exp(cum_L - cum_j) dt_j x_j^T B_j ----
  const float cum_last = cum_s[l - 1];
  float sacc[NY][NS];
#pragma unroll
  for (int r = 0; r < NY; ++r)
#pragma unroll
    for (int c = 0; c < NS; ++c) sacc[r][c] = 0.f;
  for (int jt = 0; jt < n_t; ++jt) {
    const int j0 = jt * TT;
    __syncthreads();
    stage<T, DS, LDS>(b_s, b_bh, bs.s, j0, l);
    stage<T, HD, HD>(x_s, x_bh, xs.s, j0, l);
    __syncthreads();
    const int jn = min(TT, l - j0);
    for (int jj = 0; jj < jn; ++jj) {
      const float w = expf(cum_last - cum_s[j0 + jj]) * dt_s[j0 + jj];
      float xw[NY], bv[NS];
#pragma unroll
      for (int r = 0; r < NY; ++r) xw[r] = w * x_s[jj * HD + ty + 16 * r];
#pragma unroll
      for (int c = 0; c < NS; ++c) bv[c] = b_s[jj * LDS + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < NY; ++r)
#pragma unroll
        for (int c = 0; c < NS; ++c) sacc[r][c] = fmaf(xw[r], bv[c], sacc[r][c]);
    }
  }
  float* st_bh = st + ((size_t)bb * h + hh) * HD * DS;
#pragma unroll
  for (int r = 0; r < NY; ++r)
#pragma unroll
    for (int c = 0; c < NS; ++c) st_bh[(ty + 16 * r) * DS + tx + 16 * c] = sacc[r][c];
  if (tid == 0) dec[(size_t)bb * h + hh] = expf(cum_last);
}

template <typename T, int HD, int DS>
cudaError_t launch(const void* x, const void* bm, const void* cm, const float* dt, const float* a,
                   float* y, float* st, float* dec, int b, int l, int h, Strides xs, Strides bs,
                   Strides cs, Strides dts, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD, DS>(l);
  static size_t allowed = 0;
  cudaError_t e = repro::allow_smem(ssd_chunk<T, HD, DS>, smem, allowed);
  if (e != cudaSuccess) return e;
  ssd_chunk<T, HD, DS><<<dim3(h, b), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(bm), static_cast<const T*>(cm), dt, a, y, st,
      dec, l, h, xs, bs, cs, dts);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t by_ds(int ds, const void* x, const void* bm, const void* cm, const float* dt,
                  const float* a, float* y, float* st, float* dec, int b, int l, int h, Strides xs,
                  Strides bs, Strides cs, Strides dts, cudaStream_t s) {
  switch (ds) {
    case 16: return launch<T, HD, 16>(x, bm, cm, dt, a, y, st, dec, b, l, h, xs, bs, cs, dts, s);
    case 32: return launch<T, HD, 32>(x, bm, cm, dt, a, y, st, dec, b, l, h, xs, bs, cs, dts, s);
    case 64: return launch<T, HD, 64>(x, bm, cm, dt, a, y, st, dec, b, l, h, xs, bs, cs, dts, s);
    case 128: return launch<T, HD, 128>(x, bm, cm, dt, a, y, st, dec, b, l, h, xs, bs, cs, dts, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t by_hd(int hd, int ds, const void* x, const void* bm, const void* cm, const float* dt,
                  const float* a, float* y, float* st, float* dec, int b, int l, int h, Strides xs,
                  Strides bs, Strides cs, Strides dts, cudaStream_t s) {
  switch (hd) {
    case 16: return by_ds<T, 16>(ds, x, bm, cm, dt, a, y, st, dec, b, l, h, xs, bs, cs, dts, s);
    case 32: return by_ds<T, 32>(ds, x, bm, cm, dt, a, y, st, dec, b, l, h, xs, bs, cs, dts, s);
    case 64: return by_ds<T, 64>(ds, x, bm, cm, dt, a, y, st, dec, b, l, h, xs, bs, cs, dts, s);
    case 128: return by_ds<T, 128>(ds, x, bm, cm, dt, a, y, st, dec, b, l, h, xs, bs, cs, dts, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (b, l, h, hd), bm / cm (b, l, h, ds) in one dtype (f32 or bf16), dt
// (b, l, h) f32, each with element strides (batch, seq, head) and its last
// axis contiguous; a (h,) f32.  Writes y (b, l, h, hd), st (b, h, hd, ds)
// and dec (b, h), contiguous f32.  hd and ds in {16, 32, 64, 128}; l >= 1.
extern "C" int ssd_chunk_launch(const void* x, const void* bm, const void* cm, const void* dt,
                                const void* a, void* y, void* st, void* dec, int b, int l, int h,
                                int hd, int ds, long long xs_b, long long xs_s, long long xs_h,
                                long long bs_b, long long bs_s, long long bs_h, long long cs_b,
                                long long cs_s, long long cs_h, long long dts_b, long long dts_s,
                                long long dts_h, int is_bf16, void* stream) {
  if (l < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides xs{xs_b, xs_s, xs_h}, bs{bs_b, bs_s, bs_h}, cs{cs_b, cs_s, cs_h};
  const Strides dts{dts_b, dts_s, dts_h};
  const float* dtp = static_cast<const float*>(dt);
  const float* ap = static_cast<const float*>(a);
  float* yp = static_cast<float*>(y);
  float* sp = static_cast<float*>(st);
  float* dp = static_cast<float*>(dec);
  const cudaError_t e =
      is_bf16 ? by_hd<__nv_bfloat16>(hd, ds, x, bm, cm, dtp, ap, yp, sp, dp, b, l, h, xs, bs, cs, dts, s)
              : by_hd<float>(hd, ds, x, bm, cm, dtp, ap, yp, sp, dp, b, l, h, xs, bs, cs, dts, s);
  return (int)e;
}
