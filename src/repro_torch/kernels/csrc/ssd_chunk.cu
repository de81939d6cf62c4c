// Mamba2 SSD intra-chunk terms: C . B^T once per (batch, group), then
// blocks per (batch, head) for y and for the chunk state.
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
// What bounds it on an H100: operations.  At the serving shape (B = 8,
// L = 256, H = 64, hd = 64, ds = 128, one group) the function needs, over
// the causal half, C . B^T once per (batch, group) (67 MFLOP for the
// call) and the score-weighted x and the state product once per (batch,
// head) (4.2 + 4.2 MFLOP each, 4.3 GFLOP in all), on the f32 CUDA cores:
// the last two take the f32 decay weights, which bf16 or TF32 operands
// would round.  The kernel before this design computed C . B^T again in
// every head's block (64 times over with one group: 5.4 GFLOP of the
// block's 10), staged B_j and x_j twice with one load in flight a thread,
// and fed its register tiles with scalar shared loads.
//
// Design.
//   * ssd_scores, grid (causal tile pairs, groups, batch): each block
//     computes one 64 x 64 tile C_i . B_j^T (j tile <= i tile) of one
//     group, every entry one fmaf chain over ds in order from 0.f, and
//     writes it transposed ([j][i]) to an f32 scratch (2 MB at the serving
//     shape, which stays in L2).  A group is what B and C hold apart:
//     views with head stride 0 are one group, anything else one group per
//     head.  Either way the same code computes each tile, so an expanded
//     view and its materialised copy give the same bits.
//   * ssd_chunk, grid (heads, batch, 1 + ceil(n_t / 2)) for n_t i tiles of
//     64 rows: block z == 0 computes the chunk state, block z > 0 the y
//     rows of i tiles n_t - z and z - 1, so every block walks about n_t + 1
//     tiles and the longest work is dispatched first.  A step's inputs (x_j
//     and the (i, j) score tile, or x_j and B_j) go to one of two shared
//     buffers by 16-byte cp.async while the block computes on the other; x
//     and B stay in their input type there (bf16 halves the shared loads)
//     and are upcast as they are read (every row of x and B 16-byte
//     aligned: the wrapper copies any that is not).  A y step turns
//     the score tile into the masked, decayed P = sc * exp(cum_i - cum_j) *
//     dt_j in place and accumulates y_i += P x_j; the state block
//     accumulates w_j x_j^T B_j with w_j = exp(cum_L - cum_j) dt_j (for f32
//     at ds = 128 in two passes over j, one per half of B's columns, to keep
//     a buffer at 16 KB and three blocks on an SM).  256 threads in a 16 x 16
//     layout keep 4 rows x hd / 16 contiguous columns of y and hd / 16 x
//     ds / 16 entries of the state in registers, fed by vector shared loads
//     (P stored [j][i] so a thread's four rows are one load).
//     So x_j is staged once in every y block that needs it and again in
//     the state block (twice there for f32 at ds = 128), not once for both
//     products: one block doing y and the state would walk the whole
//     chunk alone, and the split gives B * H * (1 + ceil(n_t / 2)) blocks
//     of about n_t + 1 steps each (1536 at the serving shape, over four
//     waves of three blocks on each of 132 SMs), where one block per
//     (batch, head) would give 512 blocks of 2 n_t + 2 steps each, 1.3
//     waves with the last one a third full.
//   * cum is one thread's in-order f32 scan over the chunk, the order of
//     torch.cumsum on the card, so the inter-chunk term that the caller
//     computes from torch.cumsum sees the kernel's own cum.  The chunk's
//     outputs are large beside their rounding (cum reaches -L * dt * |a|,
//     and exp(cum_i - cum_j) takes the difference of two such sums), so a
//     scan in any other order moves y by far more than the products do.
//   * Every output's f32 operation sequence is the one of the kernel this
//     design replaced: masking is by select (a score with j > i, or past
//     L, is 0, and its product is still added), y sums over all 64 j of a
//     tile in order, the state over the chunk's j in order.
//   * x, B, C and dt are read through their batch / sequence / head
//     strides, so B and C may be views expanded over the heads.
#include "common.cuh"
#include "sm90.cuh"

namespace {

using repro::Strides;
using repro::to_f;

constexpr int kThreads = 256;
constexpr int TT = 64;  // rows per i tile and per j tile

constexpr int kBatch = 8;  // global loads a thread keeps in flight before it stores

// rows [r0, r0 + TT) of a (., L, ., W) tensor slice into dst[TT][LDD] as
// f32; rows at or past l are 0.  kBatch loads are issued before their
// stores, so their latencies overlap.
template <typename T, int W, int LDD>
__device__ __forceinline__ void stage(float* dst, const T* src, long long s_stride, int r0, int l) {
  constexpr int N = TT * W / kThreads, NB = N < kBatch ? N : kBatch;
#pragma unroll 1
  for (int u0 = 0; u0 < N; u0 += NB) {
    float v[NB];
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      const int e = threadIdx.x + (u0 + u) * kThreads, r = e / W, col = e - r * W, pos = r0 + r;
      v[u] = pos < l ? to_f(src[(size_t)pos * s_stride + col]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      const int e = threadIdx.x + (u0 + u) * kThreads, r = e / W, col = e - r * W;
      dst[r * LDD + col] = v[u];
    }
  }
}

// N consecutive f32 of shared memory, by the widest aligned loads
template <int N>
__device__ __forceinline__ void lds(float (&v)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int c = 0; c < N; c += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + c);
      v[c] = t.x;
      v[c + 1] = t.y;
      v[c + 2] = t.z;
      v[c + 3] = t.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int c = 0; c < N; c += 2) {
      const float2 t = *reinterpret_cast<const float2*>(p + c);
      v[c] = t.x;
      v[c + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int c = 0; c < N; ++c) v[c] = p[c];
  }
}

// N consecutive bf16 of shared memory as f32, by the widest aligned loads
template <int N>
__device__ __forceinline__ void lds(float (&v)[N], const __nv_bfloat16* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int c = 0; c < N; c += 4) {
      const uint2 raw = *reinterpret_cast<const uint2*>(p + c);
      const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
      const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
      v[c] = lo.x;
      v[c + 1] = lo.y;
      v[c + 2] = hi.x;
      v[c + 3] = hi.y;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int c = 0; c < N; c += 2) {
      const float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + c));
      v[c] = t.x;
      v[c + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int c = 0; c < N; ++c) v[c] = __bfloat162float(p[c]);
  }
}

// rows [r0, r0 + TT) of a (., L, ., W) tensor slice into dst[TT][W] in its
// own type by 16-byte cp.async (every row 16-byte aligned), rows at or
// past l zero
template <typename T, int W>
__device__ __forceinline__ void copy_tile(T* dst, const T* src, long long s_stride, int r0, int l) {
  constexpr int VEC = 16 / sizeof(T), CPR = W / VEC;  // W * sizeof(T) >= 32
  for (int e = threadIdx.x; e < TT * CPR; e += kThreads) {
    const int r = e / CPR, col = (e - r * CPR) * VEC, pos = r0 + r;
    const bool ok = pos < l;
    repro::cp_async16(repro::smem_addr(dst + r * W + col), ok ? src + (size_t)pos * s_stride + col : src, ok);
  }
}

// one 64 x 64 f32 score tile (contiguous, 16-byte aligned), by cp.async
__device__ __forceinline__ void copy_scores(float* dst, const float* src) {
  for (int e = threadIdx.x; e < TT * TT / 4; e += kThreads)
    repro::cp_async16(repro::smem_addr(dst + 4 * e), src + 4 * e, true);
}

__host__ __device__ constexpr int n_pairs(int n_t) { return n_t * (n_t + 1) / 2; }

// One tile of C_i . B_j^T for one (batch, group), written as [j][i].
template <typename T, int DS>
__global__ void __launch_bounds__(kThreads)
ssd_scores(const T* __restrict__ bm, const T* __restrict__ cm, float* __restrict__ cbt, int l, int groups,
           Strides bs, Strides cs) {
  constexpr int LDS = DS + 1;  // the padded rows keep the strided reads free of bank conflicts
  extern __shared__ __align__(16) float sm[];
  float* c_s = sm;              // [TT][LDS]
  float* b_s = c_s + TT * LDS;  // [TT][LDS]
  const int pair = blockIdx.x, g = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  int it = 0;
  while (n_pairs(it + 1) <= pair) ++it;
  const int jt = pair - n_pairs(it);

  stage<T, DS, LDS>(c_s, cm + (size_t)bb * cs.b + (size_t)g * cs.h, cs.s, it * TT, l);
  stage<T, DS, LDS>(b_s, bm + (size_t)bb * bs.b + (size_t)g * bs.h, bs.s, jt * TT, l);
  __syncthreads();
  // rows ty*4 + r, columns tx + 16 c
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
  float* tile = cbt + (((size_t)bb * groups + g) * n_pairs((l + TT - 1) / TT) + pair) * TT * TT;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    *reinterpret_cast<float4*>(tile + (tx + 16 * c) * TT + ty * 4) = make_float4(sc[0][c], sc[1][c], sc[2][c], sc[3][c]);
}

// Shared memory of the chunk kernel: two buffers (the tile in use and the
// next one in flight), each x_j in the input type and then 16 KB: the
// score tile (y blocks, turned into P in place) or, in the state block, a
// chunk of B_j's columns in the input type (all of them but for f32 at
// ds = 128, which takes two passes over j); then dt, cum and the state
// weights over the chunk.
template <typename T, int HD, int DS>
struct ChunkSmem {
  static constexpr int kChunks = DS * sizeof(T) > 256 ? DS * (int)sizeof(T) / 256 : 1;  // B column chunks
  static constexpr size_t kX = (size_t)TT * HD * sizeof(T);
  static constexpr size_t kBuf = kX + (size_t)TT * TT * 4;
  static size_t bytes(int l) { return 2 * kBuf + 3 * sizeof(float) * (size_t)l; }
};

// Grid (heads, batch, 1 + ceil(n_t / 2)), each block about n_t + 1 tile
// steps: block z == 0 computes the chunk state and the decay, block z > 0
// the y rows of i tiles n_t - z and z - 1 (one tile where they meet).
template <typename T, int HD, int DS>
__global__ void __launch_bounds__(kThreads, 3)
ssd_chunk(const T* __restrict__ x, const T* __restrict__ bm, const float* __restrict__ dt,
          const float* __restrict__ a, const float* __restrict__ cbt, float* __restrict__ y,
          float* __restrict__ st, float* __restrict__ dec, int l, int h, int groups, Strides xs, Strides bs,
          Strides dts) {
  using S = ChunkSmem<T, HD, DS>;
  constexpr int NY = HD / 16;  // y columns and state rows per thread
  constexpr int NS = DS / 16;  // state columns per thread
  constexpr int NC = S::kChunks, DSC = DS / NC, NSC = NS / NC;  // B column chunks, their widths
  extern __shared__ __align__(16) unsigned char smc[];
  float* dt_s = reinterpret_cast<float*>(smc + 2 * S::kBuf);  // [l]
  float* cum_s = dt_s + l;                                   // [l]
  float* w_s = cum_s + l;                                    // [l] state weights exp(cum_L - cum_j) dt_j
  auto x_buf = [&](int t) { return reinterpret_cast<T*>(smc + (t & 1) * S::kBuf); };
  auto second = [&](int t) { return smc + (t & 1) * S::kBuf + S::kX; };

  const int hh = blockIdx.x, bb = blockIdx.y;
  const int g = hh / (h / groups);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const T* x_bh = x + (size_t)bb * xs.b + (size_t)hh * xs.h;
  const T* b_bh = bm + (size_t)bb * bs.b + (size_t)hh * bs.h;
  const float* dt_bh = dt + (size_t)bb * dts.b + (size_t)hh * dts.h;
  const int n_t = (l + TT - 1) / TT;
  const bool state = blockIdx.z == 0;
  // y: the block's steps are the pairs (it_a, 0 .. it_a), then (it_b, 0 .. it_b)
  const int it_a = n_t - (int)blockIdx.z, it_b = (int)blockIdx.z - 1;
  const int n_steps = state ? NC * n_t : it_a + 1 + (it_b < it_a ? it_b + 1 : 0);
  const float* sc_bg = cbt + ((size_t)bb * groups + g) * n_pairs(n_t) * TT * TT;
  auto pair_it = [&](int t) { return t <= it_a ? it_a : it_b; };
  auto pair_jt = [&](int t) { return t <= it_a ? t : t - it_a - 1; };

  // step t's inputs into buffer t & 1: x_j, and column chunk t / n_t of
  // B_j (state: j tile t % n_t) or the (it, jt) score tile (y)
  auto issue = [&](int t) {
    const int jt = state ? t % n_t : pair_jt(t);
    copy_tile<T, HD>(x_buf(t), x_bh, xs.s, jt * TT, l);
    if (state)
      copy_tile<T, DSC>(reinterpret_cast<T*>(second(t)), b_bh + (t / n_t) * DSC, bs.s, jt * TT, l);
    else
      copy_scores(reinterpret_cast<float*>(second(t)), sc_bg + (size_t)(n_pairs(pair_it(t)) + jt) * TT * TT);
    repro::cp_async_commit();
  };
  issue(0);

  // ---- dt and the inclusive prefix sum of dt * a over the chunk ----
  for (int i = tid; i < l; i += kThreads) dt_s[i] = dt_bh[(size_t)i * dts.s];
  __syncthreads();
  if (tid == 0) {
    // in order, product and sum each rounded (no fma contraction): the
    // same bits as torch.cumsum(dt * a, dim=1) on the card, whose scan
    // over a non-innermost axis runs sequentially in f32
    const float a_h = a[hh];
    float acc = 0.f, v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = u < l ? dt_s[u] : 0.f;
    for (int i0 = 0; i0 < l; i0 += 8) {  // the next eight reads go out before this eight's stores
      float nv[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) nv[u] = i0 + 8 + u < l ? dt_s[i0 + 8 + u] : 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (i0 + u < l) {
          acc = __fadd_rn(acc, __fmul_rn(v[u], a_h));
          cum_s[i0 + u] = acc;
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = nv[u];
    }
  }
  __syncthreads();
  const float cum_last = cum_s[l - 1];

  if (state) {
    // ---- chunk state: sum_j exp(cum_L - cum_j) dt_j x_j^T B_j, in order over j ----
    for (int j = tid; j < l; j += kThreads) w_s[j] = expf(cum_last - cum_s[j]) * dt_s[j];
    // state rows ty*NY + r, columns c*DSC + tx*NSC + u in sacc[r][c*NSC + u]
    float sacc[NY][NS];
#pragma unroll
    for (int r = 0; r < NY; ++r)
#pragma unroll
      for (int c = 0; c < NS; ++c) sacc[r][c] = 0.f;
    int t = 0;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      for (int jt = 0; jt < n_t; ++jt, ++t) {
        repro::cp_async_wait<0>();
        __syncthreads();  // step t has landed (and w_s is written); buffer (t + 1) & 1 is free
        if (t + 1 < n_steps) issue(t + 1);
        const T* xr = x_buf(t);
        const T* br = reinterpret_cast<const T*>(second(t));
        const int j0 = jt * TT, jn = min(TT, l - j0);
        for (int jj = 0; jj < jn; ++jj) {
          const float w = w_s[j0 + jj];
          float xw[NY], bv[NSC];
          lds(xw, xr + jj * HD + ty * NY);
#pragma unroll
          for (int r = 0; r < NY; ++r) xw[r] = w * xw[r];
          lds(bv, br + jj * DSC + tx * NSC);
#pragma unroll
          for (int r = 0; r < NY; ++r)
#pragma unroll
            for (int u = 0; u < NSC; ++u) sacc[r][c * NSC + u] = fmaf(xw[r], bv[u], sacc[r][c * NSC + u]);
        }
      }
    }
    float* st_bh = st + ((size_t)bb * h + hh) * HD * DS;
#pragma unroll
    for (int r = 0; r < NY; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int u = 0; u < NSC; ++u)
          st_bh[(ty * NY + r) * DS + c * DSC + tx * NSC + u] = sacc[r][c * NSC + u];
    if (tid == 0) dec[(size_t)bb * h + hh] = expf(cum_last);
    return;
  }

  // ---- y_intra of i tiles it_a and it_b: the j tiles up to the diagonal, in order ----
  float acc[4][NY];  // y rows i0 + ty*4 + r, columns tx*NY + c
  for (int t = 0; t < n_steps; ++t) {
    const int it = pair_it(t), jt = pair_jt(t), i0 = it * TT, j0 = jt * TT;
    if (jt == 0) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < NY; ++c) acc[r][c] = 0.f;
    }
    repro::cp_async_wait<0>();
    __syncthreads();  // step t's tiles have landed; buffer (t + 1) & 1 is free
    if (t + 1 < n_steps) issue(t + 1);
    const T* xr = x_buf(t);
    float* p_s = reinterpret_cast<float*>(second(t));  // scores, then P in place, [j][i]
    {
      // this thread's row i is fixed, its j = j0 + tid / TT + u * (kThreads / TT)
      const int i = i0 + (tid & (TT - 1));
      const float cum_i = i < l ? cum_s[i] : 0.f;
#pragma unroll
      for (int u = 0; u < TT * TT / kThreads; ++u) {
        const int e = tid + u * kThreads, j = j0 + e / TT;
        float p = 0.f;
        if (j <= i && i < l) p = p_s[e] * expf(cum_i - cum_s[j]) * dt_s[j];  // j <= i < l: j inside the chunk
        p_s[e] = p;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int jj = 0; jj < TT; ++jj) {
      const float4 pv = *reinterpret_cast<const float4*>(p_s + jj * TT + ty * 4);
      float xv[NY];
      lds(xv, xr + jj * HD + tx * NY);
#pragma unroll
      for (int c = 0; c < NY; ++c) {
        acc[0][c] = fmaf(pv.x, xv[c], acc[0][c]);
        acc[1][c] = fmaf(pv.y, xv[c], acc[1][c]);
        acc[2][c] = fmaf(pv.z, xv[c], acc[2][c]);
        acc[3][c] = fmaf(pv.w, xv[c], acc[3][c]);
      }
    }
    if (jt == it) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty * 4 + r;
        if (i < l) {
          float* y_row = y + (((size_t)bb * l + i) * h + hh) * HD + tx * NY;
#pragma unroll
          for (int c = 0; c < NY; ++c) y_row[c] = acc[r][c];
        }
      }
    }
  }
}

struct Args {
  const void *x, *bm, *cm;
  const float *dt, *a;
  float *cbt, *y, *st, *dec;
  int b, l, h, groups;
  Strides xs, bs, cs, dts;
};

template <typename T, int HD, int DS>
cudaError_t launch_chunk(const Args& p, cudaStream_t stream) {
  const size_t smem = ChunkSmem<T, HD, DS>::bytes(p.l);
  static size_t allowed = 0;
  cudaError_t e = repro::allow_smem(ssd_chunk<T, HD, DS>, smem, allowed);
  if (e != cudaSuccess) return e;
  ssd_chunk<T, HD, DS><<<dim3(p.h, p.b, 1 + ((p.l + TT - 1) / TT + 1) / 2), kThreads, smem, stream>>>(
      static_cast<const T*>(p.x), static_cast<const T*>(p.bm), p.dt, p.a, p.cbt, p.y, p.st, p.dec, p.l, p.h,
      p.groups, p.xs, p.bs, p.dts);
  return cudaGetLastError();
}

template <typename T, int HD, int DS>
cudaError_t launch(const Args& p, cudaStream_t stream) {
  // x and B go to shared memory by 16-byte cp.async: every row they read
  // must start 16-byte aligned (the wrapper copies any that do not)
  const long long m = 16 / sizeof(T);
  if ((reinterpret_cast<uintptr_t>(p.x) | reinterpret_cast<uintptr_t>(p.bm)) % 16 || p.xs.b % m || p.xs.s % m ||
      p.xs.h % m || p.bs.b % m || p.bs.s % m || p.bs.h % m)
    return cudaErrorInvalidValue;
  const size_t smem_s = sizeof(float) * 2 * TT * (DS + 1);
  static size_t allowed_s = 0;
  cudaError_t e = repro::allow_smem(ssd_scores<T, DS>, smem_s, allowed_s);
  if (e != cudaSuccess) return e;
  ssd_scores<T, DS><<<dim3(n_pairs((p.l + TT - 1) / TT), p.groups, p.b), kThreads, smem_s, stream>>>(
      static_cast<const T*>(p.bm), static_cast<const T*>(p.cm), p.cbt, p.l, p.groups, p.bs, p.cs);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return launch_chunk<T, HD, DS>(p, stream);
}

template <typename T, int HD>
cudaError_t by_ds(int ds, const Args& p, cudaStream_t s) {
  switch (ds) {
    case 16: return launch<T, HD, 16>(p, s);
    case 32: return launch<T, HD, 32>(p, s);
    case 64: return launch<T, HD, 64>(p, s);
    case 128: return launch<T, HD, 128>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t by_hd(int hd, int ds, const Args& p, cudaStream_t s) {
  return repro::with_head_dim(hd, [&](auto HD) { return by_ds<T, decltype(HD)::value>(ds, p, s); });
}

}  // namespace

// x (b, l, h, hd), bm / cm (b, l, h, ds) in one dtype (f32 or bf16), dt
// (b, l, h) f32, each with element strides (batch, seq, head) and its last
// axis contiguous, every row of x and bm 16-byte aligned (pointer and
// strides); a (h,) f32.  groups is 1 when bm and cm hold one row
// for every head (head stride 0), else h.  cbt is f32 scratch of
// b * groups * P * 64 * 64 floats, P = n(n + 1) / 2 for n = ceil(l / 64)
// tiles.  Writes y (b, l, h, hd), st (b, h, hd, ds) and dec (b, h),
// contiguous f32.  hd and ds in {16, 32, 64, 128}; l >= 1.
extern "C" int ssd_chunk_launch(const void* x, const void* bm, const void* cm, const void* dt,
                                const void* a, void* cbt, void* y, void* st, void* dec, int b, int l,
                                int h, int hd, int ds, int groups, long long xs_b, long long xs_s,
                                long long xs_h, long long bs_b, long long bs_s, long long bs_h,
                                long long cs_b, long long cs_s, long long cs_h, long long dts_b,
                                long long dts_s, long long dts_h, int is_bf16, void* stream) {
  if (l < 1 || !(groups == 1 || groups == h)) return (int)cudaErrorInvalidValue;
  const Args p{x, bm, cm, static_cast<const float*>(dt), static_cast<const float*>(a),
               static_cast<float*>(cbt), static_cast<float*>(y), static_cast<float*>(st),
               static_cast<float*>(dec), b, l, h, groups,
               Strides{xs_b, xs_s, xs_h}, Strides{bs_b, bs_s, bs_h}, Strides{cs_b, cs_s, cs_h},
               Strides{dts_b, dts_s, dts_h}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? by_hd<__nv_bfloat16>(hd, ds, p, s) : by_hd<float>(hd, ds, p, s));
}
