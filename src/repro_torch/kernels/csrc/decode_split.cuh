// One-token attention split over positions: the body that paged_decode.cu
// (K/V through a block table) and flash_decode.cu (a contiguous cache read
// through its strides) share.
//
// What bounds it on an H100: bytes.  A step reads each live position's K
// and V once per KV head (2 * len * dh elements) for 4 * G * len * dh
// FLOP, G = 2 query heads per KV head at the serving shapes: about one
// FLOP per byte, two orders of magnitude below the tensor-core ridge, so
// the math stays f32 on the CUDA cores and the design is about keeping
// enough memory requests in flight.  At the serving shapes a whole step
// is a few hundred KB, so what the card waits on is the latency of its
// round trips, not the bandwidth.
//
// Design.
//   * Split over positions: grid (B, KV, n_split), n_split = ceil(cap /
//     64) with cap the positions the cache addresses (n_t * bs through a
//     table, S in a contiguous cache), one block of 128 threads per 64
//     positions of a row (320 blocks at the serving shapes, against 64
//     for one block per (row, KV head)).  cap is known on the host, so no
//     sync is needed.  The G group heads of a KV head ride in one block,
//     so each K/V byte is read from device memory once for all of them.
//   * A block reads its row's length, then (through a table) the entries
//     its split reaches, once, into shared memory; a split wholly past a
//     non-empty row's length writes an empty partial (m = NEG_INF, l = 0)
//     and exits.  Positions at or past the length are never read, and
//     table entries past ceil(len / bs) are never dereferenced.
//   * K and V rows come in as 16-byte cp.async copies (8 bf16 or 4 f32 a
//     lane), all of the split's copies in flight at once (32 KB in bf16
//     at head_dim 128), straight into shared memory.
//   * Every warp scores: warp w takes every fourth group of positions,
//     a position's row split over head_dim / (16-byte chunk) lanes whose
//     partial dots meet in a fixed butterfly of shuffles; then one warp
//     per group head takes the split's max, exp and sum, and the block's
//     threads spread the (G, head_dim) P V over the split's positions.
//   * The f32 (o, m, l) partials go to scratch that the wrapper
//     allocates; a second kernel merges each row's live splits: M = max_s
//     m_s, l = sum_s l_s e^(m_s - M), o = sum_s o_s e^(m_s - M), and writes
//     o / max(l, 1e-30) in q's dtype or the merged f32 (o, m, l).
//     Online softmax in f32 throughout.
//   * The empty row (lengths[b] <= 0) follows one of two rules.  Paged:
//     an exact 0.  Mean: the TPU decode kernel's, whose S logits are all
//     NEG_INF and so weigh exp(0) = 1 each: every split reads its
//     positions with every score at NEG_INF, giving m = NEG_INF, l = the
//     split's count, o = the sum of its V rows; merged, l = S, o = sum V,
//     and the normalised output is mean V.
//   * A sliding window (PagedKVWindow: row b sees its last `window`
//     positions, lo = max(0, len - window) on) splits only [lo, len):
//     split sp covers the 64 positions from (lo / 64 + sp) * 64, so the
//     grid's third axis is (window - 1) / 64 + 2 splits at most, and the
//     positions below lo in the first split score NEG_INF.  The window is
//     the address policy's (a compile-time flag, kWindow), so the kernels
//     without one are compiled as before.
#pragma once

#include "common.cuh"
#include "sm90.cuh"

namespace repro {
namespace decode {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int PS = 64;    // positions per split
constexpr int GMAX = 16;  // group heads per KV head the kernels take

template <typename T, int DH>
struct Cfg {
  static constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte copy
  static constexpr int CH = DH / VEC;         // 16-byte chunks of a K/V row = lanes per position
  static constexpr int RPW = 32 / CH;         // positions a warp scores at once
};

// 16 bytes of shared memory as f32
__device__ __forceinline__ void load16(const float* p, float (&x)[4]) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  x[0] = r.x, x[1] = r.y, x[2] = r.z, x[3] = r.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(__halves2bfloat162(__ushort_as_bfloat16((unsigned short)(w[i] & 0xFFFFu)),
                                                           __ushort_as_bfloat16((unsigned short)(w[i] >> 16))));
    x[2 * i] = f.x, x[2 * i + 1] = f.y;
  }
}

// K/V through a block table: position pos of row b is offset pos % bs of
// pool block tables[b, pos / bs] in (n_pool, bs, kv, DH) pools.  `stage`
// reads the entries a split reaches into shared memory once.
struct PagedKV {
  static constexpr bool kWindow = false;
  const int* tables;
  int bs, n_t, kv;
  __device__ __forceinline__ int cap() const { return n_t * bs; }
  __device__ __forceinline__ void stage(int b, int s0, int n, int* tbl_s) const {
    const int e0 = s0 / bs, n_e = (s0 + n - 1) / bs - e0 + 1;  // entries below ceil(len / bs)
    for (int e = threadIdx.x; e < n_e; e += kThreads) tbl_s[e] = tables[(size_t)b * n_t + e0 + e];
  }
  template <int DH>
  __device__ __forceinline__ size_t k_off(int, int kvh, int pos, int s0, const int* tbl_s) const {
    return (((size_t)tbl_s[pos / bs - s0 / bs] * bs + pos % bs) * kv + kvh) * DH;
  }
  template <int DH>
  __device__ __forceinline__ size_t v_off(int b, int kvh, int pos, int s0, const int* tbl_s) const {
    return k_off<DH>(b, kvh, pos, s0, tbl_s);
  }
};

// PagedKV with a sliding window: row b sees its last `window` positions
struct PagedKVWindow : PagedKV {
  static constexpr bool kWindow = true;
  int window;
  // the lowest position a row of `len` positions sees
  __device__ __forceinline__ int lo(int len) const { return max(0, len - window); }
};

// K/V in a contiguous (B, S, KV, DH) cache, each read through its own
// batch / sequence / head element strides, head_dim contiguous
struct StridedKV {
  static constexpr bool kWindow = false;
  Strides ks, vs;
  int s_len;
  __device__ __forceinline__ int cap() const { return s_len; }
  __device__ __forceinline__ void stage(int, int, int, int*) const {}
  template <int DH>
  __device__ __forceinline__ size_t k_off(int b, int kvh, int pos, int, const int*) const {
    return (size_t)b * ks.b + (size_t)pos * ks.s + (size_t)kvh * ks.h;
  }
  template <int DH>
  __device__ __forceinline__ size_t v_off(int b, int kvh, int pos, int, const int*) const {
    return (size_t)b * vs.b + (size_t)pos * vs.s + (size_t)kvh * vs.h;
  }
};

// K, V [PS][DH] in T; q [g][DH], p [g][PS] f32; table entries [PS + 1]
template <typename T, int DH>
size_t split_smem_bytes(int g) {
  return 2 * (size_t)PS * DH * sizeof(T) + sizeof(float) * ((size_t)g * DH + (size_t)g * PS) +
         sizeof(int) * (PS + 1);
}

// the positions row b walks: its length clamped to cap; for an empty row
// under the mean rule every position
template <bool MEAN_EMPTY>
__device__ __forceinline__ int walk_len(int raw, int cap) {
  return MEAN_EMPTY && raw <= 0 ? cap : min(raw, cap);
}

template <typename T, int DH, class KV, bool MEAN_EMPTY>
__global__ void __launch_bounds__(kThreads)
decode_split(const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp, KV src,
             const int* __restrict__ lengths, float* __restrict__ o_part, float* __restrict__ m_part,
             float* __restrict__ l_part, int h, int kv, float scale) {
  using C = Cfg<T, DH>;
  const int g = h / kv;
  extern __shared__ __align__(16) uint8_t smem[];
  T* k_s = reinterpret_cast<T*>(smem);                   // [PS][DH]
  T* v_s = k_s + PS * DH;                                // [PS][DH]
  float* q_s = reinterpret_cast<float*>(v_s + PS * DH);  // [g][DH]
  float* p_s = q_s + g * DH;                             // [g][PS]
  int* tbl_s = reinterpret_cast<int*>(p_s + g * PS);     // [PS + 1]

  const int b = blockIdx.x, kvh = blockIdx.y, sp = blockIdx.z, n_split = gridDim.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int raw = lengths[b];
  const bool empty = MEAN_EMPTY && raw <= 0;  // every score NEG_INF: uniform weights
  const int len = walk_len<MEAN_EMPTY>(raw, src.cap());
  int s0 = sp * PS, lo = 0;
  if constexpr (KV::kWindow) {  // the splits start at the one that holds the window's first position
    lo = src.lo(len);
    s0 += lo / PS * PS;
  }
  const int n = min(PS, len - s0);
  const size_t part = ((size_t)(b * kv + kvh) * n_split + sp) * g;  // (row, KV head, split) partials
  if (n <= 0) {
    if (tid < g) {
      m_part[part + tid] = NEG_INF;
      l_part[part + tid] = 0.f;
    }
    return;
  }

  src.stage(b, s0, n, tbl_s);
  for (int e = tid; e < g * DH; e += kThreads) q_s[e] = to_f(q[((size_t)b * h + kvh * g) * DH + e]);
  __syncthreads();

  for (int e = tid; e < n * C::CH; e += kThreads) {
    const int p = e / C::CH, c = e - p * C::CH, pos = s0 + p;
    // both offsets before either copy: the copies clobber memory, and a
    // table entry read after one would be read again for the other
    const size_t ka = src.template k_off<DH>(b, kvh, pos, s0, tbl_s) + c * C::VEC;
    const size_t va = src.template v_off<DH>(b, kvh, pos, s0, tbl_s) + c * C::VEC;
    repro::cp_async16(repro::smem_addr(k_s + p * DH + c * C::VEC), kp + ka, true);
    repro::cp_async16(repro::smem_addr(v_s + p * DH + c * C::VEC), vp + va, true);
  }
  repro::cp_async_commit();
  repro::cp_async_wait<0>();
  __syncthreads();

  // scores: lane group (lane / CH) of warp w takes positions w * RPW + lane / CH + 4 * RPW * j
  {
    const int c = lane % C::CH, sub = lane / C::CH;
    for (int p0 = warp * C::RPW; p0 < PS; p0 += kWarps * C::RPW) {  // warp-uniform
      const int p = p0 + sub;
      bool valid = p < n;
      if constexpr (KV::kWindow) valid = valid && s0 + p >= lo;
      float kx[C::VEC];
      load16(k_s + (valid ? p : 0) * DH + c * C::VEC, kx);
      for (int gg = 0; gg < g; ++gg) {
        const float* qr = q_s + gg * DH + c * C::VEC;
        float dot = 0.f;
#pragma unroll
        for (int u = 0; u < C::VEC; ++u) dot = fmaf(qr[u], kx[u], dot);
        dot = repro::group_sum<C::CH>(dot);
        if (c == 0) p_s[gg * PS + p] = valid && !empty ? dot * scale : NEG_INF;
      }
    }
  }
  __syncthreads();

  // softmax over the split: warp w takes group heads w, w + 4, ...
  for (int gg = warp; gg < g; gg += kWarps) {
    const float a0 = p_s[gg * PS + lane], a1 = p_s[gg * PS + lane + 32];
    const float mx = repro::group_max<32>(fmaxf(a0, a1));
    const float x0 = lane < n ? expf(a0 - mx) : 0.f, x1 = lane + 32 < n ? expf(a1 - mx) : 0.f;
    p_s[gg * PS + lane] = x0;
    p_s[gg * PS + lane + 32] = x1;
    const float sum = repro::group_sum<32>(x0 + x1);
    if (lane == 0) {
      m_part[part + gg] = mx;
      l_part[part + gg] = sum;
    }
  }
  __syncthreads();

  // un-normalised P V of the split
  for (int e = tid; e < g * DH; e += kThreads) {
    const int gg = e / DH, col = e - gg * DH;
    const float* pr = p_s + gg * PS;
    float acc = 0.f;
    for (int p = 0; p < n; ++p) acc = fmaf(pr[p], to_f(v_s[p * DH + col]), acc);
    o_part[(part + gg) * DH + col] = acc;
  }
}

// merges the splits below the row's walk, M = max_s m_s:
// out[b, kvh * g + gg] = sum_s o_s e^(m_s - M) / max(sum_s l_s e^(m_s - M), 1e-30)
// in T or, with PARTIALS, the merged f32 (o, M, l) at (b, kvh, gg) into
// o_out, m_out, l_out; under the paged rule an empty row has no live
// split and gives 0.  PARTIALS is a template parameter, so that the
// normalised form's loop carries no test of it.
template <typename T, int DH, class KV, bool MEAN_EMPTY, bool PARTIALS>
__global__ void __launch_bounds__(kThreads)
decode_combine(const float* __restrict__ o_part, const float* __restrict__ m_part,
               const float* __restrict__ l_part, KV src, const int* __restrict__ lengths,
               T* __restrict__ out, float* __restrict__ o_out, float* __restrict__ m_out,
               float* __restrict__ l_out, int h, int kv, int n_split) {
  const int g = h / kv, b = blockIdx.x, kvh = blockIdx.y;
  const int len = walk_len<MEAN_EMPTY>(lengths[b], src.cap());
  int live = len > 0 ? (len + PS - 1) / PS : 0;
  if constexpr (KV::kWindow) live -= src.lo(len) / PS;  // the splits start at the window's
  const size_t part = (size_t)(b * kv + kvh) * n_split * g;
  const size_t head0 = (size_t)(b * kv + kvh) * g;
  for (int e = threadIdx.x; e < g * DH; e += kThreads) {
    const int gg = e / DH, col = e - gg * DH;
    float mx = NEG_INF;
    for (int s = 0; s < live; ++s) mx = fmaxf(mx, m_part[part + s * g + gg]);
    float l = 0.f, acc = 0.f;
    for (int s = 0; s < live; ++s) {
      const size_t i = part + s * g + gg;
      const float w = expf(m_part[i] - mx);
      l = fmaf(l_part[i], w, l);
      acc = fmaf(o_part[i * DH + col], w, acc);
    }
    if (PARTIALS) {
      o_out[(head0 + gg) * DH + col] = acc;
      if (col == 0) {
        m_out[head0 + gg] = mx;
        l_out[head0 + gg] = l;
      }
    } else {
      out[(head0 + gg) * DH + col] = from_f<T>(acc / fmaxf(l, 1e-30f));
    }
  }
}

// both launches on `st`: the splits' partials into o_part / m_part /
// l_part (B, KV, n_split, g[, DH]), then their merge into out or, when
// o_out is set, (o_out, m_out, l_out); n_split = ceil(src.cap() / PS) is
// the caller's.  Both
// kernels carry the address policy in their names (PagedKV, StridedKV).
template <typename T, int DH, bool MEAN_EMPTY, class KV>
cudaError_t launch_split(const void* q, const void* kp, const void* vp, KV src, const int* lengths, void* out, float* o_out, float* m_out, float* l_out,
                         float* o_part, float* m_part, float* l_part, int b, int h, int kv,
                         int n_split, cudaStream_t st) {
  const size_t smem = split_smem_bytes<T, DH>(h / kv);
  static size_t allowed = 0;
  cudaError_t e = repro::allow_smem(decode_split<T, DH, KV, MEAN_EMPTY>, smem, allowed);
  if (e != cudaSuccess) return e;
  decode_split<T, DH, KV, MEAN_EMPTY><<<dim3(b, kv, n_split), kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp), src, lengths,
      o_part, m_part, l_part, h, kv, 1.0f / sqrtf((float)DH));
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if (o_out != nullptr)
    decode_combine<T, DH, KV, MEAN_EMPTY, true><<<dim3(b, kv), kThreads, 0, st>>>(
        o_part, m_part, l_part, src, lengths, static_cast<T*>(out), o_out, m_out, l_out, h, kv, n_split);
  else
    decode_combine<T, DH, KV, MEAN_EMPTY, false><<<dim3(b, kv), kThreads, 0, st>>>(
        o_part, m_part, l_part, src, lengths, static_cast<T*>(out), o_out, m_out, l_out, h, kv, n_split);
  return cudaGetLastError();
}

}  // namespace decode
}  // namespace repro
