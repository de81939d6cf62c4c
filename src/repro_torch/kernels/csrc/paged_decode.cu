// One-token flash-decode through a block table over a shared KV pool.
//
// Replaces the TPU kernel paged_decode_attention_pallas (_paged_kernel,
// src/repro/kernels/decode_attention/kernel.py): q (B, H, dh) attends the
// first lengths[b] positions of row b, whose K/V live in pool blocks
// block_tables[b, :].
//
// What bounds it on an H100: bytes.  A step reads each live position's
// K and V once per KV head (2 * len * dh elements) for 2 * G * len * dh
// FLOP, G = 2 query heads per KV head at the serving shapes: about one
// FLOP per byte, two orders of magnitude below the tensor-core ridge, so
// the math stays f32 on the CUDA cores and the design is about keeping
// enough memory requests in flight.  At the serving shapes the whole
// step is a few hundred KB, so what the card waits on is the latency of
// its round trips, not the bandwidth.
//
// Design.
//   * Split over positions: grid (B, KV, n_split), n_split =
//     ceil(n_t * bs / 64), one block of 128 threads per 64 positions of a
//     row (320 blocks at the serving shape, against 64 for one block per
//     (row, KV head)).  n_t is known on the host, so no sync is needed.
//     The G group heads of a KV head ride in one block, so each K/V byte
//     is read from device memory once for all of them.
//   * A block reads its row's length, then the table entries its split
//     reaches, once, into shared memory; a split wholly past the length
//     writes an empty partial (m = NEG_INF, l = 0) and exits.  Positions
//     at or past the length are never read and table entries past
//     ceil(len / bs) are never dereferenced.
//   * K and V rows come in as 16-byte cp.async copies (8 bf16 or 4 f32 a
//     lane), all of the split's copies in flight at once (32 KB in bf16
//     at head_dim 128), straight into shared memory.
//   * Every warp scores: warp w takes every fourth group of positions,
//     a position's row split over head_dim / (16-byte chunk) lanes whose
//     partial dots meet in a fixed butterfly of shuffles; then one warp
//     per group head takes the split's max, exp and sum, and the block's
//     threads spread the (G, head_dim) P V over the split's positions.
//   * The f32 (o, m, l) partials go to scratch that the wrapper
//     allocates; a second kernel, launched from the same C entry point,
//     merges each row's live splits (a row of length 0 gives an exact 0).
//     Online softmax in f32 throughout.
#include "common.cuh"
#include "sm90.cuh"

namespace {

using repro::NEG_INF;
using repro::from_f;
using repro::to_f;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int PS = 64;    // positions per split
constexpr int GMAX = 16;  // group heads per KV head the kernel takes

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

// K, V [PS][DH] in T; q [g][DH], p [g][PS] f32; table entries [PS + 1]
template <typename T, int DH>
size_t smem_bytes(int g) {
  return 2 * (size_t)PS * DH * sizeof(T) + sizeof(float) * ((size_t)g * DH + (size_t)g * PS) +
         sizeof(int) * (PS + 1);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
paged_decode_split(const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
                   const int* __restrict__ tables, const int* __restrict__ lengths,
                   float* __restrict__ o_part, float* __restrict__ m_part,
                   float* __restrict__ l_part, int h, int kv, int bs, int n_t, float scale) {
  using C = Cfg<T, DH>;
  const int g = h / kv;
  extern __shared__ __align__(16) uint8_t smem[];
  T* k_s = reinterpret_cast<T*>(smem);                  // [PS][DH]
  T* v_s = k_s + PS * DH;                               // [PS][DH]
  float* q_s = reinterpret_cast<float*>(v_s + PS * DH);  // [g][DH]
  float* p_s = q_s + g * DH;                            // [g][PS]
  int* tbl_s = reinterpret_cast<int*>(p_s + g * PS);    // [PS + 1]

  const int b = blockIdx.x, kvh = blockIdx.y, sp = blockIdx.z, n_split = gridDim.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = min(lengths[b], n_t * bs);
  const int s0 = sp * PS, n = min(PS, len - s0);
  const size_t part = ((size_t)(b * kv + kvh) * n_split + sp) * g;  // (row, KV head, split) partials
  if (n <= 0) {
    if (tid < g) {
      m_part[part + tid] = NEG_INF;
      l_part[part + tid] = 0.f;
    }
    return;
  }

  const int e0 = s0 / bs, n_e = (s0 + n - 1) / bs - e0 + 1;  // table entries below ceil(len / bs)
  for (int e = tid; e < n_e; e += kThreads) tbl_s[e] = tables[(size_t)b * n_t + e0 + e];
  for (int e = tid; e < g * DH; e += kThreads) q_s[e] = to_f(q[((size_t)b * h + kvh * g) * DH + e]);
  __syncthreads();

  for (int e = tid; e < n * C::CH; e += kThreads) {
    const int p = e / C::CH, c = e - p * C::CH, pos = s0 + p;
    const size_t a = (((size_t)tbl_s[pos / bs - e0] * bs + pos % bs) * kv + kvh) * DH + c * C::VEC;
    repro::cp_async16(repro::smem_addr(k_s + p * DH + c * C::VEC), kp + a, true);
    repro::cp_async16(repro::smem_addr(v_s + p * DH + c * C::VEC), vp + a, true);
  }
  repro::cp_async_commit();
  repro::cp_async_wait<0>();
  __syncthreads();

  // scores: lane group (lane / CH) of warp w takes positions w * RPW + lane / CH + 4 * RPW * j
  {
    const int c = lane % C::CH, sub = lane / C::CH;
    for (int p0 = warp * C::RPW; p0 < PS; p0 += kWarps * C::RPW) {  // warp-uniform
      const int p = p0 + sub;
      const bool valid = p < n;
      float kx[C::VEC];
      load16(k_s + (valid ? p : 0) * DH + c * C::VEC, kx);
      for (int gg = 0; gg < g; ++gg) {
        const float* qr = q_s + gg * DH + c * C::VEC;
        float dot = 0.f;
#pragma unroll
        for (int u = 0; u < C::VEC; ++u) dot = fmaf(qr[u], kx[u], dot);
        dot = repro::group_sum<C::CH>(dot);
        if (c == 0) p_s[gg * PS + p] = valid ? dot * scale : NEG_INF;
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

// out[b, kvh * g + gg] = sum_s o_s e^(m_s - M) / sum_s l_s e^(m_s - M) over
// the splits below the row's length, M = max_s m_s; 0 for an empty row
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
paged_decode_combine(const float* __restrict__ o_part, const float* __restrict__ m_part,
                     const float* __restrict__ l_part, const int* __restrict__ lengths,
                     T* __restrict__ out, int h, int kv, int bs, int n_t, int n_split) {
  const int g = h / kv, b = blockIdx.x, kvh = blockIdx.y;
  const int len = min(lengths[b], n_t * bs);
  const int live = len > 0 ? (len + PS - 1) / PS : 0;
  const size_t part = (size_t)(b * kv + kvh) * n_split * g;
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
    out[((size_t)b * h + kvh * g + gg) * DH + col] = from_f<T>(acc / fmaxf(l, 1e-30f));
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* kp, const void* vp, const int* tables,
                   const int* lengths, void* out, float* o_part, float* m_part, float* l_part,
                   int b, int h, int kv, int bs, int n_t, int n_split, cudaStream_t st) {
  const size_t smem = smem_bytes<T, DH>(h / kv);
  static size_t allowed = 0;
  cudaError_t e = repro::allow_smem(paged_decode_split<T, DH>, smem, allowed);
  if (e != cudaSuccess) return e;
  paged_decode_split<T, DH><<<dim3(b, kv, n_split), kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp), tables,
      lengths, o_part, m_part, l_part, h, kv, bs, n_t, 1.0f / sqrtf((float)DH));
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  paged_decode_combine<T, DH><<<dim3(b, kv), kThreads, 0, st>>>(
      o_part, m_part, l_part, lengths, static_cast<T*>(out), h, kv, bs, n_t, n_split);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int dh, const void* q, const void* kp, const void* vp, const int* tables,
                     const int* lengths, void* out, float* o, float* m, float* l, int b, int h,
                     int kv, int bs, int n_t, int n_split, cudaStream_t st) {
  switch (dh) {
    case 16: return launch<T, 16>(q, kp, vp, tables, lengths, out, o, m, l, b, h, kv, bs, n_t, n_split, st);
    case 32: return launch<T, 32>(q, kp, vp, tables, lengths, out, o, m, l, b, h, kv, bs, n_t, n_split, st);
    case 64: return launch<T, 64>(q, kp, vp, tables, lengths, out, o, m, l, b, h, kv, bs, n_t, n_split, st);
    case 128: return launch<T, 128>(q, kp, vp, tables, lengths, out, o, m, l, b, h, kv, bs, n_t, n_split, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (b, h, dh); k_pool / v_pool (n_pool, bs, kv, dh); tables (b, n_t)
// int32; lengths (b,) int32; out (b, h, dh); scratch o_part (b, kv,
// n_split, g, dh), m_part / l_part (b, kv, n_split, g) f32 with n_split =
// ceil(n_t * bs / 64).  q, pools and out share one dtype (f32 or bf16),
// contiguous, the pools 16-byte aligned.  dh in {16, 32, 64, 128},
// g = h / kv <= 16.
extern "C" int paged_decode_launch(const void* q, const void* kp, const void* vp,
                                   const void* tables, const void* lengths, void* out,
                                   void* o_part, void* m_part, void* l_part, int b, int h,
                                   int kv, int dh, int bs, int n_t, int n_split, int is_bf16,
                                   void* stream) {
  if (n_split != (n_t * bs + PS - 1) / PS || h / kv > GMAX) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(lengths);
  float* o = static_cast<float*>(o_part);
  float* m = static_cast<float*>(m_part);
  float* l = static_cast<float*>(l_part);
  const cudaError_t e =
      is_bf16 ? dispatch<__nv_bfloat16>(dh, q, kp, vp, tb, ln, out, o, m, l, b, h, kv, bs, n_t, n_split, st)
              : dispatch<float>(dh, q, kp, vp, tb, ln, out, o, m, l, b, h, kv, bs, n_t, n_split, st);
  return (int)e;
}
