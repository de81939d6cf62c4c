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
// FLOP per byte, two orders of magnitude below the tensor-core ridge.
//
// Design.  Grid (B, KV), 128 threads: the G group heads of a KV head
// ride in one block, so each K/V byte is read from device memory once
// for all of them.  The block reads its row's length and block table
// itself and loops over the ceil(len / 32) chunks of 32 positions only,
// staging each chunk's K/V in shared memory as f32.  Warp w scores group
// heads w, w + 4, ...: lane j takes key j of the chunk (one fmaf chain
// over head_dim in order) and the max and sum use a fixed butterfly of
// shuffles.  The (G, head_dim) accumulator is spread over the block's
// threads.  Online softmax in f32; positions at or past lengths[b]
// (every trash-backed entry among them) are masked by select.
#include "common.cuh"

namespace {

using repro::NEG_INF;
using repro::from_f;
using repro::to_f;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int KC = 32;    // key positions per chunk
constexpr int GMAX = 16;  // group heads per KV head the kernel takes

template <int DH>
size_t smem_bytes(int g) {
  return sizeof(float) * ((size_t)g * (DH + 1) + KC * (DH + 1) + KC * DH + g * KC + 2 * g);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
paged_decode(const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
             const int* __restrict__ tables, const int* __restrict__ lengths,
             T* __restrict__ out, int h, int kv, int bs, int n_t, float scale) {
  constexpr int LD = DH + 1;
  constexpr int NE = GMAX * DH / kThreads;  // accumulator entries per thread
  constexpr int GW = GMAX / kWarps;         // group heads per warp
  const int g = h / kv;
  extern __shared__ float sm[];
  float* q_s = sm;              // [g][LD]
  float* k_s = q_s + g * LD;    // [KC][LD]
  float* v_s = k_s + KC * LD;   // [KC][DH]
  float* p_s = v_s + KC * DH;   // [g][KC]
  float* a_s = p_s + g * KC;    // [g] chunk rescale alpha
  float* l_s = a_s + g;         // [g] final partition sums

  const int b = blockIdx.x, kvh = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = min(lengths[b], n_t * bs);
  const int* tbl = tables + (size_t)b * n_t;

  for (int e = tid; e < g * DH; e += kThreads) {
    const int gg = e / DH, col = e - gg * DH;
    q_s[gg * LD + col] = to_f(q[((size_t)b * h + kvh * g + gg) * DH + col]);
  }
  float m_r[GW], l_r[GW];
#pragma unroll
  for (int t = 0; t < GW; ++t) {
    m_r[t] = NEG_INF;
    l_r[t] = 0.f;
  }
  float acc[NE];
#pragma unroll
  for (int j = 0; j < NE; ++j) acc[j] = 0.f;

  for (int c0 = 0; c0 < len; c0 += KC) {
    __syncthreads();  // the previous chunk is consumed (and q_s is staged)
    for (int e = tid; e < KC * DH; e += kThreads) {
      const int kk = e / DH, col = e - kk * DH, pos = c0 + kk;
      float kx = 0.f, vx = 0.f;
      if (pos < len) {
        const size_t a = (((size_t)tbl[pos / bs] * bs + pos % bs) * kv + kvh) * DH + col;
        kx = to_f(kp[a]);
        vx = to_f(vp[a]);
      }
      k_s[kk * LD + col] = kx;
      v_s[kk * DH + col] = vx;
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < GW; ++t) {
      const int gg = warp + kWarps * t;
      if (gg < g) {  // warp-uniform
        const bool valid = c0 + lane < len;
        float dot = 0.f;
#pragma unroll 8
        for (int col = 0; col < DH; ++col) dot = fmaf(q_s[gg * LD + col], k_s[lane * LD + col], dot);
        const float s = valid ? dot * scale : NEG_INF;
        const float m_new = fmaxf(m_r[t], repro::group_max<32>(s));
        const float alpha = expf(m_r[t] - m_new);
        const float p = valid ? expf(s - m_new) : 0.f;
        l_r[t] = l_r[t] * alpha + repro::group_sum<32>(p);
        m_r[t] = m_new;
        p_s[gg * KC + lane] = p;
        if (lane == 0) a_s[gg] = alpha;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < NE; ++j) {
      const int e = tid + j * kThreads;
      if (e < g * DH) {
        const int gg = e / DH, col = e - gg * DH;
        float a = acc[j] * a_s[gg];
        for (int key = 0; key < KC; ++key) a = fmaf(p_s[gg * KC + key], v_s[key * DH + col], a);
        acc[j] = a;
      }
    }
  }

  __syncthreads();
#pragma unroll
  for (int t = 0; t < GW; ++t) {
    const int gg = warp + kWarps * t;
    if (gg < g && lane == 0) l_s[gg] = l_r[t];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < NE; ++j) {
    const int e = tid + j * kThreads;
    if (e < g * DH) {
      const int gg = e / DH, col = e - gg * DH;
      out[((size_t)b * h + kvh * g + gg) * DH + col] = from_f<T>(acc[j] / fmaxf(l_s[gg], 1e-30f));
    }
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* kp, const void* vp, const int* tables,
                   const int* lengths, void* out, int b, int h, int kv, int bs, int n_t,
                   cudaStream_t st) {
  const size_t smem = smem_bytes<DH>(h / kv);
  cudaError_t e = repro::allow_smem(paged_decode<T, DH>, smem);
  if (e != cudaSuccess) return e;
  paged_decode<T, DH><<<dim3(b, kv), kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp), tables,
      lengths, static_cast<T*>(out), h, kv, bs, n_t, 1.0f / sqrtf((float)DH));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int dh, const void* q, const void* kp, const void* vp, const int* tables,
                     const int* lengths, void* out, int b, int h, int kv, int bs, int n_t,
                     cudaStream_t st) {
  switch (dh) {
    case 16: return launch<T, 16>(q, kp, vp, tables, lengths, out, b, h, kv, bs, n_t, st);
    case 32: return launch<T, 32>(q, kp, vp, tables, lengths, out, b, h, kv, bs, n_t, st);
    case 64: return launch<T, 64>(q, kp, vp, tables, lengths, out, b, h, kv, bs, n_t, st);
    case 128: return launch<T, 128>(q, kp, vp, tables, lengths, out, b, h, kv, bs, n_t, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (b, h, dh); k_pool / v_pool (n_pool, bs, kv, dh); tables (b, n_t)
// int32; lengths (b,) int32; out (b, h, dh).  q, pools and out share one
// dtype (f32 or bf16).  dh in {16, 32, 64, 128}, h / kv <= 16.
extern "C" int paged_decode_launch(const void* q, const void* kp, const void* vp,
                                   const void* tables, const void* lengths, void* out, int b,
                                   int h, int kv, int dh, int bs, int n_t, int is_bf16,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(lengths);
  const cudaError_t e =
      is_bf16 ? dispatch<__nv_bfloat16>(dh, q, kp, vp, tb, ln, out, b, h, kv, bs, n_t, st)
              : dispatch<float>(dh, q, kp, vp, tb, ln, out, b, h, kv, bs, n_t, st);
  return (int)e;
}
