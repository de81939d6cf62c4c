// One-token flash-decode over a contiguous (B, S, KV, dh) cache.
//
// Replaces the TPU kernel decode_attention_pallas (_kernel,
// src/repro/kernels/decode_attention/kernel.py): q (B, H, dh) attends the
// positions kpos < lengths[b] of row b.  The output is normalised
// (acc / max(l, 1e-30) in q's dtype) or, when asked for, the f32
// partials (o un-normalised, m, l) that combine across cache shards.
// Its caller is the contiguous engine's decode (layers.attn_decode,
// lengths = pos + 1).
//
// What bounds it on an H100: bytes.  A step reads each live position's K
// and V once per KV head (2 * len * dh elements) for 4 * G * len * dh
// FLOP, G = 2 query heads per KV head at the serving shapes: about one
// FLOP per byte, two orders of magnitude below the tensor-core ridge.
//
// Design (the paged_decode.cu block on a contiguous cache).
//   * Grid (B, KV), 128 threads: the G query heads of a KV head ride in
//     one block, so each K/V byte is read from device memory once for all
//     of them.  The TPU grid's sequential S axis becomes a loop inside the
//     block over chunks of 32 positions, staged in shared memory as f32.
//   * The loop stops at the row's length: the TPU kernel streams all S
//     positions and masks the tail.  Any S is taken (the TPU wrapper
//     asserts S % bs == 0).
//   * K and V are read in place through their batch / sequence / head
//     strides (head_dim contiguous); the TPU wrapper transposes them to
//     (B, KV, S, dh) copies first.
//   * Online softmax in f32 with the finite NEG_INF of the reference.  A
//     row with lengths[b] <= 0 reproduces the TPU kernel: every one of
//     its S logits is NEG_INF, each weighs exp(0) = 1, so m = NEG_INF,
//     l = S, o = sum(V), and the normalised output is mean(V).
//   * Warp w scores group heads w, w + 4, ...: lane j takes key j of the
//     chunk (one fmaf chain over head_dim in order); the max and sum use a
//     fixed butterfly of shuffles.  The (G, head_dim) accumulator is
//     spread over the block's threads.
#include "common.cuh"

namespace {

using repro::NEG_INF;
using repro::from_f;
using repro::to_f;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int KC = 32;    // key positions per chunk
constexpr int GMAX = 16;  // group heads per KV head the kernel takes

// element strides of a (B, S, KV, dh) cache; head_dim's is 1
struct Strides {
  long long b, s, h;
};

template <int DH>
size_t smem_bytes(int g) {
  return sizeof(float) * ((size_t)g * (DH + 1) + KC * (DH + 1) + KC * DH + g * KC + 3 * g);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_decode(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
             const int* __restrict__ lengths, T* __restrict__ out, float* __restrict__ o_part,
             float* __restrict__ m_part, float* __restrict__ l_part, int h, int kv, int s_len,
             Strides ks, Strides vs, float scale) {
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
  float* m_s = a_s + g;         // [g] final running max
  float* l_s = m_s + g;         // [g] final partition sums

  const int b = blockIdx.x, kvh = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = lengths[b];
  const bool empty = len <= 0;  // all S positions masked: uniform weights
  const int walk = empty ? s_len : min(len, s_len);
  const T* k_row = kc + (size_t)b * ks.b + (size_t)kvh * ks.h;
  const T* v_row = vc + (size_t)b * vs.b + (size_t)kvh * vs.h;

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

  for (int c0 = 0; c0 < walk; c0 += KC) {
    __syncthreads();  // the previous chunk is consumed (and q_s is staged)
    for (int e = tid; e < KC * DH; e += kThreads) {
      const int kk = e / DH, col = e - kk * DH, pos = c0 + kk;
      float kx = 0.f, vx = 0.f;
      if (pos < walk) {
        kx = to_f(k_row[(size_t)pos * ks.s + col]);
        vx = to_f(v_row[(size_t)pos * vs.s + col]);
      }
      k_s[kk * LD + col] = kx;
      v_s[kk * DH + col] = vx;
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < GW; ++t) {
      const int gg = warp + kWarps * t;
      if (gg < g) {  // warp-uniform
        const bool valid = c0 + lane < walk;
        float dot = 0.f;
#pragma unroll 8
        for (int col = 0; col < DH; ++col) dot = fmaf(q_s[gg * LD + col], k_s[lane * LD + col], dot);
        const float s = (valid && !empty) ? dot * scale : NEG_INF;
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
    if (gg < g && lane == 0) {
      m_s[gg] = m_r[t];
      l_s[gg] = l_r[t];
    }
  }
  __syncthreads();
  const size_t head0 = (size_t)b * h + (size_t)kvh * g;  // == (b * kv + kvh) * g
  if (o_part != nullptr) {
    for (int gg = tid; gg < g; gg += kThreads) {
      m_part[head0 + gg] = m_s[gg];
      l_part[head0 + gg] = l_s[gg];
    }
  }
#pragma unroll
  for (int j = 0; j < NE; ++j) {
    const int e = tid + j * kThreads;
    if (e < g * DH) {
      const int gg = e / DH, col = e - gg * DH;
      if (o_part != nullptr) {
        o_part[(head0 + gg) * DH + col] = acc[j];
      } else {
        out[(head0 + gg) * DH + col] = from_f<T>(acc[j] / fmaxf(l_s[gg], 1e-30f));
      }
    }
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* kc, const void* vc, const int* lengths, void* out,
                   float* o, float* m, float* l, int b, int h, int kv, int s, Strides ks,
                   Strides vs, cudaStream_t st) {
  const size_t smem = smem_bytes<DH>(h / kv);
  static size_t allowed = 0;
  cudaError_t e = repro::allow_smem(flash_decode<T, DH>, smem, allowed);
  if (e != cudaSuccess) return e;
  flash_decode<T, DH><<<dim3(b, kv), kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc), lengths,
      static_cast<T*>(out), o, m, l, h, kv, s, ks, vs, 1.0f / sqrtf((float)DH));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int dh, const void* q, const void* kc, const void* vc, const int* lengths,
                     void* out, float* o, float* m, float* l, int b, int h, int kv, int s,
                     Strides ks, Strides vs, cudaStream_t st) {
  switch (dh) {
    case 16: return launch<T, 16>(q, kc, vc, lengths, out, o, m, l, b, h, kv, s, ks, vs, st);
    case 32: return launch<T, 32>(q, kc, vc, lengths, out, o, m, l, b, h, kv, s, ks, vs, st);
    case 64: return launch<T, 64>(q, kc, vc, lengths, out, o, m, l, b, h, kv, s, ks, vs, st);
    case 128: return launch<T, 128>(q, kc, vc, lengths, out, o, m, l, b, h, kv, s, ks, vs, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (b, h, dh) contiguous; k_cache / v_cache (b, s, kv, dh) with element
// strides (batch, seq, head) and head_dim contiguous; lengths (b,) int32.
// partials == 0: out (b, h, dh) in q's dtype.  partials == 1: o (b, kv,
// h / kv, dh), m and l (b, kv, h / kv, 1), all f32, and out unused.  q and
// the caches share one dtype (f32 or bf16).  dh in {16, 32, 64, 128},
// h / kv <= 16.
extern "C" int flash_decode_launch(const void* q, const void* kc, const void* vc,
                                   const void* lengths, void* out, void* o, void* m, void* l,
                                   int b, int h, int kv, int dh, int s, long long ks_b,
                                   long long ks_s, long long ks_h, long long vs_b, long long vs_s,
                                   long long vs_h, int partials, int is_bf16, void* stream) {
  if (kv <= 0 || h % kv || h / kv > GMAX) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ln = static_cast<const int*>(lengths);
  const Strides ks{ks_b, ks_s, ks_h}, vs{vs_b, vs_s, vs_h};
  float* o_p = partials ? static_cast<float*>(o) : nullptr;
  float* m_p = partials ? static_cast<float*>(m) : nullptr;
  float* l_p = partials ? static_cast<float*>(l) : nullptr;
  const cudaError_t e =
      is_bf16 ? dispatch<__nv_bfloat16>(dh, q, kc, vc, ln, out, o_p, m_p, l_p, b, h, kv, s, ks, vs, st)
              : dispatch<float>(dh, q, kc, vc, ln, out, o_p, m_p, l_p, b, h, kv, s, ks, vs, st);
  return (int)e;
}
