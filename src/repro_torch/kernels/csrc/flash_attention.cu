// Dense flash attention: grouped-query attention over contiguous
// (B, S, heads, head_dim) tensors, causal or not, online softmax in f32,
// normalised output.
//
// Replaces the TPU kernel flash_attention_pallas (_kernel,
// src/repro/kernels/flash_attention/kernel.py).  Query position i sees
// key position j iff the call is non-causal or i >= j (the causal mask is
// top-left aligned, as in the reference); the output is
// acc / max(l, 1e-30) in q's dtype.  Its callers are the encoders' non-causal
// attention (cross encoder: 256 pairs x 64 tokens; dual encoder: a
// provider's chunks x 40 tokens, head_dim 64) and the contiguous engine's
// causal admit prefill (qwen3-0.6b: 16 / 8 heads, head_dim 128).
//
// What bounds it on an H100: at these shapes the bytes (q, k, v read once,
// the output written once) and the FLOPs (4 * head_dim per visible
// (query, key) pair and head) are both small; the work per byte is below
// the ~295 FLOP/byte where the bf16 tensor cores would become the limit,
// but above the ~20 FLOP/byte of the f32 CUDA cores this first version
// runs on, so it is bound by its own arithmetic.  Tensor cores (wgmma) and
// TMA come in a later version.
//
// Design.
//   * Grid (B * ceil(Sq * G / 64), KV).  A block takes one (batch, KV head)
//     and 64 flattened rows i = q_position * G + group, so the G query
//     heads that share a KV head share every K/V chunk staged in shared
//     memory (the TPU kernel re-reads K/V per query head through its
//     index map).  The sequential KV axis of the TPU grid becomes a loop
//     inside the block.
//   * q, k and v are read in place through their batch / sequence / head
//     strides (head_dim contiguous): no transposed copies, unlike the
//     TPU wrapper's (B*H, S, dh) transposes.  The output is written
//     (B, Sq, H, dh) contiguous.
//   * Causal: the block walks keys only up to the last query position of
//     its tile, so K chunks wholly above the diagonal are never read (the
//     TPU kernel's pl.when skip).  Ragged tails (Sq, Sk not multiples of
//     the tiles) are masked: rows past Sq are not written, keys past Sk
//     are never scored.
//   * 4 threads per row: each scores 8 of the 32 keys of a chunk (one
//     fmaf chain over head_dim in order), the row's max and sum combine
//     by a fixed butterfly of warp shuffles, and each thread owns
//     head_dim / 4 interleaved output columns.  Masking is by select: a
//     masked score is NEG_INF and its probability is set to 0 after the
//     exp.
#include "common.cuh"

namespace {

using repro::NEG_INF;
using repro::from_f;
using repro::to_f;

constexpr int kThreads = 256;
constexpr int TQ = 64;  // flattened (query position, group head) rows per block
constexpr int KC = 32;  // key positions per chunk

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)TQ * (DH + 1) + 2 * KC * (DH + 1) + TQ * (KC + 1));
}

// element strides of a (B, S, heads, head_dim) tensor; head_dim's is 1
struct Strides {
  long long b, s, h;
};

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_attention(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                T* __restrict__ out, int sq, int sk, int h, int kv, int n_qt, Strides qs,
                Strides ks, Strides vs, int causal, float scale) {
  constexpr int LD = DH + 1;  // padded rows: no shared-memory bank conflicts
  constexpr int PLD = KC + 1;
  constexpr int NC = DH / 4;  // output columns per thread
  extern __shared__ float sm[];
  float* q_s = sm;             // [TQ][LD]
  float* k_s = q_s + TQ * LD;  // [KC][LD]
  float* v_s = k_s + KC * LD;  // [KC][LD]
  float* p_s = v_s + KC * LD;  // [TQ][PLD]

  const int b = blockIdx.x / n_qt, qt = blockIdx.x - b * n_qt;
  const int kvh = blockIdx.y;
  const int g = h / kv;
  const int rows_total = sq * g;
  const int i0 = qt * TQ;
  const int tid = threadIdx.x, row = tid >> 2, part = tid & 3;

  // key positions any row of this tile can see
  const int last_q = (min(rows_total, i0 + TQ) - 1) / g;
  const int n_kv = causal ? min(sk, last_q + 1) : sk;

  const T* qb = q + (size_t)b * qs.b;
  const T* kb = k + (size_t)b * ks.b + (size_t)kvh * ks.h;
  const T* vb = v + (size_t)b * vs.b + (size_t)kvh * vs.h;

  for (int e = tid; e < TQ * DH; e += kThreads) {
    const int rr = e / DH, col = e - rr * DH, i = i0 + rr;
    float x = 0.f;
    if (i < rows_total) {
      const int qp = i / g, gg = i - qp * g;
      x = to_f(qb[(size_t)qp * qs.s + (size_t)(kvh * g + gg) * qs.h + col]);
    }
    q_s[rr * LD + col] = x;
  }

  const int i = i0 + row;
  const int my_q = i / g;
  const bool live = i < rows_total;
  float m = NEG_INF, l = 0.f;
  float acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = 0.f;

  for (int c0 = 0; c0 < n_kv; c0 += KC) {
    __syncthreads();  // the previous chunk is consumed (and q_s is staged)
    for (int e = tid; e < KC * DH; e += kThreads) {
      const int kk = e / DH, col = e - kk * DH, pos = c0 + kk;
      float kx = 0.f, vx = 0.f;
      if (pos < n_kv) {
        kx = to_f(kb[(size_t)pos * ks.s + col]);
        vx = to_f(vb[(size_t)pos * vs.s + col]);
      }
      k_s[kk * LD + col] = kx;
      v_s[kk * LD + col] = vx;
    }
    __syncthreads();

    float s[KC / 4];
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < KC / 4; ++j) {
      const int key = part + 4 * j, pos = c0 + key;
      float dot = 0.f;
#pragma unroll 8
      for (int col = 0; col < DH; ++col) dot = fmaf(q_s[row * LD + col], k_s[key * LD + col], dot);
      const bool valid = live && pos < n_kv && (!causal || pos <= my_q);
      s[j] = valid ? dot * scale : NEG_INF;
      mx = fmaxf(mx, s[j]);
    }
    mx = repro::group_max<4>(mx);
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < KC / 4; ++j) {
      const int key = part + 4 * j, pos = c0 + key;
      const bool valid = live && pos < n_kv && (!causal || pos <= my_q);
      const float p = valid ? expf(s[j] - m_new) : 0.f;
      p_s[row * PLD + key] = p;
      psum += p;
    }
    psum = repro::group_sum<4>(psum);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();  // a row's 4 threads share a warp: its p_s row is complete
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] *= alpha;
    for (int key = 0; key < KC; ++key) {
      const float p = p_s[row * PLD + key];
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[c] = fmaf(p, v_s[key * LD + c * 4 + part], acc[c]);
    }
  }

  if (live) {
    const int gg = i - my_q * g;
    T* o = out + (((size_t)b * sq + my_q) * h + kvh * g + gg) * DH;
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) o[c * 4 + part] = from_f<T>(acc[c] / denom);
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int b, int sq, int sk,
                   int h, int kv, Strides qs, Strides ks, Strides vs, int causal,
                   cudaStream_t st) {
  const size_t smem = smem_bytes<DH>();
  cudaError_t e = repro::allow_smem(flash_attention<T, DH>, smem);
  if (e != cudaSuccess) return e;
  const int n_qt = (sq * (h / kv) + TQ - 1) / TQ;
  dim3 grid(b * n_qt, kv);
  flash_attention<T, DH><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), sq, sk, h, kv, n_qt, qs, ks, vs, causal,
      1.0f / sqrtf((float)DH));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int dh, const void* q, const void* k, const void* v, void* out, int b,
                     int sq, int sk, int h, int kv, Strides qs, Strides ks, Strides vs,
                     int causal, cudaStream_t st) {
  switch (dh) {
    case 16: return launch<T, 16>(q, k, v, out, b, sq, sk, h, kv, qs, ks, vs, causal, st);
    case 32: return launch<T, 32>(q, k, v, out, b, sq, sk, h, kv, qs, ks, vs, causal, st);
    case 64: return launch<T, 64>(q, k, v, out, b, sq, sk, h, kv, qs, ks, vs, causal, st);
    case 128: return launch<T, 128>(q, k, v, out, b, sq, sk, h, kv, qs, ks, vs, causal, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (b, sq, h, dh), k / v (b, sk, kv, dh), each addressed through its own
// batch / sequence / head element strides with head_dim contiguous;
// out (b, sq, h, dh) contiguous.  q, k, v and out share one dtype (f32 or
// bf16).  dh in {16, 32, 64, 128}; h % kv == 0; b, sq >= 1.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int b, int sq, int sk, int h, int kv, int dh,
                                      long long q_sb, long long q_ss, long long q_sh,
                                      long long k_sb, long long k_ss, long long k_sh,
                                      long long v_sb, long long v_ss, long long v_sh,
                                      int causal, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  const cudaError_t e =
      is_bf16 ? dispatch<__nv_bfloat16>(dh, q, k, v, out, b, sq, sk, h, kv, qs, ks, vs, causal, st)
              : dispatch<float>(dh, q, k, v, out, b, sq, sk, h, kv, qs, ks, vs, causal, st);
  return (int)e;
}
