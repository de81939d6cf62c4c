// Dense flash attention: grouped-query attention over contiguous
// (B, S, heads, head_dim) tensors, causal or not, online softmax in f32,
// normalised output.
//
// Replaces the TPU kernel flash_attention_pallas (_kernel,
// src/repro/kernels/flash_attention/kernel.py).  Query position i sees
// key position j iff the call is non-causal or i >= j (the causal mask is
// top-left aligned, as in the reference); the output is
// acc / max(l, 1e-30) in q's dtype.  Its callers, all in bf16: the
// encoders' non-causal attention (cross encoder: 256 pairs x 64 tokens;
// dual encoder: a provider's chunks x 40 tokens; head_dim 64, G = 1) and
// the contiguous engine's causal admit prefill (qwen3-0.6b: 16 / 8 heads,
// head_dim 128, G = 2); in training, the same shapes' causal forward
// (and its recompute under remat), and HuBERT's non-causal head_dim 80,
// which the wrapper pads with zero columns to 128 and scales by 1/sqrt(80)
// (scale_dh).  The backward is not a kernel: the wrapper's autograd
// Function recomputes the plain version, as the reference differentiates
// its XLA attention.
//
// What bounds it on an H100: at these shapes the bytes (q, k, v read
// once, the output written once) and the FLOPs (4 * head_dim per visible
// (query, key) pair and head) are both small, and the work per byte
// (about 16-64 FLOP/byte) is below the ~295 FLOP/byte where the bf16
// tensor cores become the limit: bytes bound it, provided the products
// run on the tensor cores and the loads are in flight while they do.
//
// In both versions a block takes one (batch, KV head) and 64 flattened
// rows i = q_position * G + group (grid B * ceil(Sq * G / 64) x KV),
// so the G query heads that share a KV head share every K/V tile staged
// in shared memory (the TPU kernel re-reads K/V per query head through
// its index map); the sequential KV axis of the TPU grid becomes a loop
// inside the block.  q, k and v are read in place through their batch /
// sequence / head strides (head_dim contiguous), the output is written
// (B, Sq, H, dh) contiguous.  Causal: the block walks keys only up to the
// last query position of its tile, so tiles wholly above the diagonal
// are never read (the TPU kernel's pl.when skip).  Ragged tails are
// masked: rows past Sq are not written, keys past Sk are never scored.
// Masking is by select: a masked score is NEG_INF and its probability is
// set to 0 after the exp.
//
// bf16 (the path): one warpgroup of 128 threads on the tensor cores, the
// tile body in attn_tile.cuh (shared with mixed_prefill.cu): 16-byte
// cp.async copies into swizzled tiles, a 2-stage K ring (and V ring below
// head_dim 128), S = Q K^T and O += (P_hi + P_lo) V on wgmma, the online
// softmax on the accumulator fragments.  This file gives it the rows
// (DenseSrc: (position, group) rows read through q's strides, keys
// through k's and v's, the causal limit qpos + 1) and numbers the blocks
// row tile first, the last row tile first: under a causal mask the last
// tiles see the most keys (1 to 4 key tiles at the admit shape, about
// two waves of blocks), so the longest start first and the shortest fill
// the tail.
//
// f32 (the smoke-width checks and the tests): the first version's design
// on the CUDA cores, 4 threads per row, each scoring 8 of the 32 keys of
// a chunk with one fmaf chain over head_dim.
#include "attn_tile.cuh"

namespace {

using repro::NEG_INF;
using repro::Strides;
using repro::from_f;
using repro::to_f;

constexpr int TQ = 64;  // flattened (query position, group head) rows per block

// ------------------------------------------------------------------ //
// bf16: wgmma, attn_tile.cuh
// ------------------------------------------------------------------ //

using repro::attn::kWgThreads;

// rows i0 + row = query position * g + group of (batch b, KV head kvh),
// read through q's strides; keys through k's and v's
template <int DH>
struct DenseSrc {
  const __nv_bfloat16 *qb, *kb, *vb;
  __nv_bfloat16* out;  // at (b, 0, kvh * g) of the (B, Sq, H, dh) output
  Strides qs, ks, vs;
  int i0, g, h, rows_total, n_kv, causal;

  __device__ __forceinline__ const __nv_bfloat16* q_row(int row, bool& ok) const {
    const int i = i0 + row;
    ok = i < rows_total;
    const int qp = ok ? i / g : 0, gg = ok ? i - qp * g : 0;
    return qb + (size_t)qp * qs.s + (size_t)gg * qs.h;
  }
  __device__ __forceinline__ const __nv_bfloat16* k_row(int pos) const { return kb + (size_t)pos * ks.s; }
  __device__ __forceinline__ const __nv_bfloat16* v_row(int pos) const { return vb + (size_t)pos * vs.s; }
  static constexpr bool kPartials = false;
  static constexpr bool kWindow = false;
  __device__ __forceinline__ int row_limit(int row) const {
    return causal ? min(n_kv, (i0 + row) / g + 1) : n_kv;
  }
  __device__ __forceinline__ bool key_ok(int) const { return true; }
  __device__ __forceinline__ __nv_bfloat16* out_row(int row) const {
    const int i = i0 + row;
    if (i >= rows_total) return nullptr;
    const int qp = i / g, gg = i - qp * g;
    return out + ((size_t)qp * h + gg) * DH;
  }
};

template <int DH>
__global__ void __launch_bounds__(kWgThreads)
flash_attention_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int bsz,
                     int sq, int sk, int h, int kv, int n_qt, Strides qs, Strides ks, Strides vs,
                     int causal, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  // row tiles in descending order, so that under a causal mask the blocks
  // with the most key tiles start first and the lightest fill the tail
  const int qt = n_qt - 1 - blockIdx.x / (bsz * kv), rest = blockIdx.x % (bsz * kv);
  const int b = rest / kv, kvh = rest - b * kv;
  const int g = h / kv;
  const int rows_total = sq * g;
  const int i0 = qt * TQ;
  const int last_q = (min(rows_total, i0 + TQ) - 1) / g;
  const int n_kv = causal ? min(sk, last_q + 1) : sk;
  const DenseSrc<DH> src{q + (size_t)b * qs.b + (size_t)kvh * g * qs.h,
                         k + (size_t)b * ks.b + (size_t)kvh * ks.h,
                         v + (size_t)b * vs.b + (size_t)kvh * vs.h,
                         out + ((size_t)b * sq * h + (size_t)kvh * g) * DH,
                         qs, ks, vs, i0, g, h, rows_total, n_kv, causal};
  repro::attn::attend_tile<DH>(src, smem_raw, n_kv, scale_log2);
}

template <int DH>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* out, int b, int sq,
                        int sk, int h, int kv, Strides qs, Strides ks, Strides vs, int causal,
                        int scale_dh, cudaStream_t st) {
  const size_t smem = repro::attn::Tile<DH>::SMEM;
  static size_t allowed = 0;
  cudaError_t e = repro::allow_smem(flash_attention_bf16<DH>, smem, allowed);
  if (e != cudaSuccess) return e;
  const int n_qt = (sq * (h / kv) + TQ - 1) / TQ;
  flash_attention_bf16<DH><<<b * n_qt * kv, kWgThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), b, sq, sk, h, kv, n_qt,
      qs, ks, vs, causal, 1.4426950408889634f / sqrtf((float)scale_dh));
  return cudaGetLastError();
}

// ------------------------------------------------------------------ //
// f32: CUDA cores
// ------------------------------------------------------------------ //

constexpr int kThreads = 256;
constexpr int KC = 32;  // key positions per chunk

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)TQ * (DH + 1) + 2 * KC * (DH + 1) + TQ * (KC + 1));
}

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
                   int h, int kv, Strides qs, Strides ks, Strides vs, int causal, int scale_dh,
                   cudaStream_t st) {
  const size_t smem = smem_bytes<DH>();
  static size_t allowed = 0;
  cudaError_t e = repro::allow_smem(flash_attention<T, DH>, smem, allowed);
  if (e != cudaSuccess) return e;
  const int n_qt = (sq * (h / kv) + TQ - 1) / TQ;
  dim3 grid(b * n_qt, kv);
  flash_attention<T, DH><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), sq, sk, h, kv, n_qt, qs, ks, vs, causal,
      1.0f / sqrtf((float)scale_dh));
  return cudaGetLastError();
}

}  // namespace

// q (b, sq, h, dh), k / v (b, sk, kv, dh), each addressed through its own
// batch / sequence / head element strides with head_dim contiguous;
// out (b, sq, h, dh) contiguous.  q, k, v and out share one dtype (f32 or
// bf16).  dh in {16, 32, 64, 128}; h % kv == 0; b, sq >= 1.  bf16: every
// pointer 16-byte aligned and every stride a multiple of 8 elements (the
// 16-byte copies).  The softmax scale is 1 / sqrt(scale_dh): scale_dh is dh
// itself, or the true head_dim of inputs the wrapper padded with zero
// columns up to dh (HuBERT's 80 runs as 128).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int b, int sq, int sk, int h, int kv, int dh, int scale_dh,
                                      long long q_sb, long long q_ss, long long q_sh,
                                      long long k_sb, long long k_ss, long long k_sh,
                                      long long v_sb, long long v_ss, long long v_sh,
                                      int causal, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  return (int)repro::with_head_dim(dh, [&](auto d) {
    constexpr int DH = decltype(d)::value;
    return is_bf16 ? launch_bf16<DH>(q, k, v, out, b, sq, sk, h, kv, qs, ks, vs, causal, scale_dh, st)
                   : launch<float, DH>(q, k, v, out, b, sq, sk, h, kv, qs, ks, vs, causal, scale_dh, st);
  });
}
