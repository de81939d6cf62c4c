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
// head_dim 128, G = 2).
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
// bf16 (the path): one warpgroup of 128 threads on the tensor cores.
//   * Blocks are numbered row tile first, the last row tile first: under
//     a causal mask the last tiles see the most keys (1 to 4 key tiles at
//     the admit shape, about two waves of blocks), so the longest start
//     first and the shortest fill the tail.
//   * Loads are 16-byte cp.async copies issued by every thread into
//     swizzled shared-memory tiles (sm90.cuh), not TMA: the 64 rows of a
//     Q tile are (position, group) pairs read through three strides, and
//     the caller's views are strided, which a tensor map per call would
//     have to describe anew on the host at every launch.  Q is loaded
//     once; K tiles of 64 keys go through a ring of 2 stages, the next
//     tile's copies in flight while the current one is computed.  V
//     tiles do too at head_dim <= 64; at 128 V has one buffer, refilled
//     as soon as P V is done and landing while the next S and softmax
//     run, so that 3 blocks (65 KB of shared memory each) fit on an SM
//     instead of 2.  Rows and keys past the ends are zero-filled by the
//     copy itself.
//   * S = Q K^T: wgmma m64n64k16, both operands K-major in shared memory,
//     head_dim / 16 steps, f32 accumulators.  The online softmax runs on
//     the accumulator fragments in registers (a row lives in the 4 lanes
//     of a quad), with m and l in f32.
//   * O += P V: wgmma m64n{head_dim}k16 with P as the register A operand
//     (the S fragment is already its layout) and V read MN-major from
//     shared memory through the transpose flag.  The reference keeps P in
//     f32 (it casts v to f32), so P goes in as two bf16 operands,
//     P = P_hi + P_lo, which carries 16 of its 24 bits: twice the P V
//     products, still far under the bound at these shapes.
//
// f32 (the smoke-width checks and the tests): the first version's design
// on the CUDA cores, 4 threads per row, each scoring 8 of the 32 keys of
// a chunk with one fmaf chain over head_dim.
#include "common.cuh"
#include "sm90.cuh"

namespace {

using repro::NEG_INF;
using repro::from_f;
using repro::to_f;

constexpr int TQ = 64;  // flattened (query position, group head) rows per block

// element strides of a (B, S, heads, head_dim) tensor; head_dim's is 1
struct Strides {
  long long b, s, h;
};

// ------------------------------------------------------------------ //
// bf16: wgmma
// ------------------------------------------------------------------ //

constexpr int kWgThreads = 128;  // one warpgroup
constexpr int TK = 64;           // keys per tile
constexpr int kStages = 2;       // K ring

template <int DH>
struct Tile {
  static constexpr int W = DH * 2 < 128 ? DH * 2 : 128;  // swizzle width = row bytes of an atom
  static constexpr int CHUNKS = DH / 8;                  // 16-byte chunks of a head_dim row
  static constexpr int BYTES = 64 * DH * 2;              // a 64-row bf16 tile
  // V's buffers: at head_dim 128 one, so that three blocks fit on an SM
  // (two V stages would leave room for two), else a ring like K's
  static constexpr int V_STAGES = DH == 128 ? 1 : kStages;
  // 1024 bytes of slack to align the tiles; Q, the K stages, the V stages
  static constexpr size_t SMEM = 1024 + (size_t)BYTES * (1 + kStages + V_STAGES);

  // byte offset of (row, 16-byte chunk) in a 64-row tile: 128-byte column
  // blocks of 64 rows, each swizzled
  static __device__ __forceinline__ uint32_t off(int row, int chunk) {
    const int cb = chunk * 16;
    return repro::swizzle<W>((uint32_t)((cb / W) * (64 * W) + row * W + cb % W));
  }
  // K-major operand (Q as A, K as B): the k16 step ks of head_dim
  static __device__ __forceinline__ uint64_t kmajor(uint32_t base, int ks) {
    const int cb = ks * 32;
    return repro::wgmma_desc<W>(base + (cb / W) * (64 * W) + cb % W, 16, 8 * W);
  }
  // MN-major operand (V as B): the k16 step ks of the 64 keys
  static __device__ __forceinline__ uint64_t mnmajor(uint32_t base, int ks) {
    return repro::wgmma_desc<W>(base + ks * 16 * W, 64 * W, 8 * W);
  }
};

template <int DH>
__global__ void __launch_bounds__(kWgThreads)
flash_attention_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int bsz,
                     int sq, int sk, int h, int kv, int n_qt, Strides qs, Strides ks, Strides vs,
                     int causal, float scale_log2) {
  using TL = Tile<DH>;
  constexpr int NO = DH / 2;  // output accumulator registers per thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = repro::smem_addr(smem_raw);
  const uint32_t q_base = (raw + 1023) & ~1023u;
  const uint32_t k_base = q_base + TL::BYTES;  // stage st at + st * BYTES
  const uint32_t v_base = k_base + kStages * TL::BYTES;

  // row tiles in descending order, so that under a causal mask the blocks
  // with the most key tiles start first and the lightest fill the tail
  const int qt = n_qt - 1 - blockIdx.x / (bsz * kv), rest = blockIdx.x % (bsz * kv);
  const int b = rest / kv, kvh = rest - b * kv;
  const int g = h / kv;
  const int rows_total = sq * g;
  const int i0 = qt * TQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, quad = lane & 3;

  const int last_q = (min(rows_total, i0 + TQ) - 1) / g;
  const int n_kv = causal ? min(sk, last_q + 1) : sk;
  const int n_tiles = (n_kv + TK - 1) / TK;

  const __nv_bfloat16* qb = q + (size_t)b * qs.b + (size_t)kvh * g * qs.h;
  const __nv_bfloat16* kb = k + (size_t)b * ks.b + (size_t)kvh * ks.h;
  const __nv_bfloat16* vb = v + (size_t)b * vs.b + (size_t)kvh * vs.h;

  // Q: 64 rows x CHUNKS, zero past the last row
  for (int e = tid; e < TQ * TL::CHUNKS; e += kWgThreads) {
    const int r = e / TL::CHUNKS, c = e - r * TL::CHUNKS, i = i0 + r;
    const bool ok = i < rows_total;
    const int qp = ok ? i / g : 0, gg = ok ? i - qp * g : 0;
    repro::cp_async16(q_base + TL::off(r, c), qb + (size_t)qp * qs.s + (size_t)gg * qs.h + c * 8, ok);
  }
  // one 64-key tile of K (into its stage) or V (into the V buffer)
  auto load_tile = [&](const __nv_bfloat16* src, long long stride, uint32_t dst, int t) {
    for (int e = tid; e < TK * TL::CHUNKS; e += kWgThreads) {
      const int r = e / TL::CHUNKS, c = e - r * TL::CHUNKS, pos = t * TK + r;
      const bool ok = pos < n_kv;
      repro::cp_async16(dst + TL::off(r, c), src + (size_t)(ok ? pos : 0) * stride + c * 8, ok);
    }
  };
  // copy groups, oldest first: {Q, K0}, {V0}, then for each tile t
  // {K(t+1), V(t+1)} with a V ring, or {K(t+1)} and, once P V(t) is done,
  // {V(t+1)} with one V buffer
  constexpr bool v_ring = TL::V_STAGES > 1;
  auto v_at = [&](int t) { return v_base + (uint32_t)(t % TL::V_STAGES) * TL::BYTES; };
  if (n_tiles > 0) load_tile(kb, ks.s, k_base, 0);
  repro::cp_async_commit();
  if (n_tiles > 0) load_tile(vb, vs.s, v_base, 0);
  repro::cp_async_commit();

  // this thread's two rows of the tile (r = 0, 1) and their query positions
  const int row0 = warp * 16 + (lane >> 2);
  int qpos[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) qpos[r] = (i0 + row0 + 8 * r) / g;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[NO];
#pragma unroll
  for (int x = 0; x < NO; ++x) o[x] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    // K(t + 1) into the stage that S(t - 1) read (and V(t + 1) likewise)
    if (t + 1 < n_tiles) {
      load_tile(kb, ks.s, k_base + (uint32_t)((t + 1) % kStages) * TL::BYTES, t + 1);
      if (v_ring) load_tile(vb, vs.s, v_at(t + 1), t + 1);
    }
    repro::cp_async_commit();
    // K(t) and Q have landed, and with a V ring V(t) too
    if (v_ring)
      repro::cp_async_wait<1>();
    else
      repro::cp_async_wait<2>();
    repro::fence_async_shared();
    __syncthreads();
    const uint32_t so = (uint32_t)(t % kStages) * TL::BYTES;

    float s[32];
#pragma unroll
    for (int x = 0; x < 32; ++x) s[x] = 0.f;
    repro::fence_regs(s);
    repro::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      repro::wgmma_ss_n64(s, TL::kmajor(q_base, kk), TL::kmajor(k_base + so, kk));
    repro::wgmma_commit();
    repro::wgmma_wait<0>();
    repro::fence_regs(s);

    // online softmax on the fragments, scores in log2 units
    const int c0 = t * TK;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int r = (x >> 1) & 1, pos = c0 + (x >> 2) * 8 + quad * 2 + (x & 1);
      const bool ok = pos < n_kv && (!causal || pos <= qpos[r]);
      s[x] = ok ? s[x] * scale_log2 : NEG_INF;
      mx[r] = fmaxf(mx[r], s[x]);
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = repro::group_max<4>(mx[r]);
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int r = (x >> 1) & 1;
      s[x] = s[x] == NEG_INF ? 0.f : exp2f(s[x] - m[r]);
      sum[r] += s[x];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + repro::group_sum<4>(sum[r]);
#pragma unroll
    for (int x = 0; x < NO; ++x) o[x] *= alpha[(x >> 1) & 1];

    // P = P_hi + P_lo as the register A operand, k16 step kk = keys 16kk..16kk+15
    uint32_t p_hi[4][4], p_lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float x0 = s[8 * kk + 2 * a], x1 = s[8 * kk + 2 * a + 1];
        const float h0 = __bfloat162float(__float2bfloat16_rn(x0));
        const float h1 = __bfloat162float(__float2bfloat16_rn(x1));
        p_hi[kk][a] = repro::pack_bf16(h0, h1);  // exact: h0, h1 are bf16 values
        p_lo[kk][a] = repro::pack_bf16(x0 - h0, x1 - h1);
      }
    if (!v_ring) {
      repro::cp_async_wait<1>();  // V(t) has landed
      repro::fence_async_shared();
      __syncthreads();
    }
    repro::fence_regs(o);
    repro::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv = TL::mnmajor(v_at(t), kk);
      repro::wgmma_rs(o, p_hi[kk], dv);
      repro::wgmma_rs(o, p_lo[kk], dv);
    }
    repro::wgmma_commit();
    repro::wgmma_wait<0>();
    repro::fence_regs(o);
    __syncthreads();  // every warp is done with K(t), V(t) before K(t + 2), V(t + 1 or 2) overwrite them
    if (!v_ring) {
      if (t + 1 < n_tiles) load_tile(vb, vs.s, v_base, t + 1);
      repro::cp_async_commit();
    }
  }
  repro::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + row0 + 8 * r;
    if (i >= rows_total) continue;
    const int gg = i - qpos[r] * g;
    __nv_bfloat16* orow = out + (((size_t)b * sq + qpos[r]) * h + kvh * g + gg) * DH;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      const int x = 4 * j + 2 * r;
      *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * quad) = repro::pack_bf16(o[x] * inv, o[x + 1] * inv);
    }
  }
}

template <int DH>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* out, int b, int sq,
                        int sk, int h, int kv, Strides qs, Strides ks, Strides vs, int causal,
                        cudaStream_t st) {
  const size_t smem = Tile<DH>::SMEM;
  static size_t allowed = 0;
  cudaError_t e = repro::allow_smem(flash_attention_bf16<DH>, smem, allowed);
  if (e != cudaSuccess) return e;
  const int n_qt = (sq * (h / kv) + TQ - 1) / TQ;
  flash_attention_bf16<DH><<<b * n_qt * kv, kWgThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), b, sq, sk, h, kv, n_qt,
      qs, ks, vs, causal, 1.4426950408889634f / sqrtf((float)DH));
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
                   int h, int kv, Strides qs, Strides ks, Strides vs, int causal,
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
      1.0f / sqrtf((float)DH));
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dh(int is_bf16, const void* q, const void* k, const void* v, void* out, int b,
                      int sq, int sk, int h, int kv, Strides qs, Strides ks, Strides vs,
                      int causal, cudaStream_t st) {
  return is_bf16 ? launch_bf16<DH>(q, k, v, out, b, sq, sk, h, kv, qs, ks, vs, causal, st)
                 : launch<float, DH>(q, k, v, out, b, sq, sk, h, kv, qs, ks, vs, causal, st);
}

}  // namespace

// q (b, sq, h, dh), k / v (b, sk, kv, dh), each addressed through its own
// batch / sequence / head element strides with head_dim contiguous;
// out (b, sq, h, dh) contiguous.  q, k, v and out share one dtype (f32 or
// bf16).  dh in {16, 32, 64, 128}; h % kv == 0; b, sq >= 1.  bf16: every
// pointer 16-byte aligned and every stride a multiple of 8 elements (the
// 16-byte copies).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int b, int sq, int sk, int h, int kv, int dh,
                                      long long q_sb, long long q_ss, long long q_sh,
                                      long long k_sb, long long k_ss, long long k_sh,
                                      long long v_sb, long long v_ss, long long v_sh,
                                      int causal, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  switch (dh) {
    case 16: return (int)launch_dh<16>(is_bf16, q, k, v, out, b, sq, sk, h, kv, qs, ks, vs, causal, st);
    case 32: return (int)launch_dh<32>(is_bf16, q, k, v, out, b, sq, sk, h, kv, qs, ks, vs, causal, st);
    case 64: return (int)launch_dh<64>(is_bf16, q, k, v, out, b, sq, sk, h, kv, qs, ks, vs, causal, st);
    case 128: return (int)launch_dh<128>(is_bf16, q, k, v, out, b, sq, sk, h, kv, qs, ks, vs, causal, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
