// bf16 attention of one 64-row tile on the tensor cores (wgmma): the body
// that flash_attention.cu (dense q, k, v read through their strides) and
// mixed_prefill.cu (K/V through a block table into the paged pool) share.
//
// One warpgroup of 128 threads takes 64 query rows and walks the keys in
// tiles of 64, online softmax in f32:
//   * Loads are 16-byte cp.async copies issued by every thread into
//     swizzled shared-memory tiles (sm90.cuh), not TMA: a tile's rows are
//     gathered (strided (position, group) rows, pool blocks through a
//     table), which a tensor map per call would have to describe anew on
//     the host at every launch.  Q is loaded once; K tiles go through a
//     ring of 2 stages, the next tile's copies in flight while the current
//     one is computed.  V tiles do too at head_dim <= 64; at 128 V has one
//     buffer, refilled as soon as P V is done and landing while the next
//     S and softmax run, so that 3 blocks (65 KB of shared memory each)
//     fit on an SM instead of 2.  Rows and keys past the ends are
//     zero-filled by the copy itself and never read from memory, so what
//     lies there (a NaN would pass through 0 x NaN) never reaches the
//     tensor cores.
//   * S = Q K^T: wgmma m64n64k16, both operands K-major in shared memory,
//     head_dim / 16 steps, f32 accumulators.  The online softmax runs on
//     the accumulator fragments in registers (a row lives in the 4 lanes
//     of a quad), with m and l in f32.  Masking is by select: a key the
//     row may not see scores NEG_INF and its probability is set to 0
//     after the exp, so a row that sees nothing keeps l = 0 and o = 0.
//   * O += P V: wgmma m64n{head_dim}k16 with P as the register A operand
//     (the S fragment is already its layout) and V read MN-major from
//     shared memory through the transpose flag.  The references keep P in
//     f32 (they cast v to f32), so P goes in as two bf16 operands,
//     P = P_hi + P_lo, which carries 16 of its 24 bits: twice the P V
//     products, still far under the bound at the path's shapes.
//
// What a caller supplies (`Src`), for rows 0..63 of its tile and key
// positions 0..n_kv-1:
//   const __nv_bfloat16* q_row(int row, bool& ok)  row's head_dim vector;
//                               ok = false: zero-filled, nothing read
//   const __nv_bfloat16* k_row(int pos), v_row(int pos)
//   int row_limit(int row)      the row sees the keys pos < row_limit
//   bool key_ok(int pos)        false masks key pos out of every row and
//                               zero-fills its K/V copies (a key this
//                               shard does not own); read only for
//                               pos < n_kv + 63
//   __nv_bfloat16* out_row(int row)   where the row's output goes, or
//                               nullptr for a row that is not stored
//   static constexpr bool kPartials   true: the tile stores the f32
//                               partials instead, through
//   int part_index(int row)     the row's index in o_part / m_part /
//                               l_part (o_part rows of DH floats), or -1
//                               for a row that is not stored
//   static constexpr bool kWindow     true: a sliding window, through
//   int k_lo                    the lowest key any row of the tile sees:
//                               the key tiles wholly below it are
//                               neither loaded nor computed
//   int row_start(int row)      the row sees the keys pos >= row_start
// With kWindow false none of the three is read, and the walk is the one
// without a window.
#pragma once

#include "common.cuh"
#include "sm90.cuh"

namespace repro {
namespace attn {

constexpr int kWgThreads = 128;  // one warpgroup
constexpr int TQ = 64;           // query rows per tile
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

// The whole tile: loads, the walk over ceil(n_kv / 64) key tiles and the
// bf16 store of o / max(l, 1e-30), or with Src::kPartials the f32
// un-normalised o, m in natural units (m_log2 * ln 2; a row that saw no
// key keeps m = NEG_INF exactly, so that a combine over shards never
// meets -inf - -inf) and l.  smem_raw holds Tile<DH>::SMEM bytes.  Called
// by all 128 threads of the block.
template <int DH, class Src>
__device__ __forceinline__ void attend_tile(const Src& src, uint8_t* smem_raw, int n_kv, float scale_log2) {
  using TL = Tile<DH>;
  constexpr int NO = DH / 2;  // output accumulator registers per thread
  const uint32_t raw = repro::smem_addr(smem_raw);
  const uint32_t q_base = (raw + 1023) & ~1023u;
  const uint32_t k_base = q_base + TL::BYTES;  // stage st at + st * BYTES
  const uint32_t v_base = k_base + kStages * TL::BYTES;
  const int n_tiles = (n_kv + TK - 1) / TK;
  int t0 = 0;  // the first key tile the walk reads
  if constexpr (Src::kWindow) t0 = src.k_lo / TK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, quad = lane & 3;

  // Q: 64 rows x CHUNKS, zero where the caller says so
  for (int e = tid; e < TQ * TL::CHUNKS; e += kWgThreads) {
    const int r = e / TL::CHUNKS, c = e - r * TL::CHUNKS;
    bool ok;
    const __nv_bfloat16* row = src.q_row(r, ok);
    repro::cp_async16(q_base + TL::off(r, c), row + c * 8, ok);
  }
  // one 64-key tile of K (into its stage) or V (into the V buffer)
  auto load_k = [&](uint32_t dst, int t) {
    for (int e = tid; e < TK * TL::CHUNKS; e += kWgThreads) {
      const int r = e / TL::CHUNKS, c = e - r * TL::CHUNKS, pos = t * TK + r;
      const bool ok = pos < n_kv && src.key_ok(pos);
      repro::cp_async16(dst + TL::off(r, c), src.k_row(ok ? pos : 0) + c * 8, ok);
    }
  };
  auto load_v = [&](uint32_t dst, int t) {
    for (int e = tid; e < TK * TL::CHUNKS; e += kWgThreads) {
      const int r = e / TL::CHUNKS, c = e - r * TL::CHUNKS, pos = t * TK + r;
      const bool ok = pos < n_kv && src.key_ok(pos);
      repro::cp_async16(dst + TL::off(r, c), src.v_row(ok ? pos : 0) + c * 8, ok);
    }
  };
  // copy groups, oldest first: {Q, K0}, {V0}, then for each tile t
  // {K(t+1), V(t+1)} with a V ring, or {K(t+1)} and, once P V(t) is done,
  // {V(t+1)} with one V buffer
  constexpr bool v_ring = TL::V_STAGES > 1;
  auto v_at = [&](int t) { return v_base + (uint32_t)(t % TL::V_STAGES) * TL::BYTES; };
  if (n_tiles > t0) load_k(k_base + (uint32_t)(t0 % kStages) * TL::BYTES, t0);
  repro::cp_async_commit();
  if (n_tiles > t0) load_v(v_at(t0), t0);
  repro::cp_async_commit();

  // this thread's two rows of the tile (r = 0, 1) and the keys they see
  const int row0 = warp * 16 + (lane >> 2);
  int lim[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) lim[r] = src.row_limit(row0 + 8 * r);
  int lo[2] = {0, 0};
  if constexpr (Src::kWindow) {
#pragma unroll
    for (int r = 0; r < 2; ++r) lo[r] = src.row_start(row0 + 8 * r);
  }
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[NO];
#pragma unroll
  for (int x = 0; x < NO; ++x) o[x] = 0.f;

  for (int t = t0; t < n_tiles; ++t) {
    // K(t + 1) into the stage that S(t - 1) read (and V(t + 1) likewise)
    if (t + 1 < n_tiles) {
      load_k(k_base + (uint32_t)((t + 1) % kStages) * TL::BYTES, t + 1);
      if (v_ring) load_v(v_at(t + 1), t + 1);
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
      bool seen = pos < lim[r] && src.key_ok(pos);
      if constexpr (Src::kWindow) seen = seen && pos >= lo[r];
      s[x] = seen ? s[x] * scale_log2 : NEG_INF;
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
      if (t + 1 < n_tiles) load_v(v_base, t + 1);
      repro::cp_async_commit();
    }
  }
  repro::cp_async_wait<0>();

  if constexpr (Src::kPartials) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int pi = src.part_index(row0 + 8 * r);
      if (pi < 0) continue;
      float* orow = src.o_part + (size_t)pi * DH;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        const int x = 4 * j + 2 * r;
        *reinterpret_cast<float2*>(orow + 8 * j + 2 * quad) = make_float2(o[x], o[x + 1]);
      }
      if (quad == 0) {
        src.m_part[pi] = m[r] == NEG_INF ? NEG_INF : m[r] * 0.6931471805599453f;
        src.l_part[pi] = l[r];
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      __nv_bfloat16* orow = src.out_row(row0 + 8 * r);
      if (orow == nullptr) continue;
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        const int x = 4 * j + 2 * r;
        *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * quad) = repro::pack_bf16(o[x] * inv, o[x + 1] * inv);
      }
    }
  }
}

}  // namespace attn
}  // namespace repro
