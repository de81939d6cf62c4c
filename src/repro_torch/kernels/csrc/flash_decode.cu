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
// FLOP per byte, two orders of magnitude below the tensor-core ridge,
// and at the serving shapes (a few hundred KB a step) the latency of the
// round trips rather than the bandwidth.
//
// Design: paged_decode.cu's, from the body both share in
// decode_split.cuh.  The TPU grid's sequential S axis becomes 64-position
// splits, grid (B, KV, ceil(S / 64)) (320 blocks at the serving shape),
// each issuing all its K/V rows as 16-byte cp.async copies at once; every
// warp scores; a second launch merges the splits' f32 (o, m, l) into the
// normalised output or, for the partials form, into the merged (o, m, l).
// What differs from the paged kernel:
//   * K and V are read in place through their batch / sequence / head
//     strides (decode::StridedKV); the TPU wrapper transposes them to
//     (B, KV, S, dh) copies first.  The wrapper copies a view whose
//     pointer or strides are not 16-byte multiples.
//   * Splits stop at the row's length: the TPU kernel streams all S
//     positions and masks the tail.  Any S is taken (the TPU wrapper
//     asserts S % bs == 0); lengths above S clamp to S.
//   * A row with lengths[b] <= 0 reproduces the TPU kernel: every one of
//     its S logits is NEG_INF, each weighs exp(0) = 1, so m = NEG_INF,
//     l = S, o = sum(V), and the normalised output is mean(V).  With
//     empty_zero it follows the paged kernel's rule instead: no split is
//     live, so m = NEG_INF, l = 0, o = 0 exactly (and the normalised
//     output 0).  That is what a cache shard holding none of a row's
//     positions must contribute to a cross-shard combine
//     (serving/dist_decode.py): exact zeros that leave the other shards'
//     partials unchanged.
#include "decode_split.cuh"

namespace {

namespace dec = repro::decode;

template <typename T>
cudaError_t dispatch(int dh, const void* q, const void* kc, const void* vc, const int* lengths,
                     void* out, float* o, float* m, float* l, float* o_part, float* m_part,
                     float* l_part, int b, int h, int kv, int s, int n_split, repro::Strides ks,
                     repro::Strides vs, int empty_zero, cudaStream_t st) {
  const dec::StridedKV src{ks, vs, s};
  return repro::with_head_dim(dh, [&](auto d) {
    constexpr int DH = decltype(d)::value;
    return empty_zero ? dec::launch_split<T, DH, false>(q, kc, vc, src, lengths, out, o, m, l, o_part, m_part,
                                                       l_part, b, h, kv, n_split, st)
                      : dec::launch_split<T, DH, true>(q, kc, vc, src, lengths, out, o, m, l, o_part, m_part,
                                                      l_part, b, h, kv, n_split, st);
  });
}

}  // namespace

// q (b, h, dh) contiguous; k_cache / v_cache (b, s, kv, dh) with element
// strides (batch, seq, head), head_dim contiguous, the pointers and every
// stride 16-byte multiples; lengths (b,) int32.  partials == 0: out
// (b, h, dh) in q's dtype.  partials == 1: o (b, kv, h / kv, dh), m and l
// (b, kv, h / kv, 1), all f32, and out unused.  Scratch o_part (b, kv,
// n_split, h / kv, dh), m_part / l_part (b, kv, n_split, h / kv) f32 with
// n_split = ceil(s / 64).  q and the caches share one dtype (f32 or
// bf16).  dh in {16, 32, 64, 128}, h / kv <= 16, s >= 1.  empty_zero: a
// row with lengths[b] <= 0 gives exact zeros (m = NEG_INF, l = 0, o = 0)
// instead of the mean rule.
extern "C" int flash_decode_launch(const void* q, const void* kc, const void* vc,
                                   const void* lengths, void* out, void* o, void* m, void* l,
                                   void* o_part, void* m_part, void* l_part, int b, int h, int kv,
                                   int dh, int s, int n_split, long long ks_b, long long ks_s,
                                   long long ks_h, long long vs_b, long long vs_s, long long vs_h,
                                   int partials, int empty_zero, int is_bf16, void* stream) {
  if (kv <= 0 || h % kv || h / kv > dec::GMAX || s < 1 || n_split != (s + dec::PS - 1) / dec::PS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ln = static_cast<const int*>(lengths);
  const repro::Strides ks{ks_b, ks_s, ks_h}, vs{vs_b, vs_s, vs_h};
  float* o_p = partials ? static_cast<float*>(o) : nullptr;
  float* m_p = partials ? static_cast<float*>(m) : nullptr;
  float* l_p = partials ? static_cast<float*>(l) : nullptr;
  float* op = static_cast<float*>(o_part);
  float* mp = static_cast<float*>(m_part);
  float* lp = static_cast<float*>(l_part);
  const cudaError_t e =
      is_bf16 ? dispatch<__nv_bfloat16>(dh, q, kc, vc, ln, out, o_p, m_p, l_p, op, mp, lp, b, h, kv, s, n_split, ks, vs,
                                        empty_zero, st)
              : dispatch<float>(dh, q, kc, vc, ln, out, o_p, m_p, l_p, op, mp, lp, b, h, kv, s, n_split, ks, vs,
                                empty_zero, st);
  return (int)e;
}
