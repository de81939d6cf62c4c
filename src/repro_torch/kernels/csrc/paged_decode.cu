// One-token flash-decode through a block table over a shared KV pool.
//
// Replaces the TPU kernel paged_decode_attention_pallas (_paged_kernel,
// src/repro/kernels/decode_attention/kernel.py): q (B, H, dh) attends the
// first lengths[b] positions of row b, whose K/V live in pool blocks
// block_tables[b, :].
//
// What bounds it on an H100: bytes, about one FLOP per byte, and at the
// serving shapes (a few hundred KB a step) the latency of the round trips
// rather than the bandwidth.  The body is decode_split.cuh's, shared with
// flash_decode.cu: the row's positions split over 64-position blocks
// (grid (B, KV, ceil(n_t * bs / 64))), each reading its table entries
// once into shared memory and then all its K/V rows as 16-byte cp.async
// copies at once, every warp scoring, and a second launch merging the
// splits' f32 partials.  Here the K/V address policy is the table's
// (decode::PagedKV) and a row of length 0 gives an exact 0.  With a
// sliding window (window > 0) the policy is decode::PagedKVWindow: a row
// sees its last `window` positions, and only the splits that hold them
// are launched.
#include "decode_split.cuh"

namespace {

namespace dec = repro::decode;

template <typename T>
cudaError_t dispatch(int dh, const void* q, const void* kp, const void* vp, const int* tables,
                     const int* lengths, void* out, float* o, float* m, float* l, int b, int h,
                     int kv, int bs, int n_t, int n_split, int window, cudaStream_t st) {
  const dec::PagedKV src{tables, bs, n_t, kv};
  return repro::with_head_dim(dh, [&](auto d) {
    if (window > 0)
      return dec::launch_split<T, decltype(d)::value, false>(q, kp, vp, dec::PagedKVWindow{src, window}, lengths,
                                                            out, nullptr, nullptr, nullptr, o, m, l, b, h, kv,
                                                            n_split, st);
    return dec::launch_split<T, decltype(d)::value, false>(q, kp, vp, src, lengths, out, nullptr, nullptr,
                                                          nullptr, o, m, l, b, h, kv, n_split, st);
  });
}

// the splits a row's walk needs: every 64 positions of the table's span,
// or with a window the 64-aligned blocks that `window` positions touch
inline int splits(int n_t, int bs, int window) {
  const int all = (n_t * bs + dec::PS - 1) / dec::PS;
  return window > 0 ? min(all, (window - 1) / dec::PS + 2) : all;
}

}  // namespace

// q (b, h, dh); k_pool / v_pool (n_pool, bs, kv, dh); tables (b, n_t)
// int32; lengths (b,) int32; out (b, h, dh); scratch o_part (b, kv,
// n_split, g, dh), m_part / l_part (b, kv, n_split, g) f32 with n_split =
// ceil(n_t * bs / 64), or with window > 0 the least of that and
// (window - 1) / 64 + 2.  q, pools and out share one dtype (f32 or bf16),
// contiguous, the pools 16-byte aligned.  dh in {16, 32, 64, 128},
// g = h / kv <= 16.  window > 0: row b sees its last `window` positions.
extern "C" int paged_decode_launch(const void* q, const void* kp, const void* vp,
                                   const void* tables, const void* lengths, void* out,
                                   void* o_part, void* m_part, void* l_part, int b, int h,
                                   int kv, int dh, int bs, int n_t, int n_split, int window,
                                   int is_bf16, void* stream) {
  if (window < 0 || n_split != splits(n_t, bs, window) || h / kv > dec::GMAX) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(lengths);
  float* o = static_cast<float*>(o_part);
  float* m = static_cast<float*>(m_part);
  float* l = static_cast<float*>(l_part);
  const cudaError_t e =
      is_bf16 ? dispatch<__nv_bfloat16>(dh, q, kp, vp, tb, ln, out, o, m, l, b, h, kv, bs, n_t, n_split, window, st)
              : dispatch<float>(dh, q, kp, vp, tb, ln, out, o, m, l, b, h, kv, bs, n_t, n_split, window, st);
  return (int)e;
}
