// Unified chunked-prefill attention: paged flash attention over a ragged
// q-tile, one launch for any mix of prefill chunks and decode rows.
//
// Replaces the TPU kernel mixed_prefill_attention_pallas (_mixed_kernel,
// src/repro/kernels/chunked_prefill/kernel.py).  Row r of the batch is
// described by desc[r] = (slot, q_start, q_len, kv_len): query lane j
// sees key position kpos iff kpos <= q_start + j and kpos < kv_len, and
// lanes j >= q_len output an exact 0.  K/V are read from the shared
// block pool through block_tables[slot].
//
// What bounds it on an H100: bytes.  Each (row, kv head) reads its
// q tile, the K/V of the positions its lanes can see, and writes the
// output; at the serving shapes (head_dim 128, 8 KV heads, bf16) the
// work per byte is far below the ~295 FLOP/byte where the tensor cores
// would become the limit.
//
// Design.
//   * Grid (R, KV, ceil(W*G / 64)).  The TPU kernel holds all W*G lanes
//     x group heads of a (row, kv head) in one VMEM block; at W*G = 512
//     and head_dim 128 that is 256 KiB of q alone, beyond the 227 KB of
//     shared memory a Hopper block may have.  So the lane axis is tiled:
//     a block takes 64 flattened rows i = lane * G + group.
//   * The block reads desc and the block table itself (Hopper has no
//     scalar prefetch) and walks key positions only up to what its live
//     lanes can see, min(kv_len, q_start + last live lane + 1), in
//     chunks of 32 positions staged in shared memory as f32; a tile
//     whose lanes are all dead reads no K/V at all.
//   * 4 threads per query row: each scores 8 of the 32 keys of a chunk
//     (one fmaf chain over head_dim in order), the row's max and sum are
//     combined by a fixed butterfly of warp shuffles, and each thread
//     owns head_dim / 4 interleaved output columns.  Online softmax in
//     f32.
//   * Masking is by select, never by multiplying with 0: a masked score
//     becomes NEG_INF and a masked probability is set to 0 after the
//     exp, so poisoned or uninitialised pool entries (the trash block)
//     cannot reach a live lane.  A dead lane keeps l = 0 and acc = 0, so
//     acc / max(l, 1e-30) is an exact 0.
#include "common.cuh"

namespace {

using repro::NEG_INF;
using repro::from_f;
using repro::to_f;

constexpr int kThreads = 256;
constexpr int TQ = 64;  // flattened (lane, group) rows per block
constexpr int KC = 32;  // key positions per chunk

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)TQ * (DH + 1) + 2 * KC * (DH + 1) + TQ * (KC + 1));
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
mixed_prefill(const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
              const int* __restrict__ tables, const int* __restrict__ desc, T* __restrict__ out,
              int w, int h, int kv, int bs, int n_t, float scale) {
  constexpr int LD = DH + 1;  // padded rows: no shared-memory bank conflicts
  constexpr int PLD = KC + 1;
  constexpr int NC = DH / 4;  // output columns per thread
  extern __shared__ float sm[];
  float* q_s = sm;              // [TQ][LD]
  float* k_s = q_s + TQ * LD;   // [KC][LD]
  float* v_s = k_s + KC * LD;   // [KC][LD]
  float* p_s = v_s + KC * LD;   // [TQ][PLD]

  const int r = blockIdx.x, kvh = blockIdx.y;
  const int g = h / kv;
  const int rows_total = w * g;
  const int i0 = blockIdx.z * TQ;
  const int slot = desc[r * 4 + 0], q_start = desc[r * 4 + 1];
  const int q_len = desc[r * 4 + 2], kv_len = desc[r * 4 + 3];
  const int tid = threadIdx.x, row = tid >> 2, part = tid & 3;

  // key positions any live lane of this tile can see
  const int first_lane = i0 / g;
  const int last_lane = min((min(rows_total, i0 + TQ) - 1) / g, q_len - 1);
  // (never past the n_t * bs positions the block table addresses)
  const int n_kv =
      first_lane < q_len ? max(0, min(min(kv_len, n_t * bs), q_start + last_lane + 1)) : 0;

  for (int e = tid; e < TQ * DH; e += kThreads) {
    const int rr = e / DH, col = e - rr * DH, i = i0 + rr;
    float x = 0.f;
    if (i < rows_total) {
      const int lane = i / g, gg = i - lane * g;
      x = to_f(q[(((size_t)r * w + lane) * h + kvh * g + gg) * DH + col]);
    }
    q_s[rr * LD + col] = x;
  }

  const int i = i0 + row;
  const int my_lane = i / g;
  const bool live = i < rows_total && my_lane < q_len;
  const int qpos = q_start + my_lane;
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
        const int blk = tables[(size_t)slot * n_t + pos / bs];
        const size_t a = (((size_t)blk * bs + pos % bs) * kv + kvh) * DH + col;
        kx = to_f(kp[a]);
        vx = to_f(vp[a]);
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
      const bool valid = live && pos < n_kv && pos <= qpos && pos < kv_len;
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
      const bool valid = live && pos < n_kv && pos <= qpos && pos < kv_len;
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

  if (i < rows_total) {
    const int gg = i - my_lane * g;
    T* o = out + (((size_t)r * w + my_lane) * h + kvh * g + gg) * DH;
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) o[c * 4 + part] = from_f<T>(acc[c] / denom);
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* kp, const void* vp, const int* tables,
                   const int* desc, void* out, int r, int w, int h, int kv, int bs, int n_t,
                   cudaStream_t st) {
  const size_t smem = smem_bytes<DH>();
  cudaError_t e = repro::allow_smem(mixed_prefill<T, DH>, smem);
  if (e != cudaSuccess) return e;
  const int g = h / kv;
  dim3 grid(r, kv, (w * g + TQ - 1) / TQ);
  mixed_prefill<T, DH><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp), tables,
      desc, static_cast<T*>(out), w, h, kv, bs, n_t, 1.0f / sqrtf((float)DH));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int dh, const void* q, const void* kp, const void* vp, const int* tables,
                     const int* desc, void* out, int r, int w, int h, int kv, int bs, int n_t,
                     cudaStream_t st) {
  switch (dh) {
    case 16: return launch<T, 16>(q, kp, vp, tables, desc, out, r, w, h, kv, bs, n_t, st);
    case 32: return launch<T, 32>(q, kp, vp, tables, desc, out, r, w, h, kv, bs, n_t, st);
    case 64: return launch<T, 64>(q, kp, vp, tables, desc, out, r, w, h, kv, bs, n_t, st);
    case 128: return launch<T, 128>(q, kp, vp, tables, desc, out, r, w, h, kv, bs, n_t, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (r, w, h, dh); k_pool / v_pool (n_pool, bs, kv, dh); tables (B, n_t)
// int32; desc (r, 4) int32; out (r, w, h, dh).  q, pools and out share
// one dtype (f32 or bf16).  dh in {16, 32, 64, 128}.
extern "C" int mixed_prefill_launch(const void* q, const void* kp, const void* vp,
                                    const void* tables, const void* desc, void* out, int r,
                                    int w, int h, int kv, int dh, int bs, int n_t, int is_bf16,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(tables);
  const int* ds = static_cast<const int*>(desc);
  const cudaError_t e =
      is_bf16 ? dispatch<__nv_bfloat16>(dh, q, kp, vp, tb, ds, out, r, w, h, kv, bs, n_t, st)
              : dispatch<float>(dh, q, kp, vp, tb, ds, out, r, w, h, kv, bs, n_t, st);
  return (int)e;
}
