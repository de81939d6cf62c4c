// Blocked maximum-inner-product top-k: the retrieval hot spot of every
// data provider.
//
// Replaces the TPU kernel retrieval_topk_pallas (_kernel,
// src/repro/kernels/retrieval_topk/kernel.py), which scores a (BQ, BN)
// tile on the MXU and carries a running (BQ, k) top-k across the
// sequential N axis of its grid.
//
// What bounds it on an H100: bytes.  Every corpus row (N x D, f32 or
// bf16) is read once; at the provider shape N = 1,048,576, D = 256 f32
// that is 1.07 GB, 0.32 ms at 3.35 TB/s, against 17 GFLOP of f32 FMA
// (0.26 ms at 67 TFLOP/s off the tensor cores).
//
// Design.  Blocks run in no order on Hopper, so nothing can carry a
// running top-k across the N axis.  Instead:
//   1. topk_partial: grid (splits, ceil(Q / QB)).  Each block stages its
//      QB queries in shared memory as f32 and walks its own contiguous
//      range of corpus rows, one row per thread, 256 rows at a time.  A
//      thread streams its row once from device memory and accumulates
//      all QB scores in registers (query reads are warp broadcasts), so
//      each corpus byte is read once per query block.  Every score is
//      one thread's fmaf chain over d = 0 .. D-1 in order, so a query's
//      scores do not depend on the batch it rides in.  The 256 x QB
//      scores go to shared memory; warp w keeps the sorted top-k lists
//      of queries w, w + 8, ... in shared memory and inserts only the
//      candidates that beat the current k-th score (a warp ballot
//      filters them, in index order).  Rows past N are never candidates.
//      Output: (Q, splits, k) partial lists.
//   2. topk_merge: one block per query selects the k best of its
//      splits * k partials, k rounds of a block-wide argmax, each round
//      taking the best entry strictly after the previous pick.
// Order everywhere is (score descending, index ascending): ties go to
// the smaller corpus index, as in lax.top_k and the TPU kernel.
#include <climits>

#include "common.cuh"

namespace {

using repro::load4;
using repro::to_f;

constexpr int kThreads = 256;  // corpus rows per chunk, one per thread
constexpr int kMaxK = 32;

__device__ __forceinline__ bool better(float s, int i, float t, int j) {
  return s > t || (s == t && i < j);
}

// insert (v, i) into the sorted length-k list; the displaced tail shifts
// down one place and the last entry falls off
__device__ void insert(float* s, int* idx, int k, float v, int i) {
  bool moved = false;
  for (int t = 0; t < k; ++t) {
    if (moved || better(v, i, s[t], idx[t])) {
      const float ts = s[t];
      const int ti = idx[t];
      s[t] = v;
      idx[t] = i;
      v = ts;
      i = ti;
      moved = true;
    }
  }
}

template <typename T, int QB>
__global__ void __launch_bounds__(kThreads)
topk_partial(const T* __restrict__ q, const T* __restrict__ c, float* __restrict__ part_s,
             int* __restrict__ part_i, int nq, int n, int d, int k, int splits,
             int rows_per_split) {
  extern __shared__ float smem[];
  float* q_s = smem;                 // [QB][d]
  float* sc = q_s + QB * d;          // [QB][kThreads] scores of the chunk
  float* ls = sc + QB * kThreads;    // [QB][kMaxK] running top-k scores
  int* li = reinterpret_cast<int*>(ls + QB * kMaxK);  // [QB][kMaxK] indices

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x;
  const int q0 = blockIdx.y * QB;
  const int nql = min(QB, nq - q0);

  for (int e = tid; e < QB * d; e += kThreads) {
    const int r = e / d;
    q_s[e] = r < nql ? to_f(q[(size_t)q0 * d + e]) : 0.f;
  }
  for (int e = tid; e < QB * kMaxK; e += kThreads) {
    ls[e] = -INFINITY;
    li[e] = INT_MAX;
  }
  __syncthreads();

  const int row_begin = split * rows_per_split;
  const int row_end = min(n, row_begin + rows_per_split);
  for (int base = row_begin; base < row_end; base += kThreads) {
    const int row = base + tid;
    float acc[QB];
#pragma unroll
    for (int j = 0; j < QB; ++j) acc[j] = 0.f;
    if (row < row_end) {
      const T* crow = c + (size_t)row * d;
      for (int col = 0; col < d; col += 4) {
        const float4 cv = load4(crow + col);
#pragma unroll
        for (int j = 0; j < QB; ++j) {
          const float4 qv = *reinterpret_cast<const float4*>(q_s + j * d + col);
          float a = acc[j];
          a = fmaf(cv.x, qv.x, a);
          a = fmaf(cv.y, qv.y, a);
          a = fmaf(cv.z, qv.z, a);
          a = fmaf(cv.w, qv.w, a);
          acc[j] = a;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < QB; ++j) sc[j * kThreads + tid] = row < row_end ? acc[j] : -INFINITY;
    __syncthreads();

    for (int j = warp; j < nql; j += kThreads / 32) {
      float* s_list = ls + j * kMaxK;
      int* i_list = li + j * kMaxK;
      float kth = s_list[k - 1];
      for (int c0 = 0; c0 < kThreads; c0 += 32) {
        const float cand = sc[j * kThreads + c0 + lane];
        // later rows lose ties, so only a strictly larger score enters
        unsigned m = __ballot_sync(0xffffffffu, cand > kth);
        while (m) {
          const int src = __ffs(m) - 1;
          const float v = __shfl_sync(0xffffffffu, cand, src);
          if (lane == 0) insert(s_list, i_list, k, v, base + c0 + src);
          __syncwarp();
          kth = s_list[k - 1];
          m &= ~(1u << src);
          m &= __ballot_sync(0xffffffffu, cand > kth);
        }
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < nql * k; e += kThreads) {
    const int j = e / k, t = e - j * k;
    const size_t o = ((size_t)(q0 + j) * splits + split) * k + t;
    part_s[o] = ls[j * kMaxK + t];
    part_i[o] = li[j * kMaxK + t];
  }
}

constexpr int kMergeThreads = 256;

__global__ void __launch_bounds__(kMergeThreads)
topk_merge(const float* __restrict__ part_s, const int* __restrict__ part_i,
           float* __restrict__ out_s, int* __restrict__ out_i, int m, int k) {
  __shared__ float ws[kMergeThreads / 32];
  __shared__ int wi[kMergeThreads / 32];
  const int qi = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* ps = part_s + (size_t)qi * m;
  const int* pi = part_i + (size_t)qi * m;
  float last_s = INFINITY;
  int last_i = -1;
  for (int r = 0; r < k; ++r) {
    float bs = -INFINITY;
    int bi = INT_MAX;
    for (int e = tid; e < m; e += kMergeThreads) {
      const float s = ps[e];
      const int i = pi[e];
      if (better(last_s, last_i, s, i) && better(s, i, bs, bi)) {
        bs = s;
        bi = i;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_down_sync(0xffffffffu, bs, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (better(os, oi, bs, bi)) {
        bs = os;
        bi = oi;
      }
    }
    if (lane == 0) {
      ws[warp] = bs;
      wi[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bs = lane < kMergeThreads / 32 ? ws[lane] : -INFINITY;
      bi = lane < kMergeThreads / 32 ? wi[lane] : INT_MAX;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float os = __shfl_down_sync(0xffffffffu, bs, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        if (better(os, oi, bs, bi)) {
          bs = os;
          bi = oi;
        }
      }
      if (lane == 0) {
        ws[0] = bs;
        wi[0] = bi;
      }
    }
    __syncthreads();
    last_s = ws[0];
    last_i = wi[0];
    if (tid == 0) {
      out_s[(size_t)qi * k + r] = last_s;
      out_i[(size_t)qi * k + r] = last_i;
    }
    __syncthreads();
  }
}

template <typename T, int QB>
cudaError_t launch_partial(const void* q, const void* c, float* ps, int* pi, int nq, int n, int d,
                           int k, int splits, int rows_per_split, cudaStream_t st) {
  const size_t smem = sizeof(float) * ((size_t)QB * d + QB * kThreads) + (size_t)QB * kMaxK * 8;
  cudaError_t e = repro::allow_smem(topk_partial<T, QB>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(splits, (nq + QB - 1) / QB);
  topk_partial<T, QB><<<grid, kThreads, smem, st>>>(static_cast<const T*>(q),
                                                      static_cast<const T*>(c), ps, pi, nq, n,
                                                      d, k, splits, rows_per_split);
  return cudaGetLastError();
}

}  // namespace

// q (nq, d), c (n, d), both f32 or both bf16, row-major; part_* (nq,
// splits, k) scratch; out_* (nq, k).  Requires d % 4 == 0, 1 <= k <=
// min(32, n).  Returns cudaGetLastError() after both launches.
extern "C" int retrieval_topk_launch(const void* q, const void* c, void* part_s, void* part_i,
                                     void* out_s, void* out_i, int nq, int n, int d, int k,
                                     int splits, int rows_per_split, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ps = static_cast<float*>(part_s);
  int* pi = static_cast<int*>(part_i);
  cudaError_t e;
  if (is_bf16) {
    e = nq <= 8 ? launch_partial<__nv_bfloat16, 8>(q, c, ps, pi, nq, n, d, k, splits, rows_per_split, st)
                : launch_partial<__nv_bfloat16, 32>(q, c, ps, pi, nq, n, d, k, splits, rows_per_split, st);
  } else {
    e = nq <= 8 ? launch_partial<float, 8>(q, c, ps, pi, nq, n, d, k, splits, rows_per_split, st)
                : launch_partial<float, 32>(q, c, ps, pi, nq, n, d, k, splits, rows_per_split, st);
  }
  if (e != cudaSuccess) return (int)e;
  topk_merge<<<nq, kMergeThreads, 0, st>>>(ps, pi, static_cast<float*>(out_s),
                                           static_cast<int*>(out_i), splits * k, k);
  return (int)cudaGetLastError();
}
