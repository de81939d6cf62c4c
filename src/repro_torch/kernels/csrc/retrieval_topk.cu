// Blocked maximum-inner-product top-k: the retrieval hot spot of every
// data provider.
//
// Replaces the TPU kernel retrieval_topk_pallas (_kernel,
// src/repro/kernels/retrieval_topk/kernel.py), which scores a (BQ, BN)
// tile on the MXU and carries a running (BQ, k) top-k across the
// sequential N axis of its grid.
//
// What bounds it on an H100: bytes, with the f32 FMA pipes close behind.
// Every corpus row (N x D, f32 or bf16) is read once; at the provider
// shape N = 1,048,576, D = 256 f32 that is 1.07 GB, 0.32 ms at 3.35 TB/s,
// against 17.2 GFLOP of f32 FMA, 0.26 ms at 67 TFLOP/s off the tensor
// cores.  Every score is one in-order fmaf chain over d = 0 .. D-1 from
// 0.f (TF32 would round the inputs), which keeps a query's scores
// independent of the batch it rides in, so the FMA pipes and the shared
// memory that feeds them are the other limit.
//
// Design.  Blocks run in no order on Hopper, so nothing can carry a
// running top-k across the N axis.  Two launches:
//   1. topk_partial: grid (splits, ceil(Q / QB)).  A block owns QB = 32
//      queries (8 for a few) and a contiguous range of corpus rows, walked
//      in tiles of 256 rows (128), each tile in slices of 32 columns of D.
//      A ring of two stages in shared memory holds (rows + QB queries) x 32
//      columns each; 16-byte cp.async copies (eight neighbouring threads on
//      a row's 128 contiguous bytes) fill the next stage while the block
//      multiplies the current one, across tile boundaries.  Rows are padded
//      by 16 bytes, so the float4 reads of eight neighbouring rows hit
//      different banks.  Every row must start 16-byte aligned: the wrapper
//      pads D to a multiple of 16 bytes with zero columns, each of which
//      adds fmaf(0, 0, s) = s to the chain, and the tail of the last slice
//      is zero-filled.  Warp w owns queries 4w .. 4w + 3 (2w, 2w + 1) and
//      every row of the tile: lane t keeps a register tile of 4 queries x 8
//      rows t + 32 r (2 x 4), so per four columns 4 + 8 float4 shared loads
//      (the queries' a broadcast) feed 128 FMAs.
//      At the end of a tile each warp selects for its own queries, with no
//      block barrier: a score that passes its query's threshold (the
//      list's k-th entry) joins the query's buffer of 32 in shared memory,
//      appended in place by a ballot.  A buffer that would overflow makes
//      the warp merge its queries' buffers into their lists (a bitonic sort
//      of the 32 candidates over the lanes, then a bitonic merge with the
//      sorted list of 32, the queries' networks interleaved), raise the
//      thresholds and retry.  On a block's first tile, whose lists are
//      empty, the threshold is the k-th best of the lanes' best scores (at
//      least k scores reach it), so a tile of 256 sends a few dozen
//      candidates instead of all.  Lists of k <= 32 live in shared memory;
//      longer lists (no path asks for them) live in the block's slice of
//      the partial output and take the buffered candidates one insertion at
//      a time.  Output: (Q, splits, k) partial lists.
//   2. topk_merge: one block per query selects the k best of its
//      splits * k partials, k rounds of a block-wide argmax, each round
//      taking the best entry strictly after the previous pick.  A merge
//      in the partial kernel's last block (found by a counter) would save
//      the second launch; it is left out, since the serves are host-bound.
// Order everywhere is (score descending, index ascending): ties go to
// the smaller corpus index, as in lax.top_k and the TPU kernel.
#include <climits>

#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int kRows = 256;  // the wrapper's split unit: a multiple of every tile's rows
constexpr int kSlice = 32;  // columns of D per stage
constexpr int kStages = 2;  // ring depth
constexpr int kSmemK = 32;  // lists up to this length live in shared memory

__device__ __forceinline__ bool better(float s, int i, float t, int j) {
  return s > t || (s == t && i < j);
}

// four consecutive shared elements as f32
__device__ __forceinline__ float4 lds4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 lds4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// The warp inserts (v, i) into the sorted list (s, idx) of length k if it
// beats the last entry: its place is the count of entries better than
// it (a prefix, the list being sorted), the entries from there on move
// down one, the last falls off.  Works on shared or global lists.
__device__ __forceinline__ void warp_insert(float* s, int* idx, int k, float v, int i, int lane) {
  int pos = 0;
  for (int t0 = 0; t0 < k; t0 += 32) {
    const int t = t0 + lane;
    pos += __popc(__ballot_sync(0xffffffffu, t < k && better(s[t], idx[t], v, i)));
  }
  if (pos >= k) return;
  for (int t1 = k - 1; t1 > pos; t1 -= 32) {  // from the end backward, 32 at a time
    const int t = t1 - lane;
    const bool act = t > pos;
    float sv = 0.f;
    int iv = 0;
    if (act) {
      sv = s[t - 1];
      iv = idx[t - 1];
    }
    __syncwarp();
    if (act) {
      s[t] = sv;
      idx[t] = iv;
    }
    __syncwarp();
  }
  if (lane == 0) {
    s[pos] = v;
    idx[pos] = i;
  }
  __syncwarp();
}

// One compare-exchange of a bitonic network between lane and lane ^ stride:
// the lane keeps the better entry if keep_better, else the worse.
__device__ __forceinline__ void exchange(float& s, int& i, int stride, bool keep_better) {
  const float os = __shfl_xor_sync(0xffffffffu, s, stride);
  const int oi = __shfl_xor_sync(0xffffffffu, i, stride);
  if (keep_better ? better(os, oi, s, i) : better(s, i, os, oi)) {
    s = os;
    i = oi;
  }
}

// The warp sorts N sets of one entry a lane, each best first in lane
// order (bitonic sorts over the lanes, the N networks interleaved).
template <int N>
__device__ __forceinline__ void warp_sort(float (&s)[N], int (&i)[N], int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int stride = size / 2; stride > 0; stride >>= 1)
#pragma unroll
      for (int n = 0; n < N; ++n) exchange(s[n], i[n], stride, ((lane & stride) == 0) == ((lane & size) == 0));
}

// The warp merges the buffers of N queries (query n: nb[n] <= 32
// candidates at bs + 32 n) into their sorted 32-entry lists (at ls +
// 32 n), the N networks interleaved: it sorts a query's candidates, keeps
// the better of list entry t and candidate 31 - t (the best 32 of both, as
// a bitonic sequence) and sorts that (a bitonic merge).
template <int N>
__device__ __forceinline__ void warp_merge(float* ls, int* li, const float* bs, const int* bi, const int (&nb)[N],
                                           int lane) {
  __syncwarp();  // the buffers' appends are visible
  float s[N];
  int i[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    s[n] = lane < nb[n] ? bs[32 * n + lane] : -INFINITY;
    i[n] = lane < nb[n] ? bi[32 * n + lane] : INT_MAX;
  }
  warp_sort(s, i, lane);
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const float rs = __shfl_sync(0xffffffffu, s[n], 31 - lane);
    const int ri = __shfl_sync(0xffffffffu, i[n], 31 - lane);
    s[n] = ls[32 * n + lane];
    i[n] = li[32 * n + lane];
    if (better(rs, ri, s[n], i[n])) {
      s[n] = rs;
      i[n] = ri;
    }
  }
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1)
#pragma unroll
    for (int n = 0; n < N; ++n) exchange(s[n], i[n], stride, (lane & stride) == 0);
  __syncwarp();
#pragma unroll
  for (int n = 0; n < N; ++n) {
    if (nb[n] > 0) {
      ls[32 * n + lane] = s[n];
      li[32 * n + lane] = i[n];
    }
  }
  __syncwarp();
}

// One query's nb buffered candidates into its list longer than 32, one
// at a time.  Out of line: no path asks for such lists.
__device__ __noinline__ void flush_long(float* ls, int* li, int k, const float* bs, const int* bi, int nb, int lane) {
  for (int e = 0; e < nb; ++e) warp_insert(ls, li, k, bs[e], bi[e], lane);
}

// Where a warp's selection keeps its state: the lists (query j's at
// ls + j * pitch, in shared memory for k <= kSmemK, else in the block's
// slice of the partial output) and the buffers of 32 survivors (bs + 32 j,
// in shared memory).
struct Lists {
  float* ls;
  int* li;
  size_t pitch;
  float* bs;
  int* bi;
  int k;
};

// Every buffer of the warp's TQ queries (from qw; nb[i] candidates each)
// into its list; the counts are then 0.
template <int TQ>
__device__ __forceinline__ void flush_warp(const Lists& L, int qw, int (&nb)[TQ], int lane) {
  if (L.k <= kSmemK) {
    warp_merge<TQ>(L.ls + qw * L.pitch, L.li + qw * L.pitch, L.bs + qw * 32, L.bi + qw * 32, nb, lane);
  } else {
#pragma unroll
    for (int i = 0; i < TQ; ++i)
      if (nb[i] > 0) flush_long(L.ls + (qw + i) * L.pitch, L.li + (qw + i) * L.pitch, L.k, L.bs + (qw + i) * 32,
                                L.bi + (qw + i) * 32, nb[i], lane);
  }
#pragma unroll
  for (int i = 0; i < TQ; ++i) nb[i] = 0;
}

// Whether score v of row `row` passes the threshold (t_s, t_i): beats it,
// or (incl) reaches it.
__device__ __forceinline__ bool passes(float v, int row, float t_s, int t_i, bool incl) {
  return incl ? !better(t_s, t_i, v, row) : better(v, row, t_s, t_i);
}

// The warp's selection over one scored tile: sc[i][r] is the score of
// query qw + i against row base + lane + 32 r; nb[i] counts query qw + i's
// buffered survivors.  A score that passes its query's threshold joins the
// query's buffer of 32.  The threshold is the list's k-th entry; on the
// block's first tile (first), whose lists are empty, it is the k-th best of
// the lanes' best scores (inclusive: at least k scores of the tile reach
// it), and the buffers are merged at the tile's end.  Where a buffer would
// overflow, the warp merges every buffer of its queries, raises the
// thresholds to the lists' k-th entries, drops the scores that no longer
// pass, and appends the rest in another round.
template <int TQ, int TR>
__device__ __forceinline__ void select_tile(const float (&sc)[TQ][TR], const Lists& L, int base, int row_end,
                                            bool first, int qw, int nql, int (&nb)[TQ], int lane) {
  const int k = L.k;
  float t_s[TQ];
  int t_i[TQ];
  bool incl[TQ];
  if (first && k <= kSmemK) {
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      t_s[i] = -INFINITY;
      t_i[i] = INT_MAX;
#pragma unroll
      for (int r = 0; r < TR; ++r) {
        const int row = base + lane + 32 * r;
        if (row < row_end && better(sc[i][r], row, t_s[i], t_i[i])) {
          t_s[i] = sc[i][r];
          t_i[i] = row;
        }
      }
    }
    warp_sort(t_s, t_i, lane);
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      t_s[i] = __shfl_sync(0xffffffffu, t_s[i], k - 1);
      t_i[i] = __shfl_sync(0xffffffffu, t_i[i], k - 1);
      incl[i] = true;
    }
  } else {
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      const int j = min(qw + i, nql - 1);
      t_s[i] = L.ls[j * L.pitch + k - 1];
      t_i[i] = L.li[j * L.pitch + k - 1];
      incl[i] = false;
    }
  }
  unsigned long long pend = 0;  // bit i * TR + r: sc[i][r] passes and is not yet buffered
#pragma unroll
  for (int i = 0; i < TQ; ++i)
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const int row = base + lane + 32 * r;
      if (qw + i < nql && row < row_end && passes(sc[i][r], row, t_s[i], t_i[i], incl[i])) pend |= 1ull << (i * TR + r);
    }
  for (;;) {
    bool full = false;  // warp-uniform
#pragma unroll
    for (int r = 0; r < TR; ++r) {
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
        const unsigned long long bit = 1ull << (i * TR + r);
        const bool surv = pend & bit;
        const unsigned m = __ballot_sync(0xffffffffu, surv);
        if (m == 0) continue;
        if (nb[i] + __popc(m) > 32) {
          full = true;
          continue;
        }
        const int j = qw + i;
        if (surv) {
          const int slot = nb[i] + __popc(m & ((1u << lane) - 1));
          L.bs[j * 32 + slot] = sc[i][r];
          L.bi[j * 32 + slot] = base + lane + 32 * r;
        }
        nb[i] += __popc(m);
        pend &= ~bit;
      }
    }
    if (!full && !first) return;
    __syncwarp();  // the appends are visible to the merge
    flush_warp<TQ>(L, qw, nb, lane);
    if (!full) return;
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      const int j = min(qw + i, nql - 1);
      const float u_s = L.ls[j * L.pitch + k - 1];
      const int u_i = L.li[j * L.pitch + k - 1];
      if (!better(t_s[i], t_i[i], u_s, u_i)) {  // the list's k-th entry is now at least as tight
        t_s[i] = u_s;
        t_i[i] = u_i;
        incl[i] = false;
      }
#pragma unroll
      for (int r = 0; r < TR; ++r)
        if (!passes(sc[i][r], base + lane + 32 * r, t_s[i], t_i[i], incl[i])) pend &= ~(1ull << (i * TR + r));
    }
  }
}

// Shared memory of one block: the ring, a buffer of 32 survivors per
// query, the lists of k <= kSmemK.
template <typename T, int QB, int ROWS>
struct Smem {
  static constexpr int kPitch = kSlice + 16 / sizeof(T);  // elements per staged row
  static constexpr size_t kStage = (size_t)(ROWS + QB) * kPitch * sizeof(T);
  static constexpr size_t kBuf = kStages * kStage;
  static constexpr size_t kLists = kBuf + (size_t)QB * 32 * 8;
  static constexpr size_t kBytes = kLists + (size_t)QB * kSmemK * 8;
};

template <typename T, int QB, int TQ, int TR, int ROWS>
__global__ void __launch_bounds__((QB / TQ) * (ROWS / TR))
topk_partial(const T* __restrict__ q, const T* __restrict__ c, float* part_s, int* part_i, int nq,
             int n, int d, int k, int splits, int rows_per_split) {
  using S = Smem<T, QB, ROWS>;
  constexpr int RG = ROWS / TR;  // a thread's rows are lane + 32 r, its queries warp * TQ + i
  constexpr int NT = (QB / TQ) * RG;
  constexpr int P = S::kPitch;
  static_assert(RG == 32, "a warp holds all the rows of its queries");
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  float* buf_s = reinterpret_cast<float*>(smem + S::kBuf);  // [QB][32]
  int* buf_i = reinterpret_cast<int*>(buf_s + QB * 32);
  float* ls = reinterpret_cast<float*>(smem + S::kLists);   // [QB][kSmemK]
  int* li = reinterpret_cast<int*>(ls + QB * kSmemK);

  const int tid = threadIdx.x, lane = tid & 31, tq = tid >> 5, tr = lane;
  const int split = blockIdx.x;
  const int q0 = blockIdx.y * QB;
  const int nql = min(QB, nq - q0);
  const int row_begin = split * rows_per_split;
  const int row_end = min(n, row_begin + rows_per_split);
  const int n_tiles = (row_end - row_begin + ROWS - 1) / ROWS;
  const int n_sl = max(1, (d + kSlice - 1) / kSlice);  // D = 0 scores 0: one empty slice
  const int total = n_tiles * n_sl;

  const bool smem_lists = k <= kSmemK;
  const Lists L{smem_lists ? ls : part_s + ((size_t)q0 * splits + split) * k,
                smem_lists ? li : part_i + ((size_t)q0 * splits + split) * k,
                smem_lists ? (size_t)kSmemK : (size_t)splits * k, buf_s, buf_i, k};
  // every list starts as k (or kSmemK) entries (-inf, INT_MAX)
  const int len = smem_lists ? kSmemK : k;
  for (int e = tid; e < (smem_lists ? QB : nql) * len; e += NT) {
    const int j = e / len, t = e - j * len;
    L.ls[j * L.pitch + t] = -INFINITY;
    L.li[j * L.pitch + t] = INT_MAX;
  }
  const int qw = tq * TQ;  // the warp's first query
  int nb[TQ];              // buffered survivors of the warp's queries
#pragma unroll
  for (int i = 0; i < TQ; ++i) nb[i] = 0;

  // stage `step` (tile step / n_sl, slice step % n_sl) into its ring slot
  auto issue = [&](int step) {
    if (step >= total) return;
    T* st = ring + (size_t)(step % kStages) * (ROWS + QB) * P;
    const int base = row_begin + (step / n_sl) * ROWS;
    const int d0 = (step % n_sl) * kSlice;
    constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte copy
    constexpr int CPR = kSlice / VEC;    // copies per staged row
    for (int e = tid; e < (ROWS + QB) * CPR; e += NT) {
      const int r = e / CPR, col = d0 + (e - r * CPR) * VEC;
      const bool is_q = r >= ROWS;
      const int row = is_q ? r - ROWS : base + r;
      const bool ok = col < d && (is_q ? row < nql : row < row_end);
      const T* src = ok ? (is_q ? q + (size_t)(q0 + row) * d : c + (size_t)row * d) + col : c;
      repro::cp_async16(repro::smem_addr(st + r * P + (col - d0)), src, ok);
    }
  };

  float acc[TQ][TR];
#pragma unroll
  for (int i = 0; i < TQ; ++i)
#pragma unroll
    for (int r = 0; r < TR; ++r) acc[i][r] = 0.f;

  // four columns of the staged slice into the register tile, each score's
  // fmaf chain in column order
  auto fma4 = [&](const T* cs, const T* qs, int dd) {
    float4 qv[TQ];
#pragma unroll
    for (int i = 0; i < TQ; ++i) qv[i] = lds4(qs + (tq * TQ + i) * P + dd);
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const float4 cv = lds4(cs + (tr + RG * r) * P + dd);
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
        float a = acc[i][r];
        a = fmaf(cv.x, qv[i].x, a);
        a = fmaf(cv.y, qv[i].y, a);
        a = fmaf(cv.z, qv[i].z, a);
        a = fmaf(cv.w, qv[i].w, a);
        acc[i][r] = a;
      }
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    issue(s);
    repro::cp_async_commit();
  }
  for (int step = 0; step < total; ++step) {
    repro::cp_async_wait<kStages - 2>();
    __syncthreads();  // this step's stage has landed; the slot refilled next is free
    issue(step + kStages - 1);
    repro::cp_async_commit();

    const T* cs = ring + (size_t)(step % kStages) * (ROWS + QB) * P;
    const T* qs = cs + ROWS * P;
    const int sl = step % n_sl;
    const int dl = min(kSlice, d - sl * kSlice);  // columns of D in this slice
    if (dl == kSlice) {
#pragma unroll
      for (int dd = 0; dd < kSlice; dd += 4) fma4(cs, qs, dd);
    } else {
      for (int dd = 0; dd < dl; dd += 4) fma4(cs, qs, dd);  // the zero-filled tail adds +0
    }
    if (sl != n_sl - 1) continue;

    // ---- the tile is scored: each warp selects for its own queries ----
    select_tile<TQ, TR>(acc, L, row_begin + (step / n_sl) * ROWS, row_end, step < n_sl, qw, nql, nb, lane);
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int r = 0; r < TR; ++r) acc[i][r] = 0.f;
  }
  __syncwarp();
  flush_warp<TQ>(L, qw, nb, lane);
  repro::cp_async_wait<0>();

  if (smem_lists) {
    __syncthreads();
    for (int e = tid; e < nql * k; e += NT) {
      const int j = e / k, t = e - j * k;
      const size_t o = ((size_t)(q0 + j) * splits + split) * k + t;
      part_s[o] = ls[j * kSmemK + t];
      part_i[o] = li[j * kSmemK + t];
    }
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

template <typename T, int QB, int TQ, int TR, int ROWS>
cudaError_t launch_partial(const void* q, const void* c, float* ps, int* pi, int nq, int n, int d,
                           int k, int splits, int rows_per_split, cudaStream_t st) {
  constexpr size_t smem = Smem<T, QB, ROWS>::kBytes;
  static size_t allowed = 0;
  cudaError_t e = repro::allow_smem(topk_partial<T, QB, TQ, TR, ROWS>, smem, allowed);
  if (e != cudaSuccess) return e;
  dim3 grid(splits, (nq + QB - 1) / QB);
  topk_partial<T, QB, TQ, TR, ROWS><<<grid, (QB / TQ) * (ROWS / TR), smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(c), ps, pi, nq, n, d, k, splits, rows_per_split);
  return cudaGetLastError();
}

// QB = 8 queries a block (2 x 4 register tiles, 128-row tiles, 128
// threads) for a few queries, else QB = 32 (4 x 8, 256-row tiles, 256
// threads)
template <typename T>
cudaError_t by_shape(const void* q, const void* c, float* ps, int* pi, int nq, int n, int d, int k,
                     int splits, int rows_per_split, cudaStream_t st) {
  if (nq <= 8) return launch_partial<T, 8, 2, 4, 128>(q, c, ps, pi, nq, n, d, k, splits, rows_per_split, st);
  return launch_partial<T, 32, 4, 8, 256>(q, c, ps, pi, nq, n, d, k, splits, rows_per_split, st);
}

}  // namespace

// q (nq, d), c (n, d), both f32 or both bf16, row-major; part_* (nq,
// splits, k) scratch; out_* (nq, k).  Any 1 <= k <= n; d >= 0 with
// d * sizeof(element) a multiple of 16 and q, c 16-byte aligned;
// rows_per_split a multiple of 256.  Returns cudaGetLastError() after
// both launches.
extern "C" int retrieval_topk_launch(const void* q, const void* c, void* part_s, void* part_i,
                                     void* out_s, void* out_i, int nq, int n, int d, int k,
                                     int splits, int rows_per_split, int is_bf16, void* stream) {
  const size_t row_bytes = (size_t)d * (is_bf16 ? 2 : 4);
  if (k < 1 || k > n || rows_per_split % kRows || row_bytes % 16 ||
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(c)) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ps = static_cast<float*>(part_s);
  int* pi = static_cast<int*>(part_i);
  const cudaError_t e = is_bf16 ? by_shape<__nv_bfloat16>(q, c, ps, pi, nq, n, d, k, splits, rows_per_split, st)
                                : by_shape<float>(q, c, ps, pi, nq, n, d, k, splits, rows_per_split, st);
  if (e != cudaSuccess) return (int)e;
  topk_merge<<<nq, kMergeThreads, 0, st>>>(ps, pi, static_cast<float*>(out_s),
                                           static_cast<int*>(out_i), splits * k, k);
  return (int)cudaGetLastError();
}
