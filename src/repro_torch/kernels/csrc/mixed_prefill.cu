// Unified chunked-prefill attention: paged flash attention over a ragged
// q-tile, one launch for any mix of prefill chunks and decode rows.
//
// Replaces the TPU kernel mixed_prefill_attention_pallas (_mixed_kernel,
// src/repro/kernels/chunked_prefill/kernel.py).  Row r of the batch is
// described by desc[r] = (slot, q_start, q_len, kv_len[, q_off]): query
// lane j sees key position kpos iff kpos <= q_start + j and kpos <
// kv_len.  K/V are read from the shared block pool through
// block_tables[slot].  Where the lanes live:
//   * packed (w == 0, the serving path): q and the output are (n, h, dh),
//     row r's q_len lanes back to back from lane q_off = desc[r][4]; only
//     those lanes are read and written;
//   * padded (w > 0): q and the output are (r, w, h, dh), the special case
//     q_off = r * w, and lanes q_len <= j < w output an exact 0.
// Rows lie in the lane axis in the order of desc (q_off ascending, no two
// overlapping), which is what maps a block to its row below.
//
// What bounds it on an H100: bytes.  Each (row, kv head) reads the q
// rows of its live lanes, the K/V of the positions its lanes can see,
// and writes the output; at the serving shapes (head_dim 128, 8 KV
// heads, bf16) the work per byte is far below the ~295 FLOP/byte where
// the tensor cores would become the limit, provided the products run on
// them and the loads are in flight while they do.
//
// Both versions tile the lane axis: a block takes one (row, KV head) and
// 64 flattened rows i = lane * G + group of that row.  Row r's lane tiles
// take the tile slots from tile0(r) = q_off(r) * G / 64 + r on, at least
// as many as it has tiles, so the grid is (n * G / 64 + R) slots x KV
// whatever the rows' lengths: a block finds its row by counting the rows
// whose first slot is at or before its own (one __syncthreads_count per
// 128 or 256 rows), and a slot past its row's last tile exits at once.
// The TPU kernel holds all W*G lanes x group heads of a (row, kv head) in one VMEM block; at W*G = 512
// and head_dim 128 that is 256 KiB of q alone, beyond the 227 KB of
// shared memory a Hopper block may have.  The block reads desc and the
// block table itself (Hopper has no scalar prefetch) and walks key
// positions only up to what its live lanes can see, n_kv =
// min(kv_len, n_t * bs, q_start + last live lane + 1); a tile whose lanes
// are all dead reads no K/V at all and writes zeros.  Masking is by
// select, never by multiplying with 0: a masked score becomes NEG_INF and
// a masked probability is set to 0 after the exp, so a dead lane keeps
// l = 0 and acc = 0 and outputs an exact 0.
//
// bf16 (the path: qwen3-0.6b, 16 / 8 heads, head_dim 128, bs 32): one
// warpgroup on the tensor cores, the tile body of attn_tile.cuh (shared
// with flash_attention.cu: cp.async into swizzled tiles, a 2-stage K
// ring, S = Q K^T and O += (P_hi + P_lo) V on wgmma, softmax on the
// fragments).  This file gives it the rows (PagedSrc):
//   * Q rows of live lanes come in by cp.async; dead lanes' rows are
//     zero-filled and never read.
//   * Key pos of row r is pool block tables[slot, pos / bs] at offset
//     pos % bs, so a 64-key tile spans 64 / bs pool blocks.  The table
//     entries the walk reaches are read once into shared memory before
//     the first K copy.  Copies past n_kv are zero-filled, so pool bytes
//     no live lane sees (the trash block, a block's unwritten tail) never
//     reach the tensor cores, where a NaN would pass through 0 x NaN.
//   * A row sees the keys pos < min(n_kv, q_start + lane + 1), a dead
//     lane none.
//   * Blocks are numbered last tile slot first, so that within a row the
//     tiles with the longest walks start first.
//
// Partials (mixed_prefill_partials_launch, the per-shard half of the
// sharded engine's dispatch): the same walk, stopped before the
// normalisation.  It stores f32 o (un-normalised), m (natural units) and
// l at (lane, kv head, group) of the packed axis, or (r, kv head, group,
// lane) in the padded form, and takes an optional (B, n_t) uint8
// `owned` table: a key in a block whose entry is 0 is masked like a key
// past kv_len, and its K/V copies are zero-filled, so a block this shard
// does not own (another shard's id mapped to the local trash) is never
// read.  A row that sees no key (no owned entry, a dead lane, a free
// slot's all-trash table) stores exactly m = NEG_INF, l = 0, o = 0, so
// the cross-shard combine passes the owner's partials through bitwise.
// A row's walk depends only on its own descriptor and table entries,
// never on the pool's size or another row's ownership; it ends at the
// row's last owned block, so a shard's call on the rows it does not own
// (row affinity: all but its own) reads no K/V and does no products.
//
// Sliding window (window > 0, mixed_prefill_launch's window argument):
// lane j of a row also needs kpos > q_start + j - window.  The windowed
// kernels (mixed_prefill_window_bf16, mixed_prefill_window) are the same
// bodies with the window as a template flag, so the kernels without it
// are compiled exactly as before.  A block starts its walk at the key tile
// (chunk, in f32) that holds the lowest key its first live lane sees: the
// tiles wholly below every lane's window are neither loaded nor computed,
// so a windowed row's prefill reads about `window` keys a lane tile
// however long its prefix.  The partials form has no window.
//
// f32 (the smoke-width checks and the tests): the first version's design
// on the CUDA cores, 4 threads per query row, each scoring 8 of the 32
// keys of a chunk staged in shared memory as f32 (one fmaf chain over
// head_dim in order), the row's max and sum by a fixed butterfly of warp
// shuffles.
#include "attn_tile.cuh"

namespace {

using repro::NEG_INF;
using repro::from_f;
using repro::to_f;

constexpr int TQ = 64;  // flattened (lane, group) rows per block

// ------------------------------------------------------------------ //
// bf16: wgmma, attn_tile.cuh
// ------------------------------------------------------------------ //

using repro::attn::kWgThreads;

// The block's row and lane tile.  Row r's first tile slot is tile0(r) =
// q_off(r) * g / TQ + r; the block's row is the last whose first slot is
// at or before the block's slot t, counted over the block's threads.
struct Row {
  int r, slot, q_start, q_len, kv_len, q_off;
  int rows_total;  // flattened (lane, group) rows the row owns: its lanes x g
  int i0;          // the block's first flattened row

  // false: slot t lies past its row's last tile (or before the first
  // row), and the block has nothing to do.  Called by all the block's
  // threads; every thread gets the same answer.
  __device__ __forceinline__ bool find(const int* desc, int nr, int w, int g, int t) {
    auto off = [&](int e) { return w ? e * w : desc[e * 5 + 4]; };
    auto tile0 = [&](int e) { return (int)((long long)off(e) * g / TQ) + e; };
    r = -1;
    for (int base = 0; base < nr; base += blockDim.x) {
      const int e = base + (int)threadIdx.x;
      r += __syncthreads_count(e < nr && tile0(e) <= t);
    }
    if (r < 0) return false;
    const int* d = desc + r * (w ? 4 : 5);
    slot = d[0], q_start = d[1], q_len = d[2], kv_len = d[3];
    q_off = off(r);
    rows_total = (w ? w : q_len) * g;
    i0 = (t - tile0(r)) * TQ;
    return i0 < rows_total;
  }
  // key positions any live lane of the tile can see (never past the n_t *
  // bs positions the block table addresses)
  __device__ __forceinline__ int n_kv(int g, int n_t, int bs) const {
    const int first_lane = i0 / g;
    const int last_lane = min((min(rows_total, i0 + TQ) - 1) / g, q_len - 1);
    return first_lane < q_len ? max(0, min(min(kv_len, n_t * bs), q_start + last_lane + 1)) : 0;
  }
  // the row's (lane 0, head kvh * g) in the partials, and a lane's and a
  // group's strides there: (n, KV, G) packed, (R, KV, G, W) padded
  __device__ __forceinline__ size_t part0(int w, int h, int kv, int kvh, int g) const {
    return w ? ((size_t)r * kv + kvh) * g * w : (size_t)q_off * h + (size_t)kvh * g;
  }
};

// the blocks: tile slots (n * g / TQ + nr) x kv, the last slot first
inline int tile_slots(int n, int g, int nr) { return (int)((long long)n * g / TQ) + nr; }

// rows i0 + row = lane * g + group of (batch row r, KV head kvh); keys
// through the block table entries staged in shared memory (with PART, a
// block this shard does not own staged as -1); with WIN, a lane at
// position p sees the keys from p - window + 1 on
template <int DH, bool PART, bool WIN>
struct PagedSrc {
  static constexpr bool kPartials = PART;
  static constexpr bool kWindow = WIN;
  const __nv_bfloat16* q;  // at (q_off, kvh * g) of the (lanes, H, dh) q
  const __nv_bfloat16 *kp, *vp;
  __nv_bfloat16* out;      // at (q_off, kvh * g) of the output
  float *o_part, *m_part, *l_part;  // at the row's part0 of the partials
  const int* tbl_s;        // tables[slot, :] in shared memory
  int i0, g, h, kv, kvh, rows_total, q_start, q_len, bs, n_kv;
  int ps_lane, ps_group;   // a lane's and a group's strides in the partials
  int window, k_lo;        // WIN: the window, and the lowest key the tile's first lane sees

  __device__ __forceinline__ const __nv_bfloat16* q_row(int row, bool& ok) const {
    const int i = i0 + row, lane = i / g;
    ok = i < rows_total && lane < q_len;
    return ok ? q + ((size_t)lane * h + (i - lane * g)) * DH : q;
  }
  __device__ __forceinline__ size_t kv_off(int pos) const {
    const int blk = tbl_s[pos / bs];  // a block not owned (-1) is never read: point at block 0
    return (((size_t)(PART && blk < 0 ? 0 : blk) * bs + pos % bs) * kv + kvh) * DH;
  }
  __device__ __forceinline__ const __nv_bfloat16* k_row(int pos) const { return kp + kv_off(pos); }
  __device__ __forceinline__ const __nv_bfloat16* v_row(int pos) const { return vp + kv_off(pos); }
  __device__ __forceinline__ int row_limit(int row) const {
    const int i = i0 + row, lane = i / g;
    return i < rows_total && lane < q_len ? min(n_kv, q_start + lane + 1) : 0;
  }
  __device__ __forceinline__ int row_start(int row) const {
    const int lane = (i0 + row) / g;
    return max(0, q_start + lane - window + 1);
  }
  __device__ __forceinline__ bool key_ok(int pos) const { return !PART || tbl_s[pos / bs] >= 0; }
  __device__ __forceinline__ __nv_bfloat16* out_row(int row) const {
    const int i = i0 + row, lane = i / g;
    return i < rows_total ? out + ((size_t)lane * h + (i - lane * g)) * DH : nullptr;
  }
  __device__ __forceinline__ int part_index(int row) const {
    const int i = i0 + row, lane = i / g;
    return i < rows_total ? (i - lane * g) * ps_group + lane * ps_lane : -1;
  }
};

// table entries staged beyond n_t with PART: key_ok may be read for a
// position up to 63 past the walk, whose value is never used
constexpr int kTblSlack = 64;

template <int DH, bool PART, bool WIN>
__device__ __forceinline__ void mixed_prefill_bf16_body(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kp,
    const __nv_bfloat16* __restrict__ vp, const int* __restrict__ tables, const int* __restrict__ desc,
    const uint8_t* __restrict__ owned, __nv_bfloat16* __restrict__ out, float* __restrict__ o_part,
    float* __restrict__ m_part, float* __restrict__ l_part, int nr, int w, int h, int kv, int bs, int n_t,
    int n_slots, float scale_log2, int window) {
  extern __shared__ uint8_t smem_raw[];
  int* tbl_s = reinterpret_cast<int*>(smem_raw + repro::attn::Tile<DH>::SMEM);  // [n_t]
  const int g = h / kv, kvh = blockIdx.x % kv;
  Row row;
  if (!row.find(desc, nr, w, g, n_slots - 1 - blockIdx.x / kv)) return;
  int n_kv = row.n_kv(g, n_t, bs);

  const int n_e = (n_kv + bs - 1) / bs;  // table entries the walk reaches
  for (int e = threadIdx.x; e < n_e; e += kWgThreads) {
    const size_t a = (size_t)row.slot * n_t + e;
    tbl_s[e] = PART && owned != nullptr && owned[a] == 0 ? -1 : tables[a];
  }
  __syncthreads();
  if (PART) {
    // the walk ends at the last owned block: the key tiles after it are
    // wholly masked, and skipping them leaves m, l and o exact; a row this
    // shard owns no block of walks nothing and stores exact zeros
    int e = n_e - 1;
    while (e >= 0 && tbl_s[e] < 0) --e;
    n_kv = min(n_kv, (e + 1) * bs);
  }
  const size_t row0 = ((size_t)row.q_off * h + (size_t)kvh * g) * DH;
  const size_t part0 = row.part0(w, h, kv, kvh, g);
  const int k_lo = WIN ? max(0, row.q_start + row.i0 / g - window + 1) : 0;
  const PagedSrc<DH, PART, WIN> src{q + row0, kp, vp, PART ? out : out + row0,
                                    PART ? o_part + part0 * DH : o_part, PART ? m_part + part0 : m_part,
                                    PART ? l_part + part0 : l_part, tbl_s, row.i0, g, h, kv, kvh,
                                    row.rows_total, row.q_start, row.q_len, bs, n_kv,
                                    w ? 1 : h, w ? w : 1, window, k_lo};
  repro::attn::attend_tile<DH>(src, smem_raw, n_kv, scale_log2);
}

template <int DH, bool PART>
__global__ void __launch_bounds__(kWgThreads)
mixed_prefill_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kp,
                   const __nv_bfloat16* __restrict__ vp, const int* __restrict__ tables,
                   const int* __restrict__ desc, const uint8_t* __restrict__ owned,
                   __nv_bfloat16* __restrict__ out, float* __restrict__ o_part,
                   float* __restrict__ m_part, float* __restrict__ l_part, int nr, int w, int h,
                   int kv, int bs, int n_t, int n_slots, float scale_log2) {
  mixed_prefill_bf16_body<DH, PART, false>(q, kp, vp, tables, desc, owned, out, o_part, m_part, l_part, nr, w, h,
                                           kv, bs, n_t, n_slots, scale_log2, 0);
}

template <int DH>
__global__ void __launch_bounds__(kWgThreads)
mixed_prefill_window_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kp,
                          const __nv_bfloat16* __restrict__ vp, const int* __restrict__ tables,
                          const int* __restrict__ desc, __nv_bfloat16* __restrict__ out, int nr, int w, int h,
                          int kv, int bs, int n_t, int n_slots, float scale_log2, int window) {
  mixed_prefill_bf16_body<DH, false, true>(q, kp, vp, tables, desc, nullptr, out, nullptr, nullptr, nullptr, nr,
                                           w, h, kv, bs, n_t, n_slots, scale_log2, window);
}

template <int DH, bool PART>
cudaError_t launch_bf16(const void* q, const void* kp, const void* vp, const int* tables,
                        const int* desc, const uint8_t* owned, void* out, float* o_part,
                        float* m_part, float* l_part, int r, int w, int n, int h, int kv, int bs,
                        int n_t, int window, cudaStream_t st) {
  const size_t smem = repro::attn::Tile<DH>::SMEM + sizeof(int) * ((size_t)n_t + (PART ? kTblSlack : 0));
  const int n_slots = tile_slots(n, h / kv, r);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)DH);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(kp);
  const auto* vb = static_cast<const __nv_bfloat16*>(vp);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  if (!PART && window > 0) {
    static size_t allowed_w = 0;
    cudaError_t e = repro::allow_smem(mixed_prefill_window_bf16<DH>, smem, allowed_w);
    if (e != cudaSuccess) return e;
    mixed_prefill_window_bf16<DH><<<n_slots * kv, kWgThreads, smem, st>>>(
        qb, kb, vb, tables, desc, ob, r, w, h, kv, bs, n_t, n_slots, scale_log2, window);
    return cudaGetLastError();
  }
  static size_t allowed = 0;
  cudaError_t e = repro::allow_smem(mixed_prefill_bf16<DH, PART>, smem, allowed);
  if (e != cudaSuccess) return e;
  mixed_prefill_bf16<DH, PART><<<n_slots * kv, kWgThreads, smem, st>>>(
      qb, kb, vb, tables, desc, owned, ob, o_part, m_part, l_part, r, w, h, kv, bs, n_t, n_slots, scale_log2);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ //
// f32: CUDA cores
// ------------------------------------------------------------------ //

constexpr int kThreads = 256;
constexpr int KC = 32;  // key positions per chunk

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)TQ * (DH + 1) + 2 * KC * (DH + 1) + TQ * (KC + 1) + KC);
}

template <typename T, int DH, bool PART, bool WIN>
__device__ __forceinline__ void mixed_prefill_body(
    const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp, const int* __restrict__ tables,
    const int* __restrict__ desc, const uint8_t* __restrict__ owned, T* __restrict__ out,
    float* __restrict__ o_part, float* __restrict__ m_part, float* __restrict__ l_part, int nr, int w, int h,
    int kv, int bs, int n_t, int n_slots, float scale, int window) {
  constexpr int LD = DH + 1;  // padded rows: no shared-memory bank conflicts
  constexpr int PLD = KC + 1;
  constexpr int NC = DH / 4;  // output columns per thread
  extern __shared__ float sm[];
  float* q_s = sm;              // [TQ][LD]
  float* k_s = q_s + TQ * LD;   // [KC][LD]
  float* v_s = k_s + KC * LD;   // [KC][LD]
  float* p_s = v_s + KC * LD;   // [TQ][PLD]
  int* own_s = reinterpret_cast<int*>(p_s + TQ * PLD);  // [KC]: the chunk's key is owned

  const int g = h / kv, kvh = blockIdx.x % kv;
  Row rw;
  if (!rw.find(desc, nr, w, g, n_slots - 1 - blockIdx.x / kv)) return;
  const int slot = rw.slot, q_start = rw.q_start, q_len = rw.q_len, kv_len = rw.kv_len;
  const int rows_total = rw.rows_total, i0 = rw.i0;
  const int tid = threadIdx.x, row = tid >> 2, part = tid & 3;
  int n_kv = rw.n_kv(g, n_t, bs);
  if (PART && owned != nullptr) {  // up to the last owned block, as in the bf16 body
    int e = (n_kv + bs - 1) / bs - 1;
    while (e >= 0 && owned[(size_t)slot * n_t + e] == 0) --e;
    n_kv = min(n_kv, (e + 1) * bs);
  }

  for (int e = tid; e < TQ * DH; e += kThreads) {
    const int rr = e / DH, col = e - rr * DH, i = i0 + rr;
    float x = 0.f;
    if (i < rows_total) {
      const int lane = i / g, gg = i - lane * g;
      x = to_f(q[(((size_t)rw.q_off + lane) * h + kvh * g + gg) * DH + col]);
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
  // WIN: the chunk holding the lowest key the block's first lane sees, and
  // the lowest this thread's lane sees
  int c_first = 0, lo = 0;
  if constexpr (WIN) {
    c_first = max(0, q_start + i0 / g - window + 1) / KC * KC;
    lo = qpos - window + 1;
  }

  for (int c0 = c_first; c0 < n_kv; c0 += KC) {
    __syncthreads();  // the previous chunk is consumed (and q_s is staged)
    for (int e = tid; e < KC * DH; e += kThreads) {
      const int kk = e / DH, col = e - kk * DH, pos = c0 + kk;
      float kx = 0.f, vx = 0.f;
      bool own = pos < n_kv;
      if (PART && own && owned != nullptr) own = owned[(size_t)slot * n_t + pos / bs] != 0;
      if (own) {
        const int blk = tables[(size_t)slot * n_t + pos / bs];
        const size_t a = (((size_t)blk * bs + pos % bs) * kv + kvh) * DH + col;
        kx = to_f(kp[a]);
        vx = to_f(vp[a]);
      }
      k_s[kk * LD + col] = kx;
      v_s[kk * LD + col] = vx;
      if (col == 0) own_s[kk] = own;
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
      const bool valid = live && own_s[key] && pos <= qpos && pos < kv_len && (!WIN || pos >= lo);
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
      const bool valid = live && own_s[key] && pos <= qpos && pos < kv_len && (!WIN || pos >= lo);
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
    if (PART) {  // f32 partials, m already in natural units
      const size_t pi = rw.part0(w, h, kv, kvh, g) + (w ? (size_t)gg * w + my_lane : (size_t)my_lane * h + gg);
#pragma unroll
      for (int c = 0; c < NC; ++c) o_part[pi * DH + c * 4 + part] = acc[c];
      if (part == 0) {
        m_part[pi] = m;
        l_part[pi] = l;
      }
    } else {
      T* o = out + (((size_t)rw.q_off + my_lane) * h + kvh * g + gg) * DH;
      const float denom = fmaxf(l, 1e-30f);
#pragma unroll
      for (int c = 0; c < NC; ++c) o[c * 4 + part] = from_f<T>(acc[c] / denom);
    }
  }
}

template <typename T, int DH, bool PART>
__global__ void __launch_bounds__(kThreads)
mixed_prefill(const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
              const int* __restrict__ tables, const int* __restrict__ desc,
              const uint8_t* __restrict__ owned, T* __restrict__ out, float* __restrict__ o_part,
              float* __restrict__ m_part, float* __restrict__ l_part, int nr, int w, int h, int kv,
              int bs, int n_t, int n_slots, float scale) {
  mixed_prefill_body<T, DH, PART, false>(q, kp, vp, tables, desc, owned, out, o_part, m_part, l_part, nr, w, h, kv,
                                         bs, n_t, n_slots, scale, 0);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
mixed_prefill_window(const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
                     const int* __restrict__ tables, const int* __restrict__ desc, T* __restrict__ out, int nr,
                     int w, int h, int kv, int bs, int n_t, int n_slots, float scale, int window) {
  mixed_prefill_body<T, DH, false, true>(q, kp, vp, tables, desc, nullptr, out, nullptr, nullptr, nullptr, nr, w, h,
                                         kv, bs, n_t, n_slots, scale, window);
}

template <typename T, int DH, bool PART>
cudaError_t launch(const void* q, const void* kp, const void* vp, const int* tables,
                   const int* desc, const uint8_t* owned, void* out, float* o_part, float* m_part,
                   float* l_part, int r, int w, int n, int h, int kv, int bs, int n_t, int window,
                   cudaStream_t st) {
  const size_t smem = smem_bytes<DH>();
  const int n_slots = tile_slots(n, h / kv, r);
  const float scale = 1.0f / sqrtf((float)DH);
  if (!PART && window > 0) {
    static size_t allowed_w = 0;
    cudaError_t e = repro::allow_smem(mixed_prefill_window<T, DH>, smem, allowed_w);
    if (e != cudaSuccess) return e;
    mixed_prefill_window<T, DH><<<n_slots * kv, kThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp), tables, desc,
        static_cast<T*>(out), r, w, h, kv, bs, n_t, n_slots, scale, window);
    return cudaGetLastError();
  }
  static size_t allowed = 0;
  cudaError_t e = repro::allow_smem(mixed_prefill<T, DH, PART>, smem, allowed);
  if (e != cudaSuccess) return e;
  mixed_prefill<T, DH, PART><<<n_slots * kv, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp), tables,
      desc, owned, static_cast<T*>(out), o_part, m_part, l_part, r, w, h, kv, bs, n_t, n_slots, scale);
  return cudaGetLastError();
}

template <bool PART>
cudaError_t dispatch(const void* q, const void* kp, const void* vp, const void* tables,
                     const void* desc, const void* owned, void* out, void* o_part, void* m_part,
                     void* l_part, int r, int w, int n, int h, int kv, int dh, int bs, int n_t,
                     int window, int is_bf16, cudaStream_t st) {
  const int* tb = static_cast<const int*>(tables);
  const int* ds = static_cast<const int*>(desc);
  const uint8_t* ow = static_cast<const uint8_t*>(owned);
  float* op = static_cast<float*>(o_part);
  float* mp = static_cast<float*>(m_part);
  float* lp = static_cast<float*>(l_part);
  return repro::with_head_dim(dh, [&](auto d) {
    constexpr int DH = decltype(d)::value;
    return is_bf16
               ? launch_bf16<DH, PART>(q, kp, vp, tb, ds, ow, out, op, mp, lp, r, w, n, h, kv, bs, n_t, window, st)
               : launch<float, DH, PART>(q, kp, vp, tb, ds, ow, out, op, mp, lp, r, w, n, h, kv, bs, n_t, window, st);
  });
}

}  // namespace

// Packed (w == 0): q (n, h, dh), desc (r, 5) int32, out (n, h, dh), of
// which only the rows' lanes are written.  Padded (w > 0): q (r, w, h,
// dh), desc (r, 4) int32, out (r, w, h, dh), n = r * w.  k_pool / v_pool
// (n_pool, bs, kv, dh); tables (B, n_t) int32.  q, pools and out share one
// dtype (f32 or bf16).  dh in {16, 32, 64, 128}.  bf16: q and the pools
// 16-byte aligned (the 16-byte copies).  window > 0: a lane sees its own
// key and the window - 1 before it (the windowed kernels); 0: no window.
extern "C" int mixed_prefill_launch(const void* q, const void* kp, const void* vp,
                                    const void* tables, const void* desc, void* out, int r,
                                    int w, int n, int h, int kv, int dh, int bs, int n_t,
                                    int window, int is_bf16, void* stream) {
  if (window < 0) return (int)cudaErrorInvalidValue;
  return (int)dispatch<false>(q, kp, vp, tables, desc, nullptr, out, nullptr, nullptr, nullptr, r, w,
                              n, h, kv, dh, bs, n_t, window, is_bf16, static_cast<cudaStream_t>(stream));
}

// The partials form: as mixed_prefill_launch, with owned (B, n_t) uint8
// (0: the block is not this shard's; null: every block is) and, in place
// of out, o (n, kv, h / kv, dh), m and l (n, kv, h / kv) packed, or o (r,
// kv, h / kv, w, dh), m and l (r, kv, h / kv, w) padded, all f32.
extern "C" int mixed_prefill_partials_launch(const void* q, const void* kp, const void* vp,
                                             const void* tables, const void* desc,
                                             const void* owned, void* o, void* m, void* l, int r,
                                             int w, int n, int h, int kv, int dh, int bs, int n_t,
                                             int is_bf16, void* stream) {
  return (int)dispatch<true>(q, kp, vp, tables, desc, owned, nullptr, o, m, l, r, w, n, h, kv, dh, bs,
                             n_t, 0, is_bf16, static_cast<cudaStream_t>(stream));
}
