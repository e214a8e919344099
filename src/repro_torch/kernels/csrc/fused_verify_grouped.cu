// fused_verify_grouped: the cluster-major first pass. Each schedule step
// scores one cluster's code rows against a tile of block_q query codes and
// keeps a deduplicated top-k' per (step, slot).
//
// Replaces the TPU kernel repro/kernels/fused_verify.py::fused_verify_grouped
// (_fused_verify_grouped_kernel).
//
// Contract, for each step s:
//   * the cluster is sched_cids[s] (clamped to [0, c)); slot j serves query
//     sched_qids[s, j] (-1: an empty slot, query scale 1.0);
//   * row r of the cluster is a candidate of slot j iff
//     step_slot_ids[s, j, r] >= 0, and that value is the id it reports and
//     dedups by;
//   * score = float(int32 dot of the int8 query codes and the row's int8 or
//     packed-int4 codes) * (q_scale[j] * row_scale[r]), bit-identical to the
//     plain version (f32 multiplication commutes, so this equals the
//     per-query kernel's row_scale * q_scale);
//   * per (step, slot): the top-k' deduplicated by id, scores descending,
//     ties to the smallest id, (-1, -inf) past the unique valid count;
//   * a step whose slots are all empty (schedule padding) writes padding and
//     loads nothing; a row that no slot has as a candidate is not loaded.
//
// What bounds it on an H100: bytes. A step reads its cluster's live rows
// (d bytes of codes a row, half that for int4, and a scale) and its
// (block_q, Lp) id tile; scoring costs 2 * d * block_q operations a row,
// far below the card's balance. Two kernels, one after the other on the
// stream:
//   1. fused_verify_grouped_score_kernel, one block per (step, group of up
//      to 32 slots). It lists the rows that some slot of the group has as a
//      candidate (one pass over the group's ids, all loads in flight at
//      once), then streams those rows, 32 at a time, through a ring of
//      three shared-memory stages with cp.async (16-byte copies of each
//      contiguous row and its scale; one block barrier a tile of 32 rows),
//      and scores each tile against the group's query codes on the
//      tensor cores: mma.sync m16n8k32 s8 x s8 -> s32 with rows as M, slots
//      as N and d as K, exact in any order as __dp4a was (int4 nibbles are
//      unpacked in registers; the query codes are staged in the unpacked
//      order). Rows of more than 1,024 code bytes go through the ring in
//      pieces of 1,024. The scores go to a (S, block_q, Lp) float32 scratch.
//   2. fused_verify_grouped_select_kernel, one block per (step, slot). It
//      gathers the slot's candidates and their scores into shared memory
//      with a histogram of the scores, keeps the highest bins that hold k'
//      of them, and sorts those once (topk.cuh's sort_compact), keeping the
//      first k' distinct: slots select in parallel, with no repeated
//      merges.
// Shared memory grows with neither block_q nor k': the score kernel holds
// one group's query codes and the ring; the select kernel next_pow2(Lp)
// (score, id) entries, which caps Lp at kMaxLp = 16,384 (128 KB).

#include "topk.cuh"

namespace {

using topk::kThreads;
using topk::kWarps;
constexpr int kMaxGroup = 32;    // query slots of a score block (4 mma N tiles)
constexpr int kTileRows = 32;    // cluster rows a ring stage holds (2 mma M tiles)
constexpr int kStages = 3;       // ring depth: two tiles in flight while one is scored
constexpr int kMaxKChunk = 1024; // logical code bytes of a row a ring stage holds
constexpr int kMaxLp = 16384;    // select kernel: next_pow2(Lp) entries in shared memory

// The four signed low (lo4) or high (hi4) nibbles of a word as int8 lanes.
__device__ __forceinline__ unsigned lo4(unsigned w) {
  return __vsub4((w & 0x0f0f0f0fu) ^ 0x08080808u, 0x08080808u);
}
__device__ __forceinline__ unsigned hi4(unsigned w) {
  return __vsub4(((w >> 4) & 0x0f0f0f0fu) ^ 0x08080808u, 0x08080808u);
}

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

struct Layout {
  int k_log;       // logical code bytes of a row the mma covers: d rounded up to 64
  int k_chunk;     // logical bytes of a row in one ring stage (a multiple of 64)
  int n_chunks;    // ring stages per tile
  int q_stride;    // bytes between staged query rows, = 64 mod 128
  int row_stride;  // bytes between staged rows: = 64 mod 128 (int8, 16-byte
                   // reads) or 32 mod 128 (packed int4, 8-byte reads)
};

__host__ __device__ inline Layout layout(int d_store, bool int4, int lp) {
  Layout l;
  const int d_log = int4 ? 2 * d_store : d_store;
  l.k_log = round_up(d_log, 64);
  l.k_chunk = l.k_log < kMaxKChunk ? l.k_log : kMaxKChunk;
  l.n_chunks = (l.k_log + l.k_chunk - 1) / l.k_chunk;
  l.q_stride = round_up(l.k_log, 128) + 64;
  l.row_stride = int4 ? round_up(l.k_chunk / 2, 128) + 32 : round_up(l.k_chunk, 128) + 64;
  return l;
}

// A ring stage: kTileRows rows, then their kTileRows scales.
__host__ __device__ inline int stage_bytes(const Layout& l) {
  return kTileRows * l.row_stride + 4 * kTileRows;
}

// Score kernel shared memory: `group` staged query rows, the ring, one flag
// byte a row and the list of live rows (16-bit: Lp <= kMaxLp).
inline size_t score_smem(const Layout& l, int group, int lp) {
  return static_cast<size_t>(group) * l.q_stride + static_cast<size_t>(kStages) * stage_bytes(l) +
         round_up(lp, 16) + round_up(2 * lp, 16);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// (c0, c1, c2, c3) += A (16 x 32 s8, row-major fragments a0..a3) . B (32 x 8
// s8, b0, b1): c0 = (row g, slot 2t), c1 = (g, 2t + 1), c2 = (g + 8, 2t),
// c3 = (g + 8, 2t + 1) for lane (g, t).
__device__ __forceinline__ void mma_s8(int& c0, int& c1, int& c2, int& c3, unsigned a0,
                                       unsigned a1, unsigned a2, unsigned a3, unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c0), "+r"(c1), "+r"(c2), "+r"(c3)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One block per (step, slot group): blockIdx.x = step, blockIdx.y = group.
// CW: bytes per copy (16 or 4 with cp.async; 1: plain loads and stores).
//
// The mma's k order within a 64-byte step is permuted the same way in A and
// B (exact, since an int32 sum does not depend on order): lane (g, t) of a
// warp (g = lane / 4, t = lane % 4) reads 16 code bytes at offset 16 t of
// rows g and g + 8 and of query slot g, and feeds words 0-1 to one mma and
// words 2-3 to the next. For int4 it reads 8 packed bytes and unpacks each
// word to its even (lo4) and odd (hi4) elements, which is the order in
// which the query codes are staged.
template <bool INT4, int CW>
__global__ void __launch_bounds__(kThreads)
    fused_verify_grouped_score_kernel(const signed char* __restrict__ embs,
                                      const float* __restrict__ row_scales, int n_clusters,
                                      int lp, int d_store,
                                      const signed char* __restrict__ q_codes,
                                      const float* __restrict__ q_scales,
                                      const int* __restrict__ sched_cids,
                                      const int* __restrict__ sched_qids,
                                      const int* __restrict__ slot_ids, int block_q,
                                      int group, float* __restrict__ scores) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float qsc[kMaxGroup];
  __shared__ int qid_s[kMaxGroup];
  __shared__ int n_live_s;

  const Layout l = layout(d_store, INT4, lp);
  const int d_log = INT4 ? 2 * d_store : d_store;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long step = blockIdx.x;
  const int g0 = blockIdx.y * group;
  const int ng = block_q - g0 < group ? block_q - g0 : group;  // slots of this group
  const int n_nt = (ng + 7) >> 3;                               // mma N tiles
  const int* step_qids = sched_qids + step * block_q;

  int any = 0;
  for (int j = tid; j < block_q; j += kThreads) any |= step_qids[j] >= 0;
  if (!__syncthreads_or(any)) return;  // schedule padding: the select kernel pads it

  unsigned char* q_s = smem;
  unsigned char* ring = q_s + static_cast<size_t>(group) * l.q_stride;
  const int st_bytes = stage_bytes(l);
  unsigned char* flag = ring + static_cast<size_t>(kStages) * st_bytes;
  unsigned short* live = reinterpret_cast<unsigned short*>(flag + round_up(lp, 16));
  if (tid < kMaxGroup) {
    const int qid = tid < ng ? step_qids[g0 + tid] : -1;
    qid_s[tid] = qid;
    qsc[tid] = qid >= 0 ? q_scales[qid] : 1.f;
  }
  if (tid == 0) n_live_s = 0;
  for (int r = tid; r < lp; r += kThreads) flag[r] = 0;
  __syncthreads();

  // The group's query codes, zero for empty slots and past d. For int4,
  // staged word 2w holds the even elements of packed word w, 2w + 1 the odd.
  if (d_log % 16 == 0) {  // 16 bytes at a time; q_codes rows are 16-byte aligned
    const int n_vec = l.k_log / 16;
    for (int i = tid; i < group * n_vec; i += kThreads) {
      const int j = i / n_vec;
      const int v = i - j * n_vec;
      const int qid = qid_s[j];
      uint4 w = make_uint4(0u, 0u, 0u, 0u);
      if (qid >= 0 && 16 * v < d_log)
        w = __ldg(reinterpret_cast<const uint4*>(q_codes + static_cast<long long>(qid) * d_log) + v);
      if (INT4)
        w = make_uint4(__byte_perm(w.x, w.y, 0x6420), __byte_perm(w.x, w.y, 0x7531),
                       __byte_perm(w.z, w.w, 0x6420), __byte_perm(w.z, w.w, 0x7531));
      *reinterpret_cast<uint4*>(q_s + j * l.q_stride + 16 * v) = w;
    }
  } else {
    for (int i = tid; i < group * l.k_log; i += kThreads) {
      const int j = i / l.k_log;
      const int p = i - j * l.k_log;
      int e = p;
      if (INT4) {
        const int word = p >> 2;
        e = (word >> 1) * 8 + (p & 3) * 2 + (word & 1);
      }
      const int qid = qid_s[j];
      q_s[j * l.q_stride + p] =
          (qid >= 0 && e < d_log) ? q_codes[static_cast<long long>(qid) * d_log + e] : 0;
    }
  }

  // The rows that some slot of the group has as a candidate: every id load
  // of the group issued at once, 16 bytes a load where aligned.
  const int* gids = slot_ids + (step * block_q + g0) * static_cast<long long>(lp);
  const int n_ids = ng * lp;
  constexpr int kLoads = 8;
  if (lp % 4 == 0 && reinterpret_cast<uintptr_t>(gids) % 16 == 0) {
    const int4* g4 = reinterpret_cast<const int4*>(gids);
    const int n4 = n_ids / 4;
    for (int i0 = tid; i0 < n4; i0 += kLoads * kThreads) {
      int4 v[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int i = i0 + u * kThreads;
        v[u] = i < n4 ? __ldg(g4 + i) : make_int4(-1, -1, -1, -1);
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        unsigned char* f = flag + 4 * (i0 + u * kThreads) % lp;
        if (v[u].x >= 0) f[0] = 1;
        if (v[u].y >= 0) f[1] = 1;
        if (v[u].z >= 0) f[2] = 1;
        if (v[u].w >= 0) f[3] = 1;
      }
    }
  } else {
    for (int i0 = tid; i0 < n_ids; i0 += kLoads * kThreads) {
      int v[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int i = i0 + u * kThreads;
        v[u] = i < n_ids ? __ldg(gids + i) : -1;
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u)
        if (v[u] >= 0) flag[(i0 + u * kThreads) % lp] = 1;
    }
  }
  __syncthreads();
  for (int r0 = 0; r0 < lp; r0 += kThreads) {
    const int r = r0 + tid;
    const bool on = r < lp && flag[r];
    const int pos = topk::warp_reserve(on, &n_live_s);
    if (on) live[pos] = static_cast<unsigned short>(r);
  }
  __syncthreads();
  const int n_live = n_live_s;
  // (tile of kTileRows live rows, k chunk) pairs, in ring order.
  const int n_items = (n_live + kTileRows - 1) / kTileRows * l.n_chunks;

  int cid = sched_cids[step];
  cid = cid < 0 ? 0 : (cid >= n_clusters ? n_clusters - 1 : cid);
  const signed char* cluster = embs + static_cast<long long>(cid) * lp * d_store;
  const float* cluster_scales = row_scales + static_cast<long long>(cid) * lp;
  const int k_store = INT4 ? l.k_chunk / 2 : l.k_chunk;  // stored bytes of a row in a stage

  // Copies item i (a k chunk of a tile of live rows, and their scales)
  // into ring stage i % kStages.
  auto issue = [&](int i) {
    if (i < n_items) {
      const int l0 = i / l.n_chunks * kTileRows;  // the tile's first entry of `live`
      const int b0 = (i % l.n_chunks) * k_store;
      const int rows = n_live - l0 < kTileRows ? n_live - l0 : kTileRows;
      const int nb = d_store - b0 < k_store ? d_store - b0 : k_store;
      unsigned char* dst = ring + static_cast<size_t>(i % kStages) * st_bytes;
      if (tid < rows)
        cp_async4(dst + kTileRows * l.row_stride + 4 * tid, cluster_scales + live[l0 + tid]);
      const int per_row = nb / CW;
      for (int x = tid; x < rows * per_row; x += kThreads) {
        const int t = x / per_row;
        const int o = (x - t * per_row) * CW;
        const signed char* src = cluster + static_cast<long long>(live[l0 + t]) * d_store + b0 + o;
        if constexpr (CW == 16)
          cp_async16(dst + t * l.row_stride + o, src);
        else if constexpr (CW == 4)
          cp_async4(dst + t * l.row_stride + o, src);
        else
          dst[t * l.row_stride + o] = *src;
      }
    }
    cp_async_commit();
  };

  // Warps 2 nt and 2 nt + 1 own N tile nt (slots 8 nt .. 8 nt + 7 of the
  // group), rows 0-15 and 16-31 of each tile.
  const int m = warp & 1;
  const int nt = warp >> 1;
  const int g = lane >> 2;
  const int tq = lane & 3;
  int c0 = 0, c1 = 0, c2 = 0, c3 = 0;
  for (int i = 0; i < kStages - 1; ++i) issue(i);
  for (int i = 0; i < n_items; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // item i is in; every warp is done with the stage refilled next
    issue(i + kStages - 1);
    if (nt >= n_nt) continue;
    const int kc = i % l.n_chunks;
    if (kc == 0) c0 = c1 = c2 = c3 = 0;
    const unsigned char* stage = ring + static_cast<size_t>(i % kStages) * st_bytes;
    const unsigned char* a = stage + (m * 16 + g) * l.row_stride;
    const unsigned char* bq = q_s + (nt * 8 + g) * l.q_stride + kc * l.k_chunk;
    const int k_here = l.k_log - kc * l.k_chunk < l.k_chunk ? l.k_log - kc * l.k_chunk : l.k_chunk;
    for (int kb = 0; kb < k_here; kb += 64) {
      const uint4 q = *reinterpret_cast<const uint4*>(bq + kb + tq * 16);
      if constexpr (INT4) {
        const uint2 p0 = *reinterpret_cast<const uint2*>(a + kb / 2 + tq * 8);
        const uint2 p1 = *reinterpret_cast<const uint2*>(a + 8 * l.row_stride + kb / 2 + tq * 8);
        mma_s8(c0, c1, c2, c3, lo4(p0.x), lo4(p1.x), hi4(p0.x), hi4(p1.x), q.x, q.y);
        mma_s8(c0, c1, c2, c3, lo4(p0.y), lo4(p1.y), hi4(p0.y), hi4(p1.y), q.z, q.w);
      } else {
        const uint4 r0 = *reinterpret_cast<const uint4*>(a + kb + tq * 16);
        const uint4 r1 = *reinterpret_cast<const uint4*>(a + 8 * l.row_stride + kb + tq * 16);
        mma_s8(c0, c1, c2, c3, r0.x, r1.x, r0.y, r1.y, q.x, q.y);
        mma_s8(c0, c1, c2, c3, r0.z, r1.z, r0.w, r1.w, q.z, q.w);
      }
    }
    if (kc != l.n_chunks - 1) continue;
    // Tile rows 16 m + g (c0, c1) and 16 m + g + 8 (c2, c3); slots 8 nt + 2 tq + {0, 1}.
    const int e0 = i / l.n_chunks * kTileRows + m * 16 + g;  // entries of `live`
    const int e1 = e0 + 8;
    const int j = nt * 8 + 2 * tq;
    float* out = scores + (step * block_q + g0 + j) * static_cast<long long>(lp);
    const float* rs = reinterpret_cast<const float*>(stage + kTileRows * l.row_stride);
    if (e0 < n_live) {
      const int r = live[e0];
      const float rs0 = rs[m * 16 + g];
      if (j < ng) out[r] = __fmul_rn(__int2float_rn(c0), __fmul_rn(qsc[j], rs0));
      if (j + 1 < ng) out[lp + r] = __fmul_rn(__int2float_rn(c1), __fmul_rn(qsc[j + 1], rs0));
    }
    if (e1 < n_live) {
      const int r = live[e1];
      const float rs1 = rs[m * 16 + g + 8];
      if (j < ng) out[r] = __fmul_rn(__int2float_rn(c2), __fmul_rn(qsc[j], rs1));
      if (j + 1 < ng) out[lp + r] = __fmul_rn(__int2float_rn(c3), __fmul_rn(qsc[j + 1], rs1));
    }
  }
}

// The histogram bin of a score, 0 for the highest: the top 11 bits of the
// score's bits mapped to an unsigned order (-0 counts as +0, which it equals).
constexpr int kBins = 2048;
__device__ __forceinline__ int score_bin(float sc) {
  const unsigned u = __float_as_uint(sc == 0.f ? 0.f : sc);
  const unsigned key = (u & 0x80000000u) ? ~u : (u | 0x80000000u);  // ascending with sc
  return kBins - 1 - static_cast<int>(key >> 21);
}

// One block per (step, slot): blockIdx.x = step * block_q + slot. Dynamic
// shared memory: next_pow2(Lp) scores and ids.
//
// The slot's n candidates are gathered with a histogram of their scores'
// bins. When k' < n, the first bins that hold k' candidates are copied
// past the n and only they are sorted (every candidate left out scores
// below all of them), if they fit; should they hold fewer than k'
// distinct ids (copies of an id share a score, so they share a bin),
// every candidate is sorted instead.
__global__ void __launch_bounds__(kThreads)
    fused_verify_grouped_select_kernel(const float* __restrict__ scores,
                                       const int* __restrict__ sched_qids,
                                       const int* __restrict__ slot_ids, int lp, int block_q,
                                       int k, int* __restrict__ ids_out,
                                       float* __restrict__ scores_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_tot[kWarps];
  __shared__ int hist[kBins];
  __shared__ int n_s, m_s, cut_s;
  const int tid = threadIdx.x;
  const long long sj = blockIdx.x;
  const long long step = sj / block_q;
  int* out_ids = ids_out + sj * k;
  float* out_sc = scores_out + sj * k;

  int any = 0;
  for (int j = tid; j < block_q; j += kThreads) any |= sched_qids[step * block_q + j] >= 0;
  if (!__syncthreads_or(any)) {  // schedule padding
    for (int i = tid; i < k; i += kThreads) {
      out_ids[i] = -1;
      out_sc[i] = topk::neg_inf();
    }
    return;
  }

  const int cap = topk::pow2_at_least(lp);
  float* w_sc = reinterpret_cast<float*>(smem);
  int* w_id = reinterpret_cast<int*>(w_sc + cap);
  for (int b = tid; b < kBins; b += kThreads) hist[b] = 0;
  if (tid == 0) n_s = m_s = 0;
  __syncthreads();
  const int* ids = slot_ids + sj * lp;
  const float* sc = scores + sj * lp;
  constexpr int kLoads = 8;
  for (int r0 = 0; r0 < lp; r0 += kLoads * kThreads) {
    int id[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int r = r0 + u * kThreads + tid;
      id[u] = r < lp ? __ldg(ids + r) : -1;
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int pos = topk::warp_reserve(id[u] >= 0, &n_s);
      if (id[u] >= 0) {
        const float v = __ldg(sc + r0 + u * kThreads + tid);
        w_sc[pos] = v;
        w_id[pos] = id[u];
        atomicAdd(hist + score_bin(v), 1);
      }
    }
  }
  __syncthreads();
  const int n = n_s;

  int base = 0, m = n;  // the entries sorted: w[base, base + m)
  if (k < n) {
    constexpr int kPer = kBins / kThreads;
    int local = 0;
#pragma unroll
    for (int b = 0; b < kPer; ++b) local += hist[kPer * tid + b];
    int tot;
    const int before_me = topk::block_exclusive_scan(local, warp_tot, &tot);
    if (before_me < k && before_me + local >= k) {  // the bin where the count reaches k
      int run = before_me;
      for (int b = 0; b < kPer; ++b) {
        run += hist[kPer * tid + b];
        if (run >= k) {
          cut_s = kPer * tid + b;
          break;
        }
      }
    }
    __syncthreads();
    const int cut = cut_s;
    for (int i0 = 0; i0 < n; i0 += kThreads) {
      const int i = i0 + tid;
      const bool keep = i < n && score_bin(w_sc[i]) <= cut;
      const int pos = topk::warp_reserve(keep, &m_s);
      if (keep && n + pos < cap) {
        w_sc[n + pos] = w_sc[i];
        w_id[n + pos] = w_id[i];
      }
    }
    __syncthreads();
    if (n + topk::pow2_at_least(m_s) <= cap) {
      base = n;
      m = m_s;
    }
  }
  int s = topk::pow2_at_least(m > 0 ? m : 1);
  topk::fill_invalid(w_sc + base, w_id + base, m, s);
  __syncthreads();
  int kk = k < s ? k : s;
  const int got = topk::sort_compact(w_sc + base, w_id + base, s, w_sc + base, w_id + base, kk,
                                     warp_tot);
  if (base > 0 && got < kk) {  // duplicates in the kept bins: sort every candidate
    base = 0;
    s = topk::pow2_at_least(n);
    topk::fill_invalid(w_sc, w_id, n, s);
    __syncthreads();
    kk = k < s ? k : s;
    topk::sort_compact(w_sc, w_id, s, w_sc, w_id, kk, warp_tot);
  }
  topk::write_padded(w_sc + base, w_id + base, kk, k, out_ids, out_sc);
}

// The slots a score block covers: the largest multiple of 8, at most
// kMaxGroup and no more than block_q needs, whose shared memory (dynamic
// and the kernel's static) fits the device's opt-in limit a block. 0 when
// not even 8 fit (rows too wide).
template <typename Kernel>
cudaError_t choose_group(Kernel kern, const Layout& l, int lp, int block_q, int* group) {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return err;
  const size_t limit = static_cast<size_t>(optin) - attr.sharedSizeBytes;
  int g = round_up(block_q < kMaxGroup ? block_q : kMaxGroup, 8);
  while (g >= 8 && score_smem(l, g, lp) > limit) g -= 8;
  *group = g < 8 ? 0 : g;
  return cudaSuccess;
}

template <bool INT4, int CW>
cudaError_t launch_score(const signed char* embs, const float* row_scales, int n_clusters,
                         int lp, int d_store, const signed char* q_codes,
                         const float* q_scales, const int* sched_cids,
                         const int* sched_qids, const int* slot_ids, int n_steps,
                         int block_q, float* scores, cudaStream_t stream) {
  const Layout l = layout(d_store, INT4, lp);
  auto kern = fused_verify_grouped_score_kernel<INT4, CW>;
  int group = 0;
  cudaError_t err = choose_group(kern, l, lp, block_q, &group);
  if (err != cudaSuccess) return err;
  if (group == 0) return cudaErrorInvalidValue;  // rows too wide for 8 slots
  const size_t smem = score_smem(l, group, lp);
  err = topk::allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(n_steps),
                  static_cast<unsigned>((block_q + group - 1) / group));
  kern<<<grid, kThreads, smem, stream>>>(embs, row_scales, n_clusters, lp, d_store, q_codes,
                                         q_scales, sched_cids, sched_qids, slot_ids, block_q,
                                         group, scores);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes: launches the score kernel, then
// the select kernel, on `stream`. Returns the first cudaError_t (0 on
// success). The caller validates shapes, dtypes and devices; the score
// kernel's slot group is chosen here (choose_group).
//   embs (c, lp, d_store) int8 codes (int4: packed, logical width 2 d_store),
//   row_scales (c, lp) f32, q_codes (B, d) int8 + q_scales (B,) f32,
//   sched_cids (S,), sched_qids (S, block_q), slot_ids (S, block_q, lp) int32,
//   scratch (S, block_q, lp) f32 -> ids_out / scores_out (S, block_q, k).
extern "C" int fused_verify_grouped_launch(
    const signed char* embs, const float* row_scales, int n_clusters, int lp,
    int d_store, int is_int4, const signed char* q_codes,
    const float* q_scales, const int* sched_cids, const int* sched_qids,
    const int* slot_ids, int n_steps, int block_q, int k, float* scratch,
    int* ids_out, float* scores_out, void* stream) {
  if (n_steps <= 0) return 0;
  if (block_q < 1 || k < 1 || lp < 1 || lp > kMaxLp || n_clusters < 1 || d_store < 1 ||
      static_cast<long long>(n_steps) * block_q > 0x7fffffffLL ||
      static_cast<long long>(block_q) * lp > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t base = reinterpret_cast<uintptr_t>(embs);
  const int cw = d_store % 16 == 0 && base % 16 == 0 ? 16 : (d_store % 4 == 0 && base % 4 == 0 ? 4 : 1);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
#define FVG_SCORE(INT4, CW)                                                                 \
  launch_score<INT4, CW>(embs, row_scales, n_clusters, lp, d_store, q_codes, q_scales,     \
                         sched_cids, sched_qids, slot_ids, n_steps, block_q, scratch,        \
                         st)
  cudaError_t err;
  if (is_int4)
    err = cw == 16 ? FVG_SCORE(true, 16) : (cw == 4 ? FVG_SCORE(true, 4) : FVG_SCORE(true, 1));
  else
    err = cw == 16 ? FVG_SCORE(false, 16) : (cw == 4 ? FVG_SCORE(false, 4) : FVG_SCORE(false, 1));
#undef FVG_SCORE
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = 8ull * topk::pow2_at_least(lp);
  auto sel = fused_verify_grouped_select_kernel;
  err = topk::allow_smem(sel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  sel<<<static_cast<unsigned>(static_cast<long long>(n_steps) * block_q), kThreads, smem, st>>>(
      scratch, sched_qids, slot_ids, lp, block_q, k, ids_out, scores_out);
  return static_cast<int>(cudaGetLastError());
}
