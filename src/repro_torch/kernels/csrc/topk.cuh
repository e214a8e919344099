// Deduplicated top-k shared by the port's verification kernels
// (fused_verify.cu, sketch_prefilter.cu, fused_verify_grouped.cu).
//
// Order: scores descending, ties to the smallest id. Invalid entries are
// (-inf, kIdSentinel) and sort last. Duplicates of one id always carry
// bit-identical scores (they are the same row scored the same way), so
// after the sort they sit next to each other and a ballot/popc scan keeps
// the first of each run. The result equals the JAX package's selection
// loop (select the max, smallest id among ties, kill every copy).
//
// chunk_topk is the skeleton of the per-query kernels (fused_verify,
// sketch_prefilter). A query's C candidates are cut into contiguous chunks,
// one block each (the wrapper's split_candidates). A block
//   1. inserts its chunk's valid (row, out id) pairs into a hash set in
//      shared memory, so each distinct pair's row is loaded and scored once
//      (LIDER's out ids are a function of the row, so that is once per
//      distinct row);
//   2. stages the pairs scoring at or above the current k-th score and
//      merges (a bitonic sort of the occupied part of the merge buffer)
//      only when the staging area is full, and once at the chunk's end;
//   3. writes its partial top-k to a workspace; the last block of the query
//      to finish (a __threadfence and an atomic counter) merges the
//      partial lists into the answer.
// This is exact: every row's score is one fixed-order computation whatever
// block makes it, and the top-k of a union is the top-k of its parts'
// top-ks (dedup by out id keeps one copy of equal (score, id) entries).
//
// Up to kMaxSmemK, a query's top-k is merged in shared memory. Above it (the
// large-k path, chunk_topk<true>) a chunk keeps all its distinct valid
// entries (at most a chunk, so its buffers stay the size of k = chunk), and
// the last block merges the partial lists in global memory, one at a time,
// with a merge path split over the block (merge_lists_global).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace topk {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kIdSentinel = 0x7fffffff;  // invalid entries sort last
constexpr int kMaxChunk = 4096;  // candidates per block (fused_verify.py MAX_CHUNK)
constexpr int kMaxSmemK = 4096;  // above it, the large-k path (fused_verify.py MAX_SMEM_K)
constexpr unsigned long long kKeySentinel = ~0ull;  // an empty slot

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ bool before(float sa, int ia, float sb, int ib) {
  return sa > sb || (sa == sb && ia < ib);
}

__host__ __device__ inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Merge buffer length of chunk_topk: a power of two >= 2k and >= k +
// kThreads, so the room left after a merge (s - k) takes a whole partial
// list of k entries and a pass of kThreads candidates.
__host__ __device__ inline int merge_size(int k) {
  const int need = 2 * k > k + kThreads ? 2 * k : k + kThreads;
  return pow2_at_least(need);
}

__device__ __forceinline__ void fill_invalid(float* sc, int* id, int lo, int hi) {
  for (int i = lo + threadIdx.x; i < hi; i += kThreads) {
    sc[i] = neg_inf();
    id[i] = kIdSentinel;
  }
}

// Takes one slot of a shared counter for each lane of the warp with flag
// set, with one atomic for the warp; returns this lane's slot. Called by
// every lane of the warp.
__device__ __forceinline__ int warp_reserve(bool flag, int* counter) {
  const int lane = threadIdx.x & 31;
  const unsigned m = __ballot_sync(0xffffffffu, flag);
  int base = 0;
  if (lane == 0 && m) base = atomicAdd(counter, __popc(m));
  base = __shfl_sync(0xffffffffu, base, 0);
  return base + __popc(m & ((1u << lane) - 1u));
}

// Sorts w[0, s) (s a power of two) on (score desc, id asc), then writes the
// first k distinct valid ids, in order, to o[0, k), with (-inf, sentinel)
// past them, and returns how many it wrote. o may be w itself: a tile's
// entries are read before any of them is written, and position p only ever
// receives the p-th kept entry, whose index is >= p. Called by every
// thread of the block; returns synchronised.
__device__ int sort_compact(float* w_sc, int* w_id, int s, float* o_sc,
                             int* o_id, int k, int* warp_tot) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // Pair i of a stage with stride <= 32 lies in the 64 entries [64 (i /
  // 32), 64 (i / 32) + 64), which the warp owning pair i also owns in
  // every other such stage: between two of them a warp barrier suffices.
  for (int size = 2; size <= s; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < (s >> 1); i += kThreads) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const float slo = w_sc[lo], shi = w_sc[hi];
        const int ilo = w_id[lo], ihi = w_id[hi];
        const bool up = (lo & size) == 0;
        const bool swap = up ? before(shi, ihi, slo, ilo)
                             : before(slo, ilo, shi, ihi);
        if (swap) {
          w_sc[lo] = shi;
          w_sc[hi] = slo;
          w_id[lo] = ihi;
          w_id[hi] = ilo;
        }
      }
      const int next = stride > 1 ? stride >> 1 : size;  // the next stage's stride
      if (stride > 32 || next > 32)
        __syncthreads();
      else
        __syncwarp();
    }
  }
  __syncthreads();  // the compaction reads across warps

  int base = 0;
  for (int i0 = 0; i0 < s && base < k; i0 += kThreads) {
    const int i = i0 + tid;
    bool flag = false;
    float sc = neg_inf();
    int id = kIdSentinel;
    if (i < s) {
      sc = w_sc[i];
      id = w_id[i];
      flag = sc != neg_inf() && (i == 0 || w_id[i - 1] != id);
    }
    const unsigned m = __ballot_sync(0xffffffffu, flag);
    if (lane == 0) warp_tot[warp] = __popc(m);
    __syncthreads();
    int off = 0, tot = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int cnt = warp_tot[w];
      off += w < warp ? cnt : 0;
      tot += cnt;
    }
    const int pos = base + off + __popc(m & ((1u << lane) - 1u));
    if (flag && pos < k) {
      o_sc[pos] = sc;
      o_id[pos] = id;
    }
    base += tot;
    __syncthreads();
  }
  fill_invalid(o_sc, o_id, base < k ? base : k, k);
  __syncthreads();
  return base < k ? base : k;
}

// Writes a k-entry accumulator out: ids of -inf slots become -1.
__device__ __forceinline__ void write_out(const float* a_sc, const int* a_id,
                                          int k, int* ids_out,
                                          float* scores_out) {
  for (int i = threadIdx.x; i < k; i += kThreads) {
    const float sc = a_sc[i];
    scores_out[i] = sc;
    ids_out[i] = sc == neg_inf() ? -1 : a_id[i];
  }
}

// Writes the first n entries of a list and (-1, -inf) from n to k.
__device__ __forceinline__ void write_padded(const float* a_sc, const int* a_id,
                                             int n, int k, int* ids_out,
                                             float* scores_out) {
  for (int i = threadIdx.x; i < k; i += kThreads) {
    const float sc = i < n ? a_sc[i] : neg_inf();
    scores_out[i] = sc;
    ids_out[i] = sc == neg_inf() ? -1 : a_id[i];
  }
}

// Exclusive prefix sum of v over the block (every thread calls it); *total
// receives the sum. Returns synchronised.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_tot, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  int base = 0, tot = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = warp_tot[w];
    base += w < warp ? c : 0;
    tot += c;
  }
  __syncthreads();
  *total = tot;
  return base + x - v;
}

// A scored slot of the hash set: the score's bits over the out id.
__device__ __forceinline__ unsigned long long scored_key(float sc,
                                                         unsigned long long key) {
  return (static_cast<unsigned long long>(__float_as_uint(sc)) << 32) |
         (key & 0xffffffffull);
}

// Global memory of a multi-chunk call: per query, n_chunks partial lists
// of `len` (score, id) entries (len = k, or the chunk on the large-k path),
// their lengths, the arrival counter (zero before the launch) and, on the
// large-k path, a k-entry list the final merge alternates with the output.
struct Workspace {
  float* sc;     // (B, n_chunks, len)
  int* id;       // (B, n_chunks, len)
  int* n;        // (B, n_chunks)
  int* arrive;   // (B,)
  float* x_sc;   // (B, k), large-k path only
  int* x_id;     // (B, k), large-k path only
};

// Length of a chunk's partial list: k, or on the large-k path the chunk
// (which holds all its distinct entries) when that is shorter.
__host__ __device__ inline int list_len(int k, int chunk) {
  return k > kMaxSmemK && chunk < k ? chunk : k;
}

// The workspace laid out in one buffer of B * n_chunks * (2 len + 1) 32-bit
// words, len = list_len(k, chunk), then 2 B k on the large-k path (null
// when n_chunks == 1).
inline Workspace workspace(void* base, int* arrive, int b, int n_chunks, int chunk, int k) {
  if (base == nullptr) return Workspace{nullptr, nullptr, nullptr, arrive, nullptr, nullptr};
  const bool large = k > kMaxSmemK;
  const size_t lists = static_cast<size_t>(b) * n_chunks * list_len(k, chunk);
  float* sc = static_cast<float*>(base);
  int* id = reinterpret_cast<int*>(sc + lists);
  int* n = id + lists;
  float* x_sc = large ? reinterpret_cast<float*>(n + static_cast<size_t>(b) * n_chunks) : nullptr;
  int* x_id = large ? reinterpret_cast<int*>(x_sc + static_cast<size_t>(b) * k) : nullptr;
  return Workspace{sc, id, n, arrive, x_sc, x_id};
}

// How many entries of sorted list a come before position d of the merge of
// a and b (both sorted on (score desc, id asc); a wins ties).
__device__ __forceinline__ int merge_split(const float* a_sc, const int* a_id, int na,
                                           const float* b_sc, const int* b_id, int nb,
                                           int d) {
  int lo = d - nb > 0 ? d - nb : 0;
  int hi = d < na ? d : na;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int j = d - 1 - mid;
    if (before(__ldcg(b_sc + j), __ldcg(b_id + j), __ldcg(a_sc + mid), __ldcg(a_id + mid)))
      hi = mid;
    else
      lo = mid + 1;
  }
  return lo;
}

// The large-k final merge, by the last block of query b: the n_chunks
// partial lists in the workspace (each sorted and deduplicated) are merged
// into an accumulator one list at a time, acc = the first k distinct
// entries of merge(acc, list). Each round cuts the merged sequence into
// equal runs, one a thread (merge_split); a thread walks its run twice,
// counting then writing the entries whose id differs from the one before
// (equal ids carry equal scores, so their copies are adjacent), at offsets
// from a block scan. The accumulator alternates between the workspace's x
// list and the output, so that the last round writes the output. Lists
// written by other blocks, or by this one, are read through L2 (__ldcg).
__device__ void merge_lists_global(const Workspace& ws, long long b, int n_chunks,
                                   int len, int k, int* ids_out, float* scores_out,
                                   int* warp_tot) {
  const int tid = threadIdx.x;
  const long long q0 = b * n_chunks;
  float* x_sc = ws.x_sc + b * k;
  int* x_id = ws.x_id + b * k;
  int na = 0;
  const float* a_sc = x_sc;
  const int* a_id = x_id;
  for (int p = 0; p < n_chunks; ++p) {
    const bool to_out = ((n_chunks - 1 - p) & 1) == 0;
    float* d_sc = to_out ? scores_out : x_sc;
    int* d_id = to_out ? ids_out : x_id;
    const float* b_sc = ws.sc + (q0 + p) * len;
    const int* b_id = ws.id + (q0 + p) * len;
    const int nb = __ldcg(ws.n + q0 + p);
    const int total = na + nb;
    const int per = (total + kThreads - 1) / kThreads;
    const int d0 = tid * per < total ? tid * per : total;
    const int d1 = d0 + per < total ? d0 + per : total;
    const int a0 = merge_split(a_sc, a_id, na, b_sc, b_id, nb, d0);
    const int b0 = d0 - a0;
    // The id of merged entry d0 - 1: the later of a[a0 - 1] and b[b0 - 1].
    int prev = -1;
    if (a0 > 0 && b0 > 0) {
      const bool b_first = before(__ldcg(b_sc + b0 - 1), __ldcg(b_id + b0 - 1),
                                  __ldcg(a_sc + a0 - 1), __ldcg(a_id + a0 - 1));
      prev = b_first ? __ldcg(a_id + a0 - 1) : __ldcg(b_id + b0 - 1);
    } else if (a0 > 0) {
      prev = __ldcg(a_id + a0 - 1);
    } else if (b0 > 0) {
      prev = __ldcg(b_id + b0 - 1);
    }
    // Walks the run [d0, d1), calling emit(pos, sc, id) for each kept
    // entry (pos counts kept entries from 0); returns the count.
    auto walk = [&](auto emit) {
      int i = a0, j = b0, last = prev, kept = 0;
      for (int d = d0; d < d1; ++d) {
        float sc;
        int id;
        const bool take_a =
            i < na && (j >= nb || !before(__ldcg(b_sc + j), __ldcg(b_id + j),
                                          __ldcg(a_sc + i), __ldcg(a_id + i)));
        if (take_a) {
          sc = __ldcg(a_sc + i);
          id = __ldcg(a_id + i);
          ++i;
        } else {
          sc = __ldcg(b_sc + j);
          id = __ldcg(b_id + j);
          ++j;
        }
        if (id != last) emit(kept++, sc, id);
        last = id;
      }
      return kept;
    };
    const int mine = walk([](int, float, int) {});
    int n_kept;
    const int off = block_exclusive_scan(mine, warp_tot, &n_kept);
    if (off < k)
      walk([&](int pos, float sc, int id) {
        if (off + pos < k) {
          d_sc[off + pos] = sc;
          d_id[off + pos] = id;
        }
      });
    na = n_kept < k ? n_kept : k;
    a_sc = d_sc;
    a_id = d_id;
    __syncthreads();
  }
  for (int i = na + tid; i < k; i += kThreads) {
    scores_out[i] = neg_inf();
    ids_out[i] = -1;
  }
}

// Slots of chunk_topk's hash set: a power of two >= twice the chunk (at
// least 32), so a chunk of up to 2,048 candidates fills at most half of
// it; at most kMaxChunk, which still holds any chunk. A chunk of 2,049 to
// 4,096 mostly distinct rows fills it to nearly 100%, which double hashing
// (chunk_topk) keeps at a few probes a key on average.
__host__ __device__ inline int table_size(int chunk) {
  const int n = pow2_at_least(2 * chunk > 32 ? 2 * chunk : 32);
  return n < kMaxChunk ? n : kMaxChunk;
}

// Bytes of the hash set (8 a slot) and the occupied slots' indices (2 a
// slot, rounded to 16).
__host__ __device__ inline size_t table_bytes(int n_tab) {
  return 8 * static_cast<size_t>(n_tab) + ((2 * static_cast<size_t>(n_tab) + 15) & ~static_cast<size_t>(15));
}

// Shared memory of chunk_topk past the caller's own: the hash set and its
// occupied slots, then the merge buffer (merge_size(k) scores and ids).
inline size_t chunk_topk_smem(int k, int chunk) {
  return table_bytes(table_size(chunk)) + 8 * static_cast<size_t>(merge_size(k));
}

// One chunk of one query row: candidates [part * chunk, min(C, (part + 1)
// * chunk)) of rid_row / oid_row. Called by every thread of the block.
//
// score_rows(keys, heads, n_heads) scores the chunk's distinct pairs: slot
// heads[h] holds key = row << 32 | out id, and becomes scored_key(score,
// key). It returns without synchronising.
//
// Row ids are clamped into [0, n_rows), as a JAX gather clamps; a pair
// whose out id is < 0 never enters (its row is never loaded).
//
// LARGE (k_out > kMaxSmemK): a chunk's list is cut at min(k_out, chunk),
// which keeps every distinct entry of the chunk, and the final merge runs
// in global memory (merge_lists_global).
template <bool LARGE, class ScoreRows>
__device__ void chunk_topk(const int* __restrict__ rid_row,
                           const int* __restrict__ oid_row, long long n_rows,
                           int c, int chunk, int part, int n_chunks, int k_out,
                           unsigned char* buf, ScoreRows& score_rows,
                           int* ids_out, float* scores_out, Workspace ws,
                           long long b) {
  __shared__ int warp_tot[kWarps];
  __shared__ int last_block, n_heads_s, cnt_s;
  const int k = LARGE ? (k_out < chunk ? k_out : chunk) : k_out;  // a chunk's list
  const int tid = threadIdx.x;
  const int j0 = part * chunk;
  int len = c - j0 < chunk ? c - j0 : chunk;
  len = len > 0 ? len : 0;
  const int n_tab = table_size(chunk);
  const int log_tab = __ffs(n_tab) - 1;
  const int s = merge_size(k);
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(buf);
  unsigned short* heads = reinterpret_cast<unsigned short*>(keys + n_tab);
  float* w_sc = reinterpret_cast<float*>(buf + table_bytes(n_tab));
  int* w_id = reinterpret_cast<int*>(w_sc + s);

  // 1. The chunk's valid (row << 32 | out id) keys, each once, in an
  // open-addressing hash set. The first slot is a multiplicative
  // (Fibonacci) hash of the row, which spreads a cluster's contiguous rows
  // evenly over the table; the probe step is a second hash of the row,
  // made odd, so it visits every slot of the power-of-two table. A step of
  // 1 (linear probing) lets occupied slots merge into long runs that every
  // later key walks past, which at the ~97% load of a chunk of 4,000
  // distinct rows costs more than the rows' loads; double hashing keeps
  // the walk to a few slots on average.
  for (int t = tid; t < n_tab; t += kThreads) keys[t] = kKeySentinel;
  fill_invalid(w_sc, w_id, 0, s);
  if (tid == 0) n_heads_s = cnt_s = 0;
  __syncthreads();
  constexpr int kIdsInFlight = 4;  // id loads issued before the inserts
  for (int t0 = tid; t0 < len; t0 += kIdsInFlight * kThreads) {
    int oid[kIdsInFlight], rid[kIdsInFlight];
#pragma unroll
    for (int u = 0; u < kIdsInFlight; ++u) {
      const int t = t0 + u * kThreads;
      oid[u] = t < len ? oid_row[j0 + t] : -1;
      rid[u] = t < len ? rid_row[j0 + t] : 0;
    }
#pragma unroll
    for (int u = 0; u < kIdsInFlight; ++u) {
      if (oid[u] < 0) continue;
      const long long r0 = rid[u];
      const unsigned r = static_cast<unsigned>(r0 < 0 ? 0 : (r0 >= n_rows ? n_rows - 1 : r0));
      const unsigned long long key =
          (static_cast<unsigned long long>(r) << 32) | static_cast<unsigned>(oid[u]);
      unsigned slot = (r * 0x9e3779b1u) >> (32 - log_tab);
      const unsigned step = ((r * 0x85ebca6bu) >> (32 - log_tab)) | 1u;
      for (;;) {
        const unsigned long long old = atomicCAS(keys + slot, kKeySentinel, key);
        if (old == kKeySentinel || old == key) break;
        slot = (slot + step) & (n_tab - 1);
      }
    }
  }
  __syncthreads();

  // 2. Score each occupied slot's row once (in no set order: the result
  // does not depend on it).
  for (int i0 = 0; i0 < n_tab; i0 += kThreads) {
    const int i = i0 + tid;
    const bool head = i < n_tab && keys[i] != kKeySentinel;
    const int pos = warp_reserve(head, &n_heads_s);
    if (head) heads[pos] = static_cast<unsigned short>(i);
  }
  __syncthreads();
  const int n_heads = n_heads_s;
  score_rows(keys, heads, n_heads);
  __syncthreads();

  // 3. Staged merges. w[0, a_n) holds the sorted accumulator (at most k
  // entries), w[a_n, a_n + cnt) the staged survivors, the rest is invalid;
  // a merge sorts only the occupied power of two. a_n and cnt are the same
  // in every thread; cnt_s is cnt's shared copy, which staging bumps.
  int a_n = 0, cnt = 0;
  auto thr = [&]() { return a_n == k ? w_sc[k - 1] : neg_inf(); };
  auto merge = [&]() {
    const int n_sort = pow2_at_least(a_n + cnt);
    a_n = sort_compact(w_sc, w_id, n_sort, w_sc, w_id, k, warp_tot);
    fill_invalid(w_sc, w_id, a_n, n_sort);
    if (tid == 0) cnt_s = 0;
    __syncthreads();
    cnt = 0;
  };
  // After a pass of staging: every thread reads the new count.
  auto settle = [&]() {
    __syncthreads();
    cnt = cnt_s;
    __syncthreads();
  };
  // Candidates go in passes of at most the free staging room, so no pass
  // overflows: each candidate stages at most one entry.
  for (int i0 = 0; i0 < n_heads;) {
    if (s - a_n - cnt < n_heads - i0 && s - a_n - cnt < kThreads) merge();
    const int n = s - a_n - cnt < n_heads - i0 ? s - a_n - cnt : n_heads - i0;
    const float t = thr();
    for (int i = i0 + tid; i < i0 + n; i += kThreads) {
      const unsigned long long key = keys[heads[i]];
      const float sc = __uint_as_float(static_cast<unsigned>(key >> 32));
      if (sc >= t) {
        const int pos = a_n + atomicAdd(&cnt_s, 1);
        w_sc[pos] = sc;
        w_id[pos] = static_cast<int>(key & 0xffffffffull);
      }
    }
    settle();
    i0 += n;
  }
  if (cnt > 0) merge();

  if (n_chunks == 1) {
    if constexpr (LARGE)
      write_padded(w_sc, w_id, a_n, k_out, ids_out, scores_out);
    else
      write_out(w_sc, w_id, k, ids_out, scores_out);
    return;
  }

  // 4. The partial list, then the last block of the query merges them all.
  const long long q0 = b * n_chunks;
  float* my_sc = ws.sc + (q0 + part) * k;
  int* my_id = ws.id + (q0 + part) * k;
  for (int i = tid; i < a_n; i += kThreads) {
    my_sc[i] = w_sc[i];
    my_id[i] = w_id[i];
  }
  if (tid == 0) ws.n[q0 + part] = a_n;
  __threadfence();
  __syncthreads();
  if (tid == 0) last_block = atomicAdd(ws.arrive + b, 1) == n_chunks - 1;
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  if constexpr (LARGE) {
    merge_lists_global(ws, b, n_chunks, k, k_out, ids_out, scores_out, warp_tot);
    return;
  }

  // Each partial list (at most k <= s - k entries) is staged in one pass,
  // after a merge if the room is short. The lists are sorted: a thread
  // stops at its first entry below the k-th score.
  for (int p = 0; p < n_chunks; ++p) {
    if (p == part) continue;
    const int m = __ldcg(ws.n + q0 + p);
    if (s - a_n - cnt < m) merge();
    const float t = thr();
    const float* p_sc = ws.sc + (q0 + p) * k;
    const int* p_id = ws.id + (q0 + p) * k;
    for (int i = tid; i < m; i += kThreads) {
      const float sc = __ldcg(p_sc + i);
      if (sc < t) break;
      const int pos = a_n + atomicAdd(&cnt_s, 1);
      w_sc[pos] = sc;
      w_id[pos] = __ldcg(p_id + i);
    }
    settle();
  }
  if (cnt > 0) merge();
  write_out(w_sc, w_id, k, ids_out, scores_out);
}

// Sets the dynamic shared memory limit of a kernel when it needs more than
// the default 48 KB; returns the CUDA error, if any.
template <class Kernel>
cudaError_t allow_smem(Kernel kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace topk
