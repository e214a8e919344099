// Deduplicated top-k merge shared by the port's verification kernels
// (fused_verify.cu, sketch_prefilter.cu, fused_verify_grouped.cu).
//
// Order: scores descending, ties to the smallest id. Invalid entries are
// (-inf, kIdSentinel) and sort last. Duplicates of one id always carry
// bit-identical scores (they are the same row scored the same way), so
// after the sort they sit next to each other and a ballot/popc scan keeps
// the first of each run. The result equals the JAX package's selection
// loop (select the max, smallest id among ties, kill every copy).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace topk {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kIdSentinel = 0x7fffffff;  // invalid entries sort last

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ bool before(float sa, int ia, float sb, int ib) {
  return sa > sb || (sa == sb && ia < ib);
}

// Merge buffer length: a power of two >= 2k (and >= 256), so a tile of
// s - k >= k candidates merges into the k-entry accumulator at once.
__host__ __device__ inline int merge_size(int k) {
  int s = 256;
  while (s < 2 * k) s <<= 1;
  return s;
}

__device__ __forceinline__ void fill_invalid(float* sc, int* id, int lo, int hi) {
  for (int i = lo + threadIdx.x; i < hi; i += kThreads) {
    sc[i] = neg_inf();
    id[i] = kIdSentinel;
  }
}

// Sorts w[0, s) (s a power of two) on (score desc, id asc), then writes the
// first k distinct valid ids, in order, to o[0, k), with (-inf, sentinel)
// past them. o must not overlap w. Called by every thread of the block;
// returns synchronised.
__device__ void sort_compact(float* w_sc, int* w_id, int s, float* o_sc,
                             int* o_id, int k, int* warp_tot) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
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
      __syncthreads();
    }
  }

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

// Shared memory the per-query skeleton below needs past the caller's own:
// a_sc[s] | a_id[s] | b_sc[s] | b_id[s] | t_row[s-k] | t_oid[s-k].
inline size_t query_topk_smem(int k) {
  const int s = merge_size(k);
  return 4 * sizeof(float) * s + 2 * sizeof(int) * (s - k);
}

// One query row's streaming top-k over its C candidates: the grid step loop
// of the TPU kernels, run inside one block.
//
// Candidates go in tiles of T = s - k. A tile whose candidates are all
// invalid (out_id < 0) is skipped: no loads, no merge. Otherwise
// score_tile(t_row, t_oid, T, thr, sc, id) scores the tile into the merge
// buffer's upper part and returns nonzero on threads that kept a candidate
// (a candidate scoring below thr, the current k-th score, can never enter
// and is written as (-inf, sentinel)); a tile where nothing survived is not
// merged. Row ids are clamped into [0, n_rows), as a JAX gather clamps.
template <class ScoreTile>
__device__ void query_topk(const int* __restrict__ rid_row,
                           const int* __restrict__ oid_row, long long n_rows,
                           int c, int k, unsigned char* buf,
                           ScoreTile& score_tile, int* ids_out,
                           float* scores_out) {
  __shared__ int warp_tot[kWarps];
  const int s = merge_size(k);
  const int t_len = s - k;
  float* a_sc = reinterpret_cast<float*>(buf);
  int* a_id = reinterpret_cast<int*>(a_sc + s);
  float* b_sc = reinterpret_cast<float*>(a_id + s);
  int* b_id = reinterpret_cast<int*>(b_sc + s);
  int* t_row = b_id + s;
  int* t_oid = t_row + t_len;
  const int tid = threadIdx.x;

  fill_invalid(a_sc, a_id, 0, s);
  __syncthreads();

  for (int c0 = 0; c0 < c; c0 += t_len) {
    int any_valid = 0;
    for (int t = tid; t < t_len; t += kThreads) {
      const int j = c0 + t;
      int oid = -1, rid = 0;
      if (j < c) {
        oid = oid_row[j];
        rid = rid_row[j];
      }
      rid = rid < 0 ? 0 : rid;
      rid = rid >= n_rows ? static_cast<int>(n_rows - 1) : rid;
      t_row[t] = rid;
      t_oid[t] = oid;
      any_valid |= oid >= 0;
    }
    if (!__syncthreads_or(any_valid)) continue;

    const float thr = a_sc[k - 1];
    const int survived = score_tile(t_row, t_oid, t_len, thr, a_sc + k, a_id + k);
    if (!__syncthreads_or(survived)) continue;

    sort_compact(a_sc, a_id, s, b_sc, b_id, k, warp_tot);
    float* tf = a_sc;
    a_sc = b_sc;
    b_sc = tf;
    int* ti = a_id;
    a_id = b_id;
    b_id = ti;
  }
  write_out(a_sc, a_id, k, ids_out, scores_out);
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
