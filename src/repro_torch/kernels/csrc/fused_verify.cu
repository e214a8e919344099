// fused_verify: gather candidate rows by id, score them against the query,
// and keep a deduplicated top-k, in one pass per query row.
//
// Replaces the TPU kernel repro/kernels/fused_verify.py::fused_verify
// (_fused_verify_kernel), float32 and bfloat16 table branches. The int8 and
// packed-int4 branches are not compiled here.
//
// Contract, for each query row b:
//   * gather rows row_ids[b, :] of the (N, d) table (ids clamped to [0, N));
//   * score q . row with float32 accumulation (a bfloat16 table scores
//     against the query rounded to bfloat16 first);
//   * candidates with out_ids < 0 score -inf and are never loaded;
//   * keep the top-k deduplicated by out_ids: scores descending, ties to the
//     smallest id, (-1, -inf) past the number of unique valid ids;
//   * a tile whose candidates are all invalid is skipped: no loads, no merge.
//
// What bounds it on an H100: bytes. Each candidate costs 2*d flops against
// d*4 (f32) or d*2 (bf16) bytes of row, far below the card's
// flops-per-byte balance, so the floor is reading each distinct candidate
// row once plus the (B, C) id arrays. The design for that floor:
//   * 16-byte vector loads (float4 / 8 x bf16) through the read-only path,
//     one warp per row, U rows in flight per warp to hide latency;
//   * invalid candidates and rows whose score falls below the current k-th
//     score never enter the merge, so after warm-up most tiles cost only
//     their loads;
//   * offsets into the table are 64-bit: a 1M x 768 table has element
//     offsets past 2^31.
// Duplicate ids are still loaded once per occurrence (the L2 cache absorbs
// most of the repeats); loading each distinct row once is later work.
//
// Merge: the accumulator (k entries, sorted) and a tile of T = S - k scored
// candidates share one shared-memory buffer of S = 2^m entries. A bitonic
// sort on (score desc, id asc) puts duplicates of one id next to each other
// (they are the same row, so their scores are bit-identical), and a
// ballot/popc compaction keeps the first k distinct ids.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 4;  // rows in flight per warp
constexpr int kIdSentinel = 0x7fffffff;  // invalid entries sort last

__device__ __forceinline__ bool before(float sa, int ia, float sb, int ib) {
  return sa > sb || (sa == sb && ia < ib);
}

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// Dot product of one 16-byte chunk of a row with the matching query slice.
template <bool BF16>
__device__ __forceinline__ float dot16(const void* row, int v, const float* q);

template <>
__device__ __forceinline__ float dot16<false>(const void* row, int v,
                                              const float* q) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(row) + v);
  const float4 y = reinterpret_cast<const float4*>(q)[v];
  float s = x.x * y.x;
  s = fmaf(x.y, y.y, s);
  s = fmaf(x.z, y.z, s);
  s = fmaf(x.w, y.w, s);
  return s;
}

template <>
__device__ __forceinline__ float dot16<true>(const void* row, int v,
                                             const float* q) {
  const uint4 x = __ldg(reinterpret_cast<const uint4*>(row) + v);
  const float4 y0 = reinterpret_cast<const float4*>(q)[2 * v];
  const float4 y1 = reinterpret_cast<const float4*>(q)[2 * v + 1];
  float s = bf16_lo(x.x) * y0.x;
  s = fmaf(bf16_hi(x.x), y0.y, s);
  s = fmaf(bf16_lo(x.y), y0.z, s);
  s = fmaf(bf16_hi(x.y), y0.w, s);
  s = fmaf(bf16_lo(x.z), y1.x, s);
  s = fmaf(bf16_hi(x.z), y1.y, s);
  s = fmaf(bf16_lo(x.w), y1.z, s);
  s = fmaf(bf16_hi(x.w), y1.w, s);
  return s;
}

template <bool BF16>
__device__ __forceinline__ float load_elem(const void* row, int e) {
  if (BF16) {
    const unsigned short h = reinterpret_cast<const unsigned short*>(row)[e];
    return __uint_as_float(static_cast<uint32_t>(h) << 16);
  }
  return __ldg(reinterpret_cast<const float*>(row) + e);
}

// One block per query row. Dynamic shared memory layout:
//   q_s[d_pad] f32 | a_sc[S] | a_id[S] | b_sc[S] | b_id[S] | t_row[T] | t_oid[T]
template <bool BF16, bool VEC>
__global__ void __launch_bounds__(kThreads)
    fused_verify_kernel(const void* __restrict__ embs, long long n_rows, int d,
                        const int* __restrict__ row_ids,
                        const int* __restrict__ out_ids,
                        const float* __restrict__ queries, int c, int k, int s,
                        int* __restrict__ ids_out,
                        float* __restrict__ scores_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int d_pad = (d + 7) & ~7;
  const int t_len = s - k;
  float* q_s = reinterpret_cast<float*>(smem);
  float* a_sc = q_s + d_pad;
  int* a_id = reinterpret_cast<int*>(a_sc + s);
  float* b_sc = reinterpret_cast<float*>(a_id + s);
  int* b_id = reinterpret_cast<int*>(b_sc + s);
  int* t_row = b_id + s;
  int* t_oid = t_row + t_len;
  __shared__ int warp_tot[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long b = blockIdx.x;
  const float neg_inf = __int_as_float(0xff800000);
  const size_t row_bytes = static_cast<size_t>(d) * (BF16 ? 2 : 4);
  const char* table = reinterpret_cast<const char*>(embs);

  for (int e = tid; e < d_pad; e += kThreads) {
    float v = 0.f;
    if (e < d) {
      v = queries[b * d + e];
      if (BF16) {  // round to nearest even, as a cast to bfloat16 does
        uint32_t u = __float_as_uint(v);
        u += 0x7fffu + ((u >> 16) & 1u);
        v = __uint_as_float(u & 0xffff0000u);
      }
    }
    q_s[e] = v;
  }
  for (int i = tid; i < s; i += kThreads) {
    a_sc[i] = neg_inf;
    a_id[i] = kIdSentinel;
  }
  __syncthreads();

  const int* rid_row = row_ids + b * c;
  const int* oid_row = out_ids + b * c;
  for (int c0 = 0; c0 < c; c0 += t_len) {
    // Stage the tile's ids; a tile with no valid candidate is skipped.
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

    // Candidates below the current k-th score can never enter the top-k.
    const float thr = a_sc[k - 1];
    int survived = 0;
    for (int t0 = warp * kRowsPerWarp; t0 < t_len;
         t0 += kWarps * kRowsPerWarp) {
      bool val[kRowsPerWarp];
      const char* rows[kRowsPerWarp];
      float acc[kRowsPerWarp];
#pragma unroll
      for (int u = 0; u < kRowsPerWarp; ++u) {
        const int t = t0 + u;
        val[u] = t < t_len && t_oid[t] >= 0;
        rows[u] = table + static_cast<size_t>(val[u] ? t_row[t] : 0) * row_bytes;
        acc[u] = 0.f;
      }
      if (VEC) {
        const int n_vec = d / (BF16 ? 8 : 4);
#pragma unroll 2
        for (int v = lane; v < n_vec; v += 32) {
#pragma unroll
          for (int u = 0; u < kRowsPerWarp; ++u)
            if (val[u]) acc[u] += dot16<BF16>(rows[u], v, q_s);
        }
      } else {
        for (int e = lane; e < d; e += 32) {
#pragma unroll
          for (int u = 0; u < kRowsPerWarp; ++u)
            if (val[u]) acc[u] = fmaf(load_elem<BF16>(rows[u], e), q_s[e], acc[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kRowsPerWarp; ++u) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], off);
      }
      if (lane == 0) {
#pragma unroll
        for (int u = 0; u < kRowsPerWarp; ++u) {
          const int t = t0 + u;
          if (t >= t_len) break;
          const bool keep = val[u] && acc[u] >= thr;
          a_sc[k + t] = keep ? acc[u] : neg_inf;
          a_id[k + t] = keep ? t_oid[t] : kIdSentinel;
          survived |= keep;
        }
      }
    }
    if (!__syncthreads_or(survived)) continue;

    // Bitonic sort of a[0, s) on (score desc, id asc).
    for (int size = 2; size <= s; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int i = tid; i < (s >> 1); i += kThreads) {
          const int lo = 2 * i - (i & (stride - 1));
          const int hi = lo + stride;
          const float slo = a_sc[lo], shi = a_sc[hi];
          const int ilo = a_id[lo], ihi = a_id[hi];
          const bool up = (lo & size) == 0;
          const bool swap = up ? before(shi, ihi, slo, ilo)
                               : before(slo, ilo, shi, ihi);
          if (swap) {
            a_sc[lo] = shi;
            a_sc[hi] = slo;
            a_id[lo] = ihi;
            a_id[hi] = ilo;
          }
        }
        __syncthreads();
      }
    }

    // Keep the first k distinct valid ids, in order, into b[0, k).
    int base = 0;
    for (int i0 = 0; i0 < s && base < k; i0 += kThreads) {
      const int i = i0 + tid;
      bool flag = false;
      float sc = neg_inf;
      int id = kIdSentinel;
      if (i < s) {
        sc = a_sc[i];
        id = a_id[i];
        flag = sc != neg_inf && (i == 0 || a_id[i - 1] != id);
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
        b_sc[pos] = sc;
        b_id[pos] = id;
      }
      base += tot;
      __syncthreads();
    }
    for (int i = (base < k ? base : k) + tid; i < k; i += kThreads) {
      b_sc[i] = neg_inf;
      b_id[i] = kIdSentinel;
    }
    // The merged accumulator now lives in b: swap the two buffers.
    float* tf = a_sc;
    a_sc = b_sc;
    b_sc = tf;
    int* ti = a_id;
    a_id = b_id;
    b_id = ti;
    __syncthreads();
  }

  for (int i = tid; i < k; i += kThreads) {
    const float sc = a_sc[i];
    scores_out[b * k + i] = sc;
    ids_out[b * k + i] = sc == neg_inf ? -1 : a_id[i];
  }
}

int merge_size(int k) {
  int s = 256;
  while (s < 2 * k) s <<= 1;
  return s;
}

template <bool BF16, bool VEC>
cudaError_t launch(const void* embs, long long n_rows, int d,
                   const int* row_ids, const int* out_ids,
                   const float* queries, int b, int c, int k, int* ids_out,
                   float* scores_out, cudaStream_t stream) {
  const int s = merge_size(k);
  const int d_pad = (d + 7) & ~7;
  const size_t smem = sizeof(float) * d_pad + 4 * sizeof(float) * s +
                      2 * sizeof(int) * (s - k);
  auto kern = fused_verify_kernel<BF16, VEC>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kern<<<b, kThreads, smem, stream>>>(embs, n_rows, d, row_ids, out_ids,
                                      queries, c, k, s, ids_out, scores_out);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. Returns the cudaError_t of the
// launch (0 on success). The caller validates shapes, dtypes and devices.
extern "C" int fused_verify_launch(const void* embs, int is_bf16,
                                   long long n_rows, int d, const int* row_ids,
                                   const int* out_ids, const float* queries,
                                   int b, int c, int k, int* ids_out,
                                   float* scores_out, void* stream) {
  if (b <= 0) return 0;
  const int elem = is_bf16 ? 2 : 4;
  const bool vec = (static_cast<long long>(d) * elem) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(embs) % 16 == 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16) {
    err = vec ? launch<true, true>(embs, n_rows, d, row_ids, out_ids, queries,
                                   b, c, k, ids_out, scores_out, st)
              : launch<true, false>(embs, n_rows, d, row_ids, out_ids, queries,
                                    b, c, k, ids_out, scores_out, st);
  } else {
    err = vec ? launch<false, true>(embs, n_rows, d, row_ids, out_ids, queries,
                                    b, c, k, ids_out, scores_out, st)
              : launch<false, false>(embs, n_rows, d, row_ids, out_ids,
                                     queries, b, c, k, ids_out, scores_out, st);
  }
  return static_cast<int>(err);
}
