// fused_verify_grouped: the cluster-major first pass. Each schedule step
// scores one cluster's code rows against a tile of block_q query codes and
// keeps a deduplicated top-k' per (step, slot).
//
// Replaces the TPU kernel repro/kernels/fused_verify.py::fused_verify_grouped
// (_fused_verify_grouped_kernel).
//
// Contract, for each step s (one block):
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
//     loads nothing; a tile of rows where no slot has a candidate is skipped.
//
// What bounds it on an H100: bytes. A step reads its cluster's live rows
// (Lp x d bytes of codes, half that for int4) and its (block_q, Lp) id
// tile; scoring costs 2 * d * block_q operations a row, still below the
// card's balance at block_q = 8. The design for that floor:
//   * each tile of TR cluster rows is copied into shared memory ONCE, with
//     16-byte loads over contiguous bytes (a cluster's rows are contiguous),
//     and scored against all block_q query rows from there: the query tile
//     shares the row traffic, which is what the TPU kernel's one MXU pass
//     per tile computes; one warp scores a row for every slot at once
//     (__dp4a, int4 nibbles unpacked in registers as in fused_verify.cu);
//   * scores at or above a slot's current k'-th score go to that slot's
//     staging buffer; a slot merges (topk.cuh) only when its buffer fills
//     and once at the end, so the sort runs a few times per step, not per
//     tile.

#include "topk.cuh"

namespace {

using topk::kThreads;
using topk::kWarps;
constexpr int kMaxBlockQ = 16;
constexpr int kTileRows = 32;  // cluster rows staged per tile

__device__ __forceinline__ int lo4(int w) {
  return static_cast<int>(__vsub4((static_cast<unsigned>(w) & 0x0f0f0f0fu) ^ 0x08080808u,
                                  0x08080808u));
}
__device__ __forceinline__ int hi4(int w) {
  return static_cast<int>(
      __vsub4(((static_cast<unsigned>(w) >> 4) & 0x0f0f0f0fu) ^ 0x08080808u, 0x08080808u));
}

// Byte offset of logical element e in a staged int4 query (fused_verify.cu).
__device__ __forceinline__ int int4_query_byte(int e) {
  return ((e >> 3) * 2 + (e & 1)) * 4 + ((e & 7) >> 1);
}

struct Layout {
  int q_bytes;  // one staged query row, a multiple of 16
  int row_bytes;  // one stored cluster row
  int tile_bytes;  // kTileRows rows, rounded up to 16
  int s, t_len;  // merge buffer length and staging capacity per slot
};

__host__ __device__ inline Layout layout(int d_store, bool int4, int k) {
  Layout l;
  const int d_log = int4 ? 2 * d_store : d_store;
  l.q_bytes = (d_log + 15) & ~15;
  l.row_bytes = d_store;
  l.tile_bytes = (kTileRows * d_store + 15) & ~15;
  int s = 256;
  while (s < 2 * k) s <<= 1;
  l.s = s;
  l.t_len = s - k;
  return l;
}

// Shared memory, in order:
//   q_s[block_q][q_bytes] int8 | tile[tile_bytes] int8 |
//   acc_sc/acc_id[block_q][k] | st_sc/st_id[block_q][t_len] |
//   w_sc/w_id[s] | t_sc/t_oid[block_q][kTileRows] | rs[kTileRows]
inline size_t smem_bytes(const Layout& l, int block_q, int k) {
  return static_cast<size_t>(block_q) * l.q_bytes + l.tile_bytes +
         8ull * block_q * k + 8ull * block_q * l.t_len + 8ull * l.s +
         8ull * block_q * kTileRows + 4ull * kTileRows;
}

template <bool INT4, bool VEC>
__global__ void __launch_bounds__(kThreads)
    fused_verify_grouped_kernel(const signed char* __restrict__ embs,
                                const float* __restrict__ row_scales,
                                int n_clusters, int lp, int d_store,
                                const signed char* __restrict__ q_codes,
                                const float* __restrict__ q_scales,
                                const int* __restrict__ sched_cids,
                                const int* __restrict__ sched_qids,
                                const int* __restrict__ slot_ids, int block_q,
                                int k, int* __restrict__ ids_out,
                                float* __restrict__ scores_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_tot[kWarps];
  __shared__ int cnt[kMaxBlockQ];
  __shared__ float qsc[kMaxBlockQ];
  __shared__ int qid_s[kMaxBlockQ];

  const Layout l = layout(d_store, INT4, k);
  const int d_log = INT4 ? 2 * d_store : d_store;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long step = blockIdx.x;

  signed char* q_s = reinterpret_cast<signed char*>(smem);
  signed char* tile = q_s + static_cast<size_t>(block_q) * l.q_bytes;
  float* acc_sc = reinterpret_cast<float*>(tile + l.tile_bytes);
  int* acc_id = reinterpret_cast<int*>(acc_sc + block_q * k);
  float* st_sc = reinterpret_cast<float*>(acc_id + block_q * k);
  int* st_id = reinterpret_cast<int*>(st_sc + block_q * l.t_len);
  float* w_sc = reinterpret_cast<float*>(st_id + block_q * l.t_len);
  int* w_id = reinterpret_cast<int*>(w_sc + l.s);
  float* t_sc = reinterpret_cast<float*>(w_id + l.s);
  int* t_oid = reinterpret_cast<int*>(t_sc + block_q * kTileRows);
  float* rs = reinterpret_cast<float*>(t_oid + block_q * kTileRows);

  int* out_ids = ids_out + step * block_q * k;
  float* out_sc = scores_out + step * block_q * k;

  if (tid < block_q) {
    const int qid = sched_qids[step * block_q + tid];
    qid_s[tid] = qid;
    qsc[tid] = qid >= 0 ? q_scales[qid] : 1.f;
    cnt[tid] = 0;
  }
  __syncthreads();
  int any_slot = 0;
  for (int j = 0; j < block_q; ++j) any_slot |= qid_s[j] >= 0;
  if (!any_slot) {  // schedule padding: nothing to load
    for (int i = tid; i < block_q * k; i += kThreads) {
      out_ids[i] = -1;
      out_sc[i] = topk::neg_inf();
    }
    return;
  }

  int cid = sched_cids[step];
  cid = cid < 0 ? 0 : (cid >= n_clusters ? n_clusters - 1 : cid);
  const signed char* cluster = embs + static_cast<long long>(cid) * lp * d_store;
  const float* cluster_scales = row_scales + static_cast<long long>(cid) * lp;
  const int* step_ids = slot_ids + step * block_q * static_cast<long long>(lp);

  // Stage the query codes of every slot (zero for empty slots).
  for (int i = tid; i < block_q * l.q_bytes; i += kThreads) {
    const int j = i / l.q_bytes;
    const int p = i - j * l.q_bytes;
    int e = p;
    if (INT4) {
      const int word = p >> 2;
      e = (word >> 1) * 8 + (p & 3) * 2 + (word & 1);
    }
    const int qid = qid_s[j];
    q_s[i] = (qid >= 0 && e < d_log) ? q_codes[static_cast<long long>(qid) * d_log + e] : 0;
  }
  topk::fill_invalid(acc_sc, acc_id, 0, block_q * k);
  __syncthreads();

  // Merges slot j's staged candidates into its accumulator.
  auto merge_slot = [&](int j) {
    const int n = cnt[j];
    for (int i = tid; i < l.s; i += kThreads) {
      float sc = topk::neg_inf();
      int id = topk::kIdSentinel;
      if (i < k) {
        sc = acc_sc[j * k + i];
        id = acc_id[j * k + i];
      } else if (i - k < n) {
        sc = st_sc[j * l.t_len + i - k];
        id = st_id[j * l.t_len + i - k];
      }
      w_sc[i] = sc;
      w_id[i] = id;
    }
    __syncthreads();
    topk::sort_compact(w_sc, w_id, l.s, acc_sc + j * k, acc_id + j * k, k, warp_tot);
    if (tid == 0) cnt[j] = 0;
    __syncthreads();
  };

  for (int r0 = 0; r0 < lp; r0 += kTileRows) {
    const int rows = lp - r0 < kTileRows ? lp - r0 : kTileRows;
    int any_valid = 0;
    for (int i = tid; i < block_q * kTileRows; i += kThreads) {
      const int j = i / kTileRows;
      const int t = i - j * kTileRows;
      const int oid = t < rows ? step_ids[static_cast<long long>(j) * lp + r0 + t] : -1;
      t_oid[i] = oid;
      any_valid |= oid >= 0;
    }
    if (!__syncthreads_or(any_valid)) continue;

    // The tile's rows, once, into shared memory.
    const signed char* src = cluster + static_cast<long long>(r0) * d_store;
    const int n_bytes = rows * d_store;
    if (VEC) {
      for (int v = tid; v < (n_bytes >> 4); v += kThreads)
        reinterpret_cast<int4*>(tile)[v] = __ldg(reinterpret_cast<const int4*>(src) + v);
    } else {
      for (int i = tid; i < n_bytes; i += kThreads) tile[i] = src[i];
    }
    if (tid < rows) rs[tid] = cluster_scales[r0 + tid];
    __syncthreads();

    // One warp per row: every slot's int32 dot at once.
    for (int t = warp; t < rows; t += kWarps) {
      const signed char* row = tile + t * d_store;
      int acc[kMaxBlockQ];
#pragma unroll
      for (int j = 0; j < kMaxBlockQ; ++j) acc[j] = 0;
      if (VEC) {
        const int n_vec = d_store >> 4;
        for (int v = lane; v < n_vec; v += 32) {
          const int4 x = reinterpret_cast<const int4*>(row)[v];
#pragma unroll
          for (int j = 0; j < kMaxBlockQ; ++j) {
            if (j >= block_q) break;
            const int4* q4 = reinterpret_cast<const int4*>(q_s + j * l.q_bytes);
            if (INT4) {
              const int4 y0 = q4[2 * v];
              const int4 y1 = q4[2 * v + 1];
              int a = acc[j];
              a = __dp4a(lo4(x.x), y0.x, a);
              a = __dp4a(hi4(x.x), y0.y, a);
              a = __dp4a(lo4(x.y), y0.z, a);
              a = __dp4a(hi4(x.y), y0.w, a);
              a = __dp4a(lo4(x.z), y1.x, a);
              a = __dp4a(hi4(x.z), y1.y, a);
              a = __dp4a(lo4(x.w), y1.z, a);
              acc[j] = __dp4a(hi4(x.w), y1.w, a);
            } else {
              const int4 y = q4[v];
              int a = acc[j];
              a = __dp4a(x.x, y.x, a);
              a = __dp4a(x.y, y.y, a);
              a = __dp4a(x.z, y.z, a);
              acc[j] = __dp4a(x.w, y.w, a);
            }
          }
        }
      } else {
        for (int e = lane; e < d_log; e += 32) {
          int code;
          int qb = e;
          if (INT4) {
            const int byte = row[e >> 1];
            code = (e & 1) ? (byte >> 4) : (((byte & 0x0f) ^ 0x08) - 0x08);
            qb = int4_query_byte(e);
          } else {
            code = row[e];
          }
#pragma unroll
          for (int j = 0; j < kMaxBlockQ; ++j) {
            if (j >= block_q) break;
            acc[j] += code * q_s[j * l.q_bytes + qb];
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kMaxBlockQ; ++j) {
        if (j >= block_q) break;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
      }
#pragma unroll
      for (int j = 0; j < kMaxBlockQ; ++j) {
        if (j >= block_q) break;
        if (lane == j) {
          const int i = j * kTileRows + t;
          t_sc[i] = t_oid[i] >= 0
                        ? __fmul_rn(__int2float_rn(acc[j]), __fmul_rn(qsc[j], rs[t]))
                        : topk::neg_inf();
        }
      }
    }
    __syncthreads();

    // A slot whose staging buffer cannot take a whole tile merges first.
    // Every thread must read the same counts, so none may append (below)
    // before all have decided: hence the barrier after the loop.
    for (int j = 0; j < block_q; ++j)
      if (cnt[j] + rows > l.t_len) merge_slot(j);
    __syncthreads();

    for (int i = tid; i < block_q * kTileRows; i += kThreads) {
      const int j = i / kTileRows;
      const int t = i - j * kTileRows;
      const float sc = t_sc[i];
      if (t < rows && t_oid[i] >= 0 && sc >= acc_sc[j * k + k - 1]) {
        const int pos = atomicAdd(&cnt[j], 1);
        st_sc[j * l.t_len + pos] = sc;
        st_id[j * l.t_len + pos] = t_oid[i];
      }
    }
    __syncthreads();
  }

  for (int j = 0; j < block_q; ++j)
    if (cnt[j] > 0) merge_slot(j);
  for (int j = 0; j < block_q; ++j)
    topk::write_out(acc_sc + j * k, acc_id + j * k, k, out_ids + j * k, out_sc + j * k);
}

template <bool INT4, bool VEC>
cudaError_t launch(const signed char* embs, const float* row_scales,
                   int n_clusters, int lp, int d_store,
                   const signed char* q_codes, const float* q_scales,
                   const int* sched_cids, const int* sched_qids,
                   const int* slot_ids, int n_steps, int block_q, int k,
                   int* ids_out, float* scores_out, cudaStream_t stream) {
  const Layout l = layout(d_store, INT4, k);
  const size_t smem = smem_bytes(l, block_q, k);
  auto kern = fused_verify_grouped_kernel<INT4, VEC>;
  cudaError_t err = topk::allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<n_steps, kThreads, smem, stream>>>(
      embs, row_scales, n_clusters, lp, d_store, q_codes, q_scales, sched_cids,
      sched_qids, slot_ids, block_q, k, ids_out, scores_out);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. Returns the cudaError_t of the
// launch (0 on success). The caller validates shapes, dtypes and devices.
//   embs (c, lp, d_store) int8 codes (int4: packed, logical width 2 d_store),
//   row_scales (c, lp) f32, q_codes (B, d) int8 + q_scales (B,) f32,
//   sched_cids (S,), sched_qids (S, block_q), slot_ids (S, block_q, lp) int32
//   -> ids_out / scores_out (S, block_q, k).
extern "C" int fused_verify_grouped_launch(
    const signed char* embs, const float* row_scales, int n_clusters, int lp,
    int d_store, int is_int4, const signed char* q_codes,
    const float* q_scales, const int* sched_cids, const int* sched_qids,
    const int* slot_ids, int n_steps, int block_q, int k, int* ids_out,
    float* scores_out, void* stream) {
  if (n_steps <= 0) return 0;
  if (block_q < 1 || block_q > kMaxBlockQ) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = d_store % 16 == 0 && reinterpret_cast<uintptr_t>(embs) % 16 == 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_int4) {
    err = vec ? launch<true, true>(embs, row_scales, n_clusters, lp, d_store, q_codes,
                                   q_scales, sched_cids, sched_qids, slot_ids,
                                   n_steps, block_q, k, ids_out, scores_out, st)
              : launch<true, false>(embs, row_scales, n_clusters, lp, d_store, q_codes,
                                    q_scales, sched_cids, sched_qids, slot_ids,
                                    n_steps, block_q, k, ids_out, scores_out, st);
  } else {
    err = vec ? launch<false, true>(embs, row_scales, n_clusters, lp, d_store, q_codes,
                                    q_scales, sched_cids, sched_qids, slot_ids,
                                    n_steps, block_q, k, ids_out, scores_out, st)
              : launch<false, false>(embs, row_scales, n_clusters, lp, d_store, q_codes,
                                     q_scales, sched_cids, sched_qids, slot_ids,
                                     n_steps, block_q, k, ids_out, scores_out, st);
  }
  return static_cast<int>(err);
}
