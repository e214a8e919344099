// sketch_prefilter: the 1-bit Hamming first pass. Gather each candidate's
// packed sign sketch by id, score it against the query's sketch, and keep a
// deduplicated top-k of survivors, in one pass per query row.
//
// Replaces the TPU kernel repro/kernels/fused_verify.py::sketch_prefilter
// (_sketch_filter_kernel).
//
// Contract, for each query row b:
//   * gather sketch rows row_ids[b, :] of the (N, w) table of 32-bit words
//     (the JAX package's uint32 words as int32 bit patterns; ids clamped to
//     [0, N));
//   * score -(float) sum_j popcount(row[j] ^ q[j]) over the w words, with
//     the query sketched by the wrapper (quant.sketch_rows): exact, since a
//     Hamming distance <= 32w < 2^24;
//   * the same padding, dead-tile skip, dedup and tie-break (ties to the
//     smallest id) as fused_verify (topk.cuh).
//
// What bounds it on an H100: bytes. A candidate costs w XOR + popcount +
// add against 4w bytes of sketch (96 B at d = 768, an eighth of an int8
// row), so the floor is reading each distinct candidate sketch once plus the
// (B, C) id arrays. A row is too short to share across a warp, so each
// thread scores whole rows: w words in 16-byte loads through the read-only
// path, 32 rows in flight per warp. Scores are small integers, so ties at
// the k-th score are common and survive the threshold test; the merge keeps
// the exact tie-break. k reaches 1600 on the main path, a merge buffer of
// 4096 entries (85 KB of shared memory, above the default 48 KB limit).

#include "topk.cuh"

namespace {

using topk::kThreads;

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    sketch_prefilter_kernel(const int* __restrict__ sketches, long long n_rows,
                            int w, const int* __restrict__ row_ids,
                            const int* __restrict__ out_ids,
                            const int* __restrict__ q_sketch, int c, int k,
                            int* __restrict__ ids_out,
                            float* __restrict__ scores_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int w_pad = (w + 3) & ~3;
  int* q_s = reinterpret_cast<int*>(smem);
  const long long b = blockIdx.x;
  for (int j = threadIdx.x; j < w_pad; j += kThreads)
    q_s[j] = j < w ? q_sketch[b * w + j] : 0;  // query_topk syncs

  auto score_tile = [&](const int* t_row, const int* t_oid, int t_len,
                        float thr, float* o_sc, int* o_id) -> int {
    int survived = 0;
    for (int t = threadIdx.x; t < t_len; t += kThreads) {
      const int oid = t_oid[t];
      bool keep = false;
      float sc = topk::neg_inf();
      if (oid >= 0) {
        const int* row = sketches + static_cast<long long>(t_row[t]) * w;
        int ham = 0;
        if (VEC) {
          const int4* r4 = reinterpret_cast<const int4*>(row);
          const int4* q4 = reinterpret_cast<const int4*>(q_s);
          for (int v = 0; v < (w >> 2); ++v) {
            const int4 x = __ldg(r4 + v);
            const int4 y = q4[v];
            ham += __popc(x.x ^ y.x) + __popc(x.y ^ y.y) + __popc(x.z ^ y.z) +
                   __popc(x.w ^ y.w);
          }
        } else {
          for (int j = 0; j < w; ++j) ham += __popc(__ldg(row + j) ^ q_s[j]);
        }
        sc = -__int2float_rn(ham);
        keep = sc >= thr;
      }
      o_sc[t] = keep ? sc : topk::neg_inf();
      o_id[t] = keep ? oid : topk::kIdSentinel;
      survived |= keep;
    }
    return survived;
  };

  topk::query_topk(row_ids + b * c, out_ids + b * c, n_rows, c, k,
                   smem + sizeof(int) * w_pad, score_tile, ids_out + b * k,
                   scores_out + b * k);
}

template <bool VEC>
cudaError_t launch(const int* sketches, long long n_rows, int w,
                   const int* row_ids, const int* out_ids, const int* q_sketch,
                   int b, int c, int k, int* ids_out, float* scores_out,
                   cudaStream_t stream) {
  const int w_pad = (w + 3) & ~3;
  const size_t smem = sizeof(int) * w_pad + topk::query_topk_smem(k);
  auto kern = sketch_prefilter_kernel<VEC>;
  cudaError_t err = topk::allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<b, kThreads, smem, stream>>>(sketches, n_rows, w, row_ids, out_ids,
                                      q_sketch, c, k, ids_out, scores_out);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. Returns the cudaError_t of the
// launch (0 on success). The caller validates shapes, dtypes and devices.
extern "C" int sketch_prefilter_launch(const int* sketches, long long n_rows,
                                       int w, const int* row_ids,
                                       const int* out_ids, const int* q_sketch,
                                       int b, int c, int k, int* ids_out,
                                       float* scores_out, void* stream) {
  if (b <= 0) return 0;
  const bool vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(sketches) % 16 == 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const cudaError_t err =
      vec ? launch<true>(sketches, n_rows, w, row_ids, out_ids, q_sketch, b, c,
                         k, ids_out, scores_out, st)
          : launch<false>(sketches, n_rows, w, row_ids, out_ids, q_sketch, b, c,
                          k, ids_out, scores_out, st);
  return static_cast<int>(err);
}
