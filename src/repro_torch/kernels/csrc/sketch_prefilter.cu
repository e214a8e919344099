// sketch_prefilter: the 1-bit Hamming first pass. Gather each candidate's
// packed sign sketch by id, score it against the query's sketch, and keep a
// deduplicated top-k of survivors per query row.
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
//   * the same padding, dedup and tie-break (ties to the smallest id) as
//     fused_verify.
//
// What bounds it on an H100: bytes. A candidate costs w XOR + popcount +
// add against 4w bytes of sketch (96 B at d = 768, an eighth of an int8
// row), so the floor is reading each distinct candidate sketch once plus the
// (B, C) id arrays. The design is fused_verify's (topk.cuh's chunk_topk: a
// (query, chunk) grid, each distinct row of a chunk loaded once, staged
// merges, the last block of a query merging the partial lists). A row is
// too short to share across a warp, so each thread scores whole rows: w
// words in 16-byte loads through the read-only path. Scores are small
// integers, so ties at the k-th score are common and survive the threshold
// test; the staging area absorbs them and the merge keeps the exact
// tie-break. k reaches 1,600 on the main path: a merge buffer of 4,096
// entries (32 KB of shared memory) beside the 40 KB hash set. A k above
// 4,096 (a covering sketch factor) takes chunk_topk's large-k path.

#include "topk.cuh"

namespace {

using topk::kThreads;

// One block per (query row, chunk): blockIdx.x = b * n_chunks + part.
// LARGE: k above topk::kMaxSmemK (chunk_topk's large-k path).
template <bool VEC, bool LARGE>
__global__ void __launch_bounds__(kThreads)
    sketch_prefilter_kernel(const int* __restrict__ sketches, long long n_rows,
                            int w, const int* __restrict__ row_ids,
                            const int* __restrict__ out_ids,
                            const int* __restrict__ q_sketch, int c, int chunk,
                            int n_chunks, int k, int* __restrict__ ids_out,
                            float* __restrict__ scores_out, topk::Workspace ws) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int w_pad = (w + 3) & ~3;
  int* q_s = reinterpret_cast<int*>(smem);
  const long long b = blockIdx.x / n_chunks;
  const int part = static_cast<int>(blockIdx.x - b * n_chunks);
  for (int j = threadIdx.x; j < w_pad; j += kThreads)
    q_s[j] = j < w ? q_sketch[b * w + j] : 0;  // chunk_topk syncs

  auto score_rows = [&](unsigned long long* keys, const unsigned short* heads,
                        int n_heads) {
    for (int h = threadIdx.x; h < n_heads; h += kThreads) {
      const int slot = heads[h];
      const int* row = sketches + static_cast<long long>(keys[slot] >> 32) * w;
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
      keys[slot] = topk::scored_key(-__int2float_rn(ham), keys[slot]);
    }
  };

  topk::chunk_topk<LARGE>(row_ids + b * c, out_ids + b * c, n_rows, c, chunk, part,
                   n_chunks, k, smem + sizeof(int) * w_pad, score_rows,
                   ids_out + b * k, scores_out + b * k, ws, b);
}

template <bool VEC, bool LARGE>
cudaError_t launch(const int* sketches, long long n_rows, int w,
                   const int* row_ids, const int* out_ids, const int* q_sketch,
                   int b, int c, int chunk, int n_chunks, int k, int* ids_out,
                   float* scores_out, topk::Workspace ws, cudaStream_t stream) {
  const int w_pad = (w + 3) & ~3;
  const size_t smem = sizeof(int) * w_pad + topk::chunk_topk_smem(topk::list_len(k, chunk), chunk);
  auto kern = sketch_prefilter_kernel<VEC, LARGE>;
  cudaError_t err = topk::allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<static_cast<unsigned>(static_cast<long long>(b) * n_chunks), kThreads, smem, stream>>>(
      sketches, n_rows, w, row_ids, out_ids, q_sketch, c, chunk, n_chunks, k,
      ids_out, scores_out, ws);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. Returns the cudaError_t of the
// launch (0 on success). The caller validates shapes, dtypes and devices.
// Chunks and workspace as fused_verify_launch.
extern "C" int sketch_prefilter_launch(const int* sketches, long long n_rows,
                                       int w, const int* row_ids,
                                       const int* out_ids, const int* q_sketch,
                                       int b, int c, int chunk, int n_chunks,
                                       int k, int* ids_out, float* scores_out,
                                       void* workspace, int* arrive,
                                       void* stream) {
  if (b <= 0) return 0;
  if (k < 1 || chunk > topk::kMaxChunk || n_chunks < 1 ||
      static_cast<long long>(chunk) * n_chunks < c)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(sketches) % 16 == 0;
  const bool large = k > topk::kMaxSmemK;
  const topk::Workspace ws = topk::workspace(workspace, arrive, b, n_chunks, chunk, k);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
#define SP_LAUNCH(VEC, LARGE)                                                          \
  launch<VEC, LARGE>(sketches, n_rows, w, row_ids, out_ids, q_sketch, b, c, chunk,     \
                     n_chunks, k, ids_out, scores_out, ws, st)
  const cudaError_t err = vec ? (large ? SP_LAUNCH(true, true) : SP_LAUNCH(true, false))
                              : (large ? SP_LAUNCH(false, true) : SP_LAUNCH(false, false));
#undef SP_LAUNCH
  return static_cast<int>(err);
}
