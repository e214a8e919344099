// fused_verify: gather candidate rows by id, score them against the query,
// and keep a deduplicated top-k per query row.
//
// Replaces the TPU kernel repro/kernels/fused_verify.py::fused_verify
// (_fused_verify_kernel): its float32, bfloat16, int8 and packed-int4
// table branches.
//
// Contract, for each query row b:
//   * gather rows row_ids[b, :] of the (N, d) table (ids clamped to [0, N));
//   * score q . row:
//       - float32 / bfloat16 tables: float32 accumulation (a bfloat16 table
//         scores against the query rounded to bfloat16 first);
//       - int8 codes: the int8 query codes (quantized by the wrapper, as the
//         JAX wrapper does) times the row codes, summed exactly in int32 with
//         __dp4a, then float(sum) * (row_scale[row] * q_scale[b]), two
//         float32 multiplies in that order, so scores are bit-identical to
//         the plain version;
//       - packed int4 codes (width d/2): the same, with each byte's two
//         nibbles unpacked in registers (per-byte __vsub4 sign extension);
//         the query codes are laid out in shared memory to match the
//         unpacked order, and the int32 sum is exact in any order;
//   * candidates with out_ids < 0 score -inf and are never loaded;
//   * keep the top-k deduplicated by out_ids: scores descending, ties to the
//     smallest id, (-1, -inf) past the number of unique valid ids.
//
// What bounds it on an H100: bytes. Each candidate costs 2*d operations
// against d*4 (f32), d*2 (bf16), d (int8) or d/2 (int4) bytes of row, far
// below the card's operations-per-byte balance, so the floor is reading each
// distinct candidate row (and its scale) once plus the (B, C) id arrays.
// LIDER's in-cluster call repeats rows: H windows of R sorted positions in
// each probed cluster overlap, so a query's 80,000 candidates hold about a
// fifth as many distinct rows. The design (topk.cuh's chunk_topk):
//   * a (query, chunk) grid: a query's candidates are cut into chunks of at
//     most 4,096 (one probed cluster's H * R at the main path's shapes), one
//     block each, so B * n_chunks blocks fill the card; the last block of a
//     query merges the partial top-ks;
//   * each block puts its chunk's (row, out id) pairs in a hash set in
//     shared memory and loads every distinct row once, with 16-byte loads
//     through the read-only path: one warp per float row, 4 rows in flight
//     a warp; integer rows take 8 or 16 lanes each (lanes_per_row), so a
//     warp keeps 8 or 16 rows in flight with every lane loading;
//   * survivors of the current k-th score are staged; the merge sort runs
//     only when the staging area fills, and at the chunk's end;
//   * the row scale is read by id inside the kernel, so the (B, C) combined
//     scale array the JAX wrapper builds is never written;
//   * offsets into the table are 64-bit: a 1M x 768 table has element
//     offsets past 2^31;
//   * k above 4,096 (topk::kMaxSmemK, off the main path) takes chunk_topk's
//     large-k path: each chunk keeps all its distinct entries and the last
//     block of a query merges the partial lists in global memory, so any k
//     is answered.
// A row's score is the same lane-strided chunks and xor-shuffle reduction
// wherever it is computed, so every block scores a row bit-identically.

#include "topk.cuh"

namespace {

using topk::kThreads;
using topk::kWarps;
constexpr int kRowsPerWarp = 4;  // rows in flight per lane group (4 * 32 / G a warp)

enum Mode { kF32 = 0, kBF16 = 1, kInt8 = 2, kInt4 = 3 };

template <int MODE>
struct Traits {
  using Acc = float;
  static constexpr int kBytes = MODE == kF32 ? 4 : 2;  // bytes per stored element
};
template <>
struct Traits<kInt8> {
  using Acc = int;
  static constexpr int kBytes = 1;
};
template <>
struct Traits<kInt4> {
  using Acc = int;
  static constexpr int kBytes = 1;  // two nibbles per stored byte
};

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// The four signed low (lo4) or high (hi4) nibbles of a word as int8 lanes.
__device__ __forceinline__ int lo4(int w) {
  return static_cast<int>(__vsub4((static_cast<unsigned>(w) & 0x0f0f0f0fu) ^ 0x08080808u,
                                  0x08080808u));
}
__device__ __forceinline__ int hi4(int w) {
  return static_cast<int>(
      __vsub4(((static_cast<unsigned>(w) >> 4) & 0x0f0f0f0fu) ^ 0x08080808u, 0x08080808u));
}

// Byte offset, in the staged int4 query, of logical element e: packed word
// g = e / 8 holds elements 8g..8g+7, its low nibbles the even ones and its
// high nibbles the odd ones; the query keeps, per g, one word of the even
// elements then one of the odd, so lo4/hi4 of a row word meet their match.
__device__ __forceinline__ int int4_query_byte(int e) {
  return ((e >> 3) * 2 + (e & 1)) * 4 + ((e & 7) >> 1);
}

// Stages the query row in shared memory: floats (f32 / bf16-rounded), or
// int8 code bytes (int4: in the unpacked order above), zero past d.
template <int MODE>
__device__ void stage_query(float* q_s, int d_pad, const void* queries,
                            long long b, int d) {
  if constexpr (MODE == kF32 || MODE == kBF16) {
    const float* q = reinterpret_cast<const float*>(queries) + b * d;
    for (int e = threadIdx.x; e < d_pad; e += kThreads) {
      float v = 0.f;
      if (e < d) {
        v = q[e];
        if constexpr (MODE == kBF16) {  // round to nearest even, as a cast to bfloat16 does
          uint32_t u = __float_as_uint(v);
          u += 0x7fffu + ((u >> 16) & 1u);
          v = __uint_as_float(u & 0xffff0000u);
        }
      }
      q_s[e] = v;
    }
  } else {
    const signed char* q = reinterpret_cast<const signed char*>(queries) + b * d;
    signed char* qb = reinterpret_cast<signed char*>(q_s);
    for (int p = threadIdx.x; p < 4 * d_pad; p += kThreads) {
      int e = p;
      if constexpr (MODE == kInt4) {  // invert int4_query_byte
        const int word = p >> 2;
        e = (word >> 1) * 8 + (p & 3) * 2 + (word & 1);
      }
      qb[p] = e < d ? q[e] : 0;
    }
  }
}

// One 16-byte chunk v of a row against the matching query slice.
template <int MODE>
__device__ __forceinline__ typename Traits<MODE>::Acc chunk(
    const void* row, int v, const float* q, typename Traits<MODE>::Acc acc);

template <>
__device__ __forceinline__ float chunk<kF32>(const void* row, int v,
                                             const float* q, float acc) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(row) + v);
  const float4 y = reinterpret_cast<const float4*>(q)[v];
  float s = x.x * y.x;
  s = fmaf(x.y, y.y, s);
  s = fmaf(x.z, y.z, s);
  s = fmaf(x.w, y.w, s);
  return acc + s;
}

template <>
__device__ __forceinline__ float chunk<kBF16>(const void* row, int v,
                                              const float* q, float acc) {
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
  return acc + s;
}

template <>
__device__ __forceinline__ int chunk<kInt8>(const void* row, int v,
                                            const float* q, int acc) {
  const int4 x = __ldg(reinterpret_cast<const int4*>(row) + v);
  const int4 y = reinterpret_cast<const int4*>(q)[v];
  acc = __dp4a(x.x, y.x, acc);
  acc = __dp4a(x.y, y.y, acc);
  acc = __dp4a(x.z, y.z, acc);
  return __dp4a(x.w, y.w, acc);
}

template <>
__device__ __forceinline__ int chunk<kInt4>(const void* row, int v,
                                            const float* q, int acc) {
  const int4 x = __ldg(reinterpret_cast<const int4*>(row) + v);
  const int4 y0 = reinterpret_cast<const int4*>(q)[2 * v];
  const int4 y1 = reinterpret_cast<const int4*>(q)[2 * v + 1];
  acc = __dp4a(lo4(x.x), y0.x, acc);
  acc = __dp4a(hi4(x.x), y0.y, acc);
  acc = __dp4a(lo4(x.y), y0.z, acc);
  acc = __dp4a(hi4(x.y), y0.w, acc);
  acc = __dp4a(lo4(x.z), y1.x, acc);
  acc = __dp4a(hi4(x.z), y1.y, acc);
  acc = __dp4a(lo4(x.w), y1.z, acc);
  return __dp4a(hi4(x.w), y1.w, acc);
}

// Scalar form for rows that are not a whole number of 16-byte chunks:
// logical element e of the row against the query.
template <int MODE>
__device__ __forceinline__ typename Traits<MODE>::Acc elem(
    const void* row, int e, const float* q, typename Traits<MODE>::Acc acc) {
  if constexpr (MODE == kF32) {
    return fmaf(__ldg(reinterpret_cast<const float*>(row) + e), q[e], acc);
  } else if constexpr (MODE == kBF16) {
    const unsigned short h = reinterpret_cast<const unsigned short*>(row)[e];
    return fmaf(__uint_as_float(static_cast<uint32_t>(h) << 16), q[e], acc);
  } else if constexpr (MODE == kInt8) {
    const signed char* qb = reinterpret_cast<const signed char*>(q);
    return acc + static_cast<int>(reinterpret_cast<const signed char*>(row)[e]) * qb[e];
  } else {
    const signed char* qb = reinterpret_cast<const signed char*>(q);
    const int byte = reinterpret_cast<const signed char*>(row)[e >> 1];
    const int code = (e & 1) ? (byte >> 4) : (((byte & 0x0f) ^ 0x08) - 0x08);
    return acc + code * qb[int4_query_byte(e)];
  }
}

// Lanes that share one row: 32 for float tables, so every row is summed in
// one fixed order; for integer codes (exact in any order) the fewest that
// still give each lane 3 or more 16-byte chunks, so no lane idles and a
// warp keeps 32 / G rows of each step in flight.
inline int lanes_per_row(int mode, int n_vec) {
  int g = 32;
  if (mode == kInt8 || mode == kInt4)
    while (g > 8 && n_vec < 3 * g) g >>= 1;
  return g;
}

// One block per (query row, chunk): blockIdx.x = b * n_chunks + part.
// Dynamic shared memory: q_s[d_pad] f32, then chunk_topk's buffers.
// LARGE: k above topk::kMaxSmemK (chunk_topk's large-k path).
template <int MODE, bool VEC, int G, bool LARGE>
__global__ void __launch_bounds__(kThreads)
    fused_verify_kernel(const void* __restrict__ embs, long long n_rows, int d,
                        const float* __restrict__ scales,
                        const int* __restrict__ row_ids,
                        const int* __restrict__ out_ids,
                        const void* __restrict__ queries,
                        const float* __restrict__ q_scales, int c, int chunk_len,
                        int n_chunks, int k, int* __restrict__ ids_out,
                        float* __restrict__ scores_out, topk::Workspace ws) {
  using Acc = typename Traits<MODE>::Acc;
  constexpr bool kQuant = MODE == kInt8 || MODE == kInt4;
  constexpr int kGroups = 32 / G;  // rows per warp step
  extern __shared__ __align__(16) unsigned char smem[];
  const int d_log = MODE == kInt4 ? 2 * d : d;  // d is the stored width
  const int d_pad = (d_log + 7) & ~7;
  float* q_s = reinterpret_cast<float*>(smem);
  const int lane = threadIdx.x & 31;
  const int grp = lane / G;
  const int gl = lane % G;
  const int warp = threadIdx.x >> 5;
  const long long b = blockIdx.x / n_chunks;
  const int part = static_cast<int>(blockIdx.x - b * n_chunks);
  const size_t row_bytes = static_cast<size_t>(d) * Traits<MODE>::kBytes;
  const char* table = reinterpret_cast<const char*>(embs);
  const float q_scale = kQuant ? q_scales[b] : 1.f;

  stage_query<MODE>(q_s, d_pad, queries, b, d_log);  // chunk_topk syncs

  // Warp w scores heads h0 + u * kGroups + grp, u < kRowsPerWarp, for h0
  // in steps of kWarps * kRowsPerWarp * kGroups.
  auto score_rows = [&](unsigned long long* keys, const unsigned short* heads,
                        int n_heads) {
    constexpr int kStep = kWarps * kRowsPerWarp * kGroups;
    for (int h0 = warp * kRowsPerWarp * kGroups; h0 < n_heads; h0 += kStep) {
      bool val[kRowsPerWarp];
      int slot[kRowsPerWarp];
      const char* rows[kRowsPerWarp];
      Acc acc[kRowsPerWarp];
#pragma unroll
      for (int u = 0; u < kRowsPerWarp; ++u) {
        const int h = h0 + u * kGroups + grp;
        val[u] = h < n_heads;
        slot[u] = val[u] ? heads[h] : 0;
        const long long row = val[u] ? static_cast<long long>(keys[slot[u]] >> 32) : 0;
        rows[u] = table + static_cast<size_t>(row) * row_bytes;
        acc[u] = 0;
      }
      if (VEC) {
        const int n_vec = static_cast<int>(row_bytes / 16);
#pragma unroll 2
        for (int v = gl; v < n_vec; v += G) {
#pragma unroll
          for (int u = 0; u < kRowsPerWarp; ++u)
            if (val[u]) acc[u] = chunk<MODE>(rows[u], v, q_s, acc[u]);
        }
      } else {
        for (int e = gl; e < d_log; e += G) {
#pragma unroll
          for (int u = 0; u < kRowsPerWarp; ++u)
            if (val[u]) acc[u] = elem<MODE>(rows[u], e, q_s, acc[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kRowsPerWarp; ++u) {
#pragma unroll
        for (int off = G / 2; off > 0; off >>= 1)
          acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], off);
      }
      if (gl == 0) {
#pragma unroll
        for (int u = 0; u < kRowsPerWarp; ++u) {
          if (!val[u]) break;
          const unsigned long long key = keys[slot[u]];
          float sc;
          if constexpr (kQuant) {
            sc = __fmul_rn(__int2float_rn(static_cast<int>(acc[u])),
                           __fmul_rn(scales[key >> 32], q_scale));
          } else {
            sc = static_cast<float>(acc[u]);
          }
          keys[slot[u]] = topk::scored_key(sc, key);
        }
      }
    }
  };

  topk::chunk_topk<LARGE>(row_ids + b * c, out_ids + b * c, n_rows, c, chunk_len, part,
                   n_chunks, k, smem + sizeof(float) * d_pad, score_rows,
                   ids_out + b * k, scores_out + b * k, ws, b);
}

template <int MODE, bool VEC, int G, bool LARGE>
cudaError_t launch(const void* embs, long long n_rows, int d,
                   const float* scales, const int* row_ids, const int* out_ids,
                   const void* queries, const float* q_scales, int b, int c,
                   int chunk_len, int n_chunks, int k, int* ids_out,
                   float* scores_out, topk::Workspace ws, cudaStream_t stream) {
  const int d_log = MODE == kInt4 ? 2 * d : d;
  const int d_pad = (d_log + 7) & ~7;
  const size_t smem =
      sizeof(float) * d_pad + topk::chunk_topk_smem(topk::list_len(k, chunk_len), chunk_len);
  auto kern = fused_verify_kernel<MODE, VEC, G, LARGE>;
  cudaError_t err = topk::allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<static_cast<unsigned>(static_cast<long long>(b) * n_chunks), kThreads, smem, stream>>>(
      embs, n_rows, d, scales, row_ids, out_ids, queries, q_scales, c, chunk_len,
      n_chunks, k, ids_out, scores_out, ws);
  return cudaGetLastError();
}

// The kernel for a table mode, 16-byte loads or not, lanes per row and k.
template <int MODE, bool LARGE>
cudaError_t launch_mode(bool vec, int g, const void* embs, long long n_rows, int d,
                        const float* scales, const int* row_ids,
                        const int* out_ids, const void* queries,
                        const float* q_scales, int b, int c, int chunk_len,
                        int n_chunks, int k, int* ids_out, float* scores_out,
                        topk::Workspace ws, cudaStream_t stream) {
#define FV_LAUNCH(VEC, G)                                                        \
  launch<MODE, VEC, G, LARGE>(embs, n_rows, d, scales, row_ids, out_ids, queries, \
                       q_scales, b, c, chunk_len, n_chunks, k, ids_out,         \
                       scores_out, ws, stream)
  if (!vec) return FV_LAUNCH(false, 32);
  if constexpr (MODE == kInt8 || MODE == kInt4) {
    if (g == 8) return FV_LAUNCH(true, 8);
    if (g == 16) return FV_LAUNCH(true, 16);
  }
  return FV_LAUNCH(true, 32);
#undef FV_LAUNCH
}

}  // namespace

// Plain C entry point, bound with ctypes. Returns the cudaError_t of the
// launch (0 on success). The caller validates shapes, dtypes and devices.
//   mode 0: float32 table, queries (B, d) f32
//   mode 1: bfloat16 table, queries (B, d) f32
//   mode 2: int8 code table (N, d) + scales (N,), queries (B, d) int8 codes
//           + q_scales (B,)
//   mode 3: packed int4 table (N, d) with d the stored width (logical 2d),
//           scales, queries (B, 2d) int8 codes + q_scales
// Each query's C candidates go in n_chunks chunks of `chunk_len` (the wrapper's
// split_candidates). With n_chunks > 1, `workspace` holds B * n_chunks * (2L
// + 1) 32-bit words, L = k, or min(k, chunk_len) when k > topk::kMaxSmemK,
// followed in that case by 2 B k words; `arrive` holds B zeroed counters.
extern "C" int fused_verify_launch(const void* embs, int mode, long long n_rows,
                                   int d, const float* scales,
                                   const int* row_ids, const int* out_ids,
                                   const void* queries, const float* q_scales,
                                   int b, int c, int chunk_len, int n_chunks, int k,
                                   int* ids_out, float* scores_out,
                                   void* workspace, int* arrive, void* stream) {
  if (b <= 0) return 0;
  if (k < 1 || chunk_len > topk::kMaxChunk || n_chunks < 1 ||
      static_cast<long long>(chunk_len) * n_chunks < c)
    return static_cast<int>(cudaErrorInvalidValue);
  const int elem = mode == kF32 ? 4 : (mode == kBF16 ? 2 : 1);
  const bool vec = (static_cast<long long>(d) * elem) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(embs) % 16 == 0;
  const int g = lanes_per_row(mode, static_cast<int>(static_cast<long long>(d) * elem / 16));
  const bool large = k > topk::kMaxSmemK;
  const topk::Workspace ws = topk::workspace(workspace, arrive, b, n_chunks, chunk_len, k);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
#define FV_MODE(M)                                                                    \
  (large ? launch_mode<M, true>(vec, g, embs, n_rows, d, scales, row_ids, out_ids,    \
                                queries, q_scales, b, c, chunk_len, n_chunks, k,      \
                                ids_out, scores_out, ws, st)                          \
         : launch_mode<M, false>(vec, g, embs, n_rows, d, scales, row_ids, out_ids,   \
                                 queries, q_scales, b, c, chunk_len, n_chunks, k,     \
                                 ids_out, scores_out, ws, st))
  switch (mode) {
    case kF32:
      err = FV_MODE(kF32);
      break;
    case kBF16:
      err = FV_MODE(kBF16);
      break;
    case kInt8:
      err = FV_MODE(kInt8);
      break;
    case kInt4:
      err = FV_MODE(kInt4);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
#undef FV_MODE
  return static_cast<int>(err);
}
