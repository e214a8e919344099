// kmeans_assign: nearest-centroid assignment. For each row, the squared L2
// distance to every centroid as |x|^2 - 2 x.c + |c|^2, and the running
// (min, argmin) over the centroids, without writing the (N, c) distance
// matrix anywhere.
//
// Replaces the TPU kernel repro/kernels/kmeans_assign.py::kmeans_assign
// (_kmeans_assign_kernel).
//
// Contract:
//   * x (N, d) float32 rows, centroids (c, d) float32, c >= 1;
//   * assign (N,) int32: the first centroid index reaching the minimum of
//     dist(r, j) = (x_sq[r] - 2 * dot(r, j)) + c_sq[j], in that order, where
//     x_sq and c_sq are float32 FMA chains over k = 0 .. d-1 and dot is the
//     split-TF32 product below;
//   * min_d (N,) float32: that minimum;
//   * x's rows ld floats apart, x 16-byte aligned and ld % 4 == 0 (the
//     tensor map's rule; the wrapper copies other rows into such a buffer).
//
// Two launches: kmeans_assign_norms_kernel writes c_sq and the centroids'
// TF32 splits (zero-padded to whole tiles) into a scratch the wrapper
// allocates (kmeans_assign_scratch_floats), once per call;
// kmeans_assign_kernel does the rest.
//
// Ties: each thread walks its centroids in ascending order with a strict
// "<", so it keeps the first minimum it sees; the 4 threads of a quad that
// share a row then reduce their (distance, index) pairs with ties to the
// smaller index, so the result is the first minimum over all c centroids.
// Padded centroids (past c) are never compared.
//
// The dot product on the tensor cores, in split TF32 ("3xTF32"): each
// float32 v is written as big + small, big = tf32(v), small = tf32(v - big)
// (rounded as cvt.rna rounds; TF32 keeps 10 mantissa bits, so v - big is
// exact and small leaves at most 2^-22 |v| out). x.c is the
// float32-accumulated sum of
// small_x*big_c + big_x*small_c + big_x*big_c (wgmma TF32 -> float32, the
// small terms first in each 8-deep step); small_x*small_c (~2^-22 |x_k c_k|)
// is dropped. Per term that errs by ~3 * 2^-22 |x_k c_k|, so the distance
// errs by at most ~7e-7 of |x|^2 + |c|^2 (the size testing.min_dist_error
// divides by) and typically ~sqrt(d) less. A single TF32 product errs ~2^11
// times more, which the float64 gate refuses. The tensor cores truncate
// their float32 sums, so a chain through their accumulator over all d
// drifts one way on the positive sums of a row and its own centroid (5.7 x
// the plain version's float64 error on the main path's data, against 1.0 x
// with the restart, measured on an H100): each 32-deep stage's products go
// into a partial that starts from zero, and the partial is added to the
// running dot with an IEEE float32 add.
//
// Row determinism: |x|^2 and |c|^2 are sequential FMA chains over d; the dot
// of (row, centroid) is the same instruction sequence on the same values
// wherever the row or the centroid sits: its 32-deep stages in ascending k
// (zero-padded past d, which adds exact zeros), each stage's 12 wgmma in a
// fixed order into a partial, the partials added in order; a wgmma output
// depends only on its row of A, its column of B and its input sum. No split
// over d, no atomics, nothing that depends on N or on the row's position.
// Equal centroids give equal dots. A row's assignment depends only on the
// row and the centroids, so an upserted row lands where a rebuild puts it.
//
// What bounds it on an H100: operations. Three TF32 products of 2*N*c*d
// (4.95 TFLOP at N = 1,048,576, c = 1024, d = 768: 10.0 ms at the 495
// TFLOP/s dense TF32 peak; the 1.65 TFLOP of one float32 product would
// take 24.6 ms at the 67 TFLOP/s float32 CUDA-core peak) against (N + c) *
// d * 4 bytes read and 8N written (0.96 ms). mma.sync reaches ~320 TFLOP/s
// of TF32 on the card (15.5 ms for the three products), and a 128 x 128
// mma.sync tile with every split in registers took ~36 ms, issue-bound;
// so the products are warpgroup MMAs (wgmma m64n128k8: A, the rows, from
// registers, split there; B, the centroids, from shared memory, split once
// per call), which issue 64 times the work per instruction. The design: a
// block of 2 warpgroups owns 128 rows (64 each) and walks the centroids in
// tiles of 128. Each 32-deep stage (the rows, and the centroids' big and
// small planes: three 128 x 32 float32 boxes, 128-byte swizzled, zeros past
// N and d) comes by TMA into a 4-stage ring in shared memory; one thread
// issues the loads, a "full" mbarrier per slot says a stage has landed and
// an "empty" one that all 8 warps are done with it, so the warpgroups run
// without a block-wide barrier and one's adds overlap the other's products.
// Per stage a warp loads and splits its rows' fragments, issues 12 wgmma
// into the partial, waits, and adds the partial to its running dots. |x|^2
// is computed once per row while the ring fills, |c|^2 and the centroid
// splits once per call. At the end of each centroid tile the distances fold
// into a running (min, first argmin) per row in registers.

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;  // 2 warpgroups, 64 rows each
constexpr int kBM = 128;       // rows per block
constexpr int kBN = 128;       // centroids per tile (wgmma n)
constexpr int kBK = 32;        // depth per stage: 128 bytes, one swizzle row
constexpr int kStages = 4;     // TMA ring
constexpr int kTileBytes = 128 * kBK * 4;  // a 128 x 32 float32 tile, 16 KB
constexpr int kStageBytes = 3 * kTileBytes;  // centroid big, centroid small, rows
constexpr size_t kSmemBytes = static_cast<size_t>(kStages) * kStageBytes + 1024;  // + alignment
constexpr int kPrepThreads = 256;

// d (64 x 128 over the warpgroup) = A (64 x 8, registers) * B (8 x 128,
// shared memory) + (accumulate ? d : 0), TF32 in, float32 sums.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// Scratch layout (floats): big (c_pad, d_pad), small (c_pad, d_pad), c_sq
// (c_pad); c_pad and d_pad are whole tiles and stages.
struct Scratch {
  int c_pad, d_pad;
  __host__ __device__ Scratch(int c, int d)
      : c_pad(static_cast<int>(round_up(c, kBN))), d_pad(static_cast<int>(round_up(d, kBK))) {}
  __host__ __device__ long long plane() const { return static_cast<long long>(c_pad) * d_pad; }
  __host__ __device__ long long floats() const { return 2 * plane() + c_pad; }
};

// Sequential FMA chain over k = 0 .. d-1 of v_k^2 (16-byte loads where v
// is 16-byte aligned and d % 4 == 0).
__device__ __forceinline__ float sq_norm(const float* __restrict__ v, int d) {
  float s = 0.0f;
  if (d % 4 == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0) {
    const float4* v4 = reinterpret_cast<const float4*>(v);
#pragma unroll 8
    for (int k = 0; k < d / 4; ++k) {
      const float4 a = __ldg(v4 + k);
      s = fmaf(a.x, a.x, s);
      s = fmaf(a.y, a.y, s);
      s = fmaf(a.z, a.z, s);
      s = fmaf(a.w, a.w, s);
    }
  } else {
#pragma unroll 8
    for (int k = 0; k < d; ++k) {
      const float a = __ldg(v + k);
      s = fmaf(a, a, s);
    }
  }
  return s;
}

// The centroids' splits, zero-padded to (c_pad, d_pad), one thread an
// element; then, in the last ceil(c / kPrepThreads) blocks, |c|^2.
__global__ void __launch_bounds__(kPrepThreads)
    kmeans_assign_norms_kernel(const float* __restrict__ cen, int c, int d,
                               float* __restrict__ scratch) {
  const Scratch sc(c, d);
  const long long split_blocks = (sc.plane() + kPrepThreads - 1) / kPrepThreads;
  if (blockIdx.x < split_blocks) {
    const long long i = static_cast<long long>(blockIdx.x) * kPrepThreads + threadIdx.x;
    if (i >= sc.plane()) return;
    const int j = static_cast<int>(i / sc.d_pad), k = static_cast<int>(i % sc.d_pad);
    const float v = j < c && k < d ? __ldg(cen + static_cast<long long>(j) * d + k) : 0.0f;
    uint32_t big, small;
    split(v, big, small);
    scratch[i] = __uint_as_float(big);
    scratch[sc.plane() + i] = __uint_as_float(small);
  } else {
    const int j = static_cast<int>(blockIdx.x - split_blocks) * kPrepThreads + threadIdx.x;
    if (j < c) scratch[2 * sc.plane() + j] = sq_norm(cen + static_cast<long long>(j) * d, d);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    kmeans_assign_kernel(const __grid_constant__ CUtensorMap x_map,
                         const __grid_constant__ CUtensorMap c_map, const float* __restrict__ x,
                         long long ld, long long n, int d, int c,
                         const float* __restrict__ scratch, int* __restrict__ assign_out,
                         float* __restrict__ min_out) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ float x_sq_s[kBM];
  __shared__ __align__(8) uint64_t full_bar[kStages], empty_bar[kStages];
  const uint32_t ring = static_cast<uint32_t>(round_up(smem_addr(smem_raw), 1024));
  const unsigned char* ring_ptr = smem_raw + (ring - smem_addr(smem_raw));

  const Scratch sc(c, d);
  const float* c_sq = scratch + 2 * sc.plane();
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;  // mma groupID, thread in group
  const int row_w = warp * 16;           // this warp's 16 rows of the block (64 per warpgroup)
  const long long row0 = static_cast<long long>(blockIdx.x) * kBM;
  const int k_tiles = sc.d_pad / kBK;
  const int total = (sc.c_pad / kBN) * k_tiles;  // (centroid tile, stage) pairs, flattened

  // Stage s: the 128 x 32 boxes of the centroids' big and small planes at
  // (k, c0) and (k, c_pad + c0), and of the rows at (k, row0).
  auto issue = [&](int s) {
    const uint32_t dst = ring + (s % kStages) * kStageBytes, bar = smem_addr(&full_bar[s % kStages]);
    const int c0 = (s / k_tiles) * kBN, k0 = (s % k_tiles) * kBK;
    mbar_expect(bar, kStageBytes);
    tma_load(dst, &c_map, k0, c0, bar);
    tma_load(dst + kTileBytes, &c_map, k0, sc.c_pad + c0, bar);
    tma_load(dst + 2 * kTileBytes, &x_map, k0, static_cast<int>(row0), bar);
  };
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(smem_addr(&full_bar[i]), 1);
      mbar_init(smem_addr(&empty_bar[i]), kThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < kStages - 1 && s < total; ++s) issue(s);
  }
  // |x|^2 while the ring fills.
  if (tid < kBM) x_sq_s[tid] = row0 + tid < n ? sq_norm(x + (row0 + tid) * ld, d) : 0.0f;
  __syncthreads();

  // This thread's rows: row_w + g and row_w + g + 8.
  const float x_sq[2] = {x_sq_s[row_w + g], x_sq_s[row_w + g + 8]};
  float best_d[2] = {__int_as_float(0x7f800000), __int_as_float(0x7f800000)};  // +inf
  int best_i[2] = {0, 0};

  float acc[64], part[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = part[e] = 0.0f;

  for (int it = 0; it < total; ++it) {
    const int slot = it % kStages;
    if (tid == 0 && it + kStages - 1 < total) {
      // Refill the slot stage it - 1 used, once both warpgroups are done with it.
      if (it >= 1) mbar_wait(smem_addr(&empty_bar[(it - 1) % kStages]), ((it - 1) / kStages) & 1);
      issue(it + kStages - 1);
    }
    __syncwarp();
    mbar_wait(smem_addr(&full_bar[slot]), (it / kStages) & 1);

    // Fragments of this warp's rows: (g, k), (g + 8, k), (g, k + 4), (g + 8,
    // k + 4) for k = 8 ks + t; row r's 16-byte chunk q sits at q ^ (r % 8).
    const unsigned char* xs = ring_ptr + slot * kStageBytes + 2 * kTileBytes;
    uint32_t a_big[kBK / 8][4], a_small[kBK / 8][4];
#pragma unroll
    for (int ks = 0; ks < kBK / 8; ++ks) {
      const unsigned char* lo = xs + (row_w + g) * 128 + t * 4;
      const unsigned char* hi = lo + 8 * 128;
      const int q0 = ((2 * ks) ^ g) * 16, q1 = ((2 * ks + 1) ^ g) * 16;
      split(*reinterpret_cast<const float*>(lo + q0), a_big[ks][0], a_small[ks][0]);
      split(*reinterpret_cast<const float*>(hi + q0), a_big[ks][1], a_small[ks][1]);
      split(*reinterpret_cast<const float*>(lo + q1), a_big[ks][2], a_small[ks][2]);
      split(*reinterpret_cast<const float*>(hi + q1), a_big[ks][3], a_small[ks][3]);
    }
    const uint32_t stage = ring + slot * kStageBytes;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBK / 8; ++ks) {
      const uint64_t b_big = sw128_desc(stage + ks * 32);
      const uint64_t b_small = sw128_desc(stage + kTileBytes + ks * 32);
      wgmma_tf32(part, a_small[ks], b_big, ks > 0);  // the stage's partial starts at zero
      wgmma_tf32(part, a_big[ks], b_small, 1);
      wgmma_tf32(part, a_big[ks], b_big, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    if (lane == 0) mbar_arrive(smem_addr(&empty_bar[slot]));

#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = __fadd_rn(acc[e], part[e]);

    if (it % k_tiles == k_tiles - 1) {
      // Epilogue of a centroid tile: (x_sq - 2 dot) + c_sq, rounded step by
      // step (no FMA contraction), folded into the running first minimum;
      // this thread's centroids in ascending order (8-column block j, then
      // e). acc[4 j + 2 h + e] is (row g + 8 h, centroid 8 j + 2 t + e).
      const int c0 = (it / k_tiles) * kBN;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int jj = c0 + 8 * j + 2 * t + e;
          if (jj < c) {
            const float csq = __ldg(c_sq + jj);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float dist =
                  __fadd_rn(__fsub_rn(x_sq[h], __fmul_rn(2.0f, acc[4 * j + 2 * h + e])), csq);
              if (dist < best_d[h]) {
                best_d[h] = dist;
                best_i[h] = jj;
              }
            }
          }
        }
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e] = 0.0f;
    }
  }

  // The 4 threads of a quad hold the same rows: ties to the smaller index.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int off = 1; off < 4; off *= 2) {
      const float od = __shfl_xor_sync(0xffffffffu, best_d[h], off);
      const int oi = __shfl_xor_sync(0xffffffffu, best_i[h], off);
      if (od < best_d[h] || (od == best_d[h] && oi < best_i[h])) {
        best_d[h] = od;
        best_i[h] = oi;
      }
    }
    const long long r = row0 + row_w + g + 8 * h;
    if (t == 0 && r < n) {
      assign_out[r] = best_i[h];
      min_out[r] = best_d[h];
    }
  }
}

// A (rows, cols) float32 tensor with rows ld floats apart, read in 128 x
// 32 boxes, 128-byte swizzled, zeros outside.
int encode(CUtensorMap* map, const float* base, long long rows, long long cols, long long ld) {
  return encode_2d(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, base, rows, cols, ld * 4, kBK, 128,
                   CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace

// Floats of scratch a call needs for c centroids of width d.
extern "C" long long kmeans_assign_scratch_floats(int c, int d) { return Scratch(c, d).floats(); }

// Plain C entry point, bound with ctypes: the centroid splits and norms into
// scratch (kmeans_assign_scratch_floats(c, d) float32), then the
// assignment. x's rows are ld floats apart; x must be 16-byte aligned and
// ld % 4 == 0 (the tensor map's rule). Returns a cudaError_t (0 on
// success). The caller validates shapes, dtypes, devices and c >= 1.
extern "C" int kmeans_assign_launch(const float* x, long long n, int d, long long ld,
                                    const float* centroids, int c, float* scratch, int* assign,
                                    float* min_d, void* stream) {
  if (n <= 0) return 0;
  if (ld % 4 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const Scratch sc(c, d);
  CUtensorMap x_map, c_map;
  int err = encode(&x_map, x, n, d, ld);
  if (err == 0) err = encode(&c_map, scratch, 2LL * sc.c_pad, sc.d_pad, sc.d_pad);
  if (err != 0) return err;
  const long long prep_blocks =
      (sc.plane() + kPrepThreads - 1) / kPrepThreads + (c + kPrepThreads - 1) / kPrepThreads;
  kmeans_assign_norms_kernel<<<static_cast<unsigned>(prep_blocks), kPrepThreads, 0, st>>>(
      centroids, c, d, scratch);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(kmeans_assign_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(kSmemBytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  kmeans_assign_kernel<<<static_cast<unsigned>((n + kBM - 1) / kBM), kThreads, kSmemBytes, st>>>(
      x_map, c_map, x, ld, n, d, c, scratch, assign, min_d);
  return static_cast<int>(cudaGetLastError());
}
