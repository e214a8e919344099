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
//     x_sq, c_sq and dot are float32 FMA chains over k = 0 .. d-1;
//   * min_d (N,) float32: that minimum.
//
// Ties: each thread walks its centroids in ascending order with a strict
// "<", so it keeps the first minimum it sees; the 16 threads that share a
// row then reduce their (distance, index) pairs with ties to the smaller
// index, so the result is the first minimum over all c centroids. There is
// no padding of the centroid axis (the JAX wrapper pads with 1e18, which
// works only because (1e18)^2 * d overflows to inf): the loops are bounded.
//
// Row determinism: |x|^2, |c|^2 and every dot product are sequential FMA
// chains over d in a fixed order (zero-padded past d, which adds exact
// zeros), computed inside the block that owns the row, with no split over
// d, no atomics and nothing that depends on N or the row's position. A
// row's assignment depends only on the row and the centroids, so an
// upserted row lands where a rebuild puts it.
//
// What bounds it on an H100: operations. 2*N*c*d float32 FLOPs (1.65 TFLOP
// at N = 1,048,576, c = 1024, d = 768: 24.6 ms at the 67 TFLOP/s float32
// CUDA-core peak) against (N + c) * d * 4 bytes read and 8N written (0.96
// ms). The design is the classic SIMT tiled product: a block owns 128 rows
// and walks the centroids in tiles of 128; for each tile it walks d in
// 8-deep stages, and each of 256 threads accumulates an 8 x 8 register
// tile (8 rows x 8 centroids), then folds it into its running (min,
// argmin) per row. The stages are double-buffered in shared memory: each
// thread loads its share of the next stage from global memory into
// registers (16-byte loads when d % 4 == 0) before it computes on the
// current one, so the loads overlap the FMAs and one barrier per stage
// suffices. No tensor cores and no TF32: either would change assignments.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kBM = 128;       // rows per block
constexpr int kBN = 128;       // centroids per tile
constexpr int kBK = 8;         // depth per stage
constexpr int kTM = 8, kTN = 8;  // register tile per thread
constexpr int kPad = 4;        // keeps float4 reads aligned, spreads banks
constexpr int kLoads = (kBM * kBK) / kThreads;  // values a thread stages, per table

// A thread's share of one stage: kLoads values of the rows and of the
// centroids, at (m, kk) = e / kBK, e % kBK for e = tid * kLoads + l, so one
// thread holds kLoads consecutive k of one row (a 16-byte load when VEC).
template <bool VEC>
__device__ __forceinline__ void load_stage(const float* __restrict__ x, long long n,
                                           int d, const float* __restrict__ cen,
                                           int c, long long row0, int c0, int k0,
                                           float (&xr)[kLoads], float (&cr)[kLoads]) {
  const int e = threadIdx.x * kLoads;
  const int m = e / kBK, kk = e % kBK;
  const long long r = row0 + m;
  const int j = c0 + m;
  const int k = k0 + kk;
  if (VEC) {  // d % 4 == 0 and k % 4 == 0: the 4 values are all in or all out
    const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float4 a = (r < n && k < d)
                         ? __ldg(reinterpret_cast<const float4*>(x + r * d + k)) : z;
    const float4 b = (j < c && k < d)
                         ? __ldg(reinterpret_cast<const float4*>(
                               cen + static_cast<long long>(j) * d + k))
                         : z;
    xr[0] = a.x; xr[1] = a.y; xr[2] = a.z; xr[3] = a.w;
    cr[0] = b.x; cr[1] = b.y; cr[2] = b.z; cr[3] = b.w;
  } else {
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      xr[l] = (r < n && k + l < d) ? __ldg(x + r * d + k + l) : 0.0f;
      cr[l] = (j < c && k + l < d)
                  ? __ldg(cen + static_cast<long long>(j) * d + k + l) : 0.0f;
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    kmeans_assign_kernel(const float* __restrict__ x, long long n, int d,
                         const float* __restrict__ cen, int c,
                         int* __restrict__ assign_out,
                         float* __restrict__ min_out) {
  __shared__ __align__(16) float xs[2][kBK][kBM + kPad];
  __shared__ __align__(16) float cs[2][kBK][kBN + kPad];
  __shared__ float x_sq[kBM];
  __shared__ float c_sq[kBN];
  __shared__ float red_d[kBM][16];
  __shared__ int red_i[kBM][16];

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const long long row0 = static_cast<long long>(blockIdx.x) * kBM;
  const int sm = (tid * kLoads) / kBK, skk = (tid * kLoads) % kBK;  // where the share goes

  float best_d[kTM];
  int best_i[kTM];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    best_d[i] = __int_as_float(0x7f800000);  // +inf
    best_i[i] = 0;
  }

  for (int c0 = 0; c0 < c; c0 += kBN) {
    float acc[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;
    float sq = 0.0f;  // |x|^2 (threads < kBM, first tile) or |c|^2 (the rest)

    float xr[kLoads], cr[kLoads];
    load_stage<VEC>(x, n, d, cen, c, row0, c0, 0, xr, cr);
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      xs[0][skk + l][sm] = xr[l];
      cs[0][skk + l][sm] = cr[l];
    }
    __syncthreads();

    int buf = 0;
    for (int k0 = 0; k0 < d; k0 += kBK) {
      const bool more = k0 + kBK < d;
      if (more) load_stage<VEC>(x, n, d, cen, c, row0, c0, k0 + kBK, xr, cr);
      if (tid < kBM) {
        if (c0 == 0) {
#pragma unroll
          for (int kk = 0; kk < kBK; ++kk)
            sq = fmaf(xs[buf][kk][tid], xs[buf][kk][tid], sq);
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < kBK; ++kk) {
          const float v = cs[buf][kk][tid - kBM];
          sq = fmaf(v, v, sq);
        }
      }
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        float av[kTM], bv[kTN];
        const float4 a0 = *reinterpret_cast<const float4*>(&xs[buf][kk][ty * kTM]);
        const float4 a1 = *reinterpret_cast<const float4*>(&xs[buf][kk][ty * kTM + 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&cs[buf][kk][tx * kTN]);
        const float4 b1 = *reinterpret_cast<const float4*>(&cs[buf][kk][tx * kTN + 4]);
        av[0] = a0.x; av[1] = a0.y; av[2] = a0.z; av[3] = a0.w;
        av[4] = a1.x; av[5] = a1.y; av[6] = a1.z; av[7] = a1.w;
        bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
        bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      if (more) {
        // The other buffer was last read in the previous stage, before the
        // barrier that ended it.
#pragma unroll
        for (int l = 0; l < kLoads; ++l) {
          xs[buf ^ 1][skk + l][sm] = xr[l];
          cs[buf ^ 1][skk + l][sm] = cr[l];
        }
      }
      __syncthreads();
      buf ^= 1;
    }
    if (tid < kBM) {
      if (c0 == 0) x_sq[tid] = sq;
    } else {
      c_sq[tid - kBM] = sq;
    }
    __syncthreads();

    // Epilogue: (x_sq - 2 dot) + c_sq, rounded step by step (no FMA
    // contraction), folded into the running first minimum.
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const float xs_i = x_sq[ty * kTM + i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int jj = c0 + tx * kTN + j;
        if (jj < c) {
          const float dist = __fadd_rn(__fsub_rn(xs_i, __fmul_rn(2.0f, acc[i][j])),
                                       c_sq[tx * kTN + j]);
          if (dist < best_d[i]) {
            best_d[i] = dist;
            best_i[i] = jj;
          }
        }
      }
    }
    __syncthreads();  // c_sq and the stage buffers are rewritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    red_d[ty * kTM + i][tx] = best_d[i];
    red_i[ty * kTM + i][tx] = best_i[i];
  }
  __syncthreads();
  if (tid < kBM) {
    const long long r = row0 + tid;
    if (r < n) {
      float bd = red_d[tid][0];
      int bi = red_i[tid][0];
      for (int t = 1; t < 16; ++t) {
        const float dd = red_d[tid][t];
        const int ii = red_i[tid][t];
        if (dd < bd || (dd == bd && ii < bi)) {
          bd = dd;
          bi = ii;
        }
      }
      assign_out[r] = bi;
      min_out[r] = bd;
    }
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. Returns the cudaError_t of the
// launch (0 on success). The caller validates shapes, dtypes, devices and
// c >= 1.
extern "C" int kmeans_assign_launch(const float* x, long long n, int d,
                                    const float* centroids, int c, int* assign,
                                    float* min_d, void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + kBM - 1) / kBM;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(centroids) % 16 == 0;
  if (vec)
    kmeans_assign_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        x, n, d, centroids, c, assign, min_d);
  else
    kmeans_assign_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        x, n, d, centroids, c, assign, min_d);
  return static_cast<int>(cudaGetLastError());
}
