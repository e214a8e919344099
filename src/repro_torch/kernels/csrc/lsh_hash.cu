// lsh_hash: ESK-LSH hashing. Project each row onto the H*M hyperplanes of
// P, take the sign bit (acc >= 0), and pack M bits per array big-endian into
// one key, without writing the (N, H*M) projection anywhere.
//
// Replaces the TPU kernel repro/kernels/lsh_hash.py::lsh_hash
// (_lsh_hash_kernel).
//
// Contract:
//   * x (N, d) float32 or bfloat16 rows (bfloat16 widens to float32
//     exactly), P (d, H*M) float32, 1 <= M <= 31;
//   * keys (N, H) int32: key[r, a] = sum_i bit(r, a*M + i) << (M - 1 - i),
//     bit(r, j) = (sum_k x[r, k] * P[k, j] >= 0.0f). M <= 31, so every key
//     is non-negative; the wrapper widens to int64.
//
// Row determinism: each (row, bit) sum is one float32 FMA chain over k =
// 0, 1, ..., d-1 in that order (zero-padded past d, which adds exact
// zeros), with no split over d, no atomics and nothing that depends on N or
// on the row's position. A row's keys depend only on the row and on P, so
// hashing a row alone, inside a large batch or at another offset gives the
// same key: what makes an upserted index equal a rebuilt one bit for bit.
//
// What bounds it on an H100: operations. 2*N*d*H*M float32 FLOPs against
// (N*d + d*H*M) * 4 bytes read and 4*N*H written; at the bank fit's chunk
// (165,376 rows, d = 768, H*M = 160) that is 40.6 GFLOP, 0.61 ms at the
// 67 TFLOP/s float32 CUDA-core peak, against 0.15 ms of bytes. The design
// is a plain shared-memory tiled product: a block owns 64 rows and one
// column tile holding whole arrays (floor(64 / M) arrays, so a key never
// spans two tiles; the tiles are the grid's second axis, so a small batch
// of queries still spreads over several blocks); it stages a 64 x 16 slice
// of the rows and a 16 x 64 slice of P in shared memory while walking d,
// each of 256 threads accumulating a 4 x 4 register tile. P (480 KB at
// d = 768, H*M = 160) does not fit in shared memory, hence the walk over d.
// The epilogue writes the tile's sign bits to shared memory and packs each
// (row, array) key from them. No tensor cores and no TF32: either would
// change the bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kBM = 64;        // rows per block
constexpr int kBN = 64;        // columns per tile (at most; whole arrays)
constexpr int kBK = 16;        // depth per stage
constexpr int kPad = 4;        // keeps float4 reads aligned, spreads banks

__device__ __forceinline__ float load_x(const float* x, long long i) {
  return __ldg(x + i);
}
__device__ __forceinline__ float load_x(const __nv_bfloat16* x, long long i) {
  return __bfloat162float(x[i]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    lsh_hash_kernel(const T* __restrict__ x, long long n, int d,
                    const float* __restrict__ proj, int n_arrays, int key_len,
                    int* __restrict__ keys) {
  __shared__ __align__(16) float xs[kBK][kBM + kPad];
  __shared__ __align__(16) float ps[kBK][kBN + kPad];
  __shared__ unsigned char bits[kBM][kBN];

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const long long row0 = static_cast<long long>(blockIdx.x) * kBM;
  const int hm = n_arrays * key_len;
  const int per_tile = kBN / key_len;  // whole arrays per column tile
  const int tile_cols = per_tile * key_len;

  const int a0 = blockIdx.y * per_tile;  // this block's column tile
  const int col0 = a0 * key_len;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < d; k0 += kBK) {
    // Rows: kBM x kBK values, 4 a thread, consecutive threads along k.
#pragma unroll
    for (int l = 0; l < (kBM * kBK) / kThreads; ++l) {
      const int e = tid + l * kThreads;
      const int m = e / kBK, kk = e % kBK;
      const long long r = row0 + m;
      const int k = k0 + kk;
      xs[kk][m] = (r < n && k < d) ? load_x(x, r * d + k) : 0.0f;
    }
    // P: kBK x kBN values, consecutive threads along the columns.
#pragma unroll
    for (int l = 0; l < (kBK * kBN) / kThreads; ++l) {
      const int e = tid + l * kThreads;
      const int kk = e / kBN, j = e % kBN;
      const int k = k0 + kk, col = col0 + j;
      ps[kk][j] = (k < d && j < tile_cols && col < hm)
                      ? __ldg(proj + static_cast<long long>(k) * hm + col)
                      : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ps[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bits[ty * 4 + i][tx * 4 + j] = acc[i][j] >= 0.0f ? 1 : 0;
  __syncthreads();

  const int arrays = min(per_tile, n_arrays - a0);
  for (int p = tid; p < kBM * arrays; p += kThreads) {
    const int m = p / arrays, a = p % arrays;
    const long long r = row0 + m;
    if (r >= n) continue;
    int key = 0;
    for (int i = 0; i < key_len; ++i) key = (key << 1) | bits[m][a * key_len + i];
    keys[r * n_arrays + a0 + a] = key;
  }
}

template <typename T>
cudaError_t launch(const void* x, long long n, int d, const float* proj,
                   int n_arrays, int key_len, int* keys, cudaStream_t stream) {
  const int per_tile = kBN / key_len;
  const dim3 grid(static_cast<unsigned>((n + kBM - 1) / kBM),
                  static_cast<unsigned>((n_arrays + per_tile - 1) / per_tile));
  lsh_hash_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), n, d, proj, n_arrays, key_len, keys);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. ``x_bf16`` selects the row type
// (0: float32, 1: bfloat16). Returns the cudaError_t of the launch (0 on
// success). The caller validates shapes, dtypes, devices and
// 1 <= key_len <= 31.
extern "C" int lsh_hash_launch(const void* x, int x_bf16, long long n, int d,
                               const float* proj, int n_arrays, int key_len,
                               int* keys, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const cudaError_t err =
      x_bf16 ? launch<__nv_bfloat16>(x, n, d, proj, n_arrays, key_len, keys, st)
             : launch<float>(x, n, d, proj, n_arrays, key_len, keys, st);
  return static_cast<int>(err);
}
