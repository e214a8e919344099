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
//     bit(r, j) = (dot(r, j) >= 0.0f), dot the split-TF32 product below.
//     M <= 31, so every key is non-negative; the wrapper widens to int64;
//   * x's rows ld elements apart, x 16-byte aligned and ld * (element size)
//     a multiple of 16; P's rows ld_p floats apart, P 16-byte aligned and
//     ld_p % 4 == 0 (the tensor maps' rule; the wrapper copies other
//     tensors into such buffers).
//
// The product on the tensor cores, in split TF32 ("3xTF32", as in
// kmeans_assign.cu): each float32 v is big + small, big = tf32(v), small =
// tf32(v - big) (rounded to nearest, ties away, as cvt.rna rounds; small
// leaves at most 2^-22 |v| out). x.P_j is the float32-accumulated sum of
// small_x*big_P + big_x*small_P + big_x*big_P (wgmma TF32 -> float32, in
// that order at each 8-deep step); small_x*small_P is dropped. Each term
// errs by at most ~3 * 2^-22 |x_k P_kj|, and the sums by a few float32
// roundings of sum_k |x_k P_kj|, so a bit can differ from the
// exact sign only where |x.P_j| is within ~2^-20 sum_k |x_k P_kj|: ~45 x inside
// the d * 2^-24 sum_k |x_k P_kj| bound (at d = 768) that testing.lsh_key_flips
// admits. One TF32 product errs ~2^11 times more per term and puts bits
// outside that bound. The tensor cores truncate their float32 sums, so each
// 32-deep stage's products go into a partial that starts from zero, added to
// the running dot with an IEEE float32 add. A bfloat16 row widens exactly to
// a TF32 value: its big half is the value, its small half 0, so it runs the
// same instructions on the same values as its float32 widening.
//
// Row determinism: the dot of (row, column) is one instruction sequence on
// the same values wherever the row or the column sits: the 32-deep stages in
// ascending k (zero-padded past d, which adds exact zeros), each stage's 12
// wgmma m64n80k8 in a fixed order into a partial, the partials added in
// order; a wgmma output depends only on its row of A, its column of B and its
// input sum. No split over d, no atomics; the grid depends on H and M alone.
// So a row hashed alone, inside a large batch or at another offset gets the
// same key: what makes an upserted index equal a rebuilt one bit for bit.
//
// What bounds it on an H100: operations. Three TF32 products of 2*N*d*H*M
// (121.9 GFLOP at the bank fit's chunk, N = 165,376, d = 768, H*M = 160:
// 0.246 ms at the 495 TFLOP/s dense TF32 peak; one float32 product on the
// CUDA cores would take 0.61 ms at 67 TFLOP/s) against (N*d + d*H*M) * 4
// bytes read and 4*N*H written (0.154 ms). The design: a block owns 64 rows
// (the wgmma m) and walks d once for every column it owns, so the rows are
// read from HBM once. Each of its two warpgroups owns a tile of whole arrays
// (at most 80 columns, one wgmma n), so a key never spans two tiles (at H*M
// = 160, 5 arrays of 16 each: every column in one block). Blocks of one
// warpgroup fault on the card (an illegal instruction, cause unknown), so a
// block always has two; one past the last array computes zeros. Each
// 32-deep stage (a 64 x 32 box of the rows, 128-byte swizzled, and a
// 32-deep box of P's columns for the whole block, both by TMA, zeros past
// N, d and H*M) comes into a 4-stage ring; one thread issues the loads, a
// "full" mbarrier per slot says a stage has landed and an "empty" one that
// every warp is done with it. Per stage a warpgroup
// splits its columns of P into big and small planes in the K-major, 128-byte
// swizzled layout wgmma reads, and its rows' fragments in registers (the A
// operand), releases the slot, and after a barrier of its own 128 threads
// issues the stage's 12 wgmma into the partial. It splits stage it + 1 while
// stage it's products run (two slots of planes, two sets of fragments), then
// waits and adds the partial to its running dots. P is split in shared memory
// by every block, so a call is one launch; P (0.5 MB at d = 768, H*M = 160)
// comes from L2 once per 64 rows. At the end each thread writes its sign
// bits to shared memory and the warpgroup packs its keys. On the card that
// split of P, not the products, takes most of the time (the ablations of
// scripts/lsh_variants.py).

#include "hopper.cuh"

namespace {

constexpr int kN = 80;          // columns of a warpgroup's tile (the wgmma n)
constexpr int kBM = 64;         // rows per block (the wgmma m)
constexpr int kBK = 32;         // depth per stage: 128 bytes of float32, one swizzle row
constexpr int kStages = 4;      // TMA ring
constexpr int kWarpgroups = 2;   // a block: two tiles of the same 64 rows
constexpr int kThreads = kWarpgroups * 128;
constexpr int kBoxCols = kWarpgroups * kN;  // columns of P's box a stage
constexpr int kXSlot = kBM * kBK * 4;       // a 64 x 32 float32 box, 8 KB (bfloat16 uses half)
constexpr int kStageBytes = kXSlot + kBK * kBoxCols * 4;
constexpr int kPlanesBytes = 4 * kN * 128;  // a warpgroup's two slots of big and small planes
// The ring, each warpgroup's planes, and 1024 bytes to align the swizzled
// tiles.
constexpr size_t kSmemBytes = 1024 + kStages * kStageBytes + kWarpgroups * kPlanesBytes;

// d (64 x 80 over the warpgroup) = A (64 x 8, registers) * B (8 x 80,
// shared memory) + (accumulate ? d : 0), TF32 in, float32 sums.
__device__ __forceinline__ void wgmma_n80(float (&d)[kN / 2], const uint32_t (&a)[4], uint64_t b,
                                          int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, const uint32_t (&v)[4]) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v[0]), "r"(v[1]),
               "r"(v[2]), "r"(v[3])
               : "memory");
}

// Row r, depth k of a stage's box of rows. float32: rows 128 bytes apart,
// 16-byte chunk q of row r at q ^ (r % 8) (the TMA's 128-byte swizzle).
// bfloat16: rows 64 bytes apart, not swizzled; widened exactly.
template <bool kBf16>
__device__ __forceinline__ float x_at(const unsigned char* xs, int r, int k) {
  if constexpr (kBf16) {
    const uint32_t h = *reinterpret_cast<const uint16_t*>(xs + r * 64 + k * 2);
    return __uint_as_float(h << 16);
  } else {
    return *reinterpret_cast<const float*>(xs + r * 128 + (((k >> 2) ^ (r & 7)) << 4) + ((k & 3) << 2));
  }
}

// Block b: row block b / n_groups, tile group b % n_groups; warpgroup w of a
// block owns tile (group * kWarpgroups + w), arrays [tile * arrays, ...).
template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 1)
    lsh_hash_kernel(const __grid_constant__ CUtensorMap x_map,
                    const __grid_constant__ CUtensorMap p_map, long long n, int d, int n_arrays,
                    int key_len, int arrays, int n_groups, int* __restrict__ keys) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kStages], empty_bar[kStages];
  const uint32_t base = static_cast<uint32_t>(round_up(smem_addr(smem_raw), 1024));
  unsigned char* base_ptr = smem_raw + (base - smem_addr(smem_raw));

  constexpr int kLoadBytes = kBM * kBK * (kBf16 ? 2 : 4) + kBK * kBoxCols * 4;

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int wg = warp / 4, tw = tid % 128;
  const int g = lane / 4, t = lane % 4;  // mma groupID, thread in group
  const int row_w = (warp % 4) * 16;     // this warp's 16 of the block's 64 rows
  const int group = static_cast<int>(blockIdx.x % n_groups);
  const long long row0 = static_cast<long long>(blockIdx.x / n_groups) * kBM;
  const int a0 = (group * kWarpgroups + wg) * arrays;  // this warpgroup's first array
  const int my_arrays = max(0, min(arrays, n_arrays - a0));
  const int cols = my_arrays * key_len;        // its columns that hold keys
  // P's box starts at a 16-byte aligned column, up to 3 before the group's
  // first: a TMA box whose first coordinate is not 16-byte aligned raised an
  // illegal instruction on the card (H*M = 15 x 15, the group at column
  // 150). Every tile is at most kN columns, so off + cols <= kBoxCols.
  const int first = group * kWarpgroups * arrays * key_len;
  const int col0 = first & ~3;
  const int off = (first - col0) + wg * arrays * key_len;  // where its columns start in the box
  const int k_tiles = (d + kBK - 1) / kBK;
  const uint32_t planes = base + kStages * kStageBytes + wg * kPlanesBytes;

  // Stage s: the 64 x 32 box of rows at (k, row0) and the 32-deep box of P
  // at (col0, k).
  auto issue = [&](int s) {
    const uint32_t dst = base + (s % kStages) * kStageBytes, bar = smem_addr(&full_bar[s % kStages]);
    mbar_expect(bar, kLoadBytes);
    tma_load(dst, &x_map, s * kBK, static_cast<int>(row0), bar);
    tma_load(dst + kXSlot, &p_map, col0, s * kBK, bar);
  };
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(smem_addr(&full_bar[i]), 1);
      mbar_init(smem_addr(&empty_bar[i]), kThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < kStages - 1 && s < k_tiles; ++s) issue(s);
  }
  __syncthreads();

  float acc[kN / 2], part[kN / 2];
#pragma unroll
  for (int e = 0; e < kN / 2; ++e) acc[e] = part[e] = 0.0f;

  // Stage it's operands: wait for its loads, split this warpgroup's columns
  // of P into the big and small planes of slot it % 2 and its rows'
  // fragments into registers, release the ring slot.
  auto load_stage = [&](int it, uint32_t (&a_big)[kBK / 8][4], uint32_t (&a_small)[kBK / 8][4]) {
    const int slot = it % kStages;
    if (tid == 0 && it + kStages - 1 < k_tiles) {
      // Refill the slot stage it - 1 used, once every warp is done with it.
      if (it >= 1) mbar_wait(smem_addr(&empty_bar[(it - 1) % kStages]), ((it - 1) / kStages) & 1);
      issue(it + kStages - 1);
    }
    __syncwarp();
    mbar_wait(smem_addr(&full_bar[slot]), (it / kStages) & 1);
    const unsigned char* xs = base_ptr + slot * kStageBytes;
    const float* raw = reinterpret_cast<const float*>(xs + kXSlot);
    // Plane row nn (column off + nn of P's box) holds the stage's 32 k, its
    // 16-byte chunk q at q ^ (nn % 8); columns past `cols` are zeros.
    const uint32_t big_plane = planes + (it & 1) * (2 * kN * 128), small_plane = big_plane + kN * 128;
#pragma unroll
    for (int e = tw; e < kN * 8; e += 128) {
      const int nn = e % kN, q = e / kN;
      uint32_t big[4], small[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        split(nn < cols ? raw[(4 * q + i) * kBoxCols + off + nn] : 0.0f, big[i], small[i]);
      const uint32_t o = nn * 128 + ((q ^ (nn & 7)) << 4);
      st_shared_v4(big_plane + o, big);
      st_shared_v4(small_plane + o, small);
    }
    // Fragments of this warp's rows: (g, k), (g + 8, k), (g, k + 4), (g + 8,
    // k + 4) for k = 8 ks + t.
#pragma unroll
    for (int ks = 0; ks < kBK / 8; ++ks) {
      const int r = row_w + g, k = 8 * ks + t;
      split(x_at<kBf16>(xs, r, k), a_big[ks][0], a_small[ks][0]);
      split(x_at<kBf16>(xs, r + 8, k), a_big[ks][1], a_small[ks][1]);
      split(x_at<kBf16>(xs, r, k + 4), a_big[ks][2], a_small[ks][2]);
      split(x_at<kBf16>(xs, r + 8, k + 4), a_big[ks][3], a_small[ks][3]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_addr(&empty_bar[slot]));
    fence_proxy_async();
    __syncwarp();  // converged for the .aligned wgmma instructions that follow
  };
  // Stage it's 12 wgmma into the partial, which starts at zero.
  auto mma_stage = [&](int it, const uint32_t (&a_big)[kBK / 8][4],
                       const uint32_t (&a_small)[kBK / 8][4]) {
    const uint32_t big_plane = planes + (it & 1) * (2 * kN * 128), small_plane = big_plane + kN * 128;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBK / 8; ++ks) {
      const uint64_t b_big = sw128_desc(big_plane + ks * 32);
      const uint64_t b_small = sw128_desc(small_plane + ks * 32);
      wgmma_n80(part, a_small[ks], b_big, ks > 0);
      wgmma_n80(part, a_big[ks], b_small, 1);
      wgmma_n80(part, a_big[ks], b_big, 1);
    }
    wgmma_commit();
  };
  // Wait for the partial and add it to the running dots; the barrier says
  // the next stage's planes are whole and this one's are free.
  auto finish = [&]() {
    wgmma_wait_all();
#pragma unroll
    for (int e = 0; e < kN / 2; ++e) acc[e] = __fadd_rn(acc[e], part[e]);
    named_barrier(1 + wg, 128);
  };

  // Stage it + 1's operands are split while stage it's products run: two
  // sets of fragments, taken in turns (the loop is unrolled by two so each
  // set stays in registers).
  uint32_t big0[kBK / 8][4], small0[kBK / 8][4], big1[kBK / 8][4], small1[kBK / 8][4];
  load_stage(0, big0, small0);
  named_barrier(1 + wg, 128);
  for (int it = 0; it < k_tiles; it += 2) {
    mma_stage(it, big0, small0);
    if (it + 1 < k_tiles) load_stage(it + 1, big1, small1);
    finish();
    if (it + 1 < k_tiles) {
      mma_stage(it + 1, big1, small1);
      if (it + 2 < k_tiles) load_stage(it + 2, big0, small0);
      finish();
    }
  }

  // Sign bits into the (now free) planes as bytes, row-major 64 x kN;
  // acc[4 j + 2 h + e] is (row g + 8 h, column 8 j + 2 t + e).
  unsigned char* bits = base_ptr + (planes - base);
#pragma unroll
  for (int j = 0; j < kN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        bits[(row_w + g + 8 * h) * kN + 8 * j + 2 * t + e] = acc[4 * j + 2 * h + e] >= 0.0f ? 1 : 0;
  named_barrier(1 + wg, 128);
  for (int p = tw; p < kBM * my_arrays; p += 128) {
    const int r = p / my_arrays, a = p % my_arrays;
    const long long row = row0 + r;
    if (row >= n) continue;
    const unsigned char* b = bits + r * kN + a * key_len;
    int key = 0;
    for (int i = 0; i < key_len; ++i) key = (key << 1) | b[i];
    keys[row * n_arrays + a0 + a] = key;
  }
}

template <bool kBf16>
cudaError_t run(const CUtensorMap& x_map, const CUtensorMap& p_map, long long n, int d,
                int n_arrays, int key_len, int arrays, int groups, int* keys, cudaStream_t stream) {
  const long long blocks = groups * ((n + kBM - 1) / kBM);
  // The shared-memory limit, once per device (a short call's time is
  // mostly the host's).
  static bool raised[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64 || !raised[dev]) {
    e = cudaFuncSetAttribute(lsh_hash_kernel<kBf16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemBytes));
    if (e != cudaSuccess) return e;
    if (dev < 64) raised[dev] = true;
  }
  lsh_hash_kernel<kBf16><<<static_cast<unsigned>(blocks), kThreads, kSmemBytes, stream>>>(
      x_map, p_map, n, d, n_arrays, key_len, arrays, groups, keys);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. ``x_bf16`` selects the row type
// (0: float32, 1: bfloat16). x's rows are ld elements apart and P's ld_p
// floats apart; both 16-byte aligned, ld * (element size) and ld_p * 4
// multiples of 16 (the tensor maps' rule). Returns a cudaError_t (0 on
// success). The caller validates shapes, dtypes, devices and
// 1 <= key_len <= 31.
extern "C" int lsh_hash_launch(const void* x, int x_bf16, long long n, int d, long long ld,
                               const float* proj, long long ld_p, int n_arrays, int key_len,
                               int* keys, void* stream) {
  if (n <= 0) return 0;
  const int esize = x_bf16 ? 2 : 4;
  if ((ld * esize) % 16 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 || ld_p % 4 != 0 ||
      reinterpret_cast<uintptr_t>(proj) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // Tiles of whole arrays, balanced, two a block; a warpgroup past the last
  // array computes zeros and writes nothing.
  const int most = kN / key_len;  // >= 1: key_len <= 31 < kN
  int tiles = (n_arrays + most - 1) / most;
  const int arrays = (n_arrays + tiles - 1) / tiles;
  tiles = (n_arrays + arrays - 1) / arrays;
  const int groups = (tiles + kWarpgroups - 1) / kWarpgroups;

  CUtensorMap x_map, p_map;
  int err = encode_2d(&x_map, x_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                      x, n, d, ld * esize, kBK, kBM,
                      x_bf16 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0)
    err = encode_2d(&p_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, proj, d,
                    static_cast<long long>(n_arrays) * key_len, ld_p * 4, kBoxCols, kBK,
                    CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != 0) return err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const cudaError_t e =
      x_bf16 ? run<true>(x_map, p_map, n, d, n_arrays, key_len, arrays, groups, keys, st)
             : run<false>(x_map, p_map, n, d, n_arrays, key_len, arrays, groups, keys, st);
  return static_cast<int>(e);
}
