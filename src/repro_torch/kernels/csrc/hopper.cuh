// What the tensor-core kernels (kmeans_assign.cu, lsh_hash.cu) share: the
// split of a float32 into two TF32 halves, mbarriers, TMA tile loads and
// their tensor maps, and the wgmma fences and shared-memory descriptors.
// Each kernel keeps its own wgmma shape (the instruction's n) and its own
// arithmetic; nothing here sums.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__host__ __device__ constexpr long long round_up(long long v, long long m) {
  return (v + m - 1) / m * m;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// v rounded to TF32 (10 mantissa bits), to nearest with ties away from zero:
// adding half the weight of the 13 dropped bits and masking them rounds the
// magnitude so, which is cvt.rna.tf32's result for every finite v, in two
// integer instructions (cvt.rna.tf32 is a longer sequence on sm_90).
__device__ __forceinline__ uint32_t tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

// v = big + small, both TF32 (v - big is exact, and small leaves at most
// 2^-22 |v| out).
__device__ __forceinline__ void split(float v, uint32_t& big, uint32_t& small) {
  big = tf32(v);
  small = tf32(__fsub_rn(v, __uint_as_float(big)));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// A box of a 2-D tensor map at (col, row) into shared memory at dst (zeros
// outside the tensor); completion is counted on the mbarrier bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int col, int row,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(bar)
      : "memory");
}

// Shared-memory descriptor of a K-major tile of 8-row, 128-byte swizzled
// atoms (rows 128 bytes apart, atoms 1024 bytes apart); addr is the tile's
// 1024-byte aligned base plus the byte offset of the k slice.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Makes this thread's st.shared visible to the async proxy (wgmma operand
// reads); a barrier after it publishes them to the other threads' wgmma.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier over the `threads` threads that name barrier `id` (1..15; 0 is
// __syncthreads).
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A (rows, cols) tensor of `type` with rows ld_bytes apart (a multiple of 16,
// base 16-byte aligned), read in box_cols x box_rows boxes with `swizzle`,
// zeros outside. Returns 0 or a cudaError_t.
inline int encode_2d(CUtensorMap* map, CUtensorMapDataType type, const void* base, long long rows,
                     long long cols, long long ld_bytes, int box_cols, int box_rows,
                     CUtensorMapSwizzle swizzle) {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    cudaDriverEntryPointQueryResult q;
    void* p = nullptr;
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (q != cudaDriverEntryPointSuccess || p == nullptr) return static_cast<int>(cudaErrorNotSupported);
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld_bytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(map, type, 2, const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
