// Hopper (sm_90a) building blocks of the bf16 1x1-conv GEMMs in
// pointwise_conv.cu: a `wgmma` m64n128k16 product with either operand read
// K-major or MN-major from shared memory, Tensor Memory Accelerator (TMA)
// copies of 2-D boxes into swizzled tiles, and the multi-stage copy ring
// that feeds the products.
//
// Everything else comes from sm90_flash.cuh: the swizzled tile layout
// (`Tile<D>`, atoms of R rows x 128 bytes, 16-byte chunk c of row r at
// chunk c ^ (r % 8), each atom on a 1024-byte boundary, which is the
// layout a TMA copy with the 128-byte swizzle writes), its K-major and
// single-atom MN-major descriptors, the `mbarrier`s and the `wgmma` fences.
//
// An MN-major operand wider than one atom (N = 128: two 64-column atoms)
// needs both descriptor offsets. In the canonical MN-major layout with the
// 128-byte swizzle, ((8 x 8 elements, atoms), (8 rows, groups)), the
// leading offset (bits 16-29) is the stride from one atom to the next along
// MN and the stride offset (bits 32-45) the stride from one 8-row group to
// the next along K; `desc_mn_wide` sets them to the tile's atom stride
// (R x 128 bytes) and 1024 bytes.

#pragma once

#include <cuda.h>

#include "sm90_flash.cuh"

namespace sm90 {

// Wait until at most N of this warpgroup's `wgmma` groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// MN-major descriptor of K-step kk (rows 16 kk .. 16 kk + 15) of an R-row
// tile of 64-column atoms (R rows x 128 bytes each, one after the other)
// whose MN extent spans all of them.
template <int R>
__device__ __forceinline__ uint64_t desc_mn_wide(uint32_t tile, int kk) {
  const uint32_t addr = tile + kk * 16 * 128;
  const uint64_t lbo = (R * 128) >> 4;  // atom to atom along MN
  const uint64_t sbo = 1024 >> 4;       // 8-row group to group along K
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (lbo << 16) | (sbo << 32) | (1ull << 62);
}

// d[0:64] (+)= A . B over one K-step of 16: A a 64-row operand, B a
// 128-column one, both from shared memory; kTransA / kTransB = 1 reads the
// operand MN-major, 0 K-major. accumulate = 0 overwrites d.
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate), "n"(kTransA), "n"(kTransB)
      : "memory");
}

// Tensor Memory Accelerator (TMA) copy of one box of a 2-D tensor map into
// shared memory: the box whose first element is (column c0, row c1) lands
// at dst in the map's swizzled layout, elements outside the tensor as
// zeros, and its bytes count towards the transaction of barrier bar.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// Arrive at barrier bar and add `bytes` to the transaction its phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// The copy ring: S stages, each guarded by a `full` barrier (one producer
// thread arrives with the stage's byte count, and the TMA copies complete
// the phase as they land) and an `empty` one (every consumer thread arrives
// once its products have read the stage). Chunks are numbered by one
// counter `it` over the block's whole life, across output tiles, so the
// producer copies the next tile's chunks while the consumers run this
// tile's epilogue.
template <int S>
struct Ring {
  static constexpr int kBytes = 2 * S * 8;  // the barriers
  uint32_t full, empty;

  __device__ Ring(uint32_t bars) : full(bars), empty(bars + 8 * S) {}

  // One thread, before the block's first __syncthreads.
  __device__ void init(int consumers) const {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, consumers);
    }
    mbar_init_fence();
  }

  // Producer: wait until chunk it's stage is free, then expect `bytes` of
  // copies into it; returns the barrier the copies complete.
  __device__ uint32_t acquire(int it, uint32_t bytes) const {
    if (it >= S) mbar_wait(empty + 8 * (it % S), (it / S - 1) & 1);
    const uint32_t bar = full + 8 * (it % S);
    mbar_expect_tx(bar, bytes);
    return bar;
  }
  // Consumer: wait for chunk it; then release it once read.
  __device__ void wait(int it) const { mbar_wait(full + 8 * (it % S), (it / S) & 1); }
  __device__ void release(int it) const { mbar_arrive(empty + 8 * (it % S)); }
};

// Host: a 2-D tensor map of a row-major bf16 matrix [rows, cols] (cols a
// multiple of 8, base 16-byte aligned) whose boxes are 64 columns (128
// bytes, one swizzle atom) by box_rows rows, in the 128-byte swizzle of
// `Tile<64>`. The CUDA driver's encoder is looked up through the CUDA
// runtime, so nothing links libcuda.
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline cudaError_t make_tmap_2d(CUtensorMap* map, const void* base, int rows, int cols,
                                int box_rows) {
  static EncodeTiledFn encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiledFn>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                              dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace sm90
