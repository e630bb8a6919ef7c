// Hopper (sm_90a) building blocks of the flash-attention kernels in
// flash_fwd.cu and flash_bwd.cu: the swizzled shared-memory tile layout that
// `wgmma` reads, its matrix descriptors, the `wgmma` products themselves,
// `cp.async` copies and the `mbarrier`s that guard the copy ring.
//
// Tile layout. A tile of R rows x D bf16 columns (R a multiple of 8, D in
// {32, 64, 128}) is stored in the canonical swizzled layout of `wgmma`:
// D >= 64 as D / 64 atoms of R rows x 128 B with the 128-byte swizzle (the
// 16-byte chunk c of row r sits at chunk c ^ (r % 8)), D = 32 as one atom of
// R rows x 64 B with the 64-byte swizzle (chunk c ^ ((r / 2) % 4)). Every
// atom starts on a 1024-byte boundary, so a descriptor's base offset is 0.
// The same bytes serve as a K-major operand (rows are M or N, columns are
// K: Q, K and V in S = Q K^T) and as an MN-major one (rows are K, columns
// are N: V in O += P V, Q and dO in dK += dS^T Q and dV += P^T dO); in both
// the stride between 8-row groups is 8 x the row's bytes, and it goes in
// both offset fields of the descriptor, so neither reading of the two
// fields can misplace a group.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int D>
struct Tile {
  static_assert(D == 32 || D == 64 || D == 128, "head dim");
  static constexpr int kAtomCols = D < 64 ? D : 64;     // columns of one atom
  static constexpr int kRowBytes = kAtomCols * 2;       // 64 or 128
  static constexpr int kChunks = kRowBytes / 16;        // 16-byte chunks a row
  static constexpr int kAtoms = D / kAtomCols;
  static constexpr uint64_t kSwizzle = kRowBytes == 128 ? 1 : 2;  // descriptor layout type
  static constexpr uint32_t kGroupBytes = 8 * kRowBytes;          // 8-row group stride

  template <int R>
  static constexpr int bytes() { return R * D * 2; }

  // Byte offset of element (r, c) of an R-row tile; c is a multiple of 2.
  template <int R>
  __device__ static __forceinline__ uint32_t offset(int r, int c) {
    const int chunk = (c % kAtomCols) / 8;
    const int x = ((r * kRowBytes) >> 7) & (kChunks - 1);
    return (c / kAtomCols) * R * kRowBytes + r * kRowBytes + ((chunk ^ x) << 4) + (c % 8) * 2;
  }

  __device__ static __forceinline__ uint64_t desc(uint32_t addr) {
    const uint64_t stride = kGroupBytes >> 4;
    return (uint64_t)((addr & 0x3FFFF) >> 4) | (stride << 16) | (stride << 32) |
           (kSwizzle << 62);
  }

  // Operand of K-step kk (16 columns) of an R-row tile read K-major.
  template <int R>
  __device__ static __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
    return desc(tile + (kk * 16 / kAtomCols) * R * kRowBytes + (kk * 16 % kAtomCols) * 2);
  }

  // Operand of K-step kk (rows 16 kk .. 16 kk + 15) and column atom nc of an
  // R-row tile read MN-major (N = the atom's kAtomCols columns).
  template <int R>
  __device__ static __forceinline__ uint64_t desc_mn(uint32_t tile, int nc, int kk) {
    return desc(tile + nc * R * kRowBytes + kk * 16 * kRowBytes);
  }
};

// 16-byte asynchronous copy global -> shared; src_bytes = 0 zero-fills.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// Copy rows [row0, row0 + R) of one head (rows row_stride elements apart)
// into an R-row swizzled tile with 16-byte cp.async, zero-filling rows at or
// past L. The NT threads of the block share it; tid is this one's index.
template <int D, int R, int NT>
__device__ __forceinline__ void copy_tile(uint32_t dst, const __nv_bfloat16* __restrict__ src,
                                          int row0, int L, int64_t row_stride, int tid) {
  constexpr int kPerRow = D / 8;
#pragma unroll
  for (int i = tid; i < R * kPerRow; i += NT) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * 8;
    const bool ok = row0 + r < L;
    const __nv_bfloat16* g = src + (ok ? (int64_t)(row0 + r) * row_stride + c : 0);
    cp_async16(dst + Tile<D>::template offset<R>(r, c), g, ok ? 16 : 0);
  }
}

// 4-byte asynchronous copy global -> shared; src_bytes = 0 zero-fills.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Shared-memory writes of this thread (cp.async, st.shared) made visible to
// the async proxy, which `wgmma` reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar)
               : "memory");
}

// Block until the phase of parity `parity` of the barrier has completed. A
// wait of more than about ten seconds traps, so that a fault in the ring
// ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1LL << 34)) {
      __trap();
    }
  }
}

// Named barrier over the 128 threads of warpgroup `wg` (ids 1.. ; 0 is
// __syncthreads').
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
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

// Keep the compiler from moving reads or writes of registers that an
// in-flight `wgmma` owns across this point.
template <int N>
__device__ __forceinline__ void fence_regs(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(x[i][j])::"memory");
  }
}

// Two floats as one bf16x2 register, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Accumulator layout of m64nNk16 (f32): register i of thread t of the
// warpgroup holds row 16 (t / 32) + (t % 32) / 4 + 8 ((i / 2) % 2) and
// column 8 (i / 4) + 2 (t % 4) + i % 2. Pairs (i, i + 1) with i % 4 in
// {0, 2}, for i in [8 kk, 8 kk + 8), are exactly the bf16 A operand of
// K-step kk of a product that takes this tile as its left factor.
__device__ __forceinline__ int acc_row(int lane, int i) { return lane / 4 + 8 * ((i / 2) % 2); }
__device__ __forceinline__ int acc_col(int lane, int i) { return 8 * (i / 4) + 2 * (lane % 4) + i % 2; }

template <int N>
__device__ __forceinline__ void to_a_operand(const float (&acc)[N], uint32_t (&a)[N / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) a[kk][j] = pack_bf16(acc[8 * kk + 2 * j], acc[8 * kk + 2 * j + 1]);
  }
}

// d[0:16] (+)= A . B^T, A and B K-major in shared memory (m64n32k16).
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate)
      : "memory");
}

// d[0:16] += A . B, A in registers (a[0:4], K-major), B MN-major in shared
// memory (m64n32k16).
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

// d[0:32] (+)= A . B^T, A and B K-major in shared memory (m64n64k16).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate)
      : "memory");
}

// d[0:32] += A . B, A in registers (a[0:4], K-major), B MN-major in shared
// memory (m64n64k16).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}


}  // namespace sm90
