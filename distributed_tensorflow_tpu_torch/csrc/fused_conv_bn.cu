// Fused 1x1-conv + BatchNorm (+ReLU) backward for Hopper (sm_90a).
//
// Replaces the TPU kernels distributed_tensorflow_tpu/ops/fused_conv_bn.py
// `_reduce_kernel` (:126) and `_apply_kernel` (:136). Per-channel constants
// arrive as one [8, N] f32 array: row 0 mu, 1 inv = rsqrt(var + eps),
// 2 gamma, 3 beta, 4 s1/M, 5 s2/M (rows 4-5 unused by the reduce pass).
//
//   x_hat = (z - mu) * inv;  g = dA * [gamma * x_hat + beta > 0]  (or dA)
//   reduce:  s1 = sum_m g,  s2 = sum_m g * x_hat
//   apply:   dz = (gamma * inv) * (g - s1/M - x_hat * s2/M), rounded to
//            W's dtype; dx = dz W^T [M, K] in dA's dtype;
//            dW = x^T dz [K, N] in f32
//
// Every f32 step of x_hat, the mask and dz is a rounded multiply or add
// (__fmul_rn, __fadd_rn, __fsub_rn) in the order of the plain PyTorch
// version, so no FMA contraction can flip a ReLU mask or a rounding of dz
// against it: dz is the same number in both, and only the sums' order
// differs.
//
// What the TPU kernels did in one sequential grid becomes these kernels:
//   bn_reduce_kernel_sm90 one wave of blocks over (column strip, M range),
//                     fed by a TMA ring; each writes its partial, and the
//                     last block of a strip sums the strip's partials in a
//                     fixed order and writes s1, s2 and the constants' rows
//                     4-5 (s1/M, s2/M) itself: one launch, no host sum;
//   bn_apply_dx_strip_sm90 (bf16, N <= 512) a block makes dz for 128 rows
//                     of M and every column of N once, keeps it in shared
//                     memory and walks a group of K tiles over it;
//   bn_apply_dx_panel_sm90 (bf16, N > 512) a block keeps dx for 64 rows of
//                     M and 256 or 512 columns of K in registers and makes
//                     each 64-column chunk of dz once for all of them;
//   bn_apply_dx_kernel (fp32) the first design: one block per 128 x 128
//                     tile of dx, dz recomputed per tile of K;
//   bn_apply_dw_kernel_sm90 (bf16) and bn_apply_dw_kernel (fp32) one block
//                     per (tile of dW, M range): the TPU carried
//                     dW across its sequential grid; here each block loops
//                     over its M range and writes an f32 partial, which a
//                     second kernel (conv1x1_tile.cuh `sum_splits_kernel`)
//                     adds in a fixed order. No atomics, so the result is
//                     the same in every run.
// dz never goes to device memory: each block makes what it multiplies in
// registers and shared memory, which is what the TPU kernel was for.
//
// bf16 dx design (on pointwise_conv.cu's `pw_dgrad_kernel_sm90` and
// sm90_gemm.cuh; the dW design below). dx = dz W^T has N as its reduction,
// and the first design made every dz element once per 128 columns of K
// (ceil(K / 128) times: 2.7x the elements needed over a ResNet-50 step,
// 7.1x over an Inception-v3 one). Both kernels make each element once per
// tile: one producer thread keeps Tensor Memory Accelerator (TMA) copies
// of dA, z and W in flight through a ring of stages guarded by mbarriers;
// two consumer warpgroups make dz in shared memory with `dz_of` (rounded
// steps in the plain version's order, so dz is bitwise the plain
// version's; zero past M and past N, where dz of a zero-filled row or
// column would not be zero), publish it to the `wgmma` async proxy with
// `fence.proxy.async` and a named barrier, and multiply it by W with
// `wgmma` m64n128k16, both operands K-major (N contiguous in dz and W), as
// in the dgrad. The grid is persistent (one block per SM, tiles t =
// blockIdx.x, + gridDim.x, ...), and the ring's counter runs across tiles.
// The epilogue packs the accumulators to bf16 into a stage whose products
// are done (two swizzled 64 x 64 atoms a 64 x 128 tile) and stores them
// with one TMA store (`store_dx`), which clips rows past M and columns past
// K; bf16 pairs stored from registers had taken most of the strip
// kernel's time (timing-only variants on the H100). The host picks
// the kernel and its tiles per shape (ops/fused_conv_bn.py `dx_plan`):
//   strip (N <= 512, every Inception-v3 unit and ResNet-50's reducing
//     ones): a tile is 128 rows of M, 64 a warpgroup, and a group of
//     128-column K tiles (all of K where the strips fill the SMs; two
//     groups at M = 6272 and 8192). Its dA and z come through the ring in
//     64-column chunks (two 16 KB boxes a stage); each warpgroup turns its
//     64 rows into dz in a resident strip of 4 (N <= 256) or 8 swizzled 64
//     x 64 atoms (32 or 64 KB a warpgroup), then, for each K tile, streams
//     W's [128 K x 128 N] slices (two boxes a stage, W stays in L2) and
//     runs 8 k-steps a slice into a 64 x 128 accumulator (all 8 always: a
//     branch among the products makes ptxas fence each one, so a slice's
//     second box past N is copied as TMA's zeros and its dz atom zeroed
//     once). Both warpgroups read each slice, so they meet at a named
//     barrier before the last slice's stage takes the tile's store; the
//     stage goes back to the producer after the next item has arrived.
//     Shared memory 64 KB of dz + 5 x 32 KB stages, or 128 KB + 3 x 32 KB.
//   panel (N > 512, ResNet-50's expanding units): a tile is 64 rows of M
//     and KT x 256 columns of K (KT = 1 where K <= 256, else 2; a K of
//     1024 takes two such ranges, so dz is made twice there). A stage holds
//     a 64-column chunk of dA and z (8 KB boxes), the chunk's six constant
//     rows (an unswizzled 1.5 KB box: loading them from L2 chunk by chunk
//     had stalled each dz pass) and W's [256 KT x 64] slice; the 256
//     consumers make the chunk's dz over dA's slot, and each warpgroup
//     multiplies it into its KT 64 x 128 accumulators (KT = 2: 128 floats
//     a thread, which fit because the producer warpgroup gives its
//     registers up: `setmaxnreg` 40 / 232, as in dW). The next chunk's dz
//     is made while this chunk's products run; each warpgroup's tile is
//     stored through its own W boxes of the tile's last stage. Four stages
//     of 50 KB (KT = 1) or two of 82 KB (KT = 2). A 128-row variant of this
//     kernel, which halves W's reads from L2, was no faster at any of
//     ResNet-50's four panel shapes (exploratory, not kept).
// A dx accumulator sums N / 16 k-steps, at most 128 (N = 2048), so the
// precision is the first design's. No kernel spills (chip_smoke.py prints
// ptxas' counts).
//
// Reduce design: a block owns 64 columns (bf16; 32 in fp32: 128 bytes a
// row) and a range of whole 128-row boxes of M (the host's plan,
// ops/fused_conv_bn.py `reduce_plan`: as many ranges as fill one wave at
// two blocks an SM). Thread 0 keeps three stages of dA and z boxes in
// flight; every thread sums 8 (4) columns of 4 rows a box in f32, rounded
// in the plain version's order. The block's 32 row groups are added in
// order into its partial row; then a ticket per strip, taken after
// __threadfence(), finds the strip's last block, which adds the strip's
// partials in a fixed order (interleaved groups of ranges, 8 in bf16 and
// 16 in fp32, then the groups in order), writes s1 and s2, and writes
// s1/M and s2/M by IEEE
// division (__fdiv_rn: what the CPU path's `s / m` gives; PyTorch's CUDA
// division by a Python number multiplies by the reciprocal, which may
// differ by one ulp) into rows 4-5 of the constants that the apply
// kernels read. It resets its ticket, so a replayed CUDA graph finds them
// at zero. Two runs give the same bits.
//
// bf16 dW design (`bn_apply_dw_kernel_sm90`, on pointwise_conv.cu's
// `pw_wgrad_kernel_sm90` and sm90_gemm.cuh): one producer thread and two
// consumer warpgroups over a ring of Tensor Memory Accelerator (TMA)
// copies; a block owns 128 KT rows of dW (of K) by 128 columns (of N),
// KT = 2 where K > 128, else 1 (the host's choice, ops/fused_conv_bn.py
// `_dw_tile_rows`, passed as tile_rows). A stage holds 64 rows of M: the x2 chunk
// (128 KT columns of K) and the dA and z chunks (128 columns of N), each in
// 64-column boxes in the 128-byte swizzle; four stages of 48 KB (KT = 1) or
// three of 64 KB (KT = 2). The consumers turn dA
// and z into the bf16 dz chunk in place over dA's slot: each of the 256
// threads owns 8 columns (their six constants held in registers for the
// block's life) and 4 rows of the chunk, and `dz_of` rounds each step in
// the plain version's order, so dz is bitwise the plain version's. dz is
// zero at rows past the block's M range and at columns past N (the
// constants are never read there; TMA zero-fills dA and z past M and N,
// but dz of a zero row is gamma inv (-s1/M + mu inv s2/M), not zero). Then
// `fence.proxy.async` and a named barrier over the 256 consumer threads,
// since both warpgroups read the whole chunk; then `wgmma` m64n128k16 with
// x2 as the MN-major A operand and dz as the MN-major B operand, exactly
// as in wgrad, KT products a warpgroup (64 KT rows of dW). Chunk c + 1's dz
// is made while chunk c's products are in flight. Making dz costs more
// than moving the chunk (below), so KT = 2 makes each dz element serve
// twice the rows of dW; its 128 accumulator floats a thread fit because
// the producer warpgroup gives its registers up (`setmaxnreg`: 40 for the
// producer, 232 for the consumers). The split over M is per shape (ops/fused_conv_bn.py
// `dw_rows_per_split`, the wgrad's one-wave rule in whole 64-row chunks
// over these tiles): as many M ranges as fill one wave of the SMs with the
// shape's dW tiles,
// one where the tiles alone fill it; with one range the kernel writes dW
// itself. A range is a whole number of chunks except the last, which ends
// at M, so no range reads another's rows. Shared memory 197,696 B (KT =
// 1) or 197,680 B (KT = 2), one block per SM; no spills (chip_smoke.py
// prints ptxas' count). The fp32 path keeps the first design below (exact
// f32 products by scalar FMA).
//
// Precision: `wgmma` sums in f32 but its error grows with the products an
// accumulator takes; at (6272, 1024, 2048), where one M range fills the
// wave, 128-row tiles summed 392 k-steps a range and came within a few
// percent of the plain version's 1e-5 x max |dW| tolerance (over it for one
// input in an exploratory sweep). 256-row tiles halve the tiles, so that
// shape takes two ranges; scripts/torch_bwd_bench.py's `bn_dw_precision`
// part measures the margin.
//
// Where its time goes (exploratory timings on the H100, 128-row tiles):
// with dz's arithmetic removed, a chunk takes what the copies alone take;
// making dz (once per 128 KT columns of K: nine rounded f32 steps and a
// compare an element) adds to that instead of hiding under it. Dropping the proxy
// fence, the barrier or the dz store (timing only) each moved it a few
// percent; 32-row chunks over eight stages were slower, and so, at every
// shape, was a variant that made dz^T in registers (`ldmatrix.trans`) as
// the register A operand of dW^T = dz^T x2, with no dz store and no
// barrier.
//
// Bound on an H100 SXM at ResNet-50's shapes (b = 128, bf16): the reduce
// pass reads dA and z (2 * M * N * 2 bytes; 206 MB at (401408, 256, 128),
// 61 us); apply reads dA, z, x and W and writes dx and dW, for 4 M K N
// operations: bytes bound at every shape but the deepest
// (6272, 2048, 512), where 26 GFLOP take 26 us and 36 MB move in 11 us.
// The dx kernels read W from L2 once per block tile of M (128 rows, or 64
// in the panel kernel), and split dW's partials cost one more write and
// read of [splits, K, N] f32. The fp32 dx and dW kernels (the first
// design, on conv1x1_tile.cuh's BlockGemm) are capped at 128 registers a
// thread for two blocks an SM and wait on the global loads of dA and z
// each chunk.

#include "conv1x1_tile.cuh"
#include "sm90_gemm.cuh"

#include <algorithm>

namespace {

using namespace conv1x1;
using bf16 = __nv_bfloat16;

template <bool kRelu>
__device__ __forceinline__ float dz_of(float da, float z, float mu, float inv, float gamma,
                                       float beta, float c1, float c2) {
  const float xh = __fmul_rn(__fsub_rn(z, mu), inv);
  float g = da;
  if (kRelu && !(__fadd_rn(__fmul_rn(gamma, xh), beta) > 0.f)) g = 0.f;
  return __fmul_rn(__fmul_rn(gamma, inv), __fsub_rn(__fsub_rn(g, c1), __fmul_rn(xh, c2)));
}

// The dz operand of a product: chunk c is the tile of rows [row0, row0 + R)
// and columns [col0, col0 + C) of dz [rows, N] (advancing along rows or
// columns by the chunk length), computed from dA and z (row-major [M, N])
// and the constants; zero outside [0, rows) x [0, N). fetch() loads the
// chunk's dA and z into registers, put() writes dz as T into shared memory
// with leading dimension Ld.
template <typename T, int R, int C, int Ld, bool kAlongRows, bool kRelu>
struct DzOperand {
  static constexpr int kV = kVec<T>;
  static constexpr int kPerRow = C / kV;
  static constexpr int kUnits = R * kPerRow / kThreads;
  static_assert(R * kPerRow % kThreads == 0, "whole vectors per thread");

  const T* da;
  const T* z;
  const float* consts;
  int rows, n_cols;
  int row0, col0;
  uint4 rda[kUnits], rz[kUnits];
  int cr, cc;  // origin of the fetched chunk

  __device__ DzOperand(const T* da_, const T* z_, const float* consts_, int rows_, int n_cols_,
                       int row0_, int col0_)
      : da(da_), z(z_), consts(consts_), rows(rows_), n_cols(n_cols_), row0(row0_),
        col0(col0_), cr(0), cc(0) {}

  __device__ __forceinline__ bool valid(int r, int c) const {
    return cr + r < rows && cc + c < n_cols;
  }

  __device__ __forceinline__ void fetch(int chunk) {
    cr = kAlongRows ? row0 + chunk * R : row0;
    cc = kAlongRows ? col0 : col0 + chunk * C;
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      const int i = threadIdx.x + u * kThreads;
      const int r = i / kPerRow, c = (i % kPerRow) * kV;
      if (valid(r, c)) {
        const int64_t off = (int64_t)(cr + r) * n_cols + cc + c;
        rda[u] = *reinterpret_cast<const uint4*>(da + off);
        rz[u] = *reinterpret_cast<const uint4*>(z + off);
      }
    }
  }

  __device__ __forceinline__ void issue(T*, int) {}

  __device__ __forceinline__ void put(T* dst) {
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      const int i = threadIdx.x + u * kThreads;
      const int r = i / kPerRow, c = (i % kPerRow) * kV;
      __align__(16) T out[kV];
      if (valid(r, c)) {
        const T* a = reinterpret_cast<const T*>(&rda[u]);
        const T* b = reinterpret_cast<const T*>(&rz[u]);
        // Four columns at a time: the six constant rows 16 bytes a load (N
        // is a multiple of 8 and the columns start at a multiple of kV).
#pragma unroll
        for (int v = 0; v < kV / 4; ++v) {
          __align__(16) float k[6][4];
#pragma unroll
          for (int q = 0; q < 6; ++q)
            *reinterpret_cast<float4*>(k[q]) =
                __ldg(reinterpret_cast<const float4*>(consts + q * n_cols + cc + c) + v);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int e = 4 * v + j;
            out[e] = from_float<T>(dz_of<kRelu>(to_float(a[e]), to_float(b[e]), k[0][j],
                                                k[1][j], k[2][j], k[3][j], k[4][j], k[5][j]));
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < kV; ++e) out[e] = from_float<T>(0.f);
      }
      *reinterpret_cast<uint4*>(dst + r * Ld + c) = *reinterpret_cast<const uint4*>(out);
    }
  }
};

// ---------------------------------------------------------------------------
// Reduce: one wave over (column strip, M range), the sum finished in-launch
// ---------------------------------------------------------------------------

// The reduce's boxes and shared memory (byte offsets from a 1024-byte
// aligned base): three stages of a dA and a z box of 128 rows x 128 bytes,
// their barriers, and the last-block flag. The block's sums reuse stage 0.
struct RedSmem {
  static constexpr int kRows = 128;  // rows of a box
  static constexpr int kStages = 3;
  static constexpr int kBox = kRows * 128;
  static constexpr int kStage = 2 * kBox;
  static constexpr int kBar = kStages * kStage;
  static constexpr int kFlag = kBar + kStages * 8;
  static constexpr int kAlloc = kFlag + 16 + 1024;
};

template <typename T, bool kRelu>
__global__ void __launch_bounds__(256, 2)
    bn_reduce_kernel_sm90(const __grid_constant__ CUtensorMap map_da,
                          const __grid_constant__ CUtensorMap map_z,
                          const float* __restrict__ consts, float* __restrict__ part,
                          float* __restrict__ s12, float* __restrict__ consts_out,
                          int* __restrict__ tickets, int M, int N, int rows_per_split) {
  using S = RedSmem;
  constexpr int kV = kVec<T>;     // columns of a 16-byte chunk
  constexpr int kCols = 8 * kV;   // columns of a strip: 128 bytes a row
  constexpr int kQ = 2 * kCols / 4;  // float4s of a partial row (s1 | s2)
  constexpr int kG = 256 / kQ;       // thread groups over the ranges at the end
  extern __shared__ __align__(1024) unsigned char smem_red[];
  const uint32_t raw = sm90::smem_u32(smem_red);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_red + (base - raw);
  const uint32_t full = base + S::kBar;
  const int tid = threadIdx.x;
  const int strip = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const int n0 = strip * kCols;
  const int mb = split * rows_per_split;
  const int me = min(M, mb + rows_per_split);
  const int boxes = (me - mb + S::kRows - 1) / S::kRows;
  if (tid == 0) {
    for (int st = 0; st < S::kStages; ++st) sm90::mbar_init(full + 8 * st, 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();
  // Thread 0: box b of dA and z (rows mb + 128 b .., columns n0 ..) into
  // stage b % 3; TMA zero-fills past M and N.
  auto load_box = [&](int b) {
    const uint32_t bar = full + 8 * (b % S::kStages);
    const uint32_t st = base + (b % S::kStages) * S::kStage;
    sm90::mbar_expect_tx(bar, S::kStage);
    sm90::tma_load_2d(st, &map_da, n0, mb + b * S::kRows, bar);
    sm90::tma_load_2d(st + S::kBox, &map_z, n0, mb + b * S::kRows, bar);
  };
  if (tid == 0) {
    for (int b = 0; b < min(S::kStages, boxes); ++b) load_box(b);
  }

  // Thread (rg, j) sums columns [n, n + kV) of rows rg, rg + 32, ... of
  // each box; its four constants stay in registers.
  const int j = tid % 8, rg = tid / 8;
  const int n = n0 + kV * j;
  const bool col_ok = n < N;
  float mu[kV], inv[kV], gamma[kV], beta[kV], s1[kV], s2[kV];
#pragma unroll
  for (int e = 0; e < kV; ++e) {
    s1[e] = s2[e] = 0.f;
    mu[e] = col_ok ? consts[n + e] : 0.f;
    inv[e] = col_ok ? consts[N + n + e] : 0.f;
    gamma[e] = col_ok ? consts[2 * N + n + e] : 0.f;
    beta[e] = col_ok ? consts[3 * N + n + e] : 0.f;
  }
  for (int b = 0; b < boxes; ++b) {
    sm90::mbar_wait(full + 8 * (b % S::kStages), (b / S::kStages) & 1);
    const unsigned char* st = smem + (b % S::kStages) * S::kStage;
    if (col_ok) {
#pragma unroll
      for (int u = 0; u < S::kRows / 32; ++u) {
        const int r = rg + 32 * u;
        if (mb + b * S::kRows + r < me) {
          const uint32_t off = r * 128 + ((j ^ (r & 7)) << 4);
          const uint4 a4 = *reinterpret_cast<const uint4*>(st + off);
          const uint4 z4 = *reinterpret_cast<const uint4*>(st + S::kBox + off);
          const T* a = reinterpret_cast<const T*>(&a4);
          const T* zz = reinterpret_cast<const T*>(&z4);
#pragma unroll
          for (int e = 0; e < kV; ++e) {
            const float xh = __fmul_rn(__fsub_rn(to_float(zz[e]), mu[e]), inv[e]);
            float g = to_float(a[e]);
            if (kRelu && !(__fadd_rn(__fmul_rn(gamma[e], xh), beta[e]) > 0.f)) g = 0.f;
            s1[e] = __fadd_rn(s1[e], g);
            s2[e] = __fadd_rn(s2[e], __fmul_rn(g, xh));
          }
        }
      }
    }
    __syncthreads();  // every thread has read stage b: refill it
    if (tid == 0 && b + S::kStages < boxes) load_box(b + S::kStages);
  }

  // The block's partial row: its 32 row groups added in order.
  float* red = reinterpret_cast<float*>(smem);  // [2][32][kCols], over stage 0
#pragma unroll
  for (int e = 0; e < kV; ++e) {
    red[rg * kCols + kV * j + e] = s1[e];
    red[(32 + rg) * kCols + kV * j + e] = s2[e];
  }
  __syncthreads();
  float* mine = part + ((int64_t)strip * splits + split) * 2 * kCols;
  if (tid < 2 * kCols) {
    const int which = tid / kCols, col = tid % kCols;
    float t = 0.f;
    for (int r = 0; r < 32; ++r) t = __fadd_rn(t, red[(which * 32 + r) * kCols + col]);
    mine[tid] = t;
  }
  // The strip's last block to finish adds the strip's partials.
  int* last = reinterpret_cast<int*>(smem + S::kFlag);
  __threadfence();
  __syncthreads();
  if (tid == 0) *last = atomicAdd(tickets + strip, 1) == splits - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  const float4* p4 = reinterpret_cast<const float4*>(part + (int64_t)strip * splits * 2 * kCols);
  const int q = tid % kQ, grp = tid / kQ;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
  for (int sp = grp; sp < splits; sp += kG) {
    const float4 v = __ldcg(p4 + (int64_t)sp * kQ + q);
    acc.x = __fadd_rn(acc.x, v.x);
    acc.y = __fadd_rn(acc.y, v.y);
    acc.z = __fadd_rn(acc.z, v.z);
    acc.w = __fadd_rn(acc.w, v.w);
  }
  reinterpret_cast<float4*>(smem)[grp * kQ + q] = acc;
  __syncthreads();
  if (tid < 2 * kCols) {
    float t = 0.f;
    for (int g = 0; g < kG; ++g) t = __fadd_rn(t, red[g * 2 * kCols + tid]);
    const int which = tid / kCols, col = n0 + tid % kCols;
    if (col < N) {
      s12[which * N + col] = t;
      if (consts_out != nullptr) consts_out[(4 + which) * N + col] = __fdiv_rn(t, (float)M);
    }
  }
  if (tid == 0) tickets[strip] = 0;  // ready for the next launch (or graph replay)
}

template <typename T, bool kRelu>
__global__ void __launch_bounds__(kThreads, 2)
    bn_apply_dx_kernel(const T* __restrict__ da, const T* __restrict__ z,
                       const T* __restrict__ w, const float* __restrict__ consts,
                       T* __restrict__ dx, int M, int K, int N) {
  using G = BlockGemm<T, false, false>;
  using AS = typename G::AShape;
  using BS = typename G::BShape;
  constexpr int kBR = Cfg<T>::kBR;
  __shared__ __align__(128) unsigned char smem_raw[G::kSmemBytes];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int k0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  // A = dz rows [m0, m0 + 128), chunked along N; B(n, k) = W[k, n].
  DzOperand<T, kBM, kBR, AS::kLd, false, kRelu> opa(da, z, consts, M, N, m0, 0);
  CopyOperand<T, kBN, kBR, BS::kLd, false> opb{w, N, K, N, k0, 0};
  auto store = [&](int r, int c, const float* v) { store8(dx, K, M, K, m0 + r, k0 + c, v); };
  G::run(smem, opa, opb, (N + kBR - 1) / kBR, store);
}

template <typename T, bool kRelu>
__global__ void __launch_bounds__(kThreads, 2)
    bn_apply_dw_kernel(const T* __restrict__ da, const T* __restrict__ z,
                       const T* __restrict__ x, const float* __restrict__ consts,
                       float* __restrict__ part, int M, int K, int N, int rows_per_split) {
  using G = BlockGemm<T, true, true>;
  using AS = typename G::AShape;
  using BS = typename G::BShape;
  constexpr int kBR = Cfg<T>::kBR;
  __shared__ __align__(128) unsigned char smem_raw[G::kSmemBytes];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int n0 = blockIdx.x * kBN;
  const int k0 = blockIdx.y * kBM;
  const int mb = blockIdx.z * rows_per_split;
  const int me = min(M, mb + rows_per_split);
  // A(k, m) = x[m, k] and B(m, n) = dz[m, n] over rows [mb, me), chunked
  // along M; rows from me on read as zero in both.
  CopyOperand<T, kBR, kBM, AS::kLd, true> opa{x, K, me, K, mb, k0};
  DzOperand<T, kBR, kBN, BS::kLd, true, kRelu> opb(da, z, consts, me, N, mb, n0);
  float* out = part + (int64_t)blockIdx.z * K * N;
  auto store = [&](int r, int c, const float* v) { store8(out, N, K, N, k0 + r, n0 + c, v); };
  G::run(smem, opa, opb, me > mb ? (me - mb + kBR - 1) / kBR : 0, store);
}

// ---------------------------------------------------------------------------
// bf16 dW: wgmma from a TMA ring, dz made in shared memory
// ---------------------------------------------------------------------------

// dW's shared-memory map for 128 KT rows of dW (byte offsets from a
// 1024-byte aligned base).
template <int KT>
struct DwSmem {
  static constexpr int kStages = KT == 1 ? 4 : 3;
  static constexpr int kBox = 64 * 64 * 2;  // 64 rows x 64 bf16 columns
  static constexpr int kX = 0;               // x2: 2 KT boxes, 128 KT columns of K
  static constexpr int kDA = 2 * KT * kBox;  // dA: two boxes of N; dz is made over it
  static constexpr int kZ = kDA + 2 * kBox;  // z: two boxes of N
  static constexpr int kStage = kZ + 2 * kBox;
  static constexpr int kBar = kStages * kStage;
  static constexpr int kAlloc = kBar + 2 * kStages * 8 + 1024;
};

// Named barrier over the two consumer warpgroups (threads 128..383).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

template <bool kRelu, int KT>
__global__ void __launch_bounds__(384, 1)
    bn_apply_dw_kernel_sm90(const __grid_constant__ CUtensorMap map_x,
                            const __grid_constant__ CUtensorMap map_da,
                            const __grid_constant__ CUtensorMap map_z,
                            const float* __restrict__ consts, float* __restrict__ out, int M,
                            int K, int N, int rows_per_split) {
  using S = DwSmem<KT>;
  constexpr int kStages = S::kStages;
  using Ring = sm90::Ring<kStages>;
  using TA = sm90::Tile<128>;  // a stage's operands: 64-column atoms, 8 KB apart
  extern __shared__ __align__(1024) unsigned char smem_dw[];
  const uint32_t raw = sm90::smem_u32(smem_dw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_dw + (base - raw);
  const Ring ring(base + S::kBar);
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  if (tid == 0) ring.init(256);
  __syncthreads();

  const int n0 = blockIdx.x * 128;
  const int k0 = blockIdx.y * 128 * KT;
  const int mb = blockIdx.z * rows_per_split;
  const int me = min(M, mb + rows_per_split);
  const int chunks = (me - mb + 63) / 64;
  if (wg == 0) {
    if constexpr (KT == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    // Producer (one thread): rows [mb + 64 c, + 64) of x2 (columns k0..)
    // and of dA and z (columns n0..), one box per 64 columns. A box that
    // starts past K or N is not copied: its x2 atom meets only dW rows
    // that are never stored, and dz is zero past N without reading dA.
    if (tid == 0) {
      const int ax = min(2 * KT, (K - k0 + 63) / 64);
      const int an = min(2, (N - n0 + 63) / 64);
      for (int c = 0; c < chunks; ++c) {
        const uint32_t bar = ring.acquire(c, (ax + 2 * an) * S::kBox);
        const uint32_t st = base + (c % kStages) * S::kStage;
        const int row = mb + 64 * c;
        for (int a = 0; a < ax; ++a) {
          sm90::tma_load_2d(st + S::kX + a * S::kBox, &map_x, k0 + 64 * a, row, bar);
        }
        for (int a = 0; a < an; ++a) {
          sm90::tma_load_2d(st + S::kDA + a * S::kBox, &map_da, n0 + 64 * a, row, bar);
          sm90::tma_load_2d(st + S::kZ + a * S::kBox, &map_z, n0 + 64 * a, row, bar);
        }
      }
    }
    return;
  }

  if constexpr (KT == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  // Consumers. Thread ct makes dz at columns [c8, c8 + 8) of the chunk
  // (its six per-channel constants in registers) and rows ct / 16 + 16 u.
  const int cw = wg - 1;
  const int ct = tid - 128;
  const int lane = tid % 32;
  const int wrow = (tid % 128) / 32 * 16;
  const int c8 = 8 * (ct % 16);
  const bool col_ok = n0 + c8 < N;
  float kc[6][8];
#pragma unroll
  for (int q = 0; q < 6; ++q) {
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const float4 f = col_ok ? __ldg(reinterpret_cast<const float4*>(consts + q * N + n0 + c8) + v)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
      kc[q][4 * v] = f.x;
      kc[q][4 * v + 1] = f.y;
      kc[q][4 * v + 2] = f.z;
      kc[q][4 * v + 3] = f.w;
    }
  }
  // dz of chunk c over dA's slot of its stage; zero past the range and N.
  auto make_dz = [&](int c) {
    unsigned char* da_s = smem + (c % kStages) * S::kStage + S::kDA;
    const unsigned char* z_s = smem + (c % kStages) * S::kStage + S::kZ;
    const int row0 = mb + 64 * c;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = ct / 16 + 16 * u;
      const uint32_t off = TA::offset<64>(r, c8);
      uint4 res = make_uint4(0u, 0u, 0u, 0u);
      if (col_ok && row0 + r < me) {
        const uint4 a4 = *reinterpret_cast<const uint4*>(da_s + off);
        const uint4 z4 = *reinterpret_cast<const uint4*>(z_s + off);
        const bf16* a = reinterpret_cast<const bf16*>(&a4);
        const bf16* z = reinterpret_cast<const bf16*>(&z4);
        bf16* d = reinterpret_cast<bf16*>(&res);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          d[e] = from_float<bf16>(dz_of<kRelu>(to_float(a[e]), to_float(z[e]), kc[0][e], kc[1][e],
                                               kc[2][e], kc[3][e], kc[4][e], kc[5][e]));
        }
      }
      *reinterpret_cast<uint4*>(da_s + off) = res;
    }
  };

  float acc[KT][64];
#pragma unroll
  for (int h = 0; h < KT; ++h) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;
  }
  ring.wait(0);
  make_dz(0);
  sm90::fence_proxy_async();  // dz, written by this thread, to the async proxy of `wgmma`
  consumers_sync();           // every thread's part of chunk 0's dz is in place
  for (int c = 0; c < chunks; ++c) {
    const uint32_t st = base + (c % kStages) * S::kStage;
    sm90::wgmma_fence();
#pragma unroll
    for (int h = 0; h < KT; ++h) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        sm90::wgmma_m64n128<1, 1>(acc[h], TA::desc_mn<64>(st + S::kX, KT * cw + h, kk),
                                  sm90::desc_mn_wide<64>(st + S::kDA, kk), c > 0 || kk > 0);
      }
    }
    sm90::wgmma_commit();
    // The next chunk's dz is made while this chunk's products run.
    if (c + 1 < chunks) {
      ring.wait(c + 1);
      make_dz(c + 1);
      sm90::fence_proxy_async();
    }
    sm90::wgmma_wait<0>();
    ring.release(c);
    if (c + 1 < chunks) consumers_sync();
  }
#pragma unroll
  for (int h = 0; h < KT; ++h) sm90::fence_regs(acc[h]);
  // f32 pairs straight from the accumulators: a quad of threads writes 32
  // contiguous bytes of a row.
  out += (int64_t)blockIdx.z * K * N;
#pragma unroll
  for (int h = 0; h < KT; ++h) {
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int row = k0 + 64 * (KT * cw + h) + wrow + sm90::acc_row(lane, i);
      const int col = n0 + sm90::acc_col(lane, i);
      if (row < K && col < N) {
        *reinterpret_cast<float2*>(out + (int64_t)row * N + col) =
            make_float2(acc[h][i], acc[h][i + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 dx: dz made once per block in shared memory, wgmma from a TMA ring
// ---------------------------------------------------------------------------

// dz of 8 columns (16 bytes of a swizzled row) from dA and z at the same
// offset: columns [col, col + 8) of row `row`, zero at or past M and N.
template <bool kRelu>
__device__ __forceinline__ uint4 dz_chunk(const unsigned char* da_s, const unsigned char* z_s,
                                          const float (&kc)[6][8], bool ok) {
  uint4 res = make_uint4(0u, 0u, 0u, 0u);
  if (ok) {
    const uint4 a4 = *reinterpret_cast<const uint4*>(da_s);
    const uint4 z4 = *reinterpret_cast<const uint4*>(z_s);
    const bf16* a = reinterpret_cast<const bf16*>(&a4);
    const bf16* z = reinterpret_cast<const bf16*>(&z4);
    bf16* d = reinterpret_cast<bf16*>(&res);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      d[e] = from_float<bf16>(dz_of<kRelu>(to_float(a[e]), to_float(z[e]), kc[0][e], kc[1][e],
                                           kc[2][e], kc[3][e], kc[4][e], kc[5][e]));
    }
  }
  return res;
}

// The six constants of columns [col, col + 8) (zero where col >= N: never
// read from memory there).
__device__ __forceinline__ void load_consts(float (&kc)[6][8], const float* consts, int N,
                                            int col) {
#pragma unroll
  for (int q = 0; q < 6; ++q) {
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const float4 f = col < N ? __ldg(reinterpret_cast<const float4*>(consts + q * N + col) + v)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
      kc[q][4 * v] = f.x;
      kc[q][4 * v + 1] = f.y;
      kc[q][4 * v + 2] = f.z;
      kc[q][4 * v + 3] = f.w;
    }
  }
}

// dz_chunk with the constants of the chunk's 64 columns in shared memory
// (cs: six rows of 64 floats, copied there with dA and z), each half's
// read where it is made (24 floats live, not 48): for the panel kernel,
// whose accumulators leave the fewest registers.
template <bool kRelu>
__device__ __forceinline__ uint4 dz_chunk_smem(const unsigned char* da_s,
                                               const unsigned char* z_s, const float* cs, int j,
                                               bool ok) {
  uint4 res = make_uint4(0u, 0u, 0u, 0u);
  if (ok) {
    const uint4 a4 = *reinterpret_cast<const uint4*>(da_s);
    const uint4 z4 = *reinterpret_cast<const uint4*>(z_s);
    const bf16* a = reinterpret_cast<const bf16*>(&a4);
    const bf16* z = reinterpret_cast<const bf16*>(&z4);
    bf16* d = reinterpret_cast<bf16*>(&res);
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      float4 k[6];
#pragma unroll
      for (int q = 0; q < 6; ++q) k[q] = *reinterpret_cast<const float4*>(cs + q * 64 + 8 * j + 4 * v);
      const float* kq[6] = {&k[0].x, &k[1].x, &k[2].x, &k[3].x, &k[4].x, &k[5].x};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        d[4 * v + e] = from_float<bf16>(dz_of<kRelu>(to_float(a[4 * v + e]), to_float(z[4 * v + e]),
                                                     kq[0][e], kq[1][e], kq[2][e], kq[3][e],
                                                     kq[4][e], kq[5][e]));
      }
    }
  }
  return res;
}

// Byte offset of 16-byte chunk j of row r in a swizzled box or atom of
// 128-byte rows (the TMA's 128-byte swizzle, `Tile<64>`).
__device__ __forceinline__ uint32_t swz(int r, int j) { return r * 128 + ((j ^ (r & 7)) << 4); }

// The epilogue of a 64 x 128 accumulator tile of a warpgroup (named
// barrier `bar`, thread ct of its 128): bf16 pairs into 16 KB of shared
// memory at stg (two swizzled 64 x 64 atoms: the dx map's boxes), then
// thread 0 stores both boxes with TMA at (column col0, row row0) of dx; the
// memory may be handed back once that thread's sm90::bulk_wait_read()
// returns. Rows past M and columns past K are not written.
__device__ __forceinline__ void store_dx(const CUtensorMap* map_dx, unsigned char* stg_ptr,
                                         uint32_t stg, const float (&acc)[64], int row0, int col0,
                                         int bar, int ct) {
  // The lane through volatile asm: the 32 staging offsets follow from it,
  // and ptxas would otherwise hold them in registers across the kernel.
  int lane;
  asm volatile("mov.u32 %0, %%laneid;\n" : "=r"(lane));
  const int wrow = ct / 32 * 16;
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int r = wrow + sm90::acc_row(lane, i);
    const int c = sm90::acc_col(lane, i);
    *reinterpret_cast<__nv_bfloat162*>(stg_ptr + sm90::Tile<128>::offset<64>(r, c)) =
        __floats2bfloat162_rn(acc[i], acc[i + 1]);
  }
  sm90::fence_proxy_async();  // the tile, to the async proxy of the TMA store
  sm90::warpgroup_sync(bar - 1);
  if (ct == 0) {
    sm90::tma_store_2d(map_dx, stg, col0, row0);
    sm90::tma_store_2d(map_dx, stg + 64 * 128, col0 + 64, row0);
    sm90::bulk_commit();
  }
}

// The strip kernel's shared-memory map (byte offsets from a 1024-byte
// aligned base): each consumer warpgroup's dz, kAtoms atoms of 64 rows x
// 64 columns (N <= 64 kAtoms: 4 atoms and five stages up to N = 256, 8 and
// three up to 512), then the ring; a stage holds a dz item (dA and z boxes
// of 128 rows x 64 columns) or a W item (two boxes of 128 rows of K x 64
// columns of N).
template <int kAtoms>
struct DxStripSmem {
  static constexpr int kStages = kAtoms == 4 ? 5 : 3;
  static constexpr int kAtom = 64 * 128;           // 64 rows x 64 bf16
  static constexpr int kDzWg = kAtoms * kAtom;     // a warpgroup's dz
  static constexpr int kBox = 128 * 128;           // 128 rows x 64 bf16
  static constexpr int kRing = 2 * kDzWg;
  static constexpr int kStage = 2 * kBox;
  static constexpr int kBar = kRing + kStages * kStage;
  static constexpr int kAlloc = kBar + 2 * kStages * 8 + 1024;
};

template <bool kRelu, int kAtoms>
__global__ void __launch_bounds__(384, 1)
    bn_apply_dx_strip_sm90(const __grid_constant__ CUtensorMap map_da,
                           const __grid_constant__ CUtensorMap map_z,
                           const __grid_constant__ CUtensorMap map_w,
                           const __grid_constant__ CUtensorMap map_dx,
                           const float* __restrict__ consts, int M, int K, int N,
                           int k_group) {
  using S = DxStripSmem<kAtoms>;
  using Ring = sm90::Ring<S::kStages>;
  extern __shared__ __align__(1024) unsigned char smem_dxs[];
  const uint32_t raw = sm90::smem_u32(smem_dxs);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_dxs + (base - raw);
  const Ring ring(base + S::kBar);
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  if (tid == 0) ring.init(256);
  const int strips = (M + 127) / 128;
  const int dz_items = (N + 63) / 64;    // 64-column chunks of dA and z
  const int w_items = (N + 127) / 128;   // 128-column slices of W a K tile
  // Every slice runs all 8 k-steps (no branch among the products, which
  // would make ptxas fence each one): a slice's second box may lie past N,
  // where the TMA copy is all zeros, and its dz atom is zeroed here once.
  if (tid >= 128 && dz_items % 2) {
    uint4* pad = reinterpret_cast<uint4*>(smem + (tid - 128) / 128 * S::kDzWg +
                                          dz_items * S::kAtom);
    for (int i = tid % 128; i < S::kAtom / 16; i += 128) pad[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  sm90::fence_proxy_async();
  __syncthreads();

  // A tile is a strip and a group of k_group K tiles (the host's plan).
  const int k_tiles = (K + 127) / 128;
  const int groups = (k_tiles + k_group - 1) / k_group;
  const int tiles = strips * groups;
  int it = 0;  // items through the ring so far
  if (wg == 0) {
    // Producer (one thread): a tile's dz items, then its W items, K tile
    // by K tile.
    if (tid == 0) {
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = 128 * (t / groups);
        const int kt0 = k_group * (t % groups), kt1 = min(k_tiles, kt0 + k_group);
        for (int c = 0; c < dz_items; ++c, ++it) {
          const uint32_t bar = ring.acquire(it, S::kStage);
          const uint32_t st = base + S::kRing + (it % S::kStages) * S::kStage;
          sm90::tma_load_2d(st, &map_da, 64 * c, m0, bar);
          sm90::tma_load_2d(st + S::kBox, &map_z, 64 * c, m0, bar);
        }
        for (int kt = kt0; kt < kt1; ++kt) {
          for (int j = 0; j < w_items; ++j, ++it) {
            const uint32_t bar = ring.acquire(it, S::kStage);
            const uint32_t st = base + S::kRing + (it % S::kStages) * S::kStage;
            sm90::tma_load_2d(st, &map_w, 128 * j, 128 * kt, bar);
            sm90::tma_load_2d(st + S::kBox, &map_w, 128 * j + 64, 128 * kt, bar);
          }
        }
      }
    }
    return;
  }

  // Consumers: warpgroup cw owns rows [64 cw, 64 cw + 64) of each strip.
  const int cw = wg - 1;
  const int ct = tid % 128;
  const uint32_t dz_base = base + cw * S::kDzWg;
  unsigned char* dz_ptr = smem + cw * S::kDzWg;
  float acc[64];
  // The stage that staged the last tile's store: it goes back to the
  // producer once the next item has arrived (the store overlaps the wait)
  // and the store has read it.
  int held = -1;
  auto let_go = [&]() {
    if (held >= 0) {
      if (ct == 0) sm90::bulk_wait_read();
      ring.release(held);
      held = -1;
    }
  };
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = 128 * (t / groups);
    const int kt0 = k_group * (t % groups), kt1 = min(k_tiles, kt0 + k_group);
    // Every warp of the warpgroup is past its last products on the old dz.
    sm90::warpgroup_sync(wg);
    // dz of this warpgroup's 64 rows, chunk by chunk: thread ct makes the
    // 16-byte chunk j = ct % 8 of rows ct / 8 + 16 u.
    for (int c = 0; c < dz_items; ++c, ++it) {
      const int j = ct % 8;
      const int col = 64 * c + 8 * j;
      float kc[6][8];
      load_consts(kc, consts, N, col);
      ring.wait(it);
      let_go();
      const unsigned char* st =
          smem + S::kRing + (it % S::kStages) * S::kStage + cw * 64 * 128;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = ct / 8 + 16 * u;
        const uint32_t off = swz(r, j);
        *reinterpret_cast<uint4*>(dz_ptr + c * S::kAtom + off) =
            dz_chunk<kRelu>(st + off, st + S::kBox + off, kc, col < N && m0 + 64 * cw + r < M);
      }
      ring.release(it);
    }
    sm90::fence_proxy_async();  // dz, written by this thread, to the async proxy of `wgmma`
    sm90::warpgroup_sync(wg);   // the warpgroup's dz is in place
    for (int kt = kt0; kt < kt1; ++kt) {
      for (int j = 0; j < w_items; ++j, ++it) {
        ring.wait(it);
        let_go();
        const uint32_t st = base + S::kRing + (it % S::kStages) * S::kStage;
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          sm90::wgmma_m64n128<0, 0>(
              acc, sm90::Tile<64>::desc_k<64>(dz_base + (2 * j + kk / 4) * S::kAtom, kk % 4),
              sm90::Tile<64>::desc_k<128>(st + (kk / 4) * S::kBox, kk % 4), j > 0 || kk > 0);
        }
        sm90::wgmma_commit();
        // This slice's products stay in flight while the next is awaited;
        // the slice before has been read once they are the only ones left.
        sm90::wgmma_wait<1>();
        if (j > 0) ring.release(it - 1);
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      // The last slice's stage stages the tile (this warpgroup's half) once
      // both warpgroups' products have read it; it goes back to the
      // producer once stored.
      consumers_sync();
      const uint32_t stg = base + S::kRing + ((it - 1) % S::kStages) * S::kStage + cw * S::kBox;
      store_dx(&map_dx, smem + (stg - base), stg, acc, m0 + 64 * cw, 128 * kt, wg + 1, ct);
      held = it - 1;
    }
  }
  let_go();
  if (ct == 0) sm90::bulk_wait();
}

// The panel kernel's stage (byte offsets): a dA and a z box of 64 rows x
// 64 columns, the chunk's six constant rows (64 floats each, unswizzled),
// then W's slice: 2 KT boxes of 128 rows of K x 64 columns.
template <int KT>
struct DxPanelSmem {
  static constexpr int kStages = KT == 1 ? 4 : 2;
  static constexpr int kBoxA = 64 * 128;
  static constexpr int kBoxC = 6 * 64 * 4;
  static constexpr int kBoxW = 128 * 128;
  static constexpr int kZ = kBoxA;
  static constexpr int kC = 2 * kBoxA;
  static constexpr int kW = kC + 2048;
  static constexpr int kStage = kW + 2 * KT * kBoxW;
  static constexpr int kBar = kStages * kStage;
  static constexpr int kAlloc = kBar + 2 * kStages * 8 + 1024;
};

template <bool kRelu, int KT>
__global__ void __launch_bounds__(384, 1)
    bn_apply_dx_panel_sm90(const __grid_constant__ CUtensorMap map_da,
                           const __grid_constant__ CUtensorMap map_z,
                           const __grid_constant__ CUtensorMap map_w,
                           const __grid_constant__ CUtensorMap map_c,
                           const __grid_constant__ CUtensorMap map_dx, int M, int K, int N) {
  using S = DxPanelSmem<KT>;
  using Ring = sm90::Ring<S::kStages>;
  constexpr int kKw = 256 * KT;  // columns of K a tile
  extern __shared__ __align__(1024) unsigned char smem_dxp[];
  const uint32_t raw = sm90::smem_u32(smem_dxp);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_dxp + (base - raw);
  const Ring ring(base + S::kBar);
  const int tid = threadIdx.x;
  if (tid == 0) ring.init(256);
  __syncthreads();

  const int ranges = (K + kKw - 1) / kKw;
  const int tiles = ((M + 63) / 64) * ranges;
  const int chunks = (N + 63) / 64;
  // Item q of this block: chunk q % chunks of tile blockIdx.x + (q / chunks) gridDim.x.
  const int total = ((tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x) * chunks;
  auto tile_of = [&](int q) { return (int)blockIdx.x + (q / chunks) * (int)gridDim.x; };
  if (tid >= 256) {
    // Producer (thread 256; its warpgroup gives its registers up for KT =
    // 2's 128 accumulator floats a consumer thread). A W box that starts
    // past K is not copied: its products (stale shared memory) meet only
    // columns of dx that are never stored.
    if constexpr (KT == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 256) {
      for (int q = 0; q < total; ++q) {
        const int t = tile_of(q), c = q % chunks;
        const int m0 = 64 * (t / ranges), k0 = kKw * (t % ranges);
        const int wb = min(2 * KT, (K - k0 + 127) / 128);
        const uint32_t bar = ring.acquire(q, 2 * S::kBoxA + S::kBoxC + wb * S::kBoxW);
        const uint32_t st = base + (q % S::kStages) * S::kStage;
        sm90::tma_load_2d(st, &map_da, 64 * c, m0, bar);
        sm90::tma_load_2d(st + S::kZ, &map_z, 64 * c, m0, bar);
        sm90::tma_load_2d(st + S::kC, &map_c, 64 * c, 0, bar);
        for (int b = 0; b < wb; ++b) {
          sm90::tma_load_2d(st + S::kW + b * S::kBoxW, &map_w, 64 * c, k0 + 128 * b, bar);
        }
      }
    }
    return;
  }

  // Consumers (threads 0-255). Both warpgroups read the whole 64-row dz
  // chunk; warpgroup cw owns columns [k0 + 128 KT cw, + 128 KT) of dx, KT
  // accumulators.
  if constexpr (KT == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int cw = tid / 128;
  const int ct = tid;
  // dz of item q over dA's slot of its stage: thread ct makes chunk j = ct
  // % 8 of rows ct / 8 + 32 u.
  auto make_dz = [&](int q) {
    const int t = tile_of(q), c = q % chunks;
    const int m0 = 64 * (t / ranges);
    const int j = ct % 8;
    const int col = 64 * c + 8 * j;
    unsigned char* st = smem + (q % S::kStages) * S::kStage;
    const float* cs = reinterpret_cast<const float*>(st + S::kC);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = ct / 8 + 32 * u;
      const uint32_t off = swz(r, j);
      *reinterpret_cast<uint4*>(st + off) =
          dz_chunk_smem<kRelu>(st + off, st + S::kZ + off, cs, j, col < N && m0 + r < M);
    }
  };

  float acc[KT][64];
  if (total > 0) {
    ring.wait(0);
    make_dz(0);
    sm90::fence_proxy_async();  // dz, written by this thread, to the async proxy of `wgmma`
    consumers_sync();           // every thread's part of item 0's dz is in place
  }
  int q = 0;  // items so far
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = 64 * (t / ranges), k0 = kKw * (t % ranges);
    for (int c = 0; c < chunks; ++c, ++q) {
      const uint32_t st = base + (q % S::kStages) * S::kStage;
      sm90::wgmma_fence();
#pragma unroll
      for (int h = 0; h < KT; ++h) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          sm90::wgmma_m64n128<0, 0>(
              acc[h], sm90::Tile<64>::desc_k<64>(st, kk),
              sm90::Tile<64>::desc_k<128>(st + S::kW + (KT * cw + h) * S::kBoxW, kk),
              c > 0 || kk > 0);
        }
      }
      sm90::wgmma_commit();
      // The next item's dz is made while this item's products run.
      if (q + 1 < total) {
        ring.wait(q + 1);
        make_dz(q + 1);
        sm90::fence_proxy_async();
      }
      sm90::wgmma_wait<0>();
      // The tile's last item keeps its stage for the epilogue.
      if (c + 1 < chunks) ring.release(q);
      if (q + 1 < total) consumers_sync();
    }
    // Epilogue: each accumulator through this warpgroup's own W box of the
    // last item's stage (no other warpgroup reads it), then the stage goes
    // back to the producer.
    const uint32_t st = base + ((q - 1) % S::kStages) * S::kStage;
#pragma unroll
    for (int h = 0; h < KT; ++h) {
      sm90::fence_regs(acc[h]);
      const uint32_t stg = st + S::kW + (KT * cw + h) * S::kBoxW;
      store_dx(&map_dx, smem + (stg - base), stg, acc[h], m0, k0 + 128 * (KT * cw + h), cw + 2,
               ct % 128);
    }
    if (ct % 128 == 0) sm90::bulk_wait_read();
    ring.release(q - 1);
  }
  if (ct % 128 == 0) sm90::bulk_wait();
}

template <class Kernel>
cudaError_t set_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <bool kRelu, int KT>
cudaError_t launch_dw_sm90(const void* da, const void* z, const void* x, const float* consts,
                           float* out, int M, int K, int N, int rows_per_split, int splits,
                           cudaStream_t s) {
  cudaError_t err = set_smem(bn_apply_dw_kernel_sm90<kRelu, KT>, DwSmem<KT>::kAlloc);
  if (err != cudaSuccess) return err;
  CUtensorMap map_x, map_da, map_z;
  err = sm90::make_tmap_2d(&map_x, x, M, K, 64);
  if (err == cudaSuccess) err = sm90::make_tmap_2d(&map_da, da, M, N, 64);
  if (err == cudaSuccess) err = sm90::make_tmap_2d(&map_z, z, M, N, 64);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + 127) / 128, (K + 128 * KT - 1) / (128 * KT), splits);
  bn_apply_dw_kernel_sm90<kRelu, KT><<<grid, 384, DwSmem<KT>::kAlloc, s>>>(
      map_x, map_da, map_z, consts, out, M, K, N, rows_per_split);
  return cudaGetLastError();
}

int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

template <typename T, bool kRelu>
cudaError_t launch_reduce(const void* da, const void* z, const float* consts, float* part,
                          float* s12, float* consts_out, int* tickets, int M, int N,
                          int rows_per_split, int strips, int splits, cudaStream_t s) {
  constexpr bool kF32 = sizeof(T) == 4;
  cudaError_t err = set_smem(bn_reduce_kernel_sm90<T, kRelu>, RedSmem::kAlloc);
  if (err != cudaSuccess) return err;
  CUtensorMap map_da, map_z;
  err = sm90::make_tmap_2d(&map_da, da, M, N, RedSmem::kRows, kF32);
  if (err == cudaSuccess) err = sm90::make_tmap_2d(&map_z, z, M, N, RedSmem::kRows, kF32);
  if (err != cudaSuccess) return err;
  bn_reduce_kernel_sm90<T, kRelu><<<dim3(strips, splits), 256, RedSmem::kAlloc, s>>>(
      map_da, map_z, consts, part, s12, consts_out, tickets, M, N, rows_per_split);
  return cudaGetLastError();
}

// bf16 dx on a persistent grid through the strip kernel (k_cols columns of
// K a tile) or the panel kernel (k_cols = 256 KT).
template <bool kRelu>
cudaError_t launch_dx_sm90(const void* da, const void* z, const void* w, const float* consts,
                           void* dx, int M, int K, int N, int strip, int k_cols,
                           cudaStream_t s) {
  const int rows = strip ? 128 : 64;
  // dx is stored in 64 x 64 boxes; the panel kernel copies the constants'
  // rows 0-5 of each 64-column chunk unswizzled.
  CUtensorMap map_da, map_z, map_w, map_dx, map_c;
  cudaError_t err = sm90::make_tmap_2d(&map_da, da, M, N, rows);
  if (err == cudaSuccess) err = sm90::make_tmap_2d(&map_z, z, M, N, rows);
  if (err == cudaSuccess) err = sm90::make_tmap_2d(&map_w, w, K, N, 128);
  if (err == cudaSuccess) err = sm90::make_tmap_2d(&map_dx, dx, M, K, 64);
  if (err == cudaSuccess) err = sm90::make_tmap_2d(&map_c, consts, 8, N, 6, true, 64);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)((M + rows - 1) / rows) * ((K + k_cols - 1) / k_cols);
  const int grid = (int)std::min<long long>(tiles, sm_count());
  if (strip && N <= 256) {
    err = set_smem(bn_apply_dx_strip_sm90<kRelu, 4>, DxStripSmem<4>::kAlloc);
    if (err != cudaSuccess) return err;
    bn_apply_dx_strip_sm90<kRelu, 4><<<grid, 384, DxStripSmem<4>::kAlloc, s>>>(
        map_da, map_z, map_w, map_dx, consts, M, K, N, k_cols / 128);
  } else if (strip) {
    err = set_smem(bn_apply_dx_strip_sm90<kRelu, 8>, DxStripSmem<8>::kAlloc);
    if (err != cudaSuccess) return err;
    bn_apply_dx_strip_sm90<kRelu, 8><<<grid, 384, DxStripSmem<8>::kAlloc, s>>>(
        map_da, map_z, map_w, map_dx, consts, M, K, N, k_cols / 128);
  } else if (k_cols == 256) {
    err = set_smem(bn_apply_dx_panel_sm90<kRelu, 1>, DxPanelSmem<1>::kAlloc);
    if (err != cudaSuccess) return err;
    bn_apply_dx_panel_sm90<kRelu, 1><<<grid, 384, DxPanelSmem<1>::kAlloc, s>>>(
        map_da, map_z, map_w, map_c, map_dx, M, K, N);
  } else {
    err = set_smem(bn_apply_dx_panel_sm90<kRelu, 2>, DxPanelSmem<2>::kAlloc);
    if (err != cudaSuccess) return err;
    bn_apply_dx_panel_sm90<kRelu, 2><<<grid, 384, DxPanelSmem<2>::kAlloc, s>>>(
        map_da, map_z, map_w, map_c, map_dx, M, K, N);
  }
  return cudaGetLastError();
}

cudaError_t apply_dx_f32(const void* da, const void* z, const void* w, const float* consts,
                         void* dx, int M, int K, int N, bool relu, cudaStream_t s) {
  const dim3 grid((K + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  auto kernel = relu ? bn_apply_dx_kernel<float, true> : bn_apply_dx_kernel<float, false>;
  kernel<<<grid, kThreads, 0, s>>>(static_cast<const float*>(da), static_cast<const float*>(z),
                                   static_cast<const float*>(w), consts, static_cast<float*>(dx),
                                   M, K, N);
  return cudaGetLastError();
}

// dW partials of every M range into out ([splits, K, N], or dW with one
// range): the bf16 kernel or the fp32 one.
cudaError_t apply_dw(const void* da, const void* z, const void* x, const float* consts,
                     float* out, int M, int K, int N, int rows_per_split, int tile_rows,
                     int splits, int is_f32, bool relu, cudaStream_t s) {
  if (!is_f32) {
    auto launch = tile_rows == 256 ? (relu ? launch_dw_sm90<true, 2> : launch_dw_sm90<false, 2>)
                                   : (relu ? launch_dw_sm90<true, 1> : launch_dw_sm90<false, 1>);
    return launch(da, z, x, consts, out, M, K, N, rows_per_split, splits, s);
  }
  const dim3 grid((N + kBN - 1) / kBN, (K + kBM - 1) / kBM, splits);
  auto kernel = relu ? bn_apply_dw_kernel<float, true> : bn_apply_dw_kernel<float, false>;
  kernel<<<grid, kThreads, 0, s>>>(static_cast<const float*>(da), static_cast<const float*>(z),
                                   static_cast<const float*>(x), consts, out, M, K, N,
                                   rows_per_split);
  return cudaGetLastError();
}

bool bad_shape(int M, int N) { return M <= 0 || N <= 0 || N % 8; }

}  // namespace

// s1 and s2 into s12 [2, N] f32 and, unless consts_out is null, s1 / M and
// s2 / M into its rows 4-5 ([8, N] f32). A block owns 128 bytes of columns
// (64 bf16, 32 fp32) and rows_per_split rows (a multiple of 128 unless
// there is one range); part holds the [strips, splits, 2, 128 bytes / 4]
// f32 partials; tickets holds n_tickets zeroed ints (at least one a strip),
// which the launch leaves zeroed.
extern "C" int bn_bwd_reduce(const void* da, const void* z, const void* consts, void* part,
                             void* s12, void* consts_out, void* tickets, int n_tickets, int M,
                             int N, int rows_per_split, int is_f32, int relu, void* stream) {
  if (bad_shape(M, N) || rows_per_split <= 0) return (int)cudaErrorInvalidValue;
  const int strips = (N + (is_f32 ? 32 : 64) - 1) / (is_f32 ? 32 : 64);
  const int splits = (M + rows_per_split - 1) / rows_per_split;
  if (strips > n_tickets || splits > 65535 || (splits > 1 && rows_per_split % RedSmem::kRows))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(consts);
  float* p = static_cast<float*>(part);
  float* o = static_cast<float*>(s12);
  float* co = static_cast<float*>(consts_out);
  int* t = static_cast<int*>(tickets);
  auto launch = is_f32 ? (relu ? launch_reduce<float, true> : launch_reduce<float, false>)
                       : (relu ? launch_reduce<bf16, true> : launch_reduce<bf16, false>);
  return (int)launch(da, z, c, p, o, co, t, M, N, rows_per_split, strips, splits, s);
}

// dx [M, K] in the operands' dtype. bf16: strip = 1 takes the strip kernel
// (N <= 512) with k_cols (a multiple of 128) columns of K a tile, strip = 0
// the panel kernel with k_cols = 256 or 512 (planned by
// ops/fused_conv_bn.py `dx_plan`); fp32 ignores both.
extern "C" int bn_bwd_apply_dx(const void* da, const void* z, const void* w, const void* consts,
                               void* dx, int M, int K, int N, int strip, int k_cols, int is_f32,
                               int relu, void* stream) {
  if (bad_shape(M, N) || K <= 0 || K % 8 || (M + kBM - 1) / kBM > 65535)
    return (int)cudaErrorInvalidValue;
  if (!is_f32 && !(strip ? N <= 512 && k_cols > 0 && k_cols % 128 == 0
                         : k_cols == 256 || k_cols == 512))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(consts);
  if (is_f32) return (int)apply_dx_f32(da, z, w, c, dx, M, K, N, relu, s);
  return (int)(relu ? launch_dx_sm90<true>(da, z, w, c, dx, M, K, N, strip, k_cols, s)
                    : launch_dx_sm90<false>(da, z, w, c, dx, M, K, N, strip, k_cols, s));
}

// dW [K, N] f32 from dA, z [M, N] and x [M, K]; part holds the
// [ceil(M / rows_per_split), K, N] f32 partials (unused, may be null, with
// one split), summed into dW in a fixed order. tile_rows: rows of dW (of
// K) a block of the bf16 kernel owns, 128 or 256 (planned by
// ops/fused_conv_bn.py; fp32 ignores it).
extern "C" int bn_bwd_apply_dw(const void* da, const void* z, const void* x, const void* consts,
                               void* part, void* dw, int M, int K, int N, int rows_per_split,
                               int tile_rows, int is_f32, int relu, void* stream) {
  if (bad_shape(M, N) || K <= 0 || K % 8 || rows_per_split <= 0)
    return (int)cudaErrorInvalidValue;
  const int splits = (M + rows_per_split - 1) / rows_per_split;
  if (splits > 65535 || (K + kBM - 1) / kBM > 65535 || (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  // bf16: each range a whole number of the kernel's 64-row chunks.
  if (!is_f32 && ((splits > 1 && rows_per_split % 64) || (tile_rows != 128 && tile_rows != 256)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(splits > 1 ? part : dw);
  cudaError_t err = apply_dw(da, z, x, static_cast<const float*>(consts), out, M, K, N,
                             rows_per_split, tile_rows, splits, is_f32, relu, s);
  if (err != cudaSuccess || splits == 1) return (int)err;
  return (int)sum_splits(out, static_cast<float*>(dw), (int64_t)K * N, splits, s);
}

template <class Kernel>
cudaError_t occupancy_of(Kernel kernel, int threads, int smem, int* blocks_per_sm) {
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, threads, smem);
}

// Dynamic shared memory (bytes) and resident blocks per SM of one kernel:
// which = 0 bf16 dW (256-row tiles), 1 the dx strip kernel up to N = 256, 2
// up to N = 512, 3 the dx panel kernel with KT = 1, 4 with KT = 2, 5 the
// bf16 reduce. Returns a cudaError_t.
extern "C" int fused_conv_bn_occupancy(int which, int* smem_bytes, int* blocks_per_sm) {
  switch (which) {
    case 0:
      *smem_bytes = DwSmem<2>::kAlloc;
      return (int)occupancy_of(bn_apply_dw_kernel_sm90<true, 2>, 384, *smem_bytes,
                               blocks_per_sm);
    case 1:
      *smem_bytes = DxStripSmem<4>::kAlloc;
      return (int)occupancy_of(bn_apply_dx_strip_sm90<true, 4>, 384, *smem_bytes,
                               blocks_per_sm);
    case 2:
      *smem_bytes = DxStripSmem<8>::kAlloc;
      return (int)occupancy_of(bn_apply_dx_strip_sm90<true, 8>, 384, *smem_bytes,
                               blocks_per_sm);
    case 3:
      *smem_bytes = DxPanelSmem<1>::kAlloc;
      return (int)occupancy_of(bn_apply_dx_panel_sm90<true, 1>, 384, *smem_bytes,
                               blocks_per_sm);
    case 4:
      *smem_bytes = DxPanelSmem<2>::kAlloc;
      return (int)occupancy_of(bn_apply_dx_panel_sm90<true, 2>, 384, *smem_bytes,
                               blocks_per_sm);
    case 5:
      *smem_bytes = RedSmem::kAlloc;
      return (int)occupancy_of(bn_reduce_kernel_sm90<bf16, true>, 256, *smem_bytes,
                               blocks_per_sm);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* fused_conv_bn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
