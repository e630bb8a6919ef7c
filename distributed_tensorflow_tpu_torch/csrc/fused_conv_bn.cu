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
// What the TPU kernels did in one sequential grid becomes three kernels:
//   bn_reduce_kernel  blocks over (64-column strip, M range) each write their
//                     own [2, N] partial row; the wrapper sums the partials
//                     (as the JAX package sums them outside the kernel);
//   bn_apply_dx_kernel one block per 128 x 128 tile of dx, dz recomputed
//                     from dA, z and the constants for each chunk of N it
//                     reduces over;
//   bn_apply_dw_kernel_sm90 (bf16) and bn_apply_dw_kernel (fp32) one block
//                     per (tile of dW, M range): the TPU carried
//                     dW across its sequential grid; here each block loops
//                     over its M range and writes an f32 partial, which a
//                     second kernel (conv1x1_tile.cuh `sum_splits_kernel`)
//                     adds in a fixed order. No atomics, so the result is
//                     the same in every run.
// dz never goes to device memory: each block makes the tile it multiplies
// in registers and shared memory, which is what the TPU kernel was for.
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
// Both apply kernels recompute dz once per tile of K (from L2: the K tiles
// of one M strip run side by side), and split dW's partials cost one
// more write and read of [splits, K, N] f32. The dx kernel and the fp32 dW
// kernel (the first design, on conv1x1_tile.cuh's BlockGemm) are capped at
// 128 registers a thread for two blocks an SM: the loop waits on the
// global loads of dA and z each chunk, and one block of 8 warps leaves the
// SM idle meanwhile.

#include "conv1x1_tile.cuh"
#include "sm90_gemm.cuh"

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

constexpr int kReduceCols = 64;  // columns per reduce block: 8 threads x 8

template <typename T, bool kRelu>
__global__ void __launch_bounds__(256)
    bn_reduce_kernel(const T* __restrict__ da, const T* __restrict__ z,
                     const float* __restrict__ consts, float* __restrict__ part, int M, int N,
                     int rows_per_split) {
  __shared__ float red[2][32][kReduceCols + 1];
  const int cg = threadIdx.x % 8, rg = threadIdx.x / 8;
  const int n = blockIdx.x * kReduceCols + cg * 8;
  const int mb = blockIdx.y * rows_per_split;
  const int me = min(M, mb + rows_per_split);
  float s1[8], s2[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) s1[e] = s2[e] = 0.f;
  if (n < N) {
    float mu[8], inv[8], gamma[8], beta[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      mu[e] = consts[n + e];
      inv[e] = consts[N + n + e];
      gamma[e] = consts[2 * N + n + e];
      beta[e] = consts[3 * N + n + e];
    }
    for (int m = mb + rg; m < me; m += 32) {
      __align__(16) T a[8], b[8];
      const int64_t off = (int64_t)m * N + n;
#pragma unroll
      for (int v = 0; v < 8 / kVec<T>; ++v) {
        reinterpret_cast<uint4*>(a)[v] = reinterpret_cast<const uint4*>(da + off)[v];
        reinterpret_cast<uint4*>(b)[v] = reinterpret_cast<const uint4*>(z + off)[v];
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float xh = __fmul_rn(__fsub_rn(to_float(b[e]), mu[e]), inv[e]);
        float g = to_float(a[e]);
        if (kRelu && !(__fadd_rn(__fmul_rn(gamma[e], xh), beta[e]) > 0.f)) g = 0.f;
        s1[e] = __fadd_rn(s1[e], g);
        s2[e] = __fadd_rn(s2[e], __fmul_rn(g, xh));
      }
    }
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    red[0][rg][cg * 8 + e] = s1[e];
    red[1][rg][cg * 8 + e] = s2[e];
  }
  __syncthreads();
  if (threadIdx.x < 2 * kReduceCols) {
    const int which = threadIdx.x / kReduceCols, col = threadIdx.x % kReduceCols;
    const int nn = blockIdx.x * kReduceCols + col;
    float t = 0.f;
    for (int r = 0; r < 32; ++r) t += red[which][r][col];
    if (nn < N) part[((int64_t)blockIdx.y * 2 + which) * N + nn] = t;
  }
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

template <typename T>
cudaError_t reduce(const void* da, const void* z, const float* consts, float* part, int M, int N,
                   int rows_per_split, bool relu, cudaStream_t s) {
  const dim3 grid((N + kReduceCols - 1) / kReduceCols, (M + rows_per_split - 1) / rows_per_split);
  auto kernel = relu ? bn_reduce_kernel<T, true> : bn_reduce_kernel<T, false>;
  kernel<<<grid, 256, 0, s>>>(static_cast<const T*>(da), static_cast<const T*>(z), consts, part,
                              M, N, rows_per_split);
  return cudaGetLastError();
}

template <typename T>
cudaError_t apply_dx(const void* da, const void* z, const void* w, const float* consts, void* dx,
                     int M, int K, int N, bool relu, cudaStream_t s) {
  const dim3 grid((K + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  auto kernel = relu ? bn_apply_dx_kernel<T, true> : bn_apply_dx_kernel<T, false>;
  kernel<<<grid, kThreads, 0, s>>>(static_cast<const T*>(da), static_cast<const T*>(z),
                                   static_cast<const T*>(w), consts, static_cast<T*>(dx), M, K,
                                   N);
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

// s1/s2 partials [ceil(M / rows_per_split), 2, N] f32.
extern "C" int bn_bwd_reduce(const void* da, const void* z, const void* consts, void* part, int M,
                             int N, int rows_per_split, int is_f32, int relu, void* stream) {
  if (bad_shape(M, N) || rows_per_split <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(consts);
  float* p = static_cast<float*>(part);
  return (int)(is_f32 ? reduce<float>(da, z, c, p, M, N, rows_per_split, relu, s)
                      : reduce<__nv_bfloat16>(da, z, c, p, M, N, rows_per_split, relu, s));
}

// dx [M, K] in the operands' dtype.
extern "C" int bn_bwd_apply_dx(const void* da, const void* z, const void* w, const void* consts,
                               void* dx, int M, int K, int N, int is_f32, int relu,
                               void* stream) {
  if (bad_shape(M, N) || K <= 0 || K % 8 || (M + kBM - 1) / kBM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(consts);
  return (int)(is_f32 ? apply_dx<float>(da, z, w, c, dx, M, K, N, relu, s)
                      : apply_dx<__nv_bfloat16>(da, z, w, c, dx, M, K, N, relu, s));
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

// Dynamic shared memory (bytes) and resident blocks per SM of the bf16 dW
// kernel with 256-row tiles. Returns a cudaError_t.
extern "C" int fused_conv_bn_occupancy(int* smem_bytes, int* blocks_per_sm) {
  *smem_bytes = DwSmem<2>::kAlloc;
  cudaError_t err = set_smem(bn_apply_dw_kernel_sm90<true, 2>, *smem_bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, bn_apply_dw_kernel_sm90<true, 2>, 384, *smem_bytes);
}

extern "C" const char* fused_conv_bn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
