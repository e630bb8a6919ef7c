// Flash-attention backward for Hopper (sm_90a): a dQ kernel and a dK/dV
// kernel, bf16 tensor cores or fp32 FMA.
//
// Replaces the TPU kernels of distributed_tensorflow_tpu/ops/flash_attention.py:
//   `_bwd_dq_kernel` (:175) and `_bwd_dkv_kernel` (:216), the [B*H, L, D]
//   family launched by `_bwd_impl` (:262), and `_bwd_dq_kernel_packed`
//   (:490) and `_bwd_dkv_kernel_packed` (:559), the flat [B, L, H*D] family
//   launched by `_bwd_impl_packed` (:639).
// As in the forward (flash_fwd.cu), the two kernels read the strided
// [B, L, H, D] layout directly, so the TPU's two families (which exist for
// Mosaic's (8, 128) tiling) collapse into one pair.
//
// Semantics (identical to the TPU kernels), per (batch, head), with
// scale = D^-0.5 and lse the forward's natural-log logsumexp:
//   s  = (scale * log2 e) * q k^T in f32, masked keys set to -1e30 * log2 e
//        (the SCALED value: a fully masked row carries lse = -1e30, and the
//        recompute must cancel the two exactly or exp2 overflows to inf)
//   p  = exp2(s - lse * log2 e) * keymask
//   dp = do v^T in f32;  ds = p * (dp - delta)
//        delta = rowsum(do * o) - dlse, computed by the wrapper in f32
//   dq = scale * ds.astype(K) k,  dv = p.astype(dO)^T do,
//   dk = scale * ds.astype(Q)^T q    (all f32 accumulation)
// Keys and queries past L (the ragged edge) are masked here: the forward
// does not pad on the card either. Both products that cancel in the mask
// (s * scale_log2 and lse * log2 e) are rounded multiplies (__fmul_rn), so
// the compiler cannot contract one of them into an FMA and break the exact
// cancellation.
//
// The TPU's two-kernel split: each block writes only its own tile, so no
// atomics are needed, and a loop inside the block replaces the TPU's
// sequential grid.
//
// dQ, bf16 (`flash_bwd_dq_sm90<D>`), on the skeleton of the forward's
// `flash_fwd_sm90`: one warpgroup of 128 threads per (64-row q tile, head,
// batch). (Two warpgroups on a 128-row q tile, one resident block per SM,
// were slower at every timed shape than three 64-row blocks.) Q and
// dO are copied once into swizzled tiles; each thread reads lse * log2 e
// and delta of its two accumulator rows into registers. K, V and the 64-key mask stream through the
// forward's two-stage `cp.async` ring (one `mbarrier` per stage that both
// fills and frees it). Per K/V tile: S = Q K^T and dP = dO V^T by `wgmma`
// m64n64k16 from shared memory, all operands K-major; P = exp2(S scale_log2
// - lse log2 e) * mask and dS = P (dP - delta) in f32 registers; dS goes to
// bf16 in registers and is the register A operand of dQ += dS K (K read
// MN-major, n = one 64- or 32-column swizzle atom per `wgmma`, so D = 128
// takes two n64 halves). S, dP, dS and the dQ sum never touch shared
// memory, and nothing synchronises the block between the products. The
// epilogue scales dQ, stages it through the warpgroup's Q tile and stores
// 16-byte vectors, rows past L not written. Rows past L read zero Q and
// dO, so their dS is zero (lse and delta read as 0 there), and a row's dQ
// depends on its own dS alone. Registers at D = 128: S, dP and dQ take 32 +
// 32 + 64 floats.
//
// dK/dV, bf16 (`flash_bwd_dkv_sm90`): one warpgroup of 128 threads per
// (64-key tile, head, batch), looping over q tiles of 64 rows (32 at
// D = 128, which keeps dK, dV, S^T and dP^T under 255 registers). The
// products are transposed so that the block's 64 keys are the M dimension
// of every `wgmma`: S^T = K Q^T and dP^T = V dO^T (m64nBQk16, all operands
// K-major from shared memory), then dV += P^T dO and dK += dS^T Q with P^T
// and dS^T as the register A operand and dO, Q read MN-major. Each thread
// therefore owns whole key rows of P^T and dS^T: the key mask is two
// registers, lse * log2 e and delta are per column, read from the ring
// stage. P^T, dS^T, dK and dV never touch shared memory, and nothing
// synchronises the block between the products. K and V are copied once;
// Q, dO and their lse and delta stream through a two-stage ring of
// `cp.async` copies guarded by one `mbarrier` per stage, as in flash_fwd.cu:
// tile i + 1 is copied under tile i's products. The epilogue scales dK,
// stages dK and dV through K's and V's buffers and stores 16-byte vectors,
// rows past L not written. Shared memory at D = 64: 51,216 B (K, V 16 KB,
// 2 x (Q + dO) 32 KB, lse and delta 1 KB, + 1 KB to align the base), 167
// registers a thread: 3 resident blocks per SM on an H100 (the old design:
// 125,696 B, one).
//
// fp32 (`flash_bwd_dq_kernel`, `flash_bwd_dkv_kernel`): scalar FMA, one
// block of 4 warps per 64-row tile, the current tiles, the f32 S and dP
// tiles (P and dS written over them) and the f32 accumulators in dynamic
// shared memory (up to 225 KB for dK/dV at D = 128). Resident blocks per SM
// of the bf16 kernels are read at run time by flash_bwd_occupancy (printed
// by chip_smoke.py).
//
// Bounds at the training cell (B = 24, L = 512, H = 12, D = 64, bf16, no
// padding) on an H100 SXM:
//   dK/dV: four products (S, dP, dV, dK), 8 * B * H * L^2 * D = 38.7 GFLOP
//     -> 39.1 us at 989 TFLOP/s; q, k, v, dO read and dk, dv written,
//     6 * 18.9 MB = 113 MB -> 33.8 us at 3.35 TB/s: 0.0391 ms, operations.
//   dQ: three products (S, dP, dQ), 29.0 GFLOP -> 0.0293 ms, operations.
// The first dK/dV design (WMMA, synchronous loads, S, dP, P, dS and both
// accumulators round-tripping through 125,696 B of shared memory: one block
// per SM) took 1.31 ms there, 17.5 waves of one block's serial latency;
// this one 0.143 ms (chip_smoke.py, H100 80GB HBM3 at 700 W; SDPA's
// backward of dK and dV alone 0.383 ms). The first dQ design (the same
// WMMA round trips through 97 KB of shared memory, two blocks per SM) took
// 0.607 ms there.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_flash.cuh"

namespace {

constexpr int kBQ = 64;  // query rows per tile
constexpr int kBK = 64;  // keys per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 16;
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// fp32: scalar FMA through shared memory
// ---------------------------------------------------------------------------

// dQ block: Q and dO tiles, the current K/V tile, S, dP (dS written over
// it), the dQ sum.
template <int D>
struct SmemDq {
  float q[kBQ * D];
  float dout[kBQ * D];
  float k[kBK * D];
  float v[kBK * D];
  float s[kBQ * kBK];
  float dp[kBQ * kBK];
  float acc[kBQ * D];
  float lse2[kBQ];   // lse * log2 e per q row
  float delta[kBQ];
  float kmask[kBK];
};

// dK/dV block: the resident K/V tile, the current Q/dO tile, S and dP (P
// and dS written over them) and both sums.
template <int D>
struct SmemDkv {
  float k[kBK * D];
  float v[kBK * D];
  float q[kBQ * D];
  float dout[kBQ * D];
  float s[kBQ * kBK];
  float dp[kBQ * kBK];
  float dk[kBK * D];
  float dv[kBK * D];
  float lse2[kBQ];
  float delta[kBQ];
  float kmask[kBK];
};

// Copy rows [row0, row0 + 64) of one head into shared memory (row stride
// D) in 16-byte vectors, zero-filling rows at or past `rows_valid`.
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src, int row0,
                                          int rows_valid, int64_t row_stride) {
  constexpr int kChunks = D / 4;
  for (int i = threadIdx.x; i < 64 * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 4;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows_valid) {
      val = *reinterpret_cast<const uint4*>(src + (int64_t)(row0 + r) * row_stride + c);
    }
    *reinterpret_cast<uint4*>(dst + r * D + c) = val;
  }
}

// out[r0:r0+16, 0:64] = A[r0:r0+16, 0:D] . B[0:64, 0:D]^T.
template <int D>
__device__ __forceinline__ void mma_abt(float* out, const float* a, const float* b, int r0,
                                        int lane) {
  for (int idx = lane; idx < kRowsPerWarp * 64; idx += 32) {
    const int r = r0 + idx / 64;
    const int c = idx % 64;
    const float* ar = a + r * D;
    const float* br = b + c * D;
    float acc = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) acc = fmaf(ar[d], br[d], acc);
    out[r * kBK + c] = acc;
  }
}

// acc[r0:r0+16, 0:D] += A[r0:r0+16, 0:64] . B[0:64, 0:D].
template <int D>
__device__ __forceinline__ void mma_acc_ab(float* acc, const float* a, const float* b, int r0,
                                           int lane) {
  for (int idx = lane; idx < kRowsPerWarp * D; idx += 32) {
    const int r = r0 + idx / D;
    const int d = idx % D;
    float sum = acc[r * D + d];
#pragma unroll 8
    for (int c = 0; c < 64; ++c) sum = fmaf(a[r * kBK + c], b[c * D + d], sum);
    acc[r * D + d] = sum;
  }
}

// acc[r0:r0+16, 0:D] += A[0:64, r0:r0+16]^T . B[0:64, 0:D] (the dK/dV
// kernel's products).
template <int D>
__device__ __forceinline__ void mma_acc_atb(float* acc, const float* a, const float* b, int r0,
                                            int lane) {
  for (int idx = lane; idx < kRowsPerWarp * D; idx += 32) {
    const int r = r0 + idx / D;
    const int d = idx % D;
    float sum = acc[r * D + d];
#pragma unroll 8
    for (int c = 0; c < 64; ++c) sum = fmaf(a[c * kBK + r], b[c * D + d], sum);
    acc[r * D + d] = sum;
  }
}

// P and dS for this warp's 16 q rows, written over the S and dP tiles, two
// lanes per row, 32 keys each. `with_p` = false leaves S as it is (the dQ
// kernel needs only dS).
__device__ __forceinline__ void p_and_ds(float* s, float* dp, bool with_p, const float* lse2,
                                         const float* delta, const float* kmask,
                                         int rows_valid, int r0, int lane, float scale_log2) {
  const int row = r0 + (lane >> 1);
  const int c0 = (lane & 1) * 32;
  const bool valid = row < rows_valid;
  const float l2 = lse2[row];
  const float dl = delta[row];
  const float neg_scaled = __fmul_rn(kNeg, kLog2e);
#pragma unroll 8
  for (int i = 0; i < 32; ++i) {
    const int c = c0 + i;
    const float km = kmask[c];
    const float sv = km != 0.f ? __fmul_rn(s[row * kBK + c], scale_log2) : neg_scaled;
    const float p = valid ? exp2f(__fsub_rn(sv, l2)) * km : 0.f;
    const float ds = p * (dp[row * kBK + c] - dl);
    if (with_p) s[row * kBK + c] = p;
    dp[row * kBK + c] = ds;
  }
}

// lse * log2 e and delta of q rows [q0, q0 + 64) of head (b, h); zero past L.
__device__ __forceinline__ void load_row_stats(float* lse2, float* dlt,
                                               const float* __restrict__ lse,
                                               const float* __restrict__ delta, int64_t base,
                                               int q0, int rows_valid) {
  if (threadIdx.x < kBQ) {
    const int r = threadIdx.x;
    const bool ok = r < rows_valid;
    lse2[r] = ok ? __fmul_rn(lse[base + q0 + r], kLog2e) : 0.f;
    dlt[r] = ok ? delta[base + q0 + r] : 0.f;
  }
}

// Key mask of keys [k0, k0 + 64) of batch row b: 1 where the key exists
// (k0 + c < L) and the padding mask (null = all valid) keeps it.
__device__ __forceinline__ void load_key_mask(float* kmask, const uint8_t* __restrict__ mask,
                                              int b, int L, int k0, int k_valid) {
  if (threadIdx.x < kBK) {
    const int c = threadIdx.x;
    const bool ok = c < k_valid && (mask == nullptr || mask[(int64_t)b * L + k0 + c] != 0);
    kmask[c] = ok ? 1.f : 0.f;
  }
}

// Rows [0, 16) of this warp's accumulator strip, times `mul`, to global
// rows row0 + r0 + i (< L), two lanes per row.
template <int D>
__device__ __forceinline__ void store_rows(float* __restrict__ dst, const float* acc, int row0,
                                           int r0, int lane, int L, int64_t row_stride,
                                           float mul) {
  const int row = r0 + (lane >> 1);
  if (row0 + row >= L) return;
  const float* ar = acc + row * D;
  float* g = dst + (int64_t)(row0 + row) * row_stride;
  const int d0 = (lane & 1) * (D / 2);
#pragma unroll 8
  for (int d = d0; d < d0 + D / 2; ++d) g[d] = ar[d] * mul;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const uint8_t* __restrict__ mask,
                        const float* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ delta, float* __restrict__ dq, int L, int H,
                        float scale_log2, float scale) {
  using S = SmemDq<D>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  S& sm = *reinterpret_cast<S*>(smem_raw);

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * kRowsPerWarp;
  const int64_t row_stride = (int64_t)H * D;
  const int64_t head_base = (int64_t)b * L * row_stride + (int64_t)h * D;
  const int q_valid = min(kBQ, L - q0);

  load_rows<D>(sm.q, q + head_base, q0, q_valid, row_stride);
  load_rows<D>(sm.dout, dout + head_base, q0, q_valid, row_stride);
  load_row_stats(sm.lse2, sm.delta, lse, delta, ((int64_t)b * H + h) * L, q0, q_valid);
  for (int i = threadIdx.x; i < kBQ * D; i += kThreads) sm.acc[i] = 0.f;

  const int n_tiles = (L + kBK - 1) / kBK;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBK;
    const int k_valid = min(kBK, L - k0);
    __syncthreads();  // the previous K/V tile is consumed
    load_rows<D>(sm.k, k + head_base, k0, k_valid, row_stride);
    load_rows<D>(sm.v, v + head_base, k0, k_valid, row_stride);
    load_key_mask(sm.kmask, mask, b, L, k0, k_valid);
    __syncthreads();
    mma_abt<D>(sm.s, sm.q, sm.k, r0, lane);
    mma_abt<D>(sm.dp, sm.dout, sm.v, r0, lane);
    __syncwarp();
    p_and_ds(sm.s, sm.dp, false, sm.lse2, sm.delta, sm.kmask, q_valid, r0, lane, scale_log2);
    __syncwarp();
    mma_acc_ab<D>(sm.acc, sm.dp, sm.k, r0, lane);
  }
  __syncwarp();
  store_rows<D>(dq + head_base, sm.acc, q0, r0, lane, L, row_stride, scale);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const uint8_t* __restrict__ mask,
                         const float* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, float* __restrict__ dk,
                         float* __restrict__ dv, int L, int H, float scale_log2, float scale) {
  using S = SmemDkv<D>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  S& sm = *reinterpret_cast<S*>(smem_raw);

  const int k0 = blockIdx.x * kBK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * kRowsPerWarp;
  const int64_t row_stride = (int64_t)H * D;
  const int64_t head_base = (int64_t)b * L * row_stride + (int64_t)h * D;
  const int64_t stat_base = ((int64_t)b * H + h) * L;
  const int k_valid = min(kBK, L - k0);

  load_rows<D>(sm.k, k + head_base, k0, k_valid, row_stride);
  load_rows<D>(sm.v, v + head_base, k0, k_valid, row_stride);
  load_key_mask(sm.kmask, mask, b, L, k0, k_valid);
  for (int i = threadIdx.x; i < kBK * D; i += kThreads) {
    sm.dk[i] = 0.f;
    sm.dv[i] = 0.f;
  }

  const int n_tiles = (L + kBQ - 1) / kBQ;
  for (int i = 0; i < n_tiles; ++i) {
    const int q0 = i * kBQ;
    const int q_valid = min(kBQ, L - q0);
    __syncthreads();  // the previous Q/dO tile, P and dS are consumed
    load_rows<D>(sm.q, q + head_base, q0, q_valid, row_stride);
    load_rows<D>(sm.dout, dout + head_base, q0, q_valid, row_stride);
    load_row_stats(sm.lse2, sm.delta, lse, delta, stat_base, q0, q_valid);
    __syncthreads();
    // This warp's 16 q rows against the block's 64 keys.
    mma_abt<D>(sm.s, sm.q, sm.k, r0, lane);
    mma_abt<D>(sm.dp, sm.dout, sm.v, r0, lane);
    __syncwarp();
    p_and_ds(sm.s, sm.dp, true, sm.lse2, sm.delta, sm.kmask, q_valid, r0, lane, scale_log2);
    __syncthreads();  // every q row's P and dS are in place
    // This warp's 16 keys over the tile's 64 q rows.
    mma_acc_atb<D>(sm.dv, sm.s, sm.dout, r0, lane);
    mma_acc_atb<D>(sm.dk, sm.dp, sm.q, r0, lane);
  }
  __syncwarp();
  store_rows<D>(dk + head_base, sm.dk, k0, r0, lane, L, row_stride, scale);
  store_rows<D>(dv + head_base, sm.dv, k0, r0, lane, L, row_stride, 1.f);
}

// ---------------------------------------------------------------------------
// bf16: wgmma, register-resident tiles, cp.async ring
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

// Key mask of keys [k0, k0 + 64) of batch row b into shared memory: 1
// where the key exists and the padding mask (null = all valid) keeps it.
__device__ __forceinline__ void store_key_mask(float* kmask, const uint8_t* __restrict__ mask,
                                               int b, int L, int k0, int tid) {
  if (tid < kBK) {
    const int key = k0 + tid;
    const bool ok = key < L && (mask == nullptr || mask[(int64_t)b * L + key] != 0);
    kmask[tid] = ok ? 1.f : 0.f;
  }
}

// Shared-memory map of the bf16 dQ block (byte offsets from a 1024-byte
// aligned base).
template <int D>
struct DqSmem {
  using T = sm90::Tile<D>;
  static constexpr int kTile = T::template bytes<64>();
  static constexpr int kQ = 0;
  static constexpr int kDO = kQ + kTile;
  static constexpr int kK = kDO + kTile;            // 2 stages
  static constexpr int kV = kK + 2 * kTile;         // 2 stages
  static constexpr int kMask = kV + 2 * kTile;      // 2 x 64 floats
  static constexpr int kBar = kMask + 2 * kBK * 4;  // 2 mbarriers
  static constexpr int kBytes = kBar + 2 * 8;
  static constexpr int kAlloc = kBytes + 1024;      // room to align the base
};

template <int D>
__global__ void __launch_bounds__(128, D == 128 ? 2 : 3)
    flash_bwd_dq_sm90(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                      const bf16* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dq, int L, int H,
                      float scale_log2, float scale) {
  using S = DqSmem<D>;
  using T = sm90::Tile<D>;
  constexpr int kNT = 128;
  constexpr int kN = T::kAtomCols / 2;  // dQ accumulator floats per atom
  extern __shared__ __align__(1024) unsigned char smem_dq[];
  const uint32_t raw = sm90::smem_u32(smem_dq);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_dq + (base - raw);
  float* kmask = reinterpret_cast<float*>(smem + S::kMask);
  const uint32_t bar = base + S::kBar;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int wrow = tid / 32 * 16;  // the warp's first row
  const int q0 = blockIdx.x * 64;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int64_t row_stride = (int64_t)H * D;
  const int64_t head_base = (int64_t)b * L * row_stride + (int64_t)h * D;
  const int64_t stat_base = ((int64_t)b * H + h) * L;
  const uint32_t q_tile = base + S::kQ;
  const uint32_t do_tile = base + S::kDO;

  if (tid == 0) {
    sm90::mbar_init(bar, kNT);
    sm90::mbar_init(bar + 8, kNT);
    sm90::mbar_init_fence();
  }
  __syncthreads();

  // Prologue: Q, dO, the first K/V tile and mask.
  sm90::copy_tile<D, 64, kNT>(q_tile, q + head_base, q0, L, row_stride, tid);
  sm90::copy_tile<D, 64, kNT>(do_tile, dout + head_base, q0, L, row_stride, tid);
  sm90::copy_tile<D, 64, kNT>(base + S::kK, k + head_base, 0, L, row_stride, tid);
  sm90::copy_tile<D, 64, kNT>(base + S::kV, v + head_base, 0, L, row_stride, tid);
  store_key_mask(kmask, mask, b, L, 0, tid);
  sm90::cp_async_commit();

  // lse * log2 e and delta of this thread's rows wrow + lane/4 (+ 8); 0
  // past L.
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wrow + lane / 4 + 8 * r;
    const bool ok = row < L;
    lse2[r] = ok ? __fmul_rn(lse[stat_base + row], kLog2e) : 0.f;
    dlt[r] = ok ? delta[stat_base + row] : 0.f;
  }
  const float neg_scaled = __fmul_rn(kNeg, kLog2e);

  float acc[T::kAtoms][kN];
#pragma unroll
  for (int a = 0; a < T::kAtoms; ++a) {
#pragma unroll
    for (int i = 0; i < kN; ++i) acc[a][i] = 0.f;
  }

  const int n_tiles = (L + kBK - 1) / kBK;
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    // Tile j is in place once every thread's copies of it have landed.
    sm90::cp_async_wait_all();
    sm90::fence_proxy_async();
    sm90::mbar_arrive(bar + 8 * st);
    sm90::mbar_wait(bar + 8 * st, (j >> 1) & 1);
    if (j + 1 < n_tiles) {  // the other stage was freed by the arrivals above
      const int k1 = (j + 1) * kBK;
      sm90::copy_tile<D, 64, kNT>(base + S::kK + (st ^ 1) * S::kTile, k + head_base, k1, L,
                                  row_stride, tid);
      sm90::copy_tile<D, 64, kNT>(base + S::kV + (st ^ 1) * S::kTile, v + head_base, k1, L,
                                  row_stride, tid);
      store_key_mask(kmask + (st ^ 1) * kBK, mask, b, L, k1, tid);
      sm90::cp_async_commit();
    }
    const uint32_t k_tile = base + S::kK + st * S::kTile;
    const uint32_t v_tile = base + S::kV + st * S::kTile;
    const float* km = kmask + st * kBK;

    // S = Q K^T and dP = dO V^T for the block's 64 rows.
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = 0.f;
      dp[i] = 0.f;
    }
    __syncwarp();
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      sm90::wgmma_ss(s, T::template desc_k<64>(q_tile, kk), T::template desc_k<64>(k_tile, kk),
                     1);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      sm90::wgmma_ss(dp, T::template desc_k<64>(do_tile, kk),
                     T::template desc_k<64>(v_tile, kk), 1);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(s);
    sm90::fence_regs(dp);

    // P and dS in registers: element i sits in row (i / 2) % 2 of this
    // thread's two and in column acc_col(lane, i) of the tile.
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i / 2) % 2;
      const float m = km[sm90::acc_col(lane, i)];
      const float sv = m != 0.f ? __fmul_rn(s[i], scale_log2) : neg_scaled;
      const float p = exp2f(__fsub_rn(sv, lse2[r])) * m;
      dp[i] = p * (dp[i] - dlt[r]);
    }
    uint32_t dsa[4][4];
    sm90::to_a_operand(dp, dsa);

    // dQ += dS K, dS (bf16) from registers, K MN-major from the stage.
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
      for (int a = 0; a < T::kAtoms; ++a) {
        sm90::wgmma_rs(acc[a], dsa[kk], T::template desc_mn<64>(k_tile, a, kk));
      }
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
#pragma unroll
    for (int a = 0; a < T::kAtoms; ++a) sm90::fence_regs(acc[a]);
    sm90::fence_regs(dsa);
  }

  // Epilogue: dQ * scale to bf16, staged in the Q tile.
  unsigned char* stage = smem + S::kQ;
  __syncthreads();  // every warp's last product has read Q
#pragma unroll
  for (int a = 0; a < T::kAtoms; ++a) {
#pragma unroll
    for (int i = 0; i < kN; i += 2) {
      const int r = wrow + sm90::acc_row(lane, i);
      const int c = a * T::kAtomCols + sm90::acc_col(lane, i);
      *reinterpret_cast<__nv_bfloat162*>(stage + T::template offset<64>(r, c)) =
          __floats2bfloat162_rn(acc[a][i] * scale, acc[a][i + 1] * scale);
    }
  }
  __syncthreads();
  constexpr int kPerRow = D / 8;
  for (int i = tid; i < 64 * kPerRow; i += 128) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * 8;
    const int row = q0 + r;
    if (row < L) {
      *reinterpret_cast<uint4*>(dq + head_base + (int64_t)row * row_stride + c) =
          *reinterpret_cast<const uint4*>(stage + T::template offset<64>(r, c));
    }
  }
}

// Shared-memory map of the bf16 dK/dV block (byte offsets from a 1024-byte
// aligned base).
template <int D>
struct DkvSmem {
  using T = sm90::Tile<D>;
  static constexpr int kBQ = D == 128 ? 32 : 64;       // q rows per ring stage
  static constexpr int kKV = T::template bytes<64>();
  static constexpr int kQT = T::template bytes<kBQ>();
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKV;
  static constexpr int kQ = kV + kKV;                   // 2 stages
  static constexpr int kDO = kQ + 2 * kQT;              // 2 stages
  static constexpr int kStats = kDO + 2 * kQT;          // 2 stages x (lse, delta) x kBQ floats
  static constexpr int kBar = kStats + 2 * 2 * kBQ * 4; // 2 mbarriers
  static constexpr int kBytes = kBar + 2 * 8;
  static constexpr int kAlloc = kBytes + 1024;          // room to align the base
};

// Ring stage `st` of the dK/dV block: Q and dO rows [q0, q0 + BQ) and their
// lse and delta (zero past L).
template <int D>
__device__ __forceinline__ void copy_q_stage(uint32_t base, int st, const bf16* __restrict__ q,
                                             const bf16* __restrict__ dout,
                                             const float* __restrict__ lse,
                                             const float* __restrict__ delta, int q0, int L,
                                             int64_t row_stride, int tid) {
  using S = DkvSmem<D>;
  sm90::copy_tile<D, S::kBQ, 128>(base + S::kQ + st * S::kQT, q, q0, L, row_stride, tid);
  sm90::copy_tile<D, S::kBQ, 128>(base + S::kDO + st * S::kQT, dout, q0, L, row_stride, tid);
  if (tid < 2 * S::kBQ) {
    const int row = q0 + tid % S::kBQ;
    const bool ok = row < L;
    const float* src = (tid < S::kBQ ? lse : delta) + (ok ? row : 0);
    sm90::cp_async4(base + S::kStats + (st * 2 * S::kBQ + tid) * 4, src, ok ? 4 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(128, D == 128 ? 2 : 3)
    flash_bwd_dkv_sm90(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                       const bf16* __restrict__ dout, const float* __restrict__ lse,
                       const float* __restrict__ delta, bf16* __restrict__ dk,
                       bf16* __restrict__ dv, int L, int H, float scale_log2, float scale) {
  using S = DkvSmem<D>;
  using T = sm90::Tile<D>;
  constexpr int kBQ2 = S::kBQ;
  constexpr int kN = T::kAtomCols / 2;  // dK/dV accumulator floats per atom
  extern __shared__ __align__(1024) unsigned char smem_sm90[];
  unsigned char* smem_raw = smem_sm90;
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const float* stats = reinterpret_cast<const float*>(smem + S::kStats);
  const uint32_t bar = base + S::kBar;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int wrow = tid / 32 * 16;  // the warp's first key row
  const int k0 = blockIdx.x * kBK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int64_t row_stride = (int64_t)H * D;
  const int64_t head_base = (int64_t)b * L * row_stride + (int64_t)h * D;
  const int64_t stat_base = ((int64_t)b * H + h) * L;

  if (tid == 0) {
    sm90::mbar_init(bar, 128);
    sm90::mbar_init(bar + 8, 128);
    sm90::mbar_init_fence();
  }
  __syncthreads();

  // Prologue: K and V once, and the first Q/dO stage.
  sm90::copy_tile<D, 64, 128>(base + S::kK, k + head_base, k0, L, row_stride, tid);
  sm90::copy_tile<D, 64, 128>(base + S::kV, v + head_base, k0, L, row_stride, tid);
  copy_q_stage<D>(base, 0, q + head_base, dout + head_base, lse + stat_base, delta + stat_base,
                  0, L, row_stride, tid);
  sm90::cp_async_commit();

  // This thread's key rows: wrow + lane/4 and 8 below it.
  float km[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + wrow + lane / 4 + 8 * r;
    km[r] = key < L && (mask == nullptr || mask[(int64_t)b * L + key] != 0) ? 1.f : 0.f;
  }
  const float neg_scaled = __fmul_rn(kNeg, kLog2e);

  float dk_acc[T::kAtoms][kN], dv_acc[T::kAtoms][kN];
#pragma unroll
  for (int a = 0; a < T::kAtoms; ++a) {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      dk_acc[a][i] = 0.f;
      dv_acc[a][i] = 0.f;
    }
  }

  const uint32_t k_tile = base + S::kK;
  const uint32_t v_tile = base + S::kV;
  const int n_tiles = (L + kBQ2 - 1) / kBQ2;
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i & 1;
    // Stage i is in place once every thread's copies of it have landed.
    sm90::cp_async_wait_all();
    sm90::fence_proxy_async();
    sm90::mbar_arrive(bar + 8 * st);
    sm90::mbar_wait(bar + 8 * st, (i >> 1) & 1);
    if (i + 1 < n_tiles) {  // the other stage was freed by the arrivals above
      copy_q_stage<D>(base, st ^ 1, q + head_base, dout + head_base, lse + stat_base,
                      delta + stat_base, (i + 1) * kBQ2, L, row_stride, tid);
      sm90::cp_async_commit();
    }
    const uint32_t q_tile = base + S::kQ + st * S::kQT;
    const uint32_t do_tile = base + S::kDO + st * S::kQT;
    const float* lse_s = stats + st * 2 * kBQ2;
    const float* delta_s = lse_s + kBQ2;

    // S^T = K Q^T and dP^T = V dO^T: the block's 64 keys by the stage's q rows.
    float s[kBQ2 / 2], dp[kBQ2 / 2];
#pragma unroll
    for (int j = 0; j < kBQ2 / 2; ++j) {
      s[j] = 0.f;
      dp[j] = 0.f;
    }
    __syncwarp();
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      sm90::wgmma_ss(s, T::template desc_k<64>(k_tile, kk),
                     T::template desc_k<kBQ2>(q_tile, kk), 1);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      sm90::wgmma_ss(dp, T::template desc_k<64>(v_tile, kk),
                     T::template desc_k<kBQ2>(do_tile, kk), 1);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(s);
    sm90::fence_regs(dp);

    // P^T and dS^T in registers; rows are keys, columns q rows.
    const int q0 = i * kBQ2;
#pragma unroll
    for (int j = 0; j < kBQ2 / 2; ++j) {
      const int c = sm90::acc_col(lane, j);
      const float m = km[(j / 2) % 2];
      const float l2 = __fmul_rn(lse_s[c], kLog2e);
      const float sv = m != 0.f ? __fmul_rn(s[j], scale_log2) : neg_scaled;
      const float p = q0 + c < L ? exp2f(__fsub_rn(sv, l2)) * m : 0.f;
      dp[j] = p * (dp[j] - delta_s[c]);
      s[j] = p;
    }
    uint32_t pa[kBQ2 / 16][4], dsa[kBQ2 / 16][4];
    sm90::to_a_operand(s, pa);
    sm90::to_a_operand(dp, dsa);

    // dV += P^T dO and dK += dS^T Q, the B operands MN-major from the stage.
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBQ2 / 16; ++kk) {
#pragma unroll
      for (int a = 0; a < T::kAtoms; ++a) {
        sm90::wgmma_rs(dv_acc[a], pa[kk], T::template desc_mn<kBQ2>(do_tile, a, kk));
      }
    }
#pragma unroll
    for (int kk = 0; kk < kBQ2 / 16; ++kk) {
#pragma unroll
      for (int a = 0; a < T::kAtoms; ++a) {
        sm90::wgmma_rs(dk_acc[a], dsa[kk], T::template desc_mn<kBQ2>(q_tile, a, kk));
      }
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
#pragma unroll
    for (int a = 0; a < T::kAtoms; ++a) {
      sm90::fence_regs(dk_acc[a]);
      sm90::fence_regs(dv_acc[a]);
    }
    sm90::fence_regs(pa);
    sm90::fence_regs(dsa);
  }

  // Epilogue: dK * scale and dV to bf16, staged in K's and V's tiles.
  __syncthreads();  // every warp's last product has read K and V
#pragma unroll
  for (int a = 0; a < T::kAtoms; ++a) {
#pragma unroll
    for (int j = 0; j < kN; j += 2) {
      const int r = wrow + sm90::acc_row(lane, j);
      const uint32_t off = T::template offset<64>(r, a * T::kAtomCols + sm90::acc_col(lane, j));
      *reinterpret_cast<__nv_bfloat162*>(smem + S::kK + off) =
          __floats2bfloat162_rn(dk_acc[a][j] * scale, dk_acc[a][j + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(smem + S::kV + off) =
          __floats2bfloat162_rn(dv_acc[a][j], dv_acc[a][j + 1]);
    }
  }
  __syncthreads();
  constexpr int kPerRow = D / 8;
  for (int idx = tid; idx < 64 * kPerRow; idx += 128) {
    const int r = idx / kPerRow;
    const int c = (idx % kPerRow) * 8;
    const int row = k0 + r;
    if (row < L) {
      const uint32_t off = T::template offset<64>(r, c);
      const int64_t g = head_base + (int64_t)row * row_stride + c;
      *reinterpret_cast<uint4*>(dk + g) = *reinterpret_cast<const uint4*>(smem + S::kK + off);
      *reinterpret_cast<uint4*>(dv + g) = *reinterpret_cast<const uint4*>(smem + S::kV + off);
    }
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* mask;
  const void* dout;
  const void* lse;
  const void* delta;
  void* out0;  // dq, or dk
  void* out1;  // dv (dK/dV kernel only)
  int B, L, H;
  float scale_log2, scale;
  cudaStream_t stream;
};

template <int D>
cudaError_t set_smem_dq_sm90() {
  return cudaFuncSetAttribute(flash_bwd_dq_sm90<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              DqSmem<D>::kAlloc);
}

template <int D>
cudaError_t launch_dq_sm90(const Args& a) {
  cudaError_t err = set_smem_dq_sm90<D>();
  if (err != cudaSuccess) return err;
  const dim3 grid((a.L + 63) / 64, a.H, a.B);
  flash_bwd_dq_sm90<D><<<grid, 128, DqSmem<D>::kAlloc, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const uint8_t*>(a.mask), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<bf16*>(a.out0), a.L, a.H, a.scale_log2, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(int is_f32, const Args& a) {
  if (is_f32) {
    constexpr int smem = (int)sizeof(SmemDq<D>);
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.L + kBQ - 1) / kBQ, a.H, a.B);
    flash_bwd_dq_kernel<D><<<grid, kThreads, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const uint8_t*>(a.mask),
        static_cast<const float*>(a.dout), static_cast<const float*>(a.lse),
        static_cast<const float*>(a.delta), static_cast<float*>(a.out0), a.L, a.H,
        a.scale_log2, a.scale);
    return cudaGetLastError();
  }
  return launch_dq_sm90<D>(a);
}

template <int D>
cudaError_t set_smem_dkv_sm90() {
  return cudaFuncSetAttribute(flash_bwd_dkv_sm90<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              DkvSmem<D>::kAlloc);
}

template <int D>
cudaError_t launch_dkv(int is_f32, const Args& a) {
  const dim3 grid((a.L + kBK - 1) / kBK, a.H, a.B);
  if (!is_f32) {
    cudaError_t err = set_smem_dkv_sm90<D>();
    if (err != cudaSuccess) return err;
    flash_bwd_dkv_sm90<D><<<grid, 128, DkvSmem<D>::kAlloc, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const uint8_t*>(a.mask),
        static_cast<const bf16*>(a.dout), static_cast<const float*>(a.lse),
        static_cast<const float*>(a.delta), static_cast<bf16*>(a.out0),
        static_cast<bf16*>(a.out1), a.L, a.H, a.scale_log2, a.scale);
  } else {
    constexpr int smem = (int)sizeof(SmemDkv<D>);
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    flash_bwd_dkv_kernel<D><<<grid, kThreads, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const uint8_t*>(a.mask),
        static_cast<const float*>(a.dout), static_cast<const float*>(a.lse),
        static_cast<const float*>(a.delta), static_cast<float*>(a.out0),
        static_cast<float*>(a.out1), a.L, a.H, a.scale_log2, a.scale);
  }
  return cudaGetLastError();
}

template <bool kDq>
int dispatch(const void* q, const void* k, const void* v, const void* mask, const void* dout,
             const void* lse, const void* delta, void* out0, void* out1, int B, int L, int H,
             int D, int is_f32, float scale_log2, float scale, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, mask, dout, lse, delta, out0, out1, B, L, H, scale_log2, scale,
               static_cast<cudaStream_t>(stream)};
  switch (D) {
    case 32: return (int)(kDq ? launch_dq<32>(is_f32, a) : launch_dkv<32>(is_f32, a));
    case 64: return (int)(kDq ? launch_dq<64>(is_f32, a) : launch_dkv<64>(is_f32, a));
    case 128: return (int)(kDq ? launch_dq<128>(is_f32, a) : launch_dkv<128>(is_f32, a));
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, dout, dq/dk/dv: contiguous [B, L, H, D] of one dtype (fp32 when
// is_f32, else bf16); mask: contiguous uint8/bool [B, L] (nullptr = every
// key valid); lse, delta: contiguous [B, H, L] f32. Each returns the
// launch's cudaError_t (0 = launched).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* mask,
                            const void* dout, const void* lse, const void* delta, void* dq,
                            int B, int L, int H, int D, int is_f32, float scale_log2,
                            float scale, void* stream) {
  return dispatch<true>(q, k, v, mask, dout, lse, delta, dq, nullptr, B, L, H, D, is_f32,
                        scale_log2, scale, stream);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* mask,
                             const void* dout, const void* lse, const void* delta, void* dk,
                             void* dv, int B, int L, int H, int D, int is_f32,
                             float scale_log2, float scale, void* stream) {
  return dispatch<false>(q, k, v, mask, dout, lse, delta, dk, dv, B, L, H, D, is_f32,
                         scale_log2, scale, stream);
}

// Dynamic shared memory and resident blocks per SM of the bf16 kernels at
// D = 64: kernel 0 is dQ, 1 dK/dV. Returns a cudaError_t.
extern "C" int flash_bwd_occupancy(int kernel, int* smem_bytes, int* blocks_per_sm) {
  cudaError_t err;
  if (kernel == 0) {
    *smem_bytes = DqSmem<64>::kAlloc;
    err = set_smem_dq_sm90<64>();
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, flash_bwd_dq_sm90<64>,
                                                          128, *smem_bytes);
    }
  } else if (kernel == 1) {
    *smem_bytes = DkvSmem<64>::kAlloc;
    err = set_smem_dkv_sm90<64>();
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, flash_bwd_dkv_sm90<64>,
                                                          128, *smem_bytes);
    }
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

extern "C" const char* flash_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
