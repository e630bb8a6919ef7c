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
// dQ (`flash_bwd_dq_kernel`, both dtypes) and dK/dV in fp32
// (`flash_bwd_dkv_kernel`): one block of 4 warps per 64-row tile, the
// current tiles, the f32 S and dP tiles, P and dS and the f32 accumulators
// in dynamic shared memory (bf16 dQ at D = 64: 97 KB; up to 225 KB for fp32
// dK/dV at D = 128), bf16 products through WMMA 16x16x16, fp32 on FMA.
// Resident blocks per SM of both bf16 kernels are read at run time by
// flash_bwd_occupancy (printed by chip_smoke.py).
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
// backward of dK and dV alone 0.383 ms).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "sm90_flash.cuh"

namespace {

using namespace nvcuda;

constexpr int kBQ = 64;  // query rows per tile
constexpr int kBK = 64;  // keys per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 16;  // one WMMA row strip
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
struct Pads {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  // bf16 rows carry a 16-byte pad against bank conflicts; with it every
  // member size stays a multiple of 32 bytes and every WMMA pointer is
  // 256-bit aligned. The fp32 FMA path drops the pads so that the D = 128
  // dK/dV tiles fit in the 227 KB a block may use.
  static constexpr int kT = kF32 ? 0 : 8;  // elements of T
  static constexpr int kF = kF32 ? 0 : 4;  // floats
};

// dQ block: Q and dO tiles, the current K/V tile, S, dP, dS, the dQ sum.
template <typename T, int D>
struct SmemDq {
  using P = Pads<T>;
  static constexpr int kLdT = D + P::kT;    // q, do, k, v rows (T)
  static constexpr int kLdS = kBK + P::kF;  // s, dp rows (floats)
  static constexpr int kLdP = kBK + P::kT;  // ds rows (T); fp32 aliases dp
  static constexpr int kLdA = D + P::kF;    // accumulator rows (floats)
  T q[kBQ * kLdT];
  T dout[kBQ * kLdT];
  T k[kBK * kLdT];
  T v[kBK * kLdT];
  float s[kBQ * kLdS];
  float dp[kBQ * kLdS];
  T ds_store[P::kF32 ? 32 / sizeof(T) : kBQ * kLdP];
  float acc[kBQ * kLdA];
  float lse2[kBQ];   // lse * log2 e per q row
  float delta[kBQ];
  float kmask[kBK];
  __device__ T* ds() {
    if constexpr (P::kF32) return reinterpret_cast<T*>(dp); else return ds_store;
  }
};

// dK/dV block of the fp32 kernel: the resident K/V tile, the current Q/dO
// tile, S, dP, P, dS and both sums.
template <typename T, int D>
struct SmemDkv {
  using P = Pads<T>;
  static constexpr int kLdT = D + P::kT;
  static constexpr int kLdS = kBK + P::kF;
  static constexpr int kLdP = kBK + P::kT;  // p, ds rows (T); fp32 aliases s, dp
  static constexpr int kLdA = D + P::kF;
  T k[kBK * kLdT];
  T v[kBK * kLdT];
  T q[kBQ * kLdT];
  T dout[kBQ * kLdT];
  float s[kBQ * kLdS];
  float dp[kBQ * kLdS];
  T p_store[P::kF32 ? 32 / sizeof(T) : kBQ * kLdP];
  T ds_store[P::kF32 ? 32 / sizeof(T) : kBQ * kLdP];
  float dk[kBK * kLdA];
  float dv[kBK * kLdA];
  float lse2[kBQ];
  float delta[kBQ];
  float kmask[kBK];
  __device__ T* p() {
    if constexpr (P::kF32) return reinterpret_cast<T*>(s); else return p_store;
  }
  __device__ T* ds() {
    if constexpr (P::kF32) return reinterpret_cast<T*>(dp); else return ds_store;
  }
};

__device__ __forceinline__ float to_float(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Copy rows [row0, row0 + 64) of one head into shared memory (row stride
// LD) in 16-byte vectors, zero-filling rows at or past `rows_valid`.
template <typename T, int D, int LD>
__device__ __forceinline__ void load_rows(T* dst, const T* __restrict__ src, int row0,
                                          int rows_valid, int64_t row_stride) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = D / kVec;
  for (int i = threadIdx.x; i < 64 * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows_valid) {
      val = *reinterpret_cast<const uint4*>(src + (int64_t)(row0 + r) * row_stride + c);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// out[r0:r0+16, 0:64] = A[r0:r0+16, 0:D] . B[0:64, 0:D]^T, in f32.
template <typename T, int D>
__device__ __forceinline__ void mma_abt(float* out, int ldo, const T* a, int lda, const T* b,
                                        int ldb, int r0, int lane) {
  if constexpr (!Pads<T>::kF32) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[D / 16];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::load_matrix_sync(fa[kk], a + r0 * lda + kk * 16, lda);
    }
#pragma unroll
    for (int n = 0; n < 64 / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::fill_fragment(c, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        // B^T as a column-major operand: element (d, j) sits at b[j][d].
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
        wmma::load_matrix_sync(fb, b + (n * 16) * ldb + kk * 16, ldb);
        wmma::mma_sync(c, fa[kk], fb, c);
      }
      wmma::store_matrix_sync(out + r0 * ldo + n * 16, c, ldo, wmma::mem_row_major);
    }
  } else {
    for (int idx = lane; idx < kRowsPerWarp * 64; idx += 32) {
      const int r = r0 + idx / 64;
      const int c = idx % 64;
      const T* ar = a + r * lda;
      const T* br = b + c * ldb;
      float acc = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) acc = fmaf(to_float(ar[d]), to_float(br[d]), acc);
      out[r * ldo + c] = acc;
    }
  }
}

// acc[r0:r0+16, 0:D] += A[r0:r0+16, 0:64] . B[0:64, 0:D].
template <typename T, int D>
__device__ __forceinline__ void mma_acc_ab(float* acc, int ldacc, const T* a, int lda,
                                           const T* b, int ldb, int r0, int lane) {
  if constexpr (!Pads<T>::kF32) {
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::load_matrix_sync(c, acc + r0 * ldacc + n * 16, ldacc, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < 64 / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, a + r0 * lda + kk * 16, lda);
        wmma::load_matrix_sync(fb, b + (kk * 16) * ldb + n * 16, ldb);
        wmma::mma_sync(c, fa, fb, c);
      }
      wmma::store_matrix_sync(acc + r0 * ldacc + n * 16, c, ldacc, wmma::mem_row_major);
    }
  } else {
    for (int idx = lane; idx < kRowsPerWarp * D; idx += 32) {
      const int r = r0 + idx / D;
      const int d = idx % D;
      float sum = acc[r * ldacc + d];
#pragma unroll 8
      for (int c = 0; c < 64; ++c) sum = fmaf(to_float(a[r * lda + c]), to_float(b[c * ldb + d]), sum);
      acc[r * ldacc + d] = sum;
    }
  }
}

// acc[r0:r0+16, 0:D] += A[0:64, r0:r0+16]^T . B[0:64, 0:D] (the fp32 dK/dV
// kernel's products).
template <typename T, int D>
__device__ __forceinline__ void mma_acc_atb(float* acc, int ldacc, const T* a, int lda,
                                            const T* b, int ldb, int r0, int lane) {
  for (int idx = lane; idx < kRowsPerWarp * D; idx += 32) {
    const int r = r0 + idx / D;
    const int d = idx % D;
    float sum = acc[r * ldacc + d];
#pragma unroll 8
    for (int c = 0; c < 64; ++c) sum = fmaf(to_float(a[c * lda + r]), to_float(b[c * ldb + d]), sum);
    acc[r * ldacc + d] = sum;
  }
}

// P and dS for this warp's 16 q rows from the f32 S and dP tiles, two lanes
// per row, 32 keys each. `p_out` may be null (the dQ kernel needs only dS);
// in the fp32 path p_out/ds_out alias s/dp and are written in place.
template <typename T>
__device__ __forceinline__ void p_and_ds(const float* s, const float* dp, int lds, T* p_out,
                                         T* ds_out, int ldp, const float* lse2,
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
    const float sv = km != 0.f ? __fmul_rn(s[row * lds + c], scale_log2) : neg_scaled;
    const float p = valid ? exp2f(__fsub_rn(sv, l2)) * km : 0.f;
    const float ds = p * (dp[row * lds + c] - dl);
    if (p_out != nullptr) p_out[row * ldp + c] = from_float<T>(p);
    ds_out[row * ldp + c] = from_float<T>(ds);
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
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* __restrict__ dst, const float* acc, int ldacc,
                                           int row0, int r0, int lane, int L,
                                           int64_t row_stride, float mul) {
  const int row = r0 + (lane >> 1);
  if (row0 + row >= L) return;
  const float* ar = acc + row * ldacc;
  T* g = dst + (int64_t)(row0 + row) * row_stride;
  const int d0 = (lane & 1) * (D / 2);
#pragma unroll 8
  for (int d = d0; d < d0 + D / 2; ++d) g[d] = from_float<T>(ar[d] * mul);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const uint8_t* __restrict__ mask,
                        const T* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq, int L, int H,
                        float scale_log2, float scale) {
  using S = SmemDq<T, D>;
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

  load_rows<T, D, S::kLdT>(sm.q, q + head_base, q0, q_valid, row_stride);
  load_rows<T, D, S::kLdT>(sm.dout, dout + head_base, q0, q_valid, row_stride);
  load_row_stats(sm.lse2, sm.delta, lse, delta, ((int64_t)b * H + h) * L, q0, q_valid);
  for (int i = threadIdx.x; i < kBQ * D; i += kThreads) sm.acc[(i / D) * S::kLdA + i % D] = 0.f;

  const int n_tiles = (L + kBK - 1) / kBK;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBK;
    const int k_valid = min(kBK, L - k0);
    __syncthreads();  // the previous K/V tile is consumed
    load_rows<T, D, S::kLdT>(sm.k, k + head_base, k0, k_valid, row_stride);
    load_rows<T, D, S::kLdT>(sm.v, v + head_base, k0, k_valid, row_stride);
    load_key_mask(sm.kmask, mask, b, L, k0, k_valid);
    __syncthreads();
    mma_abt<T, D>(sm.s, S::kLdS, sm.q, S::kLdT, sm.k, S::kLdT, r0, lane);
    mma_abt<T, D>(sm.dp, S::kLdS, sm.dout, S::kLdT, sm.v, S::kLdT, r0, lane);
    __syncwarp();
    p_and_ds<T>(sm.s, sm.dp, S::kLdS, nullptr, sm.ds(), S::kLdP, sm.lse2, sm.delta, sm.kmask,
                q_valid, r0, lane, scale_log2);
    __syncwarp();
    mma_acc_ab<T, D>(sm.acc, S::kLdA, sm.ds(), S::kLdP, sm.k, S::kLdT, r0, lane);
  }
  __syncwarp();
  store_rows<T, D>(dq + head_base, sm.acc, S::kLdA, q0, r0, lane, L, row_stride, scale);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const uint8_t* __restrict__ mask,
                         const T* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int L, int H, float scale_log2, float scale) {
  using S = SmemDkv<T, D>;
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

  load_rows<T, D, S::kLdT>(sm.k, k + head_base, k0, k_valid, row_stride);
  load_rows<T, D, S::kLdT>(sm.v, v + head_base, k0, k_valid, row_stride);
  load_key_mask(sm.kmask, mask, b, L, k0, k_valid);
  for (int i = threadIdx.x; i < kBK * D; i += kThreads) {
    sm.dk[(i / D) * S::kLdA + i % D] = 0.f;
    sm.dv[(i / D) * S::kLdA + i % D] = 0.f;
  }

  const int n_tiles = (L + kBQ - 1) / kBQ;
  for (int i = 0; i < n_tiles; ++i) {
    const int q0 = i * kBQ;
    const int q_valid = min(kBQ, L - q0);
    __syncthreads();  // the previous Q/dO tile, P and dS are consumed
    load_rows<T, D, S::kLdT>(sm.q, q + head_base, q0, q_valid, row_stride);
    load_rows<T, D, S::kLdT>(sm.dout, dout + head_base, q0, q_valid, row_stride);
    load_row_stats(sm.lse2, sm.delta, lse, delta, stat_base, q0, q_valid);
    __syncthreads();
    // This warp's 16 q rows against the block's 64 keys.
    mma_abt<T, D>(sm.s, S::kLdS, sm.q, S::kLdT, sm.k, S::kLdT, r0, lane);
    mma_abt<T, D>(sm.dp, S::kLdS, sm.dout, S::kLdT, sm.v, S::kLdT, r0, lane);
    __syncwarp();
    p_and_ds<T>(sm.s, sm.dp, S::kLdS, sm.p(), sm.ds(), S::kLdP, sm.lse2, sm.delta, sm.kmask,
                q_valid, r0, lane, scale_log2);
    __syncthreads();  // every q row's P and dS are in place
    // This warp's 16 keys over the tile's 64 q rows.
    mma_acc_atb<T, D>(sm.dv, S::kLdA, sm.p(), S::kLdP, sm.dout, S::kLdT, r0, lane);
    mma_acc_atb<T, D>(sm.dk, S::kLdA, sm.ds(), S::kLdP, sm.q, S::kLdT, r0, lane);
  }
  __syncwarp();
  store_rows<T, D>(dk + head_base, sm.dk, S::kLdA, k0, r0, lane, L, row_stride, scale);
  store_rows<T, D>(dv + head_base, sm.dv, S::kLdA, k0, r0, lane, L, row_stride, 1.f);
}

// ---------------------------------------------------------------------------
// dK/dV, bf16: wgmma, register-resident P^T/dS^T/dK/dV, cp.async ring
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

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

template <typename T, int D>
cudaError_t launch_dq(const Args& a) {
  constexpr int smem = (int)sizeof(SmemDq<T, D>);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.L + kBQ - 1) / kBQ, a.H, a.B);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const uint8_t*>(a.mask), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.out0), a.L, a.H, a.scale_log2, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t set_smem_dkv_sm90() {
  return cudaFuncSetAttribute(flash_bwd_dkv_sm90<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              DkvSmem<D>::kAlloc);
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a) {
  const dim3 grid((a.L + kBK - 1) / kBK, a.H, a.B);
  if constexpr (std::is_same<T, bf16>::value) {
    cudaError_t err = set_smem_dkv_sm90<D>();
    if (err != cudaSuccess) return err;
    flash_bwd_dkv_sm90<D><<<grid, 128, DkvSmem<D>::kAlloc, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const uint8_t*>(a.mask),
        static_cast<const bf16*>(a.dout), static_cast<const float*>(a.lse),
        static_cast<const float*>(a.delta), static_cast<bf16*>(a.out0),
        static_cast<bf16*>(a.out1), a.L, a.H, a.scale_log2, a.scale);
  } else {
    constexpr int smem = (int)sizeof(SmemDkv<T, D>);
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const uint8_t*>(a.mask), static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.L, a.H, a.scale_log2, a.scale);
  }
  return cudaGetLastError();
}

template <bool kDq, typename T>
cudaError_t dispatch_d(int D, const Args& a) {
  switch (D) {
    case 32: return kDq ? launch_dq<T, 32>(a) : launch_dkv<T, 32>(a);
    case 64: return kDq ? launch_dq<T, 64>(a) : launch_dkv<T, 64>(a);
    case 128: return kDq ? launch_dq<T, 128>(a) : launch_dkv<T, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kDq>
int dispatch(const void* q, const void* k, const void* v, const void* mask, const void* dout,
             const void* lse, const void* delta, void* out0, void* out1, int B, int L, int H,
             int D, int is_f32, float scale_log2, float scale, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, mask, dout, lse, delta, out0, out1, B, L, H, scale_log2, scale,
               static_cast<cudaStream_t>(stream)};
  return (int)(is_f32 ? dispatch_d<kDq, float>(D, a) : dispatch_d<kDq, __nv_bfloat16>(D, a));
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
// D = 64: kernel 0 is dQ, 1 is dK/dV. Returns a cudaError_t.
extern "C" int flash_bwd_occupancy(int kernel, int* smem_bytes, int* blocks_per_sm) {
  cudaError_t err;
  if (kernel == 0) {
    *smem_bytes = (int)sizeof(SmemDq<bf16, 64>);
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel<bf16, 64>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, *smem_bytes);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks_per_sm, flash_bwd_dq_kernel<bf16, 64>, kThreads, *smem_bytes);
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
