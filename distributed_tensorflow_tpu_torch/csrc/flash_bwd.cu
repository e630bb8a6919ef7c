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
// Design: the TPU's two-kernel split. `flash_bwd_dq_kernel` runs one block
// of 4 warps per (64-row q tile, head, batch) and loops over 64-key K/V
// tiles; `flash_bwd_dkv_kernel` runs one block per (64-key tile, head,
// batch) and loops over 64-row q tiles. Each block writes only its own
// tile, so no atomics are needed, and the loop inside the block replaces
// the TPU's sequential grid. The current tiles, the f32 S and dP tiles, P
// and dS in the input dtype and the f32 accumulators live in dynamic shared
// memory (bf16 at D = 64: 97 KB for dq, 123 KB for dk/dv; up to 225 KB for
// fp32 dk/dv at D = 128, set with cudaFuncSetAttribute). bf16 products go
// through WMMA 16x16x16 (mma.sync underneath) with f32 accumulation; fp32
// inputs take a scalar FMA path with the same structure. D in {32, 64, 128}.
//
// Bound at the training cell (B = 24, L = 512, H = 12, D = 64, bf16, no
// padding) on an H100 SXM:
//   operations: the function needs five products (S, dP, dV, dQ, dK),
//     10 * B * H * L^2 * D = 48.3 GFLOP -> 48.9 us at 989 TFLOP/s
//   bytes: q, k, v, o and dO read, dq, dk and dv written,
//     8 * 18.9 MB = 151 MB -> 45.1 us at 3.35 TB/s
// so about 0.049 ms per call, set by operations, 12 calls per step. The
// two-kernel design recomputes S and dP in both kernels (7 products, 1.4x
// the operations), and like the forward this first version is built to be
// right, not fast: synchronous loads, S/dP/accumulators round-tripping
// through shared memory, one 128-thread block per tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

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

// dK/dV block: the resident K/V tile, the current Q/dO tile, S, dP, P, dS
// and both sums.
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
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
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

// acc[r0:r0+16, 0:D] += A[0:64, r0:r0+16]^T . B[0:64, 0:D].
template <typename T, int D>
__device__ __forceinline__ void mma_acc_atb(float* acc, int ldacc, const T* a, int lda,
                                            const T* b, int ldb, int r0, int lane) {
  if constexpr (!Pads<T>::kF32) {
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::load_matrix_sync(c, acc + r0 * ldacc + n * 16, ldacc, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < 64 / 16; ++kk) {
        // A^T as a column-major operand: element (i, j) sits at a[j][r0 + i].
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, a + (kk * 16) * lda + r0, lda);
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
      for (int c = 0; c < 64; ++c) sum = fmaf(to_float(a[c * lda + r]), to_float(b[c * ldb + d]), sum);
      acc[r * ldacc + d] = sum;
    }
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

template <typename T, int D>
cudaError_t launch_dkv(const Args& a) {
  constexpr int smem = (int)sizeof(SmemDkv<T, D>);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.L + kBK - 1) / kBK, a.H, a.B);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const uint8_t*>(a.mask), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.L, a.H, a.scale_log2, a.scale);
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

extern "C" const char* flash_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
