// Flash-attention forward for Hopper (sm_90a), bf16 tensor cores or fp32 FMA.
//
// Replaces the TPU kernels distributed_tensorflow_tpu/ops/flash_attention.py
// `_fwd_kernel` (:96, the [B*H, L, D] family) and `_fwd_kernel_packed`
// (:396, the flat [B, L, H*D] family). The TPU needed two families because
// Mosaic tiles (8, 128) lanes; here one kernel reads the strided
// [B, L, H, D] layout directly, so neither transposes nor lane masks exist.
//
// Semantics (identical to the TPU kernels):
//   s   = (scale * log2 e) * q k^T in f32, masked keys set to -1e30
//   online softmax in the base-2 domain over 64-key tiles:
//       m_new = max(m, rowmax s); p = exp2(s - m_new) * keymask
//       l = l * exp2(m - m_new) + rowsum p        (p summed in f32)
//       o = o * exp2(m - m_new) + p.astype(V) v   (f32 accumulation)
//   o   = o / max(l, 1e-37), written in the input dtype
//   lse = l > 0 ? m / log2 e + ln(max(l, 1e-37)) : -1e30   (natural log, [B, H, L])
// Fully masked query rows therefore give o = 0 and lse = -1e30. Keys and
// queries past L (the ragged edge) are masked here, the way the TPU wrapper
// padded them with mask False.
//
// Design: one block of 4 warps per (q tile of 64 rows, head, batch). Q, the
// current K/V tile, the score tile, P and the f32 output accumulator live in
// shared memory; each warp owns 16 query rows, so the softmax and the PV
// update need only warp-level synchronisation. bf16 products go through
// WMMA 16x16x16 (mma.sync underneath) with f32 accumulation; fp32 inputs
// (`--weight-dtype float32` serving) take a scalar FMA path with the same
// structure. D in {32, 64, 128}.
//
// Bound at the serving path's largest cell (tier 8, L = 512, H = 12, D = 64,
// bf16) on an H100 SXM:
//   operations 4 * B * H * L^2 * D = 6.4 GFLOP -> 6.5 us at 989 TFLOP/s
//   bytes      q, k, v, o = 4 * 8 * 512 * 768 * 2 B = 25 MB -> 7.5 us at 3.35 TB/s
// so the function is memory bound, barely. This first version is built to
// be right, not fast: it re-reads K/V once per q tile (8x at L = 512),
// issues no asynchronous copies and runs one 128-thread block per tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per K/V tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kBQ / kWarps;  // 16: one WMMA row strip
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory layout. Every row stride carries a 16-byte pad against
// bank conflicts; all member sizes are multiples of 32 bytes, which keeps
// every WMMA fragment pointer 256-bit aligned.
template <typename T, int D>
struct Smem {
  static constexpr int kPad = 16 / sizeof(T);
  static constexpr int kLdT = D + kPad;    // q, k, v rows (elements of T)
  static constexpr int kLdS = kBK + 4;     // score rows (floats)
  static constexpr int kLdP = kBK + kPad;  // P rows (elements of T)
  static constexpr int kLdO = D + 4;       // accumulator rows (floats)
  T q[kBQ * kLdT];
  T k[kBK * kLdT];
  T v[kBK * kLdT];
  float s[kBQ * kLdS];
  T p[kBQ * kLdP];
  float o[kBQ * kLdO];
  float m[kBQ];
  float l[kBQ];
  float kmask[kBK];
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

// Copy rows [row0, row0 + 64) of one head into shared memory in 16-byte
// vectors, zero-filling rows at or past `rows_valid` (the ragged edge).
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src, int row0,
                                          int rows_valid, int64_t row_stride) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = D / kVec;
  constexpr int kLd = Smem<T, D>::kLdT;
  for (int i = threadIdx.x; i < kBQ * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows_valid) {
      val = *reinterpret_cast<const uint4*>(src + (int64_t)(row0 + r) * row_stride + c);
    }
    *reinterpret_cast<uint4*>(dst + r * kLd + c) = val;
  }
}

// S[r0:r0+16, 0:64] = Q[r0:r0+16] K^T, f32.
template <typename T, int D>
__device__ __forceinline__ void scores(Smem<T, D>& sm, int r0, int lane) {
  using S = Smem<T, D>;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[D / 16];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::load_matrix_sync(a[kk], sm.q + r0 * S::kLdT + kk * 16, S::kLdT);
    }
#pragma unroll
    for (int n = 0; n < kBK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::fill_fragment(c, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        // K^T as a column-major B: element (d, key) sits at k[key][d].
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
        wmma::load_matrix_sync(b, sm.k + (n * 16) * S::kLdT + kk * 16, S::kLdT);
        wmma::mma_sync(c, a[kk], b, c);
      }
      wmma::store_matrix_sync(sm.s + r0 * S::kLdS + n * 16, c, S::kLdS, wmma::mem_row_major);
    }
  } else {
    for (int idx = lane; idx < kRowsPerWarp * kBK; idx += 32) {
      const int r = r0 + idx / kBK;
      const int c = idx % kBK;
      const T* qr = sm.q + r * S::kLdT;
      const T* kr = sm.k + c * S::kLdT;
      float acc = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) acc = fmaf(to_float(qr[d]), to_float(kr[d]), acc);
      sm.s[r * S::kLdS + c] = acc;
    }
  }
}

// Online-softmax step for this warp's 16 rows: two lanes per row, 32 keys
// each. Writes P (in V's dtype), updates m and l, rescales the O rows.
template <typename T, int D>
__device__ __forceinline__ void softmax_update(Smem<T, D>& sm, int r0, int lane,
                                               float scale_log2) {
  using S = Smem<T, D>;
  constexpr int kHalf = kBK / 2;
  const int row = r0 + (lane >> 1);
  const int c0 = (lane & 1) * kHalf;
  const float* srow = sm.s + row * S::kLdS;
  float vals[kHalf];
  float mx = kNeg;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float x = sm.kmask[c0 + i] != 0.f ? srow[c0 + i] * scale_log2 : kNeg;
    vals[i] = x;
    mx = fmaxf(mx, x);
  }
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  const float m_old = sm.m[row];
  const float l_old = sm.l[row];
  const float m_new = fmaxf(m_old, mx);
  T* prow = sm.p + row * S::kLdP;
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float p = exp2f(vals[i] - m_new) * sm.kmask[c0 + i];
    sum += p;
    prow[c0 + i] = from_float<T>(p);
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  const float corr = exp2f(m_old - m_new);
  __syncwarp();  // both lanes of the pair have read m and l
  if ((lane & 1) == 0) {
    sm.m[row] = m_new;
    sm.l[row] = l_old * corr + sum;
  }
  float* orow = sm.o + row * S::kLdO + (lane & 1) * (D / 2);
#pragma unroll 8
  for (int d = 0; d < D / 2; ++d) orow[d] *= corr;
}

// O[r0:r0+16] += P[r0:r0+16] V, f32 accumulation.
template <typename T, int D>
__device__ __forceinline__ void accumulate_pv(Smem<T, D>& sm, int r0, int lane) {
  using S = Smem<T, D>;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::load_matrix_sync(c, sm.o + r0 * S::kLdO + n * 16, S::kLdO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(a, sm.p + r0 * S::kLdP + kk * 16, S::kLdP);
        wmma::load_matrix_sync(b, sm.v + (kk * 16) * S::kLdT + n * 16, S::kLdT);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(sm.o + r0 * S::kLdO + n * 16, c, S::kLdO, wmma::mem_row_major);
    }
  } else {
    for (int idx = lane; idx < kRowsPerWarp * D; idx += 32) {
      const int r = r0 + idx / D;
      const int d = idx % D;
      const T* pr = sm.p + r * S::kLdP;
      float acc = sm.o[r * S::kLdO + d];
#pragma unroll 8
      for (int c = 0; c < kBK; ++c) acc = fmaf(to_float(pr[c]), to_float(sm.v[c * S::kLdT + d]), acc);
      sm.o[r * S::kLdO + d] = acc;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const uint8_t* __restrict__ mask, T* __restrict__ o, float* __restrict__ lse,
                     int L, int H, float scale_log2) {
  using S = Smem<T, D>;
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

  load_tile<T, D>(sm.q, q + head_base, q0, min(kBQ, L - q0), row_stride);
  for (int i = threadIdx.x; i < kBQ * D; i += kThreads) sm.o[(i / D) * S::kLdO + i % D] = 0.f;
  if (threadIdx.x < kBQ) {
    sm.m[threadIdx.x] = kNeg;
    sm.l[threadIdx.x] = 0.f;
  }

  const int n_tiles = (L + kBK - 1) / kBK;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBK;
    const int k_valid = min(kBK, L - k0);
    __syncthreads();  // the previous tile is consumed; the first one sees Q and the init
    load_tile<T, D>(sm.k, k + head_base, k0, k_valid, row_stride);
    load_tile<T, D>(sm.v, v + head_base, k0, k_valid, row_stride);
    if (threadIdx.x < kBK) {
      const int c = threadIdx.x;
      const bool ok = c < k_valid && (mask == nullptr || mask[(int64_t)b * L + k0 + c] != 0);
      sm.kmask[c] = ok ? 1.f : 0.f;
    }
    __syncthreads();
    scores<T, D>(sm, r0, lane);
    __syncwarp();
    softmax_update<T, D>(sm, r0, lane, scale_log2);
    __syncwarp();
    accumulate_pv<T, D>(sm, r0, lane);
  }
  __syncwarp();

  // Epilogue: the warp's 16 rows, two lanes per row.
  const int row = r0 + (lane >> 1);
  if (q0 + row < L) {
    const float l = sm.l[row];
    const float safe = fmaxf(l, 1e-37f);
    const float* orow = sm.o + row * S::kLdO;
    T* og = o + head_base + (int64_t)(q0 + row) * row_stride;
    const int d0 = (lane & 1) * (D / 2);
#pragma unroll 8
    for (int d = d0; d < d0 + D / 2; ++d) og[d] = from_float<T>(orow[d] / safe);
    if ((lane & 1) == 0) {
      lse[((int64_t)b * H + h) * L + q0 + row] = l > 0.f ? sm.m[row] / kLog2e + logf(safe) : kNeg;
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, void* o,
                   void* lse, int B, int L, int H, float scale_log2, cudaStream_t stream) {
  constexpr int smem = (int)sizeof(Smem<T, D>);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<T*>(o), static_cast<float*>(lse), L, H,
      scale_log2);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v, const void* mask,
                       void* o, void* lse, int B, int L, int H, float scale_log2,
                       cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, mask, o, lse, B, L, H, scale_log2, stream);
    case 64: return launch<T, 64>(q, k, v, mask, o, lse, B, L, H, scale_log2, stream);
    case 128: return launch<T, 128>(q, k, v, mask, o, lse, B, L, H, scale_log2, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o: contiguous [B, L, H, D]; mask: contiguous uint8/bool [B, L]
// (nullptr = every key valid); lse: [B, H, L] f32. is_f32 selects fp32
// inputs, else bf16. Returns the launch's cudaError_t (0 = launched).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, const void* mask, void* o,
                         void* lse, int B, int L, int H, int D, int is_f32, float scale_log2,
                         void* stream) {
  if (B <= 0 || L <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_f32 ? dispatch_d<float>(D, q, k, v, mask, o, lse, B, L, H, scale_log2, s)
             : dispatch_d<__nv_bfloat16>(D, q, k, v, mask, o, lse, B, L, H, scale_log2, s);
  return (int)err;
}

extern "C" const char* flash_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
