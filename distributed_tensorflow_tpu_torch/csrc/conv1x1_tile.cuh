// Block-tile matrix product of the fused conv+BN backward kernels
// (fused_conv_bn.cu, bf16 and fp32) and of the fp32 path of the 1x1-conv
// backward (pointwise_conv.cu, whose bf16 path is the `wgmma` design of
// sm90_gemm.cuh) on Hopper (sm_90a).
//
// One block of 8 warps computes a 128 x 128 tile of C = A B, f32 sums,
// looping over the reduction dimension in chunks of kBR. Each chunk of A
// (128 x kBR) and of B (kBR x 128) goes through a two-stage ring in shared
// memory: the chunk after next is copied with cp.async (an operand read
// from device memory as it is) or fetched into registers and transformed
// (an operand computed on the fly, such as the fused kernels' dz) while
// the tensor cores work on the current one.
//
// Operand layouts in shared memory, named after the WMMA fragment that
// reads them:
//   A row-major: As[i][r] (an [M, R] matrix, r contiguous in memory);
//   A col-major: As[r][i] (an [R, M] matrix read transposed: x^T of dW);
//   B col-major: Bs[j][r] (W [K, N] read as W^T: dx = g W^T);
//   B row-major: Bs[r][j] (an [R, N] matrix, j contiguous).
//
// bf16 inputs go through WMMA 16x16x16 (mma.sync) with f32 accumulation;
// fp32 inputs through scalar FMA over the same tiles (exact f32 products,
// as the plain PyTorch version computes them). Rows and columns past the
// matrix ends are zero-filled on load and masked on store, so any M and
// any K, N that are multiples of 8 work.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace conv1x1 {

using namespace nvcuda;

constexpr int kBM = 128;      // output rows per block
constexpr int kBN = 128;      // output columns per block
constexpr int kThreads = 256;  // 8 warps: 4 along rows x 2 along columns
constexpr int kWarpM = 32;     // each warp: 32 rows x 64 columns
constexpr int kWarpN = 64;

template <typename T>
struct Cfg;
template <>
struct Cfg<__nv_bfloat16> {
  static constexpr int kBR = 32;  // reduction chunk
  static constexpr int kPad = 8;  // 16 bytes per padded row
};
template <>
struct Cfg<float> {
  static constexpr int kBR = 16;
  static constexpr int kPad = 4;
};

// Elements of T in one 16-byte vector.
template <typename T>
constexpr int kVec = 16 / sizeof(T);

// Padded leading dimensions and sizes of one stage's tiles.
template <typename T, bool kColMajor, int kOuter>
struct TileShape {
  // kColMajor: [kBR][kOuter + pad]; else [kOuter][kBR + pad].
  static constexpr int kRows = kColMajor ? Cfg<T>::kBR : kOuter;
  static constexpr int kCols = kColMajor ? kOuter : Cfg<T>::kBR;
  static constexpr int kLd = kCols + Cfg<T>::kPad;
  static constexpr int kElems = kRows * kLd;
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;  // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// An operand copied as it is from a row-major matrix src [rows, cols]
// (leading dimension ld): chunk c is the tile of rows [row0, row0 + R) and
// columns [col0, col0 + C), with the chunk advancing row0 (kAlongRows) or
// col0 by the chunk length. Stored as dst[r][c] with leading dimension Ld.
template <typename T, int R, int C, int Ld, bool kAlongRows>
struct CopyOperand {
  const T* src;
  int64_t ld;
  int rows, cols;  // valid extent of src
  int row0, col0;  // origin of chunk 0

  __device__ __forceinline__ void fetch(int) {}
  __device__ __forceinline__ void issue(T* dst, int chunk) {
    constexpr int kV = kVec<T>;
    constexpr int kPerRow = C / kV;
    const int r0 = kAlongRows ? row0 + chunk * R : row0;
    const int c0 = kAlongRows ? col0 : col0 + chunk * C;
    for (int i = threadIdx.x; i < R * kPerRow; i += kThreads) {
      const int r = i / kPerRow;
      const int c = (i % kPerRow) * kV;
      const bool valid = (r0 + r < rows) && (c0 + c < cols);
      const T* g = valid ? src + (int64_t)(r0 + r) * ld + (c0 + c) : src;
      cp_async16(dst + r * Ld + c, g, valid);
    }
  }
  __device__ __forceinline__ void put(T*) {}
};

// The block's product over all chunks into the f32 accumulators, then
// `store(row, col, 8 values)` for every 8-wide row segment of the tile.
template <typename T, bool kAColMajor, bool kBRowMajor>
struct BlockGemm {
  using AShape = TileShape<T, kAColMajor, kBM>;
  using BShape = TileShape<T, kBRowMajor, kBN>;
  static constexpr int kBR = Cfg<T>::kBR;
  static constexpr int kStageElems = AShape::kElems + BShape::kElems;
  static constexpr int kSmemBytes = 2 * kStageElems * (int)sizeof(T);
  static_assert(kSmemBytes <= 48 * 1024, "static shared memory");
  static_assert(8 * 256 * 4 <= kSmemBytes, "epilogue scratch fits in the ring");

  template <class OpA, class OpB, class Store>
  __device__ __forceinline__ static void run(T* smem, OpA& opa, OpB& opb, int nchunks,
                                             Store& store) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);
      const int warp = threadIdx.x / 32;
      const int wm = (warp / 2) * kWarpM;
      const int wn = (warp % 2) * kWarpN;
      mainloop(smem, opa, opb, nchunks, [&](const T* as, const T* bs) {
        using LayoutA = typename std::conditional<kAColMajor, wmma::col_major,
                                                  wmma::row_major>::type;
        using LayoutB = typename std::conditional<kBRowMajor, wmma::row_major,
                                                  wmma::col_major>::type;
#pragma unroll
        for (int kk = 0; kk < kBR; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, LayoutA> a[2];
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, LayoutB> b[4];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int row = wm + 16 * i;
            const T* p = kAColMajor ? as + kk * AShape::kLd + row : as + row * AShape::kLd + kk;
            wmma::load_matrix_sync(a[i], p, AShape::kLd);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = wn + 16 * j;
            const T* p = kBRowMajor ? bs + kk * BShape::kLd + col : bs + col * BShape::kLd + kk;
            wmma::load_matrix_sync(b[j], p, BShape::kLd);
          }
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
        }
      });
      // Epilogue: each warp stages one 16 x 16 fragment at a time in its own
      // 1 KB of the (now idle) ring and hands out 8-wide row segments.
      float* scratch = reinterpret_cast<float*>(smem) + warp * 256;
      const int lane = threadIdx.x % 32;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
          __syncwarp();
          const int r = lane / 2, c = (lane % 2) * 8;
          store(wm + 16 * i + r, wn + 16 * j + c, scratch + r * 16 + c);
          __syncwarp();
        }
    } else {
      // fp32: thread (tr, tc) owns rows tr*8.. and columns tc*8.. of the tile.
      float acc[8][8];
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;
      const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
      mainloop(smem, opa, opb, nchunks, [&](const T* as, const T* bs) {
#pragma unroll 4
        for (int k = 0; k < kBR; ++k) {
          float av[8], bv[8];
#pragma unroll
          for (int a = 0; a < 8; ++a) {
            const int i = tr * 8 + a;
            av[a] = to_float(kAColMajor ? as[k * AShape::kLd + i] : as[i * AShape::kLd + k]);
          }
#pragma unroll
          for (int b = 0; b < 8; ++b) {
            const int j = tc * 8 + b;
            bv[b] = to_float(kBRowMajor ? bs[k * BShape::kLd + j] : bs[j * BShape::kLd + k]);
          }
#pragma unroll
          for (int a = 0; a < 8; ++a)
#pragma unroll
            for (int b = 0; b < 8; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
        }
      });
#pragma unroll
      for (int a = 0; a < 8; ++a) store(tr * 8 + a, tc * 8, acc[a]);
    }
  }

  // Two-stage ring: chunk c + 1 is copied (cp.async) or fetched into
  // registers while chunk c is multiplied, and written into its stage
  // after. Every iteration commits one cp.async group (possibly empty), so
  // waiting for all but the newest leaves exactly chunk c complete.
  template <class OpA, class OpB, class Mma>
  __device__ __forceinline__ static void mainloop(T* smem, OpA& opa, OpB& opb, int nchunks,
                                                  Mma&& mma) {
    T* stage[2] = {smem, smem + kStageElems};
    if (nchunks > 0) {
      opa.fetch(0);
      opb.fetch(0);
      opa.issue(stage[0], 0);
      opb.issue(stage[0] + AShape::kElems, 0);
      cp_async_commit();
      opa.put(stage[0]);
      opb.put(stage[0] + AShape::kElems);
    }
    for (int c = 0; c < nchunks; ++c) {
      T* cur = stage[c & 1];
      T* nxt = stage[(c + 1) & 1];
      const bool more = c + 1 < nchunks;
      if (more) {
        opa.fetch(c + 1);
        opb.fetch(c + 1);
        opa.issue(nxt, c + 1);
        opb.issue(nxt + AShape::kElems, c + 1);
      }
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      mma(cur, cur + AShape::kElems);
      if (more) {
        opa.put(nxt);
        opb.put(nxt + AShape::kElems);
      }
      __syncthreads();
    }
    cp_async_wait<0>();
    __syncthreads();
  }
};

// Writes 8 consecutive f32 values as OutT at (row, col) of a row-major
// [rows, cols] matrix, if inside it (cols is a multiple of 8).
template <typename OutT>
__device__ __forceinline__ void store8(OutT* dst, int64_t ld, int rows, int cols, int row,
                                       int col, const float* v) {
  if (row >= rows || col >= cols) return;
  OutT* p = dst + (int64_t)row * ld + col;
  if constexpr (std::is_same<OutT, float>::value) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    __align__(16) __nv_bfloat16 h[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) h[e] = __float2bfloat16(v[e]);
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(h);
  }
}

// dst[i] = sum over s of part[s][i] (n4 float4 vectors a split), in order
// of s, four floats a thread: the fixed-order second pass of the split-M
// weight gradients (pointwise_conv.cu's wgrad, fused_conv_bn.cu's dW). No
// atomics, so every run gives the same bits.
static __global__ void sum_splits_kernel(const float4* __restrict__ part,
                                         float4* __restrict__ dst, int64_t n4, int splits) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n4;
       i += (int64_t)gridDim.x * blockDim.x) {
    float4 s = part[i];
    for (int z = 1; z < splits; ++z) {
      const float4 p = part[z * n4 + i];
      s.x += p.x;
      s.y += p.y;
      s.z += p.z;
      s.w += p.w;
    }
    dst[i] = s;
  }
}

// Launch sum_splits_kernel over `elems` floats (a multiple of 4) a split.
static inline cudaError_t sum_splits(const float* part, float* dst, int64_t elems, int splits,
                                     cudaStream_t stream) {
  const int64_t n4 = elems / 4;
  const int64_t want = (n4 + 255) / 256;
  const int blocks = (int)(want < 132 * 8 ? want : 132 * 8);
  sum_splits_kernel<<<blocks, 256, 0, stream>>>(reinterpret_cast<const float4*>(part),
                                                reinterpret_cast<float4*>(dst), n4, splits);
  return cudaGetLastError();
}

}  // namespace conv1x1
