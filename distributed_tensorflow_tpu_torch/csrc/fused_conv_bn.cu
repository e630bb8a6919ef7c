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
//   bn_apply_dw_kernel one block per (128 x 128 tile of dW, M range): the
//                     TPU carried dW across its sequential grid; here each
//                     block loops over its M range and writes an f32
//                     partial, summed by the wrapper. No atomics, so the
//                     result is the same in every run.
// dz never goes to device memory: each block makes the tile it multiplies
// in registers and shared memory, which is what the TPU kernel was for.
//
// Bound on an H100 SXM at ResNet-50's shapes (b = 128, bf16): the reduce
// pass reads dA and z (2 * M * N * 2 bytes; 206 MB at (401408, 256, 128),
// 61 us); apply reads dA, z, x and W and writes dx and dW, for 4 M K N
// operations: bytes bound at every shape but the deepest
// (6272, 2048, 512), where 26 GFLOP take 26 us and 36 MB move in 11 us.
// This first version recomputes dz once per 128 columns of K in both apply
// kernels (from L2: the K tiles of one M strip run side by side), and its
// dW partials cost one more write and read of [splits, K, N] f32. The apply
// kernels are capped at 128 registers a thread for two blocks an SM: the
// loop waits on the global loads of dA and z each chunk, and one block of
// 8 warps leaves the SM idle meanwhile.

#include "conv1x1_tile.cuh"

namespace {

using namespace conv1x1;

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
cudaError_t apply(const void* da, const void* z, const void* x, const void* w,
                  const float* consts, void* dx, float* dw_part, int M, int K, int N,
                  int rows_per_split, bool relu, cudaStream_t s) {
  const T* da_ = static_cast<const T*>(da);
  const T* z_ = static_cast<const T*>(z);
  if (dx != nullptr) {
    const dim3 grid((K + kBN - 1) / kBN, (M + kBM - 1) / kBM);
    auto kernel = relu ? bn_apply_dx_kernel<T, true> : bn_apply_dx_kernel<T, false>;
    kernel<<<grid, kThreads, 0, s>>>(da_, z_, static_cast<const T*>(w), consts,
                                     static_cast<T*>(dx), M, K, N);
  } else {
    const dim3 grid((N + kBN - 1) / kBN, (K + kBM - 1) / kBM,
                    (M + rows_per_split - 1) / rows_per_split);
    auto kernel = relu ? bn_apply_dw_kernel<T, true> : bn_apply_dw_kernel<T, false>;
    kernel<<<grid, kThreads, 0, s>>>(da_, z_, static_cast<const T*>(x), consts, dw_part, M, K,
                                     N, rows_per_split);
  }
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
  return (int)(is_f32 ? apply<float>(da, z, nullptr, w, c, dx, nullptr, M, K, N, 0, relu, s)
                      : apply<__nv_bfloat16>(da, z, nullptr, w, c, dx, nullptr, M, K, N, 0,
                                             relu, s));
}

// dW partials [ceil(M / rows_per_split), K, N] f32.
extern "C" int bn_bwd_apply_dw(const void* da, const void* z, const void* x, const void* consts,
                               void* part, int M, int K, int N, int rows_per_split, int is_f32,
                               int relu, void* stream) {
  if (bad_shape(M, N) || K <= 0 || K % 8 || rows_per_split <= 0 ||
      (M + rows_per_split - 1) / rows_per_split > 65535 || (K + kBM - 1) / kBM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(consts);
  float* p = static_cast<float*>(part);
  return (int)(is_f32 ? apply<float>(da, z, x, nullptr, c, nullptr, p, M, K, N, rows_per_split,
                                     relu, s)
                      : apply<__nv_bfloat16>(da, z, x, nullptr, c, nullptr, p, M, K, N,
                                             rows_per_split, relu, s));
}

extern "C" const char* fused_conv_bn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
