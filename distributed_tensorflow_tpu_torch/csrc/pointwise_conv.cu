// 1x1-convolution backward for Hopper (sm_90a): the input gradient
// dx[M, K] = g[M, N] W[K, N]^T and the weight gradient dW[K, N] = x2^T g.
//
// dgrad replaces the TPU kernels distributed_tensorflow_tpu/ops/
// pointwise_conv.py `_dgrad_kernel` (:74, the [M, C] flatten) and
// `_dgrad_n64_kernel` (:202, the N = 64 case in the TPU's [H*W, C, B] view).
// That view existed for XLA:TPU's batch-minor layout of 64-channel
// activations; an NHWC tensor flattens to [B*H*W, C] as a view, so both are
// this one kernel, and only the wrapper's launch counter tells the two
// routes apart.
//
// Semantics: f32 sums of bf16 (or fp32) products, dx written in g's dtype,
// as the TPU kernel's dot_general with preferred_element_type=f32 followed
// by .astype(o_ref.dtype). Any M; K and N multiples of 8 (16-byte rows).
//
// Bound on an H100 SXM at ResNet-50's shapes (b = 128): the largest,
// (M, K, N) = (401408, 256, 128), moves g + dx = 308 MB (92 us at
// 3.35 TB/s) for 26 GFLOP (26 us at 989 TFLOP/s); every shape of the
// path has K*N / (K + N) <= 410 operations per byte, near the card's
// ridge of 295, so the kernel is bound by bytes at small K*N and by the
// tensor cores at the deepest stage. Design (conv1x1_tile.cuh): 128 x 128
// output tiles per 256-thread block, the reduction over N in chunks of 32
// through a two-stage cp.async ring, WMMA bf16 with f32 accumulation. The
// grid runs the K tiles of one M strip next to each other, so g's strip is
// read from device memory once and from L2 for the other K tiles.
//
// wgrad replaces `_wgrad_kernel` (:85): dW = sum over M of x2^T g, always
// f32. The TPU kernel carried dW across a sequential grid over M tiles;
// here blocks run in no order, so the reduction over M is split instead:
// one block per (128 x 128 tile of dW, M range) loops over its range in
// chunks of 32 rows (A = x2^T read column-major, B = g row-major) and
// writes an f32 partial; a second kernel sums the partials in a fixed
// order. No atomics, so every run gives the same dW. Bound: x2 and g read
// once (at (401408, 256, 128) 308 MB, 92 us), dW written once; the
// partials add a write and a read of [splits, K, N] f32 (17 MB there).
#include "conv1x1_tile.cuh"

#include <algorithm>

namespace {

using namespace conv1x1;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    pw_dgrad_kernel(const T* __restrict__ g, const T* __restrict__ w, T* __restrict__ dx, int M,
                    int K, int N) {
  using G = BlockGemm<T, false, false>;
  using AS = typename G::AShape;
  using BS = typename G::BShape;
  constexpr int kBR = Cfg<T>::kBR;
  __shared__ __align__(128) unsigned char smem_raw[G::kSmemBytes];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int k0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  // A = g rows [m0, m0 + 128), chunked along N; B(n, k) = W[k, n].
  CopyOperand<T, kBM, kBR, AS::kLd, false> opa{g, N, M, N, m0, 0};
  CopyOperand<T, kBN, kBR, BS::kLd, false> opb{w, N, K, N, k0, 0};
  auto store = [&](int r, int c, const float* v) { store8(dx, K, M, K, m0 + r, k0 + c, v); };
  G::run(smem, opa, opb, (N + kBR - 1) / kBR, store);
}

template <typename T>
cudaError_t launch(const void* g, const void* w, void* dx, int M, int K, int N,
                   cudaStream_t stream) {
  const dim3 grid((K + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  pw_dgrad_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(w), static_cast<T*>(dx), M, K, N);
  return cudaGetLastError();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    pw_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ g, float* __restrict__ part,
                    int M, int K, int N, int rows_per_split) {
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
  // A(k, m) = x[m, k] and B(m, n) = g[m, n] over rows [mb, me), chunked
  // along M; rows from me on read as zero in both.
  CopyOperand<T, kBR, kBM, AS::kLd, true> opa{x, K, me, K, mb, k0};
  CopyOperand<T, kBR, kBN, BS::kLd, true> opb{g, N, me, N, mb, n0};
  float* out = part + (int64_t)blockIdx.z * K * N;
  auto store = [&](int r, int c, const float* v) { store8(out, N, K, N, k0 + r, n0 + c, v); };
  G::run(smem, opa, opb, me > mb ? (me - mb + kBR - 1) / kBR : 0, store);
}

// dw[i] = sum over s of part[s][i], in order of s, four floats a thread.
__global__ void pw_wgrad_sum_kernel(const float4* __restrict__ part, float4* __restrict__ dw,
                                    int64_t n4, int splits) {
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
    dw[i] = s;
  }
}

template <typename T>
cudaError_t launch_wgrad(const void* x, const void* g, float* part, float* dw, int M, int K,
                         int N, int rows_per_split, cudaStream_t stream) {
  const int splits = (M + rows_per_split - 1) / rows_per_split;
  const dim3 grid((N + kBN - 1) / kBN, (K + kBM - 1) / kBM, splits);
  pw_wgrad_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), splits > 1 ? part : dw, M, K, N,
      rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int64_t n4 = (int64_t)K * N / 4;
  const int blocks = (int)std::min<int64_t>((n4 + 255) / 256, 132 * 8);
  pw_wgrad_sum_kernel<<<blocks, 256, 0, stream>>>(reinterpret_cast<const float4*>(part),
                                                  reinterpret_cast<float4*>(dw), n4, splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" int pw_dgrad(const void* g, const void* w, void* dx, int M, int K, int N, int is_f32,
                        void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 8 || N % 8) return (int)cudaErrorInvalidValue;
  if ((M + kBM - 1) / kBM > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_f32 ? launch<float>(g, w, dx, M, K, N, s)
                      : launch<__nv_bfloat16>(g, w, dx, M, K, N, s));
}

// dW [K, N] f32 from x2 [M, K] and g [M, N]; part holds the
// [ceil(M / rows_per_split), K, N] f32 partials (unused, may be null, with
// one split).
extern "C" int pw_wgrad(const void* x, const void* g, void* part, void* dw, int M, int K, int N,
                        int rows_per_split, int is_f32, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 8 || N % 8 || rows_per_split <= 0)
    return (int)cudaErrorInvalidValue;
  const int splits = (M + rows_per_split - 1) / rows_per_split;
  if (splits > 65535 || (K + kBM - 1) / kBM > 65535 || (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  float* out = static_cast<float*>(dw);
  return (int)(is_f32 ? launch_wgrad<float>(x, g, p, out, M, K, N, rows_per_split, s)
                      : launch_wgrad<__nv_bfloat16>(x, g, p, out, M, K, N, rows_per_split, s));
}

extern "C" const char* pointwise_conv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
