// 1x1-convolution dgrad for Hopper (sm_90a): dx[M, K] = g[M, N] W[K, N]^T.
//
// Replaces the TPU kernels distributed_tensorflow_tpu/ops/pointwise_conv.py
// `_dgrad_kernel` (:74, the [M, C] flatten) and `_dgrad_n64_kernel` (:202,
// the N = 64 case in the TPU's [H*W, C, B] view). That view existed for
// XLA:TPU's batch-minor layout of 64-channel activations; an NHWC tensor
// flattens to [B*H*W, C] as a view, so both are this one kernel, and only
// the wrapper's launch counter tells the two routes apart.
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

#include "conv1x1_tile.cuh"

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

}  // namespace

extern "C" int pw_dgrad(const void* g, const void* w, void* dx, int M, int K, int N, int is_f32,
                        void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 8 || N % 8) return (int)cudaErrorInvalidValue;
  if ((M + kBM - 1) / kBM > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_f32 ? launch<float>(g, w, dx, M, K, N, s)
                      : launch<__nv_bfloat16>(g, w, dx, M, K, N, s));
}

extern "C" const char* pointwise_conv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
