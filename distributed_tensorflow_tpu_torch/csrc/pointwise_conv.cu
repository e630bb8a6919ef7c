// 1x1-convolution backward for Hopper (sm_90a): the input gradient
// dx[M, K] = g[M, N] W[K, N]^T and the weight gradient dW[K, N] = x2^T g.
//
// What it replaces (distributed_tensorflow_tpu/ops/pointwise_conv.py):
//   pw_dgrad: `_dgrad_kernel` (:74, the [M, C] flatten) and
//     `_dgrad_n64_kernel` (:202, the N = 64 case in the TPU's [H*W, C, B]
//     view, which existed for XLA:TPU's batch-minor layout of 64-channel
//     activations; an NHWC tensor flattens to [B*H*W, C] as a view, so both
//     are this one kernel and only the wrapper's launch counter tells the
//     two routes apart);
//   pw_wgrad: `_wgrad_kernel` (:85). The TPU kernel carried dW across a
//     sequential grid over M tiles; blocks here run in no order, so the sum
//     over M is split into ranges whose f32 partials a second kernel
//     (conv1x1_tile.cuh `sum_splits_kernel`) adds in a fixed order. No
//     atomics: every run gives the same dW.
//
// Semantics: f32 sums of bf16 (or fp32) products; dx in g's dtype, as the
// TPU kernel's dot_general with preferred_element_type=f32 followed by
// .astype(o_ref.dtype); dW always f32. Any M; K and N multiples of 8.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): inputs read once,
// outputs written once, against 2 M K N operations. dgrad at ResNet-50's
// shapes (b = 128; us, what bounds it): (401408, 256, 128) 92.0 bytes,
// (401408, 256, 64) 76.7 bytes [the N = 64 route], (100352, 128|512,
// 512|128) 38.4 bytes, (100352, 256|512, 512|256) 46.1 bytes, (25088,
// 256|1024, 1024|256) 19.3 bytes, (25088, 512|1024, 1024|512) 26.6
// operations, (6272, 512|2048, 2048|512) 13.3 operations, (6272, 1024,
// 2048) 26.6 operations: shapes with K N / (K + N) above the card's ridge of
// about 295 operations a byte are bound by the tensor cores. wgrad at
// scripts/torch_pw_bench.py's shapes: (401408, 256|64, 64|256) 76.7 bytes,
// (401408, 64, 64) 30.7, (100352, 512|128, 128|512) 38.4, (25088,
// 1024|256, 256|1024) 19.5 bytes, (6272, 2048|512, 512|2048) 13.3
// operations.
//
// bf16 design (sm90_gemm.cuh; the fp32 path keeps conv1x1_tile.cuh's
// BlockGemm, exact f32 products by scalar FMA, since TF32 would not hold
// the 1e-4 fp32 tolerance). Every product is a `wgmma` m64n128k16 from
// swizzled shared-memory tiles. A block is one producer warpgroup, of which
// one thread starts Tensor Memory Accelerator (TMA) copies, and one or two
// consumer warpgroups of 64 output rows each, which only multiply and store.
// Chunks of 64 bf16 along the reduction (one 128-byte swizzle atom a row)
// stream through a four-stage ring in dynamic shared memory, each stage
// guarded by a `full` mbarrier (completed by the copies' byte count) and an
// `empty` one (every consumer thread arrives once its products have read
// the stage). A consumer keeps one chunk's products in flight while it
// waits for the next. TMA rather than `cp.async`: a first version of this
// ring made 16-byte `cp.async` copies from the whole producer warpgroup
// and was slower at every shape on the H100 (each thread's wait for its
// own copies and `fence.proxy.async` sat between a copy and its barrier).
// The tensor maps are encoded per launch through the CUDA runtime's entry
// point into the CUDA driver, so nothing links libcuda, and the
// copies zero-fill past M, K and N themselves.
//
//   pw_dgrad_kernel_sm90: both operands K-major (N is contiguous in g and
//     in W), as S = Q K^T in flash_fwd.cu. 128 x 128 tiles of dx, two
//     consumer warpgroups. The grid is persistent, one block per SM: each
//     block walks tiles t = blockIdx.x, + gridDim.x, ... with t = m-tile x
//     k-tiles + k-tile, so the blocks in flight cover all K tiles of a few
//     M strips at once and g's strip comes from device memory once and
//     from L2 for its other K tiles; W (at most 4 MB here) stays in L2. The
//     ring's counter runs across tiles, so the next tile's chunks are
//     copied while this tile's epilogue runs: at N <= 256 a tile has only
//     1-4 chunks, and this is what hides the fill. The epilogue packs the
//     accumulators to bf16 in registers, writes them to a swizzled staging
//     tile (no bank conflicts) and stores dx in 16-byte segments, 256
//     contiguous bytes a row. Shared memory: 4 x 32 KB ring + 32 KB staging
//     + barriers + 1 KB to align = 164,928 B, one block per SM; ptxas: 156
//     registers, no spills.
//   pw_wgrad_kernel_sm90<NWG>: both operands MN-major: a chunk is 64 rows of
//     x2 and 64 rows of g copied as they are, and the products read them
//     transposed (no transpose pass). A block owns one (64 NWG) x 128 tile
//     of dW and one range of M, accumulated in registers over the whole
//     range, so the ring's fill is paid once per block. NWG = 1 (64-row
//     tiles) where K <= 64, which removes the zero rows a 128-row tile
//     carried at the bench's K = 64 shapes; a box that starts past K or N
//     (the second 64 columns of g at N = 64) is not copied at all. The
//     number of M ranges is chosen per shape by ops/pointwise_conv.py
//     `wgrad_rows_per_split`: as many as fill one wave of the SMs with the
//     shape's dW tiles, and one where the tiles alone fill it (more ranges
//     would add waves and f32 partials, not SMs); with one range the
//     kernel writes dW itself. Shared memory: 4 x 24 or 32 KB + barriers +
//     1 KB = 99,392 / 132,160 B; ptxas: 90 registers, no spills.
//
// What the design changes against the first kernels (WMMA 16x16x16 loaded
// from padded shared memory, 32-wide chunks through a two-stage ring in
// 48 KB of static shared memory with two __syncthreads a chunk, one 128 x
// 128 tile per block, an epilogue through 1 KB of scratch per warp, and a
// 128 x 128 wgrad tile even at K = 64): `wgmma` in place of mma.sync; a
// four-stage TMA ring of 64-wide chunks synchronised by mbarriers alone,
// never by the whole block; the fill hidden across tiles (dgrad) or paid
// once per long range (wgrad); a staged epilogue of whole rows; 64-row
// wgrad tiles at K = 64; and 1-2 wgrad splits at the stage-4 shapes where
// the old rule took 5 (42 MB of partials). chip_smoke.py's build phase
// prints the registers, spills and blocks per SM; PERF.md has the times.
#include "conv1x1_tile.cuh"
#include "sm90_gemm.cuh"

#include <algorithm>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kStages = 4;
using Ring = sm90::Ring<kStages>;

// ---------------------------------------------------------------------------
// bf16: wgmma from a TMA ring
// ---------------------------------------------------------------------------

// dgrad's shared-memory map (byte offsets from a 1024-byte aligned base).
struct DgradSmem {
  static constexpr int kA = 128 * 64 * 2;           // g chunk: 128 rows x 64
  static constexpr int kStage = 2 * kA;             // + the W chunk
  static constexpr int kStaging = kStages * kStage;  // 2 x (64 x 128 bf16)
  static constexpr int kBar = kStaging + 2 * 64 * 128 * 2;
  static constexpr int kAlloc = kBar + Ring::kBytes + 1024;
};

__global__ void __launch_bounds__(384, 1)
    pw_dgrad_kernel_sm90(const __grid_constant__ CUtensorMap map_g,
                         const __grid_constant__ CUtensorMap map_w, bf16* __restrict__ dx, int M,
                         int K, int N) {
  using S = DgradSmem;
  extern __shared__ __align__(1024) unsigned char smem_dgrad[];
  const uint32_t raw = sm90::smem_u32(smem_dgrad);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const Ring ring(base + S::kBar);
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  if (tid == 0) ring.init(256);
  __syncthreads();

  const int k_tiles = (K + 127) / 128;
  const int tiles = ((M + 127) / 128) * k_tiles;
  const int chunks = (N + 63) / 64;
  int it = 0;  // chunks through the ring so far
  if (wg == 0) {
    // Producer (one thread): g rows [m0, m0 + 128) and W rows [k0, k0 +
    // 128), columns [64 c, 64 c + 64), into chunk it's stage.
    if (tid == 0) {
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t / k_tiles) * 128;
        const int k0 = (t % k_tiles) * 128;
        for (int c = 0; c < chunks; ++c, ++it) {
          const uint32_t bar = ring.acquire(it, S::kStage);
          const uint32_t st = base + (it % kStages) * S::kStage;
          sm90::tma_load_2d(st, &map_g, 64 * c, m0, bar);
          sm90::tma_load_2d(st + S::kA, &map_w, 64 * c, k0, bar);
        }
      }
    }
    return;
  }
  // Consumers: warpgroup cw owns rows [64 cw, 64 cw + 64) of each tile.
  const int cw = wg - 1;
  const int lane = tid % 32;
  const int wrow = (tid % 128) / 32 * 16;
  const uint32_t staging = base + S::kStaging + cw * (64 * 128 * 2);
  unsigned char* staging_ptr = smem_dgrad + (staging - raw);
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = (t / k_tiles) * 128;
    const int k0 = (t % k_tiles) * 128;
    for (int c = 0; c < chunks; ++c, ++it) {
      ring.wait(it);
      const uint32_t st = base + (it % kStages) * S::kStage;
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        sm90::wgmma_m64n128<0, 0>(acc, sm90::Tile<64>::desc_k<64>(st + cw * (64 * 128), kk),
                                  sm90::Tile<64>::desc_k<128>(st + S::kA, kk), c > 0 || kk > 0);
      }
      sm90::wgmma_commit();
      // Chunk it's products stay in flight while the next chunk is awaited;
      // the chunk before has been read once they are the only ones left.
      sm90::wgmma_wait<1>();
      if (c > 0) ring.release(it - 1);
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    ring.release(it - 1);
    // Epilogue: bf16 pairs into the swizzled staging tile, then 16-byte
    // stores of whole rows.
    sm90::warpgroup_sync(wg);  // the last tile's stores have read the staging tile
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int r = wrow + sm90::acc_row(lane, i);
      const int col = sm90::acc_col(lane, i);
      *reinterpret_cast<__nv_bfloat162*>(staging_ptr + sm90::Tile<128>::offset<64>(r, col)) =
          __floats2bfloat162_rn(acc[i], acc[i + 1]);
    }
    sm90::warpgroup_sync(wg);
    for (int i = tid % 128; i < 64 * 16; i += 128) {
      const int r = i / 16;
      const int col = (i % 16) * 8;
      const int row = m0 + 64 * cw + r;
      if (row < M && k0 + col < K) {
        *reinterpret_cast<uint4*>(dx + (int64_t)row * K + k0 + col) =
            *reinterpret_cast<const uint4*>(staging_ptr + sm90::Tile<128>::offset<64>(r, col));
      }
    }
  }
}

// wgrad's shared-memory map for NWG consumer warpgroups (64 NWG rows of dW).
template <int NWG>
struct WgradSmem {
  static constexpr int kA = 64 * (64 * NWG) * 2;  // x2 chunk: 64 rows x 64 NWG
  static constexpr int kStage = kA + 64 * 128 * 2;  // + the g chunk: 64 x 128
  static constexpr int kBar = kStages * kStage;
  static constexpr int kAlloc = kBar + Ring::kBytes + 1024;
};

template <int NWG>
__global__ void __launch_bounds__((NWG + 1) * 128, 1)
    pw_wgrad_kernel_sm90(const __grid_constant__ CUtensorMap map_x,
                         const __grid_constant__ CUtensorMap map_g, float* __restrict__ out, int M,
                         int K, int N, int rows_per_split) {
  using S = WgradSmem<NWG>;
  using TA = sm90::Tile<64 * NWG>;
  extern __shared__ __align__(1024) unsigned char smem_wgrad[];
  const uint32_t raw = sm90::smem_u32(smem_wgrad);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const Ring ring(base + S::kBar);
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  if (tid == 0) ring.init(128 * NWG);
  __syncthreads();

  const int n0 = blockIdx.x * 128;
  const int k0 = blockIdx.y * 64 * NWG;
  const int mb = blockIdx.z * rows_per_split;
  const int me = min(M, mb + rows_per_split);
  const int chunks = me > mb ? (me - mb + 63) / 64 : 0;
  if (wg == 0) {
    // Producer (one thread): rows [mb + 64 c, + 64) of x2 (columns k0..,
    // one 64-column box per atom) and of g (columns n0.., two boxes). A
    // range is a whole number of chunks except at M, past which the boxes
    // read as zero. A box that starts past K or N is not copied: its atom
    // meets only output rows or columns that are never stored.
    if (tid == 0) {
      const int ax = min(NWG, (K - k0 + 63) / 64);  // x2 boxes that hold columns
      const int ag = min(2, (N - n0 + 63) / 64);    // g boxes that do
      for (int c = 0; c < chunks; ++c) {
        const uint32_t bar = ring.acquire(c, (ax + ag) * 8192);
        const uint32_t st = base + (c % kStages) * S::kStage;
        const int row = mb + 64 * c;
        for (int a = 0; a < ax; ++a) {
          sm90::tma_load_2d(st + a * 8192, &map_x, k0 + 64 * a, row, bar);
        }
        for (int a = 0; a < ag; ++a) {
          sm90::tma_load_2d(st + S::kA + a * 8192, &map_g, n0 + 64 * a, row, bar);
        }
      }
    }
    return;
  }
  const int cw = wg - 1;
  const int lane = tid % 32;
  const int wrow = (tid % 128) / 32 * 16;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int c = 0; c < chunks; ++c) {
    ring.wait(c);
    const uint32_t st = base + (c % kStages) * S::kStage;
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      sm90::wgmma_m64n128<1, 1>(acc, TA::template desc_mn<64>(st, cw, kk),
                                sm90::desc_mn_wide<64>(st + S::kA, kk), c > 0 || kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();  // as in dgrad: one chunk's products in flight
    if (c > 0) ring.release(c - 1);
  }
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);
  // f32 pairs straight from the accumulators: a quad of threads writes 32
  // contiguous bytes of a row.
  out += (int64_t)blockIdx.z * K * N;
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int row = k0 + 64 * cw + wrow + sm90::acc_row(lane, i);
    const int col = n0 + sm90::acc_col(lane, i);
    if (row < K && col < N) {
      *reinterpret_cast<float2*>(out + (int64_t)row * N + col) = make_float2(acc[i], acc[i + 1]);
    }
  }
}

template <class Kernel>
cudaError_t set_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

cudaError_t launch_dgrad_sm90(const void* g, const void* w, void* dx, int M, int K, int N,
                              cudaStream_t stream) {
  cudaError_t err = set_smem(pw_dgrad_kernel_sm90, DgradSmem::kAlloc);
  if (err != cudaSuccess) return err;
  CUtensorMap map_g, map_w;
  err = sm90::make_tmap_2d(&map_g, g, M, N, 128);
  if (err == cudaSuccess) err = sm90::make_tmap_2d(&map_w, w, K, N, 128);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)((M + 127) / 128) * ((K + 127) / 128);
  const int grid = (int)std::min<long long>(tiles, sm_count());
  pw_dgrad_kernel_sm90<<<grid, 384, DgradSmem::kAlloc, stream>>>(map_g, map_w,
                                                                  static_cast<bf16*>(dx), M, K, N);
  return cudaGetLastError();
}

template <int NWG>
cudaError_t launch_wgrad_sm90(const void* x, const void* g, float* out, int M, int K, int N,
                              int rows_per_split, int splits, cudaStream_t stream) {
  using S = WgradSmem<NWG>;
  cudaError_t err = set_smem(pw_wgrad_kernel_sm90<NWG>, S::kAlloc);
  if (err != cudaSuccess) return err;
  CUtensorMap map_x, map_g;
  err = sm90::make_tmap_2d(&map_x, x, M, K, 64);
  if (err == cudaSuccess) err = sm90::make_tmap_2d(&map_g, g, M, N, 64);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + 127) / 128, (K + 64 * NWG - 1) / (64 * NWG), splits);
  pw_wgrad_kernel_sm90<NWG><<<grid, (NWG + 1) * 128, S::kAlloc, stream>>>(
      map_x, map_g, out, M, K, N, rows_per_split);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: conv1x1_tile.cuh's BlockGemm (scalar FMA)
// ---------------------------------------------------------------------------

using namespace conv1x1;

__global__ void __launch_bounds__(kThreads)
    pw_dgrad_kernel_f32(const float* __restrict__ g, const float* __restrict__ w,
                        float* __restrict__ dx, int M, int K, int N) {
  using G = BlockGemm<float, false, false>;
  using AS = typename G::AShape;
  using BS = typename G::BShape;
  constexpr int kBR = Cfg<float>::kBR;
  __shared__ __align__(128) unsigned char smem_raw[G::kSmemBytes];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int k0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  // A = g rows [m0, m0 + 128), chunked along N; B(n, k) = W[k, n].
  CopyOperand<float, kBM, kBR, AS::kLd, false> opa{g, N, M, N, m0, 0};
  CopyOperand<float, kBN, kBR, BS::kLd, false> opb{w, N, K, N, k0, 0};
  auto store = [&](int r, int c, const float* v) { store8(dx, K, M, K, m0 + r, k0 + c, v); };
  G::run(smem, opa, opb, (N + kBR - 1) / kBR, store);
}

__global__ void __launch_bounds__(kThreads)
    pw_wgrad_kernel_f32(const float* __restrict__ x, const float* __restrict__ g,
                        float* __restrict__ part, int M, int K, int N, int rows_per_split) {
  using G = BlockGemm<float, true, true>;
  using AS = typename G::AShape;
  using BS = typename G::BShape;
  constexpr int kBR = Cfg<float>::kBR;
  __shared__ __align__(128) unsigned char smem_raw[G::kSmemBytes];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int n0 = blockIdx.x * kBN;
  const int k0 = blockIdx.y * kBM;
  const int mb = blockIdx.z * rows_per_split;
  const int me = min(M, mb + rows_per_split);
  // A(k, m) = x[m, k] and B(m, n) = g[m, n] over rows [mb, me), chunked
  // along M; rows from me on read as zero in both.
  CopyOperand<float, kBR, kBM, AS::kLd, true> opa{x, K, me, K, mb, k0};
  CopyOperand<float, kBR, kBN, BS::kLd, true> opb{g, N, me, N, mb, n0};
  float* out = part + (int64_t)blockIdx.z * K * N;
  auto store = [&](int r, int c, const float* v) { store8(out, N, K, N, k0 + r, n0 + c, v); };
  G::run(smem, opa, opb, me > mb ? (me - mb + kBR - 1) / kBR : 0, store);
}

cudaError_t launch_dgrad(const void* g, const void* w, void* dx, int M, int K, int N, int is_f32,
                         cudaStream_t stream) {
  if (!is_f32) return launch_dgrad_sm90(g, w, dx, M, K, N, stream);
  const dim3 grid((K + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  pw_dgrad_kernel_f32<<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(g), static_cast<const float*>(w), static_cast<float*>(dx), M, K,
      N);
  return cudaGetLastError();
}

cudaError_t launch_wgrad(const void* x, const void* g, float* part, float* dw, int M, int K,
                         int N, int rows_per_split, int is_f32, cudaStream_t stream) {
  const int splits = (M + rows_per_split - 1) / rows_per_split;
  float* out = splits > 1 ? part : dw;
  cudaError_t err;
  if (is_f32) {
    const dim3 grid((N + kBN - 1) / kBN, (K + kBM - 1) / kBM, splits);
    pw_wgrad_kernel_f32<<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(g), out, M, K, N,
        rows_per_split);
    err = cudaGetLastError();
  } else if (K <= 64) {
    err = launch_wgrad_sm90<1>(x, g, out, M, K, N, rows_per_split, splits, stream);
  } else {
    err = launch_wgrad_sm90<2>(x, g, out, M, K, N, rows_per_split, splits, stream);
  }
  if (err != cudaSuccess || splits == 1) return err;
  return sum_splits(part, dw, (int64_t)K * N, splits, stream);
}

}  // namespace

extern "C" int pw_dgrad(const void* g, const void* w, void* dx, int M, int K, int N, int is_f32,
                        void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 8 || N % 8) return (int)cudaErrorInvalidValue;
  if ((M + kBM - 1) / kBM > 65535) return (int)cudaErrorInvalidValue;
  return (int)launch_dgrad(g, w, dx, M, K, N, is_f32, static_cast<cudaStream_t>(stream));
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
  // bf16: each range a whole number of the kernel's 64-row chunks.
  if (!is_f32 && splits > 1 && rows_per_split % 64) return (int)cudaErrorInvalidValue;
  return (int)launch_wgrad(x, g, static_cast<float*>(part), static_cast<float*>(dw), M, K, N,
                           rows_per_split, is_f32, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory (bytes) and resident blocks per SM of the bf16
// kernels: which = 0 dgrad, 1 wgrad with 128-row tiles, 2 wgrad with 64.
extern "C" int pointwise_conv_occupancy(int which, int* smem_bytes, int* blocks_per_sm) {
  cudaError_t err;
  if (which == 0) {
    *smem_bytes = DgradSmem::kAlloc;
    err = set_smem(pw_dgrad_kernel_sm90, *smem_bytes);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, pw_dgrad_kernel_sm90,
                                                          384, *smem_bytes);
    }
  } else if (which == 1 || which == 2) {
    const int nwg = which == 1 ? 2 : 1;
    *smem_bytes = nwg == 2 ? WgradSmem<2>::kAlloc : WgradSmem<1>::kAlloc;
    err = nwg == 2 ? set_smem(pw_wgrad_kernel_sm90<2>, *smem_bytes)
                   : set_smem(pw_wgrad_kernel_sm90<1>, *smem_bytes);
    if (err == cudaSuccess) {
      err = nwg == 2 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                           blocks_per_sm, pw_wgrad_kernel_sm90<2>, 384, *smem_bytes)
                     : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                           blocks_per_sm, pw_wgrad_kernel_sm90<1>, 256, *smem_bytes);
    }
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

extern "C" const char* pointwise_conv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
