// Flash-attention forward for Hopper (sm_90a): bf16 on the tensor cores
// through `wgmma`, fp32 on FMA.
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
// bf16 design (`flash_fwd_sm90`). One block per (q tile, head, batch); a q
// tile is one warpgroup of 128 threads per 64 query rows, 64 or 128 rows
// (the host takes 128, which halves the K/V traffic, when the grid of
// 128-row blocks still gives every SM one, else 64). S = Q K^T is a `wgmma` m64n64k16 with Q
// and the K tile read K-major from shared memory; the accumulator stays in
// registers, where each row is spread over a quad of 4 threads, so the
// online softmax needs two shuffles per row max and row sum. P goes to bf16
// in registers and is the register A operand of O += P V (m64nDk16, V read
// MN-major); O stays in registers and is rescaled there. No S, P or O tile
// touches shared memory. K/V tiles and the 64-key mask stream through a
// two-stage ring: every thread issues `cp.async` copies of tile j + 1 into
// the free stage right after tile j's barrier opens, so the copy runs under
// tile j's products; before it arrives at tile j + 1's `mbarrier` it waits
// for its own copies and fences them to the async proxy that `wgmma` reads
// through. Every thread arrives at a tile's barrier only after its last
// read of the tile before, so one barrier per stage both fills and frees
// it. Q is copied once with the first tile. The epilogue divides by
// max(l, 1e-37) in registers, stages O through the warpgroup's Q buffer and
// stores it with 16-byte vectors.
//
// Shared memory at D = 64 (sm90::Tile swizzled tiles, + 1 KB to align the
// base): 42,512 B for a 64-row tile (Q 8 KB, 2 x (K + V) 32 KB, the masks),
// 50,704 B for a 128-row tile. On an H100 the card's occupancy calculator
// (flash_fwd_occupancy, printed by chip_smoke.py) gives 4 and 2 resident
// blocks per SM, 16 warps either way; the old design had 3 blocks of 4.
//
// fp32 (`flash_fwd_kernel`, `--weight-dtype float32` serving only): scalar
// FMA, one block of 4 warps per 64-row q tile, Q, K/V, the score tile, P and
// the O accumulator in shared memory, each warp owning 16 rows.
//
// Bound at the BERT training cell (B = 24, L = 512, H = 12, D = 64, bf16, no
// padding) on an H100 SXM:
//   operations 4 * B * H * L^2 * D = 19.3 GFLOP -> 19.5 us at 989 TFLOP/s
//   bytes      q, k, v, o = 4 * 24 * 512 * 768 * 2 B = 75.5 MB -> 22.5 us at 3.35 TB/s
// so 0.0227 ms, set by bytes. The first design (WMMA, synchronous loads, S,
// P and O round-tripping through shared memory) took 0.471 ms there:
// per-tile serial latency times the number of waves. This one removes the
// round trips and the load stalls; chip_smoke.py measured 0.106 ms there on
// an H100 80GB HBM3 at 700 W (SDPA 0.098 ms).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_flash.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block (fp32) and per warpgroup (bf16)
constexpr int kBK = 64;        // keys per K/V tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kBQ / kWarps;  // 16
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// bf16: wgmma, register-resident S/P/O, cp.async ring
// ---------------------------------------------------------------------------

// Shared-memory map of a block with NWG warpgroups (byte offsets from a
// 1024-byte aligned base).
template <int D, int NWG>
struct FwdSmem {
  using T = sm90::Tile<D>;
  static constexpr int kTile = T::template bytes<64>();
  static constexpr int kQ = 0;                         // NWG tiles of 64 rows
  static constexpr int kK = kQ + NWG * kTile;          // 2 stages
  static constexpr int kV = kK + 2 * kTile;            // 2 stages
  static constexpr int kMask = kV + 2 * kTile;         // 2 x 64 floats
  static constexpr int kBar = kMask + 2 * kBK * 4;     // 2 mbarriers
  static constexpr int kBytes = kBar + 2 * 8;
  static constexpr int kAlloc = kBytes + 1024;         // room to align the base
};

// Key mask of keys [k0, k0 + 64) of batch row b: 1 where the key exists and
// the padding mask (null = all valid) keeps it.
__device__ __forceinline__ void store_key_mask(float* kmask, const uint8_t* __restrict__ mask,
                                               int b, int L, int k0, int tid) {
  if (tid < kBK) {
    const int key = k0 + tid;
    const bool ok = key < L && (mask == nullptr || mask[(int64_t)b * L + key] != 0);
    kmask[tid] = ok ? 1.f : 0.f;
  }
}

template <int D, int NWG>
__global__ void __launch_bounds__(NWG * 128, (D == 128 ? 2 : 4) / NWG)
    flash_fwd_sm90(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                   bf16* __restrict__ o, float* __restrict__ lse, int L, int H,
                   float scale_log2) {
  using S = FwdSmem<D, NWG>;
  using T = sm90::Tile<D>;
  constexpr int kNT = NWG * 128;
  constexpr int kN = T::kAtomCols / 2;  // O accumulator floats per atom
  extern __shared__ __align__(1024) unsigned char smem_sm90[];
  unsigned char* smem_raw = smem_sm90;
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* kmask = reinterpret_cast<float*>(smem_raw + (base - raw) + S::kMask);
  const uint32_t bar = base + S::kBar;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int lane = tid % 32;
  const int wrow = (tid % 128) / 32 * 16;  // the warp's first row in its warpgroup
  const int q0 = blockIdx.x * 64 * NWG;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int64_t row_stride = (int64_t)H * D;
  const int64_t head_base = (int64_t)b * L * row_stride + (int64_t)h * D;
  const uint32_t q_tile = base + S::kQ + wg * S::kTile;

  if (tid == 0) {
    sm90::mbar_init(bar, kNT);
    sm90::mbar_init(bar + 8, kNT);
    sm90::mbar_init_fence();
  }
  __syncthreads();

  // Prologue: Q and the first K/V tile and mask.
#pragma unroll
  for (int w = 0; w < NWG; ++w) {
    sm90::copy_tile<D, 64, kNT>(base + S::kQ + w * S::kTile, q + head_base, q0 + 64 * w, L,
                                row_stride, tid);
  }
  sm90::copy_tile<D, 64, kNT>(base + S::kK, k + head_base, 0, L, row_stride, tid);
  sm90::copy_tile<D, 64, kNT>(base + S::kV, v + head_base, 0, L, row_stride, tid);
  store_key_mask(kmask, mask, b, L, 0, tid);
  sm90::cp_async_commit();

  float acc[T::kAtoms][kN];
#pragma unroll
  for (int a = 0; a < T::kAtoms; ++a) {
#pragma unroll
    for (int i = 0; i < kN; ++i) acc[a][i] = 0.f;
  }
  float m[2] = {kNeg, kNeg};
  float l[2] = {0.f, 0.f};

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

    // S = Q K^T for this warpgroup's 64 rows.
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    __syncwarp();
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      sm90::wgmma_ss(s, T::template desc_k<64>(q_tile, kk), T::template desc_k<64>(k_tile, kk),
                     1);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(s);

    // Online softmax in registers: this thread's rows wrow + lane/4 (+ 8).
    float kv[16];  // the mask of this thread's 16 columns
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float2 two = *reinterpret_cast<const float2*>(km + 8 * c + 2 * (lane % 4));
      kv[2 * c] = two.x;
      kv[2 * c + 1] = two.y;
    }
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float x = kv[2 * (i / 4) + i % 2] != 0.f ? s[i] * scale_log2 : kNeg;
      s[i] = x;
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], x);
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = exp2f(s[i] - m[(i / 2) % 2]) * kv[2 * (i / 4) + i % 2];
      s[i] = p;
      sum[(i / 2) % 2] += p;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * corr[r] + sum[r];
    }
#pragma unroll
    for (int a = 0; a < T::kAtoms; ++a) {
#pragma unroll
      for (int i = 0; i < kN; ++i) acc[a][i] *= corr[(i / 2) % 2];
    }

    // O += P V, P (bf16) from registers, V MN-major from shared memory.
    uint32_t p[4][4];
    sm90::to_a_operand(s, p);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
      for (int a = 0; a < T::kAtoms; ++a) {
        sm90::wgmma_rs(acc[a], p[kk], T::template desc_mn<64>(v_tile, a, kk));
      }
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
#pragma unroll
    for (int a = 0; a < T::kAtoms; ++a) sm90::fence_regs(acc[a]);
    sm90::fence_regs(p);
  }

  // Epilogue: O / max(l, 1e-37) to bf16, staged in this warpgroup's Q tile.
  float safe[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) safe[r] = fmaxf(l[r], 1e-37f);
  unsigned char* stage = smem_raw + (q_tile - raw);
  sm90::warpgroup_sync(wg);  // every warp's last product has read Q
#pragma unroll
  for (int a = 0; a < T::kAtoms; ++a) {
#pragma unroll
    for (int i = 0; i < kN; i += 2) {
      const int r = wrow + sm90::acc_row(lane, i);
      const int c = a * T::kAtomCols + sm90::acc_col(lane, i);
      const float sf = safe[(i / 2) % 2];
      *reinterpret_cast<__nv_bfloat162*>(stage + T::template offset<64>(r, c)) =
          __floats2bfloat162_rn(acc[a][i] / sf, acc[a][i + 1] / sf);
    }
  }
  if (lane % 4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + 64 * wg + wrow + lane / 4 + 8 * r;
      if (row < L) {
        lse[((int64_t)b * H + h) * L + row] =
            l[r] > 0.f ? m[r] / kLog2e + logf(safe[r]) : kNeg;
      }
    }
  }
  sm90::warpgroup_sync(wg);
  constexpr int kPerRow = D / 8;
  for (int i = tid % 128; i < 64 * kPerRow; i += 128) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * 8;
    const int row = q0 + 64 * wg + r;
    if (row < L) {
      *reinterpret_cast<uint4*>(o + head_base + (int64_t)row * row_stride + c) =
          *reinterpret_cast<const uint4*>(stage + T::template offset<64>(r, c));
    }
  }
}

// Rows of q tile per block: 128 when the grid of 128-row blocks gives every
// SM at least one, else 64.
int auto_q_tile(int B, int L, int H) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const long long blocks128 = (long long)((L + 127) / 128) * H * B;
  return blocks128 >= sms ? 128 : 64;
}

template <int D, int NWG>
cudaError_t set_smem_sm90() {
  return cudaFuncSetAttribute(flash_fwd_sm90<D, NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              FwdSmem<D, NWG>::kAlloc);
}

template <int D, int NWG>
cudaError_t launch_sm90(const void* q, const void* k, const void* v, const void* mask, void* o,
                        void* lse, int B, int L, int H, float scale_log2, cudaStream_t stream) {
  cudaError_t err = set_smem_sm90<D, NWG>();
  if (err != cudaSuccess) return err;
  const dim3 grid((L + 64 * NWG - 1) / (64 * NWG), H, B);
  flash_fwd_sm90<D, NWG><<<grid, NWG * 128, FwdSmem<D, NWG>::kAlloc, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const uint8_t*>(mask), static_cast<bf16*>(o), static_cast<float*>(lse), L, H,
      scale_log2);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(int q_tile, const void* q, const void* k, const void* v,
                        const void* mask, void* o, void* lse, int B, int L, int H,
                        float scale_log2, cudaStream_t stream) {
  if (q_tile == 0) q_tile = auto_q_tile(B, L, H);
  if (q_tile == 64) return launch_sm90<D, 1>(q, k, v, mask, o, lse, B, L, H, scale_log2, stream);
  if (q_tile == 128) return launch_sm90<D, 2>(q, k, v, mask, o, lse, B, L, H, scale_log2, stream);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// fp32: scalar FMA through shared memory
// ---------------------------------------------------------------------------

// Shared-memory layout. Every row stride carries a 16-byte pad against
// bank conflicts.
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
  for (int idx = lane; idx < kRowsPerWarp * kBK; idx += 32) {
    const int r = r0 + idx / kBK;
    const int c = idx % kBK;
    const T* qr = sm.q + r * S::kLdT;
    const T* kr = sm.k + c * S::kLdT;
    float acc = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) acc = fmaf(qr[d], kr[d], acc);
    sm.s[r * S::kLdS + c] = acc;
  }
}

// Online-softmax step for this warp's 16 rows: two lanes per row, 32 keys
// each. Writes P, updates m and l, rescales the O rows.
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
    prow[c0 + i] = p;
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
  for (int idx = lane; idx < kRowsPerWarp * D; idx += 32) {
    const int r = r0 + idx / D;
    const int d = idx % D;
    const T* pr = sm.p + r * S::kLdP;
    float acc = sm.o[r * S::kLdO + d];
#pragma unroll 8
    for (int c = 0; c < kBK; ++c) acc = fmaf(pr[c], sm.v[c * S::kLdT + d], acc);
    sm.o[r * S::kLdO + d] = acc;
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
    for (int d = d0; d < d0 + D / 2; ++d) og[d] = orow[d] / safe;
    if ((lane & 1) == 0) {
      lse[((int64_t)b * H + h) * L + q0 + row] = l > 0.f ? sm.m[row] / kLog2e + logf(safe) : kNeg;
    }
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* mask, void* o,
                       void* lse, int B, int L, int H, float scale_log2, cudaStream_t stream) {
  constexpr int smem = (int)sizeof(Smem<float, D>);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<float, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<float, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const uint8_t*>(mask), static_cast<float*>(o), static_cast<float*>(lse), L, H,
      scale_log2);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(int is_f32, int q_tile, const void* q, const void* k, const void* v,
                   const void* mask, void* o, void* lse, int B, int L, int H, float scale_log2,
                   cudaStream_t stream) {
  return is_f32 ? launch_f32<D>(q, k, v, mask, o, lse, B, L, H, scale_log2, stream)
                : launch_bf16<D>(q_tile, q, k, v, mask, o, lse, B, L, H, scale_log2, stream);
}

}  // namespace

// q, k, v, o: contiguous [B, L, H, D]; mask: contiguous uint8/bool [B, L]
// (nullptr = every key valid); lse: [B, H, L] f32. is_f32 selects fp32
// inputs, else bf16. q_tile: query rows per block of the bf16 kernel, 64 or
// 128, or 0 to let the launcher pick (fp32 ignores it). Returns the launch's
// cudaError_t (0 = launched).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, const void* mask, void* o,
                         void* lse, int B, int L, int H, int D, int is_f32, int q_tile,
                         float scale_log2, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return (int)launch<32>(is_f32, q_tile, q, k, v, mask, o, lse, B, L, H, scale_log2, s);
    case 64: return (int)launch<64>(is_f32, q_tile, q, k, v, mask, o, lse, B, L, H, scale_log2, s);
    case 128: return (int)launch<128>(is_f32, q_tile, q, k, v, mask, o, lse, B, L, H, scale_log2, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory and resident blocks per SM of the bf16 kernel at
// D = 64 with a q tile of 64 or 128 rows. Returns a cudaError_t.
extern "C" int flash_fwd_occupancy(int q_tile, int* smem_bytes, int* blocks_per_sm) {
  cudaError_t err;
  if (q_tile == 64) {
    err = set_smem_sm90<64, 1>();
    *smem_bytes = FwdSmem<64, 1>::kAlloc;
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, flash_fwd_sm90<64, 1>,
                                                          128, *smem_bytes);
    }
  } else if (q_tile == 128) {
    err = set_smem_sm90<64, 2>();
    *smem_bytes = FwdSmem<64, 2>::kAlloc;
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, flash_fwd_sm90<64, 2>,
                                                          256, *smem_bytes);
    }
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

extern "C" const char* flash_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
