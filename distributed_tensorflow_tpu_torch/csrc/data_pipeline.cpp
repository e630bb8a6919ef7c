// Host-side input pipeline of the PyTorch port: threaded shuffle/augment/
// prefetch, plus the CRC-32C that checks TFRecord framing.
//
// The port's own copy of the JAX package's native pipeline, built by
// ops/build.py with g++ into build/host/; it replaces no TPU kernel (it runs
// on the host CPU, bound by its cores' bilinear resampling). Batches are
// bit-identical to the JAX package's for the same arguments:
//
// - Sampling is per-epoch permutation WITHOUT replacement: stream position p
//   maps to example perm_e(p mod E) where perm_e is a Feistel-network
//   permutation of [0, n) keyed by (seed, epoch e) — O(1) per draw, no
//   shared permutation array, so any worker can compute any batch
//   independently and batch k is identical regardless of thread count.
// - Augmentation: pad-crop + horizontal flip + per-image standardization
//   (CIFAR-style), or random-resized-crop to a target size with bilinear
//   resampling + per-channel mean/std normalization (ImageNet-style).
//   Sources may be f32 or u8 (u8 enables memory-mapped ImageNet caches).
// - Finished batches stage in a bounded ring in ticket order. dp_next copies
//   the next one out into the caller's buffer (a pinned host tensor on the
//   card's path), as float32 or rounded to bfloat16 (nearest even), so the
//   Python side only issues the host->device copy. `start_ticket` lets a
//   restored run resume the stream at batch N instead of replaying 0..N-1.
//
// C ABI (ctypes-friendly), no external dependencies, C++17 + pthreads.

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <queue>
#include <random>
#include <thread>
#include <vector>

namespace {

inline uint64_t SplitMix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ULL;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

// Format-preserving permutation of [0, n) via a 4-round balanced Feistel
// network over the smallest even-bit-width domain covering n, with
// cycle-walking to stay inside [0, n). Each (seed, epoch) keys a distinct
// permutation; evaluation is O(1) per index (expected <2 walk steps), so
// workers need no shared shuffle state — the property that makes batch
// content independent of thread scheduling.
class EpochPerm {
 public:
  EpochPerm(uint64_t n, uint64_t seed, uint64_t epoch) : n_(n) {
    int bits = 1;
    while ((1ULL << bits) < n_) ++bits;
    half_bits_ = (bits + 1) / 2;
    half_mask_ = (1ULL << half_bits_) - 1;
    const uint64_t base = SplitMix64(seed ^ (epoch * 0xD1B54A32D192ED03ULL));
    for (int r = 0; r < kRounds; ++r) keys_[r] = SplitMix64(base + r);
  }

  uint64_t operator()(uint64_t x) const {
    do {
      uint64_t l = x >> half_bits_, r = x & half_mask_;
      for (int i = 0; i < kRounds; ++i) {
        const uint64_t f = SplitMix64(r ^ keys_[i]) & half_mask_;
        const uint64_t nl = r;
        r = l ^ f;
        l = nl;
      }
      x = (l << half_bits_) | r;
    } while (x >= n_);  // cycle-walk: revisits stay a bijection on [0, n)
    return x;
  }

 private:
  static constexpr int kRounds = 4;
  uint64_t n_, half_mask_, keys_[4];
  int half_bits_;
};

// float32 -> bfloat16 bits, round to nearest even (ml_dtypes' and torch's
// conversion); NaN stays a quiet NaN of the same sign.
inline uint16_t ToBf16(float f) {
  uint32_t u;
  std::memcpy(&u, &f, sizeof(u));
  if ((u & 0x7FFFFFFFu) > 0x7F800000u) return uint16_t((u >> 16) | 0x40u);
  u += 0x7FFFu + ((u >> 16) & 1u);
  return uint16_t(u >> 16);
}

// CRC-32C (Castagnoli, reflected polynomial 0x82F63B78), slicing by 8: the
// checksum TFRecord framing carries (masked) for each length and payload.
class Crc32cTables {
 public:
  Crc32cTables() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1u)));
      t_[0][i] = c;
    }
    for (int s = 1; s < 8; ++s) {
      for (int i = 0; i < 256; ++i) {
        t_[s][i] = (t_[s - 1][i] >> 8) ^ t_[0][t_[s - 1][i] & 0xFFu];
      }
    }
  }

  uint32_t Extend(uint32_t crc, const uint8_t* p, uint64_t n) const {
    crc = ~crc;
    while (n >= 8) {
      uint32_t lo, hi;
      std::memcpy(&lo, p, 4);
      std::memcpy(&hi, p + 4, 4);
      lo ^= crc;  // little-endian host
      crc = t_[7][lo & 0xFFu] ^ t_[6][(lo >> 8) & 0xFFu] ^
            t_[5][(lo >> 16) & 0xFFu] ^ t_[4][lo >> 24] ^
            t_[3][hi & 0xFFu] ^ t_[2][(hi >> 8) & 0xFFu] ^
            t_[1][(hi >> 16) & 0xFFu] ^ t_[0][hi >> 24];
      p += 8;
      n -= 8;
    }
    while (n--) crc = (crc >> 8) ^ t_[0][(crc ^ *p++) & 0xFFu];
    return ~crc;
  }

 private:
  uint32_t t_[8][256];
};

struct Batch {
  std::vector<float> images;
  std::vector<int32_t> labels;
};

struct Config {
  const void* images;     // [n, h, w, c] contiguous, f32 or u8
  const int32_t* labels;  // [n]
  int64_t n;
  int h, w, c;            // source geometry
  int out_h, out_w;       // output geometry (== h, w unless cropping/resizing)
  int batch;              // examples per emitted batch (this host's share)
  int pad;                // pad-crop margin (0 = off; CIFAR-style)
  int flip;               // 1 = random horizontal flip
  int standardize;        // 1 = per-image mean/std normalization
  int rrc;                // 1 = random-resized-crop to (out_h, out_w)
  float rrc_min_area;     // min crop area fraction for rrc (e.g. 0.08)
  int src_u8;             // 1 = source pixels are u8 (scaled by 1/255)
  const float* mean;      // per-channel mean ([c]) or null
  const float* stddev;    // per-channel std  ([c]) or null
  uint64_t seed;
  // Multi-host epoch layout: stream position of example i of ticket t is
  //   offset + (t % batches_per_epoch) * stride + i,  epoch = t / bpe
  // where bpe = epoch_examples / stride. Single host: offset 0, stride ==
  // batch. Host k of m: offset = k * batch, stride = m * batch — all hosts
  // share one permutation and read disjoint slices, the explicit form of
  // tf.data's shard(num_hosts, host_id) idiom.
  uint64_t stream_offset;
  uint64_t stream_stride;
};

class Pipeline {
 public:
  Pipeline(const Config& cfg, int n_threads, int queue_cap, uint64_t start_ticket)
      : cfg_(cfg),
        cap_(queue_cap),
        stop_(false),
        next_ticket_(start_ticket),
        next_out_(start_ticket) {
    if (cfg_.stream_stride == 0) cfg_.stream_stride = cfg_.batch;
    // Per-epoch examples: whole strides only (drop-tail, like the numpy
    // loader) so every epoch is the same static batch count.
    batches_per_epoch_ = cfg_.n / cfg_.stream_stride;
    if (batches_per_epoch_ == 0) batches_per_epoch_ = 1;  // n < stride: wrap
    if (n_threads < 1) n_threads = 1;
    for (int t = 0; t < n_threads; ++t) {
      workers_.emplace_back([this] { Work(); });
    }
  }

  ~Pipeline() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_space_.notify_all();
    cv_data_.notify_all();
    for (auto& th : workers_) th.join();
  }

  // Blocks until the next in-order batch is staged, then copies it out:
  // float32, or bfloat16 (uint16 bits) when out_bf16. Returns 1 on success,
  // 0 if the pipeline was stopped (outputs untouched — the caller must not
  // read them).
  int Next(void* out_images, int32_t* out_labels, int out_bf16) {
    std::unique_lock<std::mutex> lk(mu_);
    cv_data_.wait(lk, [this] { return stop_ || !ready_.empty(); });
    if (stop_ && ready_.empty()) return 0;
    Batch b = std::move(ready_.front());
    ready_.pop();
    lk.unlock();
    // notify_all: only the worker holding ticket == next_out_ can proceed;
    // notify_one could wake a different one, which re-sleeps, and the
    // eligible worker would wait forever — permanent stall.
    cv_space_.notify_all();
    if (out_bf16) {
      uint16_t* dst = static_cast<uint16_t*>(out_images);
      for (size_t i = 0; i < b.images.size(); ++i) dst[i] = ToBf16(b.images[i]);
    } else {
      std::memcpy(out_images, b.images.data(), b.images.size() * sizeof(float));
    }
    std::memcpy(out_labels, b.labels.data(), b.labels.size() * sizeof(int32_t));
    return 1;
  }

 private:
  // Deterministic per-ticket RNG: batch k is identical regardless of thread
  // count or interleaving — reproducibility is part of the framework's
  // contract (the reference's async input raced; see SURVEY.md §4).
  void Work() {
    const int64_t out_elems = int64_t(cfg_.out_h) * cfg_.out_w * cfg_.c;
    while (true) {
      const uint64_t ticket = next_ticket_.fetch_add(1);
      Batch b;
      b.images.resize(size_t(cfg_.batch) * out_elems);
      b.labels.resize(cfg_.batch);
      std::mt19937_64 rng(SplitMix64(cfg_.seed ^ (ticket * 0x9E3779B97F4A7C15ULL)));
      const uint64_t epoch = ticket / batches_per_epoch_;
      const uint64_t slot = ticket % batches_per_epoch_;
      const EpochPerm perm(cfg_.n, cfg_.seed, epoch);
      for (int i = 0; i < cfg_.batch; ++i) {
        const uint64_t pos =
            (cfg_.stream_offset + slot * cfg_.stream_stride + i) % cfg_.n;
        const int64_t idx = int64_t(perm(pos));
        float* dst = b.images.data() + int64_t(i) * out_elems;
        Augment(idx, dst, rng);
        b.labels[i] = cfg_.labels[idx];
      }
      // Stage in ticket order so output order is deterministic.
      std::unique_lock<std::mutex> lk(mu_);
      cv_space_.wait(lk, [this, ticket] {
        return stop_ ||
               (ticket == next_out_ && ready_.size() < size_t(cap_));
      });
      if (stop_) return;
      ready_.push(std::move(b));
      ++next_out_;
      lk.unlock();
      cv_data_.notify_one();
      cv_space_.notify_all();
    }
  }

  inline float SrcPx(int64_t img, int y, int x, int ch) const {
    const int64_t off =
        ((img * cfg_.h + y) * int64_t(cfg_.w) + x) * cfg_.c + ch;
    if (cfg_.src_u8) {
      return static_cast<const uint8_t*>(cfg_.images)[off] * (1.0f / 255.0f);
    }
    return static_cast<const float*>(cfg_.images)[off];
  }

  void Augment(int64_t idx, float* dst, std::mt19937_64& rng) {
    if (cfg_.rrc || cfg_.out_h != cfg_.h || cfg_.out_w != cfg_.w) {
      CropResize(idx, dst, rng);
    } else {
      PadCrop(idx, dst, rng);
    }
    const int64_t n = int64_t(cfg_.out_h) * cfg_.out_w * cfg_.c;
    if (cfg_.mean && cfg_.stddev) {
      for (int64_t i = 0; i < n; ++i) {
        const int ch = i % cfg_.c;
        dst[i] = (dst[i] - cfg_.mean[ch]) / cfg_.stddev[ch];
      }
    }
    if (cfg_.standardize) {
      double sum = 0, sq = 0;
      for (int64_t i = 0; i < n; ++i) sum += dst[i];
      const double mean = sum / n;
      for (int64_t i = 0; i < n; ++i) {
        const double v = dst[i] - mean;
        sq += v * v;
      }
      // tf.image.per_image_standardization's adjusted stddev floor.
      const double stddev = std::max(std::sqrt(sq / n), 1.0 / std::sqrt((double)n));
      for (int64_t i = 0; i < n; ++i) {
        dst[i] = float((dst[i] - mean) / stddev);
      }
    }
  }

  // CIFAR-style: reflect nothing, zero-pad margin, random crop + flip.
  void PadCrop(int64_t idx, float* dst, std::mt19937_64& rng) {
    const int h = cfg_.h, w = cfg_.w, c = cfg_.c;
    int dy = 0, dx = 0;
    bool flip = false;
    if (cfg_.pad > 0) {
      dy = std::uniform_int_distribution<int>(-cfg_.pad, cfg_.pad)(rng);
      dx = std::uniform_int_distribution<int>(-cfg_.pad, cfg_.pad)(rng);
    }
    if (cfg_.flip) flip = std::uniform_int_distribution<int>(0, 1)(rng) != 0;
    for (int y = 0; y < h; ++y) {
      const int sy = y + dy;
      for (int x = 0; x < w; ++x) {
        int sx = flip ? (w - 1 - x) + dx : x + dx;
        float* d = dst + (int64_t(y) * w + x) * c;
        if (sy < 0 || sy >= h || sx < 0 || sx >= w) {
          std::memset(d, 0, sizeof(float) * c);
        } else {
          for (int ch = 0; ch < c; ++ch) d[ch] = SrcPx(idx, sy, sx, ch);
        }
      }
    }
  }

  // ImageNet-style: random-resized-crop (scale in [min_area, 1], aspect in
  // [3/4, 4/3], 10 attempts then center fallback — the standard Inception
  // crop) or, when rrc == 0, a center crop; bilinear resample to
  // (out_h, out_w); optional flip folded into the sampling.
  void CropResize(int64_t idx, float* dst, std::mt19937_64& rng) {
    const int h = cfg_.h, w = cfg_.w, c = cfg_.c;
    const int oh = cfg_.out_h, ow = cfg_.out_w;
    int cy = 0, cx = 0, ch_ = h, cw_ = w;
    if (cfg_.rrc) {
      std::uniform_real_distribution<float> u01(0.0f, 1.0f);
      bool found = false;
      for (int attempt = 0; attempt < 10 && !found; ++attempt) {
        const float area = float(h) * w;
        const float target =
            area * (cfg_.rrc_min_area +
                    u01(rng) * (1.0f - cfg_.rrc_min_area));
        const float log_r = std::log(3.0f / 4.0f) +
                            u01(rng) * (std::log(4.0f / 3.0f) - std::log(3.0f / 4.0f));
        const float ratio = std::exp(log_r);
        const int tw = int(std::lround(std::sqrt(target * ratio)));
        const int th = int(std::lround(std::sqrt(target / ratio)));
        if (tw > 0 && th > 0 && tw <= w && th <= h) {
          cw_ = tw;
          ch_ = th;
          cy = std::uniform_int_distribution<int>(0, h - th)(rng);
          cx = std::uniform_int_distribution<int>(0, w - tw)(rng);
          found = true;
        }
      }
      if (!found) {  // center fallback
        ch_ = cw_ = std::min(h, w);
        cy = (h - ch_) / 2;
        cx = (w - cw_) / 2;
      }
    } else {
      ch_ = cw_ = std::min(h, w);
      cy = (h - ch_) / 2;
      cx = (w - cw_) / 2;
    }
    bool flip = false;
    if (cfg_.flip) flip = std::uniform_int_distribution<int>(0, 1)(rng) != 0;
    // Bilinear resample crop box -> (oh, ow), align_corners=false convention.
    // Source coordinates clamp to the CROP WINDOW, not the full image: the
    // crop is resized in isolation (torchvision/TF RRC convention), so border
    // output pixels never blend content from outside the sampled box. The
    // clamp also happens BEFORE floor/frac: an unclamped floor at fy < cy
    // (upscale at the box's top/left edge) would invert the blend weights.
    const float sy_scale = float(ch_) / oh, sx_scale = float(cw_) / ow;
    for (int y = 0; y < oh; ++y) {
      float fy = (y + 0.5f) * sy_scale - 0.5f + cy;
      fy = std::max(float(cy), std::min(float(cy + ch_ - 1), fy));
      const int y0 = int(fy);
      const int y1 = std::min(cy + ch_ - 1, y0 + 1);
      const float wy = fy - y0;
      for (int x = 0; x < ow; ++x) {
        const int xo = flip ? (ow - 1 - x) : x;
        float fx = (x + 0.5f) * sx_scale - 0.5f + cx;
        fx = std::max(float(cx), std::min(float(cx + cw_ - 1), fx));
        const int x0 = int(fx);
        const int x1 = std::min(cx + cw_ - 1, x0 + 1);
        const float wx = fx - x0;
        float* d = dst + (int64_t(y) * ow + xo) * c;
        for (int chn = 0; chn < c; ++chn) {
          const float p00 = SrcPx(idx, y0, x0, chn);
          const float p01 = SrcPx(idx, y0, x1, chn);
          const float p10 = SrcPx(idx, y1, x0, chn);
          const float p11 = SrcPx(idx, y1, x1, chn);
          d[chn] = p00 * (1 - wy) * (1 - wx) + p01 * (1 - wy) * wx +
                   p10 * wy * (1 - wx) + p11 * wy * wx;
        }
      }
    }
  }

  Config cfg_;
  int cap_;
  bool stop_;
  uint64_t batches_per_epoch_;
  std::atomic<uint64_t> next_ticket_;
  uint64_t next_out_;
  std::vector<std::thread> workers_;
  std::queue<Batch> ready_;
  std::mutex mu_;
  std::condition_variable cv_data_, cv_space_;
};

}  // namespace

extern "C" {

void* dp_create(const void* images, const int32_t* labels, int64_t n, int h,
                int w, int c, int out_h, int out_w, int batch, int pad,
                int flip, int standardize, int rrc, float rrc_min_area,
                int src_u8, const float* mean, const float* stddev,
                uint64_t seed, uint64_t stream_offset, uint64_t stream_stride,
                uint64_t start_ticket, int n_threads, int queue_cap) {
  Config cfg{images,  labels, n,
             h,       w,      c,
             out_h,   out_w,  batch,
             pad,     flip,   standardize,
             rrc,     rrc_min_area, src_u8,
             mean,    stddev, seed,
             stream_offset,   stream_stride};
  return new Pipeline(cfg, n_threads, queue_cap, start_ticket);
}

int dp_next(void* handle, void* out_images, int32_t* out_labels, int out_bf16) {
  return static_cast<Pipeline*>(handle)->Next(out_images, out_labels, out_bf16);
}

void dp_destroy(void* handle) { delete static_cast<Pipeline*>(handle); }

// CRC-32C of n bytes continuing from crc (0 to start).
uint32_t dp_crc32c(const uint8_t* data, uint64_t n, uint32_t crc) {
  static const Crc32cTables tables;
  return tables.Extend(crc, data, n);
}

}  // extern "C"
