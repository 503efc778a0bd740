// Native host-side data loader — C++ runtime component.
//
// TPU-native counterpart of the reference's host-side DataLoader
// (BASELINE.json:5): the TPU compute path is XLA/Pallas, but batch
// assembly is host CPU work, so it is native code here exactly as it is
// in the reference. Two modes:
//
//  - synthetic: xoshiro256++-derived uniform floats + integer labels,
//    deterministic in (seed, batch_index) — mirrors the Python
//    SyntheticImages contract (index-addressable => step-exact resume);
//  - file: fixed-size binary records (CIFAR-10 layout: label byte(s) +
//    uint8 sample payload), shuffled per epoch with a seeded
//    Fisher-Yates permutation, normalized to float32 in [0, 1).
//
// Batches are produced by a small worker pool into a ring of
// preallocated slots; the consumer thread blocks on the slot for the
// next index. Every batch is computed purely from its index, so workers
// need no shared mutable state beyond the claim counter, and
// start(index) gives exact resume. Exposed as a C ABI for ctypes
// (no pybind11 in this image).
//
// Build: g++ -O3 -shared -fPIC -pthread -std=c++17 loader.cc -o ddl_loader.so

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <numeric>
#include <stdexcept>
#include <string>
#include <memory>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

// splitmix64: seeds the per-batch generator from (seed, index) so any
// batch is computable independently (no sequential RNG state).
inline uint64_t splitmix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ull;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ull;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebull;
  return x ^ (x >> 31);
}

struct Rng {  // xoshiro256++
  uint64_t s[4];
  explicit Rng(uint64_t seed) {
    for (int i = 0; i < 4; ++i) s[i] = seed = splitmix64(seed);
  }
  static inline uint64_t rotl(uint64_t x, int k) {
    return (x << k) | (x >> (64 - k));
  }
  uint64_t next() {
    uint64_t result = rotl(s[0] + s[3], 23) + s[0];
    uint64_t t = s[1] << 17;
    s[2] ^= s[0]; s[3] ^= s[1]; s[1] ^= s[2]; s[0] ^= s[3]; s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return result;
  }
  float uniform() {  // [0, 1)
    return (next() >> 40) * (1.0f / (1ull << 24));
  }
  int64_t below(int64_t n) { return static_cast<int64_t>(next() % n); }
};

struct Config {
  int64_t batch = 0;
  int64_t sample_floats = 0;  // floats per sample in the output buffer
  int64_t num_classes = 0;
  uint64_t seed = 0;
  int threads = 2;
  int depth = 4;  // prefetch ring depth
  // file mode
  std::string path;
  int64_t record_bytes = 0;
  int64_t label_bytes = 0;  // leading bytes holding the label (LE int)
  bool shuffle = true;
  // Training augmentation (random zero-pad+crop / horizontal flip) applied
  // by the worker threads — bit-exact with data.augment_images (same
  // splitmix64 draw per GLOBAL sample index, same crop geometry), so the
  // numpy and native paths stay interchangeable mid-training.
  bool aug = false;
  int64_t aug_pad = 4;
  int64_t img_h = 0, img_w = 0, img_c = 0;
  bool chw = true;  // payload layout: channel-major (CIFAR) vs pixel-major
};

class Loader {
 public:
  explicit Loader(Config cfg) : cfg_(std::move(cfg)) {
    // One in-flight claim per worker; more workers than ring slots would
    // let two claims race for the same slot.
    if (cfg_.threads > cfg_.depth) cfg_.threads = cfg_.depth;
    if (cfg_.threads < 1) cfg_.threads = 1;
    if (!cfg_.path.empty()) {
      FILE* f = std::fopen(cfg_.path.c_str(), "rb");
      if (!f) throw std::runtime_error("cannot open " + cfg_.path);
      std::fseek(f, 0, SEEK_END);
      int64_t size = std::ftell(f);
      std::fseek(f, 0, SEEK_SET);
      num_records_ = size / cfg_.record_bytes;
      if (num_records_ <= 0 || size % cfg_.record_bytes != 0) {
        // Misaligned size means a wrong record_bytes config: truncating
        // would silently misalign every record boundary.
        std::fclose(f);
        throw std::runtime_error("bad record file " + cfg_.path);
      }
      file_.resize(static_cast<size_t>(num_records_) * cfg_.record_bytes);
      if (std::fread(file_.data(), 1, file_.size(), f) != file_.size()) {
        std::fclose(f);
        throw std::runtime_error("short read on " + cfg_.path);
      }
      std::fclose(f);
    }
    for (int i = 0; i < cfg_.depth; ++i) {
      auto s = std::make_unique<Slot>();
      s->data.resize(cfg_.batch * cfg_.sample_floats);
      s->labels.resize(cfg_.batch);
      s->index.store(-1, std::memory_order_relaxed);
      slots_.push_back(std::move(s));
    }
  }

  ~Loader() { Stop(); }

  int64_t num_records() const { return num_records_; }

  // Call before Start()/Fill(): workers read these fields unlocked.
  void EnableAugment(int64_t pad, int64_t h, int64_t w, int64_t c, bool chw) {
    cfg_.aug = true;
    cfg_.aug_pad = pad;
    cfg_.img_h = h;
    cfg_.img_w = w;
    cfg_.img_c = c;
    cfg_.chw = chw;
  }

  // Fill caller buffers synchronously with batch `index` (used for
  // batch(i) shape probes and as the determinism oracle in tests).
  void Fill(int64_t index, float* data, int32_t* labels) {
    FillBuffers(index, data, labels);
  }

  void Start(int64_t start_index) {
    Stop();
    // next_m_ serializes this reset against Next()'s claim, and the bumped
    // generation invalidates any consumer still blocked from the previous
    // stream (its wait predicate checks gen_), so a stale consumer can
    // neither re-sleep past the restart nor steal the new stream's batches.
    std::lock_guard<std::mutex> lk(next_m_);
    gen_.fetch_add(1, std::memory_order_release);
    stop_.store(false, std::memory_order_relaxed);
    next_claim_.store(start_index, std::memory_order_relaxed);
    next_out_ = start_index;
    start_ = start_index;
    for (auto& s : slots_) s->index.store(kFresh, std::memory_order_relaxed);
    for (int i = 0; i < cfg_.threads; ++i)
      workers_.emplace_back([this] { WorkerLoop(); });
  }

  // Copy the next batch (in index order) into caller buffers.
  // Returns the batch index, or -1 if Stop() or a superseding Start()
  // interrupted the wait (so a consumer blocked here can neither deadlock
  // a concurrent Stop()/destructor nor cross into a restarted stream).
  int64_t Next(float* data, int32_t* labels) {
    int64_t gen, want;
    {
      // Claim atomically with the generation snapshot: a Start() reset
      // either happens entirely before (new-gen claim, valid) or entirely
      // after (old-gen claim, predicate below bails with -1).
      std::lock_guard<std::mutex> claim(next_m_);
      gen = gen_.load(std::memory_order_acquire);
      want = next_out_++;
    }
    Slot& slot = *slots_[want % slots_.size()];
    {
      std::unique_lock<std::mutex> lk(slot.m);
      slot.cv.wait(lk, [&] {
        return stop_.load(std::memory_order_relaxed) ||
               gen_.load(std::memory_order_acquire) != gen ||
               slot.index.load(std::memory_order_acquire) == want;
      });
      if (gen_.load(std::memory_order_acquire) != gen ||
          slot.index.load(std::memory_order_acquire) != want) {
        return -1;  // stream stopped or superseded; nothing consumed
      }
      std::memcpy(data, slot.data.data(), slot.data.size() * sizeof(float));
      std::memcpy(labels, slot.labels.data(),
                  slot.labels.size() * sizeof(int32_t));
      // Record WHICH batch was consumed (encoded negative): the worker
      // holding claim `want + depth` — and only that one — may refill.
      slot.index.store(Consumed(want), std::memory_order_release);
    }
    slot.cv.notify_all();
    return want;
  }

  void Stop() {
    stop_.store(true, std::memory_order_relaxed);
    for (auto& s : slots_) {
      // Lock-then-notify: without taking the slot mutex a waiter that has
      // evaluated its predicate (stop_ still false) but not yet gone to
      // sleep would miss this notification forever (lost-wakeup race).
      { std::lock_guard<std::mutex> lk(s->m); }
      s->cv.notify_all();
    }
    for (auto& t : workers_) t.join();
    workers_.clear();
  }

 private:
  struct Slot {
    std::mutex m;
    std::condition_variable cv;
    std::atomic<int64_t> index{-1};
    std::vector<float> data;
    std::vector<int32_t> labels;
  };

  static constexpr int64_t kFresh = -1;
  static int64_t Consumed(int64_t batch) { return -batch - 2; }

  void WorkerLoop() {
    while (!stop_.load(std::memory_order_relaxed)) {
      int64_t idx = next_claim_.fetch_add(1, std::memory_order_relaxed);
      Slot& slot = *slots_[idx % slots_.size()];
      int64_t depth = static_cast<int64_t>(slots_.size());
      std::unique_lock<std::mutex> lk(slot.m);
      // Strict turn order per slot: claim `idx` may fill only a fresh slot
      // (first lap) or one whose previous occupant `idx - depth` was
      // consumed. Claims `depth` apart map to the same slot, so a plain
      // "slot is free" check would let a later claim overtake an earlier
      // one and deadlock the consumer.
      slot.cv.wait(lk, [&] {
        int64_t cur = slot.index.load(std::memory_order_acquire);
        return stop_.load(std::memory_order_relaxed) ||
               (cur == kFresh && idx - start_ < depth) ||
               cur == Consumed(idx - depth);
      });
      if (stop_.load(std::memory_order_relaxed)) return;
      FillBuffers(idx, slot.data.data(), slot.labels.data());
      slot.index.store(idx, std::memory_order_release);
      lk.unlock();
      slot.cv.notify_all();
    }
  }

  void FillBuffers(int64_t index, float* data, int32_t* labels) {
    if (file_.empty()) {
      Rng rng(splitmix64(cfg_.seed) ^ static_cast<uint64_t>(index));
      int64_t n = cfg_.batch * cfg_.sample_floats;
      for (int64_t i = 0; i < n; ++i) data[i] = rng.uniform();
      for (int64_t i = 0; i < cfg_.batch; ++i)
        labels[i] = static_cast<int32_t>(rng.below(cfg_.num_classes));
    } else {
      int64_t payload = cfg_.record_bytes - cfg_.label_bytes;
      // A batch touches at most two consecutive epochs; fetch their
      // permutations once (two lock acquisitions) instead of per sample.
      int64_t first_epoch = (index * cfg_.batch) / num_records_;
      int64_t last_epoch =
          (index * cfg_.batch + cfg_.batch - 1) / num_records_;
      std::shared_ptr<const std::vector<int32_t>> perm_a, perm_b;
      if (cfg_.shuffle) {
        perm_a = GetPerm(first_epoch);
        perm_b = last_epoch == first_epoch ? perm_a : GetPerm(last_epoch);
      }
      for (int64_t i = 0; i < cfg_.batch; ++i) {
        int64_t global = index * cfg_.batch + i;
        int64_t epoch = global / num_records_;
        int64_t pos = global % num_records_;
        int64_t rec =
            cfg_.shuffle
                ? (*(epoch == first_epoch ? perm_a : perm_b))[pos]
                : pos;
        const uint8_t* p = file_.data() + rec * cfg_.record_bytes;
        int64_t label = 0;
        for (int64_t b = 0; b < cfg_.label_bytes; ++b)
          label |= static_cast<int64_t>(p[b]) << (8 * b);
        labels[i] = static_cast<int32_t>(label);
        float* out = data + i * cfg_.sample_floats;
        const uint8_t* s = p + cfg_.label_bytes;
        if (cfg_.aug) {
          AugmentSample(global, s, out);
        } else {
          for (int64_t b = 0; b < payload; ++b)
            out[b] = s[b] * (1.0f / 255.0f);
        }
      }
    }
  }

  // Random zero-pad+crop and horizontal flip for one sample, gathered
  // directly from the uint8 payload into the normalized float output.
  // The (dy, dx, flip) draw is data.augment_bits verbatim:
  //   h = splitmix64(global ^ splitmix64(seed)); span = 2*pad + 1;
  //   dy = h % span; dx = (h >> 16) % span; flip = (h >> 32) & 1.
  // Output pixel (y, x) reads padded(dy + y, dx + x), i.e. source
  // (dy + y - pad, dx + x' - pad) with x' pre-flipped, zeros outside.
  void AugmentSample(int64_t global, const uint8_t* s, float* out) const {
    const int64_t H = cfg_.img_h, W = cfg_.img_w, C = cfg_.img_c;
    const int64_t pad = cfg_.aug_pad;
    const uint64_t span = static_cast<uint64_t>(2 * pad + 1);
    const uint64_t h64 =
        splitmix64(static_cast<uint64_t>(global) ^ splitmix64(cfg_.seed));
    const int64_t dy = static_cast<int64_t>(h64 % span);
    const int64_t dx = static_cast<int64_t>((h64 >> 16) % span);
    const bool flip = ((h64 >> 32) & 1ull) != 0;
    for (int64_t y = 0; y < H; ++y) {
      const int64_t sy = y + dy - pad;
      const bool row_ok = sy >= 0 && sy < H;
      for (int64_t x = 0; x < W; ++x) {
        const int64_t xx = flip ? (W - 1 - x) : x;
        const int64_t sx = xx + dx - pad;
        const bool ok = row_ok && sx >= 0 && sx < W;
        for (int64_t c = 0; c < C; ++c) {
          const int64_t dst = cfg_.chw ? (c * H * W + y * W + x)
                                       : ((y * W + x) * C + c);
          if (ok) {
            const int64_t src = cfg_.chw ? (c * H * W + sy * W + sx)
                                         : ((sy * W + sx) * C + c);
            out[dst] = s[src] * (1.0f / 255.0f);
          } else {
            out[dst] = 0.0f;
          }
        }
      }
    }
  }

  // The epoch's Fisher-Yates permutation, cached. shared_ptr so a caller
  // can keep indexing lock-free while another thread prunes the cache.
  std::shared_ptr<const std::vector<int32_t>> GetPerm(int64_t epoch) {
    std::lock_guard<std::mutex> lk(perm_m_);
    auto it = perms_.find(epoch);
    if (it == perms_.end()) {
      auto perm = std::make_shared<std::vector<int32_t>>(num_records_);
      std::iota(perm->begin(), perm->end(), 0);
      Rng rng(splitmix64(cfg_.seed ^ 0xda7a5e7ull) ^
              static_cast<uint64_t>(epoch));
      for (int64_t i = num_records_ - 1; i > 0; --i)
        std::swap((*perm)[i], (*perm)[rng.below(i + 1)]);
      if (perms_.size() > 4) perms_.clear();
      it = perms_.emplace(epoch, std::move(perm)).first;
    }
    return it->second;
  }

  Config cfg_;
  std::vector<uint8_t> file_;
  int64_t num_records_ = 0;
  std::vector<std::unique_ptr<Slot>> slots_;
  std::vector<std::thread> workers_;
  std::atomic<bool> stop_{false};
  std::atomic<int64_t> gen_{0};  // bumped by Start(); stale waiters bail
  std::atomic<int64_t> next_claim_{0};
  std::mutex next_m_;  // serializes Next() claims against Start() resets
  int64_t next_out_ = 0;
  int64_t start_ = 0;
  std::mutex perm_m_;
  std::unordered_map<int64_t, std::shared_ptr<const std::vector<int32_t>>>
      perms_;
};

}  // namespace

extern "C" {

void* ddl_loader_create_synthetic(int64_t batch, int64_t sample_floats,
                                  int64_t num_classes, uint64_t seed,
                                  int threads, int depth) {
  Config cfg;
  cfg.batch = batch;
  cfg.sample_floats = sample_floats;
  cfg.num_classes = num_classes;
  cfg.seed = seed;
  cfg.threads = threads;
  cfg.depth = depth;
  try {
    return new Loader(std::move(cfg));
  } catch (...) {
    return nullptr;
  }
}

void* ddl_loader_create_file(const char* path, int64_t batch,
                             int64_t record_bytes, int64_t label_bytes,
                             uint64_t seed, int threads, int depth,
                             int shuffle) {
  Config cfg;
  cfg.path = path;
  cfg.batch = batch;
  cfg.record_bytes = record_bytes;
  cfg.label_bytes = label_bytes;
  cfg.sample_floats = record_bytes - label_bytes;
  cfg.seed = seed;
  cfg.threads = threads;
  cfg.depth = depth;
  cfg.shuffle = shuffle != 0;
  try {
    return new Loader(std::move(cfg));
  } catch (...) {
    return nullptr;
  }
}

int64_t ddl_loader_num_records(void* loader) {
  return static_cast<Loader*>(loader)->num_records();
}

void ddl_loader_enable_augment(void* loader, int64_t pad, int64_t img_h,
                               int64_t img_w, int64_t channels, int chw) {
  static_cast<Loader*>(loader)->EnableAugment(pad, img_h, img_w, channels,
                                              chw != 0);
}

void ddl_loader_fill(void* loader, int64_t index, float* data,
                     int32_t* labels) {
  static_cast<Loader*>(loader)->Fill(index, data, labels);
}

void ddl_loader_start(void* loader, int64_t start_index) {
  static_cast<Loader*>(loader)->Start(start_index);
}

int64_t ddl_loader_next(void* loader, float* data, int32_t* labels) {
  return static_cast<Loader*>(loader)->Next(data, labels);
}

void ddl_loader_destroy(void* loader) { delete static_cast<Loader*>(loader); }

}  // extern "C"
