// rollloader — native data-loading runtime of midi_vae_tpu_torch, a copy of
// the JAX package's midi_vae_tpu/native/rollloader.cc (same C ABI, same
// shuffle, so both packages serve the same batches for a seed).
//
// A threaded, mmap-backed batch assembler over a raw on-disk tensor format
// ("RRD"), in place of DataLoader worker processes. Rationale:
//  - datasets stream from disk without deserialization (mmap + memcpy),
//    so sets larger than host RAM feed the device at full PCIe rate;
//  - shuffled gather (the CPU-bound part of batching) runs on a producer
//    thread pool with a ring of reusable batch buffers — no Python, no
//    per-worker process forks, no pickle;
//  - epoch order is a seeded Fisher-Yates shuffle (std::mt19937_64),
//    deterministic across platforms, so a resumed run sees the batches
//    the uninterrupted one would (epoch seeds: core/rng.py).
//
// RRD file layout (little-endian):
//   magic  u64  = 0x52524431'4D564154  ("MVAT" "1DRR")
//   n, h, w, c  u64 each
//   images      n*h*w*c bytes (uint8, NHWC, C-contiguous)
//   labels      n * i64
//
// C ABI (ctypes): rrd_open/rrd_info/rrd_close manage the mapping;
// rrd_loader_create/start_epoch/next/destroy drive iteration.

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <queue>
#include <random>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x5252443144564154ull;  // "TAVD1DRR" tag

struct Dataset {
  int fd = -1;
  size_t map_size = 0;
  const uint8_t* base = nullptr;
  uint64_t n = 0, h = 0, w = 0, c = 0;
  const uint8_t* images = nullptr;
  const int64_t* labels = nullptr;

  size_t sample_bytes() const { return static_cast<size_t>(h) * w * c; }
};

struct BatchSlot {
  std::vector<uint8_t> images;
  std::vector<int64_t> labels;
  long valid = 0;
};

struct Loader {
  Dataset* ds = nullptr;
  long batch_size = 0;
  bool drop_last = true;
  int n_threads = 1;
  int depth = 2;

  std::vector<uint64_t> order;
  std::vector<uint64_t> base_indices;  // optional row subset (dataset splits)
  long num_batches = 0;

  // ring of filled slots
  std::vector<BatchSlot> slots;
  std::queue<int> free_slots;
  std::queue<int> ready_slots;  // FIFO: batches delivered in index order
  std::mutex mu;
  std::condition_variable cv_free, cv_ready;
  std::atomic<long> next_batch_idx{0};  // producer cursor
  long consumed = 0;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};
  uint64_t epoch_seq = 0;

  // producer ordering: batches must be enqueued in index order so the
  // consumer sees a deterministic stream regardless of thread timing.
  // Buffer slots are ALSO claimed in batch order (next_claim): without
  // that, n_threads > depth can deadlock — workers holding later batches
  // own every slot while the next-to-enqueue batch waits for one, and no
  // slot frees until that batch is enqueued and consumed (circular wait).
  // Ordered claims make the smallest unenqueued batch always hold a slot,
  // so the enqueue wait below is starvation-free; filling still overlaps
  // across up to `depth` workers.
  long next_claim = 0;
  long next_enqueue = 0;
  std::condition_variable cv_enqueue;

  ~Loader() { shutdown(); }

  void shutdown() {
    {
      std::lock_guard<std::mutex> lock(mu);
      stop = true;
    }
    cv_free.notify_all();
    cv_enqueue.notify_all();
    for (auto& t : workers) {
      if (t.joinable()) t.join();
    }
    workers.clear();
  }

  void fill_batch(long batch_idx, BatchSlot& slot) {
    const long start = batch_idx * batch_size;
    const long end = std::min<long>(start + batch_size, order.size());
    const size_t sb = ds->sample_bytes();
    slot.valid = end - start;
    for (long i = start; i < end; ++i) {
      const uint64_t src = order[i];
      std::memcpy(slot.images.data() + (i - start) * sb, ds->images + src * sb, sb);
      slot.labels[i - start] = ds->labels[src];
    }
    // zero-pad the tail (eval batches keep static shapes; mask = valid)
    for (long i = end - start; i < batch_size; ++i) {
      std::memset(slot.images.data() + i * sb, 0, sb);
      slot.labels[i] = 0;
    }
  }

  void worker_loop() {
    for (;;) {
      const long my_batch = next_batch_idx.fetch_add(1);
      if (my_batch >= num_batches || stop) return;

      int slot_idx;
      {
        std::unique_lock<std::mutex> lock(mu);
        cv_free.wait(lock, [&] { return stop || (next_claim == my_batch && !free_slots.empty()); });
        if (stop) return;
        slot_idx = free_slots.front();
        free_slots.pop();
        ++next_claim;
      }
      cv_free.notify_all();  // wake the worker owning batch my_batch+1
      fill_batch(my_batch, slots[slot_idx]);
      {
        std::unique_lock<std::mutex> lock(mu);
        cv_enqueue.wait(lock, [&] { return stop || next_enqueue == my_batch; });
        if (stop) return;
        ready_slots.push(slot_idx);
        ++next_enqueue;
      }
      cv_enqueue.notify_all();
      cv_ready.notify_one();
    }
  }

  void start_epoch(uint64_t seed, bool shuffle) {
    shutdown();
    stop = false;
    ++epoch_seq;

    if (!base_indices.empty()) {
      order = base_indices;  // epoch order draws from the split subset
    } else {
      order.resize(ds->n);
      for (uint64_t i = 0; i < ds->n; ++i) order[i] = i;
    }
    if (shuffle) {
      std::mt19937_64 rng(seed);
      std::shuffle(order.begin(), order.end(), rng);
    }
    num_batches = drop_last ? static_cast<long>(order.size()) / batch_size
                            : static_cast<long>((order.size() + batch_size - 1) / batch_size);
    if (drop_last) order.resize(static_cast<size_t>(num_batches) * batch_size);

    const size_t sb = ds->sample_bytes();
    slots.resize(depth);
    {
      std::lock_guard<std::mutex> lock(mu);
      free_slots = {};
      ready_slots = {};
      for (int i = 0; i < depth; ++i) {
        slots[i].images.resize(static_cast<size_t>(batch_size) * sb);
        slots[i].labels.resize(batch_size);
        free_slots.push(i);
      }
      next_batch_idx = 0;
      next_claim = 0;
      next_enqueue = 0;
      consumed = 0;
    }
    for (int i = 0; i < n_threads; ++i) {
      workers.emplace_back([this] { worker_loop(); });
    }
  }

  long next(uint8_t* out_images, int64_t* out_labels) {
    if (consumed >= num_batches) return 0;
    int slot_idx;
    {
      std::unique_lock<std::mutex> lock(mu);
      cv_ready.wait(lock, [&] { return stop || !ready_slots.empty(); });
      if (stop) return -1;
      slot_idx = ready_slots.front();
      ready_slots.pop();
    }
    BatchSlot& slot = slots[slot_idx];
    std::memcpy(out_images, slot.images.data(), slot.images.size());
    std::memcpy(out_labels, slot.labels.data(), slot.labels.size() * sizeof(int64_t));
    const long valid = slot.valid;
    {
      std::lock_guard<std::mutex> lock(mu);
      free_slots.push(slot_idx);
      ++consumed;
    }
    // notify_all: with ordered claims only the worker whose turn it is may
    // take the slot — notify_one could wake a different waiter, which would
    // re-check its predicate and sleep again, losing the wakeup.
    cv_free.notify_all();
    return valid;
  }
};

}  // namespace

extern "C" {

void* rrd_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    ::close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (base == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  auto* ds = new Dataset();
  ds->fd = fd;
  ds->map_size = st.st_size;
  ds->base = static_cast<const uint8_t*>(base);
  const uint64_t* header = reinterpret_cast<const uint64_t*>(ds->base);
  if (st.st_size < 40 || header[0] != kMagic) {
    munmap(base, st.st_size);
    ::close(fd);
    delete ds;
    return nullptr;
  }
  ds->n = header[1];
  ds->h = header[2];
  ds->w = header[3];
  ds->c = header[4];
  // overflow-safe size validation: crafted header dims whose product wraps
  // 64 bits would pass a naive check and SIGBUS on first row read
  size_t sample = 0, image_bytes = 0, label_bytes = 0, need = 40;
  bool overflow = __builtin_mul_overflow(ds->h, ds->w, &sample) ||
                  __builtin_mul_overflow(sample, ds->c, &sample) ||
                  __builtin_mul_overflow(ds->n, sample, &image_bytes) ||
                  __builtin_mul_overflow(ds->n, sizeof(int64_t), &label_bytes) ||
                  __builtin_add_overflow(need, image_bytes, &need) ||
                  __builtin_add_overflow(need, label_bytes, &need);
  if (overflow || static_cast<size_t>(st.st_size) < need) {
    munmap(base, st.st_size);
    ::close(fd);
    delete ds;
    return nullptr;
  }
  ds->images = ds->base + 40;
  ds->labels = reinterpret_cast<const int64_t*>(ds->base + 40 + image_bytes);
  return ds;
}

int rrd_info(void* handle, int64_t* n, int64_t* h, int64_t* w, int64_t* c) {
  if (!handle) return -1;
  auto* ds = static_cast<Dataset*>(handle);
  *n = ds->n;
  *h = ds->h;
  *w = ds->w;
  *c = ds->c;
  return 0;
}

void rrd_close(void* handle) {
  if (!handle) return;
  auto* ds = static_cast<Dataset*>(handle);
  munmap(const_cast<uint8_t*>(ds->base), ds->map_size);
  ::close(ds->fd);
  delete ds;
}

void* rrd_loader_create(void* dataset, long batch_size, int drop_last, int n_threads, int prefetch_depth) {
  if (!dataset || batch_size <= 0) return nullptr;
  auto* loader = new Loader();
  loader->ds = static_cast<Dataset*>(dataset);
  loader->batch_size = batch_size;
  loader->drop_last = drop_last != 0;
  loader->n_threads = std::max(1, n_threads);
  loader->depth = std::max(2, prefetch_depth);
  return loader;
}

void rrd_loader_set_indices(void* handle, const uint64_t* indices, long n) {
  auto* loader = static_cast<Loader*>(handle);
  loader->base_indices.assign(indices, indices + n);
}

void rrd_loader_start_epoch(void* handle, uint64_t seed, int shuffle) {
  static_cast<Loader*>(handle)->start_epoch(seed, shuffle != 0);
}

long rrd_loader_num_batches(void* handle) { return static_cast<Loader*>(handle)->num_batches; }

long rrd_loader_next(void* handle, uint8_t* out_images, int64_t* out_labels) {
  return static_cast<Loader*>(handle)->next(out_images, out_labels);
}

void rrd_loader_destroy(void* handle) { delete static_cast<Loader*>(handle); }

}  // extern "C"
