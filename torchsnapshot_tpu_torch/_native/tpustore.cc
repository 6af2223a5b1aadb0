// Native host data plane of torchsnapshot_tpu_torch: xxHash64 digests and
// hashed pwrite/pread, driven from Python via ctypes (no pybind11, no torch
// headers — the library builds with g++ in seconds).
//
// A copy of the file-I/O and checksum half of torchsnapshot_tpu's
// _native/tpustore.cc, cut to what the synchronous take/restore path calls:
//   tpusnap_abi_version / tpusnap_pool_configure / tpusnap_pool_size
//   tpusnap_xxhash64 / tpusnap_xxhash64_striped
//   tpusnap_write_file_parts / tpusnap_write_parts_hash
//   tpusnap_read_ranges_hash / tpusnap_file_size
// The digest values ("xxh64" and the striped "xxh64s") are bit-identical to
// the JAX package's, so either package verifies the other's snapshots.
// Entry points return 0 (or a size) on success and -errno on failure.

#include <atomic>
#include <cerrno>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <fcntl.h>
#include <functional>
#include <mutex>
#include <new>
#include <pthread.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <thread>
#include <unistd.h>
#include <vector>

extern "C" {

// ------------------------------------------------------------ checksums
// xxHash64 (Yann Collet's public algorithm, implemented from the spec) for
// payload integrity: recorded in the manifest at write time, verified on
// restore.  ~5 GB/s single-threaded — off the critical path at checkpoint
// bandwidths.

static inline uint64_t xx_rotl(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

static const uint64_t P1 = 11400714785074694791ULL;
static const uint64_t P2 = 14029467366897019727ULL;
static const uint64_t P3 = 1609587929392839161ULL;
static const uint64_t P4 = 9650029242287828579ULL;
static const uint64_t P5 = 2870177450012600261ULL;

// Streaming state shared by the one-shot hasher and the fused read+hash:
// any change to the stripe round or finalization applies to both, so
// save-time and restore-time digests can never silently desync.
struct XXState {
  uint64_t v1, v2, v3, v4;
};

static inline void xx_init(XXState* s, uint64_t seed) {
  s->v1 = seed + P1 + P2;
  s->v2 = seed + P2;
  s->v3 = seed;
  s->v4 = seed - P1;
}

// Consumes n_stripes complete 32-byte stripes starting at p.
static inline void xx_stripes(XXState* s, const uint8_t* p,
                              int64_t n_stripes) {
  uint64_t v1 = s->v1, v2 = s->v2, v3 = s->v3, v4 = s->v4;
  for (int64_t i = 0; i < n_stripes; ++i) {
    uint64_t k;
    memcpy(&k, p, 8);      v1 = xx_rotl(v1 + k * P2, 31) * P1;
    memcpy(&k, p + 8, 8);  v2 = xx_rotl(v2 + k * P2, 31) * P1;
    memcpy(&k, p + 16, 8); v3 = xx_rotl(v3 + k * P2, 31) * P1;
    memcpy(&k, p + 24, 8); v4 = xx_rotl(v4 + k * P2, 31) * P1;
    p += 32;
  }
  s->v1 = v1; s->v2 = v2; s->v3 = v3; s->v4 = v4;
}

// Merges the stripe state (when total_len >= 32), mixes in the tail bytes
// [tail, tail + tail_len), and avalanches.
static uint64_t xx_finalize(const XXState* s, uint64_t seed,
                            const uint8_t* tail, int64_t tail_len,
                            int64_t total_len) {
  uint64_t h;
  if (total_len >= 32) {
    h = xx_rotl(s->v1, 1) + xx_rotl(s->v2, 7) + xx_rotl(s->v3, 12) +
        xx_rotl(s->v4, 18);
    uint64_t vs[4] = {s->v1, s->v2, s->v3, s->v4};
    for (uint64_t v : vs) {
      h ^= xx_rotl(v * P2, 31) * P1;
      h = h * P1 + P4;
    }
  } else {
    h = seed + P5;
  }
  h += static_cast<uint64_t>(total_len);
  const uint8_t* p = tail;
  const uint8_t* end = tail + tail_len;
  while (p + 8 <= end) {
    uint64_t k;
    memcpy(&k, p, 8);
    h ^= xx_rotl(k * P2, 31) * P1;
    h = xx_rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    uint32_t k;
    memcpy(&k, p, 4);
    h ^= static_cast<uint64_t>(k) * P1;
    h = xx_rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p) * P5;
    h = xx_rotl(h, 11) * P1;
    ++p;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// Number of 32-byte stripes the spec consumes for a payload of len bytes:
// stripe starts run while start <= len - 32.
static inline int64_t xx_n_stripes(int64_t len) {
  return len < 32 ? 0 : (len - 32) / 32 + 1;
}

uint64_t tpusnap_xxhash64(const void* data, int64_t len, uint64_t seed) {
  const uint8_t* p = static_cast<const uint8_t*>(data);
  XXState s;
  xx_init(&s, seed);
  int64_t n_stripes = xx_n_stripes(len);
  xx_stripes(&s, p, n_stripes);
  int64_t consumed = n_stripes * 32;
  return xx_finalize(&s, seed, p + consumed, len - consumed, len);
}

}  // extern "C"

namespace {

// ------------------------------------------------------- worker pool
// Off-GIL data plane: a process-wide pool of C++ threads executing the
// stripe/part tasks of the fused write+hash, striped hash, and multi-range
// read calls.  The calling (Python) thread has already dropped the GIL via
// ctypes, so it participates in draining the task set — progress is
// guaranteed even when every pool worker is busy with another call's tasks,
// and a pool of size 0 simply degrades to inline execution.

struct WorkPool {
  std::mutex mu;
  std::condition_variable cv;
  std::deque<std::function<void()>> q;
  std::vector<std::thread> threads;
  bool stopping = false;

  explicit WorkPool(int n) {
    for (int i = 0; i < n; ++i) {
      threads.emplace_back([this] { worker(); });
    }
  }

  void worker() {
    for (;;) {
      std::function<void()> task;
      {
        std::unique_lock<std::mutex> lock(mu);
        cv.wait(lock, [&] { return stopping || !q.empty(); });
        if (stopping && q.empty()) return;
        task = std::move(q.front());
        q.pop_front();
      }
      task();
    }
  }

  void submit(std::function<void()> task) {
    {
      std::lock_guard<std::mutex> lock(mu);
      q.push_back(std::move(task));
    }
    cv.notify_one();
  }
};

std::mutex g_pool_mu;
WorkPool* g_pool = nullptr;
int g_pool_threads_requested = 0;  // 0 = auto, set before first use

// Fork safety: a fork()ed child (multiprocessing workers, multi-process
// launchers) inherits g_pool but NOT its threads — a submit
// in the child would enqueue work nobody ever runs and a TaskSet would
// wait forever for helpers that never start.  The atfork child handler
// drops the inherited pool (leaking its memory — a fork costs one empty
// struct) and re-initializes the guarding mutex, which may have been held
// mid-fork by another parent thread; the child then lazily builds a fresh
// pool on first use.
struct PoolForkGuard {
  PoolForkGuard() {
    ::pthread_atfork(nullptr, nullptr, [] {
      new (&g_pool_mu) std::mutex();
      g_pool = nullptr;
    });
  }
};
PoolForkGuard g_pool_fork_guard;

int pool_auto_threads() {
  unsigned hw = std::thread::hardware_concurrency();
  if (hw == 0) hw = 4;
  int n = static_cast<int>(hw);
  if (n > 16) n = 16;
  if (n < 2) n = 2;
  return n;
}

WorkPool* get_pool() {
  std::lock_guard<std::mutex> lock(g_pool_mu);
  if (g_pool == nullptr) {
    int n = g_pool_threads_requested;
    if (n <= 0) n = pool_auto_threads();
    g_pool = new WorkPool(n);  // lives for the process (never churned)
  }
  return g_pool;
}

// A set of independent tasks drained cooperatively by pool workers and the
// calling thread (atomic work-stealing index).  Two usage shapes:
//   run_all()            — helpers + caller drain together, returns when
//                          every task finished;
//   launch(); <caller does other work>; finish()
//                        — helpers start immediately, the caller overlaps
//                          its own work (the sequential file write of the
//                          fused write+hash), then joins the drain.
struct TaskSet {
  std::vector<std::function<void()>> tasks;
  std::atomic<size_t> next{0};
  std::mutex done_mu;
  std::condition_variable done_cv;
  size_t done_count = 0;
  std::atomic<int> helpers_live{0};

  void drain() {
    for (;;) {
      size_t i = next.fetch_add(1);
      if (i >= tasks.size()) return;
      tasks[i]();
      std::lock_guard<std::mutex> lock(done_mu);
      if (++done_count == tasks.size()) done_cv.notify_all();
    }
  }

  void launch() {
    if (tasks.empty()) return;
    WorkPool* pool = get_pool();
    size_t helpers = tasks.size();
    if (helpers > pool->threads.size()) helpers = pool->threads.size();
    // Helpers only touch the TaskSet's counters; finish() does not return
    // until every helper exited its drain(), so the (stack-allocated) set
    // strictly outlives them.  The exit handshake is cv-based, never a
    // spin: under concurrent calls a queued helper can sit behind OTHER
    // calls' tasks for milliseconds before it even starts, and a yield
    // spin across 16 waiting callers measurably burned CPU-seconds.
    for (size_t h = 0; h < helpers; ++h) {
      helpers_live.fetch_add(1);
      pool->submit([this] {
        drain();
        // Notify UNDER the lock: with it released, a sibling helper's
        // decrement could satisfy finish()'s predicate and let the caller
        // destroy this stack-allocated set while our notify_all is still
        // pending on the freed condition_variable.
        std::lock_guard<std::mutex> lock(done_mu);
        helpers_live.fetch_sub(1);
        done_cv.notify_all();
      });
    }
  }

  void finish() {
    if (tasks.empty()) return;
    drain();  // help with whatever the pool hasn't claimed yet
    std::unique_lock<std::mutex> lock(done_mu);
    done_cv.wait(lock, [&] {
      return done_count == tasks.size() && helpers_live.load() == 0;
    });
  }

  void run_all() {
    if (tasks.empty()) return;
    if (tasks.size() == 1) {
      tasks[0]();
      return;
    }
    launch();
    finish();
  }
};

int pwrite_full(int fd, const void* buf, int64_t n, int64_t offset) {
  const char* p = static_cast<const char*>(buf);
  int64_t put = 0;
  while (put < n) {
    ssize_t r = ::pwrite(fd, p + put, static_cast<size_t>(n - put),
                         offset + put);
    if (r < 0) {
      if (errno == EINTR) continue;
      return -errno;
    }
    put += r;
  }
  return 0;
}

int pread_full(int fd, void* buf, int64_t n, int64_t offset) {
  char* p = static_cast<char*>(buf);
  int64_t got = 0;
  while (got < n) {
    ssize_t r = ::pread(fd, p + got, static_cast<size_t>(n - got),
                        offset + got);
    if (r == 0) return -EIO;  // short file: the range must exist in full
    if (r < 0) {
      if (errno == EINTR) continue;
      return -errno;
    }
    got += r;
  }
  return 0;
}

// Combine per-stripe xxh64 digests into the striped ("xxh64s") digest:
// xxh64 over the little-endian u64 digest stream, same seed — the same
// combination torchsnapshot_tpu records, so the two packages' manifests
// agree digest for digest.
uint64_t combine_stripe_digests(const std::vector<uint64_t>& digests,
                                uint64_t seed) {
  std::vector<uint8_t> packed(digests.size() * 8);
  for (size_t i = 0; i < digests.size(); ++i) {
    uint64_t d = digests[i];
    for (int b = 0; b < 8; ++b) {
      packed[i * 8 + b] = static_cast<uint8_t>((d >> (8 * b)) & 0xff);
    }
  }
  return tpusnap_xxhash64(packed.data(),
                          static_cast<int64_t>(packed.size()), seed);
}

// One payload file: open, write all parts sequentially, close.
int write_one_file(const char* path, const void* const* bufs,
                   const int64_t* sizes, int n) {
  int fd = ::open(path, O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return -errno;
  int err = 0;
  int64_t off = 0;
  for (int i = 0; i < n && err == 0; ++i) {
    if (sizes[i]) err = pwrite_full(fd, bufs[i], sizes[i], off);
    off += sizes[i];
  }
  if (err != 0) {
    ::close(fd);
    return err;
  }
  if (::close(fd) < 0) return -errno;
  return 0;
}

}  // namespace

extern "C" {

int tpusnap_abi_version() { return 1; }

// Sizes the worker pool BEFORE its lazy creation (TPUSNAP_NATIVE_THREADS);
// once threads exist the request is ignored.  n <= 0 selects auto
// (min(16, hardware_concurrency)).
void tpusnap_pool_configure(int n) {
  std::lock_guard<std::mutex> lock(g_pool_mu);
  if (g_pool == nullptr) g_pool_threads_requested = n;
}

int tpusnap_pool_size() { return static_cast<int>(get_pool()->threads.size()); }

// Scatter-gather file write: the member buffers of a slab are written
// sequentially from their own memory, skipping the pack memcpy.
int tpusnap_write_file_parts(const char* path, const void** bufs,
                             const int64_t* sizes, int n) {
  return write_one_file(path, bufs, sizes, n);
}

int64_t tpusnap_file_size(const char* path) {
  struct stat st;
  if (::stat(path, &st) < 0) return -errno;
  return st.st_size;
}

// Striped xxh64 ("xxh64s"): independent xxh64 per stripe_bytes window,
// computed in parallel on the pool, combined via xxh64 over the
// little-endian digest stream.  NOT equal to plain xxh64 of the buffer —
// the manifest records which algorithm a digest used ("xxh64s:" tag).
uint64_t tpusnap_xxhash64_striped(const void* data, int64_t len,
                                  uint64_t seed, int64_t stripe_bytes) {
  if (stripe_bytes <= 0 || len <= stripe_bytes) {
    return tpusnap_xxhash64(data, len, seed);
  }
  const uint8_t* p = static_cast<const uint8_t*>(data);
  int64_t n = (len + stripe_bytes - 1) / stripe_bytes;
  std::vector<uint64_t> digests(static_cast<size_t>(n));
  TaskSet ts;
  ts.tasks.reserve(static_cast<size_t>(n));
  for (int64_t i = 0; i < n; ++i) {
    int64_t off = i * stripe_bytes;
    int64_t sz = len - off < stripe_bytes ? len - off : stripe_bytes;
    ts.tasks.emplace_back([p, off, sz, seed, i, &digests] {
      digests[static_cast<size_t>(i)] = tpusnap_xxhash64(p + off, sz, seed);
    });
  }
  ts.run_all();
  return combine_stripe_digests(digests, seed);
}

// Fused write + per-part hash: the member buffers of a slab (or a single
// whole payload, n == 1) land sequentially in one file while each part's
// digest is computed concurrently on the pool — serialize / checksum /
// write stop being separate Python passes over the payload.  Parts at or
// above striped_min_bytes hash stripewise (out digest = xxh64s); smaller
// parts hash plain.  Division of labor measured, not guessed: hashing is
// embarrassingly parallel (128 MB stripes across the pool in ~5 ms) while
// concurrent pwrites to ONE file serialize on the inode lock and burn
// ~10x the CPU of a sequential writer for the same wall — so the pool
// hashes while THIS thread writes the parts in order, and the call
// returns when both are done (wall = max(write, hash) ≈ the write).
// Returns 0 or -errno; out_hashes[i] = part i's digest (callers map
// size >= striped_min_bytes to the "xxh64s" tag, below to "xxh64").
int tpusnap_write_parts_hash(const char* path, const void** bufs,
                             const int64_t* sizes, int n, uint64_t seed,
                             int64_t stripe_bytes, int64_t striped_min_bytes,
                             uint64_t* out_hashes) {
  // Per-part stripe digest storage for striped parts (index aligned).
  std::vector<std::vector<uint64_t>> stripes(static_cast<size_t>(n));
  TaskSet ts;
  for (int i = 0; i < n; ++i) {
    const uint8_t* buf = static_cast<const uint8_t*>(bufs[i]);
    int64_t sz = sizes[i];
    bool striped = striped_min_bytes > 0 && stripe_bytes > 0 &&
                   sz >= striped_min_bytes && sz > stripe_bytes;
    if (!striped) {
      ts.tasks.emplace_back(
          [=] { out_hashes[i] = tpusnap_xxhash64(buf, sz, seed); });
      continue;
    }
    int64_t n_stripes = (sz + stripe_bytes - 1) / stripe_bytes;
    stripes[static_cast<size_t>(i)].resize(static_cast<size_t>(n_stripes));
    std::vector<uint64_t>* out = &stripes[static_cast<size_t>(i)];
    for (int64_t j = 0; j < n_stripes; ++j) {
      int64_t s_off = j * stripe_bytes;
      int64_t s_sz = sz - s_off < stripe_bytes ? sz - s_off : stripe_bytes;
      ts.tasks.emplace_back([=] {
        (*out)[static_cast<size_t>(j)] =
            tpusnap_xxhash64(buf + s_off, s_sz, seed);
      });
    }
  }
  // Hashers start on the pool; this thread writes sequentially meanwhile
  // (concurrent pwrites to ONE file serialize on the inode lock — see the
  // division-of-labor note above).
  ts.launch();
  int write_err = write_one_file(path, bufs, sizes, n);
  ts.finish();  // digests all landed (must complete even on write error)
  if (write_err != 0) return write_err;
  for (int i = 0; i < n; ++i) {
    if (!stripes[static_cast<size_t>(i)].empty()) {
      out_hashes[i] =
          combine_stripe_digests(stripes[static_cast<size_t>(i)], seed);
    }
  }
  return 0;
}

// Parallel multi-range read with optional fused per-range hashing: the
// restore/audit fan-out that replaces the per-range Python loop.  Each
// range lands in its own destination buffer; with want_hash, each range's
// digest is computed fused with its reads (striped ranges hash per stripe
// in parallel — the xxh64s path that lets CHECKSUMMED large reads use
// parallelism; plain xxh64 is order-dependent, so sub-striped-min ranges
// hash sequentially within the range while ranges still parallelize
// against each other).  Returns 0 or -errno (first failure wins; a short
// range is -EIO).
int tpusnap_read_ranges_hash(const char* path, int n, const int64_t* offsets,
                             const int64_t* lengths, void** bufs,
                             int want_hash, uint64_t seed,
                             int64_t stripe_bytes, int64_t striped_min_bytes,
                             uint64_t* out_hashes) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return -errno;
  std::atomic<int> first_err{0};
  std::vector<std::vector<uint64_t>> stripes(static_cast<size_t>(n));
  const int64_t CHUNK = 8 << 20;  // unhashed split granularity
  TaskSet ts;
  for (int i = 0; i < n; ++i) {
    uint8_t* dst = static_cast<uint8_t*>(bufs[i]);
    int64_t off = offsets[i];
    int64_t len = lengths[i];
    if (len <= 0) {
      if (want_hash && out_hashes != nullptr) {
        out_hashes[i] = tpusnap_xxhash64(dst, 0, seed);
      }
      continue;
    }
    if (!want_hash) {
      // Split big ranges for intra-file parallelism; no digests.
      for (int64_t c_off = 0; c_off < len; c_off += CHUNK) {
        int64_t c_sz = len - c_off < CHUNK ? len - c_off : CHUNK;
        ts.tasks.emplace_back([=, &first_err] {
          if (first_err.load() != 0) return;
          int rc = pread_full(fd, dst + c_off, c_sz, off + c_off);
          if (rc != 0) {
            int expected = 0;
            first_err.compare_exchange_strong(expected, rc);
          }
        });
      }
      continue;
    }
    bool striped = striped_min_bytes > 0 && stripe_bytes > 0 &&
                   len >= striped_min_bytes && len > stripe_bytes;
    if (!striped) {
      // One task: sequential fused pread+hash over the range (the plain
      // xxh64 stream cannot split); ranges still overlap each other.
      ts.tasks.emplace_back([=, &first_err] {
        if (first_err.load() != 0) return;
        XXState s;
        xx_init(&s, seed);
        int64_t got = 0, hashed = 0;
        while (got < len) {
          int64_t want = len - got < CHUNK ? len - got : CHUNK;
          int rc = pread_full(fd, dst + got, want, off + got);
          if (rc != 0) {
            int expected = 0;
            first_err.compare_exchange_strong(expected, rc);
            return;
          }
          got += want;
          int64_t avail = (got - hashed) / 32;
          xx_stripes(&s, dst + hashed, avail);
          hashed += avail * 32;
        }
        out_hashes[i] =
            xx_finalize(&s, seed, dst + hashed, len - hashed, len);
      });
      continue;
    }
    int64_t n_stripes = (len + stripe_bytes - 1) / stripe_bytes;
    stripes[static_cast<size_t>(i)].resize(static_cast<size_t>(n_stripes));
    std::vector<uint64_t>* out = &stripes[static_cast<size_t>(i)];
    for (int64_t j = 0; j < n_stripes; ++j) {
      int64_t s_off = j * stripe_bytes;
      int64_t s_sz = len - s_off < stripe_bytes ? len - s_off : stripe_bytes;
      ts.tasks.emplace_back([=, &first_err] {
        if (first_err.load() != 0) return;
        int rc = pread_full(fd, dst + s_off, s_sz, off + s_off);
        if (rc != 0) {
          int expected = 0;
          first_err.compare_exchange_strong(expected, rc);
          return;
        }
        (*out)[static_cast<size_t>(j)] =
            tpusnap_xxhash64(dst + s_off, s_sz, seed);
      });
    }
  }
  ts.run_all();
  ::close(fd);
  if (first_err.load() != 0) return first_err.load();
  if (want_hash && out_hashes != nullptr) {
    for (int i = 0; i < n; ++i) {
      if (!stripes[static_cast<size_t>(i)].empty()) {
        out_hashes[i] =
            combine_stripe_digests(stripes[static_cast<size_t>(i)], seed);
      }
    }
  }
  return 0;
}

}  // extern "C"
