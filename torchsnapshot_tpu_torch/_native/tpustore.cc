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
//   tpusnap_cdc_boundaries (content-defined chunk edges)
//   tpusnap_has_zstd / tpusnap_zstd_encode / tpusnap_zstd_encode2 /
//   tpusnap_zstd_decode (the compression frame's zstd codec)
// and the coordination store's TCP server and client (tpustore_server_*,
// tpustore_client_*; see the "TCP store" section at the end).
// The digest values ("xxh64" and the striped "xxh64s") are bit-identical to
// the JAX package's, so either package verifies the other's snapshots.
// Entry points return 0 (or a size) on success and -errno on failure.

#include <atomic>
#include <cerrno>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <dlfcn.h>
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

#ifdef TPUSNAP_WITH_ZSTD
#include <zstd.h>
#endif

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


// ------------------------------------------------------------ zstd codec
// The ZSTD_* C API, resolved once per process: linked at build time when
// zstd.h exists (build.py defines TPUSNAP_WITH_ZSTD and links -lzstd), else
// through dlopen of the runtime libzstd.so.1 that most images ship without
// the -dev package.  ok = the one-shot API resolved; ok2 = the advanced
// cctx API too.  The cctx parameter ids are part of zstd's stable public
// ABI (ZSTD_c_compressionLevel=100, ZSTD_c_windowLog=101,
// ZSTD_c_enableLongDistanceMatching=160), so the shim passes the integers.
struct ZstdApi {
  size_t (*compress)(void*, size_t, const void*, size_t, int) = nullptr;
  size_t (*decompress)(void*, size_t, const void*, size_t) = nullptr;
  unsigned (*is_error)(size_t) = nullptr;
  size_t (*compress_bound)(size_t) = nullptr;
  void* (*cctx_create)() = nullptr;
  size_t (*cctx_free)(void*) = nullptr;
  size_t (*cctx_set_param)(void*, int, int) = nullptr;
  size_t (*compress2)(void*, void*, size_t, const void*, size_t) = nullptr;
  bool ok = false;
  bool ok2 = false;
};

const ZstdApi& zstd_api() {
  static const ZstdApi api = [] {
    ZstdApi a;
#ifdef TPUSNAP_WITH_ZSTD
    a.compress = &ZSTD_compress;
    a.decompress = &ZSTD_decompress;
    a.is_error = &ZSTD_isError;
    a.compress_bound = &ZSTD_compressBound;
    a.cctx_create = reinterpret_cast<void* (*)()>(&ZSTD_createCCtx);
    a.cctx_free = reinterpret_cast<size_t (*)(void*)>(&ZSTD_freeCCtx);
    a.cctx_set_param = reinterpret_cast<size_t (*)(void*, int, int)>(
        &ZSTD_CCtx_setParameter);
    a.compress2 =
        reinterpret_cast<size_t (*)(void*, void*, size_t, const void*,
                                    size_t)>(&ZSTD_compress2);
    a.ok = true;
    a.ok2 = true;
#else
    void* h = dlopen("libzstd.so.1", RTLD_NOW | RTLD_LOCAL);
    if (h == nullptr) h = dlopen("libzstd.so", RTLD_NOW | RTLD_LOCAL);
    if (h != nullptr) {
      a.compress = reinterpret_cast<size_t (*)(void*, size_t, const void*,
                                               size_t, int)>(
          dlsym(h, "ZSTD_compress"));
      a.decompress = reinterpret_cast<size_t (*)(void*, size_t, const void*,
                                                 size_t)>(
          dlsym(h, "ZSTD_decompress"));
      a.is_error =
          reinterpret_cast<unsigned (*)(size_t)>(dlsym(h, "ZSTD_isError"));
      a.compress_bound =
          reinterpret_cast<size_t (*)(size_t)>(dlsym(h, "ZSTD_compressBound"));
      a.ok = a.compress && a.decompress && a.is_error && a.compress_bound;
      a.cctx_create =
          reinterpret_cast<void* (*)()>(dlsym(h, "ZSTD_createCCtx"));
      a.cctx_free =
          reinterpret_cast<size_t (*)(void*)>(dlsym(h, "ZSTD_freeCCtx"));
      a.cctx_set_param = reinterpret_cast<size_t (*)(void*, int, int)>(
          dlsym(h, "ZSTD_CCtx_setParameter"));
      a.compress2 = reinterpret_cast<size_t (*)(void*, void*, size_t,
                                                const void*, size_t)>(
          dlsym(h, "ZSTD_compress2"));
      a.ok2 = a.ok && a.cctx_create && a.cctx_free && a.cctx_set_param &&
              a.compress2;
      // The handle is kept for the life of the process.
    }
#endif
    return a;
  }();
  return api;
}

// ------------------------------------------- content-defined chunking
// FastCDC-style gear-hash chunking, byte-identical to chunker.boundaries_py
// and to torchsnapshot_tpu's native and Python implementations: the same
// gear table (splitmix64 from one frozen seed) and the same normalized
// selection walk.  Boundaries name CAS chunks, so a divergence would fork
// the dedup namespace.
//
// The rolling hash h_i = (h_{i-1} << 1) + GEAR[b_i] (mod 2^64), computed
// from the buffer start, depends only on the trailing 64 bytes, which is
// what makes edges content-local and lets the candidate scan stripe across
// the worker pool with a 63-byte warm-up per stripe.

constexpr uint64_t CDC_GEAR_SEED = 0x747075736E617031ULL;  // "tpusnap1"

const uint64_t* cdc_gear_table() {
  static const uint64_t* table = [] {
    static uint64_t t[256];
    uint64_t x = CDC_GEAR_SEED;
    for (int i = 0; i < 256; ++i) {
      x += 0x9E3779B97F4A7C15ULL;
      uint64_t z = x;
      z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
      z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
      t[i] = z ^ (z >> 31);
    }
    return t;
  }();
  return table;
}

struct CdcCandidate {
  int64_t idx;
  bool strict;  // also satisfies mask_s
};

// Candidates in [begin, end): mask_l hits, flagged when they also hit
// mask_s.  The hash state is rebuilt from up to 63 bytes before `begin`,
// which reproduces the computed-from-buffer-start value exactly.
void cdc_scan(const uint8_t* data, int64_t begin, int64_t end,
              uint64_t mask_s, uint64_t mask_l,
              std::vector<CdcCandidate>* out) {
  const uint64_t* gear = cdc_gear_table();
  int64_t warm = begin >= 63 ? begin - 63 : 0;
  uint64_t h = 0;
  for (int64_t i = warm; i < begin; ++i) {
    h = (h << 1) + gear[data[i]];
  }
  for (int64_t i = begin; i < end; ++i) {
    h = (h << 1) + gear[data[i]];
    if ((h & mask_l) == 0) {
      out->push_back({i, (h & mask_s) == 0});
    }
  }
}

}  // namespace

extern "C" {

int tpusnap_abi_version() { return 3; }

// Sizes the worker pool BEFORE its lazy creation (TPUSNAP_NATIVE_THREADS);
// once threads exist the request is ignored.  n <= 0 selects auto
// (min(16, hardware_concurrency)).
void tpusnap_pool_configure(int n) {
  std::lock_guard<std::mutex> lock(g_pool_mu);
  if (g_pool == nullptr) g_pool_threads_requested = n;
}

int tpusnap_pool_size() { return static_cast<int>(get_pool()->threads.size()); }

// Content-defined chunk END offsets of data[0, len) into out (ascending,
// last == len).  Returns the count, -EINVAL for parameters outside
// 64 <= min < avg <= max, or -ENOMEM when out_cap is too small (callers
// size it len/min + 2, the upper bound).  The candidate scan stripes
// across the worker pool (63-byte warm-up per stripe keeps values exact);
// the selection walk is sequential over the candidates.
int64_t tpusnap_cdc_boundaries(const void* data, int64_t len,
                               int64_t min_size, int64_t avg_size,
                               int64_t max_size, int64_t* out,
                               int64_t out_cap) {
  if (min_size < 64 || min_size >= avg_size || avg_size > max_size) {
    return -EINVAL;
  }
  const uint8_t* p = static_cast<const uint8_t*>(data);
  if (len <= 0) return 0;
  if (len <= min_size) {
    if (out_cap < 1) return -ENOMEM;
    out[0] = len;
    return 1;
  }
  int bits = 0;
  while ((int64_t{1} << (bits + 1)) <= avg_size) ++bits;
  int sbits = bits + 2 > 62 ? 62 : bits + 2;
  int lbits = bits - 2 < 1 ? 1 : bits - 2;
  uint64_t mask_s = (uint64_t{1} << sbits) - 1;
  uint64_t mask_l = (uint64_t{1} << lbits) - 1;

  const int64_t STRIPE = 8 << 20;
  int64_t n_stripes = (len + STRIPE - 1) / STRIPE;
  std::vector<std::vector<CdcCandidate>> per_stripe(
      static_cast<size_t>(n_stripes));
  TaskSet ts;
  ts.tasks.reserve(static_cast<size_t>(n_stripes));
  for (int64_t s = 0; s < n_stripes; ++s) {
    int64_t begin = s * STRIPE;
    int64_t end = begin + STRIPE < len ? begin + STRIPE : len;
    std::vector<CdcCandidate>* dst = &per_stripe[static_cast<size_t>(s)];
    ts.tasks.emplace_back([=] {
      cdc_scan(p, begin, end, mask_s, mask_l, dst);
    });
  }
  ts.run_all();
  std::vector<CdcCandidate> cand;
  for (auto& v : per_stripe) {
    cand.insert(cand.end(), v.begin(), v.end());
  }

  // Selection walk — the same spec as chunker._walk: a candidate at index
  // i cuts a chunk end at i + 1; the strict mask applies through the
  // average point, the loose one through the max; a chunk is forced at
  // max size, and a candidate-less tail becomes one final chunk.
  int64_t n_out = 0;
  int64_t last = 0;
  size_t ci = 0;
  while (len - last > min_size) {
    int64_t window_end = last + max_size < len ? last + max_size : len;
    int64_t norm_end = last + avg_size < window_end ? last + avg_size
                                                    : window_end;
    while (ci < cand.size() && cand[ci].idx < last + min_size - 1) ++ci;
    int64_t cut = 0;
    size_t k = ci;
    for (; k < cand.size() && cand[k].idx <= norm_end - 1; ++k) {
      if (cand[k].strict) {
        cut = cand[k].idx + 1;
        break;
      }
    }
    if (cut == 0) {
      // k sits at the first candidate past norm_end - 1 (or the strict
      // hit loop's stop); rescan from there for any loose candidate.
      while (k < cand.size() && cand[k].idx <= norm_end - 1) ++k;
      if (k < cand.size() && cand[k].idx <= window_end - 1) {
        cut = cand[k].idx + 1;
      }
    }
    if (cut == 0) {
      cut = window_end < len ? window_end : len;
    }
    if (n_out >= out_cap) return -ENOMEM;
    out[n_out++] = cut;
    last = cut;
  }
  if (last < len) {
    if (n_out >= out_cap) return -ENOMEM;
    out[n_out++] = len;
  }
  return n_out;
}

// zstd straight into and out of the compression frame's payload region.
// Frames are standard single-segment zstd frames; at the same level and
// library they are byte-identical to torchsnapshot_tpu's native encode.
int tpusnap_has_zstd() { return zstd_api().ok ? 1 : 0; }

// Returns the encoded size, -1 when the output does not fit dst_cap (the
// incompressible case callers turn into a raw frame), -2 on any other
// zstd error or when the backend is unavailable.
int64_t tpusnap_zstd_encode(const void* src, int64_t src_len, void* dst,
                            int64_t dst_cap, int level) {
  const ZstdApi& z = zstd_api();
  if (!z.ok) return -2;
  size_t rc = z.compress(dst, static_cast<size_t>(dst_cap), src,
                         static_cast<size_t>(src_len), level);
  if (z.is_error(rc)) {
    // Below the bound the expected failure is dstSize_tooSmall — the
    // didn't-shrink signal; at/above it any failure is a real error
    // (conflating them would silently store compressible payloads raw).
    return static_cast<size_t>(dst_cap) <
                   z.compress_bound(static_cast<size_t>(src_len))
               ? -1
               : -2;
  }
  return static_cast<int64_t>(rc);
}

// Advanced-parameter zstd encode: window log + long-distance matching for
// the many-similar-chunks fleet case (hundreds of fine-tunes sharing a
// frozen backbone — LDM finds the repeats a 1 MB window cannot see).
// Output is a standard zstd frame any backend decodes.  Returns the
// encoded size, -1 when the output does not fit dst_cap (incompressible —
// same contract as tpusnap_zstd_encode), -2 on codec error, or -3 when
// the advanced cctx API is unavailable in the resolved backend (ancient
// libzstd) — callers then fall back to the plain encode with a one-time
// warning.  window_log <= 0 leaves the level's default; enable_ldm != 0
// turns LDM on.
int64_t tpusnap_zstd_encode2(const void* src, int64_t src_len, void* dst,
                             int64_t dst_cap, int level, int window_log,
                             int enable_ldm) {
  const ZstdApi& z = zstd_api();
  if (!z.ok) return -2;
  if (!z.ok2) return -3;
  void* cctx = z.cctx_create();
  if (cctx == nullptr) return -2;
  // Stable public parameter ids: compressionLevel=100, windowLog=101,
  // enableLongDistanceMatching=160.
  z.cctx_set_param(cctx, 100, level);
  if (window_log > 0) z.cctx_set_param(cctx, 101, window_log);
  if (enable_ldm) z.cctx_set_param(cctx, 160, 1);
  size_t rc = z.compress2(cctx, dst, static_cast<size_t>(dst_cap), src,
                          static_cast<size_t>(src_len));
  z.cctx_free(cctx);
  if (z.is_error(rc)) {
    return static_cast<size_t>(dst_cap) <
                   z.compress_bound(static_cast<size_t>(src_len))
               ? -1
               : -2;
  }
  return static_cast<int64_t>(rc);
}

// Returns the decoded size (callers compare it against the frame header's
// recorded uncompressed length), or -2 on any decode error.
int64_t tpusnap_zstd_decode(const void* src, int64_t src_len, void* dst,
                            int64_t dst_cap) {
  const ZstdApi& z = zstd_api();
  if (!z.ok) return -2;
  size_t rc = z.decompress(dst, static_cast<size_t>(dst_cap), src,
                           static_cast<size_t>(src_len));
  if (z.is_error(rc)) return -2;
  return static_cast<int64_t>(rc);
}

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

// ------------------------------------------------------------ TCP store
// The coordination store of multi-rank snapshots: a key-value server (one
// acceptor thread plus one handler thread per connection) and its client,
// copied from torchsnapshot_tpu's _native/tpustore.cc with the same wire
// protocol, so either package's client talks to either package's server.
//
// Protocol (all integers little-endian uint32 unless noted):
//   request:  op(1) keylen(4) key value_len(4) value
//   response: status(1) value_len(4) value
//   ops: 0=SET 1=GET(blocking, timeout_ms in value) 2=TRYGET
//        3=ADD(int64 delta in value, returns int64) 4=PING
//        5=DELETE_PREFIX(erases all keys starting with key, returns int64
//          count): retired collective generations are swept, so a job that
//          takes thousands of snapshots keeps the server's map bounded
//   status: 0=ok 1=not_found 2=timeout 3=error

#include <arpa/inet.h>
#include <chrono>
#include <map>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <string>
#include <sys/socket.h>

namespace {

struct Store {
  std::mutex mu;
  std::condition_variable cv;
  std::map<std::string, std::string> data;
};

int sock_read_full(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  size_t got = 0;
  while (got < n) {
    ssize_t r = ::read(fd, p + got, n - got);
    if (r == 0) return -1;
    if (r < 0) {
      if (errno == EINTR) continue;
      return -1;
    }
    got += static_cast<size_t>(r);
  }
  return 0;
}

int sock_write_full(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  size_t put = 0;
  while (put < n) {
    ssize_t r = ::write(fd, p + put, n - put);
    if (r < 0) {
      if (errno == EINTR) continue;
      return -1;
    }
    put += static_cast<size_t>(r);
  }
  return 0;
}

bool send_response(int fd, uint8_t status, const std::string& value) {
  uint32_t len = static_cast<uint32_t>(value.size());
  std::string out;
  out.reserve(5 + value.size());
  out.push_back(static_cast<char>(status));
  out.append(reinterpret_cast<const char*>(&len), 4);
  out.append(value);
  return sock_write_full(fd, out.data(), out.size()) == 0;
}

struct Server {
  int listen_fd = -1;
  int port = 0;
  std::thread acceptor;
  std::vector<std::thread> handlers;
  std::mutex handlers_mu;
  Store store;
  std::atomic<bool> stopping{false};

  void handle_conn(int fd) {
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    for (;;) {
      uint8_t op;
      uint32_t keylen, vallen;
      if (sock_read_full(fd, &op, 1) < 0) break;
      if (sock_read_full(fd, &keylen, 4) < 0) break;
      std::string key(keylen, '\0');
      if (keylen && sock_read_full(fd, &key[0], keylen) < 0) break;
      if (sock_read_full(fd, &vallen, 4) < 0) break;
      std::string value(vallen, '\0');
      if (vallen && sock_read_full(fd, &value[0], vallen) < 0) break;

      bool ok = true;
      switch (op) {
        case 0: {  // SET
          {
            std::lock_guard<std::mutex> lock(store.mu);
            store.data[key] = value;
          }
          store.cv.notify_all();
          ok = send_response(fd, 0, "");
          break;
        }
        case 1: {  // blocking GET with timeout_ms payload
          int64_t timeout_ms = 1800000;
          if (value.size() == 8) memcpy(&timeout_ms, value.data(), 8);
          std::unique_lock<std::mutex> lock(store.mu);
          auto deadline = std::chrono::steady_clock::now() +
                          std::chrono::milliseconds(timeout_ms);
          bool found = store.cv.wait_until(lock, deadline, [&] {
            return stopping || store.data.count(key) > 0;
          });
          if (stopping) { ok = send_response(fd, 3, ""); break; }
          if (!found) {
            ok = send_response(fd, 2, "");
          } else {
            ok = send_response(fd, 0, store.data[key]);
          }
          break;
        }
        case 2: {  // TRYGET
          std::lock_guard<std::mutex> lock(store.mu);
          auto it = store.data.find(key);
          if (it == store.data.end()) {
            ok = send_response(fd, 1, "");
          } else {
            ok = send_response(fd, 0, it->second);
          }
          break;
        }
        case 3: {  // ADD int64
          int64_t delta = 0;
          if (value.size() == 8) memcpy(&delta, value.data(), 8);
          int64_t result;
          {
            std::lock_guard<std::mutex> lock(store.mu);
            int64_t current = 0;
            auto it = store.data.find(key);
            if (it != store.data.end() && it->second.size() == 8) {
              memcpy(&current, it->second.data(), 8);
            }
            result = current + delta;
            std::string packed(8, '\0');
            memcpy(&packed[0], &result, 8);
            store.data[key] = packed;
          }
          store.cv.notify_all();
          std::string out(8, '\0');
          memcpy(&out[0], &result, 8);
          ok = send_response(fd, 0, out);
          break;
        }
        case 4: {  // PING
          ok = send_response(fd, 0, "");
          break;
        }
        case 5: {  // DELETE_PREFIX
          int64_t count = 0;
          {
            std::lock_guard<std::mutex> lock(store.mu);
            auto it = store.data.lower_bound(key);
            while (it != store.data.end() &&
                   it->first.compare(0, key.size(), key) == 0) {
              it = store.data.erase(it);
              ++count;
            }
          }
          std::string out(8, '\0');
          memcpy(&out[0], &count, 8);
          ok = send_response(fd, 0, out);
          break;
        }
        default:
          ok = send_response(fd, 3, "");
      }
      if (!ok) break;
    }
    ::close(fd);
  }

  void accept_loop() {
    for (;;) {
      int fd = ::accept(listen_fd, nullptr, nullptr);
      if (fd < 0) {
        if (stopping) return;
        if (errno == EINTR) continue;
        return;
      }
      std::lock_guard<std::mutex> lock(handlers_mu);
      handlers.emplace_back([this, fd] { handle_conn(fd); });
    }
  }
};

struct Client {
  int fd = -1;
  std::string last_value;
  std::mutex mu;
};

}  // namespace

extern "C" {

// ----------------------------------------------------------------- server

void* tpustore_server_start(int port) {
  auto* srv = new Server();
  srv->listen_fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (srv->listen_fd < 0) { delete srv; return nullptr; }
  int one = 1;
  setsockopt(srv->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::bind(srv->listen_fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0 ||
      ::listen(srv->listen_fd, 128) < 0) {
    ::close(srv->listen_fd);
    delete srv;
    return nullptr;
  }
  if (port == 0) {
    socklen_t len = sizeof(addr);
    getsockname(srv->listen_fd, reinterpret_cast<sockaddr*>(&addr), &len);
  }
  srv->port = ntohs(addr.sin_port);
  srv->acceptor = std::thread([srv] { srv->accept_loop(); });
  return srv;
}

int tpustore_server_port(void* handle) {
  return static_cast<Server*>(handle)->port;
}

void tpustore_server_stop(void* handle) {
  auto* srv = static_cast<Server*>(handle);
  srv->stopping = true;
  srv->store.cv.notify_all();
  ::shutdown(srv->listen_fd, SHUT_RDWR);
  ::close(srv->listen_fd);
  if (srv->acceptor.joinable()) srv->acceptor.join();
  {
    std::lock_guard<std::mutex> lock(srv->handlers_mu);
    for (auto& t : srv->handlers) {
      if (t.joinable()) t.detach();  // blocked conns exit on closed fds
    }
  }
  // Leak srv intentionally: detached handlers may still touch the store for
  // a moment during teardown; process exit reclaims. (Servers are one per
  // job, not churned.)
}

// ----------------------------------------------------------------- client

void* tpustore_client_connect(const char* host, int port, int timeout_ms) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return nullptr;
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
    ::close(fd);
    return nullptr;
  }
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::milliseconds(timeout_ms);
  while (::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0) {
    ::close(fd);
    if (std::chrono::steady_clock::now() > deadline) return nullptr;
    std::this_thread::sleep_for(std::chrono::milliseconds(50));
    fd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) return nullptr;
  }
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  auto* client = new Client();
  client->fd = fd;
  return client;
}

static int client_request(Client* c, uint8_t op, const char* key,
                          const void* value, uint32_t value_len) {
  std::string req;
  uint32_t keylen = static_cast<uint32_t>(strlen(key));
  req.push_back(static_cast<char>(op));
  req.append(reinterpret_cast<const char*>(&keylen), 4);
  req.append(key, keylen);
  req.append(reinterpret_cast<const char*>(&value_len), 4);
  if (value_len) req.append(static_cast<const char*>(value), value_len);
  if (sock_write_full(c->fd, req.data(), req.size()) < 0) return -1;
  uint8_t status;
  uint32_t resp_len;
  if (sock_read_full(c->fd, &status, 1) < 0) return -1;
  if (sock_read_full(c->fd, &resp_len, 4) < 0) return -1;
  c->last_value.resize(resp_len);
  if (resp_len && sock_read_full(c->fd, &c->last_value[0], resp_len) < 0) return -1;
  return static_cast<int>(status);
}

// returns status; value fetched with tpustore_client_value/_value_len
int tpustore_client_set(void* handle, const char* key, const void* value,
                        uint32_t value_len) {
  auto* c = static_cast<Client*>(handle);
  std::lock_guard<std::mutex> lock(c->mu);
  return client_request(c, 0, key, value, value_len);
}

int tpustore_client_get(void* handle, const char* key, int64_t timeout_ms) {
  auto* c = static_cast<Client*>(handle);
  std::lock_guard<std::mutex> lock(c->mu);
  return client_request(c, 1, key, &timeout_ms, 8);
}

int tpustore_client_tryget(void* handle, const char* key) {
  auto* c = static_cast<Client*>(handle);
  std::lock_guard<std::mutex> lock(c->mu);
  return client_request(c, 2, key, nullptr, 0);
}

int tpustore_client_add(void* handle, const char* key, int64_t delta,
                        int64_t* result) {
  auto* c = static_cast<Client*>(handle);
  std::lock_guard<std::mutex> lock(c->mu);
  int status = client_request(c, 3, key, &delta, 8);
  if (status == 0 && c->last_value.size() == 8) {
    memcpy(result, c->last_value.data(), 8);
  }
  return status;
}

int tpustore_client_ping(void* handle) {
  auto* c = static_cast<Client*>(handle);
  std::lock_guard<std::mutex> lock(c->mu);
  return client_request(c, 4, "", nullptr, 0);
}

int tpustore_client_delete_prefix(void* handle, const char* prefix,
                                  int64_t* count) {
  auto* c = static_cast<Client*>(handle);
  std::lock_guard<std::mutex> lock(c->mu);
  int status = client_request(c, 5, prefix, nullptr, 0);
  if (status == 0 && c->last_value.size() == 8) {
    memcpy(count, c->last_value.data(), 8);
  }
  return status;
}

uint32_t tpustore_client_value_len(void* handle) {
  return static_cast<uint32_t>(static_cast<Client*>(handle)->last_value.size());
}

void tpustore_client_value(void* handle, void* out) {
  auto* c = static_cast<Client*>(handle);
  memcpy(out, c->last_value.data(), c->last_value.size());
}

void tpustore_client_close(void* handle) {
  auto* c = static_cast<Client*>(handle);
  ::close(c->fd);
  delete c;
}

}  // extern "C"
