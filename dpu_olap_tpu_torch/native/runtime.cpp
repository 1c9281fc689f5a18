// The port's copy of dpu_olap_tpu/native/runtime.cpp, the JAX package's
// native host runtime, kept here so that dpu_olap_tpu_torch reads no file of
// the JAX package. Built by dpu_olap_tpu_torch/native/__init__.py with g++
// into dpu_olap_tpu_torch/_build/; the code below is the original's.
//
// Native host runtime for dpu_olap_tpu.
//
// C++ re-expression of the reference's host-native support layer:
//   * parallel blocked memcpy      (host/memory_utils/memcpy.h:39-74)
//   * partition slab buffers with lock-free atomic write cursors
//                                  (host/partition/partition.{h,cc})
//   * named per-rank nanosecond timers (host/timer/timer.{h,cc})
//   * ordered async executor: per-queue FIFO worker threads, the host-side
//     staging analog of the reference's per-rank async callback chains
//     (host/dpuext/dpuext.hpp:842-899 DpuSetAsync)
//
// Exposed as a plain C ABI consumed from Python via ctypes (no pybind11).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <functional>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Parallel memcpy
// ---------------------------------------------------------------------------

// Reference splits the range into 64-byte-aligned blocks and fans out to the
// Arrow thread pool above a 1MB threshold (memcpy.h:24-26,39-74). Here we use
// plain std::threads with the same alignment discipline.
constexpr size_t kAlign = 64;

void memcpy_range(char* dst, const char* src, size_t n) { std::memcpy(dst, src, n); }

}  // namespace

extern "C" {

void ue_parallel_memcpy(void* dst_v, const void* src_v, size_t nbytes,
                        int nthreads, size_t block_size) {
  char* dst = static_cast<char*>(dst_v);
  const char* src = static_cast<const char*>(src_v);
  if (nthreads <= 1 || nbytes < block_size * 2) {
    std::memcpy(dst, src, nbytes);
    return;
  }
  // Aligned prefix/suffix handled by the first/last chunk automatically:
  // chunk boundaries snapped to kAlign relative to dst.
  size_t nchunks = (size_t)nthreads;
  size_t chunk = ((nbytes / nchunks) / kAlign) * kAlign;
  if (chunk == 0) {
    std::memcpy(dst, src, nbytes);
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(nchunks);
  size_t off = 0;
  for (size_t i = 0; i + 1 < nchunks && off + chunk <= nbytes; ++i) {
    threads.emplace_back(memcpy_range, dst + off, src + off, chunk);
    off += chunk;
  }
  memcpy_range(dst + off, src + off, nbytes - off);
  for (auto& t : threads) t.join();
}

// ---------------------------------------------------------------------------
// Partition slab: per-column buffers + one shared atomic row cursor
// ---------------------------------------------------------------------------

// Reference Partition: one Arrow buffer per column with per-column
// atomic<size_t> cursors and fetch_add slab reservation; overflow throws
// (partition.cc:7-46). Rows are fixed-width so one row cursor serves all
// columns.
struct UePartition {
  std::vector<std::vector<char>> columns;
  std::vector<size_t> item_sizes;
  size_t capacity_rows;
  std::atomic<size_t> cursor{0};
};

void* ue_partition_new(int ncols, const size_t* item_sizes, size_t capacity_rows) {
  auto* p = new UePartition();
  p->capacity_rows = capacity_rows;
  p->columns.resize(ncols);
  p->item_sizes.assign(item_sizes, item_sizes + ncols);
  for (int c = 0; c < ncols; ++c) p->columns[c].resize(capacity_rows * item_sizes[c]);
  return p;
}

// Reserve nrows; returns starting row or (size_t)-1 on overflow
// (PrepareWrite, partition.cc:28-34).
size_t ue_partition_reserve(void* h, size_t nrows) {
  auto* p = static_cast<UePartition*>(h);
  size_t start = p->cursor.fetch_add(nrows, std::memory_order_relaxed);
  if (start + nrows > p->capacity_rows) {
    p->cursor.fetch_sub(nrows, std::memory_order_relaxed);
    return (size_t)-1;
  }
  return start;
}

// Copy rows into a previously reserved range (UnsafeWrite, partition.cc:36-46).
void ue_partition_write(void* h, int col, size_t start_row, const void* src,
                        size_t nrows) {
  auto* p = static_cast<UePartition*>(h);
  size_t isz = p->item_sizes[col];
  std::memcpy(p->columns[col].data() + start_row * isz, src, nrows * isz);
}

void* ue_partition_data(void* h, int col) {
  return static_cast<UePartition*>(h)->columns[col].data();
}

size_t ue_partition_rows(void* h) {
  return static_cast<UePartition*>(h)->cursor.load(std::memory_order_relaxed);
}

void ue_partition_free(void* h) { delete static_cast<UePartition*>(h); }

// ---------------------------------------------------------------------------
// Timers: named, per-rank, nanosecond, summed across ranks
// ---------------------------------------------------------------------------

// Reference Timer/Timers (host/timer/timer.{h,cc}): start/stop per rank id,
// Sum() over ranks, registry by name.
struct UeTimers {
  std::mutex mu;
  // name -> rank -> (accum_ns, start_ns or 0)
  std::map<std::string, std::map<int, std::pair<uint64_t, uint64_t>>> timers;
};

static uint64_t now_ns() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (uint64_t)ts.tv_sec * 1000000000ull + (uint64_t)ts.tv_nsec;
}

void* ue_timers_new() { return new UeTimers(); }
void ue_timers_free(void* h) { delete static_cast<UeTimers*>(h); }

void ue_timer_start(void* h, const char* name, int rank) {
  auto* t = static_cast<UeTimers*>(h);
  std::lock_guard<std::mutex> l(t->mu);
  t->timers[name][rank].second = now_ns();
}

void ue_timer_stop(void* h, const char* name, int rank) {
  auto* t = static_cast<UeTimers*>(h);
  uint64_t now = now_ns();
  std::lock_guard<std::mutex> l(t->mu);
  auto& slot = t->timers[name][rank];
  if (slot.second) {
    slot.first += now - slot.second;
    slot.second = 0;
  }
}

// Sum of accumulated ns across ranks (Timers::Sum analog).
uint64_t ue_timer_sum_ns(void* h, const char* name) {
  auto* t = static_cast<UeTimers*>(h);
  std::lock_guard<std::mutex> l(t->mu);
  auto it = t->timers.find(name);
  if (it == t->timers.end()) return 0;
  uint64_t sum = 0;
  for (auto& kv : it->second) sum += kv.second.first;
  return sum;
}

int ue_timer_rank_count(void* h, const char* name) {
  auto* t = static_cast<UeTimers*>(h);
  std::lock_guard<std::mutex> l(t->mu);
  auto it = t->timers.find(name);
  return it == t->timers.end() ? 0 : (int)it->second.size();
}

// ---------------------------------------------------------------------------
// Ordered async executor: N FIFO queues, one worker each
// ---------------------------------------------------------------------------

// The reference pipelines copy-in/exec/copy-out as ordered callbacks on
// per-rank queues (dpuext.hpp:859-899); ordering within a queue is the
// correctness backbone. This executor provides the same contract for host
// staging work (memcpy jobs), with sync() as the global barrier.
struct UeExecutor {
  struct Queue {
    std::mutex mu;
    std::condition_variable cv;
    std::deque<std::function<void()>> jobs;
    bool stop = false;
    std::thread worker;
  };
  std::vector<Queue> queues;
  std::atomic<size_t> inflight{0};
  std::mutex done_mu;
  std::condition_variable done_cv;

  explicit UeExecutor(int n) : queues(n) {
    for (auto& q : queues) {
      q.worker = std::thread([this, &q] {
        for (;;) {
          std::function<void()> job;
          {
            std::unique_lock<std::mutex> l(q.mu);
            q.cv.wait(l, [&] { return q.stop || !q.jobs.empty(); });
            if (q.jobs.empty()) return;  // stop && drained
            job = std::move(q.jobs.front());
            q.jobs.pop_front();
          }
          job();
          if (inflight.fetch_sub(1, std::memory_order_acq_rel) == 1) {
            std::lock_guard<std::mutex> l(done_mu);
            done_cv.notify_all();
          }
        }
      });
    }
  }

  ~UeExecutor() {
    for (auto& q : queues) {
      {
        std::lock_guard<std::mutex> l(q.mu);
        q.stop = true;
      }
      q.cv.notify_all();
    }
    for (auto& q : queues) q.worker.join();
  }

  void submit(int queue, std::function<void()> job) {
    auto& q = queues[queue % queues.size()];
    inflight.fetch_add(1, std::memory_order_acq_rel);
    {
      std::lock_guard<std::mutex> l(q.mu);
      q.jobs.push_back(std::move(job));
    }
    q.cv.notify_one();
  }

  void sync() {
    std::unique_lock<std::mutex> l(done_mu);
    done_cv.wait(l, [&] { return inflight.load(std::memory_order_acquire) == 0; });
  }
};

void* ue_executor_new(int nqueues) { return new UeExecutor(nqueues); }
void ue_executor_free(void* h) { delete static_cast<UeExecutor*>(h); }

void ue_executor_submit_memcpy(void* h, int queue, void* dst, const void* src,
                               size_t nbytes) {
  static_cast<UeExecutor*>(h)->submit(
      queue, [=] { std::memcpy(dst, src, nbytes); });
}

// Submit a copy into a partition slab behind a fresh reservation; writes the
// reserved start row into *out_row (the GetOffsets + background-memcpy flow,
// partitioner.cc:249-312).
void ue_executor_submit_partition_write(void* h, int queue, void* partition,
                                        int col, const void* src, size_t nrows,
                                        size_t start_row) {
  static_cast<UeExecutor*>(h)->submit(queue, [=] {
    ue_partition_write(partition, col, start_row, src, nrows);
  });
}

void ue_executor_sync(void* h) { static_cast<UeExecutor*>(h)->sync(); }

}  // extern "C"
