// Native host-runtime components for qm_control_tpu.
//
// The reference's runtime around the solver is C++ (ros_control plugin
// lifecycle, realtime_tools lock-free buffers, OCS2 executeAndSleep /
// setThreadPriority, the Gazebo QMHWSim actuation-delay deque). The JAX
// compute path needs none of that, but the HOST side of a real deployment
// does; this library provides TPU-host-native equivalents, consumed from
// Python via ctypes (qm_control_tpu/native/__init__.py):
//
//   1. PolicyBuffer  — seqlock double buffer for MPC policy snapshots
//      (realtime_tools::RealtimeBuffer equivalent; reference
//      QMController.h:111, FromTopiceEstimate.h). Writer never blocks;
//      readers retry on a torn read.
//   2. DelayLine     — timestamped command ring replaying entries
//      `delay` seconds old (QMHWSim.cpp:98-116 fault injection).
//   3. RatePacer     — absolute-deadline loop pacing with
//      clock_nanosleep(TIMER_ABSTIME) and optional SCHED_FIFO priority
//      (OCS2 executeAndSleep / setThreadPriority; reference
//      QMController.cpp:318-326).
//
// Build: make -C native   (g++ -O2 -shared -fPIC, no dependencies).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <ctime>
#include <new>

#include <pthread.h>
#include <sched.h>

extern "C" {

// ---------------------------------------------------------------------------
// 1. PolicyBuffer: seqlock over an opaque fixed-size payload.
// ---------------------------------------------------------------------------

struct PolicyBuffer {
  std::atomic<uint64_t> seq{0};
  uint64_t payload_bytes{0};
  double stamp{0.0};
  // payload follows the header (allocated together)
  unsigned char data[];  // flexible array member
};

PolicyBuffer* policy_buffer_create(uint64_t payload_bytes) {
  void* mem = ::operator new(sizeof(PolicyBuffer) + payload_bytes,
                             std::align_val_t(64));
  auto* b = new (mem) PolicyBuffer();
  b->payload_bytes = payload_bytes;
  std::memset(b->data, 0, payload_bytes);
  return b;
}

void policy_buffer_destroy(PolicyBuffer* b) {
  if (b) {
    b->~PolicyBuffer();
    ::operator delete(static_cast<void*>(b), std::align_val_t(64));
  }
}

// Writer: bump seq to odd (write in progress), copy, bump to even.
void policy_buffer_write(PolicyBuffer* b, const unsigned char* src,
                         uint64_t n, double stamp) {
  if (n > b->payload_bytes) n = b->payload_bytes;
  uint64_t s = b->seq.load(std::memory_order_relaxed);
  b->seq.store(s + 1, std::memory_order_release);  // odd: writing
  std::atomic_thread_fence(std::memory_order_acq_rel);
  std::memcpy(b->data, src, n);
  b->stamp = stamp;
  std::atomic_thread_fence(std::memory_order_acq_rel);
  b->seq.store(s + 2, std::memory_order_release);  // even: stable
}

// Reader: returns 1 on a consistent snapshot, 0 if no data yet.
// Retries internally on torn reads (bounded).
int policy_buffer_read(PolicyBuffer* b, unsigned char* dst, uint64_t n,
                       double* stamp_out) {
  if (n > b->payload_bytes) n = b->payload_bytes;
  for (int attempt = 0; attempt < 1000; ++attempt) {
    uint64_t s1 = b->seq.load(std::memory_order_acquire);
    if (s1 == 0) return 0;       // never written
    if (s1 & 1) continue;        // write in progress
    std::atomic_thread_fence(std::memory_order_acquire);
    std::memcpy(dst, b->data, n);
    double st = b->stamp;
    std::atomic_thread_fence(std::memory_order_acquire);
    uint64_t s2 = b->seq.load(std::memory_order_acquire);
    if (s1 == s2) {
      if (stamp_out) *stamp_out = st;
      return 1;
    }
  }
  return 0;
}

uint64_t policy_buffer_version(PolicyBuffer* b) {
  return b->seq.load(std::memory_order_acquire) / 2;
}

// ---------------------------------------------------------------------------
// 2. DelayLine: timestamped ring buffer of fixed-size records.
// ---------------------------------------------------------------------------

struct DelayLine {
  uint64_t record_bytes{0};
  uint64_t capacity{0};
  uint64_t head{0};  // next write slot
  uint64_t count{0};
  double* stamps{nullptr};
  unsigned char* records{nullptr};
};

DelayLine* delay_line_create(uint64_t record_bytes, uint64_t capacity) {
  auto* d = new DelayLine();
  d->record_bytes = record_bytes;
  d->capacity = capacity;
  d->stamps = new double[capacity]();
  d->records = new unsigned char[record_bytes * capacity]();
  return d;
}

void delay_line_destroy(DelayLine* d) {
  if (d) {
    delete[] d->stamps;
    delete[] d->records;
    delete d;
  }
}

void delay_line_push(DelayLine* d, double stamp, const unsigned char* rec) {
  std::memcpy(d->records + d->head * d->record_bytes, rec, d->record_bytes);
  d->stamps[d->head] = stamp;
  d->head = (d->head + 1) % d->capacity;
  if (d->count < d->capacity) ++d->count;
}

// Newest record with stamp <= now - delay; falls back to the oldest held
// record (the reference replays the front of the deque the same way).
// Returns 1 if a record was produced.
int delay_line_read(DelayLine* d, double now, double delay,
                    unsigned char* out) {
  if (d->count == 0) return 0;
  const double cutoff = now - delay;
  uint64_t best = d->capacity;  // invalid
  // scan from newest backwards
  for (uint64_t i = 0; i < d->count; ++i) {
    uint64_t idx = (d->head + d->capacity - 1 - i) % d->capacity;
    if (d->stamps[idx] <= cutoff) {
      best = idx;
      break;
    }
  }
  if (best == d->capacity) {  // nothing old enough: replay the oldest
    best = (d->head + d->capacity - d->count) % d->capacity;
  }
  std::memcpy(out, d->records + best * d->record_bytes, d->record_bytes);
  return 1;
}

// ---------------------------------------------------------------------------
// 3. RatePacer: absolute-deadline pacing (drift-free) + RT priority.
// ---------------------------------------------------------------------------

struct RatePacer {
  struct timespec next {};
  long period_ns{0};
  uint64_t overruns{0};
};

static void ts_add_ns(struct timespec* t, long ns) {
  t->tv_nsec += ns;
  while (t->tv_nsec >= 1000000000L) {
    t->tv_nsec -= 1000000000L;
    t->tv_sec += 1;
  }
}

RatePacer* rate_pacer_create(double frequency_hz) {
  auto* p = new RatePacer();
  p->period_ns = static_cast<long>(1e9 / frequency_hz);
  clock_gettime(CLOCK_MONOTONIC, &p->next);
  ts_add_ns(&p->next, p->period_ns);
  return p;
}

void rate_pacer_destroy(RatePacer* p) { delete p; }

// Sleep until the next absolute deadline (OCS2 executeAndSleep).
// Returns the number of whole periods missed (0 = on time).
uint64_t rate_pacer_sleep(RatePacer* p) {
  struct timespec now;
  clock_gettime(CLOCK_MONOTONIC, &now);
  uint64_t missed = 0;
  while (now.tv_sec > p->next.tv_sec ||
         (now.tv_sec == p->next.tv_sec && now.tv_nsec > p->next.tv_nsec)) {
    ts_add_ns(&p->next, p->period_ns);
    ++missed;
  }
  if (missed > 0) p->overruns += missed;
  clock_nanosleep(CLOCK_MONOTONIC, TIMER_ABSTIME, &p->next, nullptr);
  ts_add_ns(&p->next, p->period_ns);
  return missed;
}

uint64_t rate_pacer_overruns(RatePacer* p) { return p->overruns; }

// setThreadPriority equivalent: SCHED_FIFO (needs privileges; returns 0
// on success, errno otherwise — callers fall back silently).
int set_realtime_priority(int priority) {
  struct sched_param sp {};
  sp.sched_priority = priority;
  return pthread_setschedparam(pthread_self(), SCHED_FIFO, &sp);
}

}  // extern "C"
