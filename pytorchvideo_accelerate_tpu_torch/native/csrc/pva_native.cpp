// pva_native: the native runtime of the port's process transport (the
// port's own copy of the JAX package's native/pva_native.cpp; the code is
// the same, so a ring slot written by either package reads back in the
// other).
//
// Decode workers run in forked processes (a full escape from the
// interpreter lock) and write each decoded, transformed sample straight
// into a slot of a ring buffer in anonymous shared memory; the trainer
// process maps the same pages and assembles batches with a multithreaded
// gather-copy. No pickling, no pipe syscalls per sample, no per-batch
// allocation.
//
// Synchronization: one PTHREAD_PROCESS_SHARED mutex + two condvars in the
// shm header guard a free-list and a ready-queue of slot ids. All waits are
// timed (robust against a dead peer; callers retry/abort on timeout).
//
// Built with plain g++ -shared (no external deps) at first use and loaded
// via ctypes (pytorchvideo_accelerate_tpu_torch/native/__init__.py). The
// layout is single-machine, same-architecture: not a wire format.

#include <pthread.h>

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <ctime>
#include <thread>
#include <vector>

namespace {

constexpr uint64_t kMagic = 0x70766172696E6731ULL;  // "pvaring1"
constexpr uint32_t kAlign = 64;

struct Header {
  uint64_t magic;
  uint32_t n_slots;
  uint64_t slot_bytes;
  uint64_t data_off;   // byte offset of slot 0 from base
  uint64_t meta_off;   // byte offset of per-slot meta arrays
  pthread_mutex_t mu;
  pthread_cond_t cv_free;
  pthread_cond_t cv_ready;
  // ring of free slot ids and ring of ready slot ids
  uint32_t free_head, free_count;
  uint32_t ready_head, ready_count;
  uint32_t shutdown;
};

struct SlotMeta {
  uint64_t nbytes;
  uint64_t tag;
};

inline uint64_t align_up(uint64_t v) { return (v + kAlign - 1) & ~uint64_t(kAlign - 1); }

inline Header* hdr(void* base) { return reinterpret_cast<Header*>(base); }
inline uint32_t* free_ring(void* base, Header* h) {
  return reinterpret_cast<uint32_t*>(static_cast<char*>(base) + sizeof(Header));
}
inline uint32_t* ready_ring(void* base, Header* h) {
  return free_ring(base, h) + h->n_slots;
}
inline SlotMeta* metas(void* base, Header* h) {
  return reinterpret_cast<SlotMeta*>(static_cast<char*>(base) + h->meta_off);
}

void abstime_in(timespec* ts, int timeout_ms) {
  clock_gettime(CLOCK_REALTIME, ts);
  ts->tv_sec += timeout_ms / 1000;
  ts->tv_nsec += (timeout_ms % 1000) * 1000000L;
  if (ts->tv_nsec >= 1000000000L) {
    ts->tv_sec += 1;
    ts->tv_nsec -= 1000000000L;
  }
}

}  // namespace

extern "C" {

// Total shm bytes needed for a ring of n_slots x slot_bytes.
uint64_t pva_rb_total_size(uint32_t n_slots, uint64_t slot_bytes) {
  uint64_t off = align_up(sizeof(Header) + 2ULL * n_slots * sizeof(uint32_t));
  uint64_t meta = align_up(off + n_slots * sizeof(SlotMeta));
  return meta + n_slots * align_up(slot_bytes);
}

// Initialize a ring in (zeroed) shared memory. Parent-process only, once.
int pva_rb_init(void* base, uint32_t n_slots, uint64_t slot_bytes) {
  Header* h = hdr(base);
  h->magic = kMagic;
  h->n_slots = n_slots;
  h->slot_bytes = align_up(slot_bytes);
  uint64_t rings_end = sizeof(Header) + 2ULL * n_slots * sizeof(uint32_t);
  h->meta_off = align_up(rings_end);
  h->data_off = align_up(h->meta_off + n_slots * sizeof(SlotMeta));
  h->free_head = 0;
  h->free_count = n_slots;
  h->ready_head = 0;
  h->ready_count = 0;
  h->shutdown = 0;
  uint32_t* fr = free_ring(base, h);
  for (uint32_t i = 0; i < n_slots; ++i) fr[i] = i;

  pthread_mutexattr_t ma;
  pthread_mutexattr_init(&ma);
  pthread_mutexattr_setpshared(&ma, PTHREAD_PROCESS_SHARED);
  if (pthread_mutex_init(&h->mu, &ma) != 0) return -1;
  pthread_condattr_t ca;
  pthread_condattr_init(&ca);
  pthread_condattr_setpshared(&ca, PTHREAD_PROCESS_SHARED);
  if (pthread_cond_init(&h->cv_free, &ca) != 0) return -1;
  if (pthread_cond_init(&h->cv_ready, &ca) != 0) return -1;
  return 0;
}

void* pva_rb_slot_ptr(void* base, uint32_t slot) {
  Header* h = hdr(base);
  return static_cast<char*>(base) + h->data_off + uint64_t(slot) * align_up(h->slot_bytes);
}

uint64_t pva_rb_slot_bytes(void* base) { return hdr(base)->slot_bytes; }

// Producer: take a free slot (blocks up to timeout_ms). -1 timeout, -2 shutdown.
int pva_rb_acquire(void* base, int timeout_ms) {
  Header* h = hdr(base);
  timespec ts;
  abstime_in(&ts, timeout_ms);
  pthread_mutex_lock(&h->mu);
  while (h->free_count == 0 && !h->shutdown) {
    if (pthread_cond_timedwait(&h->cv_free, &h->mu, &ts) == ETIMEDOUT) {
      pthread_mutex_unlock(&h->mu);
      return -1;
    }
  }
  if (h->shutdown) {
    pthread_mutex_unlock(&h->mu);
    return -2;
  }
  uint32_t slot = free_ring(base, h)[h->free_head];
  h->free_head = (h->free_head + 1) % h->n_slots;
  h->free_count--;
  pthread_mutex_unlock(&h->mu);
  return static_cast<int>(slot);
}

// Producer: publish a filled slot.
int pva_rb_commit(void* base, uint32_t slot, uint64_t nbytes, uint64_t tag) {
  Header* h = hdr(base);
  SlotMeta* m = metas(base, h);
  m[slot].nbytes = nbytes;
  m[slot].tag = tag;
  pthread_mutex_lock(&h->mu);
  uint32_t pos = (h->ready_head + h->ready_count) % h->n_slots;
  ready_ring(base, h)[pos] = slot;
  h->ready_count++;
  pthread_cond_signal(&h->cv_ready);
  pthread_mutex_unlock(&h->mu);
  return 0;
}

// Consumer: pop the oldest ready slot. -1 timeout, -2 shutdown+drained.
int pva_rb_pop(void* base, int timeout_ms, uint64_t* nbytes, uint64_t* tag) {
  Header* h = hdr(base);
  timespec ts;
  abstime_in(&ts, timeout_ms);
  pthread_mutex_lock(&h->mu);
  while (h->ready_count == 0) {
    if (h->shutdown) {
      pthread_mutex_unlock(&h->mu);
      return -2;
    }
    if (pthread_cond_timedwait(&h->cv_ready, &h->mu, &ts) == ETIMEDOUT) {
      pthread_mutex_unlock(&h->mu);
      return -1;
    }
  }
  uint32_t slot = ready_ring(base, h)[h->ready_head];
  h->ready_head = (h->ready_head + 1) % h->n_slots;
  h->ready_count--;
  pthread_mutex_unlock(&h->mu);
  SlotMeta* m = metas(base, h);
  if (nbytes) *nbytes = m[slot].nbytes;
  if (tag) *tag = m[slot].tag;
  return static_cast<int>(slot);
}

// Consumer: return a drained slot to the free list.
int pva_rb_release(void* base, uint32_t slot) {
  Header* h = hdr(base);
  pthread_mutex_lock(&h->mu);
  uint32_t pos = (h->free_head + h->free_count) % h->n_slots;
  free_ring(base, h)[pos] = slot;
  h->free_count++;
  pthread_cond_signal(&h->cv_free);
  pthread_mutex_unlock(&h->mu);
  return 0;
}

// Wake all waiters permanently (loader close / worker exit signal).
void pva_rb_shutdown(void* base) {
  Header* h = hdr(base);
  pthread_mutex_lock(&h->mu);
  h->shutdown = 1;
  pthread_cond_broadcast(&h->cv_free);
  pthread_cond_broadcast(&h->cv_ready);
  pthread_mutex_unlock(&h->mu);
}

uint32_t pva_rb_ready_count(void* base) {
  Header* h = hdr(base);
  pthread_mutex_lock(&h->mu);
  uint32_t c = h->ready_count;
  pthread_mutex_unlock(&h->mu);
  return c;
}

// Multithreaded gather-copy: dst[off[i] : off[i]+sizes[i]] = *srcs[i].
// Batch assembly without the GIL (ctypes releases it for the call); items
// are striped over threads by cumulative size.
int pva_gather_copy(char* dst, const char** srcs, const uint64_t* offs,
                    const uint64_t* sizes, uint32_t n, uint32_t n_threads) {
  if (n == 0) return 0;
  if (n_threads <= 1 || n == 1) {
    for (uint32_t i = 0; i < n; ++i) memcpy(dst + offs[i], srcs[i], sizes[i]);
    return 0;
  }
  uint64_t total = 0;
  for (uint32_t i = 0; i < n; ++i) total += sizes[i];
  uint64_t per = total / n_threads + 1;
  std::vector<std::thread> threads;
  uint32_t i = 0;
  for (uint32_t t = 0; t < n_threads && i < n; ++t) {
    uint64_t budget = 0;
    uint32_t start = i;
    while (i < n && budget < per) budget += sizes[i++];
    threads.emplace_back([=]() {
      for (uint32_t j = start; j < i; ++j) memcpy(dst + offs[j], srcs[j], sizes[j]);
    });
  }
  for (auto& th : threads) th.join();
  return 0;
}

}  // extern "C"
