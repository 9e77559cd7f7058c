// Shared-memory SPSC ring buffer for DataLoader worker->trainer transport.
//
// Parity target: the reference's mmap shared-memory DataLoader IPC
// (paddle/fluid/memory/allocation/mmap_allocator.cc +
// fluid/dataloader/worker.py): worker processes place collated numpy
// batches in shared memory; the trainer process consumes them without
// a pipe copy. The trainer copies each batch into a pinned buffer and
// from there to the card (paddle_tpu_torch.io).
//
// Design: one ring per worker (single producer, single consumer), so
// synchronization is two C11 atomics (head/tail) with acquire/release
// ordering — no locks, no semaphores. Blocking ops spin with usleep
// and honor a timeout measured against CLOCK_MONOTONIC wall time —
// counting usleep(200) as exactly 200us undercounts by the scheduler's
// timer slack (observed ~5x), which turned a 2s liveness-poll tick
// into ~11s of dead-worker detection latency.
//
// The slot layout is the JAX package's (paddle_tpu/utils/cpp/
// shm_ring.cc), so a ring one package writes the other reads.
//
// Build: compiled with g++ (-lrt) at first use into
// paddle_tpu_torch/_build/ and bound with ctypes
// (paddle_tpu_torch.io.worker._ring_lib).

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>

#include <ctime>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

int64_t now_us() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (int64_t)ts.tv_sec * 1000000 + ts.tv_nsec / 1000;
}

struct RingHeader {
  uint64_t slots;
  uint64_t slot_bytes;
  std::atomic<uint64_t> head;  // next slot to write (producer)
  std::atomic<uint64_t> tail;  // next slot to read (consumer)
};

struct Ring {
  RingHeader* hdr;
  uint8_t* data;  // slots * (8-byte length prefix + slot_bytes)
  size_t map_bytes;
  int fd;
};

// Each slot = 64B header block (length prefix in the first 8 bytes)
// followed by a 64B-rounded payload area, and the data region itself
// starts 64B into the (page-aligned) mapping — so PAYLOADS ARE ALWAYS
// 64-BYTE ALIGNED. The zero-copy consumer reads payload-resident
// array bodies in place; producers align array bodies relative to the
// payload base, which is only meaningful because of this guarantee.
constexpr uint64_t kSlotHdr = 64;
constexpr uint64_t kDataOff = 64;

inline uint64_t slot_stride(uint64_t slot_bytes) {
  return kSlotHdr + ((slot_bytes + 63) & ~uint64_t(63));
}

inline uint8_t* slot_ptr(Ring* r, uint64_t idx) {
  return r->data + (idx % r->hdr->slots) * slot_stride(r->hdr->slot_bytes);
}

size_t total_bytes(uint64_t slots, uint64_t slot_bytes) {
  return kDataOff + slots * slot_stride(slot_bytes);
}

}  // namespace

extern "C" {

// Returns an opaque handle (0 on failure). create=1 initializes.
void* ring_open(const char* name, uint64_t slots, uint64_t slot_bytes,
                int create) {
  int flags = create ? (O_CREAT | O_RDWR) : O_RDWR;
  int fd = shm_open(name, flags, 0600);
  if (fd < 0) return nullptr;
  size_t bytes = total_bytes(slots, slot_bytes);
  if (create && ftruncate(fd, (off_t)bytes) != 0) {
    close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, bytes, PROT_READ | PROT_WRITE, MAP_SHARED,
                   fd, 0);
  if (mem == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  Ring* r = new Ring();
  r->hdr = reinterpret_cast<RingHeader*>(mem);
  r->data = reinterpret_cast<uint8_t*>(mem) + kDataOff;
  r->map_bytes = bytes;
  r->fd = fd;
  if (create) {
    r->hdr->slots = slots;
    r->hdr->slot_bytes = slot_bytes;
    r->hdr->head.store(0, std::memory_order_relaxed);
    r->hdr->tail.store(0, std::memory_order_relaxed);
  }
  return r;
}

// 0 ok; -1 timeout; -2 payload too large.
int ring_push(void* handle, const uint8_t* buf, uint64_t len,
              int64_t timeout_ms) {
  Ring* r = reinterpret_cast<Ring*>(handle);
  if (len > r->hdr->slot_bytes) return -2;
  int64_t t0_us = now_us();
  for (;;) {
    uint64_t head = r->hdr->head.load(std::memory_order_relaxed);
    uint64_t tail = r->hdr->tail.load(std::memory_order_acquire);
    if (head - tail < r->hdr->slots) {
      uint8_t* p = slot_ptr(r, head);
      std::memcpy(p, &len, 8);
      std::memcpy(p + kSlotHdr, buf, len);
      r->hdr->head.store(head + 1, std::memory_order_release);
      return 0;
    }
    if (timeout_ms >= 0 && now_us() - t0_us >= timeout_ms * 1000)
      return -1;
    usleep(200);
  }
}

// >=0: payload length; -1 timeout; -2 caller buffer too small.
int64_t ring_pop(void* handle, uint8_t* buf, uint64_t buf_len,
                 int64_t timeout_ms) {
  Ring* r = reinterpret_cast<Ring*>(handle);
  int64_t t0_us = now_us();
  for (;;) {
    uint64_t tail = r->hdr->tail.load(std::memory_order_relaxed);
    uint64_t head = r->hdr->head.load(std::memory_order_acquire);
    if (tail < head) {
      uint8_t* p = slot_ptr(r, tail);
      uint64_t len;
      std::memcpy(&len, p, 8);
      if (len > buf_len) return -2;
      std::memcpy(buf, p + kSlotHdr, len);
      r->hdr->tail.store(tail + 1, std::memory_order_release);
      return (int64_t)len;
    }
    if (timeout_ms >= 0 && now_us() - t0_us >= timeout_ms * 1000)
      return -1;
    usleep(200);
  }
}

// ---- zero-copy variants (r5) ----------------------------------------
// The copying push/pop above move every batch twice (worker buf ->
// slot, slot -> trainer buf). These variants expose the slot memory
// itself: the producer writes its serialized batch straight into the
// reserved slot; the consumer reads (deserializes out-of-band numpy
// buffers) directly from the slot and releases it afterwards. With
// pickle protocol-5 out-of-band buffers the batch arrays alias shared
// memory end to end — the only full copy left on the consumer side is
// the trainer's copy out of the slot (the reference's mmap_allocator.cc
// shared-memory-tensor semantics).

// Pointer to the payload area of the next free slot, or null on
// timeout. Single producer: at most one reservation outstanding.
uint8_t* ring_push_reserve(void* handle, int64_t timeout_ms) {
  Ring* r = reinterpret_cast<Ring*>(handle);
  int64_t t0_us = now_us();
  for (;;) {
    uint64_t head = r->hdr->head.load(std::memory_order_relaxed);
    uint64_t tail = r->hdr->tail.load(std::memory_order_acquire);
    if (head - tail < r->hdr->slots) return slot_ptr(r, head) + kSlotHdr;
    if (timeout_ms >= 0 && now_us() - t0_us >= timeout_ms * 1000)
      return nullptr;
    usleep(200);
  }
}

// Publish the reserved slot with `len` payload bytes. 0 ok, -2 too big.
int ring_push_commit(void* handle, uint64_t len) {
  Ring* r = reinterpret_cast<Ring*>(handle);
  if (len > r->hdr->slot_bytes) return -2;
  uint64_t head = r->hdr->head.load(std::memory_order_relaxed);
  std::memcpy(slot_ptr(r, head), &len, 8);
  r->hdr->head.store(head + 1, std::memory_order_release);
  return 0;
}

// Pointer to the current tail slot's payload (no copy, no consume), or
// null on timeout. *len_out receives the payload length. The slot
// stays owned by the consumer until ring_pop_release.
uint8_t* ring_pop_view(void* handle, uint64_t* len_out,
                       int64_t timeout_ms) {
  Ring* r = reinterpret_cast<Ring*>(handle);
  int64_t t0_us = now_us();
  for (;;) {
    uint64_t tail = r->hdr->tail.load(std::memory_order_relaxed);
    uint64_t head = r->hdr->head.load(std::memory_order_acquire);
    if (tail < head) {
      uint8_t* p = slot_ptr(r, tail);
      std::memcpy(len_out, p, 8);
      return p + kSlotHdr;
    }
    if (timeout_ms >= 0 && now_us() - t0_us >= timeout_ms * 1000)
      return nullptr;
    usleep(200);
  }
}

// Release the slot returned by ring_pop_view (advance tail).
void ring_pop_release(void* handle) {
  Ring* r = reinterpret_cast<Ring*>(handle);
  uint64_t tail = r->hdr->tail.load(std::memory_order_relaxed);
  r->hdr->tail.store(tail + 1, std::memory_order_release);
}

// Number of filled slots (diagnostic).
uint64_t ring_size(void* handle) {
  Ring* r = reinterpret_cast<Ring*>(handle);
  return r->hdr->head.load(std::memory_order_acquire) -
         r->hdr->tail.load(std::memory_order_acquire);
}

void ring_close(void* handle) {
  Ring* r = reinterpret_cast<Ring*>(handle);
  munmap(r->hdr, r->map_bytes);
  close(r->fd);
  delete r;
}

int ring_unlink(const char* name) { return shm_unlink(name); }

}  // extern "C"
