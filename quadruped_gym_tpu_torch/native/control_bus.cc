// Shared-memory real-time control bus: the hardware bridge between the
// TPU control loop and a robot driver process.
//
// The reference talks to its (simulated) robot in-process through MuJoCo
// bindings; a real deployment of this framework runs the MPC loop in one
// process (feeding the TPU) and the servo/IMU driver in another, at
// 100 Hz with hard deadlines. This bus gives them a wait-free exchange:
// two seqlock-protected blocks in POSIX shared memory —
//   sensor block: driver writes (timestamp + nsensor doubles), MPC reads
//   ctrl block:   MPC writes (timestamp + nctrl doubles), driver reads
// Writers never block or take locks (increment seq to odd, store, seq to
// even); readers retry on torn/odd sequence numbers. Either side can
// crash and reattach without corrupting the other.
//
// C ABI only (used via ctypes — no pybind11 in this image).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x716774627573ULL;  // "qgtbus"

struct BlockHeader {
  std::atomic<uint64_t> seq;  // odd while a write is in flight
  double timestamp;
};

struct ShmHeader {
  uint64_t magic;
  uint32_t nsensor;
  uint32_t nctrl;
};

struct Bus {
  void* base = nullptr;
  size_t size = 0;
  uint32_t nsensor = 0;
  uint32_t nctrl = 0;
  char name[256];
};

size_t block_bytes(uint32_t n) {
  return sizeof(BlockHeader) + n * sizeof(double);
}

size_t total_bytes(uint32_t nsensor, uint32_t nctrl) {
  return sizeof(ShmHeader) + block_bytes(nsensor) + block_bytes(nctrl);
}

BlockHeader* sensor_block(Bus* b) {
  return reinterpret_cast<BlockHeader*>(
      static_cast<char*>(b->base) + sizeof(ShmHeader));
}

BlockHeader* ctrl_block(Bus* b) {
  return reinterpret_cast<BlockHeader*>(
      static_cast<char*>(b->base) + sizeof(ShmHeader) +
      block_bytes(b->nsensor));
}

double* block_data(BlockHeader* h) {
  return reinterpret_cast<double*>(h + 1);
}

void seqlock_write(BlockHeader* h, const double* v, uint32_t n, double t) {
  // parity self-heals after a writer crash: if the previous writer died
  // mid-write (seq left odd), start from the NEXT odd value so the
  // invariant (odd = in flight, even = consistent) is restored
  uint64_t s = h->seq.load(std::memory_order_relaxed);
  uint64_t odd = (s & 1) ? s + 2 : s + 1;
  h->seq.store(odd, std::memory_order_release);  // odd: write in flight
  std::atomic_thread_fence(std::memory_order_release);
  h->timestamp = t;
  std::memcpy(block_data(h), v, n * sizeof(double));
  std::atomic_thread_fence(std::memory_order_release);
  h->seq.store(odd + 1, std::memory_order_release);  // even: consistent
}

// returns the (even) sequence number of the snapshot, or 0 if no
// consistent snapshot is available (never written, or the writer died
// mid-write and has not yet reattached — bounded retries keep the
// 100 Hz caller from hanging; it holds its last value instead)
uint64_t seqlock_read(BlockHeader* h, double* v, uint32_t n, double* t) {
  for (int attempt = 0; attempt < 1000; ++attempt) {
    uint64_t s1 = h->seq.load(std::memory_order_acquire);
    if (s1 == 0) return 0;
    if (s1 & 1) continue;  // write in flight (or a crashed writer)
    std::atomic_thread_fence(std::memory_order_acquire);
    double ts = h->timestamp;
    std::memcpy(v, block_data(h), n * sizeof(double));
    std::atomic_thread_fence(std::memory_order_acquire);
    uint64_t s2 = h->seq.load(std::memory_order_acquire);
    if (s1 == s2) {
      if (t) *t = ts;
      return s1;
    }
  }
  return 0;
}

Bus* map_bus(const char* name, int fd, size_t size) {
  void* base = mmap(nullptr, size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (base == MAP_FAILED) return nullptr;
  Bus* b = new Bus();
  b->base = base;
  b->size = size;
  std::snprintf(b->name, sizeof(b->name), "%s", name);
  return b;
}

}  // namespace

extern "C" {

void* qgt_bus_create(const char* name, int nsensor, int nctrl) {
  if (nsensor <= 0 || nctrl <= 0) return nullptr;
  size_t size = total_bytes(nsensor, nctrl);
  // always create a FRESH segment: unlink any stale one first, then
  // O_EXCL. Peers still attached to an old segment keep their own
  // (now-anonymous) mapping untouched — re-truncating a live object in
  // place would shift their block offsets under them (or SIGBUS them).
  shm_unlink(name);
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  if (ftruncate(fd, static_cast<off_t>(size)) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  Bus* b = map_bus(name, fd, size);
  if (!b) {
    shm_unlink(name);
    return nullptr;
  }
  auto* hdr = static_cast<ShmHeader*>(b->base);
  hdr->nsensor = b->nsensor = static_cast<uint32_t>(nsensor);
  hdr->nctrl = b->nctrl = static_cast<uint32_t>(nctrl);
  sensor_block(b)->seq.store(0, std::memory_order_relaxed);
  ctrl_block(b)->seq.store(0, std::memory_order_relaxed);
  std::atomic_thread_fence(std::memory_order_release);
  hdr->magic = kMagic;  // published last: attachers check it
  return b;
}

void* qgt_bus_open(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < (off_t)sizeof(ShmHeader)) {
    close(fd);
    return nullptr;
  }
  // map the header first to learn the dims
  void* peek = mmap(nullptr, sizeof(ShmHeader), PROT_READ, MAP_SHARED, fd, 0);
  if (peek == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  auto* hdr = static_cast<ShmHeader*>(peek);
  if (hdr->magic != kMagic) {
    munmap(peek, sizeof(ShmHeader));
    close(fd);
    return nullptr;
  }
  uint32_t ns = hdr->nsensor, nc = hdr->nctrl;
  munmap(peek, sizeof(ShmHeader));
  size_t size = total_bytes(ns, nc);
  if (st.st_size < (off_t)size) {
    close(fd);
    return nullptr;
  }
  Bus* b = map_bus(name, fd, size);
  if (!b) return nullptr;
  b->nsensor = ns;
  b->nctrl = nc;
  return b;
}

int qgt_bus_nsensor(void* h) { return static_cast<Bus*>(h)->nsensor; }
int qgt_bus_nctrl(void* h) { return static_cast<Bus*>(h)->nctrl; }

void qgt_bus_write_sensor(void* h, const double* v, double t) {
  Bus* b = static_cast<Bus*>(h);
  seqlock_write(sensor_block(b), v, b->nsensor, t);
}

void qgt_bus_write_ctrl(void* h, const double* v, double t) {
  Bus* b = static_cast<Bus*>(h);
  seqlock_write(ctrl_block(b), v, b->nctrl, t);
}

// return: snapshot sequence number (even, >0), or 0 if never written
unsigned long long qgt_bus_read_sensor(void* h, double* v, double* t) {
  Bus* b = static_cast<Bus*>(h);
  return seqlock_read(sensor_block(b), v, b->nsensor, t);
}

unsigned long long qgt_bus_read_ctrl(void* h, double* v, double* t) {
  Bus* b = static_cast<Bus*>(h);
  return seqlock_read(ctrl_block(b), v, b->nctrl, t);
}

void qgt_bus_close(void* h) {
  Bus* b = static_cast<Bus*>(h);
  munmap(b->base, b->size);
  delete b;
}

int qgt_bus_unlink(const char* name) { return shm_unlink(name); }

}  // extern "C"
