// High-rate telemetry / trajectory logger: lock-free SPSC ring + writer
// thread.
//
// The reference logs training metrics by appending CSV rows from the
// callback thread (train_quadruped.py:86-110) — fine at 10 envs, but this
// framework streams metrics from solves running at 100 Hz x thousands of
// envs, and a Python-side file append on the control thread would stall
// the device feed (and take the GIL). This logger gives the hot loop an
// O(row) wait-free enqueue; a background thread drains the ring to disk in
// either CSV (reference-compatible schema) or a raw float64 binary stream.
//
// C ABI only (used via ctypes — no pybind11 in this image).

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Logger {
  std::vector<double> ring;     // capacity_rows * row_len
  std::vector<uint64_t> steps;  // capacity_rows
  size_t capacity_rows;
  size_t row_len;
  std::atomic<uint64_t> head{0};  // rows enqueued
  std::atomic<uint64_t> tail{0};  // rows written to disk
  std::atomic<uint64_t> dropped{0};
  std::atomic<bool> stop{false};
  FILE* file = nullptr;
  bool binary = false;
  std::thread writer;
  std::mutex wake_mutex;
  std::condition_variable wake;

  void writer_loop() {
    std::vector<double> row(row_len);
    while (true) {
      uint64_t h = head.load(std::memory_order_acquire);
      uint64_t t = tail.load(std::memory_order_relaxed);
      if (t == h) {
        if (stop.load(std::memory_order_acquire)) break;
        std::unique_lock<std::mutex> lk(wake_mutex);
        wake.wait_for(lk, std::chrono::milliseconds(50));
        continue;
      }
      while (t < h) {
        size_t slot = static_cast<size_t>(t % capacity_rows);
        std::memcpy(row.data(), &ring[slot * row_len],
                    row_len * sizeof(double));
        uint64_t step = steps[slot];
        if (binary) {
          fwrite(&step, sizeof(uint64_t), 1, file);
          fwrite(row.data(), sizeof(double), row_len, file);
        } else {
          fprintf(file, "%llu", static_cast<unsigned long long>(step));
          double total = 0;
          for (size_t i = 0; i < row_len; ++i) total += row[i];
          fprintf(file, ",%.10g", total);
          for (size_t i = 0; i < row_len; ++i) fprintf(file, ",%.10g", row[i]);
          fputc('\n', file);
        }
        ++t;
        tail.store(t, std::memory_order_release);
      }
      fflush(file);
    }
    fflush(file);
  }
};

}  // namespace

extern "C" {

// Returns an opaque handle, or null on failure. header: comma-separated
// component names (CSV mode writes "step,total,<header>" as line 1).
void* qgt_logger_open(const char* path, const char* header, size_t row_len,
                      size_t capacity_rows, int binary, int append) {
  Logger* lg = new Logger();
  lg->row_len = row_len;
  lg->capacity_rows = capacity_rows ? capacity_rows : 1 << 16;
  lg->ring.resize(lg->capacity_rows * row_len);
  lg->steps.resize(lg->capacity_rows);
  lg->binary = binary != 0;
  const char* mode = append ? (binary ? "ab" : "a") : (binary ? "wb" : "w");
  // detect fresh file for the CSV header
  bool fresh = true;
  if (append) {
    FILE* probe = fopen(path, "rb");
    if (probe) {
      fseek(probe, 0, SEEK_END);
      fresh = ftell(probe) == 0;
      fclose(probe);
    }
  }
  lg->file = fopen(path, mode);
  if (!lg->file) {
    delete lg;
    return nullptr;
  }
  if (!lg->binary && fresh && header && header[0]) {
    fprintf(lg->file, "step,total,%s\n", header);
    fflush(lg->file);
  }
  lg->writer = std::thread([lg] { lg->writer_loop(); });
  return lg;
}

// Wait-free from the producer side. Returns 0 on success, 1 if the ring was
// full and the row was dropped (counted).
int qgt_logger_log(void* handle, uint64_t step, const double* row) {
  Logger* lg = static_cast<Logger*>(handle);
  uint64_t h = lg->head.load(std::memory_order_relaxed);
  uint64_t t = lg->tail.load(std::memory_order_acquire);
  if (h - t >= lg->capacity_rows) {
    lg->dropped.fetch_add(1, std::memory_order_relaxed);
    return 1;
  }
  size_t slot = static_cast<size_t>(h % lg->capacity_rows);
  std::memcpy(&lg->ring[slot * lg->row_len], row,
              lg->row_len * sizeof(double));
  lg->steps[slot] = step;
  lg->head.store(h + 1, std::memory_order_release);
  lg->wake.notify_one();
  return 0;
}

// Batch enqueue: rows is (n, row_len) row-major, steps ascending from step0.
int qgt_logger_log_many(void* handle, uint64_t step0, const double* rows,
                        size_t n) {
  Logger* lg = static_cast<Logger*>(handle);
  int rc = 0;
  for (size_t i = 0; i < n; ++i) {
    rc |= qgt_logger_log(handle, step0 + i, rows + i * lg->row_len);
  }
  (void)lg;
  return rc;
}

uint64_t qgt_logger_dropped(void* handle) {
  return static_cast<Logger*>(handle)->dropped.load();
}

// Blocks until the ring is drained to disk.
void qgt_logger_flush(void* handle) {
  Logger* lg = static_cast<Logger*>(handle);
  while (lg->tail.load(std::memory_order_acquire) <
         lg->head.load(std::memory_order_acquire)) {
    lg->wake.notify_one();
    std::this_thread::sleep_for(std::chrono::milliseconds(1));
  }
}

void qgt_logger_close(void* handle) {
  Logger* lg = static_cast<Logger*>(handle);
  lg->stop.store(true, std::memory_order_release);
  lg->wake.notify_one();
  if (lg->writer.joinable()) lg->writer.join();
  fclose(lg->file);
  delete lg;
}

}  // extern "C"
