// Launch limits and helpers shared by the two kernels. A robot is carried
// by SPLIT aligned quads of threads (one thread per leg and replica,
// lane_math.cuh), so a launch over n robots has 4 SPLIT n threads; the
// split, the block size and the dynamic shared memory (the contact rows,
// ROW_VALS values per slot and leg column) are chosen in
// ops/cuda_engine.py::launch_geometry from the packed model, the type and
// n, and passed in. The constants here bound that choice and are mirrored
// there: tests/test_torch_launch.py holds the two together.
#pragma once

#include <cuda_runtime.h>

namespace qg {

// __launch_bounds__ of both kernels: the largest block the wrapper may ask
// for and the blocks an SM must be able to hold of it, which caps the
// registers per thread at 65,536 / (threads * blocks): here all 255. On an
// H100 the kernels ran faster with every register and 8 warps an SM than
// with 168 registers and 12 warps or 128 and 15: what they spill costs
// more than the warps bring (PERF.md has the times).
constexpr int MAX_THREADS = 128;
constexpr int MIN_BLOCKS = 2;

// Above 48 KB a kernel must be allowed its dynamic shared memory first.
// Returns the error of a request the card refuses (more than 227 KB).
template <typename K> int allow_shared(K kernel, int smem_bytes) {
  if (smem_bytes <= 48 * 1024) return 0;
  const int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != 0) cudaGetLastError();  // reported here; do not leave it for the next launch
  return err;
}

// What the runtime says of a kernel at a block size and shared size:
// registers per thread, local (stack + spill) bytes per thread, and the
// blocks of it that fit an SM together.
template <typename K>
int kernel_info(K kernel, int threads, int smem_bytes, int* registers, int* local_bytes,
                int* blocks_per_sm) {
  cudaFuncAttributes attr;
  int err = (int)cudaFuncGetAttributes(&attr, kernel);
  if (err != 0) return err;
  *registers = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  err = allow_shared(kernel, smem_bytes);
  if (err != 0) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, threads,
                                                            (size_t)smem_bytes);
}

}  // namespace qg
