// Fused whole-rollout cost kernel for Hopper (sm_90a).
//
// Replaces quadruped_gym_tpu/ops/pallas_engine.py::_rollout_kernel (the
// Pallas TPU kernel behind fused_rollout_cost): for each of S rollouts
// from one shared start state, H control steps x frame_skip leg-engine
// substeps at a fixed Newton / line-search budget, sensors on the last
// substep of each control step, and the walking stage cost summed into
// out[s].
//
// Bound: operations, in FP32 (the main path) or FP64 outside the tensor
// cores. A rollout reads 12 H control values and writes one cost, but
// every substep runs tens of thousands of operations (forward kinematics,
// composite inertia, RNE, two tree-sparse LDLᵀ factorizations, the
// hull-vertex selection loops and the Newton solve); the count comes from
// the plain version (ops/cuda_engine.py::rollout_flops). Nothing here
// maps onto the tensor cores, and the chains of dependent operations
// (1/x, sqrt, sin/cos, the factorizations) make the warps wait on
// latency. What the kernel needs is little state per thread, so that
// nothing goes through local memory, and then as many resident warps as
// that leaves room for; on an H100 spills cost it more than warps bring
// (launch.cuh).
//
// Design: a thread per LEG. An aligned quad of a warp carries one rollout
// (thread lane & 3 owns that leg), so a block of T threads holds T / 4
// rollouts and the grid is 4 S threads. Each thread keeps its own leg's
// kinematics, inertias, mass-matrix blocks and factors in registers, a
// quarter of what a whole robot needs, and a replica of the small
// free-base quantities, computed redundantly. The legs couple only
// through sums over the four legs, each two __shfl_xor_sync steps inside
// the quad (lane_math.cuh::quad_sum) that leave the same bits in all four
// threads. The contact rows, whose slot index is a run-time value, live in
// dynamic shared memory: only the model's own slots, laid out
// [value][thread] so a warp's accesses fall on 32 banks
// (leg_step.cuh::RowStore). The wrapper sizes the block so that these
// rows fit the 227 KB of an SM and passes threads and bytes in; a request
// the card refuses comes back as the launch's error. Threads past the
// ragged edge stay alive on a clamped rollout index (the quad sums need
// all 32 lanes) and only their store is masked. The (H, 12, S) control
// read is four 32-byte segments a warp per row. The model constants are
// one packed struct (leg_model.cuh) read through the read-only cache.
// Vertex selection and slot loops are run-time loops over that struct, so
// code size does not grow with the hulls; selections are strict < / >
// compare-and-keep, as the plain version's _collide_loop.
//
// Build (ops/_build.py): nvcc -gencode arch=compute_90a,code=sm_90a
// -std=c++17 -O3 -shared -Xcompiler -fPIC -DQG_REAL=float|double.

#include "launch.cuh"
#include "rollout.cuh"

#ifndef QG_REAL
#define QG_REAL float
#endif

namespace qg {

using Real = QG_REAL;

__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS)
fused_rollout_kernel(const LegModel<Real>* __restrict__ model, const Real* __restrict__ qpos0,
                     const Real* __restrict__ qvel0, const Real* __restrict__ act0,
                     const Real* __restrict__ seqs, const Real* __restrict__ prev0,
                     const Real* __restrict__ cmd, DomainLanes<Real> lanes,
                     Real* __restrict__ out, int S, int H, int frame_skip, int iterations,
                     int ls_iterations, Real height) {
  extern __shared__ __align__(16) unsigned char qg_smem[];
  const int r = (blockIdx.x * blockDim.x + threadIdx.x) >> 2;
  const int leg = threadIdx.x & 3;
  const bool valid = r < S;
  const int s = valid ? r : S - 1;
  const RowStore<1, Real> rows{reinterpret_cast<Real*>(qg_smem) + threadIdx.x,
                               (size_t)blockDim.x};
  const Real cost = rollout_cost<1>(*model, qpos0, qvel0, act0, seqs, prev0, cmd, lanes, leg, s,
                                    S, H, frame_skip, iterations, ls_iterations, height, rows);
  if (valid && leg == 0) out[s] = cost;
}

}  // namespace qg
extern "C" {

// sizeof(LegModel<QG_REAL>): the wrapper checks it against its ctypes
// struct before the first upload
int qg_model_size() { return (int)sizeof(qg::LegModel<QG_REAL>); }

// registers, local bytes and resident blocks per SM of the kernel at a
// block size and dynamic shared size; returns a CUDA error code, 0 if none
int qg_kernel_info(int threads, int smem_bytes, int* registers, int* local_bytes,
                   int* blocks_per_sm) {
  return qg::kernel_info(qg::fused_rollout_kernel, threads, smem_bytes, registers,
                         local_bytes, blocks_per_sm);
}

// Launch ``grid`` blocks of ``threads`` (4 threads a rollout) with
// ``smem_bytes`` of dynamic shared memory on ``stream``; returns the CUDA
// error of the request or of the launch (0 on success). Every pointer is
// device memory; DomainParams lanes are nullptr where nominal.
int qg_fused_rollout(const void* model, const void* qpos0, const void* qvel0, const void* act0,
                     const void* seqs, const void* prev0, const void* cmd,
                     const void* friction, const void* gain_scale, const void* base_mass_scale,
                     const void* tilt_x, const void* tilt_y, const void* terrain_amp,
                     const void* terrain_freq, void* out, int S, int H, int frame_skip,
                     int iterations, int ls_iterations, double height, int grid, int threads,
                     int smem_bytes, void* stream) {
  using qg::Real;
  qg::DomainLanes<Real> lanes{(const Real*)friction,    (const Real*)gain_scale,
                              (const Real*)base_mass_scale, (const Real*)tilt_x,
                              (const Real*)tilt_y,      (const Real*)terrain_amp,
                              (const Real*)terrain_freq};
  const int err = qg::allow_shared(qg::fused_rollout_kernel, smem_bytes);
  if (err != 0) return err;
  qg::fused_rollout_kernel<<<grid, threads, smem_bytes, (cudaStream_t)stream>>>(
      (const qg::LegModel<Real>*)model, (const Real*)qpos0, (const Real*)qvel0,
      (const Real*)act0, (const Real*)seqs, (const Real*)prev0, (const Real*)cmd, lanes,
      (Real*)out, S, H, frame_skip, iterations, ls_iterations, (Real)height);
  return (int)cudaGetLastError();
}

}  // extern "C"
