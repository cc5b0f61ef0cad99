// Fused whole-rollout cost kernel for Hopper (sm_90a).
//
// Replaces quadruped_gym_tpu/ops/pallas_engine.py::_rollout_kernel (the
// Pallas TPU kernel behind fused_rollout_cost): for each of S rollouts
// from one shared start state, H control steps x frame_skip leg-engine
// substeps at a fixed Newton / line-search budget, sensors on the last
// substep of each control step, and the walking stage cost summed into
// out[s].
//
// Bound: compute, in FP32 (the main path) or FP64 non-tensor operations.
// A rollout reads 12 H control values and writes one cost, but every
// substep runs tens of thousands of operations (forward kinematics,
// composite inertia, RNE, two tree-sparse LDLᵀ factorizations, the
// hull-vertex selection loops and the Newton solve). Counted from the
// plain version (ops/cuda_engine.py::rollout_flops): about 60,000 per
// substep on the planning model at Newton/line-search 2/4 and 183,000 on
// the fast-plant model at 4/8, against 48 bytes of control per control
// step. Nothing here maps onto the tensor cores.
//
// Design: one thread per rollout (blocks of 128, the ragged edge masked),
// so a rollout's state and Newton iterates stay in that thread's registers
// and local memory for the whole horizon; the only device-memory traffic
// is the (H, 12, S) control read, coalesced because neighbouring threads
// read neighbouring rollouts. The model constants are one packed struct
// (leg_model.cuh) read through the read-only cache with uniform addresses.
// Vertex selection and slot loops are runtime loops over that struct, so
// code size does not grow with the hulls; selections are strict < / >
// compare-and-keep, as the plain version's _collide_loop. The price of
// keeping a whole rollout in one thread is register pressure: ptxas gives
// the float32 build 255 registers and an 11 KB stack frame (the contact
// rows), so two blocks fit an SM and the Newton solve streams its rows
// through local memory (L1/L2). Splitting a rollout across threads, or
// keeping only the active rows, is the next step for speed.
//
// Build (ops/_build.py): nvcc -gencode arch=compute_90a,code=sm_90a
// -std=c++17 -O3 -shared -Xcompiler -fPIC -DQG_REAL=float|double.

#include <cuda_runtime.h>

#include "rollout.cuh"

#ifndef QG_REAL
#define QG_REAL float
#endif

namespace qg {

template <typename T>
__global__ void __launch_bounds__(128)
fused_rollout_kernel(const LegModel<T>* __restrict__ model, const T* __restrict__ qpos0,
                     const T* __restrict__ qvel0, const T* __restrict__ act0,
                     const T* __restrict__ seqs, const T* __restrict__ prev0,
                     const T* __restrict__ cmd_in, DomainLanes<T> lanes, T* __restrict__ out,
                     int S, int H, int frame_skip, int iterations, int ls_iterations, T height) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  out[s] = rollout_cost(*model, qpos0, qvel0, act0, seqs, prev0, cmd_in, lanes, s, S, H,
                        frame_skip, iterations, ls_iterations, height);
}

}  // namespace qg
extern "C" {

// sizeof(LegModel<QG_REAL>): the wrapper checks it against its ctypes
// struct before the first upload
int qg_model_size() { return (int)sizeof(qg::LegModel<QG_REAL>); }

// Launch on ``stream``; returns cudaGetLastError() (0 on success). Every
// pointer is device memory; DomainParams lanes are nullptr where nominal.
int qg_fused_rollout(const void* model, const void* qpos0, const void* qvel0, const void* act0,
                     const void* seqs, const void* prev0, const void* cmd,
                     const void* friction, const void* gain_scale, const void* base_mass_scale,
                     const void* tilt_x, const void* tilt_y, const void* terrain_amp,
                     const void* terrain_freq, void* out, int S, int H, int frame_skip,
                     int iterations, int ls_iterations, double height, void* stream) {
  using T = QG_REAL;
  qg::DomainLanes<T> lanes{(const T*)friction, (const T*)gain_scale, (const T*)base_mass_scale,
                           (const T*)tilt_x, (const T*)tilt_y, (const T*)terrain_amp,
                           (const T*)terrain_freq};
  const int block = 128;
  const int grid = (S + block - 1) / block;
  qg::fused_rollout_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const qg::LegModel<T>*)model, (const T*)qpos0, (const T*)qvel0, (const T*)act0,
      (const T*)seqs, (const T*)prev0, (const T*)cmd, lanes, (T*)out, S, H, frame_skip,
      iterations, ls_iterations, (T)height);
  return (int)cudaGetLastError();
}

}  // extern "C"
