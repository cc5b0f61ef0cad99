// Physics substep kernel for Hopper (sm_90a).
//
// Replaces quadruped_gym_tpu/ops/pallas_engine.py::_substep_kernel (the
// Pallas TPU kernel behind ``step`` and ``control_step``): one
// mj_step-semantics substep per batch lane (FK -> CRBA -> RNE -> servo
// actuation -> tree-sparse LDLᵀ -> plane-convex contacts -> primal Newton
// at a fixed budget -> sensors -> implicitfast), on the batch-minor
// (d, B) state arrays. The TPU version launches once per substep and
// sends the state through device memory in between; here ONE launch runs
// all ``nsub`` substeps of a control step with the lane's state in
// registers, and writes all of the model's sensors (pre-integration
// values of the last substep), or zeros when the caller asks for none.
//
// Bound: operations, in FP32 (the main paths) or FP64. A lane moves
// about 570 bytes in and out per launch (19 + 18 + 12 + 12 values in,
// 19 + 18 + 12 + 33 out) against tens of thousands of operations per
// substep (ops/cuda_engine.py::substep_flops counts them from the plain
// version). Nothing here maps onto the tensor cores.
//
// Design: one thread per lane, blocks of 128, the ragged edge masked, so
// B need not divide anything. Neighbouring threads read neighbouring
// lanes of each row: every load and store is coalesced. The device code
// is the fused rollout kernel's substep (leg_substep.cuh) compiled with
// the full sensor table on; the model constants are the same packed
// struct. As there, the price of a whole substep in one thread is
// register pressure and a local-memory stack for the contact rows; and a
// batch of a few thousand lanes (an RL env batch) fills only B / 128 of
// the card's 132 SMs.
//
// Build (ops/_build.py): nvcc -gencode arch=compute_90a,code=sm_90a
// -std=c++17 -O3 -shared -Xcompiler -fPIC -DQG_REAL=float|double.

#include <cuda_runtime.h>

#include "substep.cuh"

#ifndef QG_REAL
#define QG_REAL float
#endif

namespace qg {

template <typename T>
__global__ void __launch_bounds__(128)
substep_kernel(const LegModel<T>* __restrict__ model, const T* __restrict__ qpos,
               const T* __restrict__ qvel, const T* __restrict__ act,
               const T* __restrict__ ctrl, DomainLanes<T> lanes, T* __restrict__ qpos_out,
               T* __restrict__ qvel_out, T* __restrict__ act_out, T* __restrict__ sens_out,
               int B, int nsub, int iterations, int ls_iterations, int compute_sensors) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  lane_substeps(*model, qpos, qvel, act, ctrl, lanes, qpos_out, qvel_out, act_out, sens_out,
                (size_t)b, (size_t)B, nsub, iterations, ls_iterations, compute_sensors != 0);
}

}  // namespace qg
extern "C" {

// sizeof(LegModel<QG_REAL>): the wrapper checks it against its ctypes
// struct before the first upload
int qg_model_size() { return (int)sizeof(qg::LegModel<QG_REAL>); }

// Launch on ``stream``; returns cudaGetLastError() (0 on success). Every
// pointer is device memory; DomainParams lanes are nullptr where nominal.
// The outputs must not alias the inputs.
int qg_substeps(const void* model, const void* qpos, const void* qvel, const void* act,
                const void* ctrl, const void* friction, const void* gain_scale,
                const void* base_mass_scale, const void* tilt_x, const void* tilt_y,
                const void* terrain_amp, const void* terrain_freq, void* qpos_out,
                void* qvel_out, void* act_out, void* sens_out, int B, int nsub, int iterations,
                int ls_iterations, int compute_sensors, void* stream) {
  using T = QG_REAL;
  qg::DomainLanes<T> lanes{(const T*)friction, (const T*)gain_scale, (const T*)base_mass_scale,
                           (const T*)tilt_x, (const T*)tilt_y, (const T*)terrain_amp,
                           (const T*)terrain_freq};
  const int block = 128;
  const int grid = (B + block - 1) / block;
  qg::substep_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const qg::LegModel<T>*)model, (const T*)qpos, (const T*)qvel, (const T*)act,
      (const T*)ctrl, lanes, (T*)qpos_out, (T*)qvel_out, (T*)act_out, (T*)sens_out, B, nsub,
      iterations, ls_iterations, compute_sensors);
  return (int)cudaGetLastError();
}

}  // extern "C"
