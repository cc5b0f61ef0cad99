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
// version). Nothing here maps onto the tensor cores; the dependent chains
// of the dynamics make the warps wait on latency, so the kernel wants
// little state per thread (nothing in local memory) and then as many
// resident warps as that leaves room for.
//
// Design: the fused rollout kernel's (rollout_kernel.cu): a thread per
// leg, SPLIT aligned quads of a warp per lane (replicas that split the
// hull-vertex scans), the legs' sums by two shuffles inside the quad, the
// contact rows in dynamic shared memory sized by the model's slots, one
// column a leg, split, block size and bytes chosen by the wrapper. The
// grid is 4 SPLIT B threads: an env batch of 2,048 lanes at SPLIT 1 is
// 256 warps, at most 2 on each of the card's 132 SMs, so the wrapper
// takes the largest SPLIT (1, 2 or 4) whose grid is one wave of at most
// one warp a scheduler, two on a model of long hull scans; replicas repeat
// the rest of the work, which costs issue slots beyond that, and only
// long scans repay it (ops/cuda_engine.py::launch_geometry,
// scheduler_warps).
// Every replica runs the whole substep on the same bits; replica r scans
// only its share of each hull, and the winners, exchanged by shuffles
// with ties to the lower index, are the serial scan's, so the outputs do
// not depend on SPLIT. The replicas of a leg share its column of rows and
// all write the same bits to it between two __syncwarp fences
// (leg_step.cuh::RowStore). At SPLIT = 1 none of that is compiled.
// B need not divide anything: threads past the ragged edge stay alive on
// a clamped lane (the quad sums need all 32 lanes) and store nothing. A
// thread reads the base rows (the threads of a lane read the same
// address) and its own leg's joint rows; the base rows and the base-site
// sensors are written by the thread of leg 0 of replica 0, a joint's
// position sensor by its leg's thread of replica 0. The device code is
// the fused kernel's substep (leg_substep.cuh) compiled with the full
// sensor table on; the model constants are the same packed struct.
//
// Build (ops/_build.py): nvcc -gencode arch=compute_90a,code=sm_90a
// -std=c++17 -O3 -shared -Xcompiler -fPIC -DQG_REAL=float|double.

#include "launch.cuh"
#include "substep.cuh"

#ifndef QG_REAL
#define QG_REAL float
#endif

namespace qg {

using Real = QG_REAL;

template <int SPLIT>
__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS)
substep_kernel(const LegModel<Real>* __restrict__ model, const Real* __restrict__ qpos,
               const Real* __restrict__ qvel, const Real* __restrict__ act,
               const Real* __restrict__ ctrl, DomainLanes<Real> lanes,
               Real* __restrict__ qpos_out, Real* __restrict__ qvel_out,
               Real* __restrict__ act_out, Real* __restrict__ sens_out, int B, int nsub,
               int iterations, int ls_iterations, int compute_sensors) {
  extern __shared__ __align__(16) unsigned char qg_smem[];
  const LaneIndex<SPLIT> t;
  const bool valid = t.robot < B;
  const int b = valid ? t.robot : B - 1;
  const RowStore<Real, SPLIT> rows{reinterpret_cast<Real*>(qg_smem) + t.col, t.stride()};
  lane_substeps(*model, qpos, qvel, act, ctrl, lanes, qpos_out, qvel_out, act_out, sens_out,
                t.leg, t.rep, (size_t)b, (size_t)B, nsub, iterations, ls_iterations,
                compute_sensors != 0, valid && t.rep == 0, rows);
}

}  // namespace qg
extern "C" {

// sizeof(LegModel<QG_REAL>): the wrapper checks it against its ctypes
// struct before the first upload
int qg_model_size() { return (int)sizeof(qg::LegModel<QG_REAL>); }

// registers, local bytes and resident blocks per SM of the kernel for
// ``split`` replicas at a block size and dynamic shared size; returns a
// CUDA error code, 0 if none
int qg_kernel_info(int threads, int smem_bytes, int split, int* registers, int* local_bytes,
                   int* blocks_per_sm) {
  return qg::with_split(split, (int)cudaErrorInvalidValue, [&](auto s) {
    return qg::kernel_info(qg::substep_kernel<decltype(s)::value>, threads, smem_bytes,
                           registers, local_bytes, blocks_per_sm);
  });
}

// Launch ``grid`` blocks of ``threads`` (4 ``split`` threads a lane) with
// ``smem_bytes`` of dynamic shared memory on ``stream``; returns the CUDA
// error of the request or of the launch (0 on success). Every pointer is
// device memory; DomainParams lanes are nullptr where nominal. The
// outputs must not alias the inputs.
int qg_substeps(const void* model, const void* qpos, const void* qvel, const void* act,
                const void* ctrl, const void* friction, const void* gain_scale,
                const void* base_mass_scale, const void* tilt_x, const void* tilt_y,
                const void* terrain_amp, const void* terrain_freq, void* qpos_out,
                void* qvel_out, void* act_out, void* sens_out, int B, int nsub, int iterations,
                int ls_iterations, int compute_sensors, int grid, int threads, int smem_bytes,
                int split, void* stream) {
  using qg::Real;
  qg::DomainLanes<Real> lanes{(const Real*)friction,    (const Real*)gain_scale,
                              (const Real*)base_mass_scale, (const Real*)tilt_x,
                              (const Real*)tilt_y,      (const Real*)terrain_amp,
                              (const Real*)terrain_freq};
  return qg::with_split(split, (int)cudaErrorInvalidValue, [&](auto s) {
    const auto kernel = qg::substep_kernel<decltype(s)::value>;
    const int err = qg::allow_shared(kernel, smem_bytes);
    if (err != 0) return err;
    kernel<<<grid, threads, smem_bytes, (cudaStream_t)stream>>>(
        (const qg::LegModel<Real>*)model, (const Real*)qpos, (const Real*)qvel,
        (const Real*)act, (const Real*)ctrl, lanes, (Real*)qpos_out, (Real*)qvel_out,
        (Real*)act_out, (Real*)sens_out, B, nsub, iterations, ls_iterations, compute_sensors);
    return (int)cudaGetLastError();
  });
}

}  // extern "C"
