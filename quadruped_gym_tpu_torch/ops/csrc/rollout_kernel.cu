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
// Replicas (a template parameter, SPLIT in 1, 2, 4): below ~8,192
// rollouts the grid leaves the SMs with a few warps each, and nothing
// hides the latency of the dependent chains. The wrapper then takes the
// largest SPLIT whose 4 SPLIT S threads are one wave of at most one warp
// a scheduler (ops/cuda_engine.py::launch_geometry), and a rollout is
// carried by SPLIT quads (lane (lane >> 2) & (SPLIT - 1) is the
// replica). Every replica runs the whole rollout on the same bits; the
// three vertex passes of each contact group are the one
// exception: replica r scans the share [r V / SPLIT, (r + 1) V / SPLIT) of
// its leg's hull, and the replicas exchange winners by butterfly shuffles
// over the replica bits (xor 4, 8; lane_math.cuh::lane_best), ties to
// the lower index, so that every winner, and the cost, is the serial
// scan's at every SPLIT. The rows are not replicated: the replicas of a
// leg share its column (a stride of T / SPLIT), read it as a broadcast and
// all write the same bits to it between two __syncwarp fences
// (leg_step.cuh::RowStore), so a warp keeps 32 / SPLIT columns of rows.
// Only replica 0 of leg 0 stores the cost. At SPLIT = 1 none of this is
// compiled: the kernel is the quad form above.
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

template <int SPLIT>
__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS)
fused_rollout_kernel(const LegModel<Real>* __restrict__ model, const Real* __restrict__ qpos0,
                     const Real* __restrict__ qvel0, const Real* __restrict__ act0,
                     const Real* __restrict__ seqs, const Real* __restrict__ prev0,
                     const Real* __restrict__ cmd, DomainLanes<Real> lanes,
                     Real* __restrict__ out, int S, int H, int frame_skip, int iterations,
                     int ls_iterations, Real height) {
  extern __shared__ __align__(16) unsigned char qg_smem[];
  const LaneIndex<SPLIT> t;
  const bool valid = t.robot < S;
  const int s = valid ? t.robot : S - 1;
  const RowStore<Real, SPLIT> rows{reinterpret_cast<Real*>(qg_smem) + t.col, t.stride()};
  const Real cost = rollout_cost(*model, qpos0, qvel0, act0, seqs, prev0, cmd, lanes, t.leg,
                                 t.rep, s, S, H, frame_skip, iterations, ls_iterations, height,
                                 rows);
  if (valid && t.leg == 0 && t.rep == 0) out[s] = cost;
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
    return qg::kernel_info(qg::fused_rollout_kernel<decltype(s)::value>, threads, smem_bytes,
                           registers, local_bytes, blocks_per_sm);
  });
}

// Launch ``grid`` blocks of ``threads`` (4 ``split`` threads a rollout) with
// ``smem_bytes`` of dynamic shared memory on ``stream``; returns the CUDA
// error of the request or of the launch (0 on success). Every pointer is
// device memory; DomainParams lanes are nullptr where nominal.
int qg_fused_rollout(const void* model, const void* qpos0, const void* qvel0, const void* act0,
                     const void* seqs, const void* prev0, const void* cmd,
                     const void* friction, const void* gain_scale, const void* base_mass_scale,
                     const void* tilt_x, const void* tilt_y, const void* terrain_amp,
                     const void* terrain_freq, void* out, int S, int H, int frame_skip,
                     int iterations, int ls_iterations, double height, int grid, int threads,
                     int smem_bytes, int split, void* stream) {
  using qg::Real;
  qg::DomainLanes<Real> lanes{(const Real*)friction,    (const Real*)gain_scale,
                              (const Real*)base_mass_scale, (const Real*)tilt_x,
                              (const Real*)tilt_y,      (const Real*)terrain_amp,
                              (const Real*)terrain_freq};
  return qg::with_split(split, (int)cudaErrorInvalidValue, [&](auto sp) {
    const auto kernel = qg::fused_rollout_kernel<decltype(sp)::value>;
    const int err = qg::allow_shared(kernel, smem_bytes);
    if (err != 0) return err;
    kernel<<<grid, threads, smem_bytes, (cudaStream_t)stream>>>(
        (const qg::LegModel<Real>*)model, (const Real*)qpos0, (const Real*)qvel0,
        (const Real*)act0, (const Real*)seqs, (const Real*)prev0, (const Real*)cmd, lanes,
        (Real*)out, S, H, frame_skip, iterations, ls_iterations, (Real)height);
    return (int)cudaGetLastError();
  });
}

}  // extern "C"
