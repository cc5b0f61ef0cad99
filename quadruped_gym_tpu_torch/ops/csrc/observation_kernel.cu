// Partial-observation kernel for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package computes the walking task's
// partial observation (tasks/observations.py: the Madgwick IMU update, the
// ahrs Euler angles, the heading angle, the frame and the window's push or
// fill) as elementwise operations that its jit fuses; PyTorch runs each as
// a kernel of its own, ~120 small kernels a call on (N, <= 4) tensors, two
// calls an env step (the step's frame and the auto-reset's). Here a call is
// one launch, on the current stream, so a CUDA graph captures it as one
// node.
//
// Bound: bytes. At 2,048 envs and a window of 10 frames a launch reads and
// writes ~2.1 MB of window each, ~4.3 MB with the inputs (~1.3 us at
// 3.35 TB/s), against ~200 operations an env; in practice a launch's
// latency, a few microseconds, bounds it.
//
// Design (po_observation.cuh): a block of PO_THREADS threads takes
// PO_ENVS consecutive envs. Its first PO_ENVS threads compute an env's
// frame each, reading the inputs through their strides (views need no
// copy), into shared memory; then all its threads write the block's window
// rows, which are contiguous in the output, neighbouring threads on
// neighbouring entries, reading the old window the same way. One thread
// copying an env's strided ~1 KB row would not coalesce. 2,048 envs are
// 256 blocks, about two an SM, each thread moving ~8 entries.
//
// Build (ops/_build.py): nvcc -gencode arch=compute_90a,code=sm_90a
// -std=c++17 -O3 -shared -Xcompiler -fPIC -DQG_REAL=float|double.

#include <cuda_runtime.h>

#include "po_observation.cuh"

#ifndef QG_REAL
#define QG_REAL float
#endif

namespace qg {

using Real = QG_REAL;

__global__ void __launch_bounds__(PO_THREADS)
po_window_kernel(PoInputs<Real> in, const Real* __restrict__ window, Real* __restrict__ quat_out,
                 Real* __restrict__ window_out, int n, int W) {
  __shared__ Real frames[PO_ENVS * PO_OBS_DIM];
  const long long env0 = (long long)blockIdx.x * PO_ENVS;
  po_block_frames(in, frames, quat_out, env0, n, (int)threadIdx.x);
  __syncthreads();
  po_block_window(window, frames, window_out, env0, n, W, (int)threadIdx.x);
}

}  // namespace qg
extern "C" {

// One launch over ``n`` envs on ``stream``: their frames into the (n,
// window_len, 26) ``window_out`` (the old ``window`` pushed by one frame,
// or filled with the frame where ``window`` is null) and their filter
// quaternions into the (n, 4) ``quat_out``, both contiguous. ``inputs``
// (host memory) holds six device views with their strides in elements:
// sensordata, ctrl, the command's velocity, its heading, the filter
// quaternion and the time; ``sensor_adr`` the gyro's, accelerometer's and
// velocimeter's sensordata addresses. Returns the CUDA error of the launch,
// 0 on success. The outputs must not alias the inputs.
int qg_po_window(const qg::StridedArg* inputs, const int* sensor_adr, double half_settling,
                 double control_dt, const void* window, void* quat_out, void* window_out, int n,
                 int window_len, void* stream) {
  using qg::Real;
  const qg::PoInputs<Real> in =
      qg::po_inputs<Real>(inputs, sensor_adr, half_settling, control_dt);
  const int grid = (n + qg::PO_ENVS - 1) / qg::PO_ENVS;
  qg::po_window_kernel<<<grid, qg::PO_THREADS, 0, (cudaStream_t)stream>>>(
      in, (const Real*)window, (Real*)quat_out, (Real*)window_out, n, window_len);
  return (int)cudaGetLastError();
}

}  // extern "C"
