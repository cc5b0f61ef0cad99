// Host build of the partial-observation kernel's device code (g++), so the
// CPU tests run its own arithmetic: the CUDA qualifiers become plain inline
// functions, a block becomes a loop over its threads before and after the
// barrier, and the grid a loop over blocks.
#define __device__
#define __forceinline__ inline
#define QG_HOST
#include <cmath>
#include <vector>
using std::asin; using std::atan2; using std::sqrt;

#include "po_observation.cuh"

template <typename T>
static void run(const qg::StridedArg* inputs, const int* sensor_adr, double half_settling,
                double control_dt, const void* window, void* quat_out, void* window_out, int n,
                int W) {
  const qg::PoInputs<T> in = qg::po_inputs<T>(inputs, sensor_adr, half_settling, control_dt);
  std::vector<T> frames(qg::PO_ENVS * qg::PO_OBS_DIM);
  for (long long env0 = 0; env0 < n; env0 += qg::PO_ENVS) {
    for (int t = 0; t < qg::PO_THREADS; ++t)
      qg::po_block_frames(in, frames.data(), (T*)quat_out, env0, n, t);
    for (int t = 0; t < qg::PO_THREADS; ++t)
      qg::po_block_window((const T*)window, frames.data(), (T*)window_out, env0, n, W, t);
  }
}

extern "C" {

// qg_po_window's arguments (observation_kernel.cu) without the stream, in
// host memory
int qg_host_po_window_f32(const qg::StridedArg* inputs, const int* sensor_adr,
                          double half_settling, double control_dt, const void* window,
                          void* quat_out, void* window_out, int n, int W) {
  run<float>(inputs, sensor_adr, half_settling, control_dt, window, quat_out, window_out, n, W);
  return 0;
}

int qg_host_po_window_f64(const qg::StridedArg* inputs, const int* sensor_adr,
                          double half_settling, double control_dt, const void* window,
                          void* quat_out, void* window_out, int n, int W) {
  run<double>(inputs, sensor_adr, half_settling, control_dt, window, quat_out, window_out, n, W);
  return 0;
}

}  // extern "C"
