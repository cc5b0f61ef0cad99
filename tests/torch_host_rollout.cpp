// Host build of the fused rollout kernel's device code (g++), so the CPU
// tests run the kernel's own arithmetic: the CUDA qualifiers become plain
// inline functions and the grid becomes a loop over rollouts.
#define __device__
#define __forceinline__ inline
#include <cmath>
#include <cstddef>
using std::fabs; using std::fmax; using std::fmin; using std::sqrt; using std::sin;
using std::cos; using std::exp; using std::pow;

#include "rollout.cuh"

template <typename T>
static void run(const void* model, const void* qpos0, const void* qvel0, const void* act0,
                const void* seqs, const void* prev0, const void* cmd, const void* const* dp,
                void* out, int S, int H, int frame_skip, int iterations, int ls_iterations,
                double height) {
  qg::DomainLanes<T> lanes{(const T*)dp[0], (const T*)dp[1], (const T*)dp[2], (const T*)dp[3],
                           (const T*)dp[4], (const T*)dp[5], (const T*)dp[6]};
  for (int s = 0; s < S; ++s)
    ((T*)out)[s] = qg::rollout_cost(*(const qg::LegModel<T>*)model, (const T*)qpos0,
                                    (const T*)qvel0, (const T*)act0, (const T*)seqs,
                                    (const T*)prev0, (const T*)cmd, lanes, s, S, H, frame_skip,
                                    iterations, ls_iterations, (T)height);
}

extern "C" {
// one substep of one robot in place; sens (6,): vel xy, xaxis xy, zaxis z, pos z
void qg_host_substep_f64(const void* model, double* q, double* qv, double* act,
                         const double* ctrl, int iterations, int ls_iterations, double* sens) {
  qg::Domain<double> dp{};
  dp.gain = 1; dp.mass = 1;
  qg::CostSensors<double> cs;
  qg::leg_substep(*(const qg::LegModel<double>*)model, dp, q, qv, act, ctrl, iterations,
                  ls_iterations, &cs);
  const double v[6] = {cs.vel[0], cs.vel[1], cs.xaxis[0], cs.xaxis[1], cs.zaxis_z, cs.pos_z};
  for (int i = 0; i < 6; ++i) sens[i] = v[i];
}
int qg_model_size_f32() { return (int)sizeof(qg::LegModel<float>); }
int qg_model_size_f64() { return (int)sizeof(qg::LegModel<double>); }
void qg_host_rollout_f32(const void* model, const void* qpos0, const void* qvel0,
                         const void* act0, const void* seqs, const void* prev0, const void* cmd,
                         const void* const* dp, void* out, int S, int H, int frame_skip,
                         int iterations, int ls_iterations, double height) {
  run<float>(model, qpos0, qvel0, act0, seqs, prev0, cmd, dp, out, S, H, frame_skip, iterations,
             ls_iterations, height);
}
void qg_host_rollout_f64(const void* model, const void* qpos0, const void* qvel0,
                         const void* act0, const void* seqs, const void* prev0, const void* cmd,
                         const void* const* dp, void* out, int S, int H, int frame_skip,
                         int iterations, int ls_iterations, double height) {
  run<double>(model, qpos0, qvel0, act0, seqs, prev0, cmd, dp, out, S, H, frame_skip, iterations,
              ls_iterations, height);
}
}
