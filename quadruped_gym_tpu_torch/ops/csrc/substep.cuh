// One lane of the substep kernel: ``nsub`` substeps under a constant
// control on lane ``b`` of the batch-minor (d, B) state arrays. Shared by
// the CUDA kernel and a host build of the same source.
#pragma once

#include "leg_step.cuh"

namespace qg {

// Reads column b of qpos (19, B), qvel (18, B), act (12, B), ctrl (12, B),
// runs nsub substeps in place in this lane's registers, and writes column
// b of the outputs. sens_out (nsensordata, B) gets the pre-integration
// sensors of the LAST substep when compute_sensors is set, else zeros.
template <typename T>
QG_DEV void lane_substeps(const LegModel<T>& M, const T* qpos, const T* qvel, const T* act_in,
                          const T* ctrl_in, const DomainLanes<T>& lanes, T* qpos_out,
                          T* qvel_out, T* act_out, T* sens_out, size_t b, size_t B, int nsub,
                          int iterations, int ls_iterations, bool compute_sensors) {
  const Domain<T> dp = load_domain(lanes, b);
  T q[19], qv[18], act[12], ctrl[12];
  for (int i = 0; i < 19; ++i) q[i] = qpos[i * B + b];
  for (int i = 0; i < 18; ++i) qv[i] = qvel[i * B + b];
  for (int i = 0; i < 12; ++i) { act[i] = act_in[i * B + b]; ctrl[i] = ctrl_in[i * B + b]; }

  if (!compute_sensors)
    for (int i = 0; i < M.nsensordata; ++i) sens_out[i * B + b] = T(0);
  for (int sub = 0; sub < nsub; ++sub) {
    T* full = (compute_sensors && sub + 1 == nsub) ? sens_out + b : static_cast<T*>(nullptr);
    leg_substep_full(M, dp, q, qv, act, ctrl, iterations, ls_iterations, full, B);
  }

  for (int i = 0; i < 19; ++i) qpos_out[i * B + b] = q[i];
  for (int i = 0; i < 18; ++i) qvel_out[i * B + b] = qv[i];
  for (int i = 0; i < 12; ++i) act_out[i * B + b] = act[i];
}

}  // namespace qg
