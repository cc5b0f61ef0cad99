// One lane of the substep kernel: ``nsub`` substeps under a constant
// control on lane ``b`` of the batch-minor (d, B) state arrays, in the
// thread of leg ``leg`` (leg_step.cuh), replica ``rep`` of it
// (lane_math.cuh). Shared by the CUDA kernel and the host build of the
// tests.
#pragma once

#include "leg_step.cuh"

namespace qg {

// Reads this thread's share of column b of qpos (19, B), qvel (18, B),
// act (12, B), ctrl (12, B), runs nsub substeps in place in registers, and
// writes its share of column b of the outputs: its leg's joints, and the
// base rows if its leg is leg 0. sens_out (nsensordata, B) gets the
// pre-integration sensors of the LAST substep when compute_sensors is
// set, else zeros. With ``store`` false (a thread past the ragged edge,
// kept alive for the quad sums, or a replica other than 0) nothing is
// written.
template <typename T, int SPLIT>
QG_DEV void lane_substeps(const LegModel<T>& M, const T* qpos, const T* qvel, const T* act_in,
                          const T* ctrl_in, const DomainLanes<T>& lanes, T* qpos_out,
                          T* qvel_out, T* act_out, T* sens_out, int leg, int rep, size_t b,
                          size_t B, int nsub, int iterations, int ls_iterations,
                          bool compute_sensors, bool store, RowStore<T, SPLIT> rows) {
  const Domain<T> dp = load_domain(lanes, b);
  const bool base_owner = leg == 0;
  LegState<T> st;
  T ctrl[3];
  for (int i = 0; i < 7; ++i) st.qb[i] = qpos[i * B + b];
  for (int i = 0; i < 6; ++i) st.vf[i] = qvel[i * B + b];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const size_t u = 3 * leg + k;
    st.q[k] = qpos[(7 + u) * B + b];
    st.qv[k] = qvel[(6 + u) * B + b];
    st.act[k] = act_in[u * B + b];
    ctrl[k] = ctrl_in[u * B + b];
  }

  if (!compute_sensors && store && base_owner)
    for (int i = 0; i < M.nsensordata; ++i) sens_out[i * B + b] = T(0);
  for (int sub = 0; sub < nsub; ++sub) {
    T* full = (compute_sensors && store && sub + 1 == nsub) ? sens_out + b
                                                             : static_cast<T*>(nullptr);
    leg_substep_impl<true>(M, dp, leg, rep, st, ctrl, iterations, ls_iterations, rows,
                           static_cast<CostSensors<T>*>(nullptr), full, B);
  }

  if (!store) return;
  if (base_owner) {
    for (int i = 0; i < 7; ++i) qpos_out[i * B + b] = st.qb[i];
    for (int i = 0; i < 6; ++i) qvel_out[i * B + b] = st.vf[i];
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const size_t u = 3 * leg + k;
    qpos_out[(7 + u) * B + b] = st.q[k];
    qvel_out[(6 + u) * B + b] = st.qv[k];
    act_out[u * B + b] = st.act[k];
  }
}

}  // namespace qg
