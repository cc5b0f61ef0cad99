// One rollout: H control steps x frame_skip substeps plus the walking
// stage cost (pallas_engine.py::_lane_stage_cost), for rollout ``s``, in
// the thread of leg ``leg`` (leg_step.cuh), replica ``rep`` of it
// (lane_math.cuh). Shared by the CUDA kernel and the host build of the
// tests.
#pragma once

#include "leg_step.cuh"

namespace qg {

// ``ctrl`` and ``prev`` are the leg's controls by level. Each leg sums
// its three posture and control-change terms and the legs are then added,
// where the plain version sums the 12 actuators in one pass: the two sums
// differ from it by rounding only.
template <typename T>
QG_DEV T stage_cost(const CostSensors<T>& s, int leg, const T ctrl[3], const T prev[3],
                    const T* cmd, T height, const T centers[12]) {
  const T vx = s.vel[0], vy = s.vel[1];
  const T n2 = vx * vx + vy * vy;
  const T vnorm = n2 > T(0) ? sqrt(n2) : T(0);
  const T inv = T(1) / fmax(vnorm, T(1e-30));
  const T prog_dir = (vx * inv) * cmd[0] + (vy * inv) * cmd[1];
  const T ds = vnorm - cmd[2];
  const T speed_cost = ds * ds;
  const T heading = s.xaxis[0] * cmd[3] + s.xaxis[1] * cmd[4];
  const T orient = s.zaxis_z;
  const T height_cost = fabs(s.pos_z - height);
  T post_l = T(0), dctrl_l = T(0);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const T d = (ctrl[k] - centers[3 * leg + k]) / T(12);
    post_l = post_l + d * d;
    const T e = ctrl[k] - prev[k];
    dctrl_l = dctrl_l + e * e;
  }
  const T posture2 = quad_sum(post_l);
  const T dctrl = quad_sum(dctrl_l);
  const T reward = ((((((((T(10) + T(10) * prog_dir) - T(50) * speed_cost)
                         + T(10) * (exp(heading) - T(1)))
                        + T(10) * (exp(orient) - T(1)))
                       - T(50) * (exp(height_cost) - T(1)))
                      - sqrt(posture2))
                     - T(2) * dctrl)
                    - (orient < T(0) ? T(200) : T(0)));
  return -reward;
}

// The shared start state, this thread's share of it
template <typename T>
QG_DEV void load_shared_state(const T* qpos0, const T* qvel0, const T* act0, int leg,
                              LegState<T>& st) {
  for (int i = 0; i < 7; ++i) st.qb[i] = qpos0[i];
  for (int i = 0; i < 6; ++i) st.vf[i] = qvel0[i];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int u = 3 * leg + k;
    st.q[k] = qpos0[7 + u];
    st.qv[k] = qvel0[6 + u];
    st.act[k] = act0[u];
  }
}

// Total cost of rollout s; every thread of the robot returns the same bits.
template <typename T, int SPLIT>
QG_DEV T rollout_cost(const LegModel<T>& M, const T* qpos0, const T* qvel0, const T* act0,
                      const T* seqs, const T* prev0, const T* cmd, const DomainLanes<T>& lanes,
                      int leg, int rep, int s, int S, int H, int frame_skip, int iterations,
                      int ls_iterations, T height, RowStore<T, SPLIT> rows) {
  const Domain<T> dp = load_domain(lanes, (size_t)s);
  LegState<T> st;
  load_shared_state(qpos0, qvel0, act0, leg, st);
  T prev[3], ctrl[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) prev[k] = prev0[3 * leg + k];

  T cost = T(0);
  for (int t = 0; t < H; ++t) {
#pragma unroll
    for (int k = 0; k < 3; ++k) ctrl[k] = seqs[((size_t)t * 12 + 3 * leg + k) * S + s];
    for (int sub = 0; sub + 1 < frame_skip; ++sub)
      leg_substep_impl<false>(M, dp, leg, rep, st, ctrl, iterations, ls_iterations, rows,
                              static_cast<CostSensors<T>*>(nullptr), static_cast<T*>(nullptr),
                              (size_t)0);
    CostSensors<T> sens;
    leg_substep_impl<false>(M, dp, leg, rep, st, ctrl, iterations, ls_iterations, rows, &sens,
                            static_cast<T*>(nullptr), (size_t)0);
    cost = cost + stage_cost(sens, leg, ctrl, prev, cmd, height, M.joint_centers);
#pragma unroll
    for (int k = 0; k < 3; ++k) prev[k] = ctrl[k];
  }
  return cost;
}

}  // namespace qg
