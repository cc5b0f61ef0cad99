// One rollout: H control steps x frame_skip substeps plus the walking
// stage cost (pallas_engine.py::_lane_stage_cost), for rollout ``s``.
// Shared by the CUDA kernel and a host build of the same source.
#pragma once

#include "leg_step.cuh"

namespace qg {

template <typename T>
QG_DEV T stage_cost(const CostSensors<T>& s, const T ctrl[12], const T prev[12],
                        const T cmd[5], T height, const T centers[12]) {
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
  T posture2 = T(0), dctrl = T(0);
  for (int u = 0; u < 12; ++u) {
    const T d = (ctrl[u] - centers[u]) / T(12);
    posture2 = posture2 + d * d;
    const T e = ctrl[u] - prev[u];
    dctrl = dctrl + e * e;
  }
  const T reward = ((((((((T(10) + T(10) * prog_dir) - T(50) * speed_cost)
                         + T(10) * (exp(heading) - T(1)))
                        + T(10) * (exp(orient) - T(1)))
                       - T(50) * (exp(height_cost) - T(1)))
                      - sqrt(posture2))
                     - T(2) * dctrl)
                    - (orient < T(0) ? T(200) : T(0)));
  return -reward;
}

template <typename T>
QG_DEV T rollout_cost(const LegModel<T>& M, const T* qpos0, const T* qvel0, const T* act0,
                      const T* seqs, const T* prev0, const T* cmd_in, const DomainLanes<T>& lanes,
                      int s, int S, int H, int frame_skip, int iterations, int ls_iterations,
                      T height) {
  const Domain<T> dp = load_domain(lanes, (size_t)s);

  T q[19], qv[18], act[12], prev[12], ctrl[12], cmd[5];
  for (int i = 0; i < 19; ++i) q[i] = qpos0[i];
  for (int i = 0; i < 18; ++i) qv[i] = qvel0[i];
  for (int i = 0; i < 12; ++i) { act[i] = act0[i]; prev[i] = prev0[i]; }
  for (int i = 0; i < 5; ++i) cmd[i] = cmd_in[i];

  T cost = T(0);
  for (int t = 0; t < H; ++t) {
    for (int u = 0; u < 12; ++u) ctrl[u] = seqs[((size_t)t * 12 + u) * S + s];
    for (int sub = 0; sub + 1 < frame_skip; ++sub)
      leg_substep(M, dp, q, qv, act, ctrl, iterations, ls_iterations,
                  static_cast<CostSensors<T>*>(nullptr));
    CostSensors<T> sens;
    leg_substep(M, dp, q, qv, act, ctrl, iterations, ls_iterations, &sens);
    cost = cost + stage_cost(sens, ctrl, prev, cmd, height, M.joint_centers);
    for (int u = 0; u < 12; ++u) prev[u] = ctrl[u];
  }
  return cost;
}

}  // namespace qg
