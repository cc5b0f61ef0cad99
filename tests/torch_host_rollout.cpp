// Host build of the kernels' device code (g++), so the CPU tests run the
// kernels' own arithmetic: the CUDA qualifiers become plain inline
// functions and the grid becomes a loop over rollouts or lanes.
//
// Two forms of the same source are built. With NL = 4 one host thread
// carries a whole robot and the sum over the legs is (0 + 1) + (2 + 3) in
// place. With NL = 1, the form the card runs, a robot is carried by a quad
// of four host threads, one per leg, in lockstep: quad_sum below does the
// two butterfly steps of the card's __shfl_xor_sync through a small
// exchange buffer and a spin barrier, and the contact rows are laid out
// [value][thread] with a stride of 4, as a block of one quad would.
#define __device__
#define __forceinline__ inline
#define QG_HOST
#include <atomic>
#include <cmath>
#include <cstddef>
#include <thread>
#include <vector>
using std::fabs; using std::fmax; using std::fmin; using std::sqrt; using std::sin;
using std::cos; using std::exp; using std::pow;

namespace qg {

// four threads in lockstep: an exchange slot per butterfly step and a
// sense-reversing barrier (a float is held exactly in a double slot; so is
// an index)
struct Quad {
  std::atomic<int> count{0};
  std::atomic<int> gen{0};
  double slot[2][4];
  double pair[2][4][2];
  void wait() {
    const int g = gen.load(std::memory_order_acquire);
    if (count.fetch_add(1, std::memory_order_acq_rel) == 3) {
      count.store(0, std::memory_order_relaxed);
      gen.store(g + 1, std::memory_order_release);
    } else {
      int spins = 0;
      while (gen.load(std::memory_order_acquire) == g)
        if (++spins > 200) std::this_thread::yield();
    }
  }
};
static thread_local Quad* tl_quad = nullptr;
static thread_local int tl_leg = 0;

template <typename T> T quad_sum(T v) {
  Quad& q = *tl_quad;
  const int l = tl_leg;
  q.slot[0][l] = (double)v;
  q.wait();
  v = v + (T)q.slot[0][l ^ 1];
  q.slot[1][l] = (double)v;
  q.wait();
  v = v + (T)q.slot[1][l ^ 2];
  return v;
}

// the card's quad_best (lane_math.cuh) through the exchange buffer
template <typename T> void quad_best(T& v, int& i, bool lower) {
  Quad& q = *tl_quad;
  const int l = tl_leg;
  for (int s = 0; s < 2; ++s) {
    q.pair[s][l][0] = (double)v;
    q.pair[s][l][1] = (double)i;
    q.wait();
    const T ov = (T)q.pair[s][l ^ (1 << s)][0];
    const int oi = (int)q.pair[s][l ^ (1 << s)][1];
    if ((lower ? ov < v : ov > v) || (ov == v && oi < i)) { v = ov; i = oi; }
  }
}

}  // namespace qg

#include "rollout.cuh"
#include "substep.cuh"

template <typename T> static qg::DomainLanes<T> domain_lanes(const void* const* dp) {
  return qg::DomainLanes<T>{(const T*)dp[0], (const T*)dp[1], (const T*)dp[2], (const T*)dp[3],
                            (const T*)dp[4], (const T*)dp[5], (const T*)dp[6]};
}

// body(leg, rows) on four threads, thread ``leg`` owning that leg; the
// rows of the quad interleave in one buffer as in a block of four threads
template <typename T, typename Body> static void run_quad(Body body) {
  qg::Quad quad;
  std::vector<T> smem((size_t)qg::MAX_SLOTS * qg::ROW_VALS * 4);
  std::vector<std::thread> threads;
  for (int leg = 0; leg < 4; ++leg)
    threads.emplace_back([&, leg] {
      qg::tl_quad = &quad;
      qg::tl_leg = leg;
      body(leg, qg::RowStore<1, T>{smem.data() + leg, 4});
    });
  for (auto& t : threads) t.join();
}

template <typename T>
static void run(const void* model, const void* qpos0, const void* qvel0, const void* act0,
                const void* seqs, const void* prev0, const void* cmd, const void* const* dp,
                void* out, int S, int H, int frame_skip, int iterations, int ls_iterations,
                double height) {
  const qg::DomainLanes<T> lanes = domain_lanes<T>(dp);
  std::vector<T> buf((size_t)qg::MAX_SLOTS * qg::ROW_VALS * 4);
  const qg::RowStore<4, T> rows{buf.data(), 1};
  for (int s = 0; s < S; ++s)
    ((T*)out)[s] = qg::rollout_cost<4>(*(const qg::LegModel<T>*)model, (const T*)qpos0,
                                       (const T*)qvel0, (const T*)act0, (const T*)seqs,
                                       (const T*)prev0, (const T*)cmd, lanes, 0, s, S, H,
                                       frame_skip, iterations, ls_iterations, (T)height, rows);
}

// the same rollouts in the one-leg form; returns how many rollouts' costs
// differ in any bit between the four threads of the quad (must be 0)
template <typename T>
static int run_quads(const void* model, const void* qpos0, const void* qvel0, const void* act0,
                     const void* seqs, const void* prev0, const void* cmd,
                     const void* const* dp, void* out, int S, int H, int frame_skip,
                     int iterations, int ls_iterations, double height) {
  const qg::DomainLanes<T> lanes = domain_lanes<T>(dp);
  std::vector<T> costs((size_t)4 * S);
  run_quad<T>([&](int leg, qg::RowStore<1, T> rows) {
    for (int s = 0; s < S; ++s)
      costs[(size_t)leg * S + s] = qg::rollout_cost<1>(
          *(const qg::LegModel<T>*)model, (const T*)qpos0, (const T*)qvel0, (const T*)act0,
          (const T*)seqs, (const T*)prev0, (const T*)cmd, lanes, leg, s, S, H, frame_skip,
          iterations, ls_iterations, (T)height, rows);
  });
  int differ = 0;
  for (int s = 0; s < S; ++s) {
    ((T*)out)[s] = costs[s];
    bool same = true;
    for (int leg = 1; leg < 4; ++leg) same = same && costs[(size_t)leg * S + s] == costs[s];
    differ += same ? 0 : 1;
  }
  return differ;
}

// the substep kernel's body on every lane of (d, B) arrays
template <typename T>
static void run_substeps(const void* model, const void* qpos, const void* qvel, const void* act,
                         const void* ctrl, const void* const* dp, void* qpos_out,
                         void* qvel_out, void* act_out, void* sens_out, int B, int nsub,
                         int iterations, int ls_iterations, int compute_sensors) {
  const qg::DomainLanes<T> lanes = domain_lanes<T>(dp);
  std::vector<T> buf((size_t)qg::MAX_SLOTS * qg::ROW_VALS * 4);
  const qg::RowStore<4, T> rows{buf.data(), 1};
  for (int b = 0; b < B; ++b)
    qg::lane_substeps<4>(*(const qg::LegModel<T>*)model, (const T*)qpos, (const T*)qvel,
                         (const T*)act, (const T*)ctrl, lanes, (T*)qpos_out, (T*)qvel_out,
                         (T*)act_out, (T*)sens_out, 0, (size_t)b, (size_t)B, nsub, iterations,
                         ls_iterations, compute_sensors != 0, true, rows);
}

// the same in the one-leg form. Lanes b >= B_store run but store nothing,
// as the card's threads past the ragged edge do.
template <typename T>
static void run_quad_substeps(const void* model, const void* qpos, const void* qvel,
                              const void* act, const void* ctrl, const void* const* dp,
                              void* qpos_out, void* qvel_out, void* act_out, void* sens_out,
                              int B, int B_store, int nsub, int iterations, int ls_iterations,
                              int compute_sensors) {
  const qg::DomainLanes<T> lanes = domain_lanes<T>(dp);
  run_quad<T>([&](int leg, qg::RowStore<1, T> rows) {
    for (int b = 0; b < B; ++b)
      qg::lane_substeps<1>(*(const qg::LegModel<T>*)model, (const T*)qpos, (const T*)qvel,
                           (const T*)act, (const T*)ctrl, lanes, (T*)qpos_out, (T*)qvel_out,
                           (T*)act_out, (T*)sens_out, leg, (size_t)b, (size_t)B, nsub,
                           iterations, ls_iterations, compute_sensors != 0, b < B_store, rows);
  });
}

extern "C" {
#define QG_SUBSTEP_ARGS                                                                   \
  const void *model, const void *qpos, const void *qvel, const void *act, const void *ctrl, \
      const void *const *dp, void *qpos_out, void *qvel_out, void *act_out, void *sens_out
void qg_host_substeps_f32(QG_SUBSTEP_ARGS, int B, int nsub, int iterations, int ls_iterations,
                          int compute_sensors) {
  run_substeps<float>(model, qpos, qvel, act, ctrl, dp, qpos_out, qvel_out, act_out, sens_out, B,
                      nsub, iterations, ls_iterations, compute_sensors);
}
void qg_host_substeps_f64(QG_SUBSTEP_ARGS, int B, int nsub, int iterations, int ls_iterations,
                          int compute_sensors) {
  run_substeps<double>(model, qpos, qvel, act, ctrl, dp, qpos_out, qvel_out, act_out, sens_out,
                       B, nsub, iterations, ls_iterations, compute_sensors);
}
void qg_host_quad_substeps_f32(QG_SUBSTEP_ARGS, int B, int B_store, int nsub, int iterations,
                               int ls_iterations, int compute_sensors) {
  run_quad_substeps<float>(model, qpos, qvel, act, ctrl, dp, qpos_out, qvel_out, act_out,
                           sens_out, B, B_store, nsub, iterations, ls_iterations,
                           compute_sensors);
}
void qg_host_quad_substeps_f64(QG_SUBSTEP_ARGS, int B, int B_store, int nsub, int iterations,
                               int ls_iterations, int compute_sensors) {
  run_quad_substeps<double>(model, qpos, qvel, act, ctrl, dp, qpos_out, qvel_out, act_out,
                            sens_out, B, B_store, nsub, iterations, ls_iterations,
                            compute_sensors);
}
// one substep of one robot in place; sens (6,): vel xy, xaxis xy, zaxis z, pos z
void qg_host_substep_f64(const void* model, double* q, double* qv, double* act,
                         const double* ctrl, int iterations, int ls_iterations, double* sens) {
  qg::Domain<double> dp{};
  dp.gain = 1; dp.mass = 1;
  qg::LegState<4, double> st;
  double c[3][4];
  for (int i = 0; i < 7; ++i) st.qb[i] = q[i];
  for (int i = 0; i < 6; ++i) st.vf[i] = qv[i];
  for (int k = 0; k < 3; ++k)
    for (int l = 0; l < 4; ++l) {
      st.q[k][l] = q[7 + 3 * l + k];
      st.qv[k][l] = qv[6 + 3 * l + k];
      st.act[k][l] = act[3 * l + k];
      c[k][l] = ctrl[3 * l + k];
    }
  std::vector<double> buf((size_t)qg::MAX_SLOTS * qg::ROW_VALS * 4);
  qg::CostSensors<double> cs;
  qg::leg_substep_impl<4, false>(*(const qg::LegModel<double>*)model, dp, 0, st, c, iterations,
                                 ls_iterations, qg::RowStore<4, double>{buf.data(), 1}, &cs,
                                 static_cast<double*>(nullptr), (size_t)0);
  for (int i = 0; i < 7; ++i) q[i] = st.qb[i];
  for (int i = 0; i < 6; ++i) qv[i] = st.vf[i];
  for (int k = 0; k < 3; ++k)
    for (int l = 0; l < 4; ++l) {
      q[7 + 3 * l + k] = st.q[k][l];
      qv[6 + 3 * l + k] = st.qv[k][l];
      act[3 * l + k] = st.act[k][l];
    }
  const double v[6] = {cs.vel[0], cs.vel[1], cs.xaxis[0], cs.xaxis[1], cs.zaxis_z, cs.pos_z};
  for (int i = 0; i < 6; ++i) sens[i] = v[i];
}
int qg_model_size_f32() { return (int)sizeof(qg::LegModel<float>); }
int qg_model_size_f64() { return (int)sizeof(qg::LegModel<double>); }
int qg_row_vals() { return qg::ROW_VALS; }
#define QG_ROLLOUT_ARGS                                                                      \
  const void *model, const void *qpos0, const void *qvel0, const void *act0, const void *seqs, \
      const void *prev0, const void *cmd, const void *const *dp, void *out, int S, int H,      \
      int frame_skip, int iterations, int ls_iterations, double height
void qg_host_rollout_f32(QG_ROLLOUT_ARGS) {
  run<float>(model, qpos0, qvel0, act0, seqs, prev0, cmd, dp, out, S, H, frame_skip, iterations,
             ls_iterations, height);
}
void qg_host_rollout_f64(QG_ROLLOUT_ARGS) {
  run<double>(model, qpos0, qvel0, act0, seqs, prev0, cmd, dp, out, S, H, frame_skip, iterations,
              ls_iterations, height);
}
int qg_host_quad_rollout_f32(QG_ROLLOUT_ARGS) {
  return run_quads<float>(model, qpos0, qvel0, act0, seqs, prev0, cmd, dp, out, S, H, frame_skip,
                          iterations, ls_iterations, height);
}
int qg_host_quad_rollout_f64(QG_ROLLOUT_ARGS) {
  return run_quads<double>(model, qpos0, qvel0, act0, seqs, prev0, cmd, dp, out, S, H,
                           frame_skip, iterations, ls_iterations, height);
}
}
