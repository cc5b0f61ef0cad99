// Host build of the kernels' device code (g++), so the CPU tests run the
// kernels' own arithmetic: the CUDA qualifiers become plain inline
// functions and the grid becomes a loop over rollouts or lanes.
//
// A robot is carried as on the card: by 4 x SPLIT host threads in
// lockstep, SPLIT replicas of a quad with one thread per leg (SPLIT 1, 2
// or 4). quad_sum and lane_best below do the butterfly steps of the
// card's __shfl_xor_sync through a small exchange buffer and a spin
// barrier, replica_fence is that barrier, and the contact rows are laid
// out [value][leg] with a stride of 4, one column a leg shared by its
// replicas, as a block of one robot would.
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

// the 4 x SPLIT threads of a robot in lockstep: a double-buffered exchange
// slot a lane (up to three values; a float and an index are held exactly
// in a double) and a generation barrier. A waiter spins briefly, then
// sleeps on the generation (a futex): with up to 16 threads a robot and
// other test processes on the same cores, spinning alone starves the
// threads that still have to arrive.
struct Group {
  int size = 4;
  std::atomic<int> count{0};
  std::atomic<int> gen{0};
  double slot[2][16][3];
  void wait() {
    const int g = gen.load(std::memory_order_acquire);
    if (count.fetch_add(1, std::memory_order_acq_rel) == size - 1) {
      count.store(0, std::memory_order_relaxed);
      gen.store(g + 1, std::memory_order_release);
      gen.notify_all();
    } else {
      for (int spins = 0; spins < 64 && gen.load(std::memory_order_acquire) == g; ++spins) {
      }
      while (gen.load(std::memory_order_acquire) == g) gen.wait(g, std::memory_order_acquire);
    }
  }
};
static thread_local Group* tl_group = nullptr;
static thread_local int tl_lane = 0;
static thread_local int tl_buf = 0;

// the card's __shfl_xor_sync(v, m) for n values at once: every lane
// writes its own, waits for the group and reads lane ^ m's. Consecutive
// exchanges alternate buffers, so a write never meets a late read.
static void exchange(double* v, int n, int m) {
  Group& g = *tl_group;
  double* mine = g.slot[tl_buf][tl_lane];
  for (int k = 0; k < n; ++k) mine[k] = v[k];
  g.wait();
  const double* other = g.slot[tl_buf][tl_lane ^ m];
  for (int k = 0; k < n; ++k) v[k] = other[k];
  tl_buf ^= 1;
}

template <typename T> T quad_sum(T v) {
  for (int m = 1; m <= 2; m <<= 1) {
    double x = (double)v;
    exchange(&x, 1, m);
    v = v + (T)x;
  }
  return v;
}

// the card's lane_best (lane_math.cuh) through the exchange buffer
template <int FIRST, int LANES, typename T> void lane_best(T& v, int& i, bool lower) {
  for (int m = FIRST; m < LANES; m <<= 1) {
    double x[2] = {(double)v, (double)i};
    exchange(x, 2, m);
    const T ov = (T)x[0];
    const int oi = (int)x[1];
    if ((lower ? ov < v : ov > v) || (ov == v && oi < i)) { v = ov; i = oi; }
  }
}

template <int FIRST, int LANES, typename T> void lane_best(T& v, int& i, T& h, bool lower) {
  for (int m = FIRST; m < LANES; m <<= 1) {
    double x[3] = {(double)v, (double)i, (double)h};
    exchange(x, 3, m);
    const T ov = (T)x[0];
    const int oi = (int)x[1];
    if ((lower ? ov < v : ov > v) || (ov == v && oi < i)) { v = ov; i = oi; h = (T)x[2]; }
  }
}

inline void replica_fence() { tl_group->wait(); }

}  // namespace qg

#include "rollout.cuh"
#include "substep.cuh"

template <typename T> static qg::DomainLanes<T> domain_lanes(const void* const* dp) {
  return qg::DomainLanes<T>{(const T*)dp[0], (const T*)dp[1], (const T*)dp[2], (const T*)dp[3],
                            (const T*)dp[4], (const T*)dp[5], (const T*)dp[6]};
}

// body(leg, rep, rows) on 4 x SPLIT threads, thread 4 rep + leg owning
// replica rep of that leg; the replicas of a leg share its column of rows,
// and the columns interleave in one buffer as in a block of one robot
template <typename T, int SPLIT, typename Body> static void run_group(Body body) {
  qg::Group group;
  group.size = 4 * SPLIT;
  std::vector<T> smem((size_t)qg::MAX_SLOTS * qg::ROW_VALS * 4);
  std::vector<std::thread> threads;
  for (int lane = 0; lane < 4 * SPLIT; ++lane)
    threads.emplace_back([&, lane] {
      qg::tl_group = &group;
      qg::tl_lane = lane;
      qg::tl_buf = 0;
      body(lane & 3, lane >> 2, qg::RowStore<T, SPLIT>{smem.data() + (lane & 3), 4});
    });
  for (auto& t : threads) t.join();
}

// the rollouts, 4 x split threads a robot; returns how many rollouts'
// costs differ in any bit between the robot's threads (must be 0), or -1
// for a split other than 1, 2, 4
template <typename T>
static int run_quads(const void* model, const void* qpos0, const void* qvel0, const void* act0,
                     const void* seqs, const void* prev0, const void* cmd,
                     const void* const* dp, void* out, int S, int H, int frame_skip,
                     int iterations, int ls_iterations, double height, int split) {
  const qg::DomainLanes<T> lanes = domain_lanes<T>(dp);
  std::vector<T> costs((size_t)4 * split * S);
  return qg::with_split(split, -1, [&](auto sp) {
    constexpr int SPLIT = decltype(sp)::value;
    run_group<T, SPLIT>([&](int leg, int rep, qg::RowStore<T, SPLIT> rows) {
      for (int s = 0; s < S; ++s)
        costs[(size_t)(4 * rep + leg) * S + s] = qg::rollout_cost(
            *(const qg::LegModel<T>*)model, (const T*)qpos0, (const T*)qvel0, (const T*)act0,
            (const T*)seqs, (const T*)prev0, (const T*)cmd, lanes, leg, rep, s, S, H,
            frame_skip, iterations, ls_iterations, (T)height, rows);
    });
    int differ = 0;
    for (int s = 0; s < S; ++s) {
      ((T*)out)[s] = costs[s];
      bool same = true;
      for (int lane = 1; lane < 4 * SPLIT; ++lane)
        same = same && costs[(size_t)lane * S + s] == costs[s];
      differ += same ? 0 : 1;
    }
    return differ;
  });
}

// the substep kernel's body on every lane of (d, B) arrays, 4 x split
// threads a lane. Each replica writes its own copy of the outputs, planes
// of (split, d, B): where the card stores replica 0's, the tests hold
// every replica's. Lanes b >= B_store run but store nothing, as the
// card's threads past the ragged edge do. Returns -1 for a split other
// than 1, 2, 4.
template <typename T>
static int run_quad_substeps(const void* model, const void* qpos, const void* qvel,
                             const void* act, const void* ctrl, const void* const* dp,
                             void* qpos_out, void* qvel_out, void* act_out, void* sens_out,
                             int B, int B_store, int nsub, int iterations, int ls_iterations,
                             int compute_sensors, int split) {
  const qg::DomainLanes<T> lanes = domain_lanes<T>(dp);
  const qg::LegModel<T>& M = *(const qg::LegModel<T>*)model;
  return qg::with_split(split, -1, [&](auto sp) {
    constexpr int SPLIT = decltype(sp)::value;
    run_group<T, SPLIT>([&](int leg, int rep, qg::RowStore<T, SPLIT> rows) {
      const size_t r = (size_t)rep * B;
      for (int b = 0; b < B; ++b)
        qg::lane_substeps(M, (const T*)qpos, (const T*)qvel, (const T*)act, (const T*)ctrl,
                          lanes, (T*)qpos_out + 19 * r, (T*)qvel_out + 18 * r,
                          (T*)act_out + 12 * r, (T*)sens_out + M.nsensordata * r, leg, rep,
                          (size_t)b, (size_t)B, nsub, iterations, ls_iterations,
                          compute_sensors != 0, b < B_store, rows);
    });
    return 0;
  });
}

extern "C" {
#define QG_SUBSTEP_ARGS                                                                   \
  const void *model, const void *qpos, const void *qvel, const void *act, const void *ctrl, \
      const void *const *dp, void *qpos_out, void *qvel_out, void *act_out, void *sens_out
int qg_host_substeps_f32(QG_SUBSTEP_ARGS, int B, int B_store, int nsub, int iterations,
                         int ls_iterations, int compute_sensors, int split) {
  return run_quad_substeps<float>(model, qpos, qvel, act, ctrl, dp, qpos_out, qvel_out,
                                  act_out, sens_out, B, B_store, nsub, iterations,
                                  ls_iterations, compute_sensors, split);
}
int qg_host_substeps_f64(QG_SUBSTEP_ARGS, int B, int B_store, int nsub, int iterations,
                         int ls_iterations, int compute_sensors, int split) {
  return run_quad_substeps<double>(model, qpos, qvel, act, ctrl, dp, qpos_out, qvel_out,
                                   act_out, sens_out, B, B_store, nsub, iterations,
                                   ls_iterations, compute_sensors, split);
}
int qg_model_size_f32() { return (int)sizeof(qg::LegModel<float>); }
int qg_model_size_f64() { return (int)sizeof(qg::LegModel<double>); }
#define QG_ROLLOUT_ARGS                                                                      \
  const void *model, const void *qpos0, const void *qvel0, const void *act0, const void *seqs, \
      const void *prev0, const void *cmd, const void *const *dp, void *out, int S, int H,      \
      int frame_skip, int iterations, int ls_iterations, double height
int qg_host_rollout_f32(QG_ROLLOUT_ARGS, int split) {
  return run_quads<float>(model, qpos0, qvel0, act0, seqs, prev0, cmd, dp, out, S, H, frame_skip,
                          iterations, ls_iterations, height, split);
}
int qg_host_rollout_f64(QG_ROLLOUT_ARGS, int split) {
  return run_quads<double>(model, qpos0, qvel0, act0, seqs, prev0, cmd, dp, out, S, H,
                           frame_skip, iterations, ls_iterations, height, split);
}
}
