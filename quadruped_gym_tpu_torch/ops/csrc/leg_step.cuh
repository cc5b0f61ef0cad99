// One leg-batched physics substep (mj_step semantics) of ONE robot, as
// __device__ functions: the math of ops/leg_engine.py::_step_impl with
// the contact selection of _collide_loop.
//
// The leg axis is the parallel axis. An aligned quad of a warp carries a
// robot and thread (lane & 3) owns that leg, ``leg``. A thread keeps its
// own leg's share of every leg-indexed quantity and a replica of the
// free-base quantities; the replicas stay bit-identical because the only
// cross-leg terms are quad_sum() (lane_math.cuh), which gives every thread
// the same bits. Every thread of a quad takes the same branches around a
// quad_sum. A robot may also be carried by SPLIT replicas of its quad
// (lane_math.cuh): they run the same code on the same bits and split only
// the hull-vertex scans (leg_substep.cuh); with SPLIT = 1 that code is not
// compiled.
//
// Indexing: level k in {hip, knee, ankle} of the thread's leg l; dof
// 6+3l+k, qpos 7+3l+k, actuator 3l+k. Everything spatial is relative to
// the base position (kin.origin); world positions are formed only where
// the reference forms them (heights against the ground plane, terrain xy).
#pragma once

#include "lane_math.cuh"
#include "leg_model.cuh"

namespace qg {

// DomainParams lanes, nullptr where nominal
template <typename T> struct DomainLanes {
  const T* friction;
  const T* gain_scale;
  const T* base_mass_scale;
  const T* tilt_x;
  const T* tilt_y;
  const T* terrain_amp;
  const T* terrain_freq;
};

// this rollout's DomainParams values; has_* false where nominal
template <typename T> struct Domain {
  bool has_friction, has_gain, has_mass, has_tilt, has_terrain;
  T friction, gain, mass, tilt_x, tilt_y, amp, freq;
};

// lane s of the DomainParams lanes
template <typename T> QG_DEV Domain<T> load_domain(const DomainLanes<T>& lanes, size_t s) {
  Domain<T> dp;
  dp.has_friction = lanes.friction != nullptr;
  dp.has_gain = lanes.gain_scale != nullptr;
  dp.has_mass = lanes.base_mass_scale != nullptr;
  dp.has_tilt = lanes.tilt_x != nullptr || lanes.tilt_y != nullptr;
  dp.has_terrain = lanes.terrain_amp != nullptr;
  dp.friction = dp.has_friction ? lanes.friction[s] : T(0);
  dp.gain = dp.has_gain ? lanes.gain_scale[s] : T(1);
  dp.mass = dp.has_mass ? lanes.base_mass_scale[s] : T(1);
  dp.tilt_x = lanes.tilt_x ? lanes.tilt_x[s] : T(0);
  dp.tilt_y = lanes.tilt_y ? lanes.tilt_y[s] : T(0);
  dp.amp = dp.has_terrain ? lanes.terrain_amp[s] : T(0);
  dp.freq = dp.has_terrain ? lanes.terrain_freq[s] : T(0);
  return dp;
}

// One thread's share of a robot's state: the free base (replicated in
// every thread of the robot) and its leg's joints.
template <typename T> struct LegState {
  T qb[7];     // base position and quaternion
  T vf[6];     // base qvel (linear, then angular in the base frame)
  T q[3];      // the leg's joint positions by level
  T qv[3];
  T act[3];
};

// the sensor readings the walking stage cost needs
template <typename T> struct CostSensors {
  T vel[2];    // velocimeter x, y
  T xaxis[2];  // frame x-axis x, y
  T zaxis_z;   // frame z-axis z
  T pos_z;     // frame position z
};

// mass matrix blocks: Mff[i][j] (j <= i), and the thread's leg's
// Mfl[i][k] and Mll[ki][kj]
template <typename T> struct Blocks {
  T ff[6][6];
  T fl[6][3];
  T ll[3][3];
};

template <typename T> struct Factor {
  T dinv_f[6];
  T dinv_l[3];
  T lff[6][6];
  T lfl[3][6];
  T lll[3][3];
};

// The leg levels are eliminated leg by leg; what they take from the free
// block is gathered per leg over the three levels and added over the legs
// once per entry (21 leg sums, not 63).
template <typename T> QG_DEV void ldl_factor(const Blocks<T>& M, Factor<T>& F) {
  Blocks<T> H = M;
  T schur[6][6];  // the leg's share, [fi][j <= fi]
#pragma unroll
  for (int k = NLEV - 1; k >= 0; --k) {
    F.dinv_l[k] = T(1) / H.ll[k][k];
#pragma unroll
    for (int i = k - 1; i >= 0; --i) {
      const T a = H.ll[k][i] * F.dinv_l[k];
      for (int j = i; j >= 0; --j) H.ll[i][j] = H.ll[i][j] - a * H.ll[k][j];
      for (int jf = 0; jf < 6; ++jf) H.fl[jf][i] = H.fl[jf][i] - a * H.fl[jf][k];
      F.lll[k][i] = a;
    }
#pragma unroll
    for (int fi = 5; fi >= 0; --fi) {
      const T a = H.fl[fi][k] * F.dinv_l[k];
#pragma unroll
      for (int j = fi; j >= 0; --j) {
        const T t = a * H.fl[j][k];
        schur[fi][j] = (k == NLEV - 1) ? t : schur[fi][j] + t;
      }
      F.lfl[k][fi] = a;
    }
  }
#pragma unroll
  for (int fi = 5; fi >= 0; --fi)
#pragma unroll
    for (int j = fi; j >= 0; --j) H.ff[fi][j] = H.ff[fi][j] - quad_sum(schur[fi][j]);
#pragma unroll
  for (int k = 5; k >= 0; --k) {
    F.dinv_f[k] = T(1) / H.ff[k][k];
#pragma unroll
    for (int i = k - 1; i >= 0; --i) {
      const T a = H.ff[k][i] * F.dinv_f[k];
#pragma unroll
      for (int j = i; j >= 0; --j) H.ff[i][j] = H.ff[i][j] - a * H.ff[k][j];
      F.lff[k][i] = a;
    }
  }
}

template <typename T>
QG_DEV void ldl_solve(const Factor<T>& F, const T bf[6], const T bl[3], T xf[6], T xl[3]) {
  T wf[6], wl[3];
#pragma unroll
  for (int i = 0; i < 6; ++i) wf[i] = bf[i];
#pragma unroll
  for (int k = 0; k < 3; ++k) wl[k] = bl[k];
#pragma unroll
  for (int k = NLEV - 1; k >= 0; --k)
#pragma unroll
    for (int i = k - 1; i >= 0; --i) wl[i] = wl[i] - F.lll[k][i] * wl[k];
  // each leg's three levels first, then one sum over the legs per entry
#pragma unroll
  for (int fi = 5; fi >= 0; --fi)
    wf[fi] = wf[fi]
             - quad_sum((F.lfl[2][fi] * wl[2] + F.lfl[1][fi] * wl[1]) + F.lfl[0][fi] * wl[0]);
#pragma unroll
  for (int k = 5; k >= 0; --k)
#pragma unroll
    for (int i = k - 1; i >= 0; --i) wf[i] = wf[i] - F.lff[k][i] * wf[k];
#pragma unroll
  for (int k = 0; k < 6; ++k) xf[k] = wf[k] * F.dinv_f[k];
#pragma unroll
  for (int k = 0; k < 6; ++k)
#pragma unroll
    for (int i = k - 1; i >= 0; --i) xf[k] = xf[k] - F.lff[k][i] * xf[i];
#pragma unroll
  for (int k = 0; k < NLEV; ++k) {
    T acc = wl[k] * F.dinv_l[k];
#pragma unroll
    for (int i = k - 1; i >= 0; --i) acc = acc - F.lll[k][i] * xl[i];
#pragma unroll
    for (int fi = 0; fi < 6; ++fi) acc = acc - F.lfl[k][fi] * xf[fi];
    xl[k] = acc;
  }
}

template <typename T>
QG_DEV void sym_matvec(const Blocks<T>& M, const T xf[6], const T xl[3], T yf[6], T yl[3]) {
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    T acc = M.ff[i][0] * xf[0];  // Mff[max(i,0)][0]
#pragma unroll
    for (int j = 1; j < 6; ++j) acc = acc + (i >= j ? M.ff[i][j] : M.ff[j][i]) * xf[j];
    acc = acc + quad_sum((M.fl[i][0] * xl[0] + M.fl[i][1] * xl[1]) + M.fl[i][2] * xl[2]);
    yf[i] = acc;
  }
#pragma unroll
  for (int ki = 0; ki < NLEV; ++ki) {
    T acc = M.ll[ki][0] * xl[0];
#pragma unroll
    for (int kj = 1; kj < NLEV; ++kj) acc = acc + (ki >= kj ? M.ll[ki][kj] : M.ll[kj][ki]) * xl[kj];
#pragma unroll
    for (int i = 0; i < 6; ++i) acc = acc + M.fl[i][ki] * xf[i];
    yl[ki] = acc;
  }
}

// Values a contact slot keeps per leg for the Newton solve: the Jacobian
// J[dir][dof] (dir n, t1, t2; dof 0-5 free, 6+k leg level k, zero below
// the contact body), the 4 pyramid facets' reference accelerations, the
// weight D the facets share, and the solve's two work vectors (J x - aref
// and J dx per facet).
constexpr int ROW_J = 0;
constexpr int ROW_AREF = 27;
constexpr int ROW_D = 31;
constexpr int ROW_JAR = 32;
constexpr int ROW_JD = 36;
constexpr int ROW_VALS = 40;

// Where a thread keeps the rows of its leg's slots: value v of slot s is
// p[(s * ROW_VALS + v) * stride]. On the card p is this thread's column
// of the block's dynamic shared memory and stride the block's number of
// columns, so a warp's 32 accesses to one value fall on 32 different
// banks; only the model's own slots (sum of grp_nslot) are laid out. Slot
// indices are run-time values, which is why the rows are not in
// registers. With SPLIT > 1 the SPLIT replicas of a leg (lane_math.cuh)
// share its one column: they read it together (a broadcast), and every
// replica writes the same bits to it, between two fences, so that no
// replica reads a value before all have written it or overwrites one that
// another still reads (the shuffles between the phases are no memory
// fence).
template <typename T, int SPLIT> struct RowStore {
  T* p;
  size_t stride;
  QG_DEV T& at(int s, int v) const { return p[(size_t)(s * ROW_VALS + v) * stride]; }
  QG_DEV void fence() const {
    if constexpr (SPLIT > 1) replica_fence();
  }
};

// Contact and joint-limit rows of one substep. Slots are numbered
// group-major, then by slot index; a slot's friction is its group's.
template <typename T, int SPLIT> struct Rows {
  const LegModel<T>* M;
  bool has_friction;
  T friction;
  T lim_sign[3];
  T lim_aref[3];
  T lim_D[3];
  RowStore<T, SPLIT> st;
  QG_DEV T mu(int g) const { return has_friction ? friction : M->grp_friction[g]; }
};

// f(s, mu) for every slot s of the model, in order
template <typename T, int SPLIT, typename F>
QG_DEV void for_each_slot(const Rows<T, SPLIT>& R, F&& f) {
  int s = 0;
  for (int g = 0; g < R.M->ngroup; ++g) {
    const T mu = R.mu(g);
    for (int i = 0; i < R.M->grp_nslot[g]; ++i, ++s) f(s, mu);
  }
}

template <typename T> QG_DEV T active_weight(T jar, T D) {
  return (jar < T(0) && D > T(0)) ? D : T(0);
}

// J x over all rows: lim into jl, slot facets into row value ``out``
// (ROW_JAR or ROW_JD), less aref when ``sub_aref``
template <typename T, int SPLIT>
QG_DEV void rows_matvec(const Rows<T, SPLIT>& R, const T xf[6], const T xl[3], T jl[3], int out,
                        bool sub_aref) {
#pragma unroll
  for (int k = 0; k < 3; ++k) jl[k] = R.lim_sign[k] * xl[k];
  R.st.fence();
  for_each_slot(R, [&](int s, T mu) {
    T v[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      T acc = R.st.at(s, ROW_J + 9 * d) * xf[0];
#pragma unroll
      for (int i = 1; i < 6; ++i) acc = acc + R.st.at(s, ROW_J + 9 * d + i) * xf[i];
#pragma unroll
      for (int k = 0; k < 3; ++k) acc = acc + R.st.at(s, ROW_J + 9 * d + 6 + k) * xl[k];
      v[d] = acc;
    }
    const T mv1 = mu * v[1], mv2 = mu * v[2];
    T js[4] = {v[0] + mv1, v[0] - mv1, v[0] + mv2, v[0] - mv2};
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      if (sub_aref) js[f] = js[f] - R.st.at(s, ROW_AREF + f);
      R.st.at(s, out + f) = js[f];
    }
  });
  R.st.fence();
}

// Jᵀ y with y = w * jar on every row, w the active weight of jar. Each
// leg gathers its slots' free-dof terms; the legs are added once.
template <typename T, int SPLIT>
QG_DEV void rows_tmatvec_active(const Rows<T, SPLIT>& R, const T yl_in[3], T yf[6], T yl[3]) {
  T c[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) c[i] = T(0);
#pragma unroll
  for (int k = 0; k < 3; ++k) yl[k] = R.lim_sign[k] * yl_in[k];
  for_each_slot(R, [&](int s, T mu) {
    const T D = R.st.at(s, ROW_D);
    T y[4];
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const T jar = R.st.at(s, ROW_JAR + f);
      y[f] = active_weight(jar, D) * jar;
    }
    const T yn = ((y[0] + y[1]) + y[2]) + y[3];
    const T y1 = mu * (y[0] - y[1]);
    const T y2 = mu * (y[2] - y[3]);
#pragma unroll
    for (int i = 0; i < 6; ++i)
      c[i] = c[i] + (R.st.at(s, ROW_J + i) * yn
                     + (R.st.at(s, ROW_J + 9 + i) * y1 + R.st.at(s, ROW_J + 18 + i) * y2));
#pragma unroll
    for (int k = 0; k < 3; ++k)
      yl[k] = yl[k] + (R.st.at(s, ROW_J + 6 + k) * yn
                       + (R.st.at(s, ROW_J + 15 + k) * y1 + R.st.at(s, ROW_J + 24 + k) * y2));
  });
#pragma unroll
  for (int i = 0; i < 6; ++i) yf[i] = quad_sum(c[i]);
}

// H = M + Jᵀ diag(w) J on the block pattern, w the active weights. Each
// leg gathers its slots' share of the free block; the legs are added once
// per entry.
template <typename T, int SPLIT>
QG_DEV void add_jwj(const Blocks<T>& M, const Rows<T, SPLIT>& R, const T wl[3], Blocks<T>& H) {
  H = M;
  T ffl[6][6];  // the leg's share of the free block, [i][j <= i]
#pragma unroll
  for (int k = 0; k < 3; ++k) H.ll[k][k] = H.ll[k][k] + wl[k];
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) ffl[i][j] = T(0);
  for_each_slot(R, [&](int s, T mu) {
    const T D = R.st.at(s, ROW_D);
    T w[4];
#pragma unroll
    for (int f = 0; f < 4; ++f) w[f] = active_weight(R.st.at(s, ROW_JAR + f), D);
    const T cnn = ((w[0] + w[1]) + w[2]) + w[3];
    const T c11 = mu * mu * (w[0] + w[1]);
    const T c22 = mu * mu * (w[2] + w[3]);
    const T cn1 = mu * (w[0] - w[1]);
    const T cn2 = mu * (w[2] - w[3]);
    T J[3][9];
#pragma unroll
    for (int e = 0; e < 3; ++e)
#pragma unroll
      for (int d = 0; d < 9; ++d) J[e][d] = R.st.at(s, ROW_J + 9 * e + d);
    auto pairval = [&](int a, int b) -> T {
      const T ni = J[0][a], t1i = J[1][a], t2i = J[2][a];
      const T nj = J[0][b], t1j = J[1][b], t2j = J[2][b];
      return (((cnn * ni * nj + c11 * t1i * t1j) + c22 * t2i * t2j) + cn1 * (ni * t1j + t1i * nj))
             + cn2 * (ni * t2j + t2i * nj);
    };
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) ffl[i][j] = ffl[i][j] + pairval(i, j);
#pragma unroll
      for (int k = 0; k < 3; ++k) H.fl[i][k] = H.fl[i][k] + pairval(i, 6 + k);
    }
#pragma unroll
    for (int ki = 0; ki < 3; ++ki)
#pragma unroll
      for (int kj = 0; kj <= ki; ++kj) H.ll[ki][kj] = H.ll[ki][kj] + pairval(6 + ki, 6 + kj);
  });
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) H.ff[i][j] = H.ff[i][j] + quad_sum(ffl[i][j]);
}

// primal Newton on the constraint rows; x (in: unconstrained qacc) -> qacc
template <typename T, int SPLIT>
QG_DEV void newton_solve(const Blocks<T>& M, const Rows<T, SPLIT>& R, const T qaf[6],
                         const T qal[3], int iterations, int ls_iterations, T xf[6], T xl[3]) {
  T jarl[3], jdl[3], wl[3];
#pragma unroll
  for (int i = 0; i < 6; ++i) xf[i] = qaf[i];
#pragma unroll
  for (int k = 0; k < 3; ++k) xl[k] = qal[k];
  for (int it = 0; it < iterations; ++it) {
    rows_matvec(R, xf, xl, jarl, ROW_JAR, true);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      jarl[k] = jarl[k] - R.lim_aref[k];
      wl[k] = active_weight(jarl[k], R.lim_D[k]);
    }
    // gradient: M (x - qa) + Jᵀ (w * jar)
    T df[6], dl[3], gsf[6], gsl[3];
#pragma unroll
    for (int i = 0; i < 6; ++i) df[i] = xf[i] - qaf[i];
#pragma unroll
    for (int k = 0; k < 3; ++k) dl[k] = xl[k] - qal[k];
    sym_matvec(M, df, dl, gsf, gsl);
    {
      T yl[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) yl[k] = wl[k] * jarl[k];
      T jtf[6], jtl[3];
      rows_tmatvec_active(R, yl, jtf, jtl);
#pragma unroll
      for (int i = 0; i < 6; ++i) df[i] = -(gsf[i] + jtf[i]);
#pragma unroll
      for (int k = 0; k < 3; ++k) dl[k] = -(gsl[k] + jtl[k]);
    }
    T dxf[6], dxl[3];
    {
      Blocks<T> H;
      add_jwj(M, R, wl, H);
      Factor<T> F;
      ldl_factor(H, F);
      ldl_solve(F, df, dl, dxf, dxl);
    }
    rows_matvec(R, dxf, dxl, jdl, ROW_JD, false);
    T mdf[6], mdl[3];
    sym_matvec(M, dxf, dxl, mdf, mdl);
    T g0 = dxf[0] * gsf[0], h0 = dxf[0] * mdf[0];
#pragma unroll
    for (int i = 1; i < 6; ++i) {
      g0 = g0 + dxf[i] * gsf[i];
      h0 = h0 + dxf[i] * mdf[i];
    }
    g0 = g0 + quad_sum((dxl[0] * gsl[0] + dxl[1] * gsl[1]) + dxl[2] * gsl[2]);
    h0 = h0 + quad_sum((dxl[0] * mdl[0] + dxl[1] * mdl[1]) + dxl[2] * mdl[2]);
    // exact line search along dx: a few 1-D Newton steps, t in [0, 4];
    // each leg sums its own rows, then the legs are added
    T t = T(1);
    for (int li = 0; li < ls_iterations; ++li) {
      T dphi_l = T(0), ddphi_l = T(0);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const T jt = jarl[k] + t * jdl[k];
        const T w = active_weight(jt, R.lim_D[k]);
        dphi_l = dphi_l + w * jt * jdl[k];
        ddphi_l = ddphi_l + w * jdl[k] * jdl[k];
      }
      for_each_slot(R, [&](int s, T) {
        const T D = R.st.at(s, ROW_D);
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const T jd = R.st.at(s, ROW_JD + f);
          const T jt = R.st.at(s, ROW_JAR + f) + t * jd;
          const T w = active_weight(jt, D);
          dphi_l = dphi_l + w * jt * jd;
          ddphi_l = ddphi_l + w * jd * jd;
        }
      });
      const T dphi = (g0 + t * h0) + quad_sum(dphi_l);
      const T ddphi = h0 + quad_sum(ddphi_l);
      t = fmin(fmax(t - dphi / fmax(ddphi, T(1e-30)), T(0)), T(4));
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) xf[i] = xf[i] + t * dxf[i];
#pragma unroll
    for (int k = 0; k < 3; ++k) xl[k] = xl[k] + t * dxl[k];
  }
}

}  // namespace qg

#include "leg_substep.cuh"
