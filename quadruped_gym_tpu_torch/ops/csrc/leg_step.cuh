// One leg-batched physics substep (mj_step semantics) for ONE rollout,
// as a __device__ function: the math of ops/leg_engine.py::_step_impl with
// the contact selection of _collide_loop, written for one thread.
//
// Indexing: level k in {hip, knee, ankle}, leg l in 0..3; dof 6+3l+k,
// qpos 7+3l+k, actuator 3l+k. Everything spatial is relative to the base
// position (kin.origin); world positions are formed only where the
// reference forms them (heights against the ground plane, terrain xy).
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

// the sensor readings the walking stage cost needs
template <typename T> struct CostSensors {
  T vel[2];    // velocimeter x, y
  T xaxis[2];  // frame x-axis x, y
  T zaxis_z;   // frame z-axis z
  T pos_z;     // frame position z
};

// mass matrix blocks: Mff[i][j] (j <= i), Mfl[i][k][l], Mll[ki][kj][l]
template <typename T> struct Blocks {
  T ff[6][6];
  T fl[6][3][4];
  T ll[3][3][4];
};

template <typename T> struct Factor {
  T dinv_f[6];
  T dinv_l[3][4];
  T lff[6][6];
  T lfl[3][6][4];
  T lll[3][3][4];
};

template <typename T> QG_DEV void ldl_factor(const Blocks<T>& M, Factor<T>& F) {
  Blocks<T> H = M;
#pragma unroll
  for (int k = NLEV - 1; k >= 0; --k) {
#pragma unroll
    for (int l = 0; l < 4; ++l) F.dinv_l[k][l] = T(1) / H.ll[k][k][l];
#pragma unroll
    for (int i = k - 1; i >= 0; --i) {
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const T a = H.ll[k][i][l] * F.dinv_l[k][l];
        for (int j = i; j >= 0; --j) H.ll[i][j][l] = H.ll[i][j][l] - a * H.ll[k][j][l];
        for (int jf = 0; jf < 6; ++jf) H.fl[jf][i][l] = H.fl[jf][i][l] - a * H.fl[jf][k][l];
        F.lll[k][i][l] = a;
      }
    }
#pragma unroll
    for (int fi = 5; fi >= 0; --fi) {
      T a[4];
#pragma unroll
      for (int l = 0; l < 4; ++l) a[l] = H.fl[fi][k][l] * F.dinv_l[k][l];
#pragma unroll
      for (int j = fi; j >= 0; --j)
        H.ff[fi][j] = H.ff[fi][j] - sum4(a[0] * H.fl[j][k][0], a[1] * H.fl[j][k][1],
                                         a[2] * H.fl[j][k][2], a[3] * H.fl[j][k][3]);
#pragma unroll
      for (int l = 0; l < 4; ++l) F.lfl[k][fi][l] = a[l];
    }
  }
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
QG_DEV void ldl_solve(const Factor<T>& F, const T bf[6], const T bl[3][4], T xf[6], T xl[3][4]) {
  T wf[6], wl[3][4];
#pragma unroll
  for (int i = 0; i < 6; ++i) wf[i] = bf[i];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int l = 0; l < 4; ++l) wl[k][l] = bl[k][l];
#pragma unroll
  for (int k = NLEV - 1; k >= 0; --k) {
#pragma unroll
    for (int i = k - 1; i >= 0; --i)
#pragma unroll
      for (int l = 0; l < 4; ++l) wl[i][l] = wl[i][l] - F.lll[k][i][l] * wl[k][l];
#pragma unroll
    for (int fi = 5; fi >= 0; --fi)
      wf[fi] = wf[fi] - sum4(F.lfl[k][fi][0] * wl[k][0], F.lfl[k][fi][1] * wl[k][1],
                             F.lfl[k][fi][2] * wl[k][2], F.lfl[k][fi][3] * wl[k][3]);
  }
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
  for (int k = 0; k < NLEV; ++k)
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      T acc = wl[k][l] * F.dinv_l[k][l];
#pragma unroll
      for (int i = k - 1; i >= 0; --i) acc = acc - F.lll[k][i][l] * xl[i][l];
#pragma unroll
      for (int fi = 0; fi < 6; ++fi) acc = acc - F.lfl[k][fi][l] * xf[fi];
      xl[k][l] = acc;
    }
}

template <typename T>
QG_DEV void sym_matvec(const Blocks<T>& M, const T xf[6], const T xl[3][4], T yf[6], T yl[3][4]) {
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    T acc = M.ff[i][0] * xf[0];  // Mff[max(i,0)][0]
#pragma unroll
    for (int j = 1; j < 6; ++j) acc = acc + (i >= j ? M.ff[i][j] : M.ff[j][i]) * xf[j];
#pragma unroll
    for (int k = 0; k < NLEV; ++k)
      acc = acc + sum4(M.fl[i][k][0] * xl[k][0], M.fl[i][k][1] * xl[k][1],
                       M.fl[i][k][2] * xl[k][2], M.fl[i][k][3] * xl[k][3]);
    yf[i] = acc;
  }
#pragma unroll
  for (int ki = 0; ki < NLEV; ++ki)
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      T acc = (ki >= 0 ? M.ll[ki][0][l] : M.ll[0][ki][l]) * xl[0][l];
#pragma unroll
      for (int kj = 1; kj < NLEV; ++kj)
        acc = acc + (ki >= kj ? M.ll[ki][kj][l] : M.ll[kj][ki][l]) * xl[kj][l];
#pragma unroll
      for (int i = 0; i < 6; ++i) acc = acc + M.fl[i][ki][l] * xf[i];
      yl[ki][l] = acc;
    }
}

// Contact rows of one substep. Slot s (group-major, then slot index) on
// leg l has a Jacobian J[dir][dof] (dir n, t1, t2; dof 0-5 free, 6+k leg
// level k, zero below the contact body), 4 pyramid facets with reference
// accelerations aref, and one weight D shared by the facets.
template <typename T> struct Rows {
  int nslot;
  T lim_sign[3][4];
  T lim_aref[3][4];
  T lim_D[3][4];
  T J[MAX_SLOTS][4][3][9];
  T mu[MAX_SLOTS];
  T aref[MAX_SLOTS][4][4];
  T D[MAX_SLOTS][4];
};

// J x over all rows: lim (3, 4) and slot facets (nslot, 4 legs, 4)
template <typename T>
QG_DEV void rows_matvec(const Rows<T>& R, const T xf[6], const T xl[3][4], T jl[3][4],
                        T js[][4][4]) {
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int l = 0; l < 4; ++l) jl[k][l] = R.lim_sign[k][l] * xl[k][l];
  for (int s = 0; s < R.nslot; ++s) {
    const T mu = R.mu[s];
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const T(&J)[3][9] = R.J[s][l];
      T v[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        T acc = J[d][0] * xf[0];
#pragma unroll
        for (int i = 1; i < 6; ++i) acc = acc + J[d][i] * xf[i];
#pragma unroll
        for (int k = 0; k < 3; ++k) acc = acc + J[d][6 + k] * xl[k][l];
        v[d] = acc;
      }
      const T mv1 = mu * v[1], mv2 = mu * v[2];
      js[s][l][0] = v[0] + mv1;
      js[s][l][1] = v[0] - mv1;
      js[s][l][2] = v[0] + mv2;
      js[s][l][3] = v[0] - mv2;
    }
  }
}

// Jᵀ y
template <typename T>
QG_DEV void rows_tmatvec(const Rows<T>& R, const T yl_in[3][4], const T ys[][4][4], T yf[6],
                         T yl[3][4]) {
#pragma unroll
  for (int i = 0; i < 6; ++i) yf[i] = T(0);
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int l = 0; l < 4; ++l) yl[k][l] = R.lim_sign[k][l] * yl_in[k][l];
  for (int s = 0; s < R.nslot; ++s) {
    const T mu = R.mu[s];
    T c[6][4];
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const T(&J)[3][9] = R.J[s][l];
      const T* y = ys[s][l];
      const T yn = ((y[0] + y[1]) + y[2]) + y[3];
      const T y1 = mu * (y[0] - y[1]);
      const T y2 = mu * (y[2] - y[3]);
#pragma unroll
      for (int i = 0; i < 6; ++i) c[i][l] = J[0][i] * yn + (J[1][i] * y1 + J[2][i] * y2);
#pragma unroll
      for (int k = 0; k < 3; ++k)
        yl[k][l] = yl[k][l] + (J[0][6 + k] * yn + (J[1][6 + k] * y1 + J[2][6 + k] * y2));
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) yf[i] = yf[i] + sum4(c[i][0], c[i][1], c[i][2], c[i][3]);
  }
}

// H = M + Jᵀ diag(w) J on the block pattern
template <typename T>
QG_DEV void add_jwj(const Blocks<T>& M, const Rows<T>& R, const T wl[3][4], const T ws[][4][4],
                    Blocks<T>& H) {
  H = M;
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int l = 0; l < 4; ++l) H.ll[k][k][l] = H.ll[k][k][l] + wl[k][l];
  for (int s = 0; s < R.nslot; ++s) {
    const T mu = R.mu[s];
    T cnn[4], c11[4], c22[4], cn1[4], cn2[4];
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const T* w = ws[s][l];
      cnn[l] = ((w[0] + w[1]) + w[2]) + w[3];
      c11[l] = mu * mu * (w[0] + w[1]);
      c22[l] = mu * mu * (w[2] + w[3]);
      cn1[l] = mu * (w[0] - w[1]);
      cn2[l] = mu * (w[2] - w[3]);
    }
    auto pairval = [&](int l, int a, int b) -> T {
      const T(&J)[3][9] = R.J[s][l];
      const T ni = J[0][a], t1i = J[1][a], t2i = J[2][a];
      const T nj = J[0][b], t1j = J[1][b], t2j = J[2][b];
      return (((cnn[l] * ni * nj + c11[l] * t1i * t1j) + c22[l] * t2i * t2j)
              + cn1[l] * (ni * t1j + t1i * nj)) + cn2[l] * (ni * t2j + t2i * nj);
    };
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j)
        H.ff[i][j] = H.ff[i][j] + sum4(pairval(0, i, j), pairval(1, i, j), pairval(2, i, j),
                                       pairval(3, i, j));
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int l = 0; l < 4; ++l) H.fl[i][k][l] = H.fl[i][k][l] + pairval(l, i, 6 + k);
    }
#pragma unroll
    for (int ki = 0; ki < 3; ++ki)
#pragma unroll
      for (int kj = 0; kj <= ki; ++kj)
#pragma unroll
        for (int l = 0; l < 4; ++l) H.ll[ki][kj][l] = H.ll[ki][kj][l] + pairval(l, 6 + ki, 6 + kj);
  }
}

template <typename T> QG_DEV T active_weight(T jar, T D) { return (jar < T(0) && D > T(0)) ? D : T(0); }

// primal Newton on the constraint rows; x (in: unconstrained qacc) -> qacc
template <typename T>
QG_DEV void newton_solve(const Blocks<T>& M, const Rows<T>& R, const T qaf[6], const T qal[3][4],
                         int iterations, int ls_iterations, T xf[6], T xl[3][4]) {
  T jarl[3][4], jars[MAX_SLOTS][4][4];
  T jdl[3][4], jds[MAX_SLOTS][4][4];
  T wl[3][4], ws[MAX_SLOTS][4][4];
#pragma unroll
  for (int i = 0; i < 6; ++i) xf[i] = qaf[i];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int l = 0; l < 4; ++l) xl[k][l] = qal[k][l];
  const int ns = R.nslot;
  for (int it = 0; it < iterations; ++it) {
    rows_matvec(R, xf, xl, jarl, jars);
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        jarl[k][l] = jarl[k][l] - R.lim_aref[k][l];
        wl[k][l] = active_weight(jarl[k][l], R.lim_D[k][l]);
      }
    for (int s = 0; s < ns; ++s)
#pragma unroll
      for (int l = 0; l < 4; ++l)
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          jars[s][l][f] = jars[s][l][f] - R.aref[s][l][f];
          ws[s][l][f] = active_weight(jars[s][l][f], R.D[s][l]);
        }
    // gradient: M (x - qa) + Jᵀ (w * jar)
    T df[6], dl[3][4], gsf[6], gsl[3][4];
#pragma unroll
    for (int i = 0; i < 6; ++i) df[i] = xf[i] - qaf[i];
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int l = 0; l < 4; ++l) dl[k][l] = xl[k][l] - qal[k][l];
    sym_matvec(M, df, dl, gsf, gsl);
    {
      T yl[3][4];
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int l = 0; l < 4; ++l) yl[k][l] = wl[k][l] * jarl[k][l];
      for (int s = 0; s < ns; ++s)
#pragma unroll
        for (int l = 0; l < 4; ++l)
#pragma unroll
          for (int f = 0; f < 4; ++f) jds[s][l][f] = ws[s][l][f] * jars[s][l][f];
      T jtf[6], jtl[3][4];
      rows_tmatvec(R, yl, jds, jtf, jtl);
#pragma unroll
      for (int i = 0; i < 6; ++i) df[i] = -(gsf[i] + jtf[i]);
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int l = 0; l < 4; ++l) dl[k][l] = -(gsl[k][l] + jtl[k][l]);
    }
    T dxf[6], dxl[3][4];
    {
      Blocks<T> H;
      add_jwj(M, R, wl, ws, H);
      Factor<T> F;
      ldl_factor(H, F);
      ldl_solve(F, df, dl, dxf, dxl);
    }
    rows_matvec(R, dxf, dxl, jdl, jds);
    T mdf[6], mdl[3][4];
    sym_matvec(M, dxf, dxl, mdf, mdl);
    T g0 = dxf[0] * gsf[0], h0 = dxf[0] * mdf[0];
#pragma unroll
    for (int i = 1; i < 6; ++i) {
      g0 = g0 + dxf[i] * gsf[i];
      h0 = h0 + dxf[i] * mdf[i];
    }
    T gl = T(0), hl = T(0);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      gl = gl + sum4(dxl[k][0] * gsl[k][0], dxl[k][1] * gsl[k][1], dxl[k][2] * gsl[k][2],
                     dxl[k][3] * gsl[k][3]);
      hl = hl + sum4(dxl[k][0] * mdl[k][0], dxl[k][1] * mdl[k][1], dxl[k][2] * mdl[k][2],
                     dxl[k][3] * mdl[k][3]);
    }
    g0 = g0 + gl;
    h0 = h0 + hl;
    // exact line search along dx: a few 1-D Newton steps, t in [0, 4]
    T t = T(1);
    for (int li = 0; li < ls_iterations; ++li) {
      T dphi = T(0), ddphi = T(0);
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          const T jt = jarl[k][l] + t * jdl[k][l];
          const T w = active_weight(jt, R.lim_D[k][l]);
          dphi = dphi + w * jt * jdl[k][l];
          ddphi = ddphi + w * jdl[k][l] * jdl[k][l];
        }
      for (int s = 0; s < ns; ++s)
#pragma unroll
        for (int l = 0; l < 4; ++l)
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            const T jd = jds[s][l][f];
            const T jt = jars[s][l][f] + t * jd;
            const T w = active_weight(jt, R.D[s][l]);
            dphi = dphi + w * jt * jd;
            ddphi = ddphi + w * jd * jd;
          }
      dphi = (g0 + t * h0) + dphi;
      ddphi = h0 + ddphi;
      t = fmin(fmax(t - dphi / fmax(ddphi, T(1e-30)), T(0)), T(4));
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) xf[i] = xf[i] + t * dxf[i];
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int l = 0; l < 4; ++l) xl[k][l] = xl[k][l] + t * dxl[k][l];
  }
}

}  // namespace qg

#include "leg_substep.cuh"
