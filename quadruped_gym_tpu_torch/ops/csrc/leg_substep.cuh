// One whole substep: FK -> CRBA -> RNE -> actuation -> LDLᵀ -> plane
// contacts (_collide_loop) -> primal Newton -> sensors -> implicitfast.
// Included by leg_step.cuh after the linear-algebra helpers.
#pragma once

namespace qg {

// ground frame (n, t1, t2) and offset at world xy for this rollout:
// static plane, per-rollout tilt, or the terrain's local tangent plane
template <typename T>
QG_DEV void tilt_frame(T gx, T gy, T fr[9]) {
  const T inv = T(1) / sqrt((gx * gx + gy * gy) + T(1));
  fr[0] = -gx * inv; fr[1] = -gy * inv; fr[2] = inv;
  const T s = T(1) / sqrt(fr[1] * fr[1] + fr[2] * fr[2]);
  fr[3] = T(0); fr[4] = fr[2] * s; fr[5] = -fr[1] * s;
  cross3(fr, fr + 3, fr + 6);
}

template <typename T>
QG_DEV void terrain_plane(const LegModel<T>& M, const Domain<T>& dp, T x, T y, T fr[9], T& off) {
  const T xr = x - M.plane_pos[0];
  const T yr = y - M.plane_pos[1];
  T z = (dp.tilt_x * xr + dp.tilt_y * yr) + M.plane_pos[2];
  T gx = dp.tilt_x, gy = dp.tilt_y;
  const T A = dp.amp, k = dp.freq;
  const T sx = sin(k * xr), cx = cos(k * xr), sy = sin(k * yr), cy = cos(k * yr);
  z = z + (A * sx) * sy;
  gx = gx + ((A * k) * cx) * sy;
  gy = gy + ((A * k) * sx) * cy;
  tilt_frame(gx, gy, fr);
  off = (fr[0] * x + fr[1] * y) + fr[2] * z;
}

// One substep in place on (q, qv, act) under ctrl. When ``sens`` is not
// null the pre-integration cost sensors are written there.
template <typename T>
QG_DEV void leg_substep(const LegModel<T>& M, const Domain<T>& dp, T q[19], T qv[18], T act[12],
                        const T ctrl[12], int iterations, int ls_iterations,
                        CostSensors<T>* sens) {
  const T h = M.timestep;
  T ql[3][4], qvl[3][4], al[3][4], cl[3][4];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      ql[k][l] = q[7 + 3 * l + k];
      qvl[k][l] = qv[6 + 3 * l + k];
      al[k][l] = act[3 * l + k];
      cl[k][l] = fmin(fmax(ctrl[3 * l + k], M.lev_ctrlrange[k][0]), M.lev_ctrlrange[k][1]);
    }

  // ---- forward kinematics ----
  const T org[3] = {q[0], q[1], q[2]};  // kin.origin = base position
  T bq[4] = {q[3], q[4], q[5], q[6]};
  quat_normalize(bq);
  T bmat[9];
  quat_to_mat(bq, bmat);
  T lpos[3][4][3], lmat[3][4][9];
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    T pos[3], quat[4], tmp[3], tq[4];
    quat_rotate(bq, M.hip_pos[l], tmp);
    for (int i = 0; i < 3; ++i) pos[i] = org[i] + tmp[i];
    quat_mul(bq, M.hip_quat[l], quat);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (k > 0) {
        quat_rotate(quat, M.lev_body_pos[k], tmp);
        for (int i = 0; i < 3; ++i) pos[i] = pos[i] + tmp[i];
        quat_mul(quat, M.lev_body_quat[k], tq);
        for (int i = 0; i < 4; ++i) quat[i] = tq[i];
      }
      const T angle = ql[k][l] - M.lev_qpos0[k];
      T anchor[3];
      quat_rotate(quat, M.lev_jnt_pos[k], tmp);
      for (int i = 0; i < 3; ++i) anchor[i] = pos[i] + tmp[i];
      T aq[4];
      axis_angle(M.lev_jnt_axis[k], angle, aq);
      quat_mul(quat, aq, tq);
      for (int i = 0; i < 4; ++i) quat[i] = tq[i];
      quat_rotate(quat, M.lev_jnt_pos[k], tmp);
      for (int i = 0; i < 3; ++i) pos[i] = anchor[i] - tmp[i];
      for (int i = 0; i < 3; ++i) lpos[k][l][i] = pos[i];
      quat_to_mat(quat, lmat[k][l]);
    }
  }

  // ---- motion subspaces: free dofs 0-2 translate along e_i, 3-5 rotate
  // about the base axes (bmat columns) through the origin ----
  T ax[3][3];  // ax[k] = bmat column k
#pragma unroll
  for (int k = 0; k < 3; ++k) { ax[k][0] = bmat[k]; ax[k][1] = bmat[3 + k]; ax[k][2] = bmat[6 + k]; }
  T Sl[3][4][6];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      T tmp[3], anc[3];
      mat_vec(lmat[k][l], M.lev_jnt_pos[k], tmp);
      for (int i = 0; i < 3; ++i) anc[i] = (lpos[k][l][i] + tmp[i]) - org[i];
      mat_vec(lmat[k][l], M.lev_jnt_axis[k], Sl[k][l]);
      cross3(anc, Sl[k][l], Sl[k][l] + 3);
    }
  auto sfree = [&](int d, T o[6]) {
    for (int i = 0; i < 6; ++i) o[i] = T(0);
    if (d < 3) o[3 + d] = T(1);
    else { o[0] = ax[d - 3][0]; o[1] = ax[d - 3][1]; o[2] = ax[d - 3][2]; }
  };

  // ---- body velocities ----
  T vb[6];
  vb[0] = (qv[3] * ax[0][0] + qv[4] * ax[1][0]) + qv[5] * ax[2][0];
  vb[1] = (qv[3] * ax[0][1] + qv[4] * ax[1][1]) + qv[5] * ax[2][1];
  vb[2] = (qv[3] * ax[0][2] + qv[4] * ax[1][2]) + qv[5] * ax[2][2];
  vb[3] = qv[0]; vb[4] = qv[1]; vb[5] = qv[2];
  T vl[3][4][6];
#pragma unroll
  for (int l = 0; l < 4; ++l)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      for (int i = 0; i < 6; ++i)
        vl[k][l][i] = (k ? vl[k - 1][l][i] : vb[i]) + qvl[k][l] * Sl[k][l][i];

  // ---- spatial inertias about the origin ----
  SpInertia<T> Ib;
  {
    T tmp[3], c[3], imat[9], inertia[3];
    mat_vec(bmat, M.base_ipos, tmp);
    for (int i = 0; i < 3; ++i) c[i] = (org[i] + tmp[i]) - org[i];
    mat_mul(bmat, M.base_imat, imat);
    T mass = M.base_mass;
    for (int i = 0; i < 3; ++i) inertia[i] = M.base_inertia[i];
    if (dp.has_mass) {
      mass = dp.mass * mass;
      for (int i = 0; i < 3; ++i) inertia[i] = dp.mass * inertia[i];
    }
    spatial_inertia(mass, inertia, imat, c, Ib);
  }
  SpInertia<T> Il[3][4];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      T tmp[3], c[3], imat[9];
      mat_vec(lmat[k][l], M.lev_ipos[k], tmp);
      for (int i = 0; i < 3; ++i) c[i] = (lpos[k][l][i] + tmp[i]) - org[i];
      mat_mul(lmat[k][l], M.lev_imat[k], imat);
      spatial_inertia(M.lev_mass[k], M.lev_inertia[k], imat, c, Il[k][l]);
    }

  // ---- CRBA: composite inertias leaf -> root, then the block matrix ----
  Blocks<T> Mb;
  {
    SpInertia<T> Ic[3][4];
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      Ic[2][l] = Il[2][l];
      Ic[1][l] = Il[1][l]; si_add(Ic[1][l], Ic[2][l]);
      Ic[0][l] = Il[0][l]; si_add(Ic[0][l], Ic[1][l]);
    }
    SpInertia<T> Icb = Ib;
    Icb.m = Icb.m + sum4(Ic[0][0].m, Ic[0][1].m, Ic[0][2].m, Ic[0][3].m);
    for (int i = 0; i < 3; ++i) Icb.h[i] = Icb.h[i] + sum4(Ic[0][0].h[i], Ic[0][1].h[i], Ic[0][2].h[i], Ic[0][3].h[i]);
    for (int i = 0; i < 9; ++i) Icb.I[i] = Icb.I[i] + sum4(Ic[0][0].I[i], Ic[0][1].I[i], Ic[0][2].I[i], Ic[0][3].I[i]);
    T Ff[6][6];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      T s[6];
      sfree(i, s);
      si_vec(Icb, s, Ff[i]);
    }
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        T s[6];
        sfree(j, s);
        T v = sv_dot(s, Ff[i]);
        if (i == j) v = v + M.free_armature[i];
        Mb.ff[i][j] = v;
      }
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        T Fl[6];
        si_vec(Ic[k][l], Sl[k][l], Fl);
        for (int i = 0; i < 6; ++i) {
          T s[6];
          sfree(i, s);
          Mb.fl[i][k][l] = sv_dot(s, Fl);
        }
        for (int kj = 0; kj <= k; ++kj) {
          T v = sv_dot(Sl[kj][l], Fl);
          if (kj == k) v = v + M.leg_armature;
          Mb.ll[k][kj][l] = v;
        }
      }
  }

  // ---- RNE bias forces (gravity + velocity products) ----
  T bias_f[6], bias_l[3][4];
  {
    const T vJb[6] = {vb[0], vb[1], vb[2], vb[3] - qv[0], vb[4] - qv[1], vb[5] - qv[2]};
    T accb[6], tmp[6];
    motion_cross(vb, vJb, tmp);
    const T acc0[6] = {T(0), T(0), T(0), -M.gravity[0], -M.gravity[1], -M.gravity[2]};
    for (int i = 0; i < 6; ++i) accb[i] = acc0[i] + tmp[i];
    auto body_force = [&](const SpInertia<T>& I, const T v[6], const T a[6], T f[6]) {
      T Ia[6], Iv[6], fc[6];
      si_vec(I, a, Ia);
      si_vec(I, v, Iv);
      force_cross(v, Iv, fc);
      for (int i = 0; i < 6; ++i) f[i] = Ia[i] + fc[i];
    };
    T fb[6];
    body_force(Ib, vb, accb, fb);
    T fsub[3][4][6];
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      T acc[3][6], fl[3][6];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        T vJ[6], mc[6];
        for (int i = 0; i < 6; ++i) vJ[i] = qvl[k][l] * Sl[k][l][i];
        motion_cross(vl[k][l], vJ, mc);
        for (int i = 0; i < 6; ++i) acc[k][i] = (k ? acc[k - 1][i] : accb[i]) + mc[i];
        body_force(Il[k][l], vl[k][l], acc[k], fl[k]);
      }
      for (int i = 0; i < 6; ++i) {
        fsub[2][l][i] = fl[2][i];
        fsub[1][l][i] = fl[1][i] + fsub[2][l][i];
        fsub[0][l][i] = fl[0][i] + fsub[1][l][i];
      }
    }
    T fbase[6];
    for (int i = 0; i < 6; ++i)
      fbase[i] = fb[i] + sum4(fsub[0][0][i], fsub[0][1][i], fsub[0][2][i], fsub[0][3][i]);
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      T s[6];
      sfree(i, s);
      bias_f[i] = sv_dot(s, fbase);
    }
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int l = 0; l < 4; ++l) bias_l[k][l] = sv_dot(Sl[k][l], fsub[k][l]);
  }

  // ---- servo actuation + passive forces ----
  T qff[6], qfl[3][4], dvel[3][4];
#pragma unroll
  for (int i = 0; i < 6; ++i) qff[i] = -M.free_damping[i] * qv[i] - bias_f[i];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      T kp_term = M.lev_kp[k] * al[k][l];
      T bias_q = M.lev_bq[k] * ql[k][l];
      if (dp.has_gain) {
        kp_term = dp.gain * kp_term;
        bias_q = dp.gain * bias_q;
      }
      const T force = kp_term + (M.lev_b0[k] + (bias_q + M.lev_bv[k] * qvl[k][l]));
      const T lo = M.lev_forcerange[k][0], hi = M.lev_forcerange[k][1];
      const T clamped = fmin(fmax(force, lo), hi);
      dvel[k][l] = (force > lo && force < hi) ? M.lev_dvel[k] : T(0);
      qfl[k][l] = (M.lev_gear[k] * clamped - M.leg_damping * qvl[k][l]) - bias_l[k][l];
    }

  T xf[6], xl[3][4];
  {
    Factor<T> F;
    ldl_factor(Mb, F);
    ldl_solve(F, qff, qfl, xf, xl);
  }

  // ---- contacts + constraint rows + Newton ----
  if (iterations > 0) {
    Rows<T> R;
    T gframe[9], goff;
    if (dp.has_tilt) {
      tilt_frame(dp.tilt_x, dp.tilt_y, gframe);
      goff = (gframe[0] * M.plane_pos[0] + gframe[1] * M.plane_pos[1]) + gframe[2] * M.plane_pos[2];
    } else {
      for (int i = 0; i < 9; ++i) gframe[i] = M.plane_frame[i];
      goff = M.plane_off;
    }
    // joint limits
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const T d_lo = ql[k][l] - M.lev_range[k][0];
        const T d_hi = M.lev_range[k][1] - ql[k][l];
        const bool lower = d_lo <= d_hi;
        const T dist = lower ? d_lo : d_hi;
        const T sign = lower ? T(1) : T(-1);
        const bool active = dist < M.lev_jnt_margin[k];
        const T r = dist - M.lev_jnt_margin[k];
        const T imp = impedance(M.lev_jnt_imp[k], r);
        R.lim_aref[k][l] = -M.lev_jnt_B[k] * (sign * qvl[k][l]) - (M.lev_jnt_K[k] * imp) * r;
        const T Rv = fmax((T(1) - imp) / imp * M.lev_invweight[k], T(1e-15));
        R.lim_D[k][l] = active ? T(1) / Rv : T(0);
        R.lim_sign[k][l] = sign;
      }
    // plane-convex contacts, group by group
    int ns = 0;
    for (int g = 0; g < M.ngroup; ++g) {
      const int level = M.grp_level[g];
      const int nslot = M.grp_nslot[g];
      const int v0i = M.grp_vstart[g], V = M.grp_nvert[g];
      const T margin = M.grp_margin[g], margin2 = M.grp_margin2[g];
      const T mu = dp.has_friction ? dp.friction : M.grp_friction[g];
      T gpos[4][3], gmat[4][9], fr[4][9], a[4][3], base[4];
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        T tmp[3];
        mat_vec(lmat[level][l], M.grp_pos[g], tmp);
        for (int i = 0; i < 3; ++i) gpos[l][i] = lpos[level][l][i] + tmp[i];
        mat_mul(lmat[level][l], M.grp_mat[g], gmat[l]);
        T off;
        if (dp.has_terrain) {
          terrain_plane(M, dp, gpos[l][0], gpos[l][1], fr[l], off);
        } else {
          for (int i = 0; i < 9; ++i) fr[l][i] = gframe[i];
          off = goff;
        }
        mat_tvec(gmat[l], fr[l], a[l]);
        base[l] = dot3(gpos[l], fr[l]) - off;
      }
      auto height = [&](int i, int l) -> T {
        const T* v = M.vert[v0i + i];
        return (v[0] * a[l][0] + v[1] * a[l][1]) + (v[2] * a[l][2] + base[l]);
      };
      // slot 0: deepest vertex (strict <: first index wins ties)
      int i0[4], i1[4], i2[4];
      T h0[4], h1[4], h2[4], d1[4], c2[4];
#pragma unroll
      for (int l = 0; l < 4; ++l) { i0[l] = 0; h0[l] = height(0, l); }
      for (int i = 1; i < V; ++i)
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          const T hi = height(i, l);
          if (hi < h0[l]) { h0[l] = hi; i0[l] = i; }
        }
      // slot 1: farthest in-plane candidate from v0
      if (nslot >= 2) {
        T v0n2[4];
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          const T* v0 = M.vert[v0i + i0[l]];
          v0n2[l] = dot3(v0, v0);
          d1[l] = T(-1); i1[l] = -1; h1[l] = T(0);
        }
        for (int i = 0; i < V; ++i) {
          const T* vi = M.vert[v0i + i];
#pragma unroll
          for (int l = 0; l < 4; ++l) {
            const T* v0 = M.vert[v0i + i0[l]];
            const T hi = height(i, l);
            const T vdot0 = (vi[0] * v0[0] + vi[1] * v0[1]) + vi[2] * v0[2];
            const T dv2 = (M.vert_n2[v0i + i] - T(2) * vdot0) + v0n2[l];
            const T dh = hi - h0[l];
            const T dplan = sqrt(fmax(dv2 - dh * dh, T(0)));
            const T s = hi < margin2 ? dplan : T(-1);
            if (s > d1[l]) { d1[l] = s; i1[l] = i; h1[l] = hi; }
          }
        }
      }
      // slot 2: largest spread across the v0-v1 line
      if (nslot >= 3) {
        T gq[4][3], v0gq[4];
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          const T* v0 = M.vert[v0i + i0[l]];
          T dv[3], u1[3], t[3], perp[3];
          for (int c = 0; c < 3; ++c) dv[c] = (i1[l] >= 0 ? M.vert[v0i + i1[l]][c] : T(0)) - v0[c];
          mat_vec(gmat[l], dv, u1);
          const T inv_d1 = T(1) / fmax(d1[l], T(1e-12));
          const T dh = h1[l] - h0[l];
          for (int c = 0; c < 3; ++c) t[c] = (u1[c] - fr[l][c] * dh) * inv_d1;
          cross3(fr[l], t, perp);
          mat_tvec(gmat[l], perp, gq[l]);
          v0gq[l] = dot3(v0, gq[l]);
          c2[l] = T(-1); i2[l] = -1; h2[l] = T(0);
        }
        for (int i = 0; i < V; ++i) {
          const T* vi = M.vert[v0i + i];
#pragma unroll
          for (int l = 0; l < 4; ++l) {
            const T hi = height(i, l);
            const T cdot = (vi[0] * gq[l][0] + vi[1] * gq[l][1]) + vi[2] * gq[l][2];
            const T s = hi < margin2 ? fabs(cdot - v0gq[l]) : T(-1);
            if (s > c2[l]) { c2[l] = s; i2[l] = i; h2[l] = hi; }
          }
        }
      }
      // emit the group's slots as constraint rows
      for (int j = 0; j < nslot; ++j) {
        const int s = ns + j;
        R.mu[s] = mu;
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          int vi;
          T dist;
          bool act_ = h0[l] < margin;
          if (j == 0) { vi = i0[l]; dist = h0[l]; }
          else if (j == 1) { vi = i1[l]; dist = h1[l]; act_ = act_ && d1[l] >= M.grp_theta2[g]; }
          else {
            vi = i2[l]; dist = h2[l];
            act_ = act_ && d1[l] >= M.grp_theta2[g] && c2[l] >= M.grp_theta3[g];
          }
          act_ = act_ && dist < M.grp_inc[g];
          T vert[3] = {T(0), T(0), T(0)};
          if (vi >= 0) for (int c = 0; c < 3; ++c) vert[c] = M.vert[v0i + vi][c];
          T p[3], rel[3];
          mat_vec(gmat[l], vert, p);
          for (int c = 0; c < 3; ++c) {
            p[c] = gpos[l][c] + p[c];
            rel[c] = (p[c] - (T(0.5) * fr[l][c]) * dist) - org[c];
          }
          // Jacobian rows: dof d moves the contact point by w = ang x rel + lin
          T(&J)[3][9] = R.J[s][l];
          for (int d = 0; d < 9; ++d) {
            T w[3];
            if (d < 3) {
              w[0] = T(0); w[1] = T(0); w[2] = T(0); w[d] = T(1);
            } else if (d < 6) {
              cross3(ax[d - 3], rel, w);
            } else if (d - 6 <= level) {
              const int k = d - 6;
              cross3(Sl[k][l], rel, w);
              for (int c = 0; c < 3; ++c) w[c] = w[c] + Sl[k][l][3 + c];
            } else {
              w[0] = T(0); w[1] = T(0); w[2] = T(0);
            }
            for (int e = 0; e < 3; ++e) J[e][d] = dot3(w, fr[l] + 3 * e);
          }
          const T r = dist - M.grp_inc[g];
          const T imp = impedance(M.grp_imp[g], r);
          const T diagA = M.grp_2invweight[g] * (T(1) + mu * mu);
          const T Rv = fmax((T(1) - imp) / imp * diagA, T(1e-15));
          R.D[s][l] = act_ ? T(1) / Rv : T(0);
          T v[3];
          for (int e = 0; e < 3; ++e) {
            T acc = J[e][0] * qv[0];
            for (int i = 1; i < 6; ++i) acc = acc + J[e][i] * qv[i];
            for (int k = 0; k < 3; ++k) acc = acc + J[e][6 + k] * qvl[k][l];
            v[e] = acc;
          }
          const T kr = (M.grp_K[g] * imp) * r;
          R.aref[s][l][0] = -M.grp_B[g] * (v[0] + mu * v[1]) - kr;
          R.aref[s][l][1] = -M.grp_B[g] * (v[0] + -mu * v[1]) - kr;
          R.aref[s][l][2] = -M.grp_B[g] * (v[0] + mu * v[2]) - kr;
          R.aref[s][l][3] = -M.grp_B[g] * (v[0] + -mu * v[2]) - kr;
        }
      }
      ns += nslot;
    }
    R.nslot = ns;
    T qaf[6], qal[3][4];
    for (int i = 0; i < 6; ++i) qaf[i] = xf[i];
    for (int k = 0; k < 3; ++k)
      for (int l = 0; l < 4; ++l) qal[k][l] = xl[k][l];
    newton_solve(Mb, R, qaf, qal, iterations, ls_iterations, xf, xl);
  }

  // ---- cost sensors (pre-integration, base site) ----
  if (sens != nullptr) {
    T tmp[3], spos[3], smat[9], p[3], vsite[3], w3[3];
    mat_vec(bmat, M.site_pos, tmp);
    for (int i = 0; i < 3; ++i) spos[i] = org[i] + tmp[i];
    mat_mul(bmat, M.site_mat, smat);
    for (int i = 0; i < 3; ++i) p[i] = spos[i] - org[i];
    cross3(vb, p, w3);
    for (int i = 0; i < 3; ++i) vsite[i] = vb[3 + i] + w3[i];
    T vloc[3];
    mat_tvec(smat, vsite, vloc);
    sens->vel[0] = vloc[0];
    sens->vel[1] = vloc[1];
    sens->xaxis[0] = smat[0];
    sens->xaxis[1] = smat[3];
    sens->zaxis_z = smat[8];
    sens->pos_z = spos[2];
  }

  // ---- implicitfast: (M - h diag(D)) dv = h M qacc ----
  {
    Blocks<T> Mh = Mb;
#pragma unroll
    for (int i = 0; i < 6; ++i)
      if (M.free_damping[i] != T(0)) Mh.ff[i][i] = Mh.ff[i][i] - h * (-M.free_damping[i]);
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int l = 0; l < 4; ++l)
        Mh.ll[k][k][l] = Mh.ll[k][k][l] - h * (-M.leg_damping + dvel[k][l]);
    Factor<T> F;
    ldl_factor(Mh, F);
    T mqf[6], mql[3][4], dvf[6], dvl[3][4];
    sym_matvec(Mb, xf, xl, mqf, mql);
    for (int i = 0; i < 6; ++i) mqf[i] = h * mqf[i];
    for (int k = 0; k < 3; ++k)
      for (int l = 0; l < 4; ++l) mql[k][l] = h * mql[k][l];
    ldl_solve(F, mqf, mql, dvf, dvl);
    for (int i = 0; i < 6; ++i) qv[i] = qv[i] + dvf[i];
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const T v = qvl[k][l] + dvl[k][l];
        qv[6 + 3 * l + k] = v;
        q[7 + 3 * l + k] = ql[k][l] + h * v;
        act[3 * l + k] = al[k][l] + (cl[k][l] - al[k][l]) * M.act_coef;
      }
  }
  for (int i = 0; i < 3; ++i) q[i] = q[i] + h * qv[i];
  {
    T quat[4] = {q[3], q[4], q[5], q[6]};
    const T om[3] = {qv[3], qv[4], qv[5]};
    quat_integrate(quat, om, h);
    for (int i = 0; i < 4; ++i) q[3 + i] = quat[i];
  }
}

}  // namespace qg
