// One whole substep: FK -> CRBA -> RNE -> actuation -> LDLᵀ -> plane
// contacts (_collide_loop) -> primal Newton -> sensors -> implicitfast,
// for the thread of one leg of the robot (leg_step.cuh).
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

// The winner (v, i) of a hull scan shared by the lanes that scanned parts
// of the same hull: for the base's single geom (``one``) the quad and its
// replicas, else the leg's replicas. With ``h`` the winner's height comes
// too: recomputed from the index for the base's single geom (every thread
// of the quad computes the same heights), carried with the winner
// otherwise. Ties go to the lower index (beats).
template <int SPLIT, typename T, typename F>
QG_DEV void share_winner(bool one, T& v, int& i, T* h, F&& height, bool lower) {
  if (one) {
    lane_best<1, 4 * SPLIT>(v, i, lower);
    if (h) *h = i >= 0 ? height(i) : T(0);
  } else if constexpr (SPLIT > 1) {
    if (h) lane_best<4, 4 * SPLIT>(v, i, *h, lower);
    else lane_best<4, 4 * SPLIT>(v, i, lower);
  }
}

// One substep in place on the thread's share ``st`` of the robot's state,
// under its leg's controls. ``rows`` is where the contact rows of the leg
// live during the solve. When ``sens`` is not null the pre-integration
// cost sensors are written there (every thread of the robot gets the same
// values). With FULL, and when ``full`` is not null, every sensor of the
// model's table is written to full[adr * stride] (pre-integration values
// too): a joint position by the thread of the joint's leg, the base-site
// sensors by the thread of leg 0. Without FULL that code is not compiled,
// so the fused rollout pays nothing for it. ``rep`` is the thread's
// replica of its leg, below the rows' SPLIT (lane_math.cuh); every replica
// computes and writes the same bits.
template <bool FULL, int SPLIT, typename T>
QG_DEV void leg_substep_impl(const LegModel<T>& M, const Domain<T>& dp, int leg, int rep,
                             LegState<T>& st, const T ctrl[3], int iterations, int ls_iterations,
                             RowStore<T, SPLIT> rows, CostSensors<T>* sens, T* full,
                             size_t stride) {
  static_assert(SPLIT == 1 || SPLIT == 2 || SPLIT == 4, "a robot's 4 x SPLIT lanes fit one warp");
  const T h = M.timestep;
  T (&ql)[3] = st.q;
  T (&qvl)[3] = st.qv;
  T (&al)[3] = st.act;
  const T (&qv)[6] = st.vf;
  T cl[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    cl[k] = fmin(fmax(ctrl[k], M.lev_ctrlrange[k][0]), M.lev_ctrlrange[k][1]);

  // ---- forward kinematics ----
  const T org[3] = {st.qb[0], st.qb[1], st.qb[2]};  // kin.origin = base position
  T bq[4] = {st.qb[3], st.qb[4], st.qb[5], st.qb[6]};
  quat_normalize(bq);
  T bmat[9];
  quat_to_mat(bq, bmat);
  T lpos[3][3], lmat[3][9];
  {
    T pos[3], quat[4], tmp[3], tq[4];
    quat_rotate(bq, M.hip_pos[leg], tmp);
    for (int i = 0; i < 3; ++i) pos[i] = org[i] + tmp[i];
    quat_mul(bq, M.hip_quat[leg], quat);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (k > 0) {
        quat_rotate(quat, M.lev_body_pos[k], tmp);
        for (int i = 0; i < 3; ++i) pos[i] = pos[i] + tmp[i];
        quat_mul(quat, M.lev_body_quat[k], tq);
        for (int i = 0; i < 4; ++i) quat[i] = tq[i];
      }
      const T angle = ql[k] - M.lev_qpos0[k];
      T anchor[3];
      quat_rotate(quat, M.lev_jnt_pos[k], tmp);
      for (int i = 0; i < 3; ++i) anchor[i] = pos[i] + tmp[i];
      T aq[4];
      axis_angle(M.lev_jnt_axis[k], angle, aq);
      quat_mul(quat, aq, tq);
      for (int i = 0; i < 4; ++i) quat[i] = tq[i];
      quat_rotate(quat, M.lev_jnt_pos[k], tmp);
      for (int i = 0; i < 3; ++i) pos[i] = anchor[i] - tmp[i];
      for (int i = 0; i < 3; ++i) lpos[k][i] = pos[i];
      quat_to_mat(quat, lmat[k]);
    }
  }

  // ---- motion subspaces: free dofs 0-2 translate along e_i, 3-5 rotate
  // about the base axes (bmat columns) through the origin ----
  T ax[3][3];  // ax[k] = bmat column k
#pragma unroll
  for (int k = 0; k < 3; ++k) { ax[k][0] = bmat[k]; ax[k][1] = bmat[3 + k]; ax[k][2] = bmat[6 + k]; }
  T Sl[3][6];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    T tmp[3], anc[3];
    mat_vec(lmat[k], M.lev_jnt_pos[k], tmp);
    for (int i = 0; i < 3; ++i) anc[i] = (lpos[k][i] + tmp[i]) - org[i];
    mat_vec(lmat[k], M.lev_jnt_axis[k], Sl[k]);
    cross3(anc, Sl[k], Sl[k] + 3);
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
  T vl[3][6];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    for (int i = 0; i < 6; ++i) vl[k][i] = (k ? vl[k - 1][i] : vb[i]) + qvl[k] * Sl[k][i];

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
  SpInertia<T> Il[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    T tmp[3], c[3], imat[9];
    mat_vec(lmat[k], M.lev_ipos[k], tmp);
    for (int i = 0; i < 3; ++i) c[i] = (lpos[k][i] + tmp[i]) - org[i];
    mat_mul(lmat[k], M.lev_imat[k], imat);
    spatial_inertia(M.lev_mass[k], M.lev_inertia[k], imat, c, Il[k]);
  }

  // ---- CRBA: composite inertias leaf -> root, then the block matrix ----
  Blocks<T> Mb;
  {
    SpInertia<T> Ic[3];
    Ic[2] = Il[2];
    Ic[1] = Il[1]; si_add(Ic[1], Ic[2]);
    Ic[0] = Il[0]; si_add(Ic[0], Ic[1]);
    SpInertia<T> Icb = Ib;
    Icb.m = Icb.m + quad_sum(Ic[0].m);
#pragma unroll
    for (int i = 0; i < 3; ++i) Icb.h[i] = Icb.h[i] + quad_sum(Ic[0].h[i]);
#pragma unroll
    for (int i = 0; i < 9; ++i) Icb.I[i] = Icb.I[i] + quad_sum(Ic[0].I[i]);
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
    for (int k = 0; k < 3; ++k) {
      T Fl[6];
      si_vec(Ic[k], Sl[k], Fl);
      for (int i = 0; i < 6; ++i) {
        T s[6];
        sfree(i, s);
        Mb.fl[i][k] = sv_dot(s, Fl);
      }
      for (int kj = 0; kj <= k; ++kj) {
        T v = sv_dot(Sl[kj], Fl);
        if (kj == k) v = v + M.leg_armature;
        Mb.ll[k][kj] = v;
      }
    }
  }

  // ---- RNE bias forces (gravity + velocity products) ----
  T bias_f[6], bias_l[3];
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
    T fsub[3][6];
    {
      T acc[3][6], fl[3][6];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        T vJ[6], mc[6];
        for (int i = 0; i < 6; ++i) vJ[i] = qvl[k] * Sl[k][i];
        motion_cross(vl[k], vJ, mc);
        for (int i = 0; i < 6; ++i) acc[k][i] = (k ? acc[k - 1][i] : accb[i]) + mc[i];
        body_force(Il[k], vl[k], acc[k], fl[k]);
      }
      for (int i = 0; i < 6; ++i) {
        fsub[2][i] = fl[2][i];
        fsub[1][i] = fl[1][i] + fsub[2][i];
        fsub[0][i] = fl[0][i] + fsub[1][i];
      }
    }
    T fbase[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) fbase[i] = fb[i] + quad_sum(fsub[0][i]);
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      T s[6];
      sfree(i, s);
      bias_f[i] = sv_dot(s, fbase);
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) bias_l[k] = sv_dot(Sl[k], fsub[k]);
  }

  // ---- servo actuation + passive forces ----
  T qff[6], qfl[3], dvel[3];
#pragma unroll
  for (int i = 0; i < 6; ++i) qff[i] = -M.free_damping[i] * qv[i] - bias_f[i];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    T kp_term = M.lev_kp[k] * al[k];
    T bias_q = M.lev_bq[k] * ql[k];
    if (dp.has_gain) {
      kp_term = dp.gain * kp_term;
      bias_q = dp.gain * bias_q;
    }
    const T force = kp_term + (M.lev_b0[k] + (bias_q + M.lev_bv[k] * qvl[k]));
    const T lo = M.lev_forcerange[k][0], hi = M.lev_forcerange[k][1];
    const T clamped = fmin(fmax(force, lo), hi);
    dvel[k] = (force > lo && force < hi) ? M.lev_dvel[k] : T(0);
    qfl[k] = (M.lev_gear[k] * clamped - M.leg_damping * qvl[k]) - bias_l[k];
  }

  T xf[6], xl[3];
  {
    Factor<T> F;
    ldl_factor(Mb, F);
    ldl_solve(F, qff, qfl, xf, xl);
  }

  // ---- contacts + constraint rows + Newton ----
  if (iterations > 0) {
    Rows<T, SPLIT> R;
    R.M = &M;
    R.has_friction = dp.has_friction;
    R.friction = dp.friction;
    R.st = rows;
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
    for (int k = 0; k < 3; ++k) {
      const T d_lo = ql[k] - M.lev_range[k][0];
      const T d_hi = M.lev_range[k][1] - ql[k];
      const bool lower = d_lo <= d_hi;
      const T dist = lower ? d_lo : d_hi;
      const T sign = lower ? T(1) : T(-1);
      const bool active = dist < M.lev_jnt_margin[k];
      const T r = dist - M.lev_jnt_margin[k];
      const T imp = impedance(M.lev_jnt_imp[k], r);
      R.lim_aref[k] = -M.lev_jnt_B[k] * (sign * qvl[k]) - (M.lev_jnt_K[k] * imp) * r;
      const T Rv = fmax((T(1) - imp) / imp * M.lev_invweight[k], T(1e-15));
      R.lim_D[k] = active ? T(1) / Rv : T(0);
      R.lim_sign[k] = sign;
    }
    // plane-convex contacts, group by group. A group on the base takes
    // the base's frame; the base's single geom (LEVEL_BASE_ONE) is the
    // same geom in every thread of the quad, whose threads scan a quarter
    // of its hull each and share the winners, and leg 0 keeps its slots:
    // the other legs' copies of them are never active. With replicas,
    // replica r scans the share [r V / SPLIT, (r + 1) V / SPLIT) of its
    // leg's hull (of its leg's quarter of the base's single geom) and the
    // replicas share the winners the same way (share_winner). Ties go to
    // the lower index, so every winner is the serial scan's and the rows
    // do not depend on SPLIT.
    int ns = 0;
    rows.fence();
    for (int g = 0; g < M.ngroup; ++g) {
      const int level = M.grp_level[g];
      const bool one = level == LEVEL_BASE_ONE;
      const int nslot = M.grp_nslot[g];
      const int v0i = M.grp_vstart[g], V = M.grp_nvert[g];
      const T margin = M.grp_margin[g], margin2 = M.grp_margin2[g];
      const T mu = R.mu(g);
      T gpos[3], gmat[9], fr[9], a[3], base;
      // level is a run-time value: pick the body's frame by compare-and-keep
      // so that lpos, lmat and Sl stay in registers
      T bpos[3], bmt[9];
      for (int i = 0; i < 3; ++i) bpos[i] = org[i];
      for (int i = 0; i < 9; ++i) bmt[i] = bmat[i];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        if (k == level) {
          for (int i = 0; i < 3; ++i) bpos[i] = lpos[k][i];
          for (int i = 0; i < 9; ++i) bmt[i] = lmat[k][i];
        }
      // the vertices this thread scans: all of its leg's hull, or a
      // quarter of the base's single geom; with replicas, the replica's
      // share of that. lo < V: every share starts on a vertex of the hull,
      // and an empty share's one pair is another's.
      int lo, hi_;
      if constexpr (SPLIT == 1) {
        lo = one ? (leg * V) >> 2 : 0;
        hi_ = one ? ((leg + 1) * V) >> 2 : V;
      } else {
        // one of 4 SPLIT parts of the base's geom, or of SPLIT of a leg's
        const int part = one ? leg * SPLIT + rep : rep;
        const int shift = one ? split_log<SPLIT> + 2 : split_log<SPLIT>;
        lo = (part * V) >> shift;
        hi_ = ((part + 1) * V) >> shift;
      }
      {
        T tmp[3];
        mat_vec(bmt, M.grp_pos[g][leg], tmp);
        for (int i = 0; i < 3; ++i) gpos[i] = bpos[i] + tmp[i];
        mat_mul(bmt, M.grp_mat[g][leg], gmat);
        T off;
        if (dp.has_terrain) {
          terrain_plane(M, dp, gpos[0], gpos[1], fr, off);
        } else {
          for (int i = 0; i < 9; ++i) fr[i] = gframe[i];
          off = goff;
        }
        mat_tvec(gmat, fr, a);
        base = dot3(gpos, fr) - off;
      }
      auto height = [&](int i) -> T {
        const T* v = M.vert[v0i + i];
        return (v[0] * a[0] + v[1] * a[1]) + (v[2] * a[2] + base);
      };
      // slot 0: deepest vertex (strict <: first index wins ties)
      int i0 = lo, i1 = -1, i2 = -1;
      T h0 = height(lo), h1 = T(0), h2 = T(0), d1 = T(-1), c2 = T(-1);
      for (int i = lo + 1; i < hi_; ++i) {
        const T hi = height(i);
        if (hi < h0) { h0 = hi; i0 = i; }
      }
      share_winner<SPLIT>(one, h0, i0, static_cast<T*>(nullptr), height, true);
      // slot 1: farthest in-plane candidate from v0
      T v0[3];  // the deepest vertex, read once (its index differs by thread)
      for (int c = 0; c < 3; ++c) v0[c] = M.vert[v0i + i0][c];
      if (nslot >= 2) {
        const T v0n2 = dot3(v0, v0);
        for (int i = lo; i < hi_; ++i) {
          const T* vi = M.vert[v0i + i];
          const T hi = height(i);
          const T vdot0 = (vi[0] * v0[0] + vi[1] * v0[1]) + vi[2] * v0[2];
          const T dv2 = (M.vert_n2[v0i + i] - T(2) * vdot0) + v0n2;
          const T dh = hi - h0;
          const T dplan = sqrt(fmax(dv2 - dh * dh, T(0)));
          const T s = hi < margin2 ? dplan : T(-1);
          if (s > d1) { d1 = s; i1 = i; h1 = hi; }
        }
        share_winner<SPLIT>(one, d1, i1, &h1, height, false);
      }
      // slot 2: largest spread across the v0-v1 line
      if (nslot >= 3) {
        T gq[3], v0gq;
        {
          T dv[3], u1[3], t[3], perp[3];
          for (int c = 0; c < 3; ++c) dv[c] = (i1 >= 0 ? M.vert[v0i + i1][c] : T(0)) - v0[c];
          mat_vec(gmat, dv, u1);
          const T inv_d1 = T(1) / fmax(d1, T(1e-12));
          const T dh = h1 - h0;
          for (int c = 0; c < 3; ++c) t[c] = (u1[c] - fr[c] * dh) * inv_d1;
          cross3(fr, t, perp);
          mat_tvec(gmat, perp, gq);
          v0gq = dot3(v0, gq);
        }
        for (int i = lo; i < hi_; ++i) {
          const T* vi = M.vert[v0i + i];
          const T hi = height(i);
          const T cdot = (vi[0] * gq[0] + vi[1] * gq[1]) + vi[2] * gq[2];
          const T s = hi < margin2 ? fabs(cdot - v0gq) : T(-1);
          if (s > c2) { c2 = s; i2 = i; h2 = hi; }
        }
        share_winner<SPLIT>(one, c2, i2, &h2, height, false);
      }
      // emit the group's slots as constraint rows
      for (int j = 0; j < nslot; ++j) {
        const int s = ns + j;
        int vi;
        T dist;
        bool act_ = h0 < margin;
        if (j == 0) { vi = i0; dist = h0; }
        else if (j == 1) { vi = i1; dist = h1; act_ = act_ && d1 >= M.grp_theta2[g]; }
        else {
          vi = i2; dist = h2;
          act_ = act_ && d1 >= M.grp_theta2[g] && c2 >= M.grp_theta3[g];
        }
        act_ = act_ && dist < M.grp_inc[g] && !(one && leg != 0);
        T vert[3] = {T(0), T(0), T(0)};
        if (vi >= 0) for (int c = 0; c < 3; ++c) vert[c] = M.vert[v0i + vi][c];
        T p[3], rel[3];
        mat_vec(gmat, vert, p);
        for (int c = 0; c < 3; ++c) {
          p[c] = gpos[c] + p[c];
          rel[c] = (p[c] - (T(0.5) * fr[c]) * dist) - org[c];
        }
        // Jacobian rows: dof d moves the contact point by w = ang x rel + lin
        T J[3][9];
#pragma unroll
        for (int d = 0; d < 9; ++d) {
          T w[3];
          if (d < 3) {
            w[0] = T(0); w[1] = T(0); w[2] = T(0); w[d] = T(1);
          } else if (d < 6) {
            cross3(ax[d - 3], rel, w);
          } else if (d - 6 <= level) {
            const int k = d - 6;
            cross3(Sl[k], rel, w);
            for (int c = 0; c < 3; ++c) w[c] = w[c] + Sl[k][3 + c];
          } else {
            w[0] = T(0); w[1] = T(0); w[2] = T(0);
          }
          for (int e = 0; e < 3; ++e) J[e][d] = dot3(w, fr + 3 * e);
        }
#pragma unroll
        for (int e = 0; e < 3; ++e)
#pragma unroll
          for (int d = 0; d < 9; ++d) rows.at(s, ROW_J + 9 * e + d) = J[e][d];
        const T r = dist - M.grp_inc[g];
        const T imp = impedance(M.grp_imp[g], r);
        const T diagA = M.grp_2invweight[g] * (T(1) + mu * mu);
        const T Rv = fmax((T(1) - imp) / imp * diagA, T(1e-15));
        rows.at(s, ROW_D) = act_ ? T(1) / Rv : T(0);
        T v[3];
#pragma unroll
        for (int e = 0; e < 3; ++e) {
          T acc = J[e][0] * qv[0];
          for (int i = 1; i < 6; ++i) acc = acc + J[e][i] * qv[i];
          for (int k = 0; k < 3; ++k) acc = acc + J[e][6 + k] * qvl[k];
          v[e] = acc;
        }
        const T kr = (M.grp_K[g] * imp) * r;
        rows.at(s, ROW_AREF + 0) = -M.grp_B[g] * (v[0] + mu * v[1]) - kr;
        rows.at(s, ROW_AREF + 1) = -M.grp_B[g] * (v[0] + -mu * v[1]) - kr;
        rows.at(s, ROW_AREF + 2) = -M.grp_B[g] * (v[0] + mu * v[2]) - kr;
        rows.at(s, ROW_AREF + 3) = -M.grp_B[g] * (v[0] + -mu * v[2]) - kr;
      }
      ns += nslot;
    }
    rows.fence();
    T qaf[6], qal[3];
    for (int i = 0; i < 6; ++i) qaf[i] = xf[i];
    for (int k = 0; k < 3; ++k) qal[k] = xl[k];
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

  // ---- all sensors of the model's table (pre-integration, base site):
  // ops/leg_engine.py::_sensors with the base's spatial acceleration
  // assembled from the solved free accelerations ----
  if constexpr (FULL) {
    if (full != nullptr) {
      T tmp[3], spos[3], smat[9], p[3], vsite[3], w3[3];
      mat_vec(bmat, M.site_pos, tmp);
      for (int i = 0; i < 3; ++i) spos[i] = org[i] + tmp[i];
      mat_mul(bmat, M.site_mat, smat);
      for (int i = 0; i < 3; ++i) p[i] = spos[i] - org[i];
      cross3(vb, p, w3);
      for (int i = 0; i < 3; ++i) vsite[i] = vb[3 + i] + w3[i];
      // cacc_base = (0, -g) + sum_d x_free[d] S_free[d] + v_base x vJ_base
      const T vJb[6] = {vb[0], vb[1], vb[2], vb[3] - qv[0], vb[4] - qv[1], vb[5] - qv[2]};
      T mc[6], alpha[3], a0[3];
      motion_cross(vb, vJb, mc);
      for (int i = 0; i < 3; ++i) {
        alpha[i] = ((xf[3] * ax[0][i] + xf[4] * ax[1][i]) + xf[5] * ax[2][i]) + mc[i];
        a0[i] = (xf[i] - M.gravity[i]) + mc[3 + i];
      }
      T c1[3], c2[3], asite[3];
      cross3(alpha, p, c1);
      cross3(vb, vsite, c2);
      for (int i = 0; i < 3; ++i) asite[i] = a0[i] + (c1[i] + c2[i]);
      T accel[3], gyro[3], vloc[3];
      mat_tvec(smat, asite, accel);
      mat_tvec(smat, vb, gyro);
      mat_tvec(smat, vsite, vloc);
      const T xaxis[3] = {smat[0], smat[3], smat[6]};
      const T zaxis[3] = {smat[2], smat[5], smat[8]};
      const bool base_owner = leg == 0;
      auto put3 = [&](int adr, const T v[3]) {
        if (base_owner)
          for (int i = 0; i < 3; ++i) full[(size_t)(adr + i) * stride] = v[i];
      };
      for (int s = 0; s < M.nsensor; ++s) {
        const int adr = M.sens_adr[s];
        switch (M.sens_kind[s]) {
          case SENS_JOINTPOS: {
            // written by the joint's owner; compare-and-keep, so the
            // joint positions stay in registers (no run-time index)
            const int jleg = M.sens_joint[s] / 3, lev = M.sens_joint[s] - 3 * jleg;
            T v = T(0);
            bool mine = false;
#pragma unroll
            for (int k = 0; k < 3; ++k)
              if (jleg == leg && lev == k) { v = ql[k]; mine = true; }
            if (mine) full[(size_t)adr * stride] = v;
            break;
          }
          case SENS_ACCELEROMETER: put3(adr, accel); break;
          case SENS_GYRO: put3(adr, gyro); break;
          case SENS_FRAMEPOS: put3(adr, spos); break;
          case SENS_FRAMELINVEL: put3(adr, vsite); break;
          case SENS_FRAMEXAXIS: put3(adr, xaxis); break;
          case SENS_FRAMEZAXIS: put3(adr, zaxis); break;
          case SENS_VELOCIMETER: put3(adr, vloc); break;
          default: break;  // pack_model refuses other kinds
        }
      }
    }
  }

  // ---- implicitfast: (M - h diag(D)) dv = h M qacc ----
  {
    Blocks<T> Mh = Mb;
#pragma unroll
    for (int i = 0; i < 6; ++i)
      if (M.free_damping[i] != T(0)) Mh.ff[i][i] = Mh.ff[i][i] - h * (-M.free_damping[i]);
#pragma unroll
    for (int k = 0; k < 3; ++k) Mh.ll[k][k] = Mh.ll[k][k] - h * (-M.leg_damping + dvel[k]);
    Factor<T> F;
    ldl_factor(Mh, F);
    T mqf[6], mql[3], dvf[6], dvl[3];
    sym_matvec(Mb, xf, xl, mqf, mql);
    for (int i = 0; i < 6; ++i) mqf[i] = h * mqf[i];
    for (int k = 0; k < 3; ++k) mql[k] = h * mql[k];
    ldl_solve(F, mqf, mql, dvf, dvl);
    for (int i = 0; i < 6; ++i) st.vf[i] = st.vf[i] + dvf[i];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const T v = qvl[k] + dvl[k];
      qvl[k] = v;
      ql[k] = ql[k] + h * v;
      al[k] = al[k] + (cl[k] - al[k]) * M.act_coef;
    }
  }
  for (int i = 0; i < 3; ++i) st.qb[i] = st.qb[i] + h * st.vf[i];
  {
    T quat[4] = {st.qb[3], st.qb[4], st.qb[5], st.qb[6]};
    const T om[3] = {st.vf[3], st.vf[4], st.vf[5]};
    quat_integrate(quat, om, h);
    for (int i = 0; i < 4; ++i) st.qb[3 + i] = quat[i];
  }
}

}  // namespace qg
