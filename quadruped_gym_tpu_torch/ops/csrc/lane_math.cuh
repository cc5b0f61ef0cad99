// Small-vector algebra in one thread's registers: vec3, quat, row-major
// mat3 and spatial 6-vectors [angular; linear], and the exchanges between
// the threads of a robot. The operation order follows ops/lane.py so the
// float64 kernel tracks the plain version to rounding.
#pragma once

#include <math.h>
#include <stddef.h>

#include <type_traits>

namespace qg {

#define QG_DEV __device__ __forceinline__

// On the card a robot is carried by 4 x SPLIT lanes of a warp: SPLIT
// replicas of an aligned quad, one thread per leg (lane & 3 is the leg,
// (lane >> 2) & (SPLIT - 1) the replica; SPLIT is 1, 2 or 4). Every
// replica runs the whole substep on the same bits, and splits only the
// hull-vertex scans with the others (leg_substep.cuh). quad_sum adds a
// value over the quad by two butterfly steps; every lane gets
// (a0 + a1) + (a2 + a3) bit for bit, because IEEE addition commutes. All
// 32 lanes of the warp must call it together: the kernels keep every
// thread alive and mask only the stores. The host build of the tests
// (QG_HOST) supplies its own quad_sum, lane_best and replica_fence before
// this header, over host threads in lockstep.
#ifndef QG_HOST
template <typename T> QG_DEV T quad_sum(T v) {
  v = v + __shfl_xor_sync(0xffffffffu, v, 1);
  v = v + __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}
#endif

// Whether (ov, oi) beats (v, i): the smaller value (``lower``) or the
// larger, the smaller index on a tie. A total order on the pairs, so the
// best of several is the same whichever way they are paired.
template <typename T> QG_DEV bool beats(T ov, int oi, T v, int i, bool lower) {
  return (lower ? ov < v : ov > v) || (ov == v && oi < i);
}

// The best (value, index) over the lanes lane ^ m, m = FIRST, 2 FIRST, ..
// below LANES, by butterfly steps: every such lane gets the same pair.
// FIRST = 1, LANES = 4 SPLIT is the quad and its replicas; FIRST = 4 the
// replicas of one leg. The second form carries ``h`` with the winner. The
// host build supplies both.
#ifndef QG_HOST
template <int FIRST, int LANES, typename T> QG_DEV void lane_best(T& v, int& i, bool lower) {
#pragma unroll
  for (int m = FIRST; m < LANES; m <<= 1) {
    const T ov = __shfl_xor_sync(0xffffffffu, v, m);
    const int oi = __shfl_xor_sync(0xffffffffu, i, m);
    if (beats(ov, oi, v, i, lower)) { v = ov; i = oi; }
  }
}

template <int FIRST, int LANES, typename T>
QG_DEV void lane_best(T& v, int& i, T& h, bool lower) {
#pragma unroll
  for (int m = FIRST; m < LANES; m <<= 1) {
    const T ov = __shfl_xor_sync(0xffffffffu, v, m);
    const int oi = __shfl_xor_sync(0xffffffffu, i, m);
    const T oh = __shfl_xor_sync(0xffffffffu, h, m);
    if (beats(ov, oi, v, i, lower)) { v = ov; i = oi; h = oh; }
  }
}

// Orders the shared-memory accesses of a robot's replicas, which share
// one column of contact rows a leg (leg_step.cuh::RowStore)
QG_DEV void replica_fence() { __syncwarp(); }
#endif

// log2 of a split of 1, 2 or 4 replicas
template <int SPLIT> constexpr int split_log = SPLIT == 4 ? 2 : SPLIT == 2 ? 1 : 0;

// f(std::integral_constant<int, SPLIT>()) for a split of 1, 2 or 4;
// ``bad`` for any other
template <typename F> int with_split(int split, int bad, F&& f) {
  switch (split) {
    case 1: return f(std::integral_constant<int, 1>());
    case 2: return f(std::integral_constant<int, 2>());
    case 4: return f(std::integral_constant<int, 4>());
    default: return bad;
  }
}

#ifndef QG_HOST
// Where a thread of a kernel instantiated for SPLIT replicas sits: its
// robot over the grid, its leg, its replica, and the column of the
// block's contact rows it shares with its leg's replicas (a stride of
// blockDim.x / SPLIT).
template <int SPLIT> struct LaneIndex {
  static constexpr int LOG = split_log<SPLIT>;
  int robot, leg, rep, col;
  QG_DEV LaneIndex() {
    robot = (blockIdx.x * blockDim.x + threadIdx.x) >> (2 + LOG);
    leg = threadIdx.x & 3;
    if constexpr (SPLIT == 1) {
      rep = 0;
      col = threadIdx.x;
    } else {
      rep = (threadIdx.x >> 2) & (SPLIT - 1);
      col = ((threadIdx.x >> (2 + LOG)) << 2) | leg;
    }
  }
  QG_DEV static size_t stride() { return blockDim.x >> LOG; }
};
#endif

template <typename T> QG_DEV T dot3(const T a[3], const T b[3]) {
  return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2];
}

template <typename T> QG_DEV void cross3(const T a[3], const T b[3], T o[3]) {
  T x = a[1] * b[2] - a[2] * b[1];
  T y = a[2] * b[0] - a[0] * b[2];
  T z = a[0] * b[1] - a[1] * b[0];
  o[0] = x; o[1] = y; o[2] = z;
}

template <typename T> QG_DEV void quat_mul(const T a[4], const T b[4], T o[4]) {
  T w = ((a[0] * b[0] - a[1] * b[1]) - a[2] * b[2]) - a[3] * b[3];
  T x = ((a[0] * b[1] + a[1] * b[0]) + a[2] * b[3]) - a[3] * b[2];
  T y = ((a[0] * b[2] - a[1] * b[3]) + a[2] * b[0]) + a[3] * b[1];
  T z = ((a[0] * b[3] + a[1] * b[2]) - a[2] * b[1]) + a[3] * b[0];
  o[0] = w; o[1] = x; o[2] = y; o[3] = z;
}

template <typename T> QG_DEV void quat_normalize(T q[4]) {
  T n2 = (q[0] * q[0] + q[1] * q[1]) + (q[2] * q[2] + q[3] * q[3]);
  T inv = T(1) / fmax(sqrt(n2), T(1e-15));
  for (int i = 0; i < 4; ++i) q[i] = inv * q[i];
}

// v' = v + 2 w (u x v) + 2 u x (u x v)
template <typename T> QG_DEV void quat_rotate(const T q[4], const T v[3], T o[3]) {
  const T u[3] = {q[1], q[2], q[3]};
  T uv[3], uuv[3];
  cross3(u, v, uv);
  cross3(u, uv, uuv);
  for (int i = 0; i < 3; ++i) o[i] = v[i] + T(2) * (q[0] * uv[i] + uuv[i]);
}

template <typename T> QG_DEV void quat_to_mat(const T q[4], T m[9]) {
  const T w = q[0], x = q[1], y = q[2], z = q[3];
  const T xx = T(2) * (x * x), yy = T(2) * (y * y), zz = T(2) * (z * z);
  const T xy = T(2) * (x * y), xz = T(2) * (x * z), yz = T(2) * (y * z);
  const T wx = T(2) * (w * x), wy = T(2) * (w * y), wz = T(2) * (w * z);
  m[0] = T(1) - (yy + zz); m[1] = xy - wz;            m[2] = xz + wy;
  m[3] = xy + wz;            m[4] = T(1) - (xx + zz); m[5] = yz - wx;
  m[6] = xz - wy;            m[7] = yz + wx;            m[8] = T(1) - (xx + yy);
}

template <typename T> QG_DEV void mat_vec(const T m[9], const T v[3], T o[3]) {
  T r[3];
  for (int i = 0; i < 3; ++i) r[i] = (m[3 * i] * v[0] + m[3 * i + 1] * v[1]) + m[3 * i + 2] * v[2];
  o[0] = r[0]; o[1] = r[1]; o[2] = r[2];
}

template <typename T> QG_DEV void mat_tvec(const T m[9], const T v[3], T o[3]) {
  T r[3];
  for (int i = 0; i < 3; ++i) r[i] = (m[i] * v[0] + m[3 + i] * v[1]) + m[6 + i] * v[2];
  o[0] = r[0]; o[1] = r[1]; o[2] = r[2];
}

template <typename T> QG_DEV void mat_mul(const T a[9], const T b[9], T o[9]) {
  T r[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      r[3 * i + j] = (a[3 * i] * b[j] + a[3 * i + 1] * b[3 + j]) + a[3 * i + 2] * b[6 + j];
  for (int i = 0; i < 9; ++i) o[i] = r[i];
}

// axis-angle -> quat, (cos(angle/2), axis sin(angle/2))
template <typename T> QG_DEV void axis_angle(const T axis[3], T angle, T o[4]) {
  const T half = angle * T(0.5);
  const T s = sin(half);
  o[0] = cos(half); o[1] = axis[0] * s; o[2] = axis[1] * s; o[3] = axis[2] * s;
}

// exact exponential-map integration (mju_quatIntegrate)
template <typename T> QG_DEV void quat_integrate(T q[4], const T om[3], T dt) {
  const T angle = sqrt(fmax(dot3(om, om), T(1e-30)));
  const T inv = T(1) / fmax(angle, T(1e-30));
  const T axis[3] = {inv * om[0], inv * om[1], inv * om[2]};
  T dq[4], out[4];
  axis_angle(axis, angle * dt, dq);
  quat_mul(q, dq, out);
  quat_normalize(out);
  for (int i = 0; i < 4; ++i) q[i] = out[i];
}

template <typename T> QG_DEV T sv_dot(const T a[6], const T b[6]) {
  T acc = a[0] * b[0];
  for (int i = 1; i < 6; ++i) acc = acc + a[i] * b[i];
  return acc;
}

// spatial motion cross v x m
template <typename T> QG_DEV void motion_cross(const T v[6], const T m[6], T o[6]) {
  T top[3], b1[3], b2[3];
  cross3(v, m, top);
  cross3(v, m + 3, b1);
  cross3(v + 3, m, b2);
  o[0] = top[0]; o[1] = top[1]; o[2] = top[2];
  o[3] = b1[0] + b2[0]; o[4] = b1[1] + b2[1]; o[5] = b1[2] + b2[2];
}

// spatial force cross v x* f
template <typename T> QG_DEV void force_cross(const T v[6], const T f[6], T o[6]) {
  T t1[3], t2[3], bot[3];
  cross3(v, f, t1);
  cross3(v + 3, f + 3, t2);
  cross3(v, f + 3, bot);
  o[0] = t1[0] + t2[0]; o[1] = t1[1] + t2[1]; o[2] = t1[2] + t2[2];
  o[3] = bot[0]; o[4] = bot[1]; o[5] = bot[2];
}

// Spatial inertia at the origin in its structured form: mass m, first
// moment h = m c, and the 3x3 rotational block I (about the origin).
//   [I  [h]x ] [w]   [I w + h x v]
//   [-[h]x m ] [v] = [m v - h x w]
template <typename T> struct SpInertia { T m; T h[3]; T I[9]; };

template <typename T>
QG_DEV void spatial_inertia(T mass, const T inertia[3], const T imat[9], const T c[3],
                            SpInertia<T>& o) {
  const T c2 = (c[0] * c[0] + c[1] * c[1]) + c[2] * c[2];
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) {
      T ic = ((imat[3 * a] * inertia[0]) * imat[3 * b] + (imat[3 * a + 1] * inertia[1]) * imat[3 * b + 1])
             + (imat[3 * a + 2] * inertia[2]) * imat[3 * b + 2];
      T par = (a == b) ? c2 - c[a] * c[b] : -(c[a] * c[b]);
      o.I[3 * a + b] = ic + mass * par;
    }
  o.m = mass;
  for (int i = 0; i < 3; ++i) o.h[i] = mass * c[i];
}

template <typename T> QG_DEV void si_add(SpInertia<T>& a, const SpInertia<T>& b) {
  a.m = a.m + b.m;
  for (int i = 0; i < 3; ++i) a.h[i] = a.h[i] + b.h[i];
  for (int i = 0; i < 9; ++i) a.I[i] = a.I[i] + b.I[i];
}

template <typename T> QG_DEV void si_vec(const SpInertia<T>& s, const T v[6], T o[6]) {
  const T* w = v;
  const T* u = v + 3;
  T r[6];
  for (int a = 0; a < 3; ++a) r[a] = (s.I[3 * a] * w[0] + s.I[3 * a + 1] * w[1]) + s.I[3 * a + 2] * w[2];
  r[0] = (r[0] - s.h[2] * u[1]) + s.h[1] * u[2];
  r[1] = (r[1] + s.h[2] * u[0]) - s.h[0] * u[2];
  r[2] = (r[2] - s.h[1] * u[0]) + s.h[0] * u[1];
  r[3] = (s.h[2] * w[1] - s.h[1] * w[2]) + s.m * u[0];
  r[4] = (s.h[0] * w[2] - s.h[2] * w[0]) + s.m * u[1];
  r[5] = (s.h[1] * w[0] - s.h[0] * w[1]) + s.m * u[2];
  for (int i = 0; i < 6; ++i) o[i] = r[i];
}

// MuJoCo impedance: imp = [d0, dmax-d0, width, mid, power, a, b]
template <typename T> QG_DEV T impedance(const T* imp, T r) {
  const T x = fmin(fmax(fabs(r) / imp[2], T(0)), T(1));
  const T power = imp[4];
  const T xp = (power == T(2)) ? x * x : pow(x, power);
  const T omx = T(1) - x;
  const T omp = (power == T(2)) ? omx * omx : pow(omx, power);
  const T y = (x < imp[3]) ? imp[5] * xp : T(1) - imp[6] * omp;
  return imp[0] + y * imp[1];
}

}  // namespace qg
