// The partial observation of one env (tasks/observations.py::po_observation)
// and the frame window it goes into (stack_push / stack_fill there). Shared
// by observation_kernel.cu and the host build of the tests
// (tests/torch_host_observation.cpp).
//
// The arithmetic follows tasks/madgwick.py and tasks/observations.py term
// for term, in their order; the two part by rounding only, where the card
// fuses a multiply and an add, and where PyTorch sums the 3- and 4-term
// norms in an order of its own.
#pragma once

#include <math.h>

#ifndef QG_DEV
#define QG_DEV __device__ __forceinline__
#endif

namespace qg {

constexpr int PO_OBS_DIM = 26;
constexpr double MADGWICK_GAIN = 0.033;  // tasks/madgwick.py::DEFAULT_GAIN

// an (N, K) input as PyTorch strides it, in elements: a view needs no copy
// (the sensors of a transposed lane state, the quaternion of qpos[:, 3:7],
// the reset's expanded filter quaternion)
template <typename T> struct Strided {
  const T* data;
  long long env;
  long long comp;
  QG_DEV T at(long long i, int k) const { return data[i * env + k * comp]; }
};

template <typename T> struct PoInputs {
  Strided<T> sens, ctrl, vel, heading, quat, time;
  int gyro, accel, velocimeter;  // sensordata addresses (rewards.SensorSlices)
  T half_settling;               // settling_time / 2 in T, as PyTorch compares
  T dt;                          // the control period
};

template <typename T> QG_DEV T clamp_min(T x, T lo) { return x < lo ? lo : x; }  // NaN stays

template <typename T> QG_DEV T norm3(T a, T b, T c) { return sqrt(a * a + b * b + c * c); }

template <typename T> QG_DEV T norm4(const T q[4]) {
  return sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
}

// madgwick.update_imu: q (w, x, y, z), gyr rad/s, acc m/s^2
template <typename T>
QG_DEV void madgwick_imu(const T q[4], const T g[3], const T acc[3], T dt, T out[4]) {
  const T gyr_norm = norm3(g[0], g[1], g[2]);
  // 0.5 * q (x) (0, g), with the zero terms the plain version multiplies
  const T z = T(0);
  T qd[4] = {T(0.5) * (((q[0] * z - q[1] * g[0]) - q[2] * g[1]) - q[3] * g[2]),
             T(0.5) * (((q[0] * g[0] + q[1] * z) + q[2] * g[2]) - q[3] * g[1]),
             T(0.5) * (((q[0] * g[1] - q[1] * g[2]) + q[2] * z) + q[3] * g[0]),
             T(0.5) * (((q[0] * g[2] + q[1] * g[1]) - q[2] * g[0]) + q[3] * z)};
  const T a_norm = norm3(acc[0], acc[1], acc[2]);
  const T a_den = clamp_min(a_norm, T(1e-30));
  const T a[3] = {acc[0] / a_den, acc[1] / a_den, acc[2] / a_den};
  const T q_den = clamp_min(norm4(q), T(1e-15));
  const T qw = q[0] / q_den, qx = q[1] / q_den, qy = q[2] / q_den, qz = q[3] / q_den;
  const T f[3] = {T(2) * (qx * qz - qw * qy) - a[0], T(2) * (qw * qx + qy * qz) - a[1],
                  T(2) * ((T(0.5) - qx * qx) - qy * qy) - a[2]};
  // J^T f, J's rows summed in order
  const T J[3][4] = {{T(-2) * qy, T(2) * qz, T(-2) * qw, T(2) * qx},
                     {T(2) * qx, T(2) * qw, T(2) * qz, T(2) * qy},
                     {z, T(-4) * qx, T(-4) * qy, z}};
  T grad[4];
  for (int k = 0; k < 4; ++k) grad[k] = (J[0][k] * f[0] + J[1][k] * f[1]) + J[2][k] * f[2];
  const T g_den = clamp_min(norm4(grad), T(1e-30));
  if (a_norm > T(0) && norm3(f[0], f[1], f[2]) > T(0)) {
    const T gain = T(MADGWICK_GAIN);
    for (int k = 0; k < 4; ++k) qd[k] = qd[k] - gain * (grad[k] / g_den);
  }
  T qn[4];
  for (int k = 0; k < 4; ++k) qn[k] = q[k] + qd[k] * dt;
  const T n_den = clamp_min(norm4(qn), T(1e-15));
  for (int k = 0; k < 4; ++k) out[k] = gyr_norm > T(0) ? qn[k] / n_den : q[k];
}

// Env i's frame (gyro, accel, the filter's ahrs Euler angles, the local
// velocity xy, the ctrl, the command's velocity xy, the heading angle) and
// its filter quaternion after the step.
template <typename T> QG_DEV void po_frame(const PoInputs<T>& in, long long i, T frame[PO_OBS_DIM],
                                           T quat_out[4]) {
  T q[4], g[3], acc[3];
  for (int k = 0; k < 4; ++k) q[k] = in.quat.at(i, k);
  for (int k = 0; k < 3; ++k) {
    g[k] = in.sens.at(i, in.gyro + k);
    acc[k] = in.sens.at(i, in.accel + k);
  }
  T upd[4];
  madgwick_imu(q, g, acc, in.dt, upd);
  const bool settled = in.time.at(i, 0) > in.half_settling;
  for (int k = 0; k < 4; ++k) quat_out[k] = settled ? upd[k] : q[k];
  const T w = quat_out[0], x = quat_out[1], y = quat_out[2], z = quat_out[3];
  for (int k = 0; k < 3; ++k) {
    frame[k] = g[k];
    frame[3 + k] = acc[k];
  }
  frame[6] = atan2(T(2) * (w * x + y * z), T(1) - T(2) * (x * x + y * y));
  T s = T(2) * (w * y - z * x);
  s = s < T(-1) ? T(-1) : (s > T(1) ? T(1) : s);
  frame[7] = asin(s);
  frame[8] = atan2(T(2) * (w * z + x * y), T(1) - T(2) * (y * y + z * z));
  frame[9] = in.sens.at(i, in.velocimeter);
  frame[10] = in.sens.at(i, in.velocimeter + 1);
  for (int k = 0; k < 12; ++k) frame[11 + k] = in.ctrl.at(i, k);
  frame[23] = in.vel.at(i, 0);
  frame[24] = in.vel.at(i, 1);
  frame[25] = atan2(in.heading.at(i, 1), in.heading.at(i, 0));
}

// A block of the launch takes PO_ENVS consecutive envs and PO_THREADS
// threads: first each of its first PO_ENVS threads computes one env's frame
// into ``frames`` (the block's shared memory) and stores its quaternion,
// then, after a barrier, all of its threads write the block's window rows.
constexpr int PO_ENVS = 8;
constexpr int PO_THREADS = 256;

template <typename T>
QG_DEV void po_block_frames(const PoInputs<T>& in, T* frames, T* quat_out, long long env0, int n,
                            int t) {
  if (t >= PO_ENVS || env0 + t >= n) return;
  T q[4];
  po_frame(in, env0 + t, frames + t * PO_OBS_DIM, q);
  for (int k = 0; k < 4; ++k) quat_out[(env0 + t) * 4 + k] = q[k];
}

// The block's envs' window rows lie contiguous in the (N, W, 26) output,
// so thread t writes entries t, t + PO_THREADS, ... of them: the frame
// itself where the window is filled (``window`` null) or at its newest
// slot, else the old window's entry one frame on (the push). The old
// window is contiguous too, so that entry is 26 further in the same rows.
template <typename T>
QG_DEV void po_block_window(const T* window, const T* frames, T* window_out, long long env0,
                            int n, int W, int t) {
  const long long rem = n - env0;
  const int count = (rem < PO_ENVS ? (int)rem : PO_ENVS) * W * PO_OBS_DIM;
  const long long first = env0 * W * PO_OBS_DIM;
  const int row = W * PO_OBS_DIM, kept = (W - 1) * PO_OBS_DIM;
#pragma unroll 4
  for (int e = t; e < count; e += PO_THREADS) {
    const int env = e / row, r = e - env * row;
    window_out[first + e] = window != nullptr && r < kept
                                ? window[first + e + PO_OBS_DIM]
                                : frames[env * PO_OBS_DIM + r % PO_OBS_DIM];
  }
}

// an input as the wrapper passes it: its data and its strides in elements
struct StridedArg {
  const void* data;
  long long env;
  long long comp;
};

// the inputs from the wrapper's six views (sensordata, ctrl, the command's
// velocity and heading, the filter quaternion, the time) and three
// sensordata addresses (gyro, accelerometer, velocimeter)
template <typename T>
PoInputs<T> po_inputs(const StridedArg* a, const int* adr, double half_settling, double dt) {
  auto view = [&](int k) { return Strided<T>{(const T*)a[k].data, a[k].env, a[k].comp}; };
  return PoInputs<T>{view(0), view(1), view(2), view(3), view(4), view(5), adr[0], adr[1],
                     adr[2], (T)half_settling, (T)dt};
}

}  // namespace qg
