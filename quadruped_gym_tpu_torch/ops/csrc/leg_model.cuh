// Model constants of a leg-compatible PhysicsModel, packed by
// ops/cuda_engine.py (``model_struct``, a ctypes.Structure with the same
// fields in the same order) and uploaded once per (model, dtype, device).
// Keep the two definitions in step: tests/test_torch_cuda_engine.py
// parses this struct and compares it with the ctypes one.
#pragma once

namespace qg {

constexpr int NLEG = 4;
constexpr int NLEV = 3;
// the collision groups of ``full`` (every mesh of the MJCF with its
// hull): 5 of the legs, the hip servos and the frame, 1,702 vertices
constexpr int MAX_GROUPS = 7;
constexpr int MAX_VERTS = 2048;
constexpr int MAX_SLOTS = 3 * MAX_GROUPS;  // contact slots per leg
// grp_level of a group on the base (ops/leg_engine.py BASE, BASE_ONE):
// one geom a leg, each with its own frame; or one geom that no leg
// carries, whose slots live in leg 0's rows
constexpr int LEVEL_BASE = -1;
constexpr int LEVEL_BASE_ONE = -2;
constexpr int MAX_SENSORS = 24;

// sensor kinds of the table below (MuJoCo's mjtSensor values)
constexpr int SENS_ACCELEROMETER = 1;
constexpr int SENS_VELOCIMETER = 2;
constexpr int SENS_GYRO = 3;
constexpr int SENS_JOINTPOS = 9;
constexpr int SENS_FRAMEPOS = 26;
constexpr int SENS_FRAMEXAXIS = 28;
constexpr int SENS_FRAMEZAXIS = 30;
constexpr int SENS_FRAMELINVEL = 31;

template <typename T>
struct LegModel {
  T timestep;
  T gravity[3];
  T act_coef;            // 1 - exp(-h / tau)
  T base_mass;
  T base_inertia[3];
  T base_ipos[3];
  T base_imat[9];        // body_iquat as a row-major rotation
  T free_damping[6];
  T free_armature[6];
  T leg_damping;
  T leg_armature;
  T hip_pos[4][3];       // per-leg hip mount (level 0 body_pos/body_quat)
  T hip_quat[4][4];
  T lev_body_pos[3][3];  // levels 1, 2 (row 0 unused)
  T lev_body_quat[3][4];
  T lev_qpos0[3];
  T lev_jnt_pos[3][3];
  T lev_jnt_axis[3][3];
  T lev_mass[3];
  T lev_inertia[3][3];
  T lev_ipos[3][3];
  T lev_imat[3][9];
  T lev_range[3][2];
  T lev_jnt_margin[3];
  T lev_jnt_imp[3][7];   // d0, dmax-d0, width, mid, power, a, b
  T lev_jnt_K[3];
  T lev_jnt_B[3];
  T lev_invweight[3];
  T lev_gear[3];
  T lev_kp[3];           // gainprm[0]
  T lev_b0[3];           // biasprm[0]
  T lev_bq[3];           // biasprm[1] * gear
  T lev_bv[3];           // biasprm[2] * gear
  T lev_dvel[3];         // gear^2 * biasprm[2]
  T lev_forcerange[3][2];
  T lev_ctrlrange[3][2];
  T plane_frame[9];      // n, t1, t2 of the static ground plane
  T plane_off;
  T plane_pos[3];
  T site_pos[3];
  T site_mat[9];
  T joint_centers[12];
  T grp_pos[MAX_GROUPS][NLEG][3];  // geom frame in its body, per leg
  T grp_mat[MAX_GROUPS][NLEG][9];
  T grp_margin[MAX_GROUPS];
  T grp_margin2[MAX_GROUPS];  // 2 * margin: slot candidates
  T grp_theta2[MAX_GROUPS];
  T grp_theta3[MAX_GROUPS];
  T grp_inc[MAX_GROUPS];      // margin - gap
  T grp_friction[MAX_GROUPS];
  T grp_imp[MAX_GROUPS][7];
  T grp_K[MAX_GROUPS];
  T grp_B[MAX_GROUPS];
  T grp_2invweight[MAX_GROUPS];
  T vert[MAX_VERTS][3];
  T vert_n2[MAX_VERTS];
  int ngroup;
  int grp_level[MAX_GROUPS];  // 0-2 a leg level, else LEVEL_BASE(_ONE)
  int grp_nslot[MAX_GROUPS];
  int grp_vstart[MAX_GROUPS];
  int grp_nvert[MAX_GROUPS];
  // sensor table: where each sensor of the model writes in sensordata.
  // A joint-position sensor reads leg joint 3 * leg + level (sens_joint);
  // every other kind reads the IMU site on the base.
  int nsensordata;
  int nsensor;
  int sens_kind[MAX_SENSORS];
  int sens_adr[MAX_SENSORS];
  int sens_joint[MAX_SENSORS];
};

}  // namespace qg
