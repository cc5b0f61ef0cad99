"""Lane-batched physics engine: every model, batch minor.

Counterpart of ``quadruped_gym_tpu/ops/lane_engine.py``: the same math as
``physics.engine`` (MuJoCo ``mj_step`` semantics: FK, CRBA, RNE bias,
position-servo actuation, plane-convex contacts, primal Newton constraint
solve, implicitfast integration) with the state laid out batch minor
(``LaneState``: a per-robot scalar is a (B,) lane vector). It serves every
model, also those that fail ``leg_engine.is_compatible`` (the ``full``
collision model, whose base and hips collide too).

The JAX package unrolls every body, dof and contact slot at trace time
into per-lane scalar ops that XLA fuses into a few loops. Eager PyTorch
launches one kernel per op, so this engine stacks the small structure
instead, and each op covers all of it at once:

  * per-body quantities are (nbody, ..., B) tensors; forward kinematics
    runs one tree depth at a time, the tree sums (composite inertia, body
    velocities and accelerations, subtree forces) are products with
    constant 0/1 ancestor masks;
  * the mass matrix is an (nv, nv, B) tensor, zero off the kinematic-tree
    pattern; its **tree-sparse LDLᵀ** stays a loop over the dofs, with the
    JAX package's arithmetic (one rank-1 update of the ancestor block per
    dof);
  * collision runs every geom's hull at once, hulls padded to the largest
    (padded vertices have height +inf and are never candidates, so they
    never win an ``argmin``/``argmax``, which keep the first index on ties);
  * every contact slot is a masked constraint row (no ``max_contacts``):
    the contact Jacobian is one (nslot, 3, nv, B) tensor, zero outside
    each slot's ancestor dofs, and the pyramid facet rows one
    (nrow, nv, B) tensor, so Jx, Jᵀy and JᵀWJ are single contractions;
  * the Newton solve has a fixed budget (no early exit: nothing is read
    back to the host), its line search is the 1-D Newton clipped to
    [0, 4].

Everything spatial is measured relative to ``kin.origin`` (the base
position). Float32 products are pinned to true FP32 on the card
(``physics.maths.true_fp32``).
"""

from __future__ import annotations

import dataclasses
import types
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..models.spec import (
    JNT_FREE,
    SENSOR_ACCELEROMETER,
    SENSOR_FRAMELINVEL,
    SENSOR_FRAMEPOS,
    SENSOR_FRAMEXAXIS,
    SENSOR_FRAMEZAXIS,
    SENSOR_GYRO,
    SENSOR_JOINTPOS,
    SENSOR_VELOCIMETER,
    PhysicsModel,
)
from ..physics.maths import true_fp32


class LaneState(NamedTuple):
    """Batched state, batch minor: each row is one lane vector."""

    qpos: torch.Tensor  # (nq, B)
    qvel: torch.Tensor  # (nv, B)
    act: torch.Tensor  # (na, B)
    time: torch.Tensor  # (B,)
    sensordata: torch.Tensor  # (nsensordata, B)


def make_lane_state(m: PhysicsModel, batch: int, dtype=torch.float32,
                    device=None) -> LaneState:
    device = resolve_device(device)
    qpos0 = torch.as_tensor(np.asarray(m.qpos0), dtype=dtype, device=device)
    return LaneState(
        qpos=qpos0[:, None].expand(m.nq, batch).contiguous(),
        qvel=torch.zeros((m.nv, batch), dtype=dtype, device=device),
        act=torch.zeros((m.na, batch), dtype=dtype, device=device),
        time=torch.zeros((batch,), dtype=dtype, device=device),
        sensordata=torch.zeros((m.nsensordata, batch), dtype=dtype,
                               device=device),
    )


def from_batched(qpos, qvel, act, time, sensordata) -> LaneState:
    """Convert leading-batch tensors (B, dim) to lane layout (dim, B)."""
    return LaneState(
        qpos=qpos.T, qvel=qvel.T, act=act.T, time=time, sensordata=sensordata.T
    )


def to_batched(ls: LaneState):
    return (ls.qpos.T, ls.qvel.T, ls.act.T, ls.time, ls.sensordata.T)


# --------------------------------------------------------------------------
# static (host-side) model structure, cached per model


@dataclasses.dataclass(frozen=True)
class _Static:
    root: int
    dof_body: Tuple[int, ...]
    dof_parent: Tuple[int, ...]  # previous dof on the kinematic path, -1=root
    dof_chain: Tuple[Tuple[int, ...], ...]  # strict ancestors of each dof
    children: Tuple[Tuple[int, ...], ...]
    body_dofs: Tuple[Tuple[int, ...], ...]  # ancestor dofs per body (sorted)
    m_pairs: Tuple[Tuple[int, int], ...]  # (i, j), j < i, j ancestor of i
    plane_frame: Tuple[Tuple[float, float, float], ...]  # n, t1, t2
    plane_off: float


def _static(m: PhysicsModel) -> _Static:
    # cached ON the model: an id()-keyed dict could serve stale topology
    # to a new model reusing a garbage-collected model's address
    cached = getattr(m, "_lane_static_cache", None)
    if cached is not None:
        return cached
    root = next(b for b in range(1, m.nbody) if m.body_parentid[b] == 0)

    dof_body = []
    for b in range(1, m.nbody):
        dof_body += [b] * m.body_dofnum[b]
    dof_body = tuple(dof_body)

    def last_dof_of_ancestor(b):
        p = m.body_parentid[b]
        while p != 0:
            if m.body_dofnum[p]:
                return m.body_dofadr[p] + m.body_dofnum[p] - 1
            p = m.body_parentid[p]
        return -1

    dof_parent = []
    for b in range(1, m.nbody):
        da, dn = m.body_dofadr[b], m.body_dofnum[b]
        for k in range(dn):
            dof_parent.append(da + k - 1 if k else last_dof_of_ancestor(b))
    dof_parent = tuple(dof_parent)

    dof_chain = []
    for i in range(m.nv):
        chain, p = [], dof_parent[i]
        while p >= 0:
            chain.append(p)
            p = dof_parent[p]
        dof_chain.append(tuple(chain))
    dof_chain = tuple(dof_chain)

    children = tuple(
        tuple(c for c in range(1, m.nbody) if m.body_parentid[c] == b)
        for b in range(m.nbody)
    )

    body_dofs = []
    for b in range(m.nbody):
        dofs, x = [], b
        while x != 0:
            da, dn = m.body_dofadr[x], m.body_dofnum[x]
            dofs += list(range(da, da + dn))
            x = m.body_parentid[x]
        body_dofs.append(tuple(sorted(dofs)))
    body_dofs = tuple(body_dofs)

    m_pairs = tuple((i, j) for i in range(m.nv) for j in dof_chain[i])

    n = np.asarray(m.plane_normal, np.float64)
    ref = np.array([1.0, 0, 0]) if abs(n[0]) < 0.9 else np.array([0.0, 1, 0])
    t1 = np.cross(n, ref)
    t1 /= np.linalg.norm(t1)
    t2 = np.cross(n, t1)
    s = _Static(
        root=root,
        dof_body=dof_body,
        dof_parent=dof_parent,
        dof_chain=dof_chain,
        children=children,
        body_dofs=body_dofs,
        m_pairs=m_pairs,
        plane_frame=(
            tuple(float(x) for x in n),
            tuple(float(x) for x in t1),
            tuple(float(x) for x in t2),
        ),
        plane_off=float(np.dot(n, np.asarray(m.plane_pos))),
    )
    object.__setattr__(m, "_lane_static_cache", s)
    return s


def _f(x) -> float:
    return float(x)


def _v3c(a) -> Tuple[float, float, float]:
    return (float(a[0]), float(a[1]), float(a[2]))


def _quatc(a) -> Tuple[float, float, float, float]:
    return (float(a[0]), float(a[1]), float(a[2]), float(a[3]))


def _np_quat_mat(qc) -> np.ndarray:
    w, x, y, z = (float(qc[0]), float(qc[1]), float(qc[2]), float(qc[3]))
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


# --------------------------------------------------------------------------
# constraint impedance (MuJoCo solref/solimp)


def _impedance_np_params(solimp):
    return tuple(float(x) for x in solimp)


def _imp_lane(solimp, r):
    d0, dmax, width, mid, power = solimp
    x = torch.clamp(torch.abs(r) / max(width, 1e-15), 0.0, 1.0)
    a = 1.0 / mid ** (power - 1.0)
    b = 1.0 / (1.0 - mid) ** (power - 1.0)
    y = torch.where(x < mid, a * x**power, 1.0 - b * (1.0 - x) ** power)
    return d0 + y * (dmax - d0)


def _kb_from_solref(solref, solimp):
    tc, dr = float(solref[0]), float(solref[1])
    dmax = float(solimp[1])
    if tc > 0:
        K = 1.0 / max(dmax**2 * tc**2 * dr**2, 1e-15)
        B = 2.0 / max(dmax * tc, 1e-15)
    else:
        K, B = -tc, -dr
    return K, B


# --------------------------------------------------------------------------
# stacked small-vector algebra: the vector dims come just before the lane
# dim, e.g. a 3-vector per body is (nbody, 3, B), a matrix (nbody, 3, 3, B)


def _dot(a, b):
    return (a * b).sum(-2)


def _mv(A, v):
    """A v for (..., 3, 3, B) and (..., 3, B)."""
    return (A * v.unsqueeze(-3)).sum(-2)


def _mtv(A, v):
    """Aᵀ v (world -> local for rotation matrices)."""
    return (A * v.unsqueeze(-2)).sum(-3)


def _mm(A, C):
    return (A.unsqueeze(-2) * C.unsqueeze(-4)).sum(-3)


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-2)


def _motion_cross(v, u):
    """Spatial motion cross v x u of (..., 6, B) vectors."""
    w, lin = v[..., :3, :], v[..., 3:, :]
    uw, ul = u[..., :3, :], u[..., 3:, :]
    return torch.cat([_cross(w, uw), _cross(w, ul) + _cross(lin, uw)], -2)


def _force_cross(v, f):
    """Spatial force cross v x* f."""
    w, lin = v[..., :3, :], v[..., 3:, :]
    fm, fl = f[..., :3, :], f[..., 3:, :]
    return torch.cat([_cross(w, fm) + _cross(lin, fl), _cross(w, fl)], -2)


def _inertia_vec(I, v):
    """(..., 6, 6, B) spatial inertias times (..., 6, B) vectors."""
    return (I * v.unsqueeze(-3)).sum(-2)


def _tree_sum(mask, x):
    """Σ over the masked rows of ``x``: (n, k) 0/1 mask, (k, ...) -> (n, ...)
    as one product (the lane columns never mix)."""
    return (mask @ x.reshape(x.shape[0], -1)).reshape(
        (mask.shape[0],) + x.shape[1:])


def _quat_normalize(q, eps=1e-15):
    inv = 1.0 / torch.clamp_min(torch.sqrt((q * q).sum(0)), eps)
    return q * inv


def _quat_mul(c, a, b):
    """Hamilton product of (4, B) quaternions: Σ_jk T_ijk a_j b_k."""
    ab = a.unsqueeze(1) * b.unsqueeze(0)  # (4, 4, B)
    return (c.quat_mul * ab.unsqueeze(0)).sum((1, 2))


def _quat_to_mat(c, q):
    """(4, B) unit quaternion -> (3, 3, B): 1 + 2 Σ_kl Q_ijkl q_k q_l."""
    qq = q.unsqueeze(1) * q.unsqueeze(0)  # (4, 4, B)
    return c.eye3 + 2.0 * (c.quat_mat * qq.unsqueeze(0).unsqueeze(0)).sum(
        (2, 3))


# --------------------------------------------------------------------------
# the model's arrays on the device, cached per (model, dtype, device)


def _imp_rows(p, r):
    """``_imp_lane`` with per-row parameters (``_row_params``)."""
    x = torch.clamp(torch.abs(r) / p.width, 0.0, 1.0)
    y = torch.where(x < p.mid, p.a * x**p.power,
                    1.0 - p.b * (1.0 - x) ** p.power)
    return p.d0 + y * (p.dmax - p.d0)


def _row_params(solref, solimp, lane):
    """Per-row impedance and reference constants, each (n, 1) by ``lane``,
    made on the host in float64 as the JAX package makes them."""
    solimp = np.asarray(solimp, np.float64).reshape(-1, 5)
    d0, dmax, width, mid, power = solimp.T
    K, B = np.asarray([_kb_from_solref(sr, si) for sr, si in
                       zip(np.asarray(solref).reshape(-1, 2), solimp)]).T
    return types.SimpleNamespace(
        d0=lane(d0), dmax=lane(dmax), width=lane(np.maximum(width, 1e-15)),
        mid=lane(mid), power=lane(power),
        a=lane(1.0 / mid ** (power - 1.0)),
        b=lane(1.0 / (1.0 - mid) ** (power - 1.0)), K=lane(K), B=lane(B))


def _consts(m: PhysicsModel, dtype, device) -> types.SimpleNamespace:
    cache = m.__dict__.setdefault("_lane_consts_cache", {})
    key = (dtype, torch.device(device))
    if key not in cache:
        cache[key] = _build_consts(m, dtype, device)
    return cache[key]


def _build_consts(m: PhysicsModel, dtype, device) -> types.SimpleNamespace:
    st = _static(m)
    nb, nv = m.nbody, m.nv

    def f(x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype,
                               device=device)

    def lane(x):  # constant that broadcasts against the lane dim
        return f(x)[..., None]

    def idx(x):
        return torch.as_tensor(np.asarray(x, np.int64).reshape(-1),
                               device=device)

    c = types.SimpleNamespace()
    eye = np.eye(3)
    c.eye3 = lane(eye)

    # quaternion product and quaternion -> matrix as constant tensors
    T = np.zeros((4, 4, 4))
    for i, j, k, s in [
        (0, 0, 0, 1), (0, 1, 1, -1), (0, 2, 2, -1), (0, 3, 3, -1),
        (1, 0, 1, 1), (1, 1, 0, 1), (1, 2, 3, 1), (1, 3, 2, -1),
        (2, 0, 2, 1), (2, 1, 3, -1), (2, 2, 0, 1), (2, 3, 1, 1),
        (3, 0, 3, 1), (3, 1, 2, 1), (3, 2, 1, -1), (3, 3, 0, 1),
    ]:
        T[i, j, k] = s
    c.quat_mul = lane(T)
    Q = np.zeros((3, 3, 4, 4))  # R = 1 + 2 Q(q, q)  (w x y z = 0 1 2 3)
    for (i, j), terms in {
        (0, 0): [(2, 2, -1), (3, 3, -1)], (1, 1): [(1, 1, -1), (3, 3, -1)],
        (2, 2): [(1, 1, -1), (2, 2, -1)],
        (0, 1): [(1, 2, 1), (0, 3, -1)], (0, 2): [(1, 3, 1), (0, 2, 1)],
        (1, 0): [(1, 2, 1), (0, 3, 1)], (1, 2): [(2, 3, 1), (0, 1, -1)],
        (2, 0): [(1, 3, 1), (0, 2, -1)], (2, 1): [(2, 3, 1), (0, 1, 1)],
    }.items():
        for k, l, s in terms:
            Q[i, j, k, l] = s
    c.quat_mat = lane(Q)

    # ---- forward kinematics, one tree depth at a time ----
    # A free joint sets its body's frame; every other body composes its
    # parent's frame with its offset and then its joints in joint order
    # (none for a body welded to its parent). A level's jointed bodies
    # are ordered by joint count, most first, so that the k-th joint step
    # covers a leading block of the level.
    depth = [0] * nb
    for b in range(1, nb):
        depth[b] = depth[m.body_parentid[b]] + 1
    where_at = {0: 0}  # body -> row in its depth's stacked tensor
    order = [0]
    levels = []
    for d in range(1, max(depth) + 1):
        bodies = [b for b in range(1, nb) if depth[b] == d]
        free = [b for b in bodies if m.body_jntnum[b]
                and m.jnt_type[m.body_jntadr[b]] == JNT_FREE]
        rest = sorted((b for b in bodies if b not in free),
                      key=lambda b: -m.body_jntnum[b])
        rest_c = None
        if rest:
            steps = []
            for k in range(max(m.body_jntnum[b] for b in rest)):
                js = [m.body_jntadr[b] + k for b in rest
                      if m.body_jntnum[b] > k]
                K = np.stack([np.cross(np.eye(3), m.jnt_axis[j])
                              for j in js])  # [axis]x
                steps.append(types.SimpleNamespace(
                    n=len(js) if len(js) < len(rest) else None,
                    qadr=idx([m.jnt_qposadr[j] for j in js]),
                    qpos0=lane(np.asarray(m.qpos0)[[m.jnt_qposadr[j]
                                                    for j in js]]),
                    jpos=lane(np.asarray(m.jnt_pos)[js]),
                    K=lane(K), K2=lane(K @ K)))
            rest_c = types.SimpleNamespace(
                parent=idx([where_at[m.body_parentid[b]] for b in rest]),
                bpos=lane(np.asarray(m.body_pos)[rest]),
                bmat=lane(np.stack([_np_quat_mat(m.body_quat[b])
                                    for b in rest])),
                joints=steps)
        levels.append(types.SimpleNamespace(
            free_qadr=[m.jnt_qposadr[m.body_jntadr[b]] for b in free],
            rest=rest_c))
        for i, b in enumerate(free + rest):
            where_at[b] = i
        order += free + rest
    c.fk_levels = levels
    c.fk_to_body = idx(np.argsort(order))
    c.body_ipos = lane(m.body_ipos)
    c.body_imat = lane(np.stack([_np_quat_mat(q) for q in m.body_iquat]))
    c.body_mass = lane(np.asarray(m.body_mass)[:, None, None])
    c.body_inertia = lane(np.asarray(m.body_inertia)[:, None, :])
    levi = np.zeros((3, 3, 3))  # [c]x_ab = Σ_k ε_akb c_k
    for a, k, b_ in [(0, 1, 2), (1, 2, 0), (2, 0, 1)]:
        levi[a, k, b_], levi[a, b_, k] = 1.0, -1.0
    c.levi = lane(levi)

    # ---- motion subspace ----
    free_j = [j for j in range(m.njnt) if m.jnt_type[j] == JNT_FREE]
    hinge_j = [j for j in range(m.njnt) if m.jnt_type[j] != JNT_FREE]
    c.free_j = [(m.jnt_bodyid[j], m.jnt_dofadr[j], m.jnt_qposadr[j])
                for j in free_j]
    c.hinge_body = idx([m.jnt_bodyid[j] for j in hinge_j])
    c.hinge_pos = lane(np.asarray(m.jnt_pos)[hinge_j].reshape(-1, 3))
    c.hinge_axis = lane(np.asarray(m.jnt_axis)[hinge_j].reshape(-1, 3))
    c.hinge_qadr = idx([m.jnt_qposadr[j] for j in hinge_j])
    c.hinge_dadr = idx([m.jnt_dofadr[j] for j in hinge_j])
    row_dof = []
    for j in free_j:
        row_dof += list(range(m.jnt_dofadr[j], m.jnt_dofadr[j] + 6))
    row_dof += [m.jnt_dofadr[j] for j in hinge_j]
    # the rows come free joints first; put them in dof order where a free
    # joint's dofs follow a hinge's
    c.subspace_order = (None if row_dof == list(range(nv))
                        else idx(np.argsort(row_dof)))
    c.free_lin_rows = lane(np.concatenate([np.zeros((3, 3)), np.eye(3)], 1))

    # ---- tree masks ----
    anc = np.zeros((nb, nb))  # anc[b, x]: x is b or an ancestor (x >= 1)
    for b in range(nb):
        x = b
        while x != 0:
            anc[b, x] = 1.0
            x = m.body_parentid[x]
    c.anc_bb = f(anc)
    c.sub_bb = f(anc.T)  # sub[b, x]: x in the subtree of b
    bd = np.zeros((nb, nv))
    for b in range(nb):
        bd[b, list(st.body_dofs[b])] = 1.0
    c.anc_bd = f(bd)
    c.dof_body = idx(st.dof_body)
    c.body_parent = idx(m.body_parentid)
    lower = np.eye(nv, dtype=bool)
    for i in range(nv):
        lower[i, list(st.dof_chain[i])] = True
    c.m_lower = torch.as_tensor(lower[:, :, None], device=device)
    c.m_upper = torch.as_tensor(lower.T[:, :, None], device=device)
    c.armature = lane(np.diag(np.asarray(m.dof_armature, np.float64)))
    c.damping = lane(m.dof_damping)
    c.chain = [idx(st.dof_chain[k]) if st.dof_chain[k] else None
               for k in range(nv)]
    c.chain_pairs = [
        idx((np.asarray(ch)[:, None] * nv + np.asarray(ch)[None, :]))
        if ch else None for ch in st.dof_chain]
    c.gravity_acc = lane(np.concatenate([np.zeros(3),
                                         -np.asarray(m.gravity)]))

    # ---- actuation ----
    nu = m.nu
    qadr = [m.jnt_qposadr[m.actuator_trnid[u]] for u in range(nu)]
    dadr = [m.jnt_dofadr[m.actuator_trnid[u]] for u in range(nu)]
    gear = np.asarray(m.actuator_gear, np.float64).reshape(nu)
    gp = np.asarray(m.actuator_gainprm, np.float64).reshape(nu, -1)
    bp = np.asarray(m.actuator_biasprm, np.float64).reshape(nu, -1)
    c.act_qadr, c.act_dadr = idx(qadr), idx(dadr)
    c.act_gain = lane(gp[:, 0])
    c.act_bias0 = lane(bp[:, 0])
    c.act_bias1 = lane(bp[:, 1] * gear)
    c.act_bias2 = lane(bp[:, 2] * gear)
    fr = np.asarray(m.actuator_forcerange, np.float64).reshape(nu, 2)
    c.force_lo, c.force_hi = lane(fr[:, 0]), lane(fr[:, 1])
    c.act_dvel = lane(gear * gear * bp[:, 2])
    sel = np.zeros((nv, nu))
    sel[dadr, np.arange(nu)] = 1.0
    c.act_to_dof = f(sel)
    c.act_gear = lane(gear)
    cr = np.asarray(m.actuator_ctrlrange, np.float64).reshape(nu, 2)
    c.ctrl_lo, c.ctrl_hi = lane(cr[:, 0]), lane(cr[:, 1])
    tau = np.maximum(np.asarray(m.actuator_dynprm, np.float64)
                     .reshape(nu, -1)[:m.na, 0], 1e-12)
    c.act_coef = lane([1.0 - float(np.exp(-m.timestep / t)) for t in tau])

    # ---- joint limits ----
    lim = [j for j in range(m.njnt) if m.jnt_limited[j]]
    c.nlim = len(lim)
    if lim:
        lim_dadr = [m.jnt_dofadr[j] for j in lim]
        c.lim_qadr = idx([m.jnt_qposadr[j] for j in lim])
        c.lim_dadr = idx(lim_dadr)
        rng_ = np.asarray([m.jnt_range[j] for j in lim], np.float64)
        c.lim_lo, c.lim_hi = lane(rng_[:, 0]), lane(rng_[:, 1])
        c.lim_margin = lane([m.jnt_margin[j] for j in lim])
        c.lim_imp = _row_params([m.jnt_solref[j] for j in lim],
                                [m.jnt_solimp[j] for j in lim], lane)
        c.lim_invweight = lane(np.asarray(m.dof_invweight0)[lim_dadr])
        c.lim_onehot = lane(np.eye(nv)[lim_dadr])

    # ---- collision: every geom at once, hulls padded to the largest ----
    G = len(m.col_geom_bodyid)
    V = max(len(v) for v in m.col_hull_verts)
    verts = np.zeros((G, V, 3))
    pad = np.full((G, V), np.inf)
    for k, v in enumerate(m.col_hull_verts):
        verts[k, :len(v)] = v
        pad[k, :len(v)] = 0.0
    c.geom_body = idx(m.col_geom_bodyid)
    c.geom_pos = lane(m.col_geom_pos)
    c.geom_mat = lane(np.stack([_np_quat_mat(q) for q in m.col_geom_quat]))
    c.vx, c.vy, c.vz = (lane(verts[:, :, i]) for i in range(3))
    c.vn2 = lane(np.sum(verts**2, axis=2))
    c.vpad = lane(pad)
    c.verts_flat = f(verts.reshape(G * V, 3))
    c.vert_off = idx(np.arange(G) * V)[:, None]
    margin = np.asarray(m.col_margin, np.float64)
    c.col_margin = lane(margin)
    c.col_margin2 = lane(2.0 * margin)[:, None]
    c.col_theta2 = lane(m.col_theta2)
    c.col_theta3 = lane(m.col_theta3)
    inc = margin - np.asarray(m.col_gap, np.float64)
    c.col_inc = lane(inc)
    n, t1, t2 = (np.asarray(x) for x in st.plane_frame)
    c.plane_n = lane(n)
    c.plane_half_n = lane(0.5 * n)
    c.plane_off = st.plane_off
    c.frame = f(np.stack([n, t1, t2]))[None, :, None, :, None]
    # per contact slot (3 per geom, geom-major)
    sbody = np.repeat(np.asarray(m.col_geom_bodyid), 3)
    mu = np.repeat(np.asarray(m.col_friction, np.float64)[:, 0], 3)
    c.slot_margin = lane(np.repeat(inc, 3))
    c.slot_imp = _row_params(np.repeat(np.asarray(m.col_solref), 3, 0),
                             np.repeat(np.asarray(m.col_solimp), 3, 0), lane)
    c.slot_diag = lane(2.0 * np.asarray(m.body_invweight0)[sbody, 0]
                       * (1.0 + mu * mu))
    c.slot_dofs = f(bd[sbody])[:, None, :, None]
    c.facet_mu = f(np.stack([mu, -mu, mu, -mu], 1))[:, :, None, None]
    c.facet_tangent = idx([1, 1, 2, 2])

    # ---- sensors: every reading as a row of one stacked table ----
    c.site_body = m.site_bodyid
    c.site_pos = lane(m.site_pos)
    c.site_mat = lane(_np_quat_mat(m.site_quat))
    kinds = {SENSOR_ACCELEROMETER: 0, SENSOR_GYRO: 1, SENSOR_FRAMEPOS: 2,
             SENSOR_FRAMELINVEL: 3, SENSOR_FRAMEXAXIS: 4,
             SENSOR_FRAMEZAXIS: 5, SENSOR_VELOCIMETER: 6}
    jp = [s for s in m.sensors if s.kind == SENSOR_JOINTPOS]
    c.sens_qadr = idx([m.jnt_qposadr[s.objid] for s in jp])
    src = np.zeros(m.nsensordata, np.int64)  # row of [jointpos; 7 x 3]
    for i, s in enumerate(jp):
        src[s.adr] = i
    for s in m.sensors:
        if s.kind == SENSOR_JOINTPOS:
            continue
        if s.kind not in kinds:
            raise NotImplementedError(f"sensor kind {s.kind}")
        src[s.adr:s.adr + 3] = len(jp) + 3 * kinds[s.kind] + np.arange(3)
    c.sens_rows = idx(src)
    return c


# --------------------------------------------------------------------------
# forward kinematics + motion subspace


class _Kin(NamedTuple):
    xpos: torch.Tensor  # (nbody, 3, B)
    xmat: torch.Tensor  # (nbody, 3, 3, B)
    xipos: torch.Tensor  # (nbody, 3, B)
    ximat: torch.Tensor  # (nbody, 3, 3, B)
    origin: torch.Tensor  # (3, B)


def _fk(m: PhysicsModel, q) -> _Kin:
    """Body frames from qpos (mj_kinematics: a hinge rotates its body about
    the joint anchor by ``qpos - qpos0``, a body's hinges one after the
    other in joint order; a free joint sets the frame).
    The JAX package composes quaternions; this composes rotation matrices,
    R_axis(θ) = 1 + sin θ [a]x + (1 - cos θ) [a]x², the same rotation."""
    c = _consts(m, q.dtype, q.device)
    B = q.shape[-1]
    pos = [q.new_zeros((1, 3, B))]
    mat = [c.eye3.expand(3, 3, B)[None]]
    for lv in c.fk_levels:
        pos_l, mat_l = [], []
        for qa in lv.free_qadr:
            pos_l.append(q[qa:qa + 3][None])
            mat_l.append(_quat_to_mat(
                c, _quat_normalize(q[qa + 3:qa + 7]))[None])
        g = lv.rest
        if g is not None:
            rp = mat[-1].index_select(0, g.parent)
            p = pos[-1].index_select(0, g.parent) + _mv(rp, g.bpos)
            r = _mm(rp, g.bmat)
            for j in g.joints:
                pj, rj = (p, r) if j.n is None else (p[:j.n], r[:j.n])
                angle = q.index_select(0, j.qadr) - j.qpos0
                anchor = pj + _mv(rj, j.jpos)
                s = torch.sin(angle)[:, None, None]
                omc = (1.0 - torch.cos(angle))[:, None, None]
                rj = _mm(rj, c.eye3 + s * j.K + omc * j.K2)
                pj = anchor - _mv(rj, j.jpos)
                if j.n is None:
                    p, r = pj, rj
                else:
                    p, r = torch.cat([pj, p[j.n:]]), torch.cat([rj, r[j.n:]])
            pos_l.append(p)
            mat_l.append(r)
        pos.append(torch.cat(pos_l) if len(pos_l) > 1 else pos_l[0])
        mat.append(torch.cat(mat_l) if len(mat_l) > 1 else mat_l[0])
    xpos = torch.cat(pos).index_select(0, c.fk_to_body)
    xmat = torch.cat(mat).index_select(0, c.fk_to_body)
    return _Kin(
        xpos=xpos,
        xmat=xmat,
        xipos=xpos + _mv(xmat, c.body_ipos),
        ximat=_mm(xmat, c.body_imat),
        origin=xpos[_static(m).root],
    )


def _subspace(m: PhysicsModel, kin: _Kin):
    """Per-dof spatial motion vectors [angular; linear-at-origin]:
    (nv, 6, B)."""
    c = _consts(m, kin.xpos.dtype, kin.xpos.device)
    B = kin.xpos.shape[-1]
    rows = []
    for b, _, _ in c.free_j:
        rows.append(c.free_lin_rows.expand(3, 6, B))
        axes = kin.xmat[b].transpose(0, 1)  # (3 columns, 3, B)
        p = (kin.xpos[b] - kin.origin)[None]
        rows.append(torch.cat([axes, _cross(p, axes)], 1))
    if len(c.hinge_body):
        r = kin.xmat.index_select(0, c.hinge_body)
        anchor = (kin.xpos.index_select(0, c.hinge_body) + _mv(r, c.hinge_pos)
                  - kin.origin)
        axis = _mv(r, c.hinge_axis)
        rows.append(torch.cat([axis, _cross(anchor, axis)], 1))
    S = torch.cat(rows) if len(rows) > 1 else rows[0]
    if c.subspace_order is not None:
        S = S.index_select(0, c.subspace_order)
    return S


def _body_velocities(m: PhysicsModel, S, qv):
    """Spatial velocity of every body: (nbody, 6, B)."""
    c = _consts(m, S.dtype, S.device)
    return _tree_sum(c.anc_bd, qv[:, None] * S)


def _spatial_inertias(m: PhysicsModel, kin: _Kin):
    """(nbody, 6, 6, B) spatial inertia of every body at ``kin.origin``
    (the massless world's is zero):
    top-left R diag(I) Rᵀ + m (|c|² 1 - c cᵀ), top-right m [c]x,
    bottom-left m [c]xᵀ, bottom-right m 1."""
    c = _consts(m, kin.xpos.dtype, kin.xpos.device)
    com = kin.xipos - kin.origin  # (nbody, 3, B)
    R = kin.ximat
    ic = _mm(R * c.body_inertia, R.transpose(1, 2))
    outer = com.unsqueeze(2) * com.unsqueeze(1)
    tl = ic + c.body_mass * (_dot(com, com)[:, None, None] * c.eye3 - outer)
    mcx = c.body_mass * (c.levi * com[:, None, :, None]).sum(2)  # m [c]x
    top = torch.cat([tl, mcx], 2)
    bot = torch.cat([mcx.transpose(1, 2), c.body_mass * c.eye3.expand_as(tl)],
                    2)
    return torch.cat([top, bot], 1)


def _crba(m: PhysicsModel, kin: _Kin, S, Ibody):
    """Mass matrix (nv, nv, B): M[i, j] = S_j · Ic_{body(i)} S_i for j an
    ancestor-or-self of i, symmetric, zero off the tree pattern, armature
    on the diagonal."""
    c = _consts(m, S.dtype, S.device)
    Ic = _tree_sum(c.sub_bb, Ibody)  # composite inertias
    F = _inertia_vec(Ic.index_select(0, c.dof_body), S)  # (nv, 6, B)
    Mf = (S.unsqueeze(1) * F.unsqueeze(0)).sum(2)  # Mf[j, i] = S_j · F_i
    M = torch.where(c.m_lower, Mf.transpose(0, 1),
                    torch.where(c.m_upper, Mf, 0.0))
    return M + c.armature


def _joint_bias_vel(m: PhysicsModel, qv, cvel):
    """Per body the part of v_b - v_parent whose subspace rotates with the
    body (a free joint's world-fixed translational axes excluded)."""
    c = _consts(m, qv.dtype, qv.device)
    vJ = cvel - cvel.index_select(0, c.body_parent)
    for b, da, _ in c.free_j:
        vJ[b, 3:] -= qv[da:da + 3]
    return vJ


def _rne_bias(m: PhysicsModel, kin: _Kin, S, cvel, qv, Ibody):
    """Bias force C(q, v) v + gravity (mjData.qfrc_bias): (nv, B)."""
    c = _consts(m, S.dtype, S.device)
    vprod = _motion_cross(cvel, _joint_bias_vel(m, qv, cvel))
    acc = c.gravity_acc + _tree_sum(c.anc_bb, vprod)
    f = _inertia_vec(Ibody, acc) + _force_cross(cvel,
                                                _inertia_vec(Ibody, cvel))
    fsub = _tree_sum(c.sub_bb, f)
    return _dot(S, fsub.index_select(0, c.dof_body))


def _body_accelerations(m: PhysicsModel, S, cvel, qv, qacc):
    """Proper spatial accelerations (the base 'accelerates' at -g):
    (nbody, 6, B)."""
    c = _consts(m, S.dtype, S.device)
    vprod = _motion_cross(cvel, _joint_bias_vel(m, qv, cvel))
    return (c.gravity_acc + _tree_sum(c.anc_bd, qacc[:, None] * S)
            + _tree_sum(c.anc_bb, vprod))


# --------------------------------------------------------------------------
# actuation


def _actuation(m: PhysicsModel, q, qv, act):
    """Position servos: (qfrc (nv, B), d qfrc / d qvel (nv, B))."""
    c = _consts(m, q.dtype, q.device)
    force = c.act_gain * act + (
        c.act_bias0 + (c.act_bias1 * q.index_select(0, c.act_qadr)
                       + c.act_bias2 * qv.index_select(0, c.act_dadr)))
    clamped = torch.clamp(force, c.force_lo, c.force_hi)
    qfrc = c.act_to_dof @ (c.act_gear * clamped)
    in_range = (force > c.force_lo) & (force < c.force_hi)
    dvel = c.act_to_dof @ torch.where(in_range, c.act_dvel, 0.0)
    return qfrc, dvel


# --------------------------------------------------------------------------
# tree-sparse LDLᵀ:  A = LᵀDL  with L unit-lower on the ancestor pattern


class _LDL(NamedTuple):
    rows: tuple  # per dof k: L[k, chain(k)] as (len(chain), B), or None
    dinv: torch.Tensor  # (nv, B)


def _ldl_factor(m: PhysicsModel, A):
    """Factor a tree-sparse SPD (nv, nv, B) matrix (not modified)."""
    c = _consts(m, A.dtype, A.device)
    nv = m.nv
    H = A.clone(memory_format=torch.contiguous_format).view(nv * nv, -1)
    rows, dinv = [None] * nv, [None] * nv
    for k in range(nv - 1, -1, -1):
        d = 1.0 / H[k * nv + k]
        dinv[k] = d
        ch = c.chain[k]
        if ch is None:
            continue
        hk = H[k * nv:(k + 1) * nv].index_select(0, ch)
        a = hk * d
        # H[i, j] -= a_i H[k, j] over the ancestor block (row k is final)
        H.index_add_(0, c.chain_pairs[k],
                     (a[:, None] * hk[None]).reshape(-1, H.shape[-1]),
                     alpha=-1)
        rows[k] = a
    return _LDL(rows=tuple(rows), dinv=torch.stack(dinv))


def _ldl_solve(m: PhysicsModel, fac: _LDL, b):
    """Solve (LᵀDL) x = b for (nv, B) b."""
    c = _consts(m, b.dtype, b.device)
    w = b.clone()
    for k in range(m.nv - 1, -1, -1):
        if fac.rows[k] is not None:
            w.index_add_(0, c.chain[k], fac.rows[k] * w[k], alpha=-1)
    x = w * fac.dinv
    for k in range(m.nv):
        if fac.rows[k] is not None:
            x[k] -= (fac.rows[k] * x.index_select(0, c.chain[k])).sum(0)
    return x


def _sym_matvec(m: PhysicsModel, A, x):
    """y = A x for the (nv, nv, B) symmetric matrix."""
    return (A * x[None]).sum(1)


# --------------------------------------------------------------------------
# collision + constraint rows


class _Rows(NamedTuple):
    """Constraint rows, batch minor: nrow = nlim + 4 * nslot."""

    J: torch.Tensor  # (nrow, nv, B) row Jacobians (facets of the pyramid)
    aref: torch.Tensor  # (nrow, B)
    D: torch.Tensor  # (nrow, B)


class _Slots(NamedTuple):
    """Contact slots, 3 per geom (geom-major)."""

    pos: torch.Tensor  # (nslot, 3, B)
    dist: torch.Tensor  # (nslot, B)
    active: torch.Tensor  # (nslot, B) bool


def _collide(m: PhysicsModel, kin: _Kin) -> _Slots:
    """Plane contacts of every geom (3 slots each), all geoms at once.

    Same behavioural contract as ``physics.collision.collide``: the support
    vertex exactly, the extra points by the calibrated farthest-point
    rules."""
    c = _consts(m, kin.xpos.dtype, kin.xpos.device)
    xmat = kin.xmat.index_select(0, c.geom_body)
    gpos = kin.xpos.index_select(0, c.geom_body) + _mv(xmat, c.geom_pos)
    gmat = _mm(xmat, c.geom_mat)  # (G, 3, 3, B)
    n = c.plane_n

    # a = gmatᵀ n; h = verts @ a + (gpos.n - off), +inf on padding
    a = _mtv(gmat, n)[:, :, None]  # (G, 3, 1, B)
    base = (_dot(gpos, n) - c.plane_off)[:, None]
    h = c.vx * a[:, 0] + c.vy * a[:, 1] + c.vz * a[:, 2] + base + c.vpad

    def vert_at(i):  # local vertex per (geom, lane): (G, 3, B)
        return c.verts_flat[i + c.vert_off].permute(0, 2, 1)

    def pick(x, i):
        return torch.gather(x, 1, i[:, None])[:, 0]

    i0 = torch.argmin(h, 1)
    h0 = pick(h, i0)
    v0 = vert_at(i0)
    a0 = h0 < c.col_margin

    cand = h < c.col_margin2
    # |u_plan|^2 = |v - v0|^2 - (h - h0)^2
    vdot0 = c.vx * v0[:, 0:1] + c.vy * v0[:, 1:2] + c.vz * v0[:, 2:3]
    dv2 = c.vn2 - 2.0 * vdot0 + _dot(v0, v0)[:, None]
    dplan = torch.sqrt(torch.clamp_min(dv2 - (h - h0[:, None]) ** 2, 0.0))
    dmask = torch.where(cand, dplan, -1.0)
    i1 = torch.argmax(dmask, 1)
    d1 = pick(dmask, i1)
    a1 = a0 & (d1 >= c.col_theta2)
    v1 = vert_at(i1)
    h1 = pick(h, i1)

    u1 = _mv(gmat, v1 - v0)
    inv_d1 = 1.0 / torch.clamp_min(d1, 1e-12)
    t = (u1 - n * (h1 - h0)[:, None]) * inv_d1[:, None]
    g = _mtv(gmat, _cross(n, t))[:, :, None]  # (G, 3, 1, B)
    cdot = c.vx * g[:, 0] + c.vy * g[:, 1] + c.vz * g[:, 2]
    cmask = torch.where(cand, torch.abs(cdot - _dot(v0, g[:, :, 0])[:, None]),
                        -1.0)
    i2 = torch.argmax(cmask, 1)
    a2 = a1 & (pick(cmask, i2) >= c.col_theta3)
    v2 = vert_at(i2)
    h2 = pick(h, i2)

    V = torch.stack([v0, v1, v2], 1)  # (G, 3 slots, 3, B)
    hs = torch.stack([h0, h1, h2], 1)  # (G, 3, B)
    p = gpos[:, None] + _mv(gmat[:, None], V)
    pos = p - c.plane_half_n * hs[:, :, None]
    active = torch.stack([a0, a1, a2], 1) & (hs < c.col_inc[:, None])
    B = hs.shape[-1]
    return _Slots(pos=pos.reshape(-1, 3, B), dist=hs.reshape(-1, B),
                  active=active.reshape(-1, B))


def _make_rows(m: PhysicsModel, kin: _Kin, S, q, qv, slots: _Slots) -> _Rows:
    c = _consts(m, q.dtype, q.device)
    B = q.shape[-1]
    J_rows, aref_rows, D_rows = [], [], []

    # ---- joint limits ----
    if c.nlim:
        ql = q.index_select(0, c.lim_qadr)
        d_lo = ql - c.lim_lo
        d_hi = c.lim_hi - ql
        lower = d_lo <= d_hi
        dist = torch.where(lower, d_lo, d_hi)
        sign = torch.where(lower, 1.0, -1.0).to(dist.dtype)
        active = dist < c.lim_margin
        r = dist - c.lim_margin
        imp = _imp_rows(c.lim_imp, r)
        vel = sign * qv.index_select(0, c.lim_dadr)
        aref_rows.append(-c.lim_imp.B * vel - c.lim_imp.K * imp * r)
        R = torch.clamp_min((1.0 - imp) / imp * c.lim_invweight, 1e-15)
        D_rows.append(torch.where(active, 1.0 / R, 0.0))
        J_rows.append(sign[:, None] * c.lim_onehot)

    # ---- contact slots -> pyramidal facet rows ----
    rel = slots.pos - kin.origin  # (nslot, 3, B)
    # w = S_ang x rel + S_lin for every (slot, dof): (nslot, nv, 3, B)
    w = _cross(S[None, :, :3], rel[:, None]) + S[None, :, 3:]
    # [Jn; Jt1; Jt2] (nslot, 3, nv, B), zero outside the slot's dofs
    J = (w[:, None] * c.frame).sum(3) * c.slot_dofs
    r = slots.dist - c.slot_margin
    imp = _imp_rows(c.slot_imp, r)
    R = torch.clamp_min((1.0 - imp) / imp * c.slot_diag, 1e-15)
    Dslot = torch.where(slots.active, 1.0 / R, 0.0)
    # facets: Jn + mu Jt1, Jn - mu Jt1, Jn + mu Jt2, Jn - mu Jt2
    Jf = J[:, :1] + c.facet_mu * J.index_select(1, c.facet_tangent)
    vel = (Jf * qv).sum(2)  # (nslot, 4, B)
    aref = -c.slot_imp.B[:, None] * vel - (c.slot_imp.K * imp * r)[:, None]
    aref_rows.append(aref.reshape(-1, B))
    D_rows.append(Dslot[:, None].expand(-1, 4, -1).reshape(-1, B))
    J_rows.append(Jf.reshape(-1, m.nv, B))
    return _Rows(J=torch.cat(J_rows), aref=torch.cat(aref_rows),
                 D=torch.cat(D_rows))


def _rows_matvec(m: PhysicsModel, rows: _Rows, x):
    """J x: (nrow, B) from (nv, B)."""
    return (rows.J * x).sum(1)


def _rows_tmatvec(m: PhysicsModel, rows: _Rows, y):
    """Jᵀ y: (nv, B) from (nrow, B)."""
    return (rows.J * y[:, None]).sum(0)


def _add_jwj(m: PhysicsModel, M, rows: _Rows, w):
    """H = M + Jᵀ diag(w) J: one contraction over the rows (every row's
    Jacobian is zero outside its ancestor dofs, so H keeps M's tree
    pattern)."""
    return M + torch.einsum("rib,rjb->ijb", rows.J, w[:, None] * rows.J)


# --------------------------------------------------------------------------
# the step


def _forward_core(m: PhysicsModel, q, qv, act):
    c = _consts(m, q.dtype, q.device)
    kin = _fk(m, q)
    S = _subspace(m, kin)
    cvel = _body_velocities(m, S, qv)
    Ibody = _spatial_inertias(m, kin)
    M = _crba(m, kin, S, Ibody)
    bias = _rne_bias(m, kin, S, cvel, qv, Ibody)
    qfrc_act, dvel = _actuation(m, q, qv, act)
    qfrc_smooth = qfrc_act - c.damping * qv - bias
    return kin, S, cvel, M, qfrc_smooth, dvel


def _newton_solve(m, M, rows: _Rows, qacc_smooth, iterations, ls_iterations):
    """Fixed-iteration primal Newton (same objective as physics.solver),
    with the 1-D Newton line search clipped to [0, 4]. Returns qacc."""
    x = qacc_smooth
    Dpos = rows.D > 0.0
    for _ in range(iterations):
        jar = _rows_matvec(m, rows, x) - rows.aref  # (nrow, B)
        w = torch.where((jar < 0.0) & Dpos, rows.D, 0.0)
        g_smooth = _sym_matvec(m, M, x - qacc_smooth)
        g = g_smooth + _rows_tmatvec(m, rows, w * jar)
        dx = _ldl_solve(m, _ldl_factor(m, _add_jwj(m, M, rows, w)), -g)

        Jdx = _rows_matvec(m, rows, dx)
        g0 = (dx * g_smooth).sum(0)
        h0 = (dx * _sym_matvec(m, M, dx)).sum(0)
        t = torch.ones_like(g0)
        for _ in range(ls_iterations):
            jar_t = jar + t * Jdx
            wJ = torch.where((jar_t < 0.0) & Dpos, rows.D, 0.0) * Jdx
            dphi = g0 + t * h0 + (wJ * jar_t).sum(0)
            ddphi = h0 + (wJ * Jdx).sum(0)
            t = torch.clamp(t - dphi / torch.clamp_min(ddphi, 1e-30), 0.0, 4.0)
        x = x + t * dx
    return x


def _sensors(m: PhysicsModel, kin: _Kin, cvel, cacc, q):
    c = _consts(m, q.dtype, q.device)
    b = c.site_body
    spos = kin.xpos[b] + _mv(kin.xmat[b], c.site_pos)
    smat = _mm(kin.xmat[b], c.site_mat)
    w, v0 = cvel[b, :3], cvel[b, 3:]
    p = spos - kin.origin
    v_site = v0 + _cross(w, p)
    alpha, a0 = cacc[b, :3], cacc[b, 3:]
    a_site = a0 + (_cross(alpha, p) + _cross(w, v_site))
    table = torch.cat([
        q.index_select(0, c.sens_qadr),
        _mtv(smat, a_site),  # accelerometer
        _mtv(smat, w),  # gyro
        spos,  # framepos
        v_site,  # framelinvel
        smat[:, 0],  # framexaxis
        smat[:, 2],  # framezaxis
        _mtv(smat, v_site),  # velocimeter
    ])
    return table.index_select(0, c.sens_rows)


def _step_impl(
    m: PhysicsModel,
    ls: LaneState,
    ctrl: torch.Tensor,
    solver_iterations: int = 4,
    ls_iterations: int = 8,
    compute_sensors: bool = True,
) -> LaneState:
    """One physics step on arbitrarily-shaped lane scalars (the lane dims
    are flattened into one and restored on the way out).

    ``compute_sensors=False`` carries the previous sensordata through —
    exact for frame-skipped control steps, where only the LAST substep's
    reading is ever observed; saves the acceleration recursion and the
    sensor assembly per substep.
    """
    lanes = ls.time.shape
    nl = ls.time.numel()
    ls = LaneState(*(x.reshape(x.shape[0], nl) for x in
                     (ls.qpos, ls.qvel, ls.act)), ls.time.reshape(nl),
                   ls.sensordata.reshape(ls.sensordata.shape[0], nl))
    ctrl = ctrl.reshape(ctrl.shape[0], nl)
    c = _consts(m, ls.qpos.dtype, ls.qpos.device)
    h = m.timestep
    q, qv, act = ls.qpos, ls.qvel, ls.act
    ctrl_l = torch.clamp(ctrl, c.ctrl_lo, c.ctrl_hi)

    kin, S, cvel, M, qfrc_smooth, dvel = _forward_core(m, q, qv, act)
    qacc_smooth = _ldl_solve(m, _ldl_factor(m, M), qfrc_smooth)

    if solver_iterations > 0:
        rows = _make_rows(m, kin, S, q, qv, _collide(m, kin))
        qacc = _newton_solve(m, M, rows, qacc_smooth, solver_iterations,
                             ls_iterations)
    else:
        qacc = qacc_smooth

    # sensors at the pre-integration state (mj_step ordering)
    if compute_sensors:
        cacc = _body_accelerations(m, S, cvel, qv, qacc)
        sens = _sensors(m, kin, cvel, cacc, q)
    else:
        sens = ls.sensordata

    # implicitfast velocity update: (M - h diag(D)) dv = h M qacc
    Mhat = M.clone()
    Mhat.diagonal(0, 0, 1).sub_((h * (dvel - c.damping)).T)
    dv = _ldl_solve(m, _ldl_factor(m, Mhat), h * _sym_matvec(m, M, qacc))
    qv_new = qv + dv

    # activation exact filter
    act_new = act + (ctrl_l[:m.na] - act) * c.act_coef

    # integrate positions with the new velocity
    q_new = q.clone()
    q_new.index_copy_(0, c.hinge_qadr, q.index_select(0, c.hinge_qadr)
                      + h * qv_new.index_select(0, c.hinge_dadr))
    for _, da, qa in c.free_j:
        q_new[qa:qa + 3] = q[qa:qa + 3] + h * qv_new[da:da + 3]
        q_new[qa + 3:qa + 7] = _quat_integrate(c, q[qa + 3:qa + 7],
                                               qv_new[da + 3:da + 6], h)

    def back(x):
        return x.reshape(x.shape[:1] + lanes)

    return LaneState(qpos=back(q_new), qvel=back(qv_new), act=back(act_new),
                     time=(ls.time + h).reshape(lanes), sensordata=back(sens))


def _quat_integrate(c, q, omega, h):
    """Exact exponential-map integration (mju_quatIntegrate)."""
    angle = torch.sqrt(torch.clamp_min((omega * omega).sum(0), 1e-30))
    axis = omega * (1.0 / torch.clamp_min(angle, 1e-30))
    half = angle * h * 0.5
    dq = torch.cat([torch.cos(half)[None], axis * torch.sin(half)])
    return _quat_normalize(_quat_mul(c, q, dq))


LANE_TILE = 128


def _tile(x: torch.Tensor) -> torch.Tensor:
    """(dims..., B) -> (dims..., B/128, 128), the JAX package's TPU tile
    layout; a view here, the engine flattens the lane dims again."""
    B = x.shape[-1]
    if B % LANE_TILE:
        return x  # odd batch: fall back to the flat layout
    return x.reshape(x.shape[:-1] + (B // LANE_TILE, LANE_TILE))


def _untile(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[:-2] + (x.shape[-2] * x.shape[-1],))


def _tile_state(ls: LaneState) -> LaneState:
    return LaneState(*(_tile(x) for x in ls))


def _untile_state(ls: LaneState) -> LaneState:
    return LaneState(*(_untile(x) for x in ls))


def step(
    m: PhysicsModel,
    ls: LaneState,
    ctrl: torch.Tensor,  # (nu, B)
    solver_iterations: int = 4,
    ls_iterations: int = 8,
    tile: bool = False,
) -> LaneState:
    """One physics step (mj_step semantics, implicitfast integrator).

    ``tile`` folds the batch into (B/128, 128) minor dims as the JAX
    package does for the TPU; the numbers are the flat layout's."""
    with true_fp32():
        if tile and ls.qpos.shape[-1] % LANE_TILE == 0:
            out = _step_impl(m, _tile_state(ls), _tile(ctrl),
                             solver_iterations, ls_iterations)
            return _untile_state(out)
        return _step_impl(m, ls, ctrl, solver_iterations, ls_iterations)


def control_step(
    m: PhysicsModel,
    ls: LaneState,
    ctrl: torch.Tensor,  # (nu, B)
    frame_skip: int,
    solver_iterations: int = 4,
    ls_iterations: int = 8,
    tile: bool = False,
) -> LaneState:
    """frame_skip physics substeps under constant control (sensors from
    the last)."""
    tiled = tile and ls.qpos.shape[-1] % LANE_TILE == 0
    if tiled:
        ls = _tile_state(ls)
        ctrl = _tile(ctrl)
    with true_fp32():
        for _ in range(frame_skip - 1):
            ls = _step_impl(m, ls, ctrl, solver_iterations, ls_iterations,
                            compute_sensors=False)
        out = _step_impl(m, ls, ctrl, solver_iterations, ls_iterations)
    return _untile_state(out) if tiled else out
