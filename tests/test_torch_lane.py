"""The port's lane algebra (``ops/lane.py``) against the JAX package's on
random float64 lane inputs, static folding included."""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_gym_tpu.ops import lane as JL
from quadruped_gym_tpu_torch.ops import lane as TL

B = 7


def _rand(rng, *shape):
    return rng.standard_normal(shape + (B,))


def _to(x, lib):
    """Nested tuples of numpy lanes -> the same nesting in jnp / torch;
    Python floats (static constants) pass through."""
    if isinstance(x, tuple):
        return tuple(_to(v, lib) for v in x)
    if isinstance(x, float):
        return x
    return jnp.asarray(x) if lib == "jax" else torch.as_tensor(x)


def _np(x):
    if isinstance(x, tuple):
        return tuple(_np(v) for v in x)
    if isinstance(x, float):
        return x
    return np.asarray(x) if not isinstance(x, torch.Tensor) else x.numpy()


def _assert_same(a, b):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
        return
    assert isinstance(a, float) == isinstance(b, float), "static folding"
    np.testing.assert_allclose(b, a, rtol=1e-14, atol=1e-15)


def _vec(rng, n):
    return tuple(_rand(rng) for _ in range(n))


def _quat(rng):
    q = _rand(rng, 4)
    return tuple(q / np.linalg.norm(q, axis=0))


def _mat(rng):
    return tuple(tuple(_rand(rng) for _ in range(3)) for _ in range(3))


CASES = {
    "v3_add": lambda r: (_vec(r, 3), _vec(r, 3)),
    "v3_sub": lambda r: (_vec(r, 3), (0.0, 1.5, _rand(r))),
    "v3_scale": lambda r: (_rand(r), (0.0, 1.0, _rand(r))),
    "v3_dot": lambda r: (_vec(r, 3), (1.0, 0.0, _rand(r))),
    "v3_cross": lambda r: (_vec(r, 3), _vec(r, 3)),
    "v3_norm": lambda r: (_vec(r, 3),),
    "quat_mul": lambda r: (_quat(r), (1.0, 0.0, 0.0, 0.0)),
    "quat_normalize": lambda r: (tuple(_rand(r, 4)),),
    "quat_rotate": lambda r: (_quat(r), _vec(r, 3)),
    "quat_to_mat": lambda r: (_quat(r),),
    "axis_angle_to_quat": lambda r: ((0.0, 0.0, 1.0), _rand(r)),
    "quat_integrate": lambda r: (_quat(r), _vec(r, 3), 0.002),
    "mat_vec": lambda r: (_mat(r), _vec(r, 3)),
    "mat_tvec": lambda r: (_mat(r), _vec(r, 3)),
    "mat_mul": lambda r: (_mat(r), ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0),
                                    (0.0, 0.0, 1.0))),
    "sv_dot": lambda r: (_vec(r, 6), _vec(r, 6)),
    "motion_cross": lambda r: (_vec(r, 6), _vec(r, 6)),
    "force_cross": lambda r: (_vec(r, 6), _vec(r, 6)),
    "spatial_inertia_world": lambda r: (0.3, (1e-3, 2e-3, 3e-3), _mat(r),
                                        _vec(r, 3)),
    "inertia_vec": lambda r: (tuple(_vec(r, 6) for _ in range(6)),
                              _vec(r, 6)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_lane_op_matches_jax(name):
    args = CASES[name](np.random.default_rng(zlib.crc32(name.encode())))
    want = _np(getattr(JL, name)(*_to(args, "jax")))
    got = _np(getattr(TL, name)(*_to(args, "torch")))
    _assert_same(want, got)


@pytest.mark.parametrize("op", ["mul", "add", "sub"])
def test_static_folding(op):
    x = torch.arange(1.0, 4.0, dtype=torch.float64)
    xj = jnp.asarray(x.numpy())
    statics = (0.0, 1.0, -1.0, 2.5)
    for a in statics:
        for b in statics + ("x",):
            ta = (a, x if b == "x" else b)
            ja = (a, xj if b == "x" else b)
            got = getattr(TL, op)(*ta)
            want = getattr(JL, op)(*ja)
            assert isinstance(got, float) == isinstance(want, float)
            np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                       rtol=0, atol=0)
            got = getattr(TL, op)(*ta[::-1])  # the mirrored argument order
            want = getattr(JL, op)(*ja[::-1])
            assert isinstance(got, float) == isinstance(want, float)
            np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                       rtol=0, atol=0)
