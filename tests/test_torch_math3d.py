"""The port's ``math3d`` against the JAX package's, case by case as
``tests/test_math3d.py`` runs them, on the same numpy inputs.

Tolerance: 1e-6 absolute (f32 rounding of a few ops; JAX's CPU compiler
fuses multiply-adds and PyTorch does not).  The affine inverse is held
to 1e-6 relative as well: its entries reach 1 / 0.2 = 5, where one ulp is
4.8e-7 and the two LU solvers round differently.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from banggameengine_tpu import math3d as jm
from banggameengine_tpu_torch import math3d as tm

ATOL = 1e-6
RNG_SEED = 0


def _euler(rng, n):
    return rng.uniform(-np.pi, np.pi, (n, 3)).astype(np.float32)


def _cases():
    """Each case: (name, JAX call, port call, numpy args)."""
    rng = np.random.default_rng(RNG_SEED)
    e = _euler(rng, 64)
    s = rng.uniform(0.2, 2.0, (64, 3)).astype(np.float32)
    t = rng.normal(size=(64, 3)).astype(np.float32)
    p = rng.normal(size=(64, 3)).astype(np.float32)
    axis = rng.normal(size=(32, 3)).astype(np.float32)
    angle = rng.uniform(-4.0, 4.0, 32).astype(np.float32)
    q = np.asarray(jm.quat_from_euler_xyz(jnp.asarray(e)))
    mats = np.asarray(jm.mat_from_euler_srt(jnp.asarray(s), jnp.asarray(e),
                                            jnp.asarray(t)))
    rot = np.asarray(jm.quat_to_mat3(jnp.asarray(q)))
    # gimbal-locked rotations (pitch +-pi/2) take the other branch
    gimbal = e[:8].copy()
    gimbal[:, 1] = np.float32(np.pi / 2) * np.sign(gimbal[:, 1])
    qg = np.asarray(jm.quat_from_euler_xyz(jnp.asarray(gimbal)))
    return [
        ("quat_from_axis_angle", jm.quat_from_axis_angle,
         tm.quat_from_axis_angle, (axis, angle)),
        ("quat_from_mat3", jm.quat_from_mat3, tm.quat_from_mat3, (rot,)),
        ("quat_from_mat3_axes", jm.quat_from_mat3, tm.quat_from_mat3,
         (np.asarray(jm.quat_to_mat3(jnp.asarray(np.eye(4, dtype=np.float32)[
             [0, 1, 2, 3, 0, 1, 2]]))),)),
        ("euler_zyx_from_quat", jm.euler_zyx_from_quat,
         tm.euler_zyx_from_quat, (q,)),
        ("euler_zyx_from_quat_gimbal", jm.euler_zyx_from_quat,
         tm.euler_zyx_from_quat, (qg,)),
        ("mat_from_euler_srt", jm.mat_from_euler_srt, tm.mat_from_euler_srt,
         (s, e, t)),
        ("mat_transform_point", jm.mat_transform_point,
         tm.mat_transform_point, (mats, p)),
        ("mat_transform_dir", jm.mat_transform_dir, tm.mat_transform_dir,
         (mats, p)),
        ("mat_affine_inverse", jm.mat_affine_inverse, tm.mat_affine_inverse,
         (mats,)),
    ]


@pytest.mark.parametrize("case", _cases(), ids=lambda c: c[0])
def test_matches_jax(case):
    name, jfn, tfn, args = case
    ref = np.asarray(jfn(*(jnp.asarray(a) for a in args)))
    out = tfn(*(torch.from_numpy(np.array(a)) for a in args)).numpy()
    assert out.dtype == np.float32 and out.shape == ref.shape
    rtol = 1e-6 if name == "mat_affine_inverse" else 0.0
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=rtol, err_msg=name)


def test_identities_and_ortho_match_jax():
    for shape in ((), (5,), (2, 3)):
        np.testing.assert_array_equal(
            tm.quat_identity(shape, "cpu").numpy(),
            np.asarray(jm.quat_identity(shape)))
        np.testing.assert_array_equal(
            tm.mat_identity(shape, "cpu").numpy(),
            np.asarray(jm.mat_identity(shape)))
    for args in ((-1.0, 1.0, -1.0, 1.0, 0.1, 100.0),
                 (-6.4, 3.3, -2.5, 7.1, -4.0, 50.0)):
        np.testing.assert_array_equal(tm.mtx_ortho(*args, device="cpu")
                                      .numpy(),
                                      np.asarray(jm.mtx_ortho(*args)))


def test_round_trips_hold():
    """The JAX tests' round trips, on the port: the matrix of a quaternion
    gives it back (up to sign), the Euler angles give the rotation back,
    the affine inverse composes to the identity."""
    rng = np.random.default_rng(RNG_SEED + 1)
    e = torch.from_numpy(_euler(rng, 64))
    e[:, 1] = e[:, 1].clamp(-1.4, 1.4)
    q = tm.quat_from_euler_xyz(e)
    q2 = tm.quat_from_mat3(tm.quat_to_mat3(q))
    assert torch.allclose((q * q2).sum(-1).abs(), torch.ones(64), atol=1e-5)
    q3 = tm.quat_from_euler_xyz(tm.euler_zyx_from_quat(q))
    assert torch.allclose((q * q3).sum(-1).abs(), torch.ones(64), atol=1e-4)
    s = torch.from_numpy(rng.uniform(0.2, 2.0, (8, 3)).astype(np.float32))
    m = tm.mat_from_euler_srt(s, e[:8], torch.ones(8, 3))
    prod = tm.mat_mul(m, tm.mat_affine_inverse(m))
    assert torch.allclose(prod, tm.mat_identity((8,), "cpu"), atol=1e-4)
    out = tm.quat_rotate(tm.quat_identity((5,), "cpu"), e[:5])
    assert torch.equal(out, e[:5])
