"""Rotation algebra: Euler angles, quaternions, SO(3) exp/log maps.

Batched JAX re-design of the reference's rotation utilities
(reference: include/MotionEstimation/core/rotation_utils.h:34-268,
src/core/rotation_utils.cpp:25-368). All functions are pure jnp, operate on
trailing-dimension arrays, and are `vmap`/`jit` friendly (no data-dependent
control flow; singularities handled with `jnp.where` + Taylor fallbacks).

Conventions
-----------
* Euler angles ``(roll, pitch, yaw)`` about (x, y, z); ``euler_to_R`` produces
  the same world->body DCM as the reference's ``Euler<T>::getR3``
  (rotation_utils.cpp:25-33): ``R = Rx(roll) @ Ry(pitch) @ Rz(yaw)`` in the
  row-convention used there.
* Quaternions are ``[w, x, y, z]`` (scalar first), matching the reference's
  ``Quat<T>`` storage (rotation_utils.h:118-188).
* ``so3_exp``/``so3_log`` are the matrix exp/log maps, equivalents of
  ``exp_map_Mat``/``log_map_Mat`` (rotation_utils.h:191-218);
  ``quat_exp``/``quat_log`` mirror ``exp_map_Quat``/``log_map_Quat``.

Default dtype is float32 (the accelerator's); pass float64 inputs on CPU for
high-precision testing.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_EPS = 1e-8


def skew(v: jax.Array) -> jax.Array:
    """Skew-symmetric matrix [v]_x such that [v]_x @ u = v x u.

    Reference: rotation_utils.h:30.  Batched: v (..., 3) -> (..., 3, 3).
    """
    zeros = jnp.zeros_like(v[..., 0])
    return jnp.stack(
        [
            jnp.stack([zeros, -v[..., 2], v[..., 1]], axis=-1),
            jnp.stack([v[..., 2], zeros, -v[..., 0]], axis=-1),
            jnp.stack([-v[..., 1], v[..., 0], zeros], axis=-1),
        ],
        axis=-2,
    )


# ---------------------------------------------------------------------------
# Euler angles
# ---------------------------------------------------------------------------


def euler_to_R(rpy: jax.Array) -> jax.Array:
    """(roll, pitch, yaw) -> 3x3 DCM, same element layout as Euler::getR3.

    Reference: rotation_utils.cpp:25-33. rpy (..., 3) -> (..., 3, 3).
    """
    cr, sr = jnp.cos(rpy[..., 0]), jnp.sin(rpy[..., 0])
    cp, sp = jnp.cos(rpy[..., 1]), jnp.sin(rpy[..., 1])
    cy, sy = jnp.cos(rpy[..., 2]), jnp.sin(rpy[..., 2])
    return jnp.stack(
        [
            jnp.stack([cp * cy, cp * sy, -sp], axis=-1),
            jnp.stack([sp * sr * cy - cr * sy, sr * sp * sy + cr * cy, cp * sr], axis=-1),
            jnp.stack([cr * sp * cy + sr * sy, cr * sp * sy - sr * cy, cp * cr], axis=-1),
        ],
        axis=-2,
    )


def euler_dR(rpy: jax.Array) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Analytic derivatives (dR/droll, dR/dpitch, dR/dyaw).

    Reference: Euler::getdRdr/getdRdp/getdRdy (rotation_utils.cpp:58-91).
    Used by the stereo VO jacobian (StereoVisualOdometry.cpp:291-329).
    """
    cr, sr = jnp.cos(rpy[..., 0]), jnp.sin(rpy[..., 0])
    cp, sp = jnp.cos(rpy[..., 1]), jnp.sin(rpy[..., 1])
    cy, sy = jnp.cos(rpy[..., 2]), jnp.sin(rpy[..., 2])
    zeros = jnp.zeros_like(cr)
    dRdr = jnp.stack(
        [
            jnp.stack([zeros, zeros, zeros], axis=-1),
            jnp.stack([cr * sp * cy + sr * sy, cr * sp * sy - sr * cy, cr * cp], axis=-1),
            jnp.stack([-sr * sp * cy + cr * sy, -sr * sp * sy - cr * cy, -sr * cp], axis=-1),
        ],
        axis=-2,
    )
    dRdp = jnp.stack(
        [
            jnp.stack([-cy * sp, -sy * sp, -cp], axis=-1),
            jnp.stack([sr * cp * cy, sr * cp * sy, -sr * sp], axis=-1),
            jnp.stack([cr * cp * cy, cr * cp * sy, -cr * sp], axis=-1),
        ],
        axis=-2,
    )
    dRdy = jnp.stack(
        [
            jnp.stack([-cp * sy, cp * cy, zeros], axis=-1),
            jnp.stack([-sr * sp * sy - cr * cy, sr * sp * cy - cr * sy, zeros], axis=-1),
            jnp.stack([-cr * sp * sy + sr * cy, cr * sp * cy + sr * sy, zeros], axis=-1),
        ],
        axis=-2,
    )
    return dRdr, dRdp, dRdy


def R_to_euler(R: jax.Array) -> jax.Array:
    """Inverse of euler_to_R. Reference: Euler::fromMat (rotation_utils.cpp:94-152)."""
    roll = jnp.arctan2(R[..., 1, 2], R[..., 2, 2])
    pitch = -jnp.arcsin(jnp.clip(R[..., 0, 2], -1.0, 1.0))
    yaw = jnp.arctan2(R[..., 0, 1], R[..., 0, 0])
    return jnp.stack([roll, pitch, yaw], axis=-1)


# ---------------------------------------------------------------------------
# Quaternions ([w, x, y, z])
# ---------------------------------------------------------------------------


def quat_identity(dtype=jnp.float32) -> jax.Array:
    return jnp.array([1.0, 0.0, 0.0, 0.0], dtype=dtype)


def quat_normalize(q: jax.Array) -> jax.Array:
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def quat_conj(q: jax.Array) -> jax.Array:
    """Conjugate. Reference: Quat::conj (rotation_utils.h)."""
    return q * jnp.array([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def quat_mul(q1: jax.Array, q2: jax.Array) -> jax.Array:
    """Hamilton product q1 * q2 (compose rotations; q1 applied after q2)."""
    w1, x1, y1, z1 = (q1[..., i] for i in range(4))
    w2, x2, y2, z2 = (q2[..., i] for i in range(4))
    return jnp.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        axis=-1,
    )


def quat_to_R(q: jax.Array) -> jax.Array:
    """Quaternion -> standard (Rodrigues-consistent) rotation matrix.

    Matches the reference's ``Quat::getR3`` (rotation_utils.h:232-238), which
    is the *standard* active rotation — note the reference's ``Euler::getR3``
    is its transpose for the same rotation (the VO applies ``getR4().t()``,
    StereoVisualOdometry.cpp:129). Accordingly here
    ``quat_to_R(euler_to_quat(e)) == euler_to_R(e).T``.
    """
    q = quat_normalize(q)
    w, x, y, z = (q[..., i] for i in range(4))
    return jnp.stack(
        [
            jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], axis=-1),
            jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], axis=-1),
            jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], axis=-1),
        ],
        axis=-2,
    )


def R_to_quat(R: jax.Array) -> jax.Array:
    """Standard rotation matrix -> quaternion, branch-free for batching.

    Uses the standard 4-branch trace method combined with jnp.where so it is
    safe under vmap/jit (reference uses cv::Rodrigues, rotation_utils.cpp:230-243).
    """
    M = R
    m00, m01, m02 = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    m10, m11, m12 = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    m20, m21, m22 = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    tr = m00 + m11 + m22

    # Candidate quaternions from each branch (unnormalized).
    qw = jnp.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], axis=-1)
    qx = jnp.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], axis=-1)
    qy = jnp.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], axis=-1)
    qz = jnp.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], axis=-1)

    # Pick the numerically largest pivot.
    pivots = jnp.stack([1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22,
                        1.0 - m00 - m11 + m22], axis=-1)
    idx = jnp.argmax(pivots, axis=-1)
    cands = jnp.stack([qw, qx, qy, qz], axis=-2)  # (..., 4branch, 4)
    q = jnp.take_along_axis(cands, idx[..., None, None].astype(jnp.int32), axis=-2)[..., 0, :]
    q = quat_normalize(q)
    # Canonical sign: w >= 0.
    return q * jnp.where(q[..., :1] < 0, -1.0, 1.0)


def euler_to_quat(rpy: jax.Array) -> jax.Array:
    """Euler -> quaternion. Reference: Euler::getQuat (rotation_utils.cpp:155-165)."""
    hr, hp, hy = rpy[..., 0] * 0.5, rpy[..., 1] * 0.5, rpy[..., 2] * 0.5
    cr, sr = jnp.cos(hr), jnp.sin(hr)
    cp, sp = jnp.cos(hp), jnp.sin(hp)
    cy, sy = jnp.cos(hy), jnp.sin(hy)
    return jnp.stack(
        [
            cr * cp * cy + sr * sp * sy,
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
        ],
        axis=-1,
    )


def quat_to_euler(q: jax.Array) -> jax.Array:
    """Reference: Quat::getEuler (rotation_utils.cpp:249-253).

    euler_to_R expects the world->body DCM = transpose of the standard matrix.
    """
    return R_to_euler(jnp.swapaxes(quat_to_R(q), -1, -2))


def quat_rotate(q: jax.Array, v: jax.Array) -> jax.Array:
    """Apply the rotation described by q to v: quat_to_R(q) @ v."""
    return jnp.einsum("...ij,...j->...i", quat_to_R(q), v)


# ---------------------------------------------------------------------------
# exp / log maps
# ---------------------------------------------------------------------------


def _safe_sqrt(x2: jax.Array, small: jax.Array) -> jax.Array:
    """sqrt with autodiff-safe handling at 0: the sqrt argument itself is
    replaced where ``small``, so no NaN tangents leak through jnp.where
    (the classic where-grad trap)."""
    return jnp.sqrt(jnp.where(small, 1.0, x2))


def _sinc_half(theta2: jax.Array) -> jax.Array:
    """sin(t/2)/t with Taylor fallback near 0 (t = sqrt(theta2))."""
    small = theta2 < _EPS
    safe = _safe_sqrt(theta2, small)
    return jnp.where(small, 0.5 - theta2 / 48.0, jnp.sin(safe * 0.5) / safe)


def quat_exp(v: jax.Array) -> jax.Array:
    """Rotation vector -> quaternion (exp map). Reference: exp_map_Quat."""
    theta2 = jnp.sum(v * v, axis=-1)
    small = theta2 < _EPS
    theta = _safe_sqrt(theta2, small)
    w = jnp.where(small, 1.0 - theta2 / 8.0, jnp.cos(theta * 0.5))
    xyz = v * _sinc_half(theta2)[..., None]
    return jnp.concatenate([w[..., None], xyz], axis=-1)


def quat_log(q: jax.Array) -> jax.Array:
    """Quaternion -> rotation vector (log map). Reference: log_map_Quat."""
    q = quat_normalize(q)
    q = q * jnp.where(q[..., :1] < 0, -1.0, 1.0)  # shortest arc
    w = jnp.clip(q[..., 0], -1.0, 1.0)
    vn2 = jnp.sum(q[..., 1:] * q[..., 1:], axis=-1)
    small = vn2 < _EPS
    vn = _safe_sqrt(vn2, small)
    theta = 2.0 * jnp.arctan2(vn, w)
    # small-angle: theta/vn -> 2/w * (1 - vn2/(3 w^2)), exact to O(vn2^2)
    scale = jnp.where(small, 2.0 / w * (1.0 - vn2 / (3.0 * w * w)), theta / vn)
    return q[..., 1:] * scale[..., None]


def so3_exp(v: jax.Array) -> jax.Array:
    """Rodrigues: rotation vector -> 3x3 matrix (body->world sense of exp).

    Reference: exp_map_Mat (rotation_utils.h:191-218).
    """
    theta2 = jnp.sum(v * v, axis=-1)
    small = theta2 < _EPS
    safe_t = _safe_sqrt(theta2, small)
    A = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(safe_t) / safe_t)
    B = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(safe_t)) / (safe_t * safe_t))
    K = skew(v)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=v.dtype), K.shape)
    return eye + A[..., None, None] * K + B[..., None, None] * (K @ K)


def so3_log(R: jax.Array) -> jax.Array:
    """Matrix log: 3x3 rotation -> rotation vector. Reference: log_map_Mat."""
    return quat_log(R_to_quat(R))


def so3_right_jacobian(v: jax.Array) -> jax.Array:
    """Right jacobian J_r(v) of SO(3): d exp(v+dv) ~ exp(v) exp(J_r dv)."""
    theta2 = jnp.sum(v * v, axis=-1)
    small = theta2 < _EPS
    safe_t = _safe_sqrt(theta2, small)
    A = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(safe_t)) / (safe_t * safe_t))
    B = jnp.where(
        small, 1.0 / 6.0 - theta2 / 120.0, (safe_t - jnp.sin(safe_t)) / (safe_t**3)
    )
    K = skew(v)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=v.dtype), K.shape)
    return eye - A[..., None, None] * K + B[..., None, None] * (K @ K)


# ---------------------------------------------------------------------------
# Reference-frame conversion (rotation_utils.h:19, rotation_utils.cpp:321-354)
# ---------------------------------------------------------------------------

# TRef maps the XYZ (x fwd, y left, z up) convention to the OpenCV camera
# convention (x right, y down, z fwd): rows (0,-1,0),(0,0,-1),(1,0,0)
TREF = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])


def xyz_to_opencv(v: jax.Array) -> jax.Array:
    """Rotate a 3-vector (or rpy triple) from XYZ to OpenCV axes
    (convertToOpenCV, rotation_utils.cpp:321-326, 347-350)."""
    return v @ jnp.asarray(TREF, v.dtype).T


def opencv_to_xyz(v: jax.Array) -> jax.Array:
    """Inverse of xyz_to_opencv (convertToXYZ, rotation_utils.cpp:329-333)."""
    return v @ jnp.asarray(TREF, v.dtype)


def quat_xyz_to_opencv(q: jax.Array) -> jax.Array:
    """Quaternion frame change q -> q_TRef * q (convertToOpenCV for Quat,
    rotation_utils.cpp:336-340)."""
    q_ref = R_to_quat(jnp.asarray(TREF, q.dtype))
    return quat_mul(q_ref, q)


def quat_opencv_to_xyz(q: jax.Array) -> jax.Array:
    """Inverse quaternion frame change (convertToXYZ for Quat,
    rotation_utils.cpp:342-345: q * conj(0.5,-0.5,0.5,-0.5))."""
    q_ref = R_to_quat(jnp.asarray(TREF, q.dtype))
    return quat_mul(quat_conj(q_ref), q)
