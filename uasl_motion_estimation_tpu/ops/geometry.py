"""Projective geometry: homogeneous points, projection, triangulation, poses.

Batched JAX re-design of the reference's feature/pose types
(reference: include/MotionEstimation/core/feature_types.h:25-268,
src/core/feature_types.cpp:18-251). Instead of per-point C++ structs, all ops
here are array-native: points are ``(..., 2|3|4)`` arrays, poses are pytrees of
arrays, covariances propagate via autodiff jacobians rather than the hand-coded
quaternion blocks ``getG/getH/getQl/getQr`` (rotation_utils.h:257-268).

A pose is the pair ``(q, t)``: quaternion [w,x,y,z] + translation, with
``T(x) = R(q) @ x + t`` (same semantics as ``CamPose::TrMat``,
feature_types.cpp:32-42). Pose covariance is 6x6 over the local tangent
``[dt, dtheta]`` (translation, rotation-vector), matching the reference's
``[position, log(q)]`` ordering (feature_types.cpp:172-251).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import lie


# ---------------------------------------------------------------------------
# Homogeneous coordinates (feature_types.h:25-86)
# ---------------------------------------------------------------------------


def to_homogeneous(pts: jax.Array) -> jax.Array:
    """(..., N) euclidean -> (..., N+1) homogeneous with last coord 1."""
    return jnp.concatenate([pts, jnp.ones_like(pts[..., :1])], axis=-1)


def from_homogeneous(pts: jax.Array, eps: float = 1e-12) -> jax.Array:
    """(..., N+1) homogeneous -> (..., N) euclidean (normalize by last coord).

    Reference: ``to_euclidean``/``normalize`` (feature_types.h:49-86).
    """
    w = pts[..., -1:]
    w = jnp.where(jnp.abs(w) < eps, jnp.where(w < 0, -eps, eps), w)
    return pts[..., :-1] / w


# ---------------------------------------------------------------------------
# Camera model
# ---------------------------------------------------------------------------


class Intrinsics(NamedTuple):
    """Pinhole intrinsics (reference: StereoVisualOdometry::parameters fu1..cv2,
    vo/StereoVisualOdometry.h:24-33)."""

    fu: jax.Array
    fv: jax.Array
    cu: jax.Array
    cv: jax.Array

    @property
    def K(self) -> jax.Array:
        fu, fv, cu, cv = (jnp.asarray(x, jnp.float32) for x in self)
        z, o = jnp.zeros_like(fu), jnp.ones_like(fu)
        return jnp.stack(
            [
                jnp.stack([fu, z, cu], axis=-1),
                jnp.stack([z, fv, cv], axis=-1),
                jnp.stack([z, z, o], axis=-1),
            ],
            axis=-2,
        )


def project(pts3: jax.Array, intr: Intrinsics, baseline_shift: jax.Array | float = 0.0
            ) -> jax.Array:
    """Project camera-frame 3D points to pixels: u = fu*(x - b)/z + cu.

    ``baseline_shift`` b implements the right camera of a rectified pair, i.e.
    the P2 projection matrix of the reference (StereoVisualOdometry.cpp:137:
    ``P2 = [fu2, 0, cu2, -baseline*fu2; ...]``).
    """
    x, y, z = pts3[..., 0], pts3[..., 1], pts3[..., 2]
    z = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    u = intr.fu * (x - baseline_shift) / z + intr.cu
    v = intr.fv * y / z + intr.cv
    return jnp.stack([u, v], axis=-1)


def triangulate_disparity(
    left_uv: jax.Array,
    right_uv: jax.Array,
    intr_left: Intrinsics,
    intr_right: Intrinsics,
    baseline: jax.Array | float,
    min_disparity: float = 1e-5,
) -> jax.Array:
    """Rectified-stereo triangulation from a quad match's (f1, f2) pair.

    Same formula as ``StereoVisualOdometry::project3D``
    (StereoVisualOdometry.cpp:22-32):
      d = (u_l - cu_l) - (u_r - cu_r);  clamped to >= min_disparity
      X = ((u_l - cu_l) * B, (v_l - cv_l) * B, fu_l * B) / d
    Returns euclidean (..., 3) camera-frame points.
    """
    du = (left_uv[..., 0] - intr_left.cu) - (right_uv[..., 0] - intr_right.cu)
    d = jnp.where(du > 0, du, min_disparity)
    x = (left_uv[..., 0] - intr_left.cu) * baseline / d
    y = (left_uv[..., 1] - intr_left.cv) * baseline / d
    z = intr_left.fu * baseline / d
    return jnp.stack([x, y, z], axis=-1)


# ---------------------------------------------------------------------------
# Poses
# ---------------------------------------------------------------------------


class Pose(NamedTuple):
    """Rigid transform T(x) = R(q) x + t with optional 6x6 covariance.

    Tangent/covariance ordering is [translation(3), rotation(3)], matching the
    reference's pose-covariance jacobians (feature_types.cpp:83-95).
    """

    q: jax.Array  # (..., 4) quaternion [w,x,y,z]
    t: jax.Array  # (..., 3)
    cov: jax.Array | None = None  # (..., 6, 6) or None

    @property
    def R(self) -> jax.Array:
        return lie.quat_to_R(self.q)

    def matrix(self) -> jax.Array:
        """4x4 homogeneous transform (CamPose::TrMat, feature_types.cpp:32-42)."""
        R = self.R
        top = jnp.concatenate([R, self.t[..., :, None]], axis=-1)
        bottom = jnp.broadcast_to(
            jnp.array([0.0, 0.0, 0.0, 1.0], dtype=top.dtype), top.shape[:-2] + (1, 4)
        )
        return jnp.concatenate([top, bottom], axis=-2)

    def apply(self, pts: jax.Array) -> jax.Array:
        """Transform euclidean 3D points."""
        return jnp.einsum("...ij,...nj->...ni", self.R, pts) + self.t[..., None, :]

    def compose(self, other: "Pose") -> "Pose":
        """self * other: apply ``other`` first (CamPose::operator*)."""
        return Pose(
            q=lie.quat_normalize(lie.quat_mul(self.q, other.q)),
            t=lie.quat_rotate(self.q, other.t) + self.t,
        )

    def inverse(self) -> "Pose":
        """T^-1 (CamPose::inv, feature_types.cpp:61-69)."""
        qc = lie.quat_conj(self.q)
        return Pose(q=qc, t=-lie.quat_rotate(qc, self.t))


def pose_identity(dtype=jnp.float32) -> Pose:
    return Pose(q=lie.quat_identity(dtype), t=jnp.zeros(3, dtype))


def pose_from_matrix(T: jax.Array) -> Pose:
    return Pose(q=lie.R_to_quat(T[..., :3, :3]), t=T[..., :3, 3])


def _perturb(p: Pose, xi: jax.Array) -> Pose:
    """Right-perturbation on the [dt, dtheta] tangent used for covariances."""
    return Pose(
        q=lie.quat_normalize(lie.quat_mul(p.q, lie.quat_exp(xi[3:6]))),
        t=p.t + lie.quat_rotate(p.q, xi[0:3]),
    )


def _tangent_jacobians(f, *poses: Pose) -> tuple[Pose, list[jax.Array]]:
    """Jacobians of pose-valued f(*poses) wrt each pose's local tangent.

    Replaces the reference's hand-coded getG/getH/getH_qvec blocks
    (feature_types.cpp:83-169) with autodiff: J_i = d log(f(.. p_i exp(xi) ..))
    / d xi at xi=0, expressed in the output's local tangent.
    """
    out = f(*poses)

    def local_delta(xi_all):
        perturbed = [
            _perturb(p, xi_all[6 * i : 6 * i + 6]) for i, p in enumerate(poses)
        ]
        res = f(*perturbed)
        dq = lie.quat_mul(lie.quat_conj(out.q), res.q)
        dtheta = lie.quat_log(dq)
        dt = lie.quat_rotate(lie.quat_conj(out.q), res.t - out.t)
        return jnp.concatenate([dt, dtheta])

    xi0 = jnp.zeros(6 * len(poses), dtype=out.t.dtype)
    J = jax.jacfwd(local_delta)(xi0)  # (6, 6*len(poses))
    return out, [J[:, 6 * i : 6 * i + 6] for i in range(len(poses))]


def compose_with_covariance(p1: Pose, p2: Pose) -> Pose:
    """p1 * p2 with first-order covariance propagation.

    Reference: ``poseMultiplicationWithCovariance`` (feature_types.cpp:172-193),
    re-derived via autodiff over the local tangent instead of quaternion-block
    jacobians. Requires p1.cov and p2.cov.
    """
    out, (J1, J2) = _tangent_jacobians(lambda a, b: a.compose(b), p1, p2)
    cov = J1 @ p1.cov @ J1.T + J2 @ p2.cov @ J2.T
    return Pose(out.q, out.t, cov)


def invert_with_covariance(p: Pose) -> Pose:
    """Pose inverse with covariance (invertPoseWithCovariance,
    feature_types.cpp:225-241)."""
    out, (J,) = _tangent_jacobians(lambda a: a.inverse(), p)
    return Pose(out.q, out.t, J @ p.cov @ J.T)


def scale_pose_with_covariance(p: Pose, scale: jax.Array, scale_var: jax.Array) -> Pose:
    """Scale translation by ``scale`` (variance ``scale_var``), propagating cov.

    Reference: ``ScalePoseWithCovariance`` (feature_types.cpp:244-251):
    augmented 7x7 cov with scale variance, J = [[s*I, 0, t], [0, I, 0]].
    """
    out = Pose(p.q, p.t * scale)

    def local_delta(xi_s):
        xi, ds = xi_s[:6], xi_s[6]
        pp = _perturb(p, xi)
        res_t = pp.t * (scale + ds)
        dq = lie.quat_mul(lie.quat_conj(out.q), pp.q)
        dt = lie.quat_rotate(lie.quat_conj(out.q), res_t - out.t)
        return jnp.concatenate([dt, lie.quat_log(dq)])

    J = jax.jacfwd(local_delta)(jnp.zeros(7, dtype=p.t.dtype))
    aug = jnp.zeros((7, 7), dtype=p.t.dtype)
    aug = aug.at[:6, :6].set(p.cov).at[6, 6].set(scale_var)
    return Pose(out.q, out.t, J @ aug @ J.T)


# ---------------------------------------------------------------------------
# Host-side (numpy, float64) covariance transport
# ---------------------------------------------------------------------------
#
# The engines compose their final pose chains on the host in float64 (the
# round-4 precision lesson); carrying pose covariance along that chain needs
# the same transport OFF-device, per-frame, without a dispatch each step.
# These closed-form adjoint helpers are the numpy counterparts of the
# autodiff versions above ([dt, dtheta] right-perturbation tangent,
# poseMultiplicationWithCovariance / invertPoseWithCovariance semantics,
# feature_types.cpp:172-241) and are parity-tested against them
# (tests/test_geometry.py).

import numpy as _onp


def se3_adjoint_np(T: _onp.ndarray) -> _onp.ndarray:
    """(4, 4) -> (6, 6) adjoint on the [dt, dtheta] right tangent:
    T exp(xi) = exp(Ad_T xi) T, with Ad = [[R, [t]x R], [0, R]]."""
    R = T[:3, :3]
    t = T[:3, 3]
    tx = _onp.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]],
                    dtype=_onp.float64)
    A = _onp.zeros((6, 6))
    A[:3, :3] = R
    A[:3, 3:] = tx @ R
    A[3:, 3:] = R
    return A


def compose_with_covariance_np(
    Ta: _onp.ndarray, Ca: _onp.ndarray, Tb: _onp.ndarray, Cb: _onp.ndarray
) -> tuple[_onp.ndarray, _onp.ndarray]:
    """(Ta @ Tb, covariance) under independent right-tangent covariances:
    C = Ad(Tb^-1) Ca Ad(Tb^-1)^T + Cb."""
    J = se3_adjoint_np(_onp.linalg.inv(Tb))
    return Ta @ Tb, J @ Ca @ J.T + Cb


def invert_with_covariance_np(
    T: _onp.ndarray, C: _onp.ndarray
) -> tuple[_onp.ndarray, _onp.ndarray]:
    """(T^-1, Ad(T) C Ad(T)^T)."""
    A = se3_adjoint_np(T)
    return _onp.linalg.inv(T), A @ C @ A.T


def relative_scale(pts_a: jax.Array, pts_b: jax.Array, mask: jax.Array | None = None
                   ) -> jax.Array:
    """Median ratio of pairwise distances between two 3D point sets.

    Capability parity with ``MonoVisualOdometry::findRelativeScale``
    (MonoVisualOdometry.cpp:76-87), but over all consecutive pairs with a
    median (robust) instead of a mean over sampled pairs.
    """
    da = jnp.linalg.norm(pts_a - jnp.roll(pts_a, 1, axis=0), axis=-1)
    db = jnp.linalg.norm(pts_b - jnp.roll(pts_b, 1, axis=0), axis=-1)
    ratio = da / jnp.where(db < 1e-12, 1e-12, db)
    if mask is not None:
        pair_mask = mask & jnp.roll(mask, 1, axis=0)
        ratio = jnp.where(pair_mask, ratio, jnp.nan)
        return jnp.nanmedian(ratio)
    return jnp.median(ratio)
