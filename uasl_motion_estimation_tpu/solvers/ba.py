"""Windowed bundle adjustment: batched Levenberg-Marquardt with dense Schur
complement elimination of landmarks.

Batched JAX re-design of the reference's Ceres-based ``BundleAdjuster<M>``
(reference: include/MotionEstimation/optimisation/BundleAdjuster.h:183-528).
The Ceres SPARSE_SCHUR solve over an irregular observation graph becomes a
fixed-shape dense-block computation over a (window, track) observation table:

* residuals: the reference's stereo 4-residual cost sharing predicted_y
  (StereoReprojectionError, BundleAdjuster.h:142-180) / mono 2-residual
  (StandardReprojectionError, h:71-103), with Huber(1.0) robustness
  (h:447-451) applied as IRLS weights;
* jacobians: autodiff (jax.jacfwd) over the same angle-axis + translation
  camera parametrization Ceres autodiffs (h:297-310);
* normal equations: per-frame 6x6 blocks U, per-point 3x3 blocks V, and the
  dense (W, M, 6, 3) coupling — all batched einsums;
* Schur: landmarks eliminated in parallel (batched 3x3 inverses), reduced
  camera system is a dense (6W, 6W) solve (W <= ~10, so <= 60x60 — tiny);
* gauge fixing: the first ``n_fixed`` frames' rows/cols of the reduced system
  are pinned (SetParameterBlockConstant equivalent, h:452-460);
* depth bounds: point depths in the first frame clamped to [zmin, zmax]
  (the box bounds of h:442-443, 455-459) after each accepted step;
* LM damping: multiplicative diagonal damping with gain-ratio adaptation in a
  ``lax.while_loop``.

Everything is shape-static, so whole problems ``vmap`` for window-parallel BA
across devices (no reference counterpart; SURVEY.md section 2.3).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import geometry as geo
from ..ops import lie


class BAConfig(NamedTuple):
    intr: geo.Intrinsics
    baseline: float = 0.0  # 0 -> mono (2 residuals); >0 -> stereo (4 residuals)
    huber_delta: float = 1.0  # HuberLoss(1.0), BundleAdjuster.h:447
    max_iter: int = 50  # Ceres default iteration cap (the reference keeps it)
    n_fixed: int = 2  # fixed first frames (gauge), nb_fixed_frames default
    lambda0: float = 1e-4
    lambda_up: float = 4.0
    lambda_down: float = 0.5
    lambda_min: float = 1e-10
    lambda_max: float = 1e6
    ftol: float = 1e-3  # function_tolerance (h:418)
    zmin_frac: float = 0.0  # zmin = zmin_frac * fu * baseline
    zmax_depth: float = 0.0  # 0 -> fu*baseline/0.1 when stereo (h:442)


class BAProblem(NamedTuple):
    """Fixed-shape window problem — the array analogue of the
    (vector<CamPose_qd>, vector<WBA_Point>) constructor inputs
    (BundleAdjuster.h:220-294)."""

    cam: jax.Array  # (W, 6) [angle-axis(3), translation(3)], world->cam
    pts: jax.Array  # (M, 3) world points
    obs: jax.Array  # (W, M, R) pixel obs, R=4 stereo [ul,vl,ur,vr] / 2 mono
    mask: jax.Array  # (W, M) bool observation validity


class BAResult(NamedTuple):
    cam: jax.Array
    pts: jax.Array
    cost: jax.Array  # final robust mean cost over valid residuals
    n_iter: jax.Array
    converged: jax.Array


def _project_stereo(cam6: jax.Array, pt3: jax.Array, cfg: BAConfig) -> jax.Array:
    """Predicted [ul, vl, ur, vr] sharing predicted_y (BundleAdjuster.h:153-171)."""
    R = lie.so3_exp(cam6[:3])
    pc = R @ pt3 + cam6[3:6]
    z = jnp.where(jnp.abs(pc[2]) < 1e-9, 1e-9, pc[2])
    ul = cfg.intr.fu * pc[0] / z + cfg.intr.cu
    v = cfg.intr.fv * pc[1] / z + cfg.intr.cv
    ur = cfg.intr.fu * (pc[0] - cfg.baseline) / z + cfg.intr.cu
    return jnp.stack([ul, v, ur, v])


def _project_mono(cam6: jax.Array, pt3: jax.Array, cfg: BAConfig) -> jax.Array:
    R = lie.so3_exp(cam6[:3])
    pc = R @ pt3 + cam6[3:6]
    z = jnp.where(jnp.abs(pc[2]) < 1e-9, 1e-9, pc[2])
    return jnp.stack(
        [cfg.intr.fu * pc[0] / z + cfg.intr.cu,
         cfg.intr.fv * pc[1] / z + cfg.intr.cv]
    )


def _residuals(cam, pts, obs, cfg: BAConfig):
    """Per-observation residuals r (W,M,R) only — ~10x cheaper than the
    jacobian path (jacfwd pushes 9 tangents through the projection), so the
    step-acceptance cost evaluation in the LM body must use this."""
    proj = _project_stereo if cfg.baseline > 0 else _project_mono
    one = lambda cam6, pt3, ob: ob - proj(cam6, pt3, cfg)
    f = jax.vmap(jax.vmap(one, in_axes=(None, 0, 0)), in_axes=(0, None, 0))
    return f(cam, pts, obs)


def _residuals_jacobians(cam, pts, obs, cfg: BAConfig):
    """Per-observation residuals r (W,M,R) and jacobians J_c (W,M,R,6),
    J_p (W,M,R,3) via forward-mode autodiff."""
    proj = _project_stereo if cfg.baseline > 0 else _project_mono

    def one(cam6, pt3, ob):
        pred = proj(cam6, pt3, cfg)
        return ob - pred

    def with_jac(cam6, pt3, ob):
        r = one(cam6, pt3, ob)
        Jc = jax.jacfwd(lambda c: one(c, pt3, ob))(cam6)
        Jp = jax.jacfwd(lambda p: one(cam6, p, ob))(pt3)
        return r, -Jc, -Jp  # J of predictions

    f = jax.vmap(jax.vmap(with_jac, in_axes=(None, 0, 0)), in_axes=(0, None, 0))
    return f(cam, pts, obs)


def _huber_weights(r: jax.Array, mask: jax.Array, delta: float) -> jax.Array:
    """IRLS weights for Huber loss on the per-observation residual norm."""
    nrm = jnp.sqrt(jnp.sum(r * r, axis=-1) + 1e-12)  # (W, M)
    w = jnp.where(nrm <= delta, 1.0, delta / nrm)
    return w * mask


def _robust_cost(r: jax.Array, mask: jax.Array, delta: float) -> jax.Array:
    """Mean Huber cost over valid observations."""
    sq = jnp.sum(r * r, axis=-1)
    nrm = jnp.sqrt(sq + 1e-12)
    rho = jnp.where(nrm <= delta, sq, 2.0 * delta * nrm - delta * delta)
    return jnp.sum(rho * mask) / jnp.maximum(jnp.sum(mask), 1.0)


def _normal_blocks(cam, pts, obs, mask, cfg: BAConfig):
    # full-f32 products: the normal-equation blocks are numerically delicate
    # and a reduced-precision default (bf16 passes, TF32) degrades convergence
    ein = partial(jnp.einsum, precision="highest")
    r, Jc, Jp = _residuals_jacobians(cam, pts, obs, cfg)
    w = _huber_weights(r, mask, cfg.huber_delta)[..., None, None]  # (W,M,1,1)
    Jcw = Jc * w
    U = ein("wmri,wmrj->wij", Jcw, Jc)  # (W, 6, 6)
    V = ein("wmri,wmrj->mij", Jp * w, Jp)  # (M, 3, 3)
    Wc = ein("wmri,wmrj->wmij", Jcw, Jp)  # (W, M, 6, 3)
    wr = r * w[..., 0]
    bc = ein("wmri,wmr->wi", Jc, wr)  # (W, 6)
    bp = ein("wmri,wmr->mi", Jp, wr)  # (M, 3)
    cost = _robust_cost(r, mask, cfg.huber_delta)
    return U, V, Wc, bc, bp, cost


def _schur_solve(U, V, Wc, bc, bp, lam, n_fixed: int, pt_valid):
    """Eliminate landmarks, solve the reduced camera system, back-substitute.

    Returns (dcam (W,6), dpts (M,3)).
    """
    W, M = Wc.shape[0], Wc.shape[1]
    eye3 = jnp.eye(3, dtype=V.dtype)
    eye6 = jnp.eye(6, dtype=U.dtype)

    # multiplicative diagonal damping (Ceres-style)
    Ud = U + lam * jnp.eye(6, dtype=U.dtype) * jnp.maximum(
        jnp.diagonal(U, axis1=-2, axis2=-1)[..., None], 1e-6)
    Vd = V + lam * eye3 * jnp.maximum(
        jnp.diagonal(V, axis1=-2, axis2=-1)[..., None], 1e-6)
    # unobserved / invalid points get identity (their updates are zeroed)
    Vd = jnp.where(pt_valid[:, None, None], Vd, eye3)
    Vinv = jnp.linalg.inv(Vd)  # (M, 3, 3) batched

    ein = partial(jnp.einsum, precision="highest")
    WV = ein("wmij,mjk->wmik", Wc, Vinv)  # (W, M, 6, 3)
    S = -ein("wmik,vmlk->wivl", WV, Wc)  # (W,6,W,6) cross terms
    S = S + ein("wv,wij->wivj", jnp.eye(W, dtype=U.dtype), Ud)
    rhs = bc - ein("wmik,mk->wi", WV, bp)  # (W, 6)

    # gauge fixing: pin the first n_fixed frames (rows/cols -> identity)
    free = (jnp.arange(W) >= n_fixed).astype(U.dtype)
    S = S * free[:, None, None, None] * free[None, None, :, None]
    S = S + jnp.einsum(
        "wv,ij->wivj", jnp.diag(1.0 - free), eye6
    )
    rhs = rhs * free[:, None]

    dcam = jnp.linalg.solve(S.reshape(W * 6, W * 6), rhs.reshape(W * 6))
    dcam = dcam.reshape(W, 6)

    dpts = ein("mij,mj->mi", Vinv, bp - ein("wmij,wi->mj", Wc, dcam))
    dpts = dpts * pt_valid[:, None]
    return dcam, dpts


def _clamp_depth(cam, pts, cfg: BAConfig):
    """Clamp depth in the first camera to [zmin, zmax]
    (BundleAdjuster.h:442-443, 455-459)."""
    if cfg.baseline <= 0:
        return pts
    fB = cfg.intr.fu * cfg.baseline
    zmax = cfg.zmax_depth if cfg.zmax_depth > 0 else fB / 0.1
    zmin = jnp.maximum(cfg.zmin_frac * fB, fB / (2.0 * cfg.intr.cu))
    R0 = lie.so3_exp(cam[0, :3])
    pc = pts @ R0.T + cam[0, 3:6]
    z = jnp.clip(pc[:, 2], zmin, zmax)
    pc = pc.at[:, 2].set(z)
    return (pc - cam[0, 3:6]) @ R0


class _State(NamedTuple):
    cam: jax.Array
    pts: jax.Array
    lam: jax.Array
    cost: jax.Array
    k: jax.Array
    done: jax.Array


@partial(jax.jit, static_argnames=("cfg",))
def ba_solve(problem: BAProblem, cfg: BAConfig) -> BAResult:
    """Run windowed BA to convergence (optimise(), BundleAdjuster.h:432-476).

    vmap over a leading window axis for window-parallel multi-device BA.
    """
    # The normal-equation products (J^T J, Schur complement) are tiny
    # matmuls whose conditioning carries the solve: under a bf16-pass f32
    # dot the LM steps degrade to the point of non-convergence at KITTI
    # pixel scales (the identical problem converges in 5 iterations at full
    # f32; 2-3 deg rotation errors otherwise). Force full f32 — the dims are
    # far too small for matrix-unit throughput to matter.
    with jax.default_matmul_precision("highest"):
        return _ba_solve_impl(problem, cfg)


def _ba_solve_impl(problem: BAProblem, cfg: BAConfig) -> BAResult:
    mask = problem.mask.astype(problem.cam.dtype)
    pt_valid = jnp.sum(mask, axis=0) >= 2.0  # need >=2 views to triangulate

    def cond(s: _State):
        return (~s.done) & (s.k < cfg.max_iter)

    def body(s: _State):
        U, V, Wc, bc, bp, cost = _normal_blocks(
            s.cam, s.pts, problem.obs, mask, cfg
        )
        dcam, dpts = _schur_solve(U, V, Wc, bc, bp, s.lam, cfg.n_fixed, pt_valid)
        ok = jnp.all(jnp.isfinite(dcam)) & jnp.all(jnp.isfinite(dpts))

        cam_new = s.cam + dcam
        pts_new = _clamp_depth(cam_new, s.pts + dpts, cfg)
        r_new = _residuals(cam_new, pts_new, problem.obs, cfg)
        cost_new = _robust_cost(r_new, mask, cfg.huber_delta)

        # freeze once converged: under vmap the while_loop runs until EVERY
        # batch element is done, and without this gate a converged window
        # kept taking micro-steps driven by its batch-mates' iteration count
        # — sliding along the Huber outlier plateau to batch-size-dependent
        # (and measured worse-vs-GT) solutions. Latching makes the batched
        # solve element-wise identical to a solo solve.
        accept = ok & (cost_new < cost) & ~s.done
        rel_decrease = (cost - cost_new) / jnp.maximum(cost, 1e-12)
        # a small decrease only signals convergence when damping is not
        # inflated (an accepted but heavily-damped step is just a short step)
        newly_done = accept & (rel_decrease < cfg.ftol) & (s.lam <= cfg.lambda0)

        lam = jnp.where(
            s.done,
            s.lam,
            jnp.where(
                accept,
                jnp.maximum(s.lam * cfg.lambda_down, cfg.lambda_min),
                jnp.minimum(s.lam * cfg.lambda_up, cfg.lambda_max),
            ),
        )
        cam = jnp.where(accept, cam_new, s.cam)
        pts = jnp.where(accept, pts_new, s.pts)
        best = jnp.where(accept, cost_new, cost)
        done = s.done | newly_done | (s.lam >= cfg.lambda_max)
        # don't count iterations a done-latched element sat out: under vmap
        # the loop runs to the slowest batch-mate, and an unconditional
        # increment would report the batch-wide count as this element's
        # n_iter (round-3 advisor finding)
        k = jnp.where(s.done, s.k, s.k + 1)
        return _State(cam, pts, lam, best, k, done)

    r0 = _residuals(problem.cam, problem.pts, problem.obs, cfg)
    s0 = _State(
        cam=problem.cam,
        pts=problem.pts,
        lam=jnp.asarray(cfg.lambda0, problem.cam.dtype),
        cost=_robust_cost(r0, mask, cfg.huber_delta),
        k=jnp.asarray(0, jnp.int32),
        done=jnp.asarray(False),
    )
    out = jax.lax.while_loop(cond, body, s0)
    return BAResult(
        cam=out.cam, pts=out.pts, cost=out.cost, n_iter=out.k,
        converged=out.done,
    )


def gate_tracks(
    cam: jax.Array,  # (W, 6)
    pts: jax.Array,  # (M, 3)
    obs: jax.Array,  # (W, M, R)
    mask: jax.Array,  # (W, M) bool
    cfg: BAConfig,
    gate_px: float,
) -> jax.Array:
    """Pre-BA inlier gate: (M,) keep-mask of tracks whose WORST per-component
    reprojection residual against the initial cameras stays within gate_px.

    The window-level analogue of the reference's RANSAC inlier gate
    (computeInliers, StereoVisualOdometry.cpp:94-114): tracks on
    independently moving objects are CONSISTENT with a wrong motion, so
    Huber down-weighting alone lets them drag the window optimum.
    """
    proj = _project_stereo if cfg.baseline > 0 else _project_mono
    # full-precision rotations: a bf16-pass R @ pt at ~1000-px image
    # coordinates carries multi-px error, enough to misclassify at the gate
    with jax.default_matmul_precision("highest"):
        pred = jax.vmap(
            jax.vmap(lambda c, x: proj(c, x, cfg), in_axes=(None, 0)),
            in_axes=(0, None),
        )(cam, pts)  # (W, M, R)
    err = jnp.max(jnp.abs(obs - pred), axis=-1)  # (W, M)
    err = jnp.where(mask, err, 0.0)
    return jnp.max(err, axis=0) <= gate_px


def ba_camera_covariances(problem: BAProblem, cfg: BAConfig) -> jax.Array:
    """Per-camera 6x6 covariances from the reduced camera system's inverse
    (extract_covariance, BundleAdjuster.h:478-528). Call after ba_solve."""
    mask = problem.mask.astype(problem.cam.dtype)
    pt_valid = jnp.sum(mask, axis=0) >= 2.0
    U, V, Wc, _, _, _ = _normal_blocks(
        problem.cam, problem.pts, problem.obs, mask, cfg
    )
    W = U.shape[0]
    eye3 = jnp.eye(3, dtype=V.dtype)
    Vd = jnp.where(pt_valid[:, None, None], V + 1e-9 * eye3, eye3)
    Vinv = jnp.linalg.inv(Vd)
    WV = jnp.einsum("wmij,mjk->wmik", Wc, Vinv)
    S = -jnp.einsum("wmik,vmlk->wivl", WV, Wc)
    S = S + jnp.einsum("wv,wij->wivj", jnp.eye(W, dtype=U.dtype), U)
    free = (jnp.arange(W) >= cfg.n_fixed).astype(U.dtype)
    S = S * free[:, None, None, None] * free[None, None, :, None]
    S = S + jnp.einsum("wv,ij->wivj", jnp.diag(1.0 - free),
                       jnp.eye(6, dtype=U.dtype))
    Sf = S.reshape(W * 6, W * 6)
    # relative Tikhonov: a window frame with almost no surviving gated
    # observations makes S near-singular and its f32 inverse indefinite
    # (negative diagonal "variances" — observed on the corrupted world)
    eps = 1e-6 * jnp.maximum(jnp.mean(jnp.abs(jnp.diagonal(Sf))), 1.0)
    Sf = Sf + eps * jnp.eye(W * 6, dtype=U.dtype)
    Sinv = jnp.linalg.inv(Sf).reshape(W, 6, W, 6)
    cov = jnp.einsum("wiwj->wij", Sinv)
    # symmetrize + project to PSD (clip the eigenvalue range): downstream
    # consumers (weights, chained propagation) need valid covariances even
    # from degenerate windows, where "huge" is informative but "negative"
    # is poison
    cov = 0.5 * (cov + jnp.swapaxes(cov, -1, -2))
    eig, vec = jnp.linalg.eigh(cov)
    eig = jnp.clip(eig, 0.0, 1e4)
    cov = jnp.einsum("wij,wj,wkj->wik", vec, eig, vec)
    # fixed (gauge) frames are exactly known: zero covariance, not the
    # placeholder identity their masked normal-equation rows would imply
    return cov * free[:, None, None]
