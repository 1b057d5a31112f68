"""Monocular odometry pipeline: detection + KLT + essential-matrix egomotion
with relative-scale propagation.

The mono analogue of models/pipeline.py — the consumer loop around
``MonoVisualOdometry`` the reference implies (SURVEY.md section 3.5):
translation from an essential matrix is only known up to scale, so each
frame's scale is propagated from the previous frame by comparing distances
between common triangulated points (findRelativeScale,
MonoVisualOdometry.cpp:76-87).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import geometry as geo
from ..ops import image as im
from ..utils.metrics import MetricsLogger
from . import frontend as fe
from .mono_vo import MonoVOParams, MonoVOResult, mono_vo_solve


class MonoPipelineConfig(NamedTuple):
    vo: MonoVOParams
    max_features: int = 500
    klt: fe.KLTConfig = fe.KLTConfig()
    detect_nms_radius: int = 5
    detect_quality: float = 0.01


class MonoFrameOutput(NamedTuple):
    result: MonoVOResult
    matches: jax.Array  # (N, 2, 2)
    valid: jax.Array  # (N,)


@partial(jax.jit, static_argnames=("cfg",))
def mono_vo_step(
    prev_img: jax.Array,
    cur_img: jax.Array,
    key: jax.Array,
    cfg: MonoPipelineConfig,
) -> MonoFrameOutput:
    """One mono frame: detect in prev, KLT to cur, solve essential+pose."""
    feats, _, v0 = im.detect_features(
        prev_img,
        max_features=cfg.max_features,
        quality_level=cfg.detect_quality,
        nms_radius=cfg.detect_nms_radius,
    )
    tracked = fe.klt_track(prev_img, cur_img, feats, v0, cfg.klt)
    matches = jnp.stack([feats, tracked.pts], axis=1)  # (N, 2, 2)
    res = mono_vo_solve(matches, tracked.valid, key, cfg.vo)
    return MonoFrameOutput(result=res, matches=matches, valid=tracked.valid)


class MonoScanOutput(NamedTuple):
    """Stacked per-step outputs of the staged mono scan (device)."""

    R: jax.Array  # (B, 3, 3)
    t: jax.Array  # (B, 3) unit-norm
    success: jax.Array  # (B,)
    n_inliers: jax.Array  # (B,)
    n_matches: jax.Array  # (B,) valid tracked matches into the solver
    rel_scale: jax.Array  # (B,) scale of step i relative to step i-1
    # (rel_scale[0] = 1; findRelativeScale semantics over the structure
    # shared by consecutive two-view reconstructions)


@partial(jax.jit, static_argnames=("cfg", "chunk"))
def mono_sequence_scan(
    ls: jax.Array,  # (n, H, W) staged left frames (uint8 wire or f32)
    keys: jax.Array,  # (g*chunk,) step keys
    cfg: MonoPipelineConfig,
    chunk: int = 8,
) -> MonoScanOutput:
    """Whole mono sequence in ONE dispatch (VERDICT r4 item 4b: the mono
    pipeline gets the staged single-dispatch treatment the stereo path got
    in round 2 — vo_sequence_scan_shared analogue).

    ``lax.map`` walks chunk-sized frame groups; each group converts its
    chunk+1 frames to f32 and builds their KLT pyramids ONCE, shared by the
    adjacent steps. The relative-scale association between consecutive
    steps (the host pipeline's per-frame nearest-neighbor loop,
    findRelativeScale semantics, MonoVisualOdometry.cpp:76-87) runs
    device-side over all step pairs at once.
    """
    from ..ops import image as im

    n = int(ls.shape[0])
    b = n - 1
    gc = int(keys.shape[0])
    assert gc % chunk == 0 and gc >= b
    g = gc // chunk

    pad = gc - b
    if pad:
        ls = jnp.concatenate([ls, jnp.repeat(ls[-1:], pad, axis=0)])
    bases = jnp.arange(g, dtype=jnp.int32) * chunk

    def one_chunk(a):
        base, ks = a
        uf = jax.lax.dynamic_slice_in_dim(ls, base, chunk + 1, axis=0)
        lf = uf.astype(jnp.float32)
        pyr = jax.vmap(
            lambda x: tuple(im.build_pyramid(x, cfg.klt.n_levels))
        )(lf)

        def step(prev, cur, pp, pc, k):
            feats, _, v0 = im.detect_features(
                prev, max_features=cfg.max_features,
                quality_level=cfg.detect_quality,
                nms_radius=cfg.detect_nms_radius,
            )
            tracked = fe.klt_track(prev, cur, feats, v0, cfg.klt,
                                   pyr_prev=pp, pyr_next=pc)
            matches = jnp.stack([feats, tracked.pts], axis=1)
            res = mono_vo_solve(matches, tracked.valid, k, cfg.vo)
            return (res.R, res.t, res.success, res.n_inliers,
                    jnp.sum(tracked.valid), res.pts3d,
                    res.inlier_mask, matches)

        return jax.vmap(step)(
            lf[:-1], lf[1:],
            tuple(p[:-1] for p in pyr), tuple(p[1:] for p in pyr), ks,
        )

    out = jax.lax.map(one_chunk, (bases, keys.reshape(g, chunk)))
    R, t, succ, ninl, nmat, pts3, inl, matches = jax.tree.map(
        lambda x: x.reshape((gc,) + x.shape[2:]), out
    )

    def rel(m_prev, m_cur, inl_prev, inl_cur, p3_prev, p3_cur, R_prev,
            t_prev):
        # previous step's CURRENT-frame track positions vs this step's
        # detections in the same (shared) frame
        prev_pts = m_prev[:, 1]
        cur_pts = m_cur[:, 0]
        d2 = jnp.sum((prev_pts[:, None] - cur_pts[None, :]) ** 2, axis=-1)
        nn = jnp.argmin(d2, axis=1)
        close = jnp.take_along_axis(d2, nn[:, None], axis=1)[:, 0] < 1.0
        mask = close & inl_prev & inl_cur[nn]
        prev_3d = p3_prev @ R_prev.T + t_prev  # shared-frame coords
        cur_3d = p3_cur[nn]
        return geo.relative_scale(prev_3d, cur_3d, mask)

    rel_s = jax.vmap(rel)(
        matches[: b - 1], matches[1:b], inl[: b - 1], inl[1:b],
        pts3[: b - 1], pts3[1:b], R[: b - 1], t[: b - 1],
    )
    rel_s = jnp.concatenate([jnp.ones(1, rel_s.dtype), rel_s])
    return MonoScanOutput(R=R[:b], t=t[:b], success=succ[:b],
                          n_inliers=ninl[:b], n_matches=nmat[:b],
                          rel_scale=rel_s)


def run_mono_staged(
    frames,
    cfg: MonoPipelineConfig,
    seed: int = 0,
    initial_speed: float = 1.0,
    chunk: int = 8,
) -> np.ndarray:
    """Host API for the staged mono engine: (N, 4, 4) cam-to-world chain
    composed in float64, with relative-scale speed propagation and the
    degraded-frame contract (failed step -> keep pose, inherit speed).

    ``solver="hybrid"`` runs here at the ENGINE level: the staged scan runs
    pencil8 throughout, then only the steps whose inlier ratio collapsed
    (or that failed outright) are re-solved with the exact 5-point in
    separate per-step dispatches. The solver-level lax.cond escalation is
    useless inside the scan — under the chunk vmap a cond lowers to select
    and BOTH branches execute for every step, so "hybrid" in-scan would run
    at 5-point speed. Easy sequences therefore pay
    exactly the pencil8 scan; a collapsed step costs one extra dispatch.
    Escalated steps keep the scan's rel_scale estimate (the 5-point re-
    solve replaces the motion, not the scale bookkeeping).
    """
    solver = cfg.vo.solver
    scan_cfg = cfg
    if solver == "hybrid":
        scan_cfg = cfg._replace(vo=cfg.vo._replace(solver="pencil8"))
    stack = np.stack([np.asarray(f) for f in frames])
    ls = jnp.asarray(np.clip(stack, 0, 255).astype(np.uint8))
    n = int(ls.shape[0])
    b = n - 1
    g = -(-b // chunk)
    base_key = jax.random.key(seed)
    keys = jax.vmap(lambda i: jax.random.fold_in(base_key, i))(
        jnp.arange(g * chunk, dtype=jnp.int32)
    )
    out = jax.device_get(mono_sequence_scan(ls, keys, scan_cfg, chunk=chunk))

    if solver == "hybrid":
        need = (~out.success.astype(bool)) | (
            out.n_inliers < cfg.vo.hybrid_ratio * np.maximum(out.n_matches, 1)
        )
        if need.any():
            cfg5 = cfg._replace(vo=cfg.vo._replace(solver="5point"))
            R = np.array(out.R)
            t = np.array(out.t)
            succ = np.array(out.success)
            ninl = np.array(out.n_inliers)
            for i in np.nonzero(need)[0]:
                key5 = jax.random.fold_in(
                    jax.random.fold_in(base_key, int(i)), 5
                )  # same derivation as the solver-level hybrid
                res = jax.device_get(mono_vo_step(
                    ls[i].astype(jnp.float32), ls[i + 1].astype(jnp.float32),
                    key5, cfg5,
                ).result)
                better = (bool(res.success) and not bool(succ[i])) or (
                    bool(res.success) == bool(succ[i])
                    and int(res.n_inliers) > int(ninl[i])
                )
                if better:
                    R[i] = res.R
                    t[i] = res.t
                    succ[i] = res.success
                    ninl[i] = res.n_inliers
            out = out._replace(R=R, t=t, success=succ, n_inliers=ninl)

    pose = np.eye(4)
    traj = [pose.copy()]
    speed = float(initial_speed)
    for i in range(b):
        if bool(out.success[i]):
            if i > 0:
                s = float(out.rel_scale[i])
                if np.isfinite(s) and 0.1 < s < 10.0:
                    speed *= s
            motion = np.eye(4)
            motion[:3, :3] = np.asarray(out.R[i], np.float64)
            motion[:3, 3] = np.asarray(out.t[i], np.float64) * speed
            pose = pose @ np.linalg.inv(motion)
        traj.append(pose.copy())
    return np.asarray(traj)


class MonoOdometryPipeline:
    """Host frame loop: pose chain with relative-scale propagation.

    The first motion's translation is normalized to ``initial_speed`` (mono
    gauge freedom); subsequent frames inherit metric consistency through the
    relative scale of shared triangulated structure."""

    def __init__(self, cfg: MonoPipelineConfig, seed: int = 0,
                 initial_speed: float = 1.0,
                 logger: MetricsLogger | None = None):
        self.cfg = cfg
        self.base_key = jax.random.key(seed)
        self.initial_speed = initial_speed
        self.logger = logger
        self.reset()

    def reset(self):
        self.pose = np.eye(4)
        self.trajectory = [self.pose.copy()]
        self.prev_img = None
        self.prev_out: MonoFrameOutput | None = None
        self.speed = self.initial_speed
        self.frame_idx = 0

    def process_frame(self, img: np.ndarray) -> dict:
        img = jnp.asarray(img, jnp.float32)
        rec: dict = {"frame": self.frame_idx}
        if self.prev_img is not None:
            # keys from GLOBAL step indices (fold_in): the per-frame and
            # staged engines solve each step with the same key (the stereo
            # engines' round-3 consistency lesson applied to mono)
            sub = jax.random.fold_in(self.base_key, self.frame_idx - 1)
            out = mono_vo_step(self.prev_img, img, sub, self.cfg)
            host = jax.device_get(out.result)
            success = bool(host.success)
            if success:
                if self.prev_out is not None:
                    s = self._relative_scale(out)
                    if np.isfinite(s) and 0.1 < s < 10.0:
                        self.speed *= float(s)
                R, t = np.asarray(host.R, np.float64), np.asarray(host.t, np.float64)
                motion = np.eye(4)
                motion[:3, :3] = R
                motion[:3, 3] = t * self.speed
                self.pose = self.pose @ np.linalg.inv(motion)
            rec.update(success=success, n_inliers=int(host.n_inliers))
            self.trajectory.append(self.pose.copy())
            self.prev_out = out
        self.prev_img = img
        self.frame_idx += 1
        if self.logger is not None:
            self.logger.log(**rec)
        return rec

    def _relative_scale(self, out: MonoFrameOutput) -> float:
        """Ratio of distances between common structure in consecutive
        two-view reconstructions (findRelativeScale semantics)."""
        prev = self.prev_out
        # common features: previous step's *current* frame == this step's
        # *previous* frame; match by pixel location of the shared image
        prev_pts = prev.matches[:, 1]  # (N, 2) in shared frame
        cur_pts = out.matches[:, 0]
        d2 = jnp.sum((prev_pts[:, None] - cur_pts[None, :]) ** 2, axis=-1)
        nn = jnp.argmin(d2, axis=1)
        close = jnp.take_along_axis(d2, nn[:, None], axis=1)[:, 0] < 1.0
        mask = (
            close
            & prev.result.inlier_mask
            & out.result.inlier_mask[nn]
        )
        # prev structure is in the shared frame after applying prev motion
        prev_3d = prev.result.pts3d @ prev.result.R.T + prev.result.t
        cur_3d = out.result.pts3d[nn]
        s = geo.relative_scale(prev_3d, cur_3d, mask)
        return float(s)

    def run(self, frames) -> np.ndarray:
        for f in frames:
            self.process_frame(f)
        return np.asarray(self.trajectory)
