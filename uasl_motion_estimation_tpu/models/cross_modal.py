"""Cross-modal metric-scale session: mono VO + MI scale from the baseline.

This is the pipeline the reference's ONLY link-instantiated Optimiser exists
for — ``Optimiser<ScaleState, vector<pair<Mat,Mat>>>``
(reference: src/optimisation/optimisation.cpp:749): a multispectral stereo
rig whose two cameras observe different modalities, so intensity stereo
matching (ZNCC/KLT across the pair) fails and classic stereo VO is
impossible. The session instead:

1. runs MONOCULAR VO on the left camera (essential matrix + cheirality,
   models/mono_vo.py) — egomotion and triangulated structure up to an
   unknown per-step scale (the mono gauge: ||t|| = 1);
2. recovers the METRIC scale of each step from the stereo baseline by
   maximizing per-feature patch mutual information between the two
   modalities (``estimate_scale``, models/scale.py == the reference's
   ScaleState residuals/jacobian, optimisation.cpp:150-228, 436-537);
3. initializes the scale from the MI cross-modal MATCHER (BASELINE
   config 3): the structure points are MI-matched into the right image,
   their disparities give metric depths fu*B/d, and the median
   metric/mono depth ratio seeds the optimiser — a robust starting point
   the LM refinement then polishes (the reference leaves initialization
   to its consumer).

The reference reprojects window features in the LAST frame only
(optimisation.cpp:164-167 ``getLastFrameIdx() == lframe``); this session
does the same with each step's freshly triangulated inlier structure. The
reference additionally carries a second point set from the right camera
with baseline-offset reprojection (optimisation.cpp:199-228); that set is
geometrically symmetric and omitted here — the left-camera structure
already constrains the single scale parameter.

All device work per frame (detect -> KLT -> mono RANSAC -> MI match ->
MI-LM scale) lives in ONE jit.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import geometry as geo
from ..ops import image as im
from ..solvers.lm import StopCondition
from . import frontend as fe
from .mono_vo import MonoVOParams, mono_vo_solve
from .scale import ScaleConfig, estimate_scale


class CrossModalConfig(NamedTuple):
    vo: MonoVOParams  # left-camera mono VO
    scale: ScaleConfig  # MI scale optimiser (shares intr/baseline)
    matcher: fe.MatcherConfig = fe.MatcherConfig()  # MI matcher (s0 init)
    klt: fe.KLTConfig = fe.KLTConfig()
    max_features: int = 500  # TrackingInfo.nb_feats default (file_IO.h:69)
    detect_quality: float = 1e-4
    min_depth: float = 1.0  # structure gate for scale estimation (mono units
    max_depth: float = 60.0  # BEFORE scaling; generous around z~[2, 50])
    # s0 sanity range: the MI-matcher init is rejected outside it and the
    # previous frame's scale (or 1.0) is used instead — the degraded-frame
    # contract applied to scale (MonoVisualOdometry.cpp:47-51 semantics)
    s0_min: float = 0.05
    s0_max: float = 20.0


class CrossModalStep(NamedTuple):
    R: jax.Array  # (3, 3) rotation prev->cur
    t: jax.Array  # (3,) unit-norm translation
    scale: jax.Array  # () refined metric scale (meters per mono unit)
    s0: jax.Array  # () MI-matcher initial scale
    # () bool: the scale estimate is trustworthy — the MI matcher seeded it
    # OR the MI-LM refinement produced an in-range value (when False, the
    # returned scale degenerated to s_prev and consumers should inherit
    # the previous frame's scale)
    s0_valid: jax.Array
    n_init: jax.Array  # () MI matches feeding s0
    n_scale_pts: jax.Array  # () structure points feeding the MI optimiser
    n_inliers: jax.Array  # () mono RANSAC inliers
    vo_success: jax.Array  # () bool
    lm_stop: jax.Array  # () StopCondition of the scale LM
    mi_final: jax.Array  # () mean per-feature MI at the solution


def _session_step(
    prev_left: jax.Array,
    cur_left: jax.Array,
    cur_right: jax.Array,
    key: jax.Array,
    cfg: CrossModalConfig,
    s_prev: jax.Array | float = 1.0,
    pyr_prev: tuple | None = None,
    pyr_cur: tuple | None = None,
) -> CrossModalStep:
    """Session step body (detect -> KLT -> mono VO -> MI-matcher scale init
    -> MI-LM scale refinement); shared by the jitted per-frame step and the
    staged scan (which passes prebuilt left-pyramids)."""
    p = cfg
    intr = p.vo.intr

    # left-camera mono VO (SURVEY.md section 3.2 consumer loop)
    feats, _, v0 = im.detect_features_grid(
        prev_left, max_features=p.max_features, quality_level=p.detect_quality
    )
    tracked = fe.klt_track(prev_left, cur_left, feats, v0, p.klt,
                           pyr_prev=pyr_prev, pyr_next=pyr_cur)
    matches = jnp.stack([feats, tracked.pts], axis=1)
    res = mono_vo_solve(matches, tracked.valid, key, p.vo)

    # structure in the CURRENT frame (the reference's "last keyframe"),
    # mono gauge ||t|| = 1
    X_cur = res.pts3d @ res.R.T + res.t
    z = X_cur[:, 2]
    ok = (
        res.inlier_mask
        & (z > p.min_depth)
        & (z < p.max_depth)
        & jnp.isfinite(X_cur).all(axis=-1)
    )
    uv = geo.project(X_cur, intr)

    # scale init from the MI cross-modal matcher: disparity -> metric depth
    fr, _, mv = fe.match_stereo(
        cur_left, cur_right, uv, ok, p.matcher, use_mi=True
    )
    disp = uv[:, 0] - fr[:, 0]
    z_metric = intr.fu * p.scale.baseline / jnp.maximum(disp, 1e-6)
    ratio = z_metric / jnp.maximum(z, 1e-6)
    ratio_ok = mv & (disp > p.matcher.min_disparity) & jnp.isfinite(ratio)
    n_init = jnp.sum(ratio_ok)
    s0_med = jnp.nanmedian(jnp.where(ratio_ok, ratio, jnp.nan))
    s0_valid = (
        (n_init >= 8)
        & jnp.isfinite(s0_med)
        & (s0_med > p.s0_min)
        & (s0_med < p.s0_max)
    )
    s_prev = jnp.asarray(s_prev, jnp.float32)
    s0 = jnp.where(s0_valid, s0_med, s_prev)

    # MI-LM refinement over the structure (ScaleState.optimise semantics)
    s_ref, lmres = estimate_scale(
        cur_left, cur_right, X_cur, ok, s0, p.scale
    )
    good = jnp.isfinite(s_ref) & (s_ref > p.s0_min) & (s_ref < p.s0_max)
    scale = jnp.where(good, s_ref, s0)

    return CrossModalStep(
        R=res.R, t=res.t, scale=scale, s0=s0, s0_valid=s0_valid | good,
        n_init=n_init, n_scale_pts=jnp.sum(ok), n_inliers=res.n_inliers,
        vo_success=res.success, lm_stop=lmres.stop,
        mi_final=lmres.cost,  # mean per-feature MI (the maximized objective)
    )


@partial(jax.jit, static_argnames=("cfg",))
def cross_modal_step(
    prev_left: jax.Array,
    cur_left: jax.Array,
    cur_right: jax.Array,
    key: jax.Array,
    cfg: CrossModalConfig,
    s_prev: jax.Array | float = 1.0,
) -> CrossModalStep:
    """One frame of the cross-modal session, single dispatch.

    ``s_prev``: previous frame's refined scale — the fallback (and LM warm
    reference) when the MI matcher cannot seed this frame.
    """
    return _session_step(prev_left, cur_left, cur_right, key, cfg, s_prev)


@partial(jax.jit, static_argnames=("cfg", "chunk"))
def cross_modal_sequence_scan(
    ls: jax.Array,  # (n, H, W) staged LEFT frames (uint8 wire or f32)
    rs: jax.Array,  # (n, H, W) staged RIGHT (cross-modal) frames
    keys: jax.Array,  # (g*chunk,) step keys
    cfg: CrossModalConfig,
    chunk: int = 4,
) -> CrossModalStep:
    """Whole cross-modal session in ONE dispatch (staged analogue of the
    mono scan): lax.map over chunk-sized frame groups, left pyramids built
    once per group and shared by adjacent steps, every step's mono VO +
    MI matcher + MI-LM scale solved in vmapped lock-step.

    In-scan steps cannot warm-start from the previous frame's scale (that
    would serialize the vmap); s_prev is fixed at 1.0 and the host replaces
    the (rare) steps whose matcher init AND refinement both failed
    (s0_valid False) with the previous frame's scale — the same degraded
    contract as the per-frame loop.
    """
    n = int(ls.shape[0])
    b = n - 1
    gc = int(keys.shape[0])
    assert gc % chunk == 0 and gc >= b
    g = gc // chunk
    pad = gc - b
    if pad:
        ls = jnp.concatenate([ls, jnp.repeat(ls[-1:], pad, axis=0)])
        rs = jnp.concatenate([rs, jnp.repeat(rs[-1:], pad, axis=0)])
    bases = jnp.arange(g, dtype=jnp.int32) * chunk

    def one_chunk(a):
        base, ks = a
        lf = jax.lax.dynamic_slice_in_dim(ls, base, chunk + 1, axis=0
                                          ).astype(jnp.float32)
        rf = jax.lax.dynamic_slice_in_dim(rs, base, chunk + 1, axis=0
                                          ).astype(jnp.float32)
        pyr = jax.vmap(
            lambda x: tuple(im.build_pyramid(x, cfg.klt.n_levels))
        )(lf)
        return jax.vmap(
            lambda pl, cl, cr, k, pp, pc: _session_step(
                pl, cl, cr, k, cfg, 1.0, pyr_prev=pp, pyr_cur=pc
            )
        )(
            lf[:-1], lf[1:], rf[1:], ks,
            tuple(x[:-1] for x in pyr), tuple(x[1:] for x in pyr),
        )

    out = jax.lax.map(one_chunk, (bases, keys.reshape(g, chunk)))
    out = jax.tree.map(lambda x: x.reshape((gc,) + x.shape[2:]), out)
    return jax.tree.map(lambda x: x[:b], out)


def run_cross_modal_staged(
    frames,
    cfg: CrossModalConfig,
    seed: int = 0,
    chunk: int = 4,
) -> CrossModalResult:
    """Host API for the staged cross-modal engine: one dispatch for the
    whole session, float64 chain composition, degraded-frame contract."""
    pairs = [(np.asarray(l), np.asarray(r)) for l, r in frames]
    ls = jnp.asarray(np.clip(np.stack([p[0] for p in pairs]), 0, 255
                             ).astype(np.uint8))
    rs = jnp.asarray(np.clip(np.stack([p[1] for p in pairs]), 0, 255
                             ).astype(np.uint8))
    n = int(ls.shape[0])
    b = n - 1
    g = -(-b // chunk)
    base_key = jax.random.key(seed)
    keys = jax.vmap(lambda i: jax.random.fold_in(base_key, i))(
        jnp.arange(g * chunk, dtype=jnp.int32)
    )
    out = jax.device_get(cross_modal_sequence_scan(ls, rs, keys, cfg,
                                                   chunk=chunk))

    pose = np.eye(4)
    traj = [pose.copy()]
    scales, s0s, records = [], [], []
    s_prev = 1.0
    for i in range(b):
        scale = float(out.scale[i])
        if not bool(out.s0_valid[i]):  # matcher AND refinement both failed
            scale = s_prev
        if bool(out.vo_success[i]):
            motion = np.eye(4)
            motion[:3, :3] = np.asarray(out.R[i], np.float64)
            motion[:3, 3] = scale * np.asarray(out.t[i], np.float64)
            pose = pose @ np.linalg.inv(motion)
            s_prev = scale
        traj.append(pose.copy())
        scales.append(scale)
        s0s.append(float(out.s0[i]))
        records.append({
            "frame": i + 1,
            "success": bool(out.vo_success[i]),
            "n_inliers": int(out.n_inliers[i]),
            "n_init": int(out.n_init[i]),
            "n_scale_pts": int(out.n_scale_pts[i]),
            "scale": scale,
            "s0": float(out.s0[i]),
            "lm_stop": StopCondition(int(out.lm_stop[i])).name,
        })
    return CrossModalResult(
        trajectory=np.asarray(traj),
        scales=np.asarray(scales),
        s0=np.asarray(s0s),
        records=records,
    )


class CrossModalResult(NamedTuple):
    trajectory: np.ndarray  # (N, 4, 4) cam-to-world METRIC poses
    scales: np.ndarray  # (N-1,) per-step metric scale
    s0: np.ndarray  # (N-1,) MI-matcher inits
    records: list  # per-frame diagnostic dicts


def run_cross_modal(
    frames,
    cfg: CrossModalConfig,
    seed: int = 0,
) -> CrossModalResult:
    """Host session loop: metric trajectory over (left, right) frame pairs
    of a cross-modal rig. Failed frames keep the last pose (degraded-frame
    contract); failed scales inherit the previous scale."""
    base_key = jax.random.key(seed)
    pose = np.eye(4)
    traj = [pose.copy()]
    scales, s0s, records = [], [], []
    prev_left = None
    s_prev = jnp.asarray(1.0, jnp.float32)

    for i, (left, right) in enumerate(frames):
        left = jnp.asarray(left, jnp.float32)
        right = jnp.asarray(right, jnp.float32)
        if prev_left is not None:
            # keys from GLOBAL step indices: the per-frame and staged
            # engines solve each step with the same key
            sub = jax.random.fold_in(base_key, i - 1)
            out = jax.device_get(
                cross_modal_step(prev_left, left, right, sub, cfg,
                                 s_prev=s_prev)
            )
            if bool(out.vo_success):
                motion = np.eye(4)
                motion[:3, :3] = np.asarray(out.R, np.float64)
                motion[:3, 3] = float(out.scale) * np.asarray(
                    out.t, np.float64
                )
                pose = pose @ np.linalg.inv(motion)
                s_prev = jnp.asarray(float(out.scale), jnp.float32)
            traj.append(pose.copy())
            scales.append(float(out.scale))
            s0s.append(float(out.s0))
            records.append({
                "frame": i,
                "success": bool(out.vo_success),
                "n_inliers": int(out.n_inliers),
                "n_init": int(out.n_init),
                "n_scale_pts": int(out.n_scale_pts),
                "scale": float(out.scale),
                "s0": float(out.s0),
                "lm_stop": StopCondition(int(out.lm_stop)).name,
            })
        prev_left = left

    return CrossModalResult(
        trajectory=np.asarray(traj),
        scales=np.asarray(scales),
        s0=np.asarray(s0s),
        records=records,
    )
