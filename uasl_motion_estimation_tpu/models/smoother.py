"""Device-resident integrated system: a unified track table feeding both
per-motion VO and window-parallel BA.

The reference consumer loop maintains ONE set of ``WBA_Point`` feature
tracks that feeds both the per-frame ``StereoVisualOdometry`` solve and the
windowed ``BundleAdjuster`` every ``ba_rate`` frames (reference:
include/MotionEstimation/core/file_IO.h:67-91 TrackingInfo,
feature_types.h:122-197 WBA_Point, BundleAdjuster.h:432-476; SURVEY.md
section 3.5). Run literally, that loop is serial: each window must wait for
the VO chain to reach it (models/odometry.py implements that latency-mode
loop with per-frame host round-trips).

The batched re-design keeps the architecture — one track table, two
consumers — but makes the windows the unit of parallelism:

1. **Window track tables**: windows tile the sequence at stride
   ``ba_rate``; each detects once (its birth frame) and KLT/ZNCC-extends
   through ``window - 1`` frames. Windows are INDEPENDENT, so they vmap;
   the sequential depth is window-1 KLT steps, not n_frames.
2. **Batched VO**: every consecutive-frame motion inside a window is
   solved by the vmapped-RANSAC stereo VO with quad matches read straight
   from the track table — no second front-end (the round-3 system ran
   per-frame detection AND per-window re-tracking, paying ~2x the
   front-end cost of plain VO).
3. **Batched BA**: all windows solve concurrently (vmapped dense-Schur LM,
   solvers/ba.py) initialized from their own VO motions; refined motions
   are installed per-motion under the best-support policy
   (_compose_from_chunks).

All stages are shape-static and live in ONE jit; the host only composes
the final pose chain in float64. ``run_unified_streaming`` wraps the same
scan in super-chunked background uploads for unbounded sequences with
bounded device memory.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import geometry as geo
from ..ops import image as im
from ..ops import lie
from ..solvers.ba import (
    BAConfig,
    BAProblem,
    ba_camera_covariances,
    ba_solve,
    gate_tracks,
)
from . import frontend as fe
from .pipeline import PipelineConfig
from .stereo_vo import stereo_vo_solve


class SmootherConfig(NamedTuple):
    pipe: PipelineConfig
    window: int = 5  # TrackingInfo.window_size default (file_IO.h:69)
    # Window stride in frames (the reference's ba_rate cadence,
    # file_IO.h:70; its default 0 means "consumer-chosen"). Must satisfy
    # ba_rate <= window - 1: in the unified engine EVERY motion is solved by
    # some covering window (there is no separate global VO scan), so a
    # larger stride would leave (stride - window + 1) motions per period
    # with no estimate at all — identity in BOTH traj_vo and traj_ba. The
    # engines enforce this (unified_system_scan / sharded_unified_scan /
    # run_unified_streaming all raise on violation).
    ba_rate: int = 4
    # Fixed frames per window: 1 = pure gauge fixing (stereo BA has metric
    # scale from the baseline, so one anchor suffices); the reference's
    # sequential loop uses 2 (VisualOdometry.h:25) because its windows feed
    # forward into an already-refined chain.
    n_fixed: int = 1
    ba_min_obs: int = 2
    ba_max_iter: int = 25
    huber_delta: float = 1.0  # HuberLoss(1.0), BundleAdjuster.h:447
    # Pre-BA track gate: drop tracks whose worst reprojection residual
    # against the VO-initialized cameras exceeds this (px). The window-level
    # analogue of the reference's RANSAC inlier gate (computeInliers,
    # StereoVisualOdometry.cpp:94-114): tracks on independently moving
    # objects are CONSISTENT with a wrong motion, so Huber down-weighting
    # alone lets them drag the window (measured: BA degraded ATE 0.22->0.34
    # on the corrupted world without this gate).
    track_gate_px: float = 3.0
    # Install a window's refined motion j -> j+1 only when BOTH endpoint
    # frames keep at least this many gated observations. Late window frames
    # are observed only by tracks surviving the whole window; under heavy
    # corruption a tail frame can drop to a handful of noisy tracks whose
    # BA estimate is WORSE than VO (measured: 2-3 deg rotation spikes on
    # exactly the tail motions at KITTI size). The degraded-frame contract
    # (keep the VO motion) applies per-motion here, as the reference keeps
    # its pose when a solve fails (MonoVisualOdometry.cpp:47-51 semantics).
    min_frame_obs: int = 15
    # How window tracks are extended frame-to-frame:
    #   "chain": classic frame-(j-1)->j KLT (the OpenCV consumer-loop
    #     behavior the reference assumes). Drift random-walks with window
    #     position (median 2.5 px by the 5th frame on the corrupted
    #     KITTI-size world) but is near-INDEPENDENT across tracks, so BA
    #     averages it away.
    #   "template": KLT against the track's BIRTH template (window frame 0)
    #     initialized from the chained position. Measured WORSE end-to-end
    #     (ATE-after-BA 0.092 vs 0.056 m at the bench config): forward
    #     motion scales the scene ~4%/frame, and translation-only LK against
    #     a stale template turns that into a drift that is CORRELATED across
    #     tracks — exactly the error component BA cannot average away.
    track_mode: str = "chain"
    # Refined-motion install cap: a BA motion is installed only when it
    # stays within this plausibility radius of the SAME window's VO
    # motion, measured as the approximate image-space displacement
    # fu * (||dt|| / depth + rotation_angle) in PIXELS at the nominal
    # scene depth. Pixel units make the cap resolution-invariant: VO
    # per-motion noise is angular (~1/focal), so a fixed metric cap that
    # is right at KITTI focal lengths (measured VO std ~40 mm) would
    # reject legitimate refinements at lower resolutions. A refinement
    # that wanders beyond this radius from its own init has followed
    # drifted window tails into a different optimum and is almost
    # certainly the wrong one. Validated ate_ba < ate_vo on four 40-frame
    # worlds + the 500-frame world (install-policy ablation, PERF.md):
    # without the cap the 500-frame BA chain is WORSE than VO (2.56 vs
    # 1.94 m, a few giant installed motions dominating); with it, 1.60 m.
    install_disc_px: float = 4.8  # == 0.10 m at KITTI fu/depth
    install_disc_depth_m: float = 15.0  # nominal depth for dt -> px


def _detect_and_match(left, right, cfg: PipelineConfig):
    """Grid-GFTT detection + ZNCC stereo match on one frame (the window's
    birth frame)."""
    feats, _, v0 = im.detect_features_grid(
        left, max_features=cfg.max_features, quality_level=cfg.detect_quality
    )
    f_right, _, sv = fe.match_stereo(left, right, feats, v0, cfg.matcher)
    return feats, f_right, v0 & sv


def _build_window_tracks(
    lf: jax.Array,  # (n, H, W) float32 left frames
    rf: jax.Array,  # (n, H, W) float32 right frames
    starts: jax.Array,  # (K,) int32
    cfg: SmootherConfig,
) -> tuple[jax.Array, jax.Array]:
    """Track tables for K windows at once: detect in each window's first
    frame, then KLT + stereo-match through the remaining window-1 frames.

    vmapped over windows — the analogue of the reference's per-frame
    WBA_Point bookkeeping (feature_types.h:122-197) with the sequential
    dependency confined to the (small, static) window length.

    Returns (obs (K, W, M, 4) [ul,vl,ur,vr], mask (K, W, M) bool). A track's
    mask is monotone: once lost it stays lost (reference tracks are dropped
    on tracking failure the same way).
    """
    p = cfg.pipe
    W = cfg.window

    l0, r0 = lf[starts], rf[starts]  # (K, H, W)
    feats, f_right, valid = jax.vmap(
        lambda a, b: _detect_and_match(a, b, p)
    )(l0, r0)

    obs_slices = [jnp.concatenate([feats, f_right], axis=-1)]  # (K, M, 4)
    mask_slices = [valid]
    pts = feats
    disp = feats[..., 0] - f_right[..., 0]
    pyr0 = jax.vmap(lambda x: tuple(im.build_pyramid(x, p.klt.n_levels)))(l0)
    pyr_prev = pyr0

    for j in range(1, W):
        lj, rj = lf[starts + j], rf[starts + j]
        pyr_cur = jax.vmap(
            lambda x: tuple(im.build_pyramid(x, p.klt.n_levels))
        )(lj)
        if cfg.track_mode == "template":
            # anchor on the birth template; the chained position from the
            # previous frame seeds the solve so only the incremental motion
            # must converge (see SmootherConfig.track_mode)
            tracked = jax.vmap(
                lambda ip, inx, f0, v, guess, pp, pc: fe.klt_track(
                    ip, inx, f0, v, p.klt, init_next=guess,
                    pyr_prev=pp, pyr_next=pc
                )
            )(l0, lj, feats, valid, pts, pyr0, pyr_cur)
        else:
            tracked = jax.vmap(
                lambda ip, inx, pt, v, pp, pc: fe.klt_track(
                    ip, inx, pt, v, p.klt, pyr_prev=pp, pyr_next=pc
                )
            )(l0, lj, pts, valid, pyr_prev, pyr_cur)
        fr, _, sv = jax.vmap(
            lambda a, b, f, v, d: fe.match_stereo(
                a, b, f, v, p.matcher, d_prior=d
            )
        )(lj, rj, tracked.pts, tracked.valid, disp)
        valid = valid & tracked.valid & sv
        obs_slices.append(jnp.concatenate([tracked.pts, fr], axis=-1))
        mask_slices.append(valid)
        pts = tracked.pts
        disp = tracked.pts[..., 0] - fr[..., 0]
        pyr_prev = pyr_cur

    obs = jnp.stack(obs_slices, axis=1)  # (K, W, M, 4)
    mask = jnp.stack(mask_slices, axis=1)  # (K, W, M)
    return obs, mask


def _inv_se3(T: jax.Array) -> jax.Array:
    """Closed-form SE(3) inverse (cheaper and better-conditioned than a
    general 4x4 inverse)."""
    R = T[:3, :3]
    out = jnp.eye(4, dtype=T.dtype)
    out = out.at[:3, :3].set(R.T)
    return out.at[:3, 3].set(-R.T @ T[:3, 3])


def _cam6_from_T(T: jax.Array) -> jax.Array:
    return jnp.concatenate([lie.so3_log(T[:3, :3]), T[:3, 3]])


def _T_from_cam6(c: jax.Array) -> jax.Array:
    T = jnp.eye(4, dtype=c.dtype)
    T = T.at[:3, :3].set(lie.so3_exp(c[:3]))
    return T.at[:3, 3].set(c[3:6])


def _init_window_problem_local(
    motions_local: jax.Array,  # (W-1, 4, 4) step motions inside the window
    obs: jax.Array,  # (W, M, 4)
    mask: jax.Array,  # (W, M)
    cfg: SmootherConfig,
) -> BAProblem:
    """BAProblem for one window in the window-frame-0 gauge: cams chained
    from the window-local motions, points triangulated from the birth-frame
    disparity (project3D semantics, StereoVisualOdometry.cpp:22-32)."""
    W = cfg.window
    p = cfg.pipe.vo
    # fenced: chaining up to W-1 4x4 products at a reduced (bf16-pass)
    # precision puts ~0.01 rad of noise on the init rotations — ~7 px of
    # systematic reprojection shift at KITTI focal lengths, which the 3-px
    # track gate below then turns into mass misclassification
    with jax.default_matmul_precision("highest"):
        cams = [jnp.zeros(6, motions_local.dtype)]
        T = jnp.eye(4, dtype=motions_local.dtype)
        for j in range(1, W):
            T = motions_local[j - 1] @ T
            cams.append(_cam6_from_T(T))
        cam0 = jnp.stack(cams)  # (W, 6) world(=frame0)->cam
    pts = geo.triangulate_disparity(
        obs[0, :, 0:2], obs[0, :, 2:4], p.intr1, p.intr2, p.baseline
    )  # (M, 3) in frame-0 camera coords == gauge world
    keep = mask[0] & (jnp.sum(mask, axis=0) >= cfg.ba_min_obs)

    # track gate vs the VO-chained init (see SmootherConfig.track_gate_px)
    gate_cfg = BAConfig(intr=p.intr1, baseline=float(p.baseline))
    keep = keep & gate_tracks(cam0, pts, obs, mask, gate_cfg,
                              cfg.track_gate_px)
    return BAProblem(cam=cam0, pts=pts, obs=obs, mask=mask & keep[None, :])


def _init_window_problem(
    motions: jax.Array,  # (B, 4, 4) step motions (prev->cur), VO chain
    start: jax.Array,  # () int32 window start frame
    obs: jax.Array,  # (W, M, 4)
    mask: jax.Array,  # (W, M)
    cfg: SmootherConfig,
) -> BAProblem:
    """_init_window_problem_local over a slice of the global VO chain."""
    local = jax.lax.dynamic_slice_in_dim(motions, start, cfg.window - 1, 0)
    return _init_window_problem_local(local, obs, mask, cfg)


class FullSystemResult(NamedTuple):
    traj_vo: np.ndarray  # (N, 4, 4) cam-to-world, VO chain only
    traj_ba: np.ndarray  # (N, 4, 4) cam-to-world, BA-refined
    per_frame: np.ndarray  # (B, 20) packed VO stats
    ba_cost: np.ndarray  # (K,)
    ba_converged: np.ndarray  # (K,)
    n_track_obs: np.ndarray  # (K,)
    # per-INSTALLED-motion covariance ([dt, dtheta] tangent): BA motion
    # covariance where a refinement was installed, VO solve covariance
    # otherwise (B, 6, 6)
    motion_cov: np.ndarray
    # per-frame pose covariance along traj_ba, chained in float64 with the
    # adjoint transport of ops/geometry (the reference's CamPose-chain
    # covariance calculus, feature_types.cpp:172-241) (N, 6, 6)
    pose_cov: np.ndarray


# ---------------------------------------------------------------------------
# Unified track-table engine (round 4)
# ---------------------------------------------------------------------------
#
# The scan above runs TWO front-ends: the VO scan detects + tracks + matches
# in every frame, then the window stage re-detects and re-tracks its own
# table — the round-3 integrated system paid ~2x the front-end cost of plain
# VO. The reference's consumer
# never does that: ONE WBA_Point track table feeds BOTH the per-frame VO
# solve and the windowed BundleAdjuster (SURVEY.md section 3.5; WBA_Point,
# feature_types.h:122-197). The unified engine is that architecture,
# batched:
#
#   * windows tile the sequence at stride ba_rate; each window detects once
#     (its birth frame) and KLT/ZNCC-extends through window-1 frames;
#   * each consecutive-frame motion inside a window is solved by the SAME
#     vmapped-RANSAC stereo VO, with its quad matches read straight from the
#     track table (obs[j], obs[j+1]) instead of a fresh detect+track;
#   * BA initializes from those VO motions and refines the window.
#
# Per ba_rate=4 frames this costs 1 detection instead of 5, one pyramid per
# frame, and one stereo match per frame instead of two. RANSAC keys derive from the global motion index (fold_in), so
# overlapping windows and streaming/staged runs solve identical problems.


def unified_window_starts(
    n_frames: int, window: int, stride: int
) -> np.ndarray:
    """Window starts tiling every motion: 0, stride, ... with a final window
    clamped to n_frames - window so the sequence tail is always covered.
    Requires stride <= window - 1 for full motion coverage."""
    if n_frames < window:
        return np.zeros((0,), np.int32)
    starts = list(range(0, n_frames - window + 1, stride))
    if starts[-1] != n_frames - window:
        starts.append(n_frames - window)
    return np.asarray(starts, np.int32)


class UnifiedOutput(NamedTuple):
    vo_motions: jax.Array  # (K, W-1, 4, 4) per-window VO step motions
    vo_success: jax.Array  # (K, W-1) bool
    vo_n_matches: jax.Array  # (K, W-1) int32
    vo_n_inliers: jax.Array  # (K, W-1) int32
    vo_err: jax.Array  # (K, W-1) mean reprojection error
    refined_motions: jax.Array  # (K, W-1, 4, 4) BA-refined
    ba_cost: jax.Array  # (K,)
    ba_converged: jax.Array  # (K,)
    n_track_obs: jax.Array  # (K,)
    n_frame_obs: jax.Array  # (K, W) gated observations per window frame
    # Covariance outputs (VERDICT r4 item 2 — the covariance calculus
    # driven end-to-end):
    vo_cov: jax.Array  # (K, W-1, 6, 6) VO motion covariances ([dt, dtheta])
    cam_cov: jax.Array  # (K, W, 6, 6) BA camera covariances (cam6 params,
    # extract_covariance parity, BundleAdjuster.h:478-528; gauge frame = 0)
    ba_motion_cov: jax.Array  # (K, W-1, 6, 6) refined-motion covariances
    # ([dt, dtheta] tangent; independent-camera first-order contraction)


def _motion_covs_from_cam_covs(cam: jax.Array, cam_cov: jax.Array
                               ) -> jax.Array:
    """(W, 6) cam params + (W, 6, 6) camera covariances -> (W-1, 6, 6)
    covariances of the step motions m_j = T_{j+1} T_j^{-1} on the
    [dt, dtheta] right tangent.

    First-order contraction with an autodiff jacobian of the motion wrt
    BOTH endpoint cameras' parameters, treating the cameras as independent
    (the reduced camera system correlates neighboring cameras positively,
    so this overestimates — conservative for downstream weighting). The
    reference emits per-camera covariances only (extract_covariance) and
    leaves motion covariance to its consumer's CamPose calculus
    (feature_types.cpp:172-241); this is that step, on-device."""

    def one(c_j, c_j1, C_j, C_j1):
        m0 = _T_from_cam6(c_j1) @ _inv_se3(_T_from_cam6(c_j))
        m0_inv = _inv_se3(m0)

        def delta(d):
            mm = (_T_from_cam6(c_j1 + d[6:])
                  @ _inv_se3(_T_from_cam6(c_j + d[:6])))
            dM = m0_inv @ mm
            return jnp.concatenate([dM[:3, 3], lie.so3_log(dM[:3, :3])])

        J = jax.jacfwd(delta)(jnp.zeros(12, cam.dtype))
        return (J[:, :6] @ C_j @ J[:, :6].T
                + J[:, 6:] @ C_j1 @ J[:, 6:].T)

    return jax.vmap(one)(cam[:-1], cam[1:], cam_cov[:-1], cam_cov[1:])


def unified_solve_group(
    lf: jax.Array,  # (n, H, W) float32 frames
    rf: jax.Array,
    start_group: jax.Array,  # (k,) int32 window starts
    base_key: jax.Array,
    index_offset,
    cfg: SmootherConfig,
) -> tuple:
    """Solve one group of windows end-to-end: track tables -> per-motion VO
    -> batched BA -> fenced refined-motion composition.

    The shared core of unified_system_scan (lax.map over groups) and the
    multi-chip window-parallel engine (parallel/unified.py shard_map over
    devices). Returns the UnifiedOutput field tuple for the group."""
    W = cfg.window
    ba_cfg = BAConfig(
        intr=cfg.pipe.vo.intr1,
        baseline=float(cfg.pipe.vo.baseline),
        n_fixed=cfg.n_fixed,
        max_iter=cfg.ba_max_iter,
        huber_delta=cfg.huber_delta,
    )
    eye4 = jnp.eye(4, dtype=jnp.float32)

    obs, mask = _build_window_tracks(lf, rf, start_group, cfg)
    # quad matches for motion j: prev = frame j, cur = frame j+1
    # ((N,4,2) [prevL, prevR, curL, curR], StereoOdoMatches layout)
    quv = jnp.stack(
        [obs[:, :-1, :, 0:2], obs[:, :-1, :, 2:4],
         obs[:, 1:, :, 0:2], obs[:, 1:, :, 2:4]],
        axis=-2,
    )  # (k, W-1, M, 4, 2)
    qvalid = mask[:, 1:]  # monotone: valid at j+1 implies valid at j
    # RANSAC keys from the GLOBAL motion index: overlapping windows and
    # streaming/staged engines solve bit-identical problems
    midx = (jnp.asarray(index_offset, jnp.int32) + start_group[:, None]
            + jnp.arange(W - 1, dtype=jnp.int32))
    keys = jax.vmap(jax.vmap(
        lambda i: jax.random.fold_in(base_key, i)
    ))(midx)
    vo = jax.vmap(jax.vmap(
        lambda m, v, ky: stereo_vo_solve(m, v, ky, cfg.pipe.vo)
    ))(quv, qvalid, keys)
    motions_local = jnp.where(
        vo.success[..., None, None], vo.motion, eye4
    )  # degraded contract: failed motion -> identity
    problems = jax.vmap(
        lambda m, o, msk: _init_window_problem_local(m, o, msk, cfg)
    )(motions_local, obs, mask)
    res = jax.vmap(lambda pr: ba_solve(pr, ba_cfg))(problems)
    # covariance outputs at the solved cameras (extract_covariance parity)
    solved = problems._replace(cam=res.cam, pts=res.pts)
    cam_cov = jax.vmap(lambda pr: ba_camera_covariances(pr, ba_cfg))(solved)
    ba_motion_cov = jax.vmap(_motion_covs_from_cam_covs)(res.cam, cam_cov)
    # refined window motions m_j = T_{j+1} @ inv(T_j). MUST be fenced
    # to full f32: default bf16-pass 4x4 matmuls put ~0.1-0.2 deg of
    # spurious rotation per motion on an exactly-converged BA solution
    # (the round-3 ATE regression, root-caused round 4)
    with jax.default_matmul_precision("highest"):
        Ts = jax.vmap(jax.vmap(_T_from_cam6))(res.cam)
        ref = jnp.einsum(
            "kwij,kwjl->kwil",
            Ts[:, 1:],
            jax.vmap(jax.vmap(_inv_se3))(Ts[:, :-1]),
        )
    n_obs = jnp.sum(problems.mask, axis=(1, 2)).astype(jnp.int32)
    n_frame = jnp.sum(problems.mask, axis=2).astype(jnp.int32)
    return (
        motions_local, vo.success,
        jnp.sum(qvalid, axis=-1).astype(jnp.int32), vo.n_inliers,
        vo.mean_reproj_error, ref, res.cost, res.converged, n_obs,
        n_frame, vo.cov, cam_cov, ba_motion_cov,
    )


@partial(jax.jit, static_argnames=("cfg", "wchunk"))
def unified_system_scan(
    ls: jax.Array,  # (n, H, W) staged frames (uint8 wire format or f32)
    rs: jax.Array,
    base_key: jax.Array,
    cfg: SmootherConfig,
    wchunk: int = 4,  # windows per lax.map group (bounds peak memory)
    index_offset: jax.Array | int = 0,  # global index of frame ls[0]
) -> UnifiedOutput:
    """One-dispatch integrated system on a single track table per window:
    detect -> track/match -> per-motion VO -> windowed BA.

    ``index_offset`` shifts the RANSAC key derivation to GLOBAL motion
    indices, so a long sequence processed in streaming super-chunks
    (run_unified_streaming) solves bit-identical per-motion problems to the
    same sequence staged whole."""
    if cfg.ba_rate > cfg.window - 1:
        raise ValueError(
            "unified engine needs ba_rate <= window-1 for full motion "
            f"coverage (got ba_rate={cfg.ba_rate}, window={cfg.window}); "
            "larger strides would leave uncovered motions as identity")
    n = int(ls.shape[0])
    W = cfg.window
    starts_np = unified_window_starts(n, W, cfg.ba_rate)
    k = len(starts_np)
    if k == 0:
        z0 = jnp.zeros((0, W - 1), jnp.float32)
        z4 = jnp.zeros((0, W - 1, 4, 4), jnp.float32)
        zk = jnp.zeros((0,), jnp.float32)
        z6 = jnp.zeros((0, W - 1, 6, 6), jnp.float32)
        return UnifiedOutput(
            z4, z0.astype(bool), z0.astype(jnp.int32), z0.astype(jnp.int32),
            z0, z4, zk, zk.astype(bool), zk.astype(jnp.int32),
            jnp.zeros((0, W), jnp.int32),
            z6, jnp.zeros((0, W, 6, 6), jnp.float32), z6,
        )
    g = -(-k // wchunk)
    starts = jnp.asarray(
        np.concatenate([starts_np, np.full(g * wchunk - k, starts_np[-1],
                                           np.int32)])
    )

    lf = ls.astype(jnp.float32)
    rf = rs.astype(jnp.float32)

    groups = starts.reshape(g, wchunk)
    outs = jax.lax.map(
        lambda sg: unified_solve_group(lf, rf, sg, base_key, index_offset,
                                       cfg),
        groups,
    )
    unpad = lambda x: x.reshape((g * wchunk,) + x.shape[2:])[:k]
    return UnifiedOutput(*(unpad(x) for x in outs))


def _compose_from_chunks(
    chunks: list[tuple[UnifiedOutput, np.ndarray, int]],
    n_frames: int,
    cfg: SmootherConfig,
) -> FullSystemResult:
    """Shared host-side float64 composition for the unified engine.

    ``chunks``: (output, global window starts (K,), frames valid through)
    triples — one for the staged scan, several for the streaming engine.

    Install policy is BEST-SUPPORT + DISCREPANCY CAP: when several windows
    cover a motion (stride < window-1, the clamped tail window, or
    streaming-chunk padding), each motion takes the covering window with
    the most OBSERVATION SUPPORT — VO by RANSAC inlier count, BA by the
    smaller of the two endpoint frames' gated track counts. Track age
    alone is the wrong arbiter: chained-KLT drift does grow with age, but
    a window born on a bad frame (occluder sweep) offers a young estimate
    from a starved table — measured at bench scale, min-age install
    DOUBLED the VO ATE by preferring 21-track age-0 solves over 80-track
    age-2 ones (install-policy ablation, PERF.md). A BA install additionally
    requires (a) min_frame_obs gated observations at both endpoint frames
    (degraded contract, MonoVisualOdometry.cpp:47-51 semantics) and (b)
    the refined motion to stay within the install_disc_px pixel-equivalent
    plausibility radius of its own window's VO motion (see
    SmootherConfig.install_disc_px), else the installed VO motion stands.
    Validated ate_ba < ate_vo on four 40-frame worlds and the 500-frame
    world."""
    b = n_frames - 1
    W = cfg.window
    motions = np.tile(np.eye(4), (b, 1, 1))
    packed = np.zeros((b, 20), np.float32)
    # installed-motion covariances: start at the uninformative prior the
    # failed-solve contract uses (StereoVOResult.cov semantics)
    motion_cov = np.tile(np.eye(6) * 1e2, (b, 1, 1))
    # Support key of the installed VO motion: (success, inliers). Success
    # leads — a failed solve's motion was already replaced with identity
    # (unified_solve_group degraded contract), so a high-inlier FAILED
    # window must never out-compete an overlapping successful one (it
    # would install identity where a valid estimate exists); among equal
    # success, more RANSAC inliers wins.
    best_vo = [(-1, -1)] * b
    # BA candidates per motion: (endpoint support, refined, window VO, cov)
    ba_cands: dict[int, list] = {}
    ba_cost, ba_conv, n_track = [], [], []

    for out, g_starts, n_valid in chunks:
        vo_m = np.asarray(out.vo_motions, np.float64)
        refined = np.asarray(out.refined_motions, np.float64)
        nfo = np.asarray(out.n_frame_obs)
        succ = np.asarray(out.vo_success)
        n_matches = np.asarray(out.vo_n_matches)
        n_inliers = np.asarray(out.vo_n_inliers)
        vo_err = np.asarray(out.vo_err)
        vo_cov = np.asarray(out.vo_cov, np.float64)
        ba_mcov = np.asarray(out.ba_motion_cov, np.float64)
        for i, s in enumerate(g_starts):
            for j in range(W - 1):
                m = s + j
                if m >= b or s + j + 1 >= n_valid:
                    continue  # padding / beyond the real sequence
                key = (int(succ[i, j]), int(n_inliers[i, j]))
                if key > best_vo[m]:
                    best_vo[m] = key
                    motions[m] = vo_m[i, j]
                    motion_cov[m] = vo_cov[i, j]
                    packed[m, :16] = vo_m[i, j].reshape(16)
                    packed[m, 16] = float(succ[i, j])
                    packed[m, 17] = float(n_matches[i, j])
                    packed[m, 18] = float(n_inliers[i, j])
                    packed[m, 19] = float(vo_err[i, j])
                support = int(min(nfo[i, j], nfo[i, j + 1]))
                if support >= cfg.min_frame_obs:
                    ba_cands.setdefault(m, []).append(
                        (support, refined[i, j], vo_m[i, j], ba_mcov[i, j])
                    )
        ba_cost.append(np.asarray(out.ba_cost))
        ba_conv.append(np.asarray(out.ba_converged))
        n_track.append(np.asarray(out.n_track_obs))

    fu = float(cfg.pipe.vo.intr1.fu)

    def discrepancy_px(a, b_):
        dt = np.linalg.norm(a[:3, 3] - b_[:3, 3])
        Rr = a[:3, :3].T @ b_[:3, :3]
        ang = np.arccos(np.clip((np.trace(Rr) - 1.0) / 2.0, -1.0, 1.0))
        return fu * (dt / cfg.install_disc_depth_m + ang)

    motions_ba = motions.copy()
    motion_cov_ba = motion_cov.copy()
    for m, cands in ba_cands.items():
        for _, ref, win_vo, mcov in sorted(cands, key=lambda c: -c[0]):
            if discrepancy_px(ref, win_vo) <= cfg.install_disc_px:
                motions_ba[m] = ref
                motion_cov_ba[m] = mcov
                break

    def chain(ms):
        traj = np.empty((n_frames, 4, 4))
        traj[0] = np.eye(4)
        for i in range(b):
            traj[i + 1] = traj[i] @ np.linalg.inv(ms[i])
        return traj

    from ..parallel.stitching import chain_covariances_np

    return FullSystemResult(
        traj_vo=chain(motions),
        traj_ba=chain(motions_ba),
        per_frame=packed,
        ba_cost=np.concatenate(ba_cost),
        ba_converged=np.concatenate(ba_conv),
        n_track_obs=np.concatenate(n_track),
        motion_cov=motion_cov_ba,
        pose_cov=chain_covariances_np(motions_ba, motion_cov_ba),
    )


def compose_unified(
    out: UnifiedOutput, n_frames: int, cfg: SmootherConfig
) -> FullSystemResult:
    """Host-side composition of one staged unified_system_scan output."""
    starts = unified_window_starts(n_frames, cfg.window, cfg.ba_rate)
    return _compose_from_chunks([(out, starts, n_frames)], n_frames, cfg)


def run_unified_system(
    frames: list[tuple[np.ndarray, np.ndarray]],
    cfg: SmootherConfig,
    seed: int = 0,
    wchunk: int = 4,
) -> FullSystemResult:
    """Convenience host API for the unified track-table engine."""
    n = len(frames)
    ls = jnp.asarray(
        np.clip(np.stack([f[0] for f in frames]), 0, 255).astype(np.uint8)
    )
    rs = jnp.asarray(
        np.clip(np.stack([f[1] for f in frames]), 0, 255).astype(np.uint8)
    )
    out = unified_system_scan(
        ls, rs, jax.random.key(seed), cfg, wchunk=wchunk
    )
    return compose_unified(jax.device_get(out), n, cfg)


def run_unified_streaming(
    frames,
    cfg: SmootherConfig,
    seed: int = 0,
    wchunk: int = 4,
    groups: int = 2,  # lax.map groups per super-chunk
    prefetch: int = 2,
    stats: dict | None = None,
    start_frame: int = 0,
) -> FullSystemResult:
    """Streaming integrated system: VO + windowed BA over an UNBOUNDED
    frame iterable with bounded device memory and upload/compute overlap.

    Composes the two round-3 flagships (VERDICT r3 item 4): the streaming
    engine's background-thread async uploads (pipeline.run_streaming
    semantics) around the unified track-table system. Frames are grouped
    into fixed-shape super-chunks of ``groups * wchunk`` windows; window
    spans overlap super-chunk boundaries by ``window - ba_rate`` frames
    (carried on the host), so window-track state never crosses a boundary
    — the boundary IS a window start, matching the reference consumer's
    BA cadence over a streaming ImageReader loop (file_IO.h:300-421).
    Device memory: at most ``prefetch + 1`` uint8 super-chunks plus one
    wchunk group's working set, independent of sequence length. The tail
    super-chunk pads by repeating the final frame (identity motions into
    padding; never installed).

    RANSAC keys derive from GLOBAL motion indices (fold_in), so the result
    is motion-for-motion identical to unified_system_scan on the staged
    whole sequence.

    CHECKPOINT/RESUME: ``start_frame`` (a multiple of the super-chunk
    advance ``groups * wchunk * ba_rate``) resumes an interrupted session:
    feed the frames from ``start_frame`` onward and the engine processes
    exactly the super-chunks the unbroken run would have from that point —
    same window starts, same global keys, bit-identical solves. The
    returned result is RELATIVE to ``start_frame`` (its traj[0] is
    identity); chain it onto the prior partial result with
    ``merge_unified_results``. With the default stride == window-1 the
    merge reproduces the unbroken run exactly (no motions span the
    boundary); with smaller strides the few boundary motions may install
    from a different (equally valid) covering window.

    Returns the composed FullSystemResult over the real frames.
    """
    import queue
    import threading
    import time as _time

    W = cfg.window
    stride = cfg.ba_rate
    if stride > W - 1:
        raise ValueError("streaming unified engine needs ba_rate <= window-1"
                         " for full motion coverage")
    n_win = groups * wchunk
    span = (n_win - 1) * stride + W  # frames per super-chunk
    advance = n_win * stride  # frames consumed per super-chunk
    overlap = span - advance  # frames carried to the next super-chunk
    if start_frame % advance != 0:
        raise ValueError(
            f"start_frame must be a super-chunk boundary (multiple of "
            f"{advance}), got {start_frame}")

    q: queue.Queue = queue.Queue(maxsize=prefetch)
    if stats is not None:
        stats.setdefault("upload_s", [])
        stats.setdefault("upload_bytes", [])

    def to_u8(f):
        return np.clip(np.asarray(f), 0, 255).astype(np.uint8)

    def put_stack(stack, offset, n_real):
        t0 = _time.perf_counter()
        ls = jax.device_put(np.stack([x[0] for x in stack]))
        rs = jax.device_put(np.stack([x[1] for x in stack]))
        if stats is not None:
            jax.block_until_ready((ls, rs))
            stats["upload_s"].append(_time.perf_counter() - t0)
            stats["upload_bytes"].append(ls.nbytes + rs.nbytes)
        q.put((ls, rs, offset, n_real))

    def uploader():
        buf: list[tuple[np.ndarray, np.ndarray]] = []
        offset = start_frame  # global index of buf[0]
        try:
            for f in frames:
                buf.append((to_u8(f[0]), to_u8(f[1])))
                if len(buf) == span:
                    put_stack(buf, offset, span)
                    buf = buf[advance:]
                    offset += advance
            if len(buf) > overlap or (offset == start_frame and len(buf) > 1):
                n_real = len(buf)
                buf = buf + [buf[-1]] * (span - len(buf))
                put_stack(buf, offset, n_real)
        except BaseException as e:
            q.put(e)
            return
        q.put(None)

    t = threading.Thread(target=uploader, daemon=True)
    t.start()

    base_key = jax.random.key(seed)
    results: list[tuple[UnifiedOutput, int, int]] = []
    while True:
        item = q.get()
        if item is None:
            break
        if isinstance(item, BaseException):
            raise item
        ls, rs, offset, n_real = item
        out = unified_system_scan(
            ls, rs, base_key, cfg, wchunk=wchunk, index_offset=offset
        )
        results.append((out, offset, n_real))
    t.join()

    if not results:
        return FullSystemResult(
            traj_vo=np.eye(4)[None], traj_ba=np.eye(4)[None],
            per_frame=np.zeros((0, 20), np.float32),
            ba_cost=np.zeros(0), ba_converged=np.zeros(0, bool),
            n_track_obs=np.zeros(0, np.int32),
            motion_cov=np.zeros((0, 6, 6)),
            pose_cov=np.zeros((1, 6, 6)),
        )

    # compose RELATIVE to start_frame (keys stayed global via index_offset)
    n_frames = results[-1][1] + results[-1][2] - start_frame
    local_starts = unified_window_starts(span, W, stride)
    chunks = [
        (jax.device_get(out_dev), offset - start_frame + local_starts,
         offset - start_frame + n_real)
        for out_dev, offset, n_real in results
    ]
    return _compose_from_chunks(chunks, n_frames, cfg)


def merge_unified_results(
    a: FullSystemResult, b: FullSystemResult, at: int | None = None
) -> FullSystemResult:
    """Chain a resumed streaming result onto the partial result it resumes:
    ``b`` came from run_unified_streaming(start_frame=at) and is RELATIVE
    to frame ``at`` (its traj[0] is identity). ``at`` defaults to the last
    frame of ``a``; pass it explicitly when ``a`` extends past the resume
    boundary (a partial run's final super-chunk covers ``window - ba_rate``
    frames beyond its advance point)."""
    if at is None:
        at = a.traj_vo.shape[0] - 1

    def chain(ta, tb):
        return np.concatenate([ta[: at + 1], ta[at] @ tb[1:]])

    # transport b's pose covariances (relative to its own gauge, zero at
    # frame 0) past a's boundary covariance: C = Ad(Tb^-1) C_at Ad^T + C_b
    from ..ops.geometry import se3_adjoint_np

    C_at = a.pose_cov[at]
    cov_tail = np.empty((b.pose_cov.shape[0] - 1, 6, 6))
    for k in range(1, b.pose_cov.shape[0]):
        Ad = se3_adjoint_np(np.linalg.inv(b.traj_ba[k]))
        cov_tail[k - 1] = Ad @ C_at @ Ad.T + b.pose_cov[k]

    return FullSystemResult(
        traj_vo=chain(a.traj_vo, b.traj_vo),
        traj_ba=chain(a.traj_ba, b.traj_ba),
        per_frame=np.concatenate([a.per_frame[:at], b.per_frame]),
        ba_cost=np.concatenate([a.ba_cost, b.ba_cost]),
        ba_converged=np.concatenate([a.ba_converged, b.ba_converged]),
        n_track_obs=np.concatenate([a.n_track_obs, b.n_track_obs]),
        motion_cov=np.concatenate([a.motion_cov[:at], b.motion_cov]),
        pose_cov=np.concatenate([a.pose_cov[: at + 1], cov_tail]),
    )
