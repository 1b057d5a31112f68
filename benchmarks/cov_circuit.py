"""Covariance-circuit artifact (VERDICT r4 item 2): weighted-vs-uniform
stitching under degraded overlap candidates, covariance informativeness on
rendered frames, and the unified engine's emitted pose-covariance chain.

Writes benchmarks/cov_circuit.json and prints it. The engine block runs on
the default backend; the stitching blocks are host math.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def block_weighted_vs_uniform():
    """Controlled experiment: 4 segments, one corrupted overlap candidate
    per boundary with honestly-inflated covariance; weighted fusion must
    hold the downstream gauges where the uniform mean inherits the error."""
    import jax.numpy as jnp

    from uasl_motion_estimation_tpu.ops import lie
    from uasl_motion_estimation_tpu.parallel import stitching

    rng = np.random.default_rng(5)
    s, f, overlap = 4, 8, 2
    n = s * (f - overlap) + overlap
    gt, pose = [], np.eye(4)
    for i in range(n):
        T = np.eye(4)
        T[:3, :3] = np.asarray(lie.so3_exp(jnp.asarray(
            rng.normal(scale=0.02, size=3), jnp.float32)))
        T[:3, 3] = [0.1, 0, 0.8]
        pose = pose @ T
        gt.append(pose.copy())
    gt = np.stack(gt)
    segs = []
    for si in range(s):
        start = si * (f - overlap)
        chunk = gt[start : start + f].copy()
        segs.append(np.linalg.inv(chunk[0]) @ chunk)
    segs = np.stack(segs)
    covs_prev = np.tile(np.eye(6) * 1e-6, (s - 1, overlap, 1, 1))
    covs_next = np.tile(np.eye(6) * 1e-6, (s - 1, overlap, 1, 1))
    for b in range(s - 1):
        d = np.eye(4)
        d[:3, 3] = rng.normal(scale=0.5, size=3)
        segs[b + 1, 1] = segs[b + 1, 1] @ d
        covs_next[b, 1] = np.eye(6)
    w = np.stack([
        stitching.overlap_weights_np(covs_prev[b], covs_next[b])
        for b in range(s - 1)
    ])
    want = np.linalg.inv(gt[0]) @ gt
    out_u = np.asarray(stitching.stitch_segments(
        jnp.asarray(segs, jnp.float32), overlap=overlap))
    out_w = np.asarray(stitching.stitch_segments(
        jnp.asarray(segs, jnp.float32), overlap=overlap,
        overlap_weights=jnp.asarray(w, jnp.float32)))
    err_u = np.linalg.norm(out_u[:, :3, 3] - want[:, :3, 3], axis=-1)
    err_w = np.linalg.norm(out_w[:, :3, 3] - want[:, :3, 3], axis=-1)
    return {
        "segments": s, "overlap": overlap,
        "corrupted_candidates_per_boundary": 1,
        "uniform_max_err_m": round(float(err_u.max()), 4),
        "weighted_max_err_m": round(float(err_w.max()), 4),
        "improvement_x": round(float(err_u.max() / max(err_w.max(), 1e-12)),
                               1),
        "pass_weighted_beats_uniform": bool(err_w.max() < 0.1 * err_u.max()),
    }


def block_informativeness():
    """Rendered frames, destroyed shared overlap frame: the chained VO
    covariance must discriminate the degraded overlap candidates."""
    import jax
    import jax.numpy as jnp

    from uasl_motion_estimation_tpu.models.pipeline import (
        default_config,
        vo_step,
    )
    from uasl_motion_estimation_tpu.ops import geometry as geo
    from uasl_motion_estimation_tpu.parallel import stitching
    from uasl_motion_estimation_tpu.utils.synthetic import (
        CameraRig,
        SyntheticStereoSequence,
    )

    rig = CameraRig(fu=200.0, fv=200.0, cu=80.0, cv=48.0, baseline=0.5,
                    height=96, width=160)
    f, ov = 6, 3
    n = 2 * f - ov
    seq = SyntheticStereoSequence(n_frames=n, rig=rig, seed=6)
    frames = [list(map(np.asarray, seq.frame(i))) for i in range(n)]
    rng = np.random.default_rng(9)
    mid = f - ov + 1
    for cam in (0, 1):
        frames[mid][cam] = np.clip(
            frames[mid][cam] * 0.15
            + rng.normal(scale=60.0, size=frames[mid][cam].shape), 0, 255)
    cfg = default_config(
        geo.Intrinsics(rig.fu, rig.fv, rig.cu, rig.cv), rig.baseline,
        image_shape=(96, 160),
    )._replace(max_features=128)

    def run_segment(start):
        motions, covs = [], []
        for i in range(start, start + f - 1):
            out = vo_step(
                jnp.asarray(frames[i][0], jnp.float32),
                jnp.asarray(frames[i][1], jnp.float32),
                jnp.asarray(frames[i + 1][0], jnp.float32),
                jnp.asarray(frames[i + 1][1], jnp.float32),
                jax.random.key(100 + i), cfg)
            m = np.asarray(out.motion, np.float64)
            if not bool(out.success):
                m = np.eye(4)
            motions.append(m)
            covs.append(np.asarray(out.cov, np.float64))
        return stitching.chain_covariances_np(motions, covs)

    c0 = run_segment(0)
    c1 = run_segment(f - ov)
    w = stitching.overlap_weights_np(c0[f - ov:], c1[:ov])
    return {
        "overlap_weights": [float(x) for x in w],
        "clean_vs_degraded_ratio": round(float(w[0] / max(w[1:].max(),
                                                          1e-12)), 1),
        "clean_candidate_cov_trace": round(
            float(np.trace(c0[f - ov]) + np.trace(c1[0])), 6),
        "pass_discriminates": bool(w[0] > 1e2 * w[1:].max()),
    }


def block_engine_covariances():
    """Unified engine on a 40-frame KITTI-size world: emitted motion/pose
    covariances and the chain's growth."""
    import jax

    from uasl_motion_estimation_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()

    from uasl_motion_estimation_tpu.models.pipeline import default_config
    from uasl_motion_estimation_tpu.models.smoother import (
        SmootherConfig,
        run_unified_system,
    )
    from uasl_motion_estimation_tpu.ops.geometry import Intrinsics
    from uasl_motion_estimation_tpu.utils.synthetic import (
        CameraRig,
        CorruptionConfig,
        SyntheticStereoSequence,
    )

    rig = CameraRig()
    n = 40
    seq = SyntheticStereoSequence(n_frames=n, rig=rig, seed=0,
                                  corruption=CorruptionConfig())
    frames = [seq.frame(i) for i in range(n)]
    cfg = SmootherConfig(pipe=default_config(
        Intrinsics(rig.fu, rig.fv, rig.cu, rig.cv), rig.baseline))
    res = run_unified_system(frames, cfg, seed=1)

    tr_m = np.trace(res.motion_cov, axis1=1, axis2=2)
    tr_p = np.trace(res.pose_cov, axis1=1, axis2=2)
    # covariance plausibility: per-motion translation sigma vs actual
    # per-motion error against GT
    gt = seq.poses
    err_t = []
    for j in range(n - 1):
        # engine convention: m_j maps frame-j points into frame j+1, i.e.
        # m_j = inv(traj[j+1]) @ traj[j] (the world-frame conjugate mixes
        # (I - R_rel) t_world into the translation — review finding)
        m_est = np.linalg.inv(res.traj_ba[j + 1]) @ res.traj_ba[j]
        m_gt = np.linalg.inv(gt[j + 1]) @ gt[j]
        err_t.append(np.linalg.norm(m_est[:3, 3] - m_gt[:3, 3]))
    err_t = np.asarray(err_t)
    sigma_t = np.sqrt(np.trace(res.motion_cov[:, :3, :3], axis1=1, axis2=2))
    return {
        "n_frames": n,
        "motion_cov_trace_median": float(np.median(tr_m)),
        "pose_cov_trace_first": float(tr_p[1]),
        "pose_cov_trace_last": float(tr_p[-1]),
        "pose_cov_positive": bool((tr_p[1:] > 0).all()),
        "pose_cov_growth_x": round(float(tr_p[-1] / max(tr_p[1], 1e-12)), 1),
        "median_motion_t_err_m": round(float(np.median(err_t)), 5),
        "median_motion_t_sigma_m": round(float(np.median(sigma_t)), 5),
        "err_within_3sigma_frac": round(
            float(np.mean(err_t < 3 * np.maximum(sigma_t, 1e-9))), 3),
    }


if __name__ == "__main__":
    result = {
        "weighted_vs_uniform": block_weighted_vs_uniform(),
        "informativeness_rendered": block_informativeness(),
        "engine_covariances": block_engine_covariances(),
    }
    print(json.dumps(result, indent=2))
    out = REPO / "benchmarks" / "cov_circuit.json"
    out.write_text(json.dumps(result, indent=2))
    print(f"wrote {out}")
