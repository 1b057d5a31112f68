"""Config-4 integrated-system benchmark (VERDICT r2 item 1, r3 items 1/5/9).

The measured full system is the round-5 UNIFIED track-table engine
(models/smoother.py unified_system_scan): one detection per window feeds
both the per-motion vmapped-RANSAC VO and the batched dense-Schur BA —
the reference consumer's one-track-table architecture (WBA_Point,
feature_types.h:122-197; consumer loop SURVEY.md section 3.5) with windows
as the unit of parallelism. Device-resident at the headline configuration
(KITTI-size 376x1241, 500 features) on the CORRUPTED world (photometric
gain/bias/noise + moving objects + occluder) so the BA refinement and
robust gates are exercised where they matter.

Reports: full-system fps (one dispatch, device_get-fenced), the round-3
style VO-only pipeline fps on the same frames for comparison, ATE of both
chains (BA must be lower), and the per-frame inlier-ratio trace with the
degraded-frame policy applied. The artifact is self-describing:
``pass_ate_gate`` / ``pass_fps_gate`` record whether the run met its own
acceptance criteria (round-3 advisor: a failing run must not publish an
artifact indistinguishable from a passing one). Writes
benchmarks/full_system.json.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

N_FRAMES = int(os.environ.get("BENCH_FRAMES", "40"))
CHUNK = int(os.environ.get("BENCH_CHUNK", "13"))  # VO-only comparison scan
WCHUNK = int(os.environ.get("BENCH_WCHUNK", "5"))
REPS = int(os.environ.get("BENCH_REPS", "3"))
# degraded-frame floor: frames solving on fewer inliers than this fraction
# of their matches are flagged in the trace (the reference's contract is
# "keep last pose" on failure, MonoVisualOdometry.cpp:47-51; the VO solver
# already gates hard failure — this floor makes near-failures observable)
INLIER_FLOOR = float(os.environ.get("BENCH_INLIER_FLOOR", "0.15"))


def main():
    import jax

    from uasl_motion_estimation_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    import jax.numpy as jnp

    from uasl_motion_estimation_tpu.models.pipeline import (
        OdometryPipeline,
        default_config,
    )
    from uasl_motion_estimation_tpu.models.smoother import (
        SmootherConfig,
        compose_unified,
        unified_system_scan,
        unified_window_starts,
    )
    from uasl_motion_estimation_tpu.ops.geometry import Intrinsics
    from uasl_motion_estimation_tpu.utils.metrics import ate_rmse
    from uasl_motion_estimation_tpu.utils.synthetic import (
        CameraRig,
        CorruptionConfig,
        SyntheticStereoSequence,
    )

    rig = CameraRig()  # KITTI-like 376x1241
    seq = SyntheticStereoSequence(
        n_frames=N_FRAMES, rig=rig, seed=0, corruption=CorruptionConfig()
    )
    frames = [seq.frame(i) for i in range(N_FRAMES)]
    gt = seq.gt_positions()

    pipe_cfg = default_config(
        Intrinsics(rig.fu, rig.fv, rig.cu, rig.cv), rig.baseline
    )
    cfg = SmootherConfig(pipe=pipe_cfg)

    # stage once (uint8 wire format; staging overlap is measured by
    # benchmarks/streaming.py / bench.py fps_end_to_end)
    pipe = OdometryPipeline(pipe_cfg, seed=0)
    ls, rs = pipe.stage_frames(frames)

    # --- VO-only pipeline timing on the same frames (comparison row) ---
    pipe.run_staged(ls, rs, chunk=CHUNK)  # warmup/compile
    vo_times = []
    traj_vo_pipe = None
    for _ in range(REPS):
        pipe.reset()
        t0 = time.perf_counter()
        traj_vo_pipe = pipe.run_staged(ls, rs, chunk=CHUNK)
        vo_times.append(time.perf_counter() - t0)
    fps_vo = (N_FRAMES - 1) / float(np.median(vo_times))
    ate_vo_pipe = float(ate_rmse(traj_vo_pipe[:, :3, 3], gt))

    # --- unified full system (tracks + VO + batched BA), one dispatch ---
    key = jax.random.key(0)
    t0 = time.perf_counter()
    out = jax.device_get(unified_system_scan(ls, rs, key, cfg, wchunk=WCHUNK))
    t_compile = time.perf_counter() - t0
    fs_times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        out = jax.device_get(
            unified_system_scan(ls, rs, key, cfg, wchunk=WCHUNK)
        )
        fs_times.append(time.perf_counter() - t0)
    fps_fs = (N_FRAMES - 1) / float(np.median(fs_times))

    res = compose_unified(out, N_FRAMES, cfg)
    ate_vo = float(ate_rmse(res.traj_vo[:, :3, 3], gt))
    ate_ba = float(ate_rmse(res.traj_ba[:, :3, 3], gt))

    packed = res.per_frame
    n_matches = packed[:, 17]
    n_inliers = packed[:, 18]
    ratio = np.where(n_matches > 0, n_inliers / np.maximum(n_matches, 1), 0.0)
    degraded = ratio < INLIER_FLOOR  # near-failure frames (VERDICT r3 item 9)

    # which BA windows contain a degraded frame (to correlate with installs)
    starts = unified_window_starts(N_FRAMES, cfg.window, cfg.ba_rate)
    win_has_degraded = [
        bool(degraded[s:s + cfg.window - 1].any()) for s in starts
    ]

    ref = json.loads((REPO / "benchmarks" / "reference_cpu.json").read_text())
    vs_ref = fps_fs / ref["fps"]
    result = {
        "metric": "integrated system fps (unified track table: windowed "
                  "detection + per-motion VO + batched BA, KITTI-size "
                  "corrupted world)",
        "value": round(fps_fs, 2),
        "unit": "frames/s",
        "vs_baseline_ref_vo_only": round(vs_ref, 2),
        "fps_vo_only_pipeline_same_frames": round(fps_vo, 2),
        "ate_vo_only_pipeline_m": round(ate_vo_pipe, 4),
        "n_windows": len(starts),
        "window": cfg.window,
        "ba_rate": cfg.ba_rate,
        "ate_vo_m": round(ate_vo, 4),
        "ate_ba_m": round(ate_ba, 4),
        "pass_ate_gate": bool(ate_ba < ate_vo),
        "pass_fps_gate": bool(vs_ref >= 10.0),
        "ba_converged": int(np.sum(res.ba_converged)),
        "mean_inlier_ratio": round(float(ratio.mean()), 3),
        "min_inlier_ratio": round(float(ratio.min()), 3),
        "inlier_ratio_trace": [round(float(r), 3) for r in ratio],
        "degraded_frame_policy": "frames with inlier ratio < %.2f are "
            "flagged; the VO solver independently gates hard failures to "
            "identity motion, and BA installs are gated per-motion on "
            "min_frame_obs endpoint support plus the install_disc_px "
            "plausibility cap (best-support policy)"
            % INLIER_FLOOR,
        "degraded_frames": [int(i) for i in np.nonzero(degraded)[0]],
        "windows_containing_degraded_frame": win_has_degraded,
        "compile_plus_first_run_s": round(t_compile, 1),
        "note": "single dispatch, device_get fence per rep; the reference "
                "baseline fps is its VO-only loop — its BA would only add "
                "Ceres time on top. The integrated system is FASTER than "
                "the per-frame-detection VO-only pipeline because the "
                "track table amortizes detection across the window.",
    }
    print(json.dumps(result))
    (REPO / "benchmarks" / "full_system.json").write_text(
        json.dumps(result, indent=1)
    )
    assert ate_ba < ate_vo, (ate_vo, ate_ba)
    assert vs_ref >= 10.0, vs_ref


if __name__ == "__main__":
    main()
