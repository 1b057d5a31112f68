"""Config-1b: headline stereo VO on the CORRUPTED world, vs the reference
binary on the SAME frames (VERDICT r2 item 3).

The corruption model (utils/synthetic.py CorruptionConfig) is deterministic
in (seed, frame, cam), so the reference binary and this pipeline see
byte-identical corrupted frames; both ATEs come from the same
utils/metrics.ate_rmse. The per-frame inlier-ratio trace proves RANSAC is
doing real rejection work (reference's core mechanism:
src/vo/StereoVisualOdometry.cpp:58-114).

Writes benchmarks/corrupted.json; the reference measurement is cached in
benchmarks/reference_cpu_corrupted.json (re-measure with BENCH_REMEASURE=1).
The reference run and the device timing are serialized so neither starves
the other of host cores.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

N_FRAMES = int(os.environ.get("BENCH_FRAMES", "40"))
N_REF_FRAMES = int(os.environ.get("BENCH_REF_FRAMES", "12"))
CHUNK = int(os.environ.get("BENCH_CHUNK", "13"))
REPS = int(os.environ.get("BENCH_REPS", "3"))
REF_CACHE = REPO / "benchmarks" / "reference_cpu_corrupted.json"


def make_sequence(n):
    from uasl_motion_estimation_tpu.utils.synthetic import (
        CameraRig,
        CorruptionConfig,
        SyntheticStereoSequence,
    )

    rig = CameraRig()
    seq = SyntheticStereoSequence(
        n_frames=n, rig=rig, seed=0, corruption=CorruptionConfig()
    )
    return rig, seq


def measure_reference():
    """Run the unmodified-reference binary (repaired loop exit, see
    reference_baseline/build.sh) on the corrupted frames."""
    import cv2

    from uasl_motion_estimation_tpu.utils.metrics import ate_rmse

    rig, seq = make_sequence(N_REF_FRAMES)
    bin_path = REPO / "benchmarks" / "reference_baseline" / "ref_vo_repaired"
    if not bin_path.exists():
        env = dict(os.environ, REPAIRED="1")
        subprocess.run(
            [str(REPO / "benchmarks" / "reference_baseline" / "build.sh")],
            check=True, capture_output=True, timeout=300, env=env,
        )
    with tempfile.TemporaryDirectory() as td:
        for i in range(N_REF_FRAMES):
            l, r = seq.frame(i)
            cv2.imwrite(f"{td}/L_{i:06d}.png",
                        np.clip(l, 0, 255).astype(np.uint8))
            cv2.imwrite(f"{td}/R_{i:06d}.png",
                        np.clip(r, 0, 255).astype(np.uint8))
        out = subprocess.run(
            [str(bin_path), td, str(N_REF_FRAMES), str(rig.fu), str(rig.fv),
             str(rig.cu), str(rig.cv), str(rig.baseline)],
            capture_output=True, text=True, timeout=3600, check=True,
        )
    summary = json.loads(out.stderr.strip().splitlines()[-1])
    rows = []
    for line in out.stdout.splitlines():
        parts = line.split()
        if len(parts) != 12:
            continue
        try:
            rows.append([float(v) for v in parts])
        except ValueError:
            continue
    poses = np.array(rows).reshape(-1, 3, 4)
    ate = float(ate_rmse(poses[:, :3, 3], seq.gt_positions()))
    rec = {
        "fps": summary["fps"],
        "ate": ate,
        "ok_frames": summary["ok_frames"],
        "n_frames": N_REF_FRAMES,
        "config": "reference defaults on corrupted frames "
                  "(same CorruptionConfig pixels as the device run)",
    }
    REF_CACHE.write_text(json.dumps(rec, indent=1))
    return rec


def measure_device():
    import jax

    from uasl_motion_estimation_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()

    from uasl_motion_estimation_tpu.models.pipeline import (
        OdometryPipeline,
        default_config,
    )
    from uasl_motion_estimation_tpu.ops.geometry import Intrinsics
    from uasl_motion_estimation_tpu.utils.metrics import (
        MetricsLogger,
        ate_rmse,
    )

    rig, seq = make_sequence(N_FRAMES)
    frames = [seq.frame(i) for i in range(N_FRAMES)]
    cfg = default_config(
        Intrinsics(rig.fu, rig.fv, rig.cu, rig.cv), rig.baseline
    )
    log = MetricsLogger()
    pipe = OdometryPipeline(cfg, seed=0, logger=log)
    ls, rs = pipe.stage_frames(frames)
    pipe.run_staged(ls, rs, chunk=CHUNK)  # warmup/compile
    times = []
    traj = None
    for _ in range(REPS):
        pipe.reset()
        log.records.clear()
        t0 = time.perf_counter()
        traj = pipe.run_staged(ls, rs, chunk=CHUNK)
        times.append(time.perf_counter() - t0)
    fps = (N_FRAMES - 1) / float(np.median(times))
    gt = seq.gt_positions()
    ate = float(ate_rmse(traj[:, :3, 3], gt))
    # ATE is trajectory-length dependent (round-3 advisor): the
    # reference-vs-device accuracy comparison must use the SAME first
    # N_REF_FRAMES the cached reference run covers
    ate_ref_span = float(
        ate_rmse(traj[:N_REF_FRAMES, :3, 3], gt[:N_REF_FRAMES])
    )
    recs = [r for r in log.records if "n_inliers" in r and r["n_matches"] > 0]
    ratios = [r["n_inliers"] / r["n_matches"] for r in recs]
    return fps, ate, ate_ref_span, ratios, [int(r["n_inliers"]) for r in recs]


def main():
    if os.environ.get("BENCH_REMEASURE") == "1" or not REF_CACHE.exists():
        ref = measure_reference()
    else:
        ref = json.loads(REF_CACHE.read_text())
    fps, ate, ate_ref_span, ratios, inliers = measure_device()
    result = {
        "metric": "stereo VO frames/s/chip, corrupted world (photometric "
                  "gain/bias/noise + 2 moving objects + occluder)",
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / ref["fps"], 2),
        "ate_m": round(ate, 4),
        "n_frames": N_FRAMES,
        "ate_m_ref_span": round(ate_ref_span, 4),
        "ref_fps": round(ref["fps"], 3),
        "ref_ate_m": round(ref["ate"], 4),
        "ref_frames": ref["n_frames"],
        "inlier_ratio_mean": round(float(np.mean(ratios)), 3),
        "inlier_ratio_min": round(float(np.min(ratios)), 3),
        "inlier_trace": [round(float(x), 3) for x in ratios],
        "note": "same deterministic corrupted pixels fed to both. ate_m "
                "covers all n_frames; the like-for-like accuracy row vs the "
                "reference is ate_m_ref_span vs ref_ate_m over the same "
                "first ref_frames frames (ATE is length-dependent; the "
                "reference run is capped at fewer frames to keep the "
                "2-CPU host measurement window short). fps ratio compares "
                "steady-state per-frame throughput, which is "
                "length-independent.",
    }
    print(json.dumps(result))
    (REPO / "benchmarks" / "corrupted.json").write_text(
        json.dumps(result, indent=1)
    )


if __name__ == "__main__":
    main()
