"""Measure the reference library's CPU MONO-VO throughput and accuracy.

Runs the unmodified reference mono path (MonoVisualOdometry ->
cv::findEssentialMat + cv::recoverPose, compiled by
reference_baseline/build.sh) with its standard OpenCV consumer front-end on
the SAME synthetic EuRoC-sized left-camera frames the device mono bench uses
(extra_configs.bench_mono: 752x480, seed 3), chaining with the same known
speed. Caches benchmarks/reference_cpu_mono.json (VERDICT r4 item 4a — the
mono rows previously had no vs_baseline).

Run: python benchmarks/measure_reference_mono.py [n_frames]
"""

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

N_FRAMES = int(sys.argv[1]) if len(sys.argv) > 1 else 13
SPEED = 0.8  # synthetic-world speed, the same initial_speed the device bench gets
CACHE = REPO / "benchmarks" / "reference_cpu_mono.json"


def main():
    import cv2

    from uasl_motion_estimation_tpu.utils.metrics import ate_rmse
    from uasl_motion_estimation_tpu.utils.synthetic import (
        CameraRig,
        SyntheticStereoSequence,
    )

    # the device mono bench's EuRoC-like rig (extra_configs.bench_mono)
    rig = CameraRig(fu=458.65, fv=457.3, cu=367.2, cv=248.4, baseline=0.11,
                    height=480, width=752)
    seq = SyntheticStereoSequence(n_frames=N_FRAMES, rig=rig, seed=3)

    bin_path = REPO / "benchmarks" / "reference_baseline" / "ref_mono"
    if not bin_path.exists():
        env = dict(os.environ, REPAIRED="1", MONO="1")
        subprocess.run(
            [str(REPO / "benchmarks" / "reference_baseline" / "build.sh")],
            check=True, capture_output=True, timeout=300, env=env,
        )

    with tempfile.TemporaryDirectory() as td:
        for i in range(N_FRAMES):
            l, _ = seq.frame(i)
            cv2.imwrite(f"{td}/L_{i:06d}.png",
                        np.clip(l, 0, 255).astype(np.uint8))
        out = subprocess.run(
            [str(bin_path), td, str(N_FRAMES), str(rig.fu), str(rig.fv),
             str(rig.cu), str(rig.cv), str(SPEED)],
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
    gt = seq.gt_positions()
    rec = {
        "fps": summary["fps"],
        "ate": float(ate_rmse(poses[:, :3, 3], gt)),
        "ate_sim3": float(ate_rmse(poses[:, :3, 3], gt, with_scale=True)),
        "ok_frames": summary["ok_frames"],
        "n_frames": N_FRAMES,
        "config": (
            "reference mono defaults: findEssentialMat(RANSAC, prob 0.99, "
            "thr 2.0) + recoverPose; GFTT+PyrLK consumer front-end; fixed "
            f"speed {SPEED} (library provides no scale propagation: "
            "findRelativeScale is private/unused, m_pts never filled)"
        ),
        "hardware": "container CPU (single thread, -O3 -march=native)",
    }
    CACHE.write_text(json.dumps(rec, indent=1))
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
