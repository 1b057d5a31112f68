"""Long-sequence integrated benchmark: 500+ frames, streaming + BA
(VERDICT r3 item 4 — the composed flagships).

Runs the unified track-table engine (models/smoother.py) over a >=500-frame
KITTI-size corrupted sequence two ways:

  * staged: all frames device-resident as uint8 (~0.9 MB/frame), one
    dispatch — the compute-rate row;
  * streaming: run_unified_streaming super-chunks with background async
    uploads — device memory bounded at (prefetch+1) super-chunks + one
    window group's working set regardless of sequence length (the in-run
    measured MB/s is reported alongside).

Acceptance: ate_ba < ate_vo on the 500-frame corrupted world (the
artifact is self-describing via pass_ate_gate). Writes
benchmarks/long_sequence.json.
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

N_FRAMES = int(os.environ.get("BENCH_FRAMES", "501"))
WCHUNK = int(os.environ.get("BENCH_WCHUNK", "5"))
GROUPS = int(os.environ.get("BENCH_GROUPS", "2"))


def main():
    import jax
    import jax.numpy as jnp

    from uasl_motion_estimation_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()

    from uasl_motion_estimation_tpu.models.pipeline import default_config
    from uasl_motion_estimation_tpu.models.smoother import (
        SmootherConfig,
        compose_unified,
        run_unified_streaming,
        unified_system_scan,
    )
    from uasl_motion_estimation_tpu.ops.geometry import Intrinsics
    from uasl_motion_estimation_tpu.utils.metrics import ate_rmse
    from uasl_motion_estimation_tpu.utils.synthetic import (
        CameraRig,
        CorruptionConfig,
        SyntheticStereoSequence,
    )

    rig = CameraRig()  # KITTI-size 376x1241
    seq = SyntheticStereoSequence(
        n_frames=N_FRAMES, rig=rig, seed=0, corruption=CorruptionConfig()
    )
    t0 = time.perf_counter()
    cache = Path(f"/tmp/long_frames_{N_FRAMES}.npz")  # deterministic render
    if cache.exists():
        d = np.load(cache)
        frames = list(zip(d["ls"].astype(np.float32),
                          d["rs"].astype(np.float32)))
    else:
        frames = [seq.frame(i) for i in range(N_FRAMES)]
        np.savez(
            cache,
            ls=np.clip(np.stack([f[0] for f in frames]), 0, 255
                       ).astype(np.uint8),
            rs=np.clip(np.stack([f[1] for f in frames]), 0, 255
                       ).astype(np.uint8),
        )
    render_s = time.perf_counter() - t0
    gt = seq.gt_positions()
    path_len = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())

    cfg = SmootherConfig(pipe=default_config(
        Intrinsics(rig.fu, rig.fv, rig.cu, rig.cv), rig.baseline
    ))

    # --- staged: all frames in HBM, one dispatch ---
    ls = jnp.asarray(
        np.clip(np.stack([f[0] for f in frames]), 0, 255).astype(np.uint8))
    rs = jnp.asarray(
        np.clip(np.stack([f[1] for f in frames]), 0, 255).astype(np.uint8))
    key = jax.random.key(0)
    t0 = time.perf_counter()
    out = jax.device_get(unified_system_scan(ls, rs, key, cfg, wchunk=WCHUNK))
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.device_get(unified_system_scan(ls, rs, key, cfg, wchunk=WCHUNK))
    t_staged = time.perf_counter() - t0
    fps_staged = (N_FRAMES - 1) / t_staged
    res = compose_unified(out, N_FRAMES, cfg)
    ate_vo = float(ate_rmse(res.traj_vo[:, :3, 3], gt))
    ate_ba = float(ate_rmse(res.traj_ba[:, :3, 3], gt))
    del ls, rs

    # --- streaming: bounded device memory, measured uploads ---
    stats: dict = {}
    t0 = time.perf_counter()
    res_s = run_unified_streaming(
        iter(frames), cfg, seed=0, wchunk=WCHUNK, groups=GROUPS, stats=stats
    )
    t_stream = time.perf_counter() - t0
    fps_stream = (N_FRAMES - 1) / t_stream
    ate_vo_s = float(ate_rmse(res_s.traj_vo[:, :3, 3], gt))
    ate_ba_s = float(ate_rmse(res_s.traj_ba[:, :3, 3], gt))
    upload_s = float(np.sum(stats["upload_s"]))
    upload_mb = float(np.sum(stats["upload_bytes"])) / 1e6
    n_win = GROUPS * WCHUNK
    span = (n_win - 1) * cfg.ba_rate + cfg.window
    frame_mb = rig.height * rig.width / 1e6
    peak_mb = 2 * frame_mb * span * 3  # prefetch 2 + active, uint8, L+R

    result = {
        "metric": f"long-sequence integrated system ({N_FRAMES} frames "
                  "KITTI-size corrupted, unified VO+BA)",
        "value": round(fps_staged, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps_staged / 12.93, 2),
        "n_frames": N_FRAMES,
        "path_length_m": round(path_len, 1),
        "ate_vo_m": round(ate_vo, 4),
        "ate_ba_m": round(ate_ba, 4),
        "pass_ate_gate": bool(ate_ba < ate_vo),
        "ba_converged": int(np.sum(res.ba_converged)),
        "n_windows": int(res.ba_cost.shape[0]),
        "staged_wall_s": round(t_staged, 2),
        "compile_plus_first_run_s": round(t_first, 1),
        "render_s": round(render_s, 1),
        "streaming": {
            "fps_e2e": round(fps_stream, 2),
            "ate_vo_m": round(ate_vo_s, 4),
            "ate_ba_m": round(ate_ba_s, 4),
            "pass_ate_gate": bool(ate_ba_s < ate_vo_s),
            "upload_s_measured": round(upload_s, 2),
            "upload_mb": round(upload_mb, 1),
            "upload_mb_s_measured": round(upload_mb / max(upload_s, 1e-9), 2),
            "peak_device_frame_mb_bound": round(peak_mb, 1),
            "note": "device memory is bounded by (prefetch+1) "
                    "super-chunks independent of length",
        },
    }
    print(json.dumps(result))
    (REPO / "benchmarks" / "long_sequence.json").write_text(
        json.dumps(result, indent=1)
    )
    assert ate_ba < ate_vo, (ate_vo, ate_ba)


if __name__ == "__main__":
    main()
