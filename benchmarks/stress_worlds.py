"""Aggressive-motion and low-texture stress worlds (VERDICT r4 item 5).

Every previously committed world was gentle forward motion (max yaw
~1.7 deg/frame); the stated benchmark domain — urban KITTI driving —
includes near-stop 90-degree turns, pure-rotation segments, and
low-texture stretches. This artifact runs plain staged VO and the unified
VO+BA engine on each adversarial regime at 192x320 with EXACT ground truth
and asserts per-regime ATE gates (pass_* fields).

Regimes (utils/synthetic.stress_trajectory + renderer options):
  turn_5deg      90-deg turn at 5 deg/frame (a brisk urban corner at
                 ~10 Hz) — must hold near-nominal accuracy on the DEFAULT
                 config.
  turn_10deg     90-deg turn at 10 deg/frame (extreme: ~56 px/frame of
                 rotational flow at this focal length) — run on both the
                 default config and a stress-tuned KLT profile (5 pyramid
                 levels, more iterations, wider tiles); the tuned profile
                 must keep the chain bounded, and failed frames must obey
                 the degraded-frame contract rather than corrupt the chain.
  near_stop      deceleration to 1 cm/frame for a third of the sequence
                 (traffic stop) with yaw jitter.
  pure_rotation  full stop + 4 deg/frame yaw-in-place (the stereo-VO
                 degenerate regime: no translation).
  low_texture    a 10 m stretch of the corridor at 8% texture contrast
                 (detection starvation + weak KLT/ZNCC signal).

Turning worlds use a widened hall (hall_half_width=45): with the default
12 m corridor a 90-degree turn drives the camera into the side wall within
a few frames — a world artifact, not a framework property (measured: the
post-turn match count decays to zero as wall depth crosses the disparity
search range).

Writes benchmarks/stress.json.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

N = 30


def main():
    import jax

    from uasl_motion_estimation_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()

    from uasl_motion_estimation_tpu.models.frontend import KLTConfig
    from uasl_motion_estimation_tpu.models.pipeline import (
        OdometryPipeline,
        default_config,
    )
    from uasl_motion_estimation_tpu.models.smoother import (
        SmootherConfig,
        run_unified_system,
    )
    from uasl_motion_estimation_tpu.ops.geometry import Intrinsics
    from uasl_motion_estimation_tpu.utils.metrics import ate_rmse
    from uasl_motion_estimation_tpu.utils.synthetic import (
        CameraRig,
        SyntheticStereoSequence,
        stress_trajectory,
    )

    rig = CameraRig(fu=320.0, fv=320.0, cu=160.0, cv=96.0, baseline=0.54,
                    height=192, width=320)
    intr = Intrinsics(rig.fu, rig.fv, rig.cu, rig.cv)
    base = default_config(intr, rig.baseline)._replace(max_features=256)
    # stress KLT profile for extreme rotational flow: 5 pyramid levels
    # (capture ~155 px), more iterations, wider per-level tiles
    stress_klt = base._replace(klt=KLTConfig(
        n_levels=5, iters=14, iters_coarse=6, tile_margin=7,
        max_displacement=150.0))

    def world(kind):
        if kind == "low_texture":
            return SyntheticStereoSequence(
                n_frames=N, rig=rig, seed=7, low_texture_band=(12.0, 22.0))
        if kind.startswith("turn_"):
            rate = float(kind.split("_")[1].rstrip("deg"))
            return SyntheticStereoSequence(
                n_frames=N, rig=rig, seed=7, hall_half_width=45.0,
                trajectory=stress_trajectory("sharp_turn", N,
                                             turn_rate_deg=rate))
        return SyntheticStereoSequence(
            n_frames=N, rig=rig, seed=7,
            trajectory=stress_trajectory(kind, N))

    def run_vo(frames, cfg):
        pipe = OdometryPipeline(cfg, seed=0)
        ls, rs = pipe.stage_frames(frames)
        return pipe.run_staged(ls, rs, chunk=8)

    result = {}
    gates = {
        "turn_5deg": 0.15,
        "turn_10deg": 0.60,  # stress-tuned profile; ~9 motions of 10 deg
        "near_stop": 0.08,
        "pure_rotation": 0.08,
        "low_texture": 0.12,
    }
    for kind in ("turn_5deg", "turn_10deg", "near_stop", "pure_rotation",
                 "low_texture"):
        seq = world(kind)
        frames = [seq.frame(i) for i in range(N)]
        gt = seq.gt_positions()
        dist = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
        row = {"path_m": round(dist, 1)}

        cfg = stress_klt if kind == "turn_10deg" else base
        traj = run_vo(frames, cfg)
        row["vo_ate_m"] = round(float(ate_rmse(traj[:, :3, 3], gt)), 4)
        if kind == "turn_10deg":
            # default config measured too, for the honest record
            traj_d = run_vo(frames, base)
            row["vo_ate_default_cfg_m"] = round(
                float(ate_rmse(traj_d[:, :3, 3], gt)), 4)

        ures = run_unified_system(frames, SmootherConfig(pipe=cfg), seed=1)
        row["unified_ate_vo_m"] = round(
            float(ate_rmse(ures.traj_vo[:, :3, 3], gt)), 4)
        row["unified_ate_ba_m"] = round(
            float(ate_rmse(ures.traj_ba[:, :3, 3], gt)), 4)
        row["vo_success"] = f"{int(ures.per_frame[:, 16].sum())}/{N - 1}"
        row["ba_converged"] = f"{int(np.sum(ures.ba_converged))}/" \
                              f"{len(ures.ba_converged)}"
        row["gate_ate_m"] = gates[kind]
        row["pass"] = bool(row["vo_ate_m"] < gates[kind]
                           and row["unified_ate_ba_m"] < 1.5 * gates[kind])
        result[kind] = row
        print(kind, json.dumps(row))

    result["pass_all"] = bool(all(
        v["pass"] for k, v in result.items() if isinstance(v, dict)))
    out = REPO / "benchmarks" / "stress.json"
    out.write_text(json.dumps(result, indent=2))
    print(f"wrote {out}; pass_all={result['pass_all']}")


if __name__ == "__main__":
    main()
