"""Stress-regime regression tests (VERDICT r4 item 5): adversarial
trajectories and low-texture stretches through the staged VO engine — the
full gated artifact lives in benchmarks/stress_worlds.py (PERF.md);
these are the fast per-regime smoke gates."""

import numpy as np

from uasl_motion_estimation_tpu.models.pipeline import (
    OdometryPipeline,
    default_config,
)
from uasl_motion_estimation_tpu.ops import geometry as geo
from uasl_motion_estimation_tpu.utils import metrics
from uasl_motion_estimation_tpu.utils.synthetic import (
    CameraRig,
    SyntheticStereoSequence,
    stress_trajectory,
)

RIG = CameraRig(fu=320.0, fv=320.0, cu=160.0, cv=96.0, baseline=0.54,
                height=192, width=320)
CFG = default_config(
    geo.Intrinsics(RIG.fu, RIG.fv, RIG.cu, RIG.cv), RIG.baseline
)._replace(max_features=256)


def run_world(seq, n):
    frames = [seq.frame(i) for i in range(n)]
    pipe = OdometryPipeline(CFG, seed=0)
    ls, rs = pipe.stage_frames(frames)
    traj = pipe.run_staged(ls, rs, chunk=6)
    return float(metrics.ate_rmse(traj[:, :3, 3], seq.gt_positions()))


def test_pure_rotation_stretch():
    n = 18
    seq = SyntheticStereoSequence(
        n_frames=n, rig=RIG, seed=7,
        trajectory=stress_trajectory("pure_rotation", n))
    assert run_world(seq, n) < 0.08


def test_moderate_turn_default_config():
    """A 5 deg/frame 90-degree corner must hold near-nominal accuracy on
    the DEFAULT config (the 10 deg/frame extreme needs the stress KLT
    profile — measured by benchmarks/stress_worlds.py, PERF.md)."""
    n = 18
    seq = SyntheticStereoSequence(
        n_frames=n, rig=RIG, seed=7, hall_half_width=45.0,
        trajectory=stress_trajectory("sharp_turn", n, turn_rate_deg=5.0))
    assert run_world(seq, n) < 0.15


def test_low_texture_stretch():
    n = 18
    seq = SyntheticStereoSequence(n_frames=n, rig=RIG, seed=7,
                                  low_texture_band=(10.0, 16.0))
    assert run_world(seq, n) < 0.12
