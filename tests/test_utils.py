"""Checkpoint/resume round-trip and visualization smoke tests."""

import json

import numpy as np
import pytest

from uasl_motion_estimation_tpu.models.frontend import MatcherConfig
from uasl_motion_estimation_tpu.models.odometry import (
    OdometryConfig,
    OdometrySystem,
)
from uasl_motion_estimation_tpu.models.stereo_vo import StereoVOParams
from uasl_motion_estimation_tpu.ops import geometry as geo
from uasl_motion_estimation_tpu.utils import viz
from uasl_motion_estimation_tpu.utils.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from uasl_motion_estimation_tpu.utils.synthetic import (
    CameraRig,
    SyntheticStereoSequence,
)

RIG = CameraRig(fu=320.0, fv=320.0, cu=160.0, cv=96.0, baseline=0.54,
                height=192, width=320)


def make_system():
    intr = geo.Intrinsics(RIG.fu, RIG.fv, RIG.cu, RIG.cv)
    cfg = OdometryConfig(
        vo=StereoVOParams(intr1=intr, intr2=intr, baseline=RIG.baseline),
        max_tracks=128, window=4, ba_rate=100,
        matcher=MatcherConfig(max_disparity=96),
    )
    return OdometrySystem(cfg, seed=0, use_ba=False)


class TestCheckpoint:
    def test_roundtrip_resume_bitexact(self, tmp_path):
        seq = SyntheticStereoSequence(n_frames=8, rig=RIG, seed=4)
        frames = [seq.frame(i) for i in range(8)]

        # run 4 frames, checkpoint, run 4 more
        a = make_system()
        for f in frames[:4]:
            a.process_pair(*f)
        ckpt = str(tmp_path / "ckpt.npz")
        save_checkpoint(ckpt, a)
        for f in frames[4:]:
            a.process_pair(*f)

        # fresh system, resume from checkpoint, same remaining frames
        b = make_system()
        load_checkpoint(ckpt, b)
        assert b.frame_idx == 4
        for f in frames[4:]:
            b.process_pair(*f)

        np.testing.assert_allclose(
            np.asarray(a.trajectory), np.asarray(b.trajectory), atol=1e-12
        )

    def test_checkpoint_before_first_frame(self, tmp_path):
        a = make_system()
        ckpt = str(tmp_path / "c0.npz")
        save_checkpoint(ckpt, a)
        b = make_system()
        load_checkpoint(ckpt, b)
        assert b.table is None and b.frame_idx == 0


class TestViz:
    def test_plot_trajectories(self, tmp_path):
        t = np.cumsum(np.random.default_rng(0).normal(size=(20, 3)), axis=0)
        fig = viz.plot_trajectories(
            {"est": t, "gt": t + 0.1}, path=str(tmp_path / "traj.png")
        )
        assert (tmp_path / "traj.png").exists()

    def test_plot_metrics(self, tmp_path):
        recs = [
            {"frame": i, "n_matches": 100 - i, "n_inliers": 90 - i,
             "mean_reproj_error": 0.1 * i, "n_tracks": 50}
            for i in range(10)
        ]
        viz.plot_metrics(recs, path=str(tmp_path / "m.png"))
        assert (tmp_path / "m.png").exists()

    def test_draw_tracks_and_reproj(self, tmp_path):
        img = np.random.default_rng(0).uniform(0, 255, (100, 200))
        uv = np.random.default_rng(1).uniform(10, 90, (30, 2))
        viz.draw_tracks(img, uv, np.ones(30, bool), depths=uv[:, 0],
                        path=str(tmp_path / "t.png"))
        viz.draw_stereo_reprojection(
            img, uv, uv + 1.0, np.ones(30, bool), path=str(tmp_path / "r.png")
        )
        assert (tmp_path / "t.png").exists() and (tmp_path / "r.png").exists()

    def test_covariance_ellipse(self):
        w, h, ang = viz.covariance_ellipse(np.diag([4.0, 1.0]))
        assert w > h
        assert abs(ang) < 1e-6 or abs(abs(ang) - 180) < 1e-6


class TestVizExtra:
    def test_plot_trajectory_3d(self, tmp_path):
        t = np.cumsum(np.random.default_rng(2).normal(size=(15, 3)), axis=0)
        viz.plot_trajectory_3d({"est": t}, path=str(tmp_path / "t3.png"))
        assert (tmp_path / "t3.png").exists()

    def test_plot_joint_distribution(self, tmp_path):
        a = np.random.default_rng(0).uniform(0, 255, (16, 16))
        viz.plot_joint_distribution(a, a, path=str(tmp_path / "jd.png"))
        assert (tmp_path / "jd.png").exists()


class TestCompileCache:
    @pytest.fixture
    def restore_config(self):
        import jax

        saved = (jax.config.jax_compilation_cache_dir,
                 jax.config.jax_persistent_cache_min_compile_time_secs)
        yield jax
        jax.config.update("jax_compilation_cache_dir", saved[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          saved[1])

    def test_uses_environment_variable(self, restore_config, monkeypatch,
                                       tmp_path):
        from uasl_motion_estimation_tpu.utils.compile_cache import (
            enable_compile_cache,
        )

        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert enable_compile_cache() == str(tmp_path)
        assert restore_config.config.jax_compilation_cache_dir == str(tmp_path)

    def test_defaults_to_checkout(self, restore_config, monkeypatch):
        from pathlib import Path

        from uasl_motion_estimation_tpu.utils.compile_cache import (
            enable_compile_cache,
        )

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        path = Path(enable_compile_cache())
        assert path.name == ".jax_cache"
        assert (path.parent / "chip_smoke.py").exists()
        assert restore_config.config.jax_compilation_cache_dir == str(path)


class TestProfiling:
    def test_stage_timer(self):
        from uasl_motion_estimation_tpu.utils.profiling import StageTimer

        t = StageTimer()
        with t("a"):
            pass
        with t("a"):
            pass
        with t("b"):
            pass
        rep = t.report()
        assert "a" in rep and "x2" in rep
