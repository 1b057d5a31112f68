"""Mono VO tests on synthetic two-view geometry (SURVEY.md section 4 tier 2):
exact projections -> recovered (R, t) up to scale; outlier injection ->
RANSAC inlier recovery; degenerate inputs -> clean failure."""

import jax
import jax.numpy as jnp
import numpy as np

from uasl_motion_estimation_tpu.models.mono_vo import MonoVOParams, mono_vo_solve
from uasl_motion_estimation_tpu.ops import geometry as geo, lie

INTR = geo.Intrinsics(fu=500.0, fv=500.0, cu=320.0, cv=240.0)


def make_two_view(n=200, rotvec=(0.01, 0.03, 0.005), trans=(0.2, -0.1, 1.0),
                  seed=0, noise=0.0):
    rng = np.random.default_rng(seed)
    pts = np.stack(
        [rng.uniform(-6, 6, n), rng.uniform(-4, 4, n), rng.uniform(6, 30, n)],
        -1,
    )
    R = np.asarray(lie.so3_exp(jnp.asarray(rotvec, jnp.float32)))
    t = np.asarray(trans)
    pc2 = pts @ R.T + t

    def proj(p):
        return np.stack(
            [500.0 * p[:, 0] / p[:, 2] + 320.0, 500.0 * p[:, 1] / p[:, 2] + 240.0],
            -1,
        )

    uv1, uv2 = proj(pts), proj(pc2)
    uv1 += rng.normal(scale=noise, size=uv1.shape)
    uv2 += rng.normal(scale=noise, size=uv2.shape)
    matches = np.stack([uv1, uv2], axis=1).astype(np.float32)
    return matches, R, t, pts


class TestMonoVO:
    def test_exact_recovery(self):
        matches, R, t, _ = make_two_view()
        res = mono_vo_solve(
            jnp.asarray(matches), jnp.ones(len(matches), bool),
            jax.random.key(0), MonoVOParams(intr=INTR),
        )
        assert bool(res.success)
        np.testing.assert_allclose(np.asarray(res.R), R, atol=2e-3)
        t_unit = t / np.linalg.norm(t)
        np.testing.assert_allclose(np.asarray(res.t), t_unit, atol=5e-3)

    def test_outlier_rejection(self):
        matches, R, t, _ = make_two_view(noise=0.3, seed=3)
        rng = np.random.default_rng(9)
        bad = rng.choice(len(matches), 40, replace=False)
        matches[bad, 1] += rng.uniform(20, 120, (40, 2)).astype(np.float32)
        res = mono_vo_solve(
            jnp.asarray(matches), jnp.ones(len(matches), bool),
            jax.random.key(1), MonoVOParams(intr=INTR, inlier_threshold=2.0),
        )
        assert bool(res.success)
        inl = np.asarray(res.inlier_mask)
        assert inl[bad].sum() <= 4, inl[bad].sum()  # outliers excluded
        # linear refit under 0.3 px noise: ~1e-2 rotation accuracy
        np.testing.assert_allclose(np.asarray(res.R), R, atol=1.5e-2)

    def test_too_few_matches_fails(self):
        matches, *_ = make_two_view(n=12)
        valid = jnp.zeros(12, bool).at[:5].set(True)
        res = mono_vo_solve(
            jnp.asarray(matches), valid, jax.random.key(0),
            MonoVOParams(intr=INTR),
        )
        assert not bool(res.success)

    def test_triangulated_depths_positive(self):
        matches, R, t, pts = make_two_view()
        res = mono_vo_solve(
            jnp.asarray(matches), jnp.ones(len(matches), bool),
            jax.random.key(0), MonoVOParams(intr=INTR),
        )
        X = np.asarray(res.pts3d)
        inl = np.asarray(res.inlier_mask)
        assert (X[inl, 2] > 0).mean() > 0.95
        # up-to-scale structure: depth ratios match ground truth
        s = np.median(pts[inl, 2] / X[inl, 2])
        np.testing.assert_allclose(X[inl, 2] * s, pts[inl, 2], rtol=0.05)

    def test_planar_scene(self):
        """All points on one plane: the plain 8-point nullspace is degenerate
        but the det-constraint pencil (mono_vo._pencil_candidates) keeps the
        sample usable (VERDICT r1 item 7)."""
        rng = np.random.default_rng(11)
        n = 150
        # ground plane y = 2 (camera 2 m above, looking forward)
        pts = np.stack(
            [rng.uniform(-8, 8, n), np.full(n, 2.0), rng.uniform(5, 35, n)], -1
        )
        R = np.asarray(lie.so3_exp(jnp.asarray([0.01, 0.04, 0.0], jnp.float32)))
        t = np.array([0.1, 0.0, 0.8])
        pc2 = pts @ R.T + t

        def proj(p):
            return np.stack(
                [500.0 * p[:, 0] / p[:, 2] + 320.0,
                 500.0 * p[:, 1] / p[:, 2] + 240.0], -1)

        matches = np.stack([proj(pts), proj(pc2)], axis=1).astype(np.float32)
        matches += rng.normal(scale=0.1, size=matches.shape).astype(np.float32)
        res = mono_vo_solve(
            jnp.asarray(matches), jnp.ones(n, bool), jax.random.key(2),
            MonoVOParams(intr=INTR, inlier_threshold=2.0),
        )
        assert bool(res.success)
        np.testing.assert_allclose(np.asarray(res.R), R, atol=2e-2)
        t_unit = t / np.linalg.norm(t)
        cosang = float(np.asarray(res.t) @ t_unit)
        assert cosang > np.cos(np.deg2rad(6.0)), f"t direction off: {cosang}"

    def test_lmeds_mode(self):
        """cv::LMEDS parity (MonoVisualOdometry.cpp:20): no inlier threshold
        needed, robust to ~35% outliers via the median score."""
        matches, R, t, _ = make_two_view(noise=0.2, seed=5)
        rng = np.random.default_rng(6)
        bad = rng.choice(len(matches), 70, replace=False)
        matches[bad, 1] += rng.uniform(15, 90, (70, 2)).astype(np.float32)
        res = mono_vo_solve(
            jnp.asarray(matches), jnp.ones(len(matches), bool),
            jax.random.key(3), MonoVOParams(intr=INTR, robust="lmeds"),
        )
        assert bool(res.success)
        np.testing.assert_allclose(np.asarray(res.R), R, atol=1.5e-2)
        assert np.asarray(res.inlier_mask)[bad].sum() <= 7

    def test_weighted_refit_not_worse_than_minimal(self):
        """Many-outlier refit: the row-weighted 8-point refit must match or
        beat the minimal-sample hypothesis (round-1 zeroed-row refit biased
        E33 -> 0 and could be WORSE; VERDICT r1 weak #6)."""
        matches, R, t, _ = make_two_view(noise=0.3, seed=7)
        rng = np.random.default_rng(8)
        bad = rng.choice(len(matches), 80, replace=False)  # 40% outliers
        matches[bad, 1] += rng.uniform(25, 150, (80, 2)).astype(np.float32)
        res = mono_vo_solve(
            jnp.asarray(matches), jnp.ones(len(matches), bool),
            jax.random.key(4), MonoVOParams(intr=INTR, inlier_threshold=2.0),
        )
        assert bool(res.success)
        np.testing.assert_allclose(np.asarray(res.R), R, atol=1.5e-2)
        t_unit = t / np.linalg.norm(t)
        np.testing.assert_allclose(np.asarray(res.t), t_unit, atol=5e-2)

    def test_5point_outlier_breakdown_vs_pencil8(self):
        """Breakdown stress (VERDICT r2 item 4): at a fixed hypothesis
        budget the exact 5-point solver works with HALF the inlier ratio
        the 8-point pencil needs — sample success inlier^5 vs inlier^8.

        Measured curve (benchmarks/mono_breakdown.py, PERF.md): at H=40 the
        pencil sustains 40% outliers (8/8 success here) and collapses past
        60%; 5-point still solves 7/8 scenes at 65% outliers — it needs a
        ~35% inlier ratio where the pencil needs ~60%, the near-2x margin
        the inlier^5 vs inlier^8 sample-success odds predict.
        """
        n, H = 200, 40

        def run(solver, rate, seeds):
            params = MonoVOParams(
                intr=INTR, inlier_threshold=2.0, solver=solver, n_ransac=H
            )
            wins = 0
            for seed in seeds:
                matches, R, t, _ = make_two_view(noise=0.3, seed=seed)
                rng = np.random.default_rng(1000 + seed)
                nbad = int(rate * n)
                bad = rng.choice(n, nbad, replace=False)
                matches[bad, 1] = np.stack(
                    [rng.uniform(0, 640, nbad), rng.uniform(0, 480, nbad)], -1
                ).astype(np.float32)
                res = mono_vo_solve(
                    jnp.asarray(matches), jnp.ones(n, bool),
                    jax.random.key(seed), params,
                )
                cosang = (np.trace(np.asarray(res.R).T @ R) - 1.0) / 2.0
                wins += np.degrees(np.arccos(np.clip(cosang, -1, 1))) < 1.0
            return wins / len(seeds)

        seeds = range(8)
        # pencil-8 holds at 40% outliers but collapses at 65%
        assert run("pencil8", 0.40, seeds) >= 0.75
        assert run("pencil8", 0.65, seeds) <= 0.50
        # the exact 5-point still solves at 65% outliers (~35% inliers vs
        # the ~60% the pencil needs)
        assert run("5point", 0.65, seeds) >= 0.75

    def test_hybrid_solver_escalates_only_when_needed(self):
        """Hybrid policy (VERDICT r4 item 4c): identical to pencil8 on easy
        frames (the 5-point branch never wins there) and 5-point-grade
        robustness at a 65% outlier rate where the pencil collapses."""
        n, H = 200, 40

        def run(solver, rate, seeds):
            params = MonoVOParams(
                intr=INTR, inlier_threshold=2.0, solver=solver, n_ransac=H
            )
            wins = 0
            results = []
            for seed in seeds:
                matches, R, t, _ = make_two_view(noise=0.3, seed=seed)
                rng = np.random.default_rng(1000 + seed)
                nbad = int(rate * n)
                bad = rng.choice(n, nbad, replace=False)
                matches[bad, 1] = np.stack(
                    [rng.uniform(0, 640, nbad), rng.uniform(0, 480, nbad)], -1
                ).astype(np.float32)
                res = mono_vo_solve(
                    jnp.asarray(matches), jnp.ones(n, bool),
                    jax.random.key(seed), params,
                )
                results.append(res)
                cosang = (np.trace(np.asarray(res.R).T @ R) - 1.0) / 2.0
                wins += np.degrees(np.arccos(np.clip(cosang, -1, 1))) < 1.0
            return wins / len(seeds), results

        seeds = range(8)
        # easy regime: hybrid == pencil8 bit-for-bit (same key, no
        # escalation)
        _, r_hyb = run("hybrid", 0.10, seeds)
        _, r_p8 = run("pencil8", 0.10, seeds)
        for a, b in zip(r_hyb, r_p8):
            np.testing.assert_array_equal(np.asarray(a.R), np.asarray(b.R))
        # collapsed regime: hybrid inherits the 5-point's robustness
        rate_hyb, _ = run("hybrid", 0.65, seeds)
        assert rate_hyb >= 0.75, rate_hyb

    def test_relative_scale_parity(self):
        """findRelativeScale capability (MonoVisualOdometry.cpp:76-87)."""
        _, _, _, pts = make_two_view()
        scaled = pts * 2.5
        s = geo.relative_scale(jnp.asarray(scaled), jnp.asarray(pts))
        np.testing.assert_allclose(float(s), 2.5, rtol=1e-5)


class TestMonoPipeline:
    def test_trajectory_shape_recovery(self):
        """Mono pipeline on the synthetic world: up-to-scale trajectory must
        align to GT with a similarity transform (mono gauge)."""
        from uasl_motion_estimation_tpu.models.mono_pipeline import (
            MonoOdometryPipeline,
            MonoPipelineConfig,
        )
        from uasl_motion_estimation_tpu.utils.metrics import ate_rmse
        from uasl_motion_estimation_tpu.utils.synthetic import (
            CameraRig,
            SyntheticStereoSequence,
        )

        rig = CameraRig(fu=320.0, fv=320.0, cu=160.0, cv=96.0, baseline=0.54,
                        height=192, width=320)
        seq = SyntheticStereoSequence(n_frames=10, rig=rig, seed=4)
        frames = [seq.frame(i)[0] for i in range(10)]  # left only
        cfg = MonoPipelineConfig(
            vo=MonoVOParams(
                intr=geo.Intrinsics(rig.fu, rig.fv, rig.cu, rig.cv),
                inlier_threshold=1.5,
            ),
            max_features=256,
        )
        pipe = MonoOdometryPipeline(cfg, seed=0)
        traj = pipe.run(frames)
        assert traj.shape == (10, 4, 4)
        gt = seq.gt_positions()
        dist = np.linalg.norm(np.diff(gt, axis=0), axis=1).sum()
        ate = ate_rmse(traj[:, :3, 3], gt, with_scale=True)
        assert ate < 0.05 * dist, f"similarity-ATE {ate:.3f} over {dist:.1f} m"

    def test_staged_engine_matches_per_frame(self):
        """The staged single-dispatch mono scan must reproduce the per-frame
        host loop (same global-index keys; uint8 wire quantization is the
        only difference) and recover the trajectory (VERDICT r4 item 4b)."""
        from uasl_motion_estimation_tpu.models.mono_pipeline import (
            MonoOdometryPipeline,
            MonoPipelineConfig,
            run_mono_staged,
        )
        from uasl_motion_estimation_tpu.utils.metrics import ate_rmse
        from uasl_motion_estimation_tpu.utils.synthetic import (
            CameraRig,
            SyntheticStereoSequence,
        )

        rig = CameraRig(fu=320.0, fv=320.0, cu=160.0, cv=96.0, baseline=0.54,
                        height=192, width=320)
        n = 10
        seq = SyntheticStereoSequence(n_frames=n, rig=rig, seed=3)
        # quantize to the wire format for BOTH engines so the comparison is
        # solver-for-solver, not pixel-rounding
        frames = [np.clip(seq.frame(i)[0], 0, 255).astype(np.uint8)
                  .astype(np.float32) for i in range(n)]
        cfg = MonoPipelineConfig(
            vo=MonoVOParams(
                intr=geo.Intrinsics(rig.fu, rig.fv, rig.cu, rig.cv),
                inlier_threshold=2.0,
            ),
            max_features=256,
        )
        traj_staged = run_mono_staged(frames, cfg, seed=0,
                                      initial_speed=0.8, chunk=3)
        pipe = MonoOdometryPipeline(cfg, seed=0, initial_speed=0.8)
        traj_loop = pipe.run(frames)
        assert traj_staged.shape == traj_loop.shape == (n, 4, 4)
        # same keys, same algorithm; the engines differ only in
        # vectorization context (chunk-vmapped vs single step), where XLA's
        # fusion choices shift f32 rounding enough to flip RANSAC inlier
        # tie-breaks on a handful of steps — trajectory-level agreement,
        # not bit identity, is the contract
        dev = np.max(np.abs(traj_staged[:, :3, 3] - traj_loop[:, :3, 3]))
        assert dev < 0.05, dev
        gt = seq.gt_positions()
        for traj in (traj_staged, traj_loop):
            ate = ate_rmse(traj[:, :3, 3], gt)
            assert ate < 0.12, ate
