"""Closed-form minimal pose solvers (ops/pnp.py).

The reference has no minimal solver — it seeds RANSAC hypotheses with a full
GN optimisation (src/vo/StereoVisualOdometry.cpp:59-71); these solvers are the
batched closed-form replacement (BASELINE config 1 names P3P).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from uasl_motion_estimation_tpu.ops import lie, pnp


def _random_rigid(rng):
    ang = rng.uniform(-0.3, 0.3, 3)
    R = np.asarray(lie.euler_to_R(jnp.asarray(ang)), np.float64)
    t = rng.uniform(-1, 1, 3)
    return R, t


class TestTriad:
    def test_exact_recovery(self):
        rng = np.random.default_rng(0)
        for _ in range(20):
            R, t = _random_rigid(rng)
            p = rng.uniform(-5, 5, (3, 3))
            q = p @ R.T + t
            Rh, th, ok = pnp.rigid_align_3pt(
                jnp.asarray(p, jnp.float32), jnp.asarray(q, jnp.float32)
            )
            assert bool(ok)
            np.testing.assert_allclose(np.asarray(Rh), R, atol=2e-4)
            np.testing.assert_allclose(np.asarray(th), t, atol=2e-3)

    def test_degenerate_collinear(self):
        p = jnp.asarray([[0.0, 0, 0], [1, 0, 0], [2, 0, 0]], jnp.float32)
        _, _, ok = pnp.rigid_align_3pt(p, p)
        assert not bool(ok)

    def test_batched(self):
        rng = np.random.default_rng(1)
        R, t = _random_rigid(rng)
        p = rng.uniform(-5, 5, (7, 3, 3)).astype(np.float32)
        q = (p @ R.T + t).astype(np.float32)
        Rh, th, ok = pnp.rigid_align_3pt(jnp.asarray(p), jnp.asarray(q))
        assert Rh.shape == (7, 3, 3) and th.shape == (7, 3)
        assert bool(ok.all())
        np.testing.assert_allclose(np.asarray(Rh), np.broadcast_to(R, (7, 3, 3)),
                                   atol=5e-4)


class TestUmeyama:
    def test_least_squares_recovery(self):
        rng = np.random.default_rng(2)
        R, t = _random_rigid(rng)
        p = rng.uniform(-5, 5, (50, 3))
        q = p @ R.T + t + rng.normal(0, 1e-4, (50, 3))
        Ru, tu = pnp.rigid_align_umeyama(
            jnp.asarray(p, jnp.float32), jnp.asarray(q, jnp.float32)
        )
        np.testing.assert_allclose(np.asarray(Ru), R, atol=1e-3)
        np.testing.assert_allclose(np.asarray(tu), t, atol=1e-3)

    def test_weighted_ignores_outliers(self):
        rng = np.random.default_rng(3)
        R, t = _random_rigid(rng)
        p = rng.uniform(-5, 5, (30, 3))
        q = p @ R.T + t
        q[:5] += 100.0  # gross outliers
        w = np.ones(30, np.float32)
        w[:5] = 0.0
        Ru, tu = pnp.rigid_align_umeyama(
            jnp.asarray(p, jnp.float32), jnp.asarray(q, jnp.float32),
            jnp.asarray(w),
        )
        np.testing.assert_allclose(np.asarray(Ru), R, atol=1e-3)
        np.testing.assert_allclose(np.asarray(tu), t, atol=1e-3)


class TestP3PGrunert:
    def test_recovers_pose_most_trials(self):
        """>=90% of random configurations yield a candidate within tolerance
        (remaining cases are resolvent-root degeneracies — in RANSAC a missed
        sample costs one hypothesis, disambiguation is by inlier count)."""
        rng = np.random.default_rng(4)
        hits = 0
        n_trials = 30
        for _ in range(n_trials):
            R, t = _random_rigid(rng)
            pts_w = rng.uniform(-3, 3, (3, 3))
            pts_w[:, 2] += 12.0
            cam = pts_w @ R.T + t
            rays = cam / np.linalg.norm(cam, axis=1, keepdims=True)
            Rs, ts, oks = pnp.p3p_grunert(
                jnp.asarray(pts_w, jnp.float32), jnp.asarray(rays, jnp.float32)
            )
            errs = [
                np.abs(np.asarray(Rs[i]) - R).max()
                + np.abs(np.asarray(ts[i]) - t).max()
                for i in range(4)
                if bool(oks[i])
            ]
            if errs and min(errs) < 1e-2:
                hits += 1
        assert hits >= 0.9 * n_trials, f"only {hits}/{n_trials} recovered"

    def test_candidates_reproject(self):
        """Valid candidates place the 3 points on their bearing rays."""
        rng = np.random.default_rng(5)
        R, t = _random_rigid(rng)
        pts_w = rng.uniform(-3, 3, (3, 3))
        pts_w[:, 2] += 10.0
        cam = pts_w @ R.T + t
        rays = cam / np.linalg.norm(cam, axis=1, keepdims=True)
        Rs, ts, oks = pnp.p3p_grunert(
            jnp.asarray(pts_w, jnp.float32), jnp.asarray(rays, jnp.float32)
        )
        for i in range(4):
            if not bool(oks[i]):
                continue
            cam_i = pts_w @ np.asarray(Rs[i]).T + np.asarray(ts[i])
            dirs = cam_i / np.linalg.norm(cam_i, axis=1, keepdims=True)
            cosang = np.sum(dirs * rays, axis=1)
            assert np.all(cosang > 1.0 - 1e-4)


class TestQuartic:
    def test_known_roots(self):
        # (x-1)(x-2)(x-3)(x-4) = x^4 -10x^3 +35x^2 -50x +24
        x, imag = pnp._solve_quartic(
            *(jnp.float32(v) for v in (1.0, -10.0, 35.0, -50.0, 24.0))
        )
        got = np.sort(np.asarray(x))
        np.testing.assert_allclose(got, [1.0, 2.0, 3.0, 4.0], atol=1e-3)
        np.testing.assert_allclose(np.asarray(imag), 0.0, atol=1e-5)

    def test_complex_pair_flagged(self):
        # (x^2+1)(x-1)(x-2) = x^4 -3x^3 +3x^2 -3x +2
        x, imag = pnp._solve_quartic(
            *(jnp.float32(v) for v in (1.0, -3.0, 3.0, -3.0, 2.0))
        )
        x = np.asarray(x)
        imag = np.asarray(imag)
        real = np.sort(x[imag < 1e-5])
        np.testing.assert_allclose(real, [1.0, 2.0], atol=1e-3)
        assert (imag > 0.5).sum() == 2
