"""Multi-device tests on the simulated 8-device CPU mesh (SURVEY.md section 4,
item 4): parallel pose chaining and the segment-sharded sequence step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from uasl_motion_estimation_tpu import parallel
from uasl_motion_estimation_tpu.models.pipeline import default_config
from uasl_motion_estimation_tpu.ops import geometry as geo, lie
from uasl_motion_estimation_tpu.utils.synthetic import (
    CameraRig,
    SyntheticStereoSequence,
)

RNG = np.random.default_rng(11)


def random_motions(n):
    ms = []
    for _ in range(n):
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = np.asarray(lie.so3_exp(jnp.asarray(
            RNG.normal(scale=0.1, size=3), jnp.float32)))
        T[:3, 3] = RNG.normal(scale=0.5, size=3)
        ms.append(T)
    return jnp.asarray(np.stack(ms))


def serial_chain(motions):
    pose = np.eye(4)
    out = []
    for m in np.asarray(motions, np.float64):
        pose = pose @ np.linalg.inv(m)
        out.append(pose.copy())
    return np.stack(out)


class TestChain:
    def test_chain_matches_serial(self):
        motions = random_motions(16)
        got = np.asarray(parallel.chain_motions(motions))
        np.testing.assert_allclose(got, serial_chain(motions), atol=1e-4)

    def test_sharded_chain_matches_serial(self):
        assert jax.device_count() >= 8, "conftest must provide 8 CPU devices"
        motions = random_motions(24)  # 3 frames per device
        mesh = parallel.make_mesh(8)
        got = np.asarray(parallel.sharded_chain_motions(motions, mesh))
        np.testing.assert_allclose(got, serial_chain(motions), atol=1e-4)


class TestMakeMesh:
    def test_one_dimensional_over_first_devices(self):
        mesh = parallel.make_mesh(4)
        assert mesh.axis_names == (parallel.segments.SEG_AXIS,)
        assert list(mesh.devices) == jax.devices()[:4]

    def test_all_devices_by_default(self):
        assert parallel.make_mesh().devices.size == jax.device_count()

    def test_raises_when_too_few_devices(self):
        """No silent fallback to another backend's devices."""
        with pytest.raises(ValueError, match="need 9 devices, have 8"):
            parallel.make_mesh(9)
        with pytest.raises(ValueError, match="need 2 devices, have 1"):
            parallel.make_mesh(2, devices=jax.devices()[:1])


class TestShardedSequence:
    @pytest.fixture(scope="class")
    def setup(self):
        rig = CameraRig(fu=200.0, fv=200.0, cu=80.0, cv=48.0, baseline=0.5,
                        height=96, width=160)
        n_pairs = 8
        seq = SyntheticStereoSequence(n_frames=n_pairs + 1, rig=rig, seed=6)
        frames = [seq.frame(i) for i in range(n_pairs + 1)]
        return rig, seq, frames, n_pairs

    def test_sharded_sequence_vo(self, setup):
        rig, seq, frames, n_pairs = setup
        cfg = default_config(
            geo.Intrinsics(rig.fu, rig.fv, rig.cu, rig.cv), rig.baseline
        )._replace(max_features=192)

        ls = jnp.asarray(np.stack([f[0] for f in frames]), jnp.float32)
        rs = jnp.asarray(np.stack([f[1] for f in frames]), jnp.float32)
        keys = jax.random.split(jax.random.key(0), n_pairs)

        mesh = parallel.make_mesh(8)
        poses, success, n_inl, covs = parallel.sharded_sequence_vo(
            parallel.shard_frames(ls[:-1], mesh),
            parallel.shard_frames(rs[:-1], mesh),
            parallel.shard_frames(ls[1:], mesh),
            parallel.shard_frames(rs[1:], mesh),
            keys, cfg, mesh,
        )
        assert bool(jnp.all(success)), np.asarray(n_inl)
        # per-motion covariances: finite, symmetric, plausible magnitude
        # (sub-mm^2 translation variance on the clean world)
        c = np.asarray(covs)
        assert c.shape == (n_pairs, 6, 6) and np.isfinite(c).all()
        np.testing.assert_allclose(c, np.swapaxes(c, 1, 2), atol=1e-8)
        assert (np.trace(c, axis1=1, axis2=2) < 1e-2).all()
        est = np.concatenate([np.zeros((1, 3)), np.asarray(poses)[:, :3, 3]])
        gt = seq.gt_positions() - seq.gt_positions()[0]
        err = np.linalg.norm(est - gt, axis=-1).max()
        # loose GT check for the tiny low-res config; exactness is checked below
        assert err < 0.25, f"max position error {err:.3f} m"

        # sharding must not change the result: same per-pair solves on one
        # device, chained serially, give the same trajectory
        from uasl_motion_estimation_tpu.models.pipeline import vo_step

        single = [
            vo_step(ls[i], rs[i], ls[i + 1], rs[i + 1], keys[i], cfg)
            for i in range(n_pairs)
        ]
        motions = np.stack([np.asarray(o.motion) for o in single])
        np.testing.assert_allclose(
            np.asarray(poses), serial_chain(motions), atol=5e-4
        )


class TestStitching:
    def make_segments(self, s=4, f=8, overlap=2, noise=0.0, seed=0):
        """Ground-truth trajectory cut into overlapping segments, each
        re-gauged to its own first frame (+ optional per-segment noise)."""
        from uasl_motion_estimation_tpu.parallel import stitching

        rng = np.random.default_rng(seed)
        n = s * (f - overlap) + overlap
        gt = []
        pose = np.eye(4)
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
            chunk = np.linalg.inv(chunk[0]) @ chunk  # own gauge
            if noise:
                for k in range(1, f):
                    d = np.eye(4)
                    d[:3, 3] = rng.normal(scale=noise, size=3)
                    chunk[k] = chunk[k] @ d
            segs.append(chunk)
        return jnp.asarray(np.stack(segs), jnp.float32), gt

    def test_exact_segments_stitch_exactly(self):
        from uasl_motion_estimation_tpu.parallel import stitching

        segs, gt = self.make_segments()
        out = np.asarray(stitching.stitch_segments(segs, overlap=2))
        want = np.linalg.inv(gt[0]) @ gt
        assert out.shape == want.shape
        np.testing.assert_allclose(out, want, atol=1e-4)

    def test_noisy_overlap_fuses(self):
        from uasl_motion_estimation_tpu.parallel import stitching

        segs, gt = self.make_segments(noise=0.01, seed=3)
        out = np.asarray(stitching.stitch_segments(segs, overlap=2))
        want = np.linalg.inv(gt[0]) @ gt
        err = np.linalg.norm(out[:, :3, 3] - want[:, :3, 3], axis=-1)
        assert err.max() < 0.15, err.max()

    def test_covariance_weights_prefer_confident_frames(self):
        from uasl_motion_estimation_tpu.parallel import stitching

        covs = jnp.stack([jnp.eye(6) * 1e-4, jnp.eye(6) * 1e2])
        w = np.asarray(stitching.weights_from_covariances(covs))
        assert w[0] > 1e3 * w[1]

    def test_weighted_stitching_beats_uniform_on_degraded_overlap(self):
        """One overlap candidate per boundary is corrupted (large pose
        error) with a correspondingly large covariance: weighted fusion
        must recover near-exactly where the uniform mean soaks the error
        into every downstream segment's gauge (VERDICT r4 item 2)."""
        from uasl_motion_estimation_tpu.parallel import stitching

        segs, gt = self.make_segments(s=4, f=8, overlap=2)
        segs = np.array(segs)  # writable copy
        rng = np.random.default_rng(5)
        covs_prev = np.tile(np.eye(6) * 1e-6, (3, 2, 1, 1))
        covs_next = np.tile(np.eye(6) * 1e-6, (3, 2, 1, 1))
        for b in range(3):
            # corrupt the SECOND overlap frame as seen by the next segment
            d = np.eye(4)
            d[:3, 3] = rng.normal(scale=0.5, size=3)
            segs[b + 1, 1] = segs[b + 1, 1] @ d
            covs_next[b, 1] = np.eye(6) * 1.0  # and say so
        w = np.stack([
            stitching.overlap_weights_np(covs_prev[b], covs_next[b])
            for b in range(3)
        ])
        want = np.linalg.inv(gt[0]) @ gt
        out_u = np.asarray(stitching.stitch_segments(
            jnp.asarray(segs, jnp.float32), overlap=2))
        out_w = np.asarray(stitching.stitch_segments(
            jnp.asarray(segs, jnp.float32), overlap=2,
            overlap_weights=jnp.asarray(w, jnp.float32)))
        err_u = np.linalg.norm(out_u[:, :3, 3] - want[:, :3, 3], axis=-1)
        err_w = np.linalg.norm(out_w[:, :3, 3] - want[:, :3, 3], axis=-1)
        # the corrupted frames themselves keep their local error; the GAUGE
        # of downstream segments must not inherit it
        assert err_w.max() < 0.05 * err_u.max(), (err_w.max(), err_u.max())

    def test_covariance_circuit_end_to_end_degraded_frames(self):
        """Full circuit on rendered frames: VO emits per-motion covariances
        (StereoVOResult.cov) -> chained to per-frame pose covariances
        (chain_covariances_np) -> overlap weights. A photometrically
        destroyed overlap frame must make the covariance chain (and
        therefore the fusion weights) discriminate the degraded overlap
        candidates by orders of magnitude — the informativeness that the
        controlled test above shows translating into stitching accuracy.
        (A destroyed SHARED frame alone cannot demonstrate weighted-vs-
        uniform end-to-end: both neighbors fail identically across it and
        their identity-motion errors cancel in the alignment candidates.)"""
        from uasl_motion_estimation_tpu.models.pipeline import vo_step
        from uasl_motion_estimation_tpu.parallel import stitching

        rig = CameraRig(fu=200.0, fv=200.0, cu=80.0, cv=48.0, baseline=0.5,
                        height=96, width=160)
        f, ov = 6, 3
        n = 2 * f - ov  # two segments sharing ov frames
        seq = SyntheticStereoSequence(n_frames=n, rig=rig, seed=6)
        frames = [list(map(np.asarray, seq.frame(i))) for i in range(n)]
        rng = np.random.default_rng(9)
        mid = f - ov + 1  # middle overlap frame
        for cam in (0, 1):  # destroy its pixels for both cameras
            frames[mid][cam] = np.clip(
                frames[mid][cam] * 0.15
                + rng.normal(scale=60.0, size=frames[mid][cam].shape),
                0, 255)
        cfg = default_config(
            geo.Intrinsics(rig.fu, rig.fv, rig.cu, rig.cv), rig.baseline,
            image_shape=(96, 160),
        )._replace(max_features=128)

        def run_segment(start):
            motions, covs, succ = [], [], []
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
                succ.append(bool(out.success))
            pose_cov = stitching.chain_covariances_np(motions, covs)
            return pose_cov, succ

        c0, succ0 = run_segment(0)
        c1, succ1 = run_segment(f - ov)
        # the motions across the destroyed frame degraded or failed
        assert not (succ0[mid - 1] and succ0[mid]) or not (
            succ1[mid - 1 - (f - ov)] and succ1[mid - (f - ov)])
        w = stitching.overlap_weights_np(c0[f - ov:], c1[:ov])
        # overlap frame 0 precedes the destroyed frame in both chains;
        # frames 1..ov-1 inherit the destroyed motion's covariance
        assert w[0] > 1e2 * w[1], w
        assert w[0] > 1e2 * w[2], w
        # and the clean candidate's chained uncertainty is small in absolute
        # terms (the circuit stays informative, not just relative)
        assert np.trace(c0[f - ov]) + np.trace(c1[0]) < 1e-2


class TestShardedUnified:
    def test_window_parallel_unified_matches_single_device(self):
        """The unified integrated system with windows sharded over the
        8-device mesh must reproduce the single-device scan: windows are
        independent and keys derive from global motion indices, so the
        per-window solves are the same computation placed differently."""
        from uasl_motion_estimation_tpu.models.smoother import (
            SmootherConfig,
            compose_unified,
            unified_system_scan,
        )
        from uasl_motion_estimation_tpu.utils import metrics

        rig = CameraRig(fu=200.0, fv=200.0, cu=80.0, cv=48.0, baseline=0.5,
                        height=96, width=160)
        n = 34  # 8 aligned windows of 5 at stride 4 + clamped tail (29)
        seq = SyntheticStereoSequence(n_frames=n, rig=rig, seed=6)
        frames = [seq.frame(i) for i in range(n)]
        ls = jnp.asarray(np.clip(np.stack([f[0] for f in frames]), 0, 255)
                         .astype(np.uint8))
        rs = jnp.asarray(np.clip(np.stack([f[1] for f in frames]), 0, 255)
                         .astype(np.uint8))
        pipe = default_config(
            geo.Intrinsics(rig.fu, rig.fv, rig.cu, rig.cv), rig.baseline,
            image_shape=(96, 160),
        )._replace(max_features=128)
        cfg = SmootherConfig(pipe=pipe)
        key = jax.random.key(0)

        mesh = parallel.make_mesh(8)
        out_sharded = jax.device_get(
            parallel.sharded_unified_scan(ls, rs, key, cfg, mesh)
        )
        out_single = jax.device_get(
            unified_system_scan(ls, rs, key, cfg, wchunk=3)
        )
        assert out_sharded.vo_motions.shape == out_single.vo_motions.shape
        # same problems, different placement: agree to float noise
        np.testing.assert_allclose(
            out_sharded.vo_motions, out_single.vo_motions, atol=1e-3
        )
        np.testing.assert_allclose(
            out_sharded.refined_motions, out_single.refined_motions,
            atol=1e-2
        )
        res = compose_unified(out_sharded, n, cfg)
        gt = seq.gt_positions()
        ate = metrics.ate_rmse(res.traj_ba[:, :3, 3], gt)
        assert ate < 0.15, ate
