"""Smoke test of the stereo-VO main path on NVIDIA GPUs.

Drives the system through the entry points a user calls, at the full width
the repo supports (KITTI-size 376x1241 stereo rig, 500 features), and gates
every result:

  1. MI at the matcher's full width (64,000 patch pairs) under the default
     matmul precision, against a float64 numpy histogram;
  2. staged stereo VO (``OdometryPipeline.stage_frames`` + ``run_staged``):
     ATE below 2% of the distance travelled;
  3. streaming (``run_streaming``) with the same chunk: same trajectory as
     the staged run within 1e-4 m;
  4. unified VO+BA (``run_unified_system``) on the corrupted world: every
     window's BA converged, finite covariances, ATE(BA) < ATE(VO);
  5. latency mode (``OdometrySystem.process_pair``) with a checkpoint saved
     mid-run and resumed: the resumed trajectory agrees with the
     uninterrupted one;
  6. the cross-modal MI scale session (``run_cross_modal_staged``) at the
     matcher's full width.

With ``--four`` it runs instead only the paths that exist across four GPUs,
each beside its single-device comparison: segment-sharded VO, the sharded
unified engine and window-parallel BA.

Run from the checkout on a machine with a GPU:

    python chip_smoke.py          # one GPU
    python chip_smoke.py --four   # four GPUs

The last line of standard output is one JSON object
``{"ok": true, "device": {...}}``; any failed gate raises instead, so the
script exits nonzero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np

N_FRAMES = 40
CHUNK = 13  # 39 steps -> 3 equal lax.map groups
MI_PAIRS = 500 * 128  # the MI matcher's cost volume: features x disparities
MI_ATOL = 1e-5  # bits: exact counts (one-hots are exact in TF32), f32 log2
LATENCY_FRAMES = 10
LATENCY_RESUME_AT = 5
# Resumed-vs-uninterrupted tolerance. The resumed run replays the same
# compiled programs on the same inputs, so on the CPU the trajectories are
# bit-identical; on the GPU an XLA reduction may sum in another order from
# one run to the next (atomics), which moves float32 poses by ~1e-7 m.
LATENCY_ATOL_M = 1e-6
STREAM_ATOL_M = 1e-4
CROSS_MODAL_FRAMES = 13  # 12 steps -> 3 groups of the default chunk (4)
CROSS_MODAL_MAX_SCALE_ERR = 0.02  # median, as tests/test_scale.py gates it


class PhaseFailed(RuntimeError):
    pass


def check(name: str, ok: bool, detail: str) -> None:
    """Print a phase result beside its gate; raise when the gate fails."""
    print(f"[{'PASS' if ok else 'FAIL'}] {name}: {detail}", flush=True)
    if not ok:
        raise PhaseFailed(f"{name}: {detail}")


def require_gpus(count: int):
    """Exit nonzero unless JAX's default backend has ``count`` GPUs."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu" or len(devices) < count:
        sys.exit(
            f"{Path(sys.argv[0]).name}: no GPU — needs {count}, JAX found "
            f"{len(devices)} {devices[0].platform} device(s)"
        )
    return devices


def card() -> str:
    """Each GPU's ``name, power.limit`` as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def print_precision() -> None:
    """The matmul precision in effect, and what it means for an f32 product
    on this device (relative error of an unannotated f32 matmul)."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    a = rng.standard_normal((512, 512)).astype(np.float32)
    b = rng.standard_normal((512, 512)).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)

    def rel_err(precision):
        got = np.asarray(jnp.matmul(jnp.asarray(a), jnp.asarray(b),
                                    precision=precision), np.float64)
        return float(np.abs(got - exact).max() / np.abs(exact).max())

    print(f"matmul precision: jax_default_matmul_precision="
          f"{jax.config.jax_default_matmul_precision}; unannotated f32 "
          f"matmul rel err {rel_err(None):.2e}, precision='highest' "
          f"{rel_err('highest'):.2e}", flush=True)


# ---------------------------------------------------------------------------
# Workloads
# ---------------------------------------------------------------------------


class Stereo(NamedTuple):
    rig: object  # utils.synthetic.CameraRig
    cfg: object  # models.pipeline.PipelineConfig
    seq: object  # utils.synthetic.SyntheticStereoSequence
    frames: list


def stereo_workload(rig, n_frames: int, seed: int = 0, corrupted=False,
                    cross_modal=False, max_features: int | None = None,
                    max_disparity: int | None = None) -> Stereo:
    """Synthetic sequence + ``default_config`` for ``rig``; the optional
    overrides only shrink the configuration for small test rigs."""
    from uasl_motion_estimation_tpu.models.frontend import MatcherConfig
    from uasl_motion_estimation_tpu.models.pipeline import default_config
    from uasl_motion_estimation_tpu.ops.geometry import Intrinsics
    from uasl_motion_estimation_tpu.utils.synthetic import (
        CorruptionConfig,
        SyntheticStereoSequence,
    )

    seq = SyntheticStereoSequence(
        n_frames=n_frames, rig=rig, seed=seed,
        corruption=CorruptionConfig() if corrupted else None,
        cross_modal=cross_modal,
    )
    cfg = default_config(
        Intrinsics(rig.fu, rig.fv, rig.cu, rig.cv), rig.baseline,
        image_shape=(rig.height, rig.width),
    )
    if max_features is not None:
        cfg = cfg._replace(max_features=max_features)
    if max_disparity is not None:
        cfg = cfg._replace(matcher=MatcherConfig(max_disparity=max_disparity))
    return Stereo(rig, cfg, seq, [seq.frame(i) for i in range(n_frames)])


def distance(seq) -> float:
    gt = seq.gt_positions()
    return float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())


# ---------------------------------------------------------------------------
# One-card phases
# ---------------------------------------------------------------------------


def mi_float64(a: np.ndarray, b: np.ndarray, bins: int = 20) -> np.ndarray:
    """(B,) MI in bits of B pairs of patches (B, H, W): plain float64 numpy
    joint histograms (one bincount over pair x joint-bin). Bin ids are
    computed as ``ops.similarity.quantise`` defines them, in float32: a
    float64 product puts about one pixel in 10^6 across a bin edge."""
    def quantise(x):
        q = np.floor(x.reshape(len(x), -1).astype(np.float32)
                     * np.float32(bins / 256.0))
        return np.clip(q, 0, bins - 1).astype(np.int64)

    qa, qb = quantise(a), quantise(b)
    n, p = qa.shape
    flat = (np.arange(n)[:, None] * bins * bins + qa * bins + qb).ravel()
    pj = np.bincount(flat, minlength=n * bins * bins).reshape(
        n, bins, bins) / p
    outer = pj.sum(2, keepdims=True) * pj.sum(1, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        terms = np.where(pj > 0, pj * np.log2(pj / outer), 0.0)
    return terms.sum(axis=(1, 2))


def phase_mi(n_pairs: int = MI_PAIRS) -> float:
    """The MI path of the matcher and the scale optimiser on ``n_pairs``
    11x11 patch pairs, against float64 numpy."""
    import jax
    import jax.numpy as jnp

    from uasl_motion_estimation_tpu.ops import similarity as sim

    rng = np.random.default_rng(0)
    a = rng.uniform(0, 255, (n_pairs, 11, 11)).astype(np.float32)
    # half the pairs correlated, half independent: MI from ~1 to ~4 bits
    b = rng.uniform(0, 255, (n_pairs, 11, 11)).astype(np.float32)
    b[::2] = np.clip(a[::2] + rng.normal(0, 8, a[::2].shape), 0, 255)
    got = np.asarray(jax.jit(sim.mutual_information)(jnp.asarray(a),
                                                     jnp.asarray(b)))
    want = mi_float64(a, b)
    err = float(np.abs(got - want).max())
    check("MI at full width", got.shape == (n_pairs,) and err < MI_ATOL,
          f"{n_pairs} pairs x 121 px, 20 bins: max |jnp - float64| "
          f"{err:.2e} bits < {MI_ATOL:.0e} (MI range "
          f"{want.min():.3f}..{want.max():.3f})")
    return err


def phase_staged(w: Stereo, chunk: int = CHUNK):
    """Staged single-dispatch VO; prints the scan's memory analysis."""
    import jax
    import jax.numpy as jnp

    from uasl_motion_estimation_tpu.models.pipeline import (
        OdometryPipeline,
        _vo_scan_packed,
    )
    from uasl_motion_estimation_tpu.utils.metrics import ate_rmse

    pipe = OdometryPipeline(w.cfg, seed=0)
    ls, rs = pipe.stage_frames(w.frames)
    traj = pipe.run_staged(ls, rs, chunk=chunk)

    steps = -(-(len(w.frames) - 1) // chunk) * chunk
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(0), i))(
        jnp.arange(steps, dtype=jnp.int32))
    mem = _vo_scan_packed.lower(ls, rs, keys, w.cfg, chunk).compile(
    ).memory_analysis()
    print(f"staged scan memory_analysis: {mem}", flush=True)

    ate = ate_rmse(traj[:, :3, 3], w.seq.gt_positions())
    dist = distance(w.seq)
    check("staged VO", bool(np.isfinite(traj).all()) and ate < 0.02 * dist,
          f"{len(w.frames)} frames {w.rig.height}x{w.rig.width}, "
          f"{w.cfg.max_features} features: ATE {ate:.4f} m < "
          f"{0.02 * dist:.4f} m (2% of {dist:.2f} m)")
    return traj


def phase_streaming(w: Stereo, traj_staged, chunk: int = CHUNK) -> float:
    from uasl_motion_estimation_tpu.models.pipeline import OdometryPipeline

    traj = OdometryPipeline(w.cfg, seed=0).run_streaming(
        iter(w.frames), chunk=chunk)
    dev = float(np.abs(traj[:, :3, 3] - traj_staged[:, :3, 3]).max())
    check("streaming", traj.shape == traj_staged.shape
          and dev < STREAM_ATOL_M,
          f"chunk {chunk}: max |streaming - staged| position {dev:.2e} m "
          f"< {STREAM_ATOL_M:.0e} m")
    return dev


def phase_unified(w: Stereo):
    from uasl_motion_estimation_tpu.models.smoother import (
        SmootherConfig,
        run_unified_system,
    )
    from uasl_motion_estimation_tpu.utils.metrics import ate_rmse

    res = run_unified_system(w.frames, SmootherConfig(pipe=w.cfg), seed=0)
    gt = w.seq.gt_positions()
    ate_vo = ate_rmse(res.traj_vo[:, :3, 3], gt)
    ate_ba = ate_rmse(res.traj_ba[:, :3, 3], gt)
    n_conv = int(np.sum(res.ba_converged))
    finite = bool(np.isfinite(res.motion_cov).all()
                  and np.isfinite(res.pose_cov).all())
    check("unified VO+BA",
          n_conv == len(res.ba_converged) and finite and ate_ba < ate_vo,
          f"corrupted world, {len(w.frames)} frames: BA converged "
          f"{n_conv}/{len(res.ba_converged)}, covariances finite {finite}, "
          f"ATE BA {ate_ba:.4f} m < VO {ate_vo:.4f} m")
    return res


def phase_latency(w: Stereo, workdir: Path,
                  n_frames: int = LATENCY_FRAMES,
                  resume_at: int = LATENCY_RESUME_AT) -> float:
    """Per-frame host loop with BA; checkpoint at ``resume_at``, resume in
    a fresh system, compare with the uninterrupted run."""
    from uasl_motion_estimation_tpu.models.odometry import (
        OdometryConfig,
        OdometrySystem,
    )
    from uasl_motion_estimation_tpu.utils.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )

    cfg = OdometryConfig(vo=w.cfg.vo, max_tracks=w.cfg.max_features,
                         matcher=w.cfg.matcher)
    frames = w.frames[:n_frames]
    ckpt = str(workdir / "latency_ckpt.npz")
    a = OdometrySystem(cfg, seed=0)
    n_ba = 0
    for i, f in enumerate(frames):
        if i == resume_at:
            save_checkpoint(ckpt, a)
        n_ba += "ba_cost" in a.process_pair(*f)
    b = OdometrySystem(cfg, seed=0)
    load_checkpoint(ckpt, b)
    for f in frames[resume_at:]:
        b.process_pair(*f)
    ta, tb = np.asarray(a.trajectory), np.asarray(b.trajectory)
    dev = float(np.abs(ta[:, :3, 3] - tb[:, :3, 3]).max())
    check("latency mode resume",
          ta.shape == tb.shape == (n_frames, 4, 4) and dev < LATENCY_ATOL_M
          and bool(np.isfinite(ta).all()),
          f"{n_frames} frames, checkpoint at {resume_at}, {n_ba} BA "
          f"solves: max |resumed - uninterrupted| {dev:.2e} m < "
          f"{LATENCY_ATOL_M:.0e} m")
    return dev


def phase_cross_modal(w: Stereo):
    """Mono VO + MI matcher + MI-LM scale, one dispatch for the session."""
    from uasl_motion_estimation_tpu.models.cross_modal import (
        CrossModalConfig,
        run_cross_modal_staged,
    )
    from uasl_motion_estimation_tpu.models.mono_vo import MonoVOParams
    from uasl_motion_estimation_tpu.models.scale import ScaleConfig

    intr = w.cfg.vo.intr1
    cfg = CrossModalConfig(
        vo=MonoVOParams(intr=intr),
        scale=ScaleConfig(intr=intr, baseline=w.rig.baseline),
        matcher=w.cfg.matcher,
        max_features=w.cfg.max_features,
    )
    res = run_cross_modal_staged(w.frames, cfg, seed=0)
    gt_speed = np.linalg.norm(np.diff(w.seq.poses[:, :3, 3], axis=0), axis=1)
    err = np.abs(res.scales - gt_speed) / gt_speed
    med = float(np.median(err))
    n_ok = sum(r["success"] for r in res.records)
    check("cross-modal session",
          bool(np.isfinite(res.trajectory).all()) and n_ok == len(err)
          and med < CROSS_MODAL_MAX_SCALE_ERR,
          f"{len(w.frames)} frames, {cfg.max_features} features x "
          f"{cfg.matcher.max_disparity} disparities MI-matched per frame: "
          f"VO ok {n_ok}/{len(err)}, median scale error {100 * med:.2f}% "
          f"< {100 * CROSS_MODAL_MAX_SCALE_ERR:.0f}%")
    return res


def run_one_card(workdir: Path) -> None:
    from uasl_motion_estimation_tpu.utils.synthetic import CameraRig

    rig = CameraRig()  # KITTI odometry size: 376x1241
    phases = [("MI at full width", lambda: phase_mi())]
    clean = stereo_workload(rig, N_FRAMES)
    staged = {}
    phases += [
        ("staged VO", lambda: staged.setdefault("traj", phase_staged(clean))),
        ("streaming", lambda: phase_streaming(clean, staged["traj"])),
        ("unified VO+BA", lambda: phase_unified(
            stereo_workload(rig, N_FRAMES, corrupted=True))),
        ("latency mode", lambda: phase_latency(clean, workdir)),
        ("cross-modal", lambda: phase_cross_modal(
            stereo_workload(rig, CROSS_MODAL_FRAMES, seed=3,
                            cross_modal=True))),
    ]
    for name, run in phases:
        t0 = time.perf_counter()
        run()
        print(f"  {name}: {time.perf_counter() - t0:.1f} s wall "
              "(compilation included)", flush=True)


# ---------------------------------------------------------------------------
# Four-card phases
# ---------------------------------------------------------------------------


def shard_devices(x) -> str:
    return ", ".join(f"{s.index[0]}: {s.device}"
                     for s in x.addressable_shards)


def phase_sharded_vo(w: Stereo, mesh) -> float:
    """Segment-sharded VO over the mesh vs the same call on one device."""
    import jax
    import jax.numpy as jnp

    from uasl_motion_estimation_tpu import parallel

    ls = jnp.asarray(np.stack([f[0] for f in w.frames]), jnp.float32)
    rs = jnp.asarray(np.stack([f[1] for f in w.frames]), jnp.float32)
    keys = jax.random.split(jax.random.key(0), len(w.frames) - 1)

    def run(m):
        return parallel.sharded_sequence_vo(
            parallel.shard_frames(ls[:-1], m), parallel.shard_frames(rs[:-1], m),
            parallel.shard_frames(ls[1:], m), parallel.shard_frames(rs[1:], m),
            keys, w.cfg, m)

    poses, success = run(mesh)[:2]
    print(f"sharded VO poses: {poses.sharding.device_set}; shards "
          f"{shard_devices(poses)}", flush=True)
    single, _ = run(parallel.make_mesh(1))[:2]
    dev = float(np.abs(np.asarray(poses)[:, :3, 3]
                       - np.asarray(single)[:, :3, 3]).max())
    check("sharded VO", dev < 1e-3 and bool(success.all()),
          f"{len(w.frames) - 1} motions over {mesh.devices.size} devices: "
          f"max |sharded - single-device| {dev:.2e} m < 1e-3 m")
    return dev


def phase_sharded_unified(w: Stereo, mesh) -> float:
    import jax
    import jax.numpy as jnp

    from uasl_motion_estimation_tpu.models.smoother import (
        SmootherConfig,
        compose_unified,
        unified_system_scan,
    )
    from uasl_motion_estimation_tpu.parallel.unified import (
        sharded_unified_scan,
    )

    cfg = SmootherConfig(pipe=w.cfg)
    ls = jnp.asarray(np.stack([f[0] for f in w.frames]), jnp.float32)
    rs = jnp.asarray(np.stack([f[1] for f in w.frames]), jnp.float32)
    key = jax.random.key(0)
    out = sharded_unified_scan(ls, rs, key, cfg, mesh)
    print(f"sharded unified ba_cost: {out.ba_cost.sharding.device_set}; "
          f"shards {shard_devices(out.ba_cost)}", flush=True)
    n = len(w.frames)
    res = compose_unified(jax.device_get(out), n, cfg)
    single = compose_unified(
        jax.device_get(unified_system_scan(ls, rs, key, cfg)), n, cfg)
    dev = float(np.linalg.norm(
        res.traj_ba[:, :3, 3] - single.traj_ba[:, :3, 3], axis=-1).max())
    conv = bool(np.all(res.ba_converged))
    check("sharded unified", dev < 1e-3 and conv,
          f"{n} frames, {len(res.ba_converged)} windows over "
          f"{mesh.devices.size} devices, all converged {conv}: max "
          f"|sharded - unified_system_scan| {dev:.2e} m < 1e-3 m")
    return dev


def ba_windows_problem(rig, n_windows: int, window: int = 4, n_fixed: int = 2,
                       n_pts: int = 500, seed: int = 3):
    """Overlapping stereo BA windows seen by ``rig`` along a forward drive,
    perturbed off the optimum (window 0 keeps the gauge). Returns
    (problem, BAConfig, true cams per window)."""
    import jax.numpy as jnp

    from uasl_motion_estimation_tpu.ops import lie
    from uasl_motion_estimation_tpu.ops.geometry import Intrinsics
    from uasl_motion_estimation_tpu.solvers.ba import BAConfig, BAProblem

    stride = window - n_fixed
    n_cams = stride * (n_windows - 1) + window
    rng = np.random.default_rng(seed)
    cams = np.stack([
        np.concatenate([[0.002 * i, 0.004 * i, 0.001 * i],
                        [0.05 * i, 0.02 * i, -0.8 * i]])
        for i in range(n_cams)
    ]).astype(np.float32)
    pts = np.stack([rng.uniform(-10, 10, n_pts), rng.uniform(-3, 3, n_pts),
                    rng.uniform(8, 45, n_pts)], -1).astype(np.float32)
    obs = np.zeros((n_cams, n_pts, 4), np.float32)
    mask = np.zeros((n_cams, n_pts), bool)
    for c in range(n_cams):
        rot = np.asarray(lie.so3_exp(jnp.asarray(cams[c, :3])))
        pc = pts @ rot.T + cams[c, 3:6]
        z = pc[:, 2]
        v = rig.fv * pc[:, 1] / z + rig.cv
        obs[c] = np.stack([rig.fu * pc[:, 0] / z + rig.cu, v,
                           rig.fu * (pc[:, 0] - rig.baseline) / z + rig.cu,
                           v], -1)
        mask[c] = z > 1.0
    starts = [i * stride for i in range(n_windows)]
    true = np.stack([cams[s:s + window] for s in starts])
    init = true + rng.normal(scale=0.01, size=true.shape).astype(np.float32)
    init[0, :n_fixed] = true[0, :n_fixed]
    problem = BAProblem(
        jnp.asarray(init), jnp.asarray(np.stack([pts] * n_windows)),
        jnp.asarray(np.stack([obs[s:s + window] for s in starts])),
        jnp.asarray(np.stack([mask[s:s + window] for s in starts])),
    )
    cfg = BAConfig(intr=Intrinsics(rig.fu, rig.fv, rig.cu, rig.cv),
                   baseline=rig.baseline, n_fixed=n_fixed)
    return problem, cfg, true


def phase_window_ba(rig, mesh, n_windows: int = 4) -> float:
    import jax

    from uasl_motion_estimation_tpu.parallel.ba_windows import (
        shard_windows,
        window_parallel_ba,
    )
    from uasl_motion_estimation_tpu.solvers.ba import ba_solve

    problem, cfg, true = ba_windows_problem(rig, n_windows)
    # block Gauss-Seidel moves a correction one window per sweep
    res = window_parallel_ba(shard_windows(problem, mesh), cfg, mesh,
                             n_sweeps=n_windows)
    print(f"window BA cams: {res.cam.sharding.device_set}; shards "
          f"{shard_devices(res.cam)}", flush=True)
    out = np.asarray(res.cam)
    halo = max(float(np.abs(out[i, -cfg.n_fixed:]
                            - out[i + 1, :cfg.n_fixed]).max())
               for i in range(n_windows - 1))
    # single-device comparison: the same windows solved independently
    alone = np.asarray(jax.jit(jax.vmap(lambda p: ba_solve(p, cfg)))(
        problem).cam)
    err = float(np.abs(out - true).max())
    err_alone = float(np.abs(alone - true).max())
    check("window-parallel BA", halo < 5e-4,
          f"{n_windows} windows over {mesh.devices.size} devices: halo "
          f"{halo:.2e} < 5e-4; max cam "
          f"error vs truth {err:.2e} (independent single-device solves "
          f"{err_alone:.2e})")
    return halo


def run_four_cards(n_devices: int = 4, rig=None, **overrides) -> None:
    """The sharded phases over a 1-D mesh of ``n_devices`` (every pair of
    cards is one NVLink hop, so the mesh follows the algorithm alone).
    Workload shapes do not depend on ``n_devices``; ``rig`` and
    ``overrides`` (see stereo_workload) only shrink them for tests."""
    from uasl_motion_estimation_tpu import parallel
    from uasl_motion_estimation_tpu.models.smoother import SmootherConfig

    from uasl_motion_estimation_tpu.utils.synthetic import CameraRig

    mesh = parallel.make_mesh(n_devices)
    rig = rig or CameraRig()
    defaults = SmootherConfig._field_defaults
    # 3 motions per card; exactly 4 unified windows (starts 0, 4, 8, 12),
    # so the window axis splits evenly and its outputs stay sharded
    n_unified = 3 * defaults["ba_rate"] + defaults["window"]
    phases = [
        ("sharded VO", lambda: phase_sharded_vo(
            stereo_workload(rig, 4 * 3 + 1, **overrides), mesh)),
        ("sharded unified", lambda: phase_sharded_unified(
            stereo_workload(rig, n_unified, seed=1, **overrides), mesh)),
        ("window-parallel BA", lambda: phase_window_ba(rig, mesh)),
    ]
    for name, run in phases:
        t0 = time.perf_counter()
        run()
        print(f"  {name}: {time.perf_counter() - t0:.1f} s wall "
              "(compilation included)", flush=True)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the four-GPU sharded paths")
    args = parser.parse_args(argv)
    count = 4 if args.four else 1

    devices = require_gpus(count)
    from uasl_motion_estimation_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    print(f"compile cache: {enable_compile_cache()}", flush=True)
    print(card(), flush=True)
    kind = devices[0].device_kind
    print(f"device_kind: {kind}; JAX devices: {len(devices)}", flush=True)
    print_precision()

    if args.four:
        run_four_cards()
    else:
        with tempfile.TemporaryDirectory() as workdir:
            run_one_card(Path(workdir))
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": kind,
        "count": len(devices)}}))


if __name__ == "__main__":
    main()
