"""Secondary benchmark configs (BASELINE.json configs 2-4).

Each prints one JSON line. Shapes are representative but sized so a single
run stays manageable:

  2. KLT pyramid tracking + pose-only estimation, EuRoC-like 752x480 frames
  3. mutual-information cross-modal stereo matching
  4. sliding-window BA throughput (10-frame windows, batched across windows)

Run: python benchmarks/extra_configs.py [2|3|4|all]
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def _setup_jax():
    import jax

    from uasl_motion_estimation_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    return jax


def bench_klt_pose():
    """Config 2: KLT front-end + pose-only solve on EuRoC-like frames."""
    jax = _setup_jax()
    import jax.numpy as jnp
    import numpy as np

    from uasl_motion_estimation_tpu.models.frontend import MatcherConfig
    from uasl_motion_estimation_tpu.models.pipeline import (
        OdometryPipeline,
        default_config,
    )
    from uasl_motion_estimation_tpu.ops.geometry import Intrinsics
    from uasl_motion_estimation_tpu.utils.metrics import ate_rmse
    from uasl_motion_estimation_tpu.utils.synthetic import (
        CameraRig,
        SyntheticStereoSequence,
    )

    # EuRoC MAV rig scale: 752x480, ~460 px focal, 11 cm baseline
    rig = CameraRig(fu=458.65, fv=457.3, cu=367.2, cv=248.4, baseline=0.11,
                    height=480, width=752)
    n = int(os.environ.get("BENCH_FRAMES", "17"))
    seq = SyntheticStereoSequence(n_frames=n, rig=rig, seed=1)
    frames = [seq.frame(i) for i in range(n)]
    cfg = default_config(
        Intrinsics(rig.fu, rig.fv, rig.cu, rig.cv), rig.baseline
    )._replace(matcher=MatcherConfig(max_disparity=64))
    pipe = OdometryPipeline(cfg, seed=0)
    ls, rs = pipe.stage_frames(frames)  # device-resident uint8
    pipe.run_staged(ls, rs, chunk=8)  # warm/compile
    times = []
    traj = None
    for _ in range(3):
        pipe.reset()
        t0 = time.perf_counter()
        traj = pipe.run_staged(ls, rs, chunk=8)
        times.append(time.perf_counter() - t0)
    import numpy as _np

    fps = (n - 1) / float(_np.median(times))

    # integrated engine (unified track table, VO + windowed BA) on the
    # same frames: validates the flagship on a second camera rig
    from uasl_motion_estimation_tpu.models.smoother import (
        SmootherConfig,
        compose_unified,
        unified_system_scan,
    )

    scfg = SmootherConfig(pipe=cfg)
    key = jax.random.key(0)
    jax.device_get(unified_system_scan(ls, rs, key, scfg, wchunk=4))  # warm
    int_times = []
    uout = None
    for _ in range(3):
        t0 = time.perf_counter()
        uout = jax.device_get(unified_system_scan(ls, rs, key, scfg,
                                                  wchunk=4))
        int_times.append(time.perf_counter() - t0)
    ures = compose_unified(uout, n, scfg)
    gt = seq.gt_positions()
    result = {
        "metric": "KLT+pose-only frames/s (EuRoC-like 752x480)",
        "value": round(fps, 2), "unit": "frames/s",
        "ate_m": round(float(ate_rmse(traj[:, :3, 3], gt)), 4),
        "integrated_vo_ba": {
            "fps": round((n - 1) / float(_np.median(int_times)), 2),
            "ate_vo_m": round(float(ate_rmse(ures.traj_vo[:, :3, 3], gt)), 4),
            "ate_ba_m": round(float(ate_rmse(ures.traj_ba[:, :3, 3], gt)), 4),
            "ba_converged": int(_np.sum(ures.ba_converged)),
        },
    }
    print(json.dumps(result))
    return result


def bench_mi_matcher():
    """Config 3: MI cross-modal stereo matching throughput."""
    jax = _setup_jax()
    import jax.numpy as jnp
    import numpy as np

    from uasl_motion_estimation_tpu.models import frontend as fe
    from uasl_motion_estimation_tpu.ops import image as im
    from uasl_motion_estimation_tpu.utils.synthetic import (
        CameraRig,
        SyntheticStereoSequence,
    )

    rig = CameraRig(fu=320.0, fv=320.0, cu=160.0, cv=96.0, baseline=0.54,
                    height=192, width=320)
    seq = SyntheticStereoSequence(n_frames=1, rig=rig, seed=2)
    left, right = seq.frame(0)
    left = jnp.asarray(left, jnp.float32)
    # cross-modal: intensity-inverted right image
    right = jnp.asarray(255.0 - right, jnp.float32)
    feats, _, v0 = im.detect_features(left, max_features=256)
    cfg = fe.MatcherConfig(max_disparity=64)

    from uasl_motion_estimation_tpu.utils.profiling import timeit_forced

    dt, (fr, sc, v) = timeit_forced(
        lambda: fe.match_stereo(left, right, feats, v0, cfg, use_mi=True),
        reps=5, warmup=2,
    )
    n_scored = 256 * 64

    # accuracy vs exact ground-truth disparity (VERDICT r2 item 6): px-error
    # stats of accepted matches + precision/recall at 1 px. MI subpixel comes
    # from the score parabola around the peak (the LK polish is intensity-
    # only and stays off cross-modally); reference MI core:
    # src/core/mutual_information.cpp:55-86.
    gt_disp = seq.gt_disparity(0)
    f_np = np.asarray(feats)
    v_np = np.asarray(v)
    meas = np.asarray(feats[:, 0] - fr[:, 0])  # measured disparity
    ix = np.clip(np.round(f_np[:, 0]).astype(int), 0, gt_disp.shape[1] - 1)
    iy = np.clip(np.round(f_np[:, 1]).astype(int), 0, gt_disp.shape[0] - 1)
    gt = gt_disp[iy, ix]
    v0_np = np.asarray(v0)
    matchable = v0_np & (gt > cfg.min_disparity) & (gt < cfg.max_disparity - 1)
    err = np.abs(meas - gt)
    accepted = v_np & matchable
    correct = accepted & (err < 1.0)
    precision = float(correct.sum() / max(accepted.sum(), 1))
    recall = float(correct.sum() / max(matchable.sum(), 1))
    result = {
        "metric": "MI cross-modal matcher pairs/s (256 feats x 64 disp)",
        "value": round(n_scored / dt, 0), "unit": "patch-pairs/s",
        "note": "per-call value includes dispatch",
        "valid_matches": int(v.sum()),
        "accuracy": {
            "n_matchable": int(matchable.sum()),
            "median_abs_px_err": round(float(np.median(err[accepted])), 3),
            "p90_abs_px_err": round(float(np.percentile(err[accepted], 90)), 3),
            "precision_at_1px": round(precision, 3),
            "recall_at_1px": round(recall, 3),
        },
    }
    print(json.dumps(result))
    return result


def bench_mi_scale():
    """Config 3b: cross-modal MI metric-scale session — the reference's only
    link-instantiated Optimiser (Optimiser<ScaleState, ...>,
    src/optimisation/optimisation.cpp:150-228, 436-537, 749) driven
    end-to-end: left-camera mono VO for up-to-scale motion + structure, MI
    matcher seeding the scale, MI-LM refinement against the stereo baseline
    (VERDICT r4 item 1)."""
    jax = _setup_jax()
    import jax.numpy as jnp
    import numpy as np

    from uasl_motion_estimation_tpu.models import frontend as fe
    from uasl_motion_estimation_tpu.models.cross_modal import (
        CrossModalConfig,
        cross_modal_step,
        run_cross_modal,
    )
    from uasl_motion_estimation_tpu.models.mono_vo import MonoVOParams
    from uasl_motion_estimation_tpu.models.scale import (
        ScaleConfig,
        estimate_scale,
    )
    from uasl_motion_estimation_tpu.ops.geometry import Intrinsics
    from uasl_motion_estimation_tpu.utils.metrics import ate_rmse
    from uasl_motion_estimation_tpu.utils.profiling import timeit_forced
    from uasl_motion_estimation_tpu.utils.synthetic import (
        CameraRig,
        SyntheticStereoSequence,
    )

    rig = CameraRig(fu=320.0, fv=320.0, cu=160.0, cv=96.0, baseline=0.54,
                    height=192, width=320)
    n = int(os.environ.get("BENCH_FRAMES", "12"))
    seq = SyntheticStereoSequence(n_frames=n, rig=rig, seed=3,
                                  cross_modal=True)
    frames = [seq.frame(i) for i in range(n)]
    intr = Intrinsics(rig.fu, rig.fv, rig.cu, rig.cv)
    cfg = CrossModalConfig(
        vo=MonoVOParams(intr=intr),
        scale=ScaleConfig(intr=intr, baseline=rig.baseline),
        matcher=fe.MatcherConfig(max_disparity=64),
        max_features=256,
    )

    from uasl_motion_estimation_tpu.models.cross_modal import (
        run_cross_modal_staged,
    )

    t0 = time.perf_counter()
    res = run_cross_modal(frames, cfg, seed=0)
    t_total = time.perf_counter() - t0

    # staged single-dispatch engine (round 5): whole session in one jit
    run_cross_modal_staged(frames, cfg, seed=0, chunk=4)  # warm
    st_times = []
    for _ in range(3):
        t0 = time.perf_counter()
        res_staged = run_cross_modal_staged(frames, cfg, seed=0, chunk=4)
        st_times.append(time.perf_counter() - t0)
    fps_staged = (n - 1) / float(np.median(st_times))

    gt_speed = np.linalg.norm(np.diff(seq.poses[:, :3, 3], axis=0), axis=1)
    err = np.abs(res.scales - gt_speed) / gt_speed
    err0 = np.abs(res.s0 - gt_speed) / gt_speed
    ate = float(ate_rmse(res.trajectory[:, :3, 3], seq.gt_positions()))
    stops: dict = {}
    for r in res.records:
        stops[r["lm_stop"]] = stops.get(r["lm_stop"], 0) + 1

    # steady-state per-frame latency (the session is a per-frame host loop)
    import jax as _jax
    key = _jax.random.key(7)
    pl_, cl_, cr_ = (jnp.asarray(frames[-2][0], jnp.float32),
                     jnp.asarray(frames[-1][0], jnp.float32),
                     jnp.asarray(frames[-1][1], jnp.float32))
    dt, _ = timeit_forced(
        lambda: cross_modal_step(pl_, cl_, cr_, key, cfg, s_prev=0.8),
        reps=5, warmup=2,
    )

    # MI recovery from deliberately wrong inits (matcher init disabled):
    # coarse log-space pre-search + LM on exact corner structure, asserted
    # not eyeballed (the reference only ever logged these curves,
    # optimisation.cpp:35-46). Structure = detected corners with EXACT
    # depths from the renderer's disparity map — the representative feature
    # population (a ground-plane-only set gives a foreshortening-biased,
    # bumpy objective; measured round 5).
    from uasl_motion_estimation_tpu.ops import image as im

    left0, right0 = map(jnp.asarray, frames[0])
    feats, _, v0 = im.detect_features_grid(left0, max_features=256,
                                           quality_level=1e-4)
    gtd = seq.gt_disparity(0)
    f_np = np.asarray(feats)
    ix = np.clip(np.round(f_np[:, 0]).astype(int), 0, rig.width - 1)
    iy = np.clip(np.round(f_np[:, 1]).astype(int), 0, rig.height - 1)
    d_gt = gtd[iy, ix]
    z = np.where(d_gt > 1e-3, rig.fu * rig.baseline
                 / np.maximum(d_gt, 1e-3), 0.0)
    ok = np.asarray(v0) & (z > 2) & (z < 40)
    X = np.stack([(f_np[:, 0] - rig.cu) * z / rig.fu,
                  (f_np[:, 1] - rig.cv) * z / rig.fv, z], -1)
    s_gt = 1.4
    pts_rec = jnp.asarray((X / s_gt).astype(np.float32))
    valid_rec = jnp.asarray(ok)
    scale_cfg_rec = cfg.scale._replace(coarse_candidates=13)
    recovery = {}
    for s_init in (0.5, 2.8):
        s_rec, lmres = estimate_scale(
            left0, right0, pts_rec, valid_rec,
            jnp.asarray(s_init), scale_cfg_rec)
        recovery[str(s_init)] = {
            "recovered": round(float(s_rec), 4),
            "err_pct": round(abs(float(s_rec) - s_gt) / s_gt * 100, 2),
            "n_iter": int(lmres.n_iter),
        }

    err_staged = (np.abs(res_staged.scales - gt_speed) / gt_speed)
    med_err = float(np.median(err)) * 100
    result = {
        "metric": "cross-modal MI metric-scale session (192x320, 256 feats)",
        "value": round(fps_staged, 2), "unit": "frames/s",
        "fps_staged": round(fps_staged, 2),
        "fps_per_frame_loop": round(1.0 / dt, 2),
        "staged_median_err_pct": round(float(np.median(err_staged)) * 100,
                                       2),
        "n_frames": n,
        "wall_s_total": round(t_total, 2),
        "scale_accuracy": {
            "median_err_pct": round(med_err, 2),
            "max_err_pct": round(float(err.max()) * 100, 2),
            "s0_median_err_pct": round(float(np.median(err0)) * 100, 2),
            "gt_speed_m_per_frame": round(float(gt_speed.mean()), 3),
        },
        "metric_ate_m": round(ate, 4),
        "lm_stops": stops,
        "bad_init_recovery": recovery,
        "pass_scale": bool(med_err < 2.0),
        "pass_recovery": bool(all(v["err_pct"] < 5.0
                                  for v in recovery.values())),
    }
    print(json.dumps(result))
    return result


def bench_ba_windows():
    """Config 4: windowed-BA throughput, batched across windows."""
    jax = _setup_jax()
    import jax.numpy as jnp
    import numpy as np

    sys.path.insert(0, str(REPO / "tests"))
    from test_ba import INTR, BASELINE, make_window, perturb

    from uasl_motion_estimation_tpu.solvers.ba import (
        BAConfig, BAProblem, ba_solve,
    )

    n_windows = int(os.environ.get("BENCH_BA_WINDOWS", "16"))
    problems = []
    for s in range(n_windows):
        cams, pts, obs, mask = make_window(n_frames=10, n_pts=256, noise=0.3,
                                           seed=s)
        cams_p, pts_p = perturb(cams, pts, seed=s + 100)
        problems.append(BAProblem(jnp.asarray(cams_p), jnp.asarray(pts_p),
                                  jnp.asarray(obs), jnp.asarray(mask)))
    batch = jax.tree.map(lambda *x: jnp.stack(x), *problems)
    cfg = BAConfig(intr=INTR, baseline=BASELINE)

    from uasl_motion_estimation_tpu.utils.profiling import timeit_forced

    solve = jax.jit(jax.vmap(lambda p: ba_solve(p, cfg)))
    dt, res = timeit_forced(lambda: solve(batch), reps=3, warmup=1)
    result = {
        "metric": "windowed BA solves/s (10 frames x 256 pts, batched)",
        "value": round(n_windows / dt, 2), "unit": "windows/s",
        "mean_cost": round(float(np.mean(res.cost)), 4),
    }
    print(json.dumps(result))
    return result


def bench_mono():
    """Mono VO pipeline on-device: the 5-point default vs the pencil8
    alternative (VERDICT r3 item 6 — the reference's default IS the 5-point,
    src/vo/MonoVisualOdometry.cpp:20; this entry is its device
    throughput/compile validation in a pipeline context)."""
    jax = _setup_jax()
    import numpy as np

    from uasl_motion_estimation_tpu.models.mono_pipeline import (
        MonoOdometryPipeline,
        MonoPipelineConfig,
    )
    from uasl_motion_estimation_tpu.models.mono_vo import MonoVOParams
    from uasl_motion_estimation_tpu.ops.geometry import Intrinsics
    from uasl_motion_estimation_tpu.utils.metrics import ate_rmse
    from uasl_motion_estimation_tpu.utils.synthetic import (
        CameraRig,
        SyntheticStereoSequence,
    )

    rig = CameraRig(fu=458.65, fv=457.3, cu=367.2, cv=248.4, baseline=0.11,
                    height=480, width=752)
    n = int(os.environ.get("BENCH_MONO_FRAMES", "13"))
    seq = SyntheticStereoSequence(n_frames=n, rig=rig, seed=3)
    frames = [seq.frame(i)[0] for i in range(n)]  # left camera only
    gt = seq.gt_positions()

    # reference CPU mono baseline (measure_reference_mono.py; same world,
    # same initial speed)
    ref_path = REPO / "benchmarks" / "reference_cpu_mono.json"
    ref = json.loads(ref_path.read_text()) if ref_path.exists() else None

    from uasl_motion_estimation_tpu.models.mono_pipeline import (
        run_mono_staged,
    )

    out = {}
    for solver in ("pencil8", "5point", "hybrid"):
        cfg = MonoPipelineConfig(
            vo=MonoVOParams(
                intr=Intrinsics(rig.fu, rig.fv, rig.cu, rig.cv),
                inlier_threshold=2.0,
                solver=solver,
            ),
            max_features=256,
        )
        # staged engine (single dispatch, VERDICT r4 item 4b)
        t0 = time.perf_counter()
        run_mono_staged(frames, cfg, seed=0, initial_speed=0.8)
        t_compile = time.perf_counter() - t0
        times, traj = [], None
        for _ in range(3):
            t0 = time.perf_counter()
            traj = run_mono_staged(frames, cfg, seed=0, initial_speed=0.8)
            times.append(time.perf_counter() - t0)
        fps = (n - 1) / float(np.median(times))
        row = {
            "fps_staged": round(fps, 2),
            "ate_m": round(
                float(ate_rmse(traj[:, :3, 3], gt[:, :3])), 4),
            "compile_plus_first_run_s": round(t_compile, 1),
        }
        if ref:
            row["vs_baseline"] = round(fps / ref["fps"], 2)
        # latency mode (per-frame host loop) for the default solver only
        if solver == "pencil8":
            pipe = MonoOdometryPipeline(cfg, seed=0, initial_speed=0.8)
            pipe.run(frames)  # warm
            pipe.reset()
            t0 = time.perf_counter()
            traj_l = pipe.run(frames)
            row["fps_per_frame_loop"] = round(
                (n - 1) / (time.perf_counter() - t0), 2)
        out[solver] = row
    result = {
        "metric": "mono VO staged-engine frames/s (752x480, 256 feats)",
        "value": out["hybrid"]["fps_staged"], "unit": "frames/s",
        "vs_baseline": out["hybrid"].get("vs_baseline"),
        "reference_cpu_mono": ref,
        "per_solver": out,
        "note": "staged single-dispatch scan (run_mono_staged); hybrid = "
                "pencil8 with lax.cond 5-point escalation on inlier "
                "collapse; reference baseline is the unmodified library "
                "mono path (findEssentialMat+recoverPose) with its OpenCV "
                "consumer front-end on the same frames",
    }
    print(json.dumps(result))
    return result


def bench_latency_mode():
    """Latency-mode engine row (VERDICT r4 weak #2): the per-frame host-loop
    OdometrySystem (persistent tracks + VO + windowed BA at the reference's
    cadence) finally measured — fps and ATE with BA on/off on the 192x320
    synthetic world, with the round-5 unified detection defaults (grid,
    quality 1e-4)."""
    jax = _setup_jax()
    import numpy as np

    from uasl_motion_estimation_tpu.models.frontend import MatcherConfig
    from uasl_motion_estimation_tpu.models.odometry import (
        OdometryConfig,
        OdometrySystem,
    )
    from uasl_motion_estimation_tpu.models.stereo_vo import StereoVOParams
    from uasl_motion_estimation_tpu.ops.geometry import Intrinsics
    from uasl_motion_estimation_tpu.utils.metrics import ate_rmse
    from uasl_motion_estimation_tpu.utils.synthetic import (
        CameraRig,
        SyntheticStereoSequence,
    )

    rig = CameraRig(fu=320.0, fv=320.0, cu=160.0, cv=96.0, baseline=0.54,
                    height=192, width=320)
    n = int(os.environ.get("BENCH_FRAMES", "17"))
    seq = SyntheticStereoSequence(n_frames=n, rig=rig, seed=4)
    frames = [seq.frame(i) for i in range(n)]
    gt = seq.gt_positions()
    intr = Intrinsics(rig.fu, rig.fv, rig.cu, rig.cv)
    cfg = OdometryConfig(
        vo=StereoVOParams(intr1=intr, intr2=intr, baseline=rig.baseline),
        max_tracks=256, matcher=MatcherConfig(max_disparity=96),
    )

    rows = {}
    for use_ba in (False, True):
        sysm = OdometrySystem(cfg, seed=1, use_ba=use_ba)
        sysm.run(frames)  # warm/compile
        sysm.reset()
        t0 = time.perf_counter()
        traj = sysm.run(frames)
        dt = time.perf_counter() - t0
        rows["with_ba" if use_ba else "vo_only"] = {
            "fps": round((n - 1) / dt, 2),
            "ate_m": round(float(ate_rmse(traj[:, :3, 3], gt)), 4),
        }
    result = {
        "metric": "latency-mode OdometrySystem frames/s (192x320, per-frame"
                  " host loop, persistent tracks)",
        "value": rows["with_ba"]["fps"], "unit": "frames/s",
        "per_mode": rows,
        "note": "per-frame host loop; the staged/streaming engines are "
                "the throughput path — this row exists so the latency "
                "mode is MEASURED",
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    collected = {}
    if which in ("2", "all"):
        collected["config2_klt_pose"] = bench_klt_pose()
    if which in ("3", "all"):
        collected["config3_mi_matcher"] = bench_mi_matcher()
    if which in ("3b", "all"):
        collected["config3b_mi_scale"] = bench_mi_scale()
    if which in ("4", "all"):
        collected["config4_ba_windows"] = bench_ba_windows()
    if which in ("m", "mono", "all"):
        collected["config_mono_vo"] = bench_mono()
    if which in ("lat", "latency", "all"):
        collected["config_latency_mode"] = bench_latency_mode()
    out = REPO / "benchmarks" / "results_extra_configs.json"
    # merge into the existing artifact so single-config re-measurements
    # update their row without stale-ing the others
    merged = json.loads(out.read_text()) if out.exists() else {}
    merged.update(collected)
    out.write_text(json.dumps(merged, indent=2))
    print(f"wrote {out}")
