"""Device-time breakdowns on the GPU from jax.profiler traces.

  gather   ops/image.extract_tiles (XLA gather) at the headline shapes: one
           22x22 KLT tile per feature at each of the 4 pyramid levels of a
           376x1241 frame, and the 11x138 ZNCC strips; 500 features. Each
           is timed (median of --reps, ended by block_until_ready) beside
           its bandwidth bound, and traced once.
  vo       one traced staged stereo-VO run (40 KITTI-size frames, 500
           features, chip_smoke's workload).
  session  one traced cross-modal MI scale session (13 KITTI-size frames,
           500 features x 128 disparities MI-matched per frame).

Each trace is reduced to device time per kernel name (events on the GPU
planes' stream lines), the sum of those, and the host wall time of the
traced call; their ratio bounds the device's busy share.

Run on a machine with a GPU:

    python benchmarks/device_trace.py [gather vo session] [--out DIR]
"""

from __future__ import annotations

import argparse
import glob
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def device_time_by_name(trace_dir: str) -> dict[str, float]:
    """Seconds of device time per kernel name in the newest trace under
    ``trace_dir``: events on the GPU planes' stream lines (the lines that
    summarize XLA modules and ops would count each kernel twice)."""
    import jax

    path = sorted(glob.glob(f"{trace_dir}/**/*.xplane.pb", recursive=True))[-1]
    totals: dict[str, float] = defaultdict(float)
    for plane in jax.profiler.ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if line.name.startswith("Stream"):
                for ev in line.events:
                    totals[ev.name] += ev.duration_ns * 1e-9
    return dict(sorted(totals.items(), key=lambda kv: -kv[1]))


def traced(out_dir: str, name: str, fn, top: int = 15) -> dict:
    """Trace one call of ``fn`` (already warm) and reduce the trace."""
    import jax

    d = str(Path(out_dir) / name)
    with jax.profiler.trace(d):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        wall = time.perf_counter() - t0
    ops = device_time_by_name(d)
    busy = sum(ops.values())
    return {
        "wall_s": wall,
        "device_op_s": busy,
        "device_op_share_of_wall": busy / wall,
        "gather_fusions_s": sum(v for k, v in ops.items() if "gather" in k),
        "top_ops_ms": {k[:120]: v * 1e3 for k, v in list(ops.items())[:top]},
    }


def timed(fn, reps: int) -> list[float]:
    """Median, min and max seconds of ``fn()`` after one warm-up call."""
    import jax

    jax.block_until_ready(fn())
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return [float(np.median(times)), min(times), max(times)]


def bench_gather(reps: int, out_dir: str) -> dict:
    import jax
    import jax.numpy as jnp

    from uasl_motion_estimation_tpu.ops import image as im

    rng = np.random.default_rng(0)
    img = jnp.asarray(rng.uniform(0, 255, (376, 1241)), jnp.float32)
    n = 500
    cases = [(f"klt_level{i}_22x22", lvl, 22, 22)
             for i, lvl in enumerate(im.build_pyramid(img, 4))]
    cases.append(("zncc_strip_11x138", img, 11, 138))
    rows = {}
    for name, lvl, th, tw in cases:
        h, w = lvl.shape
        anchors = jnp.asarray(np.stack([rng.integers(-5, w, n),
                                        rng.integers(-5, h, n)], -1),
                              jnp.int32)
        fn = jax.jit(lambda x, a, th=th, tw=tw: im.extract_tiles(x, a, th, tw))
        call = lambda fn=fn, lvl=lvl, anchors=anchors: fn(lvl, anchors)
        rows[name] = {
            "host_s_median_min_max": timed(call, reps),
            # read the gathered pixels once, write the tiles once
            "bandwidth_bound_s": 2 * n * th * tw * 4 / HBM_BYTES_PER_S,
            "trace": traced(out_dir, f"gather_{name}", call, top=3),
        }
    return rows


def bench_vo(out_dir: str) -> dict:
    import chip_smoke
    from uasl_motion_estimation_tpu.utils.synthetic import CameraRig
    from uasl_motion_estimation_tpu.models.pipeline import OdometryPipeline

    w = chip_smoke.stereo_workload(CameraRig(), chip_smoke.N_FRAMES)
    pipe = OdometryPipeline(w.cfg, seed=0)
    ls, rs = pipe.stage_frames(w.frames)

    def run():
        pipe.reset()
        return pipe.run_staged(ls, rs, chunk=chip_smoke.CHUNK)

    run()
    return traced(out_dir, "staged_vo", run)


def bench_session(out_dir: str) -> dict:
    import chip_smoke
    from uasl_motion_estimation_tpu.utils.synthetic import CameraRig
    from uasl_motion_estimation_tpu.models import cross_modal as cm

    w = chip_smoke.stereo_workload(CameraRig(),
                                   chip_smoke.CROSS_MODAL_FRAMES, seed=3,
                                   cross_modal=True)
    intr = w.cfg.vo.intr1
    cfg = cm.CrossModalConfig(
        vo=cm.MonoVOParams(intr=intr),
        scale=cm.ScaleConfig(intr=intr, baseline=w.rig.baseline))
    run = lambda: cm.run_cross_modal_staged(w.frames, cfg, seed=0).trajectory
    run()
    return traced(out_dir, "cross_modal_session", run)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("which", nargs="*", default=["gather", "vo", "session"])
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--out", default="chiprun_out/traces")
    args = parser.parse_args()

    from chip_smoke import card, require_gpus
    from uasl_motion_estimation_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    devices = require_gpus(1)
    enable_compile_cache()
    result = {"card": card(), "device_kind": devices[0].device_kind}
    if "gather" in args.which:
        result["gather"] = bench_gather(args.reps, args.out)
    if "vo" in args.which:
        result["vo"] = bench_vo(args.out)
    if "session" in args.which:
        result["session"] = bench_session(args.out)
    print(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
