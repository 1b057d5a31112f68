"""Mono RANSAC breakdown curve: pencil-8pt vs exact 5-point (VERDICT r2 #4).

Pose error vs outlier rate at fixed hypothesis budgets, quantifying the
minimal-sample-size effect (sample success = inlier^5 vs inlier^8; the
reference gets this from cv::findEssentialMat's Nister 5-point,
reference: src/vo/MonoVisualOdometry.cpp:20).

Writes benchmarks/mono_breakdown.json.
"""

import json
import os
import pathlib
import sys
import time

# Robustness statistic, not a throughput number: run on the CPU.
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from uasl_motion_estimation_tpu.models.mono_vo import (  # noqa: E402
    MonoVOParams,
    mono_vo_solve,
)
from uasl_motion_estimation_tpu.ops import geometry as geo, lie  # noqa: E402

INTR = geo.Intrinsics(fu=500.0, fv=500.0, cu=320.0, cv=240.0)
N = 200
SEEDS = range(12)
RATES = [0.2, 0.3, 0.4, 0.5, 0.6, 0.65, 0.7, 0.75, 0.8]
BUDGETS = [40, 200]


def make(seed, rate, noise=0.3):
    rng = np.random.default_rng(seed)
    pts = np.stack(
        [rng.uniform(-6, 6, N), rng.uniform(-4, 4, N), rng.uniform(6, 30, N)], -1
    )
    R = np.asarray(lie.so3_exp(jnp.asarray([0.01, 0.03, 0.005], jnp.float32)))
    t = np.array([0.2, -0.1, 1.0])
    pc2 = pts @ R.T + t

    def proj(p):
        return np.stack(
            [500 * p[:, 0] / p[:, 2] + 320, 500 * p[:, 1] / p[:, 2] + 240], -1
        )

    uv1, uv2 = proj(pts), proj(pc2)
    uv1 += rng.normal(scale=noise, size=uv1.shape)
    uv2 += rng.normal(scale=noise, size=uv2.shape)
    nbad = int(rate * N)
    bad = rng.choice(N, nbad, replace=False)
    uv2[bad] = np.stack([rng.uniform(0, 640, nbad), rng.uniform(0, 480, nbad)], -1)
    return np.stack([uv1, uv2], 1).astype(np.float32), R


def rot_err_deg(Ra, Rb):
    c = (np.trace(Ra.T @ Rb) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def main():
    out = {"n_matches": N, "seeds": len(list(SEEDS)), "curves": []}
    for H in BUDGETS:
        for solver in ("pencil8", "5point"):
            params = MonoVOParams(
                intr=INTR, inlier_threshold=2.0, solver=solver, n_ransac=H
            )
            curve = []
            t0 = time.perf_counter()
            for rate in RATES:
                errs = []
                for seed in SEEDS:
                    m, R = make(seed, rate)
                    res = mono_vo_solve(
                        jnp.asarray(m), jnp.ones(N, bool),
                        jax.random.key(seed), params,
                    )
                    errs.append(rot_err_deg(np.asarray(res.R), R))
                errs = np.asarray(errs)
                curve.append(
                    {
                        "outlier_rate": rate,
                        "median_rot_err_deg": float(np.median(errs)),
                        "success_lt_1deg": float(np.mean(errs < 1.0)),
                    }
                )
            out["curves"].append(
                {
                    "solver": solver,
                    "n_hypotheses": H,
                    "curve": curve,
                    "wall_s": round(time.perf_counter() - t0, 2),
                }
            )
            # sustained rate = largest rate with >= 75% success
            sustained = max(
                (c["outlier_rate"] for c in curve if c["success_lt_1deg"] >= 0.75),
                default=0.0,
            )
            print(f"{solver} H={H}: sustained outlier rate {sustained}")
            out["curves"][-1]["sustained_outlier_rate"] = sustained
    path = pathlib.Path(__file__).parent / "mono_breakdown.json"
    path.write_text(json.dumps(out, indent=1))
    print(json.dumps({k: v for k, v in out.items() if k != "curves"}))


if __name__ == "__main__":
    main()
