"""MI-based metric-scale estimation from a stereo baseline (ScaleState).

Batched JAX re-design of the reference's ``Optimiser<ScaleState, ...>``
specialization — the library's cross-modal capability (multispectral stereo
where intensity matching fails):

* residuals: per-feature mutual information between the left patch and the
  right patch reprojected with the candidate scale
  (reference: src/optimisation/optimisation.cpp:150-228);
* jacobian: 1-pixel finite difference of MI along the epipolar line, chained
  with duds = fu*B/(s*Z) (optimisation.cpp:436-537, including the optional
  Sobel-gradient weighting);
* solver: the shared GN/LM engine run as a MAXIMIZATION
  (minim flag sign flip, optimisation.cpp:668, 704-706) — here
  ``LMConfig(minimize=False)`` on solvers/lm.py.

The reference's per-feature ROI loops become batched patch gathers + the
one-hot-matmul MI of ops/similarity.py: all N features are scored in one
fused program per optimiser iteration.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import geometry as geo
from ..ops import image as im
from ..ops import similarity as sim
from ..solvers.lm import LMConfig, LMResult, lm_solve


class ScaleConfig(NamedTuple):
    intr: geo.Intrinsics
    baseline: float
    window_radius: int = 5  # ScaleState.window_size ROI half-size
    mi_bins: int = 20
    weighting: bool = False  # Sobel-gradient weights (optimisation.cpp:483)
    fd_step: float = 1.0  # dp = 1 px (optimisation.cpp:440)
    max_iter: int = 20  # OptimisationParams default (optimisation.h:31)
    use_lm: bool = True
    # Coarse-to-fine init: evaluate the mean-MI objective at this many
    # log-spaced scale candidates spanning [s0/coarse_range, s0*coarse_range]
    # (ONE batched MI pass — all candidates x features scored together) and
    # start the LM from the argmax. The 1-px finite-difference jacobian
    # carries patch-MI sampling noise, so plain LM from a far init stalls on
    # plateau bumps ~7% from the optimum (measured round 5); the pre-search
    # lands inside the basin where the FD signal dominates. 0 = off
    # (reference semantics: the consumer supplies a sane init,
    # optimisation.cpp:436-537 has no global stage).
    coarse_candidates: int = 0
    coarse_range: float = 3.0
    e1: float = 1e-4
    e2: float = 1e-6
    e3: float = 1e-6
    e4: float = 1e-6


def _patch_mi_and_weight(
    left: jax.Array,
    right: jax.Array,
    uv_l: jax.Array,
    uv_r: jax.Array,
    valid: jax.Array,
    cfg: ScaleConfig,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """(N,) MI, (N,) Sobel weights, (N,) in-bounds validity."""
    r = cfg.window_radius
    h, w = left.shape
    ok = (
        valid
        & im.patch_in_bounds(uv_l, r + 1, h, w)
        & im.patch_in_bounds(uv_r, r + 1, h, w)
    )
    pl = im.extract_patches(left, uv_l, r)
    pr = im.extract_patches(right, uv_r, r)
    mi = sim.mutual_information(pl, pr, bins=cfg.mi_bins)
    if cfg.weighting:
        gx, _ = im.sobel(left)
        gp = im.extract_patches(jnp.abs(gx), uv_l, r)
        weight = jnp.mean(gp, axis=(-2, -1)) + 1e-20
    else:
        weight = jnp.ones_like(mi)
    return mi, weight, ok


@partial(jax.jit, static_argnames=("cfg",))
def estimate_scale(
    left: jax.Array,
    right: jax.Array,
    pts3: jax.Array,
    valid: jax.Array,
    s0: jax.Array,
    cfg: ScaleConfig,
) -> tuple[jax.Array, LMResult]:
    """Estimate the metric scale maximizing per-feature patch MI.

    Args:
      left, right: rectified stereo images of the last frame.
      pts3: (N, 3) up-to-scale 3D points in the LAST frame's left-camera
        coordinates (the reference pre-transforms window points with the
        frame pose, ``Tr_ * pt``, optimisation.cpp:172-180).
      valid: (N,) which points participate.
      s0: initial scale.
      cfg: static configuration.

    Returns (scale, LMResult of the shared GN/LM engine).
    """
    p = cfg

    if p.coarse_candidates > 0:
        logr = jnp.log(jnp.asarray(p.coarse_range, left.dtype))
        cands = s0 * jnp.exp(
            jnp.linspace(-logr, logr, p.coarse_candidates)
        )  # (K,)

        def mean_mi(s):
            pc = s * pts3
            uv_l = geo.project(pc, p.intr)
            uv_r = geo.project(pc, p.intr, baseline_shift=p.baseline)
            mi, w, ok = _patch_mi_and_weight(left, right, uv_l, uv_r,
                                             valid, p)
            return jnp.sum(mi * w * ok) / jnp.maximum(jnp.sum(w * ok), 1e-9)

        scores = jax.vmap(mean_mi)(cands)
        s0 = cands[jnp.argmax(scores)]

    def normal_eq(x):
        s = x[0]
        pc = s * pts3  # metric points at candidate scale
        uv_l = geo.project(pc, p.intr)
        uv_r = geo.project(pc, p.intr, baseline_shift=p.baseline)
        mi, weight, ok = _patch_mi_and_weight(left, right, uv_l, uv_r, valid, p)
        res = mi * weight * ok

        # finite-difference MI wrt a 1-px epipolar shift of the right patch
        uv_r_plus = uv_r.at[:, 0].add(p.fd_step)
        mi_plus, _, ok_p = _patch_mi_and_weight(
            left, right, uv_l, uv_r_plus, valid, p
        )
        z = jnp.maximum(s * pts3[:, 2], 1e-6)
        duds = p.intr.fu * p.baseline / z  # optimisation.cpp:473
        J = (mi_plus - mi) / p.fd_step * duds * (ok & ok_p)

        JJ = jnp.sum(J * J * weight)[None, None]
        e = jnp.sum(J * res)[None]
        cost = jnp.sum(res) / jnp.maximum(jnp.sum(ok), 1.0)
        return JJ, e, cost

    lm_cfg = LMConfig(
        max_iter=p.max_iter,
        use_lm=p.use_lm,
        minimize=False,
        abs_tol=p.e1,
        grad_tol=p.e2,
        incr_tol=p.e3,
        rel_tol=p.e4,
    )
    result = lm_solve(normal_eq, jnp.asarray([s0], left.dtype), lm_cfg)
    return result.x[0], result
