"""Feature front-end: GFTT detection, ZNCC/MI stereo matching, KLT tracking.

This subsystem is new scope: the reference library consumes externally-produced
matches (its data structures assume an OpenCV front-end; SURVEY.md TL;DR,
feature_types.h:91-194) and BASELINE.json makes GFTT + ZNCC/MI matching +
pyramidal KLT native requirements. Design is batch-first:

* stereo matching scores every (feature x disparity) pair at once — ZNCC as a
  single ``einsum`` over normalized patch vectors, MI as batched one-hot
  joint-histogram matmuls (ops/similarity.py);
* KLT runs all features through every pyramid level/iteration in lock-step
  with validity masking (no per-feature control flow).

All outputs are fixed-shape (max_features static) with validity masks.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import image as im
from ..ops import similarity as sim
from ..ops import stereo as st


class MatcherConfig(NamedTuple):
    patch_radius: int = 5
    max_disparity: int = 128
    min_disparity: float = 0.5
    min_score: float = 0.6  # ZNCC acceptance threshold
    mi_bins: int = 20
    mi_min_score: float = 0.4  # MI acceptance (bits)
    refine_iters: int = 2  # 1-D photometric subpixel refinement steps
    # Search width when a per-feature disparity prior is available (the
    # quad-matcher's cur-pair match reuses the prev-pair disparity of each
    # tracked feature): candidates span prior +/- prior_width/2. Sized for
    # automotive forward motion: a near point at the reference rig
    # (d ~ 60 px, 0.8 m/frame at 6.4 m) shifts ~8 px/frame, so +/-12 covers
    # it with margin; features whose disparity truly jumped further fail
    # the ZNCC threshold instead of mismatching (moving objects are VO
    # outliers anyway).
    prior_width: int = 24


class KLTConfig(NamedTuple):
    # 4 levels = OpenCV calcOpticalFlowPyrLK's default maxLevel=3; ATE is far
    # below the acceptance bar at 4 or 5. Sequences with very large
    # inter-frame flow (fast rotation, low fps) should raise this to 5.
    n_levels: int = 4
    window_radius: int = 5
    iters: int = 10
    # Coarse levels (> 0) only need to land inside the next-finer level's
    # convergence basin (~1-2 px at that level), not converge fully, and a
    # straggler track keeps the whole lock-step batch iterating, so coarse
    # levels get a smaller iteration cap.
    iters_coarse: int = 4
    min_eig_threshold: float = 1e-4
    max_residual: float = 12.0  # mean abs intensity error acceptance
    # Capture range is bounded by the per-level tile margin: total reach is
    # ~tile_margin * (2^n_levels - 1) px at full resolution (ADVICE r1); the
    # default config reaches ~75 px (5 levels: ~155 px).
    max_displacement: float = 75.0
    tile_margin: int = 5  # px of local search room per level (tile gather)
    converge_px: float = 0.03  # early exit when every live update is below


def _photometric_residual(patch: jax.Array, template: jax.Array) -> jax.Array:
    """Mean |patch - template| after removing the DC offset: the acceptance
    gate stays meaningful under per-frame exposure (gain/bias) changes, which
    would otherwise reject every track at ~8% gain drift (raw-SSD gating is
    the OpenCV/reference behavior; this is the rebuild's robustness upgrade,
    exercised by the corrupted-world tests)."""
    err = patch - template
    err = err - jnp.mean(err, axis=(-2, -1), keepdims=True)
    return jnp.mean(jnp.abs(err), axis=(-2, -1))


def _normalized_patch_vectors(patches: jax.Array, eps: float = 1e-6) -> jax.Array:
    """(..., k, k) -> zero-mean unit-norm (..., k*k) vectors; ZNCC becomes a
    plain dot product."""
    flat = patches.reshape(patches.shape[:-2] + (-1,))
    flat = flat - jnp.mean(flat, axis=-1, keepdims=True)
    norm = jnp.linalg.norm(flat, axis=-1, keepdims=True)
    return flat / jnp.maximum(norm, eps)


@partial(jax.jit, static_argnames=("cfg", "use_mi"))
def match_stereo(
    img_left: jax.Array,
    img_right: jax.Array,
    feats_left: jax.Array,
    valid_left: jax.Array,
    cfg: MatcherConfig = MatcherConfig(),
    use_mi: bool = False,
    d_prior: jax.Array | None = None,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Epipolar stereo matching on rectified pairs.

    For each left feature (x, y), scores right-image patches at
    (x - d, y) for d in [0, max_disparity) and keeps the best, with
    sub-pixel parabola refinement and a left-right score threshold.

    ``d_prior`` (N,) float disparities, if given, narrows the ZNCC search to
    ``prior_width`` candidates centered on each feature's prior (5x less
    cost-volume work at the defaults, and fewer aliasing mismatches).

    ``use_mi=True`` scores with mutual information instead of ZNCC — the
    cross-modal capability of the reference's MI core
    (mutual_information.cpp:55-86) applied to matching (BASELINE config 3).

    Returns (feats_right (N, 2), scores (N,), valid (N,)).
    """
    h, w = img_left.shape
    n = feats_left.shape[0]
    r = cfg.patch_radius

    if use_mi:
        # MI has no moment decomposition, so the cross-modal path stays
        # patch-gather based: (N x D) pairs scored as batched one-hot
        # joint-histogram matmuls
        d_range = jnp.arange(cfg.max_disparity, dtype=img_left.dtype)
        cand = jnp.stack(
            [
                feats_left[:, None, 0] - d_range[None, :],
                jnp.broadcast_to(feats_left[:, None, 1], (n, cfg.max_disparity)),
            ],
            axis=-1,
        )
        patches_l = im.extract_patches(img_left, feats_left, r)  # (N, k, k)
        patches_r = im.extract_patches(img_right, cand.reshape(-1, 2), r).reshape(
            n, cfg.max_disparity, 2 * r + 1, 2 * r + 1
        )
        cand_ok = im.patch_in_bounds(cand, r + 1, h, w)  # (N, D)
        scores = sim.mutual_information(
            patches_l[:, None], patches_r, bins=cfg.mi_bins
        )  # (N, D)
        scores = jnp.where(cand_ok, scores, -jnp.inf)
        min_score = cfg.mi_min_score
        d0 = None
    else:
        # dense ZNCC cost volume from box-filtered moments: no per-candidate
        # gathers (ops/stereo.py), sampled at the feature locations.
        # With a prior, the search narrows to prior_width slots around it.
        if d_prior is not None:
            width = cfg.prior_width
            d0 = jnp.maximum(
                jnp.round(d_prior).astype(jnp.int32) - width // 2, 0
            )
        else:
            width = cfg.max_disparity
            d0 = None
        scores = st.zncc_disparity_scores(
            img_left, img_right, feats_left, width, r, d_offset=d0
        )
        min_score = cfg.min_score
    n_cand = scores.shape[-1]
    best = jnp.argmax(scores, axis=-1)  # (N,)
    best_score = jnp.take_along_axis(scores, best[:, None], axis=-1)[:, 0]

    # sub-pixel disparity from the score parabola around the peak
    bm1 = jnp.clip(best - 1, 0, n_cand - 1)
    bp1 = jnp.clip(best + 1, 0, n_cand - 1)
    s0 = jnp.take_along_axis(scores, bm1[:, None], axis=-1)[:, 0]
    s2 = jnp.take_along_axis(scores, bp1[:, None], axis=-1)[:, 0]
    s0 = jnp.where(jnp.isfinite(s0), s0, best_score)
    s2 = jnp.where(jnp.isfinite(s2), s2, best_score)
    denom = s0 - 2 * best_score + s2
    sub = jnp.where(jnp.abs(denom) > 1e-9, 0.5 * (s0 - s2) / denom, 0.0)
    sub = jnp.clip(sub, -0.5, 0.5)

    disparity = best.astype(img_left.dtype) + sub
    if d0 is not None:
        disparity = disparity + d0.astype(img_left.dtype)
    feats_right = jnp.stack(
        [feats_left[:, 0] - disparity, feats_left[:, 1]], axis=-1
    )

    if cfg.refine_iters > 0 and not use_mi:
        # 1-D photometric Lucas-Kanade along the epipolar line: polishes the
        # integer-grid cost-volume pick to true subpixel alignment. Intensity
        # consistency does not hold cross-modally, so the MI path skips it.
        # The patch value AND its Scharr-x gradient come from ONE widened
        # (r+1) gather per iteration: bilinear sampling and the gradient
        # filter are both LSI, so sample-then-filter equals filter-then-
        # sample on the interior — this halves the gathers and drops the
        # full-image Scharr pass the old formulation paid per frame.
        tpl = im.extract_patches_sep(img_left, feats_left, r)
        # ONE tile gather sized for every iteration: x moves at most 1 px per
        # step (clipped below), so a 2*refine_iters-wider tile around the
        # initial pick covers the whole refinement path.
        it = cfg.refine_iters
        kk = 2 * r + 3  # widened patch for the in-patch gradient
        ax = jnp.floor(feats_right[:, 0]).astype(jnp.int32) - (r + 1) - it
        ay = jnp.floor(feats_right[:, 1]).astype(jnp.int32) - (r + 1)
        rt = im.extract_tiles(img_right, jnp.stack([ax, ay], -1),
                              kk + 1, kk + 1 + 2 * it)
        a_f = jnp.stack([ax, ay], -1).astype(img_right.dtype)

        def refine(_, fr):
            off = fr - a_f - (r + 1)
            pbig = im.sample_tiles(rt, off, kk, kk)
            p = pbig[:, 1:-1, 1:-1]
            sy = (3.0 * pbig[:, :-2, :] + 10.0 * pbig[:, 1:-1, :]
                  + 3.0 * pbig[:, 2:, :]) / 16.0
            g = (sy[:, :, 2:] - sy[:, :, :-2]) * 0.5
            err = p - tpl
            # zero-mean the error: the two cameras' exposures (gain/bias)
            # differ in practice; the DC term would otherwise bias the step
            err = err - jnp.mean(err, axis=(-2, -1), keepdims=True)
            denom = jnp.sum(g * g, axis=(-2, -1))
            step = -jnp.sum(err * g, axis=(-2, -1)) / jnp.maximum(denom, 1e-6)
            step = jnp.clip(step, -1.0, 1.0)
            return fr.at[:, 0].add(step)

        feats_right = jax.lax.fori_loop(0, cfg.refine_iters, refine, feats_right)
        disparity = feats_left[:, 0] - feats_right[:, 0]

    valid = (
        valid_left
        & jnp.isfinite(best_score)
        & (best_score > min_score)
        & (disparity > cfg.min_disparity)
        & im.patch_in_bounds(feats_left, r + 1, h, w)
    )
    return feats_right, best_score, valid


class KLTResult(NamedTuple):
    pts: jax.Array  # (N, 2) tracked locations
    valid: jax.Array  # (N,) bool
    residual: jax.Array  # (N,) mean abs photometric error


@partial(jax.jit, static_argnames=("cfg",))
def klt_track(
    img_prev: jax.Array,
    img_next: jax.Array,
    pts_prev: jax.Array,
    valid_prev: jax.Array,
    cfg: KLTConfig = KLTConfig(),
    init_next: jax.Array | None = None,
    pyr_prev: tuple[jax.Array, ...] | None = None,
    pyr_next: tuple[jax.Array, ...] | None = None,
) -> KLTResult:
    """Pyramidal Lucas-Kanade tracking, all features in lock-step.

    ``pyr_prev``/``pyr_next``: optional prebuilt Gaussian pyramids of
    ``img_prev``/``img_next`` (level 0 = full res). Sequence pipelines build
    each frame's pyramid ONCE and pass it to both steps that use the frame
    (as next, then as prev) — inside a vmapped sequence step XLA cannot CSE
    the duplicate builds across lanes.

    New scope (BASELINE config 2). Coarse-to-fine over a Gaussian pyramid;
    at each level every feature runs up to ``iters`` (level 0) or
    ``iters_coarse`` (levels > 0) lock-step iterations of the 2x2 LK solve
    with masked updates and a batch-wide convergence exit.

    Memory-system design: per level, each feature gathers ONE local tile of
    the next image around its incoming guess; the inner iterations then
    resample the window from that tile with separable bilinear matmuls
    (ops/image.py sample_tiles) instead of issuing 4 gather taps per pixel
    per iteration. Iterations that would leave the tile
    clamp to its border; the final global residual check rejects any track
    that actually needed to travel further (the coarse levels absorb large
    motion, so margin px per level covers the Lucas-Kanade basin anyway).
    """
    h, w = img_prev.shape
    r = cfg.window_radius
    k = 2 * r + 1
    margin = cfg.tile_margin
    tile_size = k + 2 * margin + 1
    npix = (2 * r + 1) ** 2

    if pyr_prev is None:
        pyr_prev = im.build_pyramid(img_prev, cfg.n_levels)
    if pyr_next is None:
        pyr_next = im.build_pyramid(img_next, cfg.n_levels)

    guess = pts_prev if init_next is None else init_next
    # displacement estimate at the coarsest level
    d = (guess - pts_prev) / (2.0 ** (cfg.n_levels - 1))

    eig_ok = jnp.ones_like(valid_prev)
    lvl0 = None  # level-0 (template, tiles, anchor) kept for the residual

    for level in range(cfg.n_levels - 1, -1, -1):
        scale = 2.0**level
        p_prev = pts_prev / scale
        ip, inx = pyr_prev[level], pyr_next[level]

        # template + its Scharr gradients from ONE (k+2)-wide patch gather:
        # bilinear sampling and the gradient filter are both LSI, so
        # sample-then-filter equals filter-then-sample on the interior —
        # this replaces two full-image Scharr passes and two extra patch
        # gathers per level (same trick as the fused kernel).
        t_big = im.extract_patches_sep(ip, p_prev, r + 1)  # (N, k+2, k+2)
        tpl = t_big[:, 1:-1, 1:-1]
        sy = (3.0 * t_big[:, :-2, :] + 10.0 * t_big[:, 1:-1, :]
              + 3.0 * t_big[:, 2:, :]) / 16.0
        gxp = (sy[:, :, 2:] - sy[:, :, :-2]) * 0.5
        sx = (3.0 * t_big[:, :, :-2] + 10.0 * t_big[:, :, 1:-1]
              + 3.0 * t_big[:, :, 2:]) / 16.0
        gyp = (sx[:, 2:, :] - sx[:, :-2, :]) * 0.5

        # 2x2 structure tensor per feature (constant across iterations)
        a11 = jnp.sum(gxp * gxp, axis=(-2, -1))
        a12 = jnp.sum(gxp * gyp, axis=(-2, -1))
        a22 = jnp.sum(gyp * gyp, axis=(-2, -1))
        det = a11 * a22 - a12 * a12
        tr = a11 + a22
        min_eig = 0.5 * (tr - jnp.sqrt(jnp.maximum(tr * tr - 4 * det, 0.0)))
        eig_ok = eig_ok & (min_eig / npix > cfg.min_eig_threshold)
        inv_det = jnp.where(jnp.abs(det) > 1e-9, 1.0 / det, 0.0)

        # one tile gather per feature around the incoming guess
        anchor = jnp.floor(p_prev + d).astype(jnp.int32) - (r + margin)
        tiles = im.extract_tiles(inx, anchor, tile_size)
        anchor_f = anchor.astype(d.dtype)
        track_ok = valid_prev & eig_ok
        if level == 0:
            lvl0 = (tpl, tiles, anchor_f)

        def step(dcur, *, tiles=tiles, anchor_f=anchor_f, p_prev=p_prev,
                 tpl=tpl, gxp=gxp, gyp=gyp, a11=a11, a12=a12, a22=a22,
                 inv_det=inv_det):
            # patch top-left in tile coordinates
            off = p_prev + dcur - anchor_f - r
            patch = im.sample_tiles(tiles, off, k)
            err = patch - tpl
            # bias/gain robustness: auto-exposure shifts the DC level between
            # frames; raw-SSD LK (the OpenCV/reference behavior) soaks that
            # offset into the motion update. Zero-meaning the error removes
            # the bias term exactly and the textured gain remainder
            # ((g-1)*(patch-mean), ~2 gray levels at 8% gain) stays well
            # inside the residual gate.
            err = err - jnp.mean(err, axis=(-2, -1), keepdims=True)
            b1 = jnp.sum(err * gxp, axis=(-2, -1))
            b2 = jnp.sum(err * gyp, axis=(-2, -1))
            dx = -(a22 * b1 - a12 * b2) * inv_det
            dy = -(a11 * b2 - a12 * b1) * inv_det
            upd = jnp.stack([dx, dy], axis=-1)
            ok = jnp.isfinite(upd).all(axis=-1, keepdims=True)
            dnew = dcur + jnp.where(ok, upd, 0.0)
            # stay within the gathered tile (clamp in displacement space)
            lo = anchor_f + r - p_prev  # off = 0
            hi = lo + (tile_size - k - 1)
            dnew = jnp.clip(dnew, lo, hi)
            # residual step of still-live tracks, for the convergence exit
            live = jnp.where(track_ok[:, None], jnp.abs(dnew - dcur), 0.0)
            return dnew, jnp.max(live)

        iters_level = cfg.iters if level == 0 else cfg.iters_coarse

        def cond(c, iters_level=iters_level):
            i, _, delta = c
            return (i < iters_level) & (delta > cfg.converge_px)

        def body(c):
            i, dcur, _ = c
            dnew, delta = step(dcur)
            return i + 1, dnew, delta

        # while_loop instead of a fixed fori_loop: all features usually
        # converge in 3-5 iterations; the lock-step batch exits as soon as
        # the largest live update drops below converge_px
        _, d, _ = jax.lax.while_loop(
            cond, body, (jnp.asarray(0, jnp.int32), d,
                         jnp.asarray(jnp.inf, d.dtype))
        )
        if level > 0:
            d = d * 2.0

    pts_next = pts_prev + d

    if lvl0 is not None:
        # Residual check from the level-0 intermediates: level 0's template
        # IS the bilinear patch of img_prev at pts_prev (interior of t_big),
        # and the final displacement was clamped inside level 0's tile, so
        # both full-resolution re-gathers of the old formulation are free.
        tpl0, tiles0, anchor0 = lvl0
        final_patch = im.sample_tiles(tiles0, pts_next - anchor0 - r, k)
        residual = _photometric_residual(final_patch, tpl0)
    else:
        final_patch = im.extract_patches_sep(img_next, pts_next, r)
        tpl0 = im.extract_patches_sep(img_prev, pts_prev, r)
        residual = _photometric_residual(final_patch, tpl0)

    valid = (
        valid_prev
        & eig_ok
        & (residual < cfg.max_residual)
        & (jnp.linalg.norm(d, axis=-1) < cfg.max_displacement)
        & im.patch_in_bounds(pts_next, r + 1, h, w)
        & im.patch_in_bounds(pts_prev, r + 1, h, w)
    )
    return KLTResult(pts=pts_next, valid=valid, residual=residual)


class QuadMatches(NamedTuple):
    """Fixed-shape quad-match table, the array equivalent of
    vector<StereoOdoMatchesf> (feature_types.h:105-115)."""

    uv: jax.Array  # (N, 4, 2): f1 prevL, f2 prevR, f3 curL, f4 curR
    valid: jax.Array  # (N,)


@partial(jax.jit, static_argnames=("max_features", "matcher", "klt",
                                   "detect_kwargs", "detector"))
def quad_match_frames(
    prev_left: jax.Array,
    prev_right: jax.Array,
    cur_left: jax.Array,
    cur_right: jax.Array,
    max_features: int = 500,
    matcher: MatcherConfig = MatcherConfig(),
    klt: KLTConfig = KLTConfig(),
    detect_kwargs: tuple = (),
    detector: str = "grid",
    pyr_prev_left: tuple[jax.Array, ...] | None = None,
    pyr_cur_left: tuple[jax.Array, ...] | None = None,
) -> QuadMatches:
    """Full quad-matching: detect in prev-left, ZNCC-match both stereo pairs,
    KLT-track left features forward (the front-end loop the reference leaves
    to its consumers; SURVEY.md section 3.5).

    ``detector``: "grid" = bucketed best-per-cell GFTT (fast, spread);
    "topk" = global top-k GFTT with NMS (ops/image.py detect_features).

    ``pyr_prev_left``/``pyr_cur_left``: optional prebuilt left-image KLT
    pyramids (see klt_track) for sequence pipelines that share per-frame
    artifacts between adjacent steps.
    """
    kw = dict(detect_kwargs)
    if detector == "grid":
        kw.pop("nms_radius", None)  # cell bucketing subsumes wide NMS
        feats_l, _, v0 = im.detect_features_grid(
            prev_left, max_features=max_features, **kw
        )
    else:
        feats_l, _, v0 = im.detect_features(
            prev_left, max_features=max_features, **kw
        )
    f2, _, v1 = match_stereo(prev_left, prev_right, feats_l, v0, matcher)
    tracked = klt_track(prev_left, cur_left, feats_l, v1, klt,
                        pyr_prev=pyr_prev_left, pyr_next=pyr_cur_left)
    # cur-pair match reuses each tracked feature's prev-pair disparity as a
    # search prior: 5x less cost-volume work and fewer aliasing mismatches
    # (inter-frame disparity change is bounded by the motion, not the range)
    f4, _, v3 = match_stereo(cur_left, cur_right, tracked.pts, tracked.valid,
                             matcher, d_prior=feats_l[:, 0] - f2[:, 0])
    uv = jnp.stack([feats_l, f2, tracked.pts, f4], axis=1)
    return QuadMatches(uv=uv, valid=v3)
