"""ZNCC disparity cost volume — the batched epipolar matcher core.

Replaces the reference's per-ROI ``applyCCOEFFNormed``
(src/core/mutual_information.cpp:136-140) scaled to all features x
disparities at once.

Design: score only what is needed. For each of the
N features, gather ONE horizontal strip of the right image covering all D
candidate windows (a single (N, K, D+K-1) gather), then compute the whole
(N, D) ZNCC volume as batched einsums over shifted strip views — the cross
term is a (K*K)x(D) matvec per feature. Total compute is ~N*D*K^2 MACs
(~15 MFLOP for 500 feats x 128 disparities x 11x11), with no sequential
scan and no full-image work.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from . import image as im


@partial(jax.jit, static_argnames=("max_disparity", "radius"))
def zncc_disparity_scores(
    left: jax.Array,
    right: jax.Array,
    feats_xy: jax.Array,
    max_disparity: int,
    radius: int,
    eps: float = 1e-6,
    d_offset: jax.Array | None = None,
) -> jax.Array:
    """(N, D) ZNCC score of each left feature against right candidates.

    Args:
      left, right: (H, W) rectified grayscale images.
      feats_xy: (N, 2) float (x, y) feature locations in the left image
        (sampled at the nearest pixel; sub-pixel disparity comes from the
        caller's parabola refinement over d).
      max_disparity: candidate disparities d in [0, max_disparity).
      radius: ZNCC window radius.
      d_offset: optional (N,) int32 per-feature disparity prior offset:
        candidate i scores true disparity ``d_offset + i``. Lets callers
        with a prior (e.g. the previous frame's disparity of a tracked
        feature) search a narrow window instead of the full range.

    Returns (N, D) scores in [-1, 1]; out-of-image (or negative-disparity)
    candidates get -inf.
    """
    h, w = left.shape
    dtype = left.dtype
    d_max = max_disparity
    r = radius
    k = 2 * r + 1
    npix = k * k

    xi = jnp.clip(jnp.round(feats_xy[:, 0]).astype(jnp.int32), 0, w - 1)
    yi = jnp.clip(jnp.round(feats_xy[:, 1]).astype(jnp.int32), 0, h - 1)
    if d_offset is None:
        d_offset = jnp.zeros_like(xi)

    # one strip per feature covering every candidate window: true columns
    # [xi - d0 - (D-1) - r, xi - d0 + r]; one tile gather per feature —
    # out-of-bounds candidates are masked below
    strip_w = d_max + 2 * r
    strip_anchor = jnp.stack([xi - d_offset - (d_max - 1) - r, yi - r], -1)
    strip = im.extract_tiles(right, strip_anchor, k, strip_w)  # (N, K, S)

    # left template patch at the same integer grid
    tpl_anchor = jnp.stack([xi - r, yi - r], -1)
    tpl = im.extract_tiles(left, tpl_anchor, k)  # (N, K, K)
    tpl0 = tpl - jnp.mean(tpl, axis=(-2, -1), keepdims=True)
    tnorm = jnp.sqrt(jnp.maximum(jnp.sum(tpl0 * tpl0, axis=(-2, -1)), eps))

    # Window moments WITHOUT materializing the (N, K, K, D) shifted-view
    # tensor (N*K*K*D floats of device-memory traffic): column sums + cumsum
    # differencing give every window's s1/s2 in O(K*S). The strip is centered
    # at 128 first so the f32 cumsums keep ~1e-5 relative precision (ZNCC is
    # shift-invariant: tpl0 is zero-mean and var ignores the offset).
    strip_c = strip - 128.0
    col1 = jnp.sum(strip_c, axis=1)  # (N, S)
    col2 = jnp.sum(strip_c * strip_c, axis=1)
    zero = jnp.zeros_like(col1[:, :1])
    cs1 = jnp.concatenate([zero, jnp.cumsum(col1, axis=-1)], -1)
    cs2 = jnp.concatenate([zero, jnp.cumsum(col2, axis=-1)], -1)
    s1 = cs1[:, k : k + d_max] - cs1[:, :d_max]  # (N, t)
    s2 = cs2[:, k : k + d_max] - cs2[:, :d_max]
    var_n = jnp.maximum(s2 - s1 * s1 / npix, eps)  # npix * var

    # cross term per template column over strip slices (no big intermediate);
    # Sum(tpl0) = 0 makes the candidate-mean term vanish
    corr = sum(
        jnp.einsum(
            "ni,nit->nt",
            tpl0[:, :, c],
            jax.lax.slice_in_dim(strip_c, c, c + d_max, axis=2),
            precision="highest",
        )
        for c in range(k)
    )

    z = corr / (jnp.sqrt(var_n) * tnorm[:, None])  # (N, t)
    z = jnp.flip(z, axis=-1)  # t = D-1-d  ->  index by d

    d_range = jnp.arange(d_max, dtype=jnp.int32)
    d_abs = d_offset[:, None] + d_range[None, :]  # true disparity per slot
    ok = (
        (d_abs >= 0)
        & ((xi[:, None] - d_abs - r) >= 0)
        & ((xi + r) < w)[:, None]
        & ((yi - r) >= 0)[:, None]
        & ((yi + r) < h)[:, None]
    )
    return jnp.where(ok, z, -jnp.inf).astype(dtype)
