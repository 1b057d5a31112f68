"""Image operations: pyramids, gradients, corner response, NMS, sampling.

New-scope front-end ops (the reference delegates detection/tracking to OpenCV
and only ships a scanline NMS, feature_types.cpp:253-351; BASELINE.json adds
GFTT/ZNCC/KLT as required capabilities). All ops are pure jnp on (H, W)
float32 images, expressed as convolutions/reductions that XLA fuses; no
data-dependent shapes.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def _filter1d(img: jax.Array, taps, axis: int) -> jax.Array:
    """Small 1-D FIR filter along ``axis``, SAME padding (edge replicated).

    Unrolled shifted adds instead of conv_general_dilated: a generic conv on
    1x1-channel NCHW images wastes the matrix units, while a handful of
    slice+multiply+add ops are elementwise traffic that fuses into one pass.
    """
    taps = np.asarray(taps, dtype=np.float64)
    r = len(taps) // 2
    pad = [(0, 0)] * img.ndim
    pad[axis] = (r, r)
    p = jnp.pad(img, pad, mode="edge")
    n = img.shape[axis]
    out = None
    for i, t in enumerate(taps):
        term = float(t) * jax.lax.slice_in_dim(p, i, i + n, axis=axis)
        out = term if out is None else out + term
    return out


def _conv2d_same(img: jax.Array, kernel: jax.Array) -> jax.Array:
    """Single-channel 2D convolution, SAME padding (edge values replicated)."""
    kh, kw = kernel.shape
    pad = ((kh // 2, kh // 2), (kw // 2, kw // 2))
    img_p = jnp.pad(img, pad, mode="edge")
    out = jax.lax.conv_general_dilated(
        img_p[None, None],
        kernel[None, None].astype(img.dtype),
        window_strides=(1, 1),
        padding="VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
    )
    return out[0, 0]


def _sep_filter(img: jax.Array, k_row: jax.Array, k_col: jax.Array) -> jax.Array:
    """Separable filter: k_col applied along rows, k_row along columns."""
    out = _filter1d(img, np.asarray(k_col), axis=img.ndim - 2)
    return _filter1d(out, np.asarray(k_row), axis=img.ndim - 1)


# numpy (not jnp) so importing this module never touches a device backend
_BINOMIAL5 = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0


def gaussian_blur5(img: jax.Array) -> jax.Array:
    """5-tap binomial blur (Burt-Adelson pyramid kernel)."""
    return _sep_filter(img, _BINOMIAL5, _BINOMIAL5)


def pyr_down(img: jax.Array) -> jax.Array:
    """Blur + 2x decimation (cv2.pyrDown semantics)."""
    return gaussian_blur5(img)[::2, ::2]


def build_pyramid(img: jax.Array, n_levels: int) -> list[jax.Array]:
    """Gaussian pyramid, level 0 = full resolution."""
    levels = [img]
    for _ in range(n_levels - 1):
        levels.append(pyr_down(levels[-1]))
    return levels


def sobel(img: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Sobel gradients (gx, gy), same normalization as cv2.Sobel ksize=3
    (used for MI weighting, optimisation.cpp:483)."""
    smooth = np.array([1.0, 2.0, 1.0])
    diff = np.array([-1.0, 0.0, 1.0])
    gx = _sep_filter(img, diff, smooth)
    gy = _sep_filter(img, smooth, diff)
    return gx, gy


def scharr(img: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Scharr gradients, scaled to approximate intensity derivatives
    (1/32 normalization) — better rotational symmetry for KLT."""
    smooth = np.array([3.0, 10.0, 3.0]) / 16.0
    diff = np.array([-1.0, 0.0, 1.0]) / 2.0
    gx = _sep_filter(img, diff, smooth)
    gy = _sep_filter(img, smooth, diff)
    return gx, gy


def _box_filter(img: jax.Array, radius: int) -> jax.Array:
    k = np.ones(2 * radius + 1) / (2 * radius + 1)
    return _sep_filter(img, k, k)


def shi_tomasi_response(img: jax.Array, window_radius: int = 2) -> jax.Array:
    """GFTT (min-eigenvalue of the structure tensor) corner response.

    Equivalent of cv2.goodFeaturesToTrack's quality map (new scope per
    BASELINE.json config 1). lambda_min = (a+c)/2 - sqrt(((a-c)/2)^2 + b^2)
    with [a b; b c] the box-filtered structure tensor.
    """
    gx, gy = sobel(img)
    a = _box_filter(gx * gx, window_radius)
    b = _box_filter(gx * gy, window_radius)
    c = _box_filter(gy * gy, window_radius)
    half_tr = 0.5 * (a + c)
    disc = jnp.sqrt(jnp.maximum(0.25 * (a - c) ** 2 + b * b, 0.0))
    return half_tr - disc


def harris_response(img: jax.Array, window_radius: int = 2, k: float = 0.04
                    ) -> jax.Array:
    """Harris corner response det(M) - k*trace(M)^2 (alternative detector)."""
    gx, gy = sobel(img)
    a = _box_filter(gx * gx, window_radius)
    b = _box_filter(gx * gy, window_radius)
    c = _box_filter(gy * gy, window_radius)
    return a * c - b * b - k * (a + c) ** 2


def nms(response: jax.Array, radius: int = 1) -> jax.Array:
    """Non-maximum suppression: keep strict regional maxima.

    Block-parallel re-design of the scanline 3x3 NMS
    (feature_types.cpp:253-351): a pixel survives iff it equals the max of its
    (2r+1)^2 neighborhood — a reduce_window max-pool instead of the serial
    scan-and-skip automaton.
    """
    k = 2 * radius + 1
    pooled = jax.lax.reduce_window(
        response, -jnp.inf, jax.lax.max, (k, k), (1, 1), "SAME"
    )
    return jnp.where(response >= pooled, response, -jnp.inf)


def subpixel_peak_2d(patch3: jax.Array) -> jax.Array:
    """Quadratic sub-pixel offset (dx, dy) from a 3x3 score neighborhood.

    Same idea as the parabola fit in nonMaxSupScanline3x3's refinement
    (feature_types.cpp:330-349), vectorized over leading batch dims.
    """
    dx = 0.5 * (patch3[..., 1, 2] - patch3[..., 1, 0])
    dy = 0.5 * (patch3[..., 2, 1] - patch3[..., 0, 1])
    dxx = patch3[..., 1, 2] - 2.0 * patch3[..., 1, 1] + patch3[..., 1, 0]
    dyy = patch3[..., 2, 1] - 2.0 * patch3[..., 1, 1] + patch3[..., 0, 1]
    off_x = jnp.where(jnp.abs(dxx) > 1e-9, -dx / dxx, 0.0)
    off_y = jnp.where(jnp.abs(dyy) > 1e-9, -dy / dyy, 0.0)
    return jnp.stack(
        [jnp.clip(off_x, -0.5, 0.5), jnp.clip(off_y, -0.5, 0.5)], axis=-1
    )


@partial(jax.jit, static_argnames=("max_features", "nms_radius", "border"))
def detect_features(
    img: jax.Array,
    max_features: int = 500,
    quality_level: float = 0.01,
    nms_radius: int = 5,
    border: int = 8,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """GFTT detection: response -> NMS -> top-k, fixed output shape.

    Returns (xy (K, 2) float32 subpixel coords, scores (K,), valid (K,) bool).
    Deterministic: top_k breaks ties by linear index. The default feature
    budget mirrors TrackingInfo.nb_feats=500 (file_IO.h:69-73).
    """
    h, w = img.shape
    raw = shi_tomasi_response(img)
    resp = nms(raw, nms_radius)

    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    in_border = (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
    resp = jnp.where(in_border, resp, -jnp.inf)

    flat = resp.ravel()
    # approx_max_k: approximate top-k (the exact top_k is sort-bound for
    # ~500k-pixel response maps). Post-NMS maxima are sparse, so recall loss
    # is negligible for detection.
    scores, idx = jax.lax.approx_max_k(flat, max_features)
    yx = jnp.stack(jnp.unravel_index(idx, (h, w)), axis=-1)

    valid = jnp.isfinite(scores) & (scores > quality_level * jnp.max(scores))

    # subpixel refinement on the raw response
    patches = extract_patches(raw, yx[:, ::-1].astype(jnp.float32), 1)
    off = subpixel_peak_2d(patches)
    xy = yx[:, ::-1].astype(jnp.float32) + off
    return xy, scores, valid


def _grid_shape(h: int, w: int, max_features: int) -> tuple[int, int]:
    """(rows, cols) of the bucket grid: ~square cells, rows*cols <= budget."""
    gh = max(1, int(round((max_features * h / w) ** 0.5)))
    gw = max(1, max_features // gh)
    while gh * gw > max_features:  # pragma: no cover - round() guard
        gw -= 1
    return gh, gw


@partial(jax.jit, static_argnames=("max_features", "border"))
def detect_features_grid(
    img: jax.Array,
    max_features: int = 500,
    quality_level: float = 0.01,
    border: int = 8,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """GFTT detection by grid bucketing: best corner per cell, no sort.

    The top-k formulation (detect_features) pays an approx_max_k over the
    ~0.5 MP response map and clusters features on strong texture; bucketing
    divides the image into ~max_features cells and keeps each cell's maximum
    — a reshape+argmax, the cheapest possible selection, and the
    uniform spatial spread measurably improves pose conditioning (the classic
    VO bucketing trick). Strict 3x3 local-max, border and quality gates match
    the reference NMS semantics (feature_types.cpp:253-351).

    Returns (xy (max_features, 2) float32, scores, valid) — cells beyond the
    grid (and textureless cells) are masked invalid.
    """
    h, w = img.shape
    raw = shi_tomasi_response(img)

    # strict 3x3 local maxima, border masked
    pooled = jax.lax.reduce_window(
        raw, -jnp.inf, jax.lax.max, (3, 3), (1, 1), "SAME"
    )
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    in_border = (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
    resp = jnp.where((raw >= pooled) & in_border, raw, -jnp.inf)

    gh, gw = _grid_shape(h, w, max_features)
    ch = -(-h // gh)
    cw = -(-w // gw)
    resp_p = jnp.pad(
        resp, ((0, gh * ch - h), (0, gw * cw - w)), constant_values=-jnp.inf
    )
    cells = resp_p.reshape(gh, ch, gw, cw).transpose(0, 2, 1, 3).reshape(
        gh * gw, ch * cw
    )
    best = jnp.argmax(cells, axis=1)  # (G,)
    scores = jnp.take_along_axis(cells, best[:, None], axis=1)[:, 0]
    cell_idx = jnp.arange(gh * gw)
    y = (cell_idx // gw) * ch + best // cw
    x = (cell_idx % gw) * cw + best % cw

    xy_i = jnp.stack([x, y], axis=-1).astype(jnp.float32)
    patches = extract_patches(raw, xy_i, 1)
    xy = xy_i + subpixel_peak_2d(patches)
    valid = jnp.isfinite(scores) & (scores > quality_level * jnp.max(scores))

    pad = max_features - gh * gw
    if pad > 0:
        xy = jnp.pad(xy, ((0, pad), (0, 0)))
        scores = jnp.pad(scores, (0, pad), constant_values=-jnp.inf)
        valid = jnp.pad(valid, (0, pad))
    return xy, scores, valid


def bilinear_sample(img: jax.Array, xy: jax.Array) -> jax.Array:
    """Bilinear interpolation of img at float (x, y) locations (..., 2).

    Out-of-bounds coordinates clamp to the edge.
    """
    h, w = img.shape
    x = jnp.clip(xy[..., 0], 0.0, w - 1.0)
    y = jnp.clip(xy[..., 1], 0.0, h - 1.0)
    x0 = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, w - 2)
    y0 = jnp.clip(jnp.floor(y).astype(jnp.int32), 0, h - 2)
    fx = x - x0
    fy = y - y0
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    return (
        v00 * (1 - fx) * (1 - fy)
        + v01 * fx * (1 - fy)
        + v10 * (1 - fx) * fy
        + v11 * fx * fy
    )


def extract_patches(img: jax.Array, centers: jax.Array, radius: int) -> jax.Array:
    """Bilinear (2r+1)x(2r+1) patches around float centers (N, 2) [x, y].

    Returns (N, 2r+1, 2r+1). The gather-based equivalent of the reference's
    ROI rectangles (optimisation.cpp:185-186).
    """
    k = 2 * radius + 1
    dy, dx = jnp.meshgrid(
        jnp.arange(k, dtype=img.dtype) - radius,
        jnp.arange(k, dtype=img.dtype) - radius,
        indexing="ij",
    )
    offs = jnp.stack([dx, dy], axis=-1)  # (k, k, 2) as (x, y)
    pts = centers[:, None, None, :] + offs[None]
    return bilinear_sample(img, pts)


def extract_tiles(img: jax.Array, anchors: jax.Array, size: int,
                  size_w: int | None = None) -> jax.Array:
    """Integer (size x size_w) tiles with top-left corners ``anchors`` (N, 2)
    int32 [x, y]; out-of-bounds reads come from edge padding.

    ONE tile gather per feature (rows of ``size_w`` contiguous pixels); all
    sub-pixel sampling then happens inside the tile as small matmuls (see
    sample_tiles) instead of 4 scattered taps per pixel."""
    size_w = size if size_w is None else size_w
    h, w = img.shape
    pad_y, pad_x = size, size_w
    padded = jnp.pad(img, ((pad_y, pad_y), (pad_x, pad_x)), mode="edge")
    ax = jnp.clip(anchors[:, 0], -size_w, w - 1) + pad_x
    ay = jnp.clip(anchors[:, 1], -size, h - 1) + pad_y
    rows = ay[:, None] + jnp.arange(size)
    cols = ax[:, None] + jnp.arange(size_w)
    return padded[rows[:, :, None], cols[:, None, :]]  # (N, size, size_w)


def sample_tiles(tiles: jax.Array, offsets: jax.Array, kh: int,
                 kw: int | None = None) -> jax.Array:
    """Bilinear (kh x kw) patches from (N, Sh, Sw) tiles at float top-left
    ``offsets`` (N, 2) [x, y] in tile coordinates.

    Bilinear interpolation is separable, so the sample is two small batched
    matmuls instead of 4 gather taps per pixel:
      patch = Wy @ tile @ Wx^T,  Wy[i, s] = max(0, 1 - |(y0 + i) - s|).
    Offsets are clamped so the patch stays inside the tile."""
    kw = kh if kw is None else kw
    n, sh, sw = tiles.shape
    dtype = tiles.dtype
    # max top-left keeps the last bilinear tap (offset + k - 1, rounded up)
    # inside the tile: offset <= s - k
    ox = jnp.clip(offsets[:, 0], 0.0, float(sw - kw))
    oy = jnp.clip(offsets[:, 1], 0.0, float(sh - kh))
    iy = jnp.arange(kh, dtype=dtype)
    ix = jnp.arange(kw, dtype=dtype)
    ssh = jnp.arange(sh, dtype=dtype)
    ssw = jnp.arange(sw, dtype=dtype)
    wy = jnp.maximum(
        0.0, 1.0 - jnp.abs(oy[:, None, None] + iy[None, :, None] - ssh[None, None, :])
    )  # (N, kh, Sh)
    wx = jnp.maximum(
        0.0, 1.0 - jnp.abs(ox[:, None, None] + ix[None, :, None] - ssw[None, None, :])
    )  # (N, kw, Sw)
    # full f32 products: a reduced-precision default (TF32 / bf16 passes)
    # truncates the image VALUES (the weights are exact tent selections)
    tmp = jnp.einsum("nks,nst->nkt", wy, tiles, precision="highest")
    return jnp.einsum("nkt,njt->nkj", tmp, wx, precision="highest")


def extract_patches_sep(img: jax.Array, centers: jax.Array, radius: int
                        ) -> jax.Array:
    """Drop-in for extract_patches: one integer tile gather + separable
    bilinear matmuls instead of 4 scattered taps per pixel."""
    h, w = img.shape
    k = 2 * radius + 1
    x = jnp.clip(centers[:, 0], 0.0, w - 1.0)
    y = jnp.clip(centers[:, 1], 0.0, h - 1.0)
    ax = jnp.floor(x).astype(jnp.int32) - radius
    ay = jnp.floor(y).astype(jnp.int32) - radius
    tiles = extract_tiles(img, jnp.stack([ax, ay], -1), k + 1)
    # edge-clamp parity with bilinear_sample: offsets relative to the tile
    offs = jnp.stack([x - ax.astype(img.dtype) - radius,
                      y - ay.astype(img.dtype) - radius], -1)
    return sample_tiles(tiles, offs, k)


def patch_in_bounds(centers: jax.Array, radius: float, h: int, w: int) -> jax.Array:
    """(N,) bool: whole patch inside the image (the reference's bb.contains
    guard, optimisation.cpp:155, 183)."""
    x, y = centers[..., 0], centers[..., 1]
    return (
        (x >= radius) & (x < w - radius - 1) & (y >= radius) & (y < h - radius - 1)
    )
