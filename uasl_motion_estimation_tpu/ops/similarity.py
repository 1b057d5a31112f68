"""Patch similarity measures: entropy, mutual information, ZNCC.

Batched JAX re-design of the reference's mutual-information core
(reference: include/MotionEstimation/core/mutual_information.h:16-24,
src/core/mutual_information.cpp:14-140). The scalar double-loops over OpenCV
histograms become batched one-hot matmuls: a patch of P pixels quantized to
``bins`` levels is a (P, bins) one-hot matrix ``O``; the joint histogram of two
patches is ``O_a^T @ O_b`` — a tiny matmul, batched over thousands of patches
at once under ``vmap``.

All functions accept arbitrary leading batch dims; patches are flattened
internally. Intensities are expected in [0, 256) (uint8-like), matching the
reference's ``calcHist`` ranges (mutual_information.cpp:30-34, 62-76).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

DEFAULT_BINS = 20  # reference: histSize = 20 (mutual_information.cpp:33, 66)


def _flatten_patch(img: jax.Array) -> jax.Array:
    """(..., H, W) -> (..., H*W); 1-D patches pass through."""
    return img.reshape(img.shape[:-2] + (-1,)) if img.ndim >= 2 else img


def quantise(img: jax.Array, bins: int = DEFAULT_BINS, vmax: float = 256.0) -> jax.Array:
    """Intensity -> integer bin ids in [0, bins).

    Same binning as OpenCV calcHist over [0, 256) with ``bins`` buckets
    (and as ``quantise``, mutual_information.cpp:48-53).
    """
    idx = jnp.floor(img.astype(jnp.float32) * (bins / vmax)).astype(jnp.int32)
    return jnp.clip(idx, 0, bins - 1)


def _one_hot(img: jax.Array, bins: int) -> jax.Array:
    return jax.nn.one_hot(quantise(img, bins), bins, dtype=jnp.float32)


def histogram(img: jax.Array, bins: int = DEFAULT_BINS) -> jax.Array:
    """Normalized intensity histogram, (..., bins)."""
    flat = _flatten_patch(img)
    return jnp.mean(_one_hot(flat, bins), axis=-2)


def entropy(img: jax.Array, bins: int = DEFAULT_BINS) -> jax.Array:
    """Shannon entropy (bits) of the intensity distribution.

    Reference: ``computeEntropy`` (mutual_information.cpp:28-45).
    """
    p = histogram(img, bins)
    logp = jnp.where(p > 0, jnp.log2(jnp.where(p > 0, p, 1.0)), 0.0)
    return -jnp.sum(p * logp, axis=-1)


def joint_histogram(img_a: jax.Array, img_b: jax.Array, bins: int = DEFAULT_BINS
                    ) -> jax.Array:
    """Normalized joint histogram (..., bins, bins) via one-hot matmul.

    Replaces the 2-channel calcHist of ``computeMutualInformation``
    (mutual_information.cpp:70-76); this formulation (O_a^T @ O_b) is a
    matmul and vmaps over patch batches.
    """
    a = _one_hot(_flatten_patch(img_a), bins)
    b = _one_hot(_flatten_patch(img_b), bins)
    n = a.shape[-2]
    return jnp.einsum("...pi,...pj->...ij", a, b) / n


def mutual_information(img_a: jax.Array, img_b: jax.Array, bins: int = DEFAULT_BINS
                       ) -> jax.Array:
    """MI(a, b) in bits between two equally-shaped patches.

    Reference: ``computeMutualInformation`` (mutual_information.cpp:55-86):
    MI = sum_ij p_ij * log2(p_ij / (p_i * p_j)) over a bins x bins joint
    histogram. Batched over leading dims.
    """
    pj = joint_histogram(img_a, img_b, bins)
    pa = jnp.sum(pj, axis=-1, keepdims=True)  # marginal of a: (..., bins, 1)
    pb = jnp.sum(pj, axis=-2, keepdims=True)  # marginal of b: (..., 1, bins)
    denom = pa * pb
    valid = (pj > 0) & (denom > 0)
    ratio = jnp.where(valid, pj / jnp.where(valid, denom, 1.0), 1.0)
    return jnp.sum(jnp.where(valid, pj * jnp.log2(ratio), 0.0), axis=(-2, -1))


def ncc(img_a: jax.Array, img_b: jax.Array, eps: float = 1e-12) -> jax.Array:
    """Plain (non-centered) normalized cross-correlation.

    Reference: ``comparePC`` (mutual_information.cpp:14-25), used for
    phase-congruency images.
    """
    a = _flatten_patch(img_a).astype(jnp.float32)
    b = _flatten_patch(img_b).astype(jnp.float32)
    num = jnp.sum(a * b, axis=-1)
    den = jnp.sqrt(jnp.sum(a * a, axis=-1) * jnp.sum(b * b, axis=-1))
    return num / jnp.maximum(den, eps)


def zncc(img_a: jax.Array, img_b: jax.Array, eps: float = 1e-12) -> jax.Array:
    """Zero-mean normalized cross-correlation (TM_CCOEFF_NORMED semantics).

    Capability parity with ``applyCCOEFFNormed`` (mutual_information.cpp:136-140)
    — implemented as the standard centered NCC rather than reproducing that
    function's non-standard centering.
    """
    a = _flatten_patch(img_a).astype(jnp.float32)
    b = _flatten_patch(img_b).astype(jnp.float32)
    a = a - jnp.mean(a, axis=-1, keepdims=True)
    b = b - jnp.mean(b, axis=-1, keepdims=True)
    num = jnp.sum(a * b, axis=-1)
    den = jnp.sqrt(jnp.sum(a * a, axis=-1) * jnp.sum(b * b, axis=-1))
    return num / jnp.maximum(den, eps)
