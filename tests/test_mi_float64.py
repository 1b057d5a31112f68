"""The jnp MI path (ops/similarity.py, one-hot joint-histogram matmuls)
against a plain float64 numpy histogram, at the shapes the MI matcher and
the MI scale optimiser use."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from uasl_motion_estimation_tpu.ops import similarity as sim

RNG = np.random.default_rng(5)


def quantise_np(x, bins=20, vmax=256.0):
    """Bin ids as ops.similarity.quantise defines them (float32 product)."""
    return np.clip(np.floor(np.asarray(x, np.float32) * np.float32(bins / vmax)),
                   0, bins - 1).astype(int)


def mi_float64(a, b, bins=20):
    """MI (bits) of every pair of patches (..., H, W), float64 numpy."""
    qa = quantise_np(a, bins).reshape(-1, a.shape[-2] * a.shape[-1])
    qb = quantise_np(b, bins).reshape(qa.shape)
    out = []
    for x, y in zip(qa, qb):
        joint = np.zeros((bins, bins))
        np.add.at(joint, (x, y), 1.0)
        pj = joint / len(x)
        outer = pj.sum(1, keepdims=True) * pj.sum(0, keepdims=True)
        nz = pj > 0
        out.append(np.sum(pj[nz] * np.log2(pj[nz] / outer[nz])))
    return np.asarray(out).reshape(a.shape[:-2])


def entropy_float64(a, bins=20):
    q = quantise_np(a, bins).reshape(-1, a.shape[-2] * a.shape[-1])
    out = []
    for x in q:
        p = np.bincount(x, minlength=bins) / len(x)
        p = p[p > 0]
        out.append(-np.sum(p * np.log2(p)))
    return np.asarray(out).reshape(a.shape[:-2])


def correlated_pairs(shape, noise, rng=RNG):
    a = rng.uniform(0, 255, shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, noise, shape), 0, 255).astype(np.float32)
    return a, b


@pytest.mark.parametrize("noise", [0.0, 8.0, 30.0, 1000.0])
def test_matches_float64_across_dependence(noise):
    """From identical (noise 0) to near-independent (noise 1000) pairs of
    11x11 patches, the MI matcher's patch size."""
    a, b = correlated_pairs((37, 11, 11), noise)
    got = np.asarray(sim.mutual_information(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, mi_float64(a, b), atol=1e-5)


def test_identical_patches_give_entropy():
    a = RNG.uniform(0, 255, (5, 11, 11)).astype(np.float32)
    got = np.asarray(sim.mutual_information(jnp.asarray(a), jnp.asarray(a)))
    np.testing.assert_allclose(got, entropy_float64(a), atol=1e-5)
    np.testing.assert_allclose(np.asarray(sim.entropy(jnp.asarray(a))),
                               entropy_float64(a), atol=1e-5)


def test_independent_patches_near_zero():
    """One patch against unrelated ones: MI well below the entropy."""
    a = np.tile(RNG.uniform(0, 255, (1, 11, 11)), (3, 1, 1)).astype(np.float32)
    b = RNG.uniform(0, 255, (3, 11, 11)).astype(np.float32)
    got = np.asarray(sim.mutual_information(jnp.asarray(a), jnp.asarray(b)))
    assert (got < 0.5 * entropy_float64(a)).all()
    np.testing.assert_allclose(got, mi_float64(a, b), atol=1e-5)


def test_cost_volume_broadcast():
    """The MI matcher's call shape: (N, 1, k, k) templates against
    (N, D, k, k) candidates broadcast to (N, D) scores."""
    tpl = RNG.uniform(0, 255, (6, 1, 9, 9)).astype(np.float32)
    cand = RNG.uniform(0, 255, (6, 5, 9, 9)).astype(np.float32)
    cand[:, 2] = np.clip(tpl[:, 0] + RNG.normal(0, 5, (6, 9, 9)), 0, 255)
    got = np.asarray(sim.mutual_information(jnp.asarray(tpl),
                                            jnp.asarray(cand)))
    assert got.shape == (6, 5)
    want = mi_float64(np.broadcast_to(tpl, cand.shape), cand)
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert (got.argmax(axis=1) == 2).all()


@pytest.mark.parametrize("bins", [8, 20, 32])
def test_bin_counts(bins):
    a, b = correlated_pairs((9, 11, 11), 20.0)
    got = np.asarray(sim.mutual_information(jnp.asarray(a), jnp.asarray(b),
                                            bins=bins))
    np.testing.assert_allclose(got, mi_float64(a, b, bins), atol=1e-5)


def test_quantisation_edges():
    """Values at and beyond the [0, 256) range clip into the end bins,
    as calcHist's range does for uint8 input."""
    a = np.array([0.0, 12.79, 12.8, 255.99, 256.0, 300.0, -4.0, 128.0, 64.0,
                  200.0, 5.0, 250.0, 100.0, 12.0, 140.0, 33.0],
                 np.float32).reshape(1, 4, 4)
    b = a[:, ::-1, :].copy()
    got = np.asarray(sim.mutual_information(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, mi_float64(a, b), atol=1e-5)
    np.testing.assert_array_equal(
        np.asarray(sim.quantise(jnp.asarray(a)))[0].ravel(),
        quantise_np(a)[0].ravel())


def test_batch_shapes_under_jit_and_vmap():
    a, b = correlated_pairs((4, 7, 9, 9), 15.0)
    want = mi_float64(a, b)
    f = jax.jit(functools.partial(sim.mutual_information, bins=20))
    np.testing.assert_allclose(np.asarray(f(jnp.asarray(a), jnp.asarray(b))),
                               want, atol=1e-5)
    g = jax.vmap(sim.mutual_information)
    np.testing.assert_allclose(np.asarray(g(jnp.asarray(a), jnp.asarray(b))),
                               want, atol=1e-5)
