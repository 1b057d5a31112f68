"""ops/image.extract_tiles (the XLA patch gather behind every KLT level and
ZNCC strip) against a plain numpy reference: each tile pixel is the image
pixel at the edge-clamped coordinate."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from uasl_motion_estimation_tpu.ops import image as im

RNG = np.random.default_rng(7)


def tiles_reference(img, anchors, size_h, size_w):
    """(N, size_h, size_w) float64 tiles, top-left corners anchors [x, y]."""
    h, w = img.shape
    out = np.empty((len(anchors), size_h, size_w))
    for n, (x, y) in enumerate(np.asarray(anchors)):
        rows = np.clip(y + np.arange(size_h), 0, h - 1)
        cols = np.clip(x + np.arange(size_w), 0, w - 1)
        out[n] = img[np.ix_(rows, cols)]
    return out


def random_anchors(n, h, w, reach):
    """Anchors that start up to ``reach`` px outside every image edge."""
    return np.stack([RNG.integers(-reach, w + reach, n),
                     RNG.integers(-reach, h + reach, n)], -1).astype(np.int32)


@pytest.mark.parametrize("shape, size_h, size_w", [
    ((120, 200), 22, 22),  # KLT tile (11-px window + 2x5 margin + 1)
    ((120, 200), 11, 138),  # ZNCC strip (11-px window x 128 disparities)
    ((47, 156), 22, 22),  # coarsest KLT level of a 376x1241 frame
])
def test_parity_with_numpy(shape, size_h, size_w):
    img = RNG.uniform(0, 255, shape).astype(np.float32)
    anchors = random_anchors(64, *shape, reach=max(size_h, size_w))
    got = im.extract_tiles(jnp.asarray(img), jnp.asarray(anchors),
                           size_h, size_w)
    assert got.shape == (64, size_h, size_w)
    np.testing.assert_array_equal(
        np.asarray(got), tiles_reference(img, anchors, size_h, size_w))


def test_edge_clamping():
    """Anchors partly or wholly outside the image read edge-replicated
    pixels, however far out they start."""
    img = np.arange(48, dtype=np.float32).reshape(6, 8)
    anchors = np.array([[-3, -3], [6, 4], [100, 100], [-100, 2], [2, -50]],
                       np.int32)
    got = np.asarray(im.extract_tiles(jnp.asarray(img), jnp.asarray(anchors),
                                      4, 5))
    np.testing.assert_array_equal(got, tiles_reference(img, anchors, 4, 5))
    np.testing.assert_array_equal(got[2], np.full((4, 5), img[-1, -1]))
    np.testing.assert_array_equal(got[0, :3, :3], np.zeros((3, 3)))


def test_square_by_default():
    img = RNG.uniform(0, 255, (30, 40)).astype(np.float32)
    anchors = random_anchors(5, 30, 40, reach=3)
    got = im.extract_tiles(jnp.asarray(img), jnp.asarray(anchors), 7)
    np.testing.assert_array_equal(np.asarray(got),
                                  tiles_reference(img, anchors, 7, 7))


def test_batched_leading_dims():
    """vmap over a leading image axis (the sequence engines' frame batch)."""
    imgs = RNG.uniform(0, 255, (3, 64, 96)).astype(np.float32)
    anchors = np.stack([random_anchors(9, 64, 96, reach=8) for _ in range(3)])
    got = jax.vmap(lambda i, a: im.extract_tiles(i, a, 8, 12))(
        jnp.asarray(imgs), jnp.asarray(anchors))
    want = np.stack([tiles_reference(i, a, 8, 12)
                     for i, a in zip(imgs, anchors)])
    np.testing.assert_array_equal(np.asarray(got), want)
