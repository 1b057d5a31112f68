"""Batched small-matrix decompositions in pure jnp (no XLA custom calls).

XLA lowers ``jnp.linalg.eigh``/``svd``/``det`` to LAPACK-style custom calls
built for one large matrix, not for thousands of tiny ones. The mono VO
solver's RANSAC alone evaluates hundreds of them per frame.

This module provides the same decompositions as fixed-iteration, branch-free
jnp programs that vectorize over arbitrary batch dims:

* ``eigh_jacobi`` — cyclic Jacobi for symmetric n x n (n static, <= ~16):
  unrolled sweeps of (p, q) Givens rotations applied as batched rank-2 row/
  column updates. Quadratic convergence: 6-8 sweeps reach f32 precision.
* ``svd3_rotation`` — 3x3 SVD via eigh of A^T A + orthonormalization of the
  image basis (sufficient for essential-matrix projection/decomposition,
  where only the rotation factors and the rank structure matter).

Used by models/mono_vo.py and ops/fivepoint.py; parity-tested against the
jnp custom-call versions (tests/test_smallalg.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _round_robin_rounds(n: int) -> list[list[tuple[int, int]]]:
    """Tournament schedule: (n-1 or n) rounds of DISJOINT index pairs
    covering every (p, q) once (circle method; odd n gets a bye)."""
    m = n if n % 2 == 0 else n + 1
    players = list(range(m))
    rounds = []
    for _ in range(m - 1):
        pairs = []
        for i in range(m // 2):
            a, b = players[i], players[m - 1 - i]
            if a < n and b < n:
                pairs.append((min(a, b), max(a, b)))
        rounds.append(pairs)
        players = [players[0]] + [players[-1]] + players[1:-1]
    return rounds


def eigh_jacobi(M: jax.Array, sweeps: int = 6) -> tuple[jax.Array, jax.Array]:
    """Eigendecomposition of symmetric (..., n, n), ascending eigenvalues.

    Returns (w (..., n), V (..., n, n)) with M ~= V @ diag(w) @ V^T.
    Parallel-ordered cyclic Jacobi: each step applies a whole ROUND of
    disjoint Givens rotations as one batched n x n similarity transform
    (n/2 rotations per sequential step instead of one — the sequential
    depth, not FLOPs, dominates at these sizes). ``n`` static.
    """
    n = M.shape[-1]
    batch = M.shape[:-2]
    eye = jnp.eye(n, dtype=M.dtype)
    V = jnp.broadcast_to(eye, batch + (n, n))
    A = 0.5 * (M + jnp.swapaxes(M, -1, -2))
    rounds = _round_robin_rounds(n)

    for _ in range(sweeps):
        for pairs in rounds:
            # build one orthogonal G embedding every (p, q) rotation of
            # this round (pairs are disjoint)
            G = jnp.broadcast_to(eye, batch + (n, n))
            for p, q in pairs:
                apq = A[..., p, q]
                app = A[..., p, p]
                aqq = A[..., q, q]
                tau = (aqq - app) / (2.0 * jnp.where(
                    jnp.abs(apq) < 1e-30, 1e-30, apq))
                # NOT jnp.sign(tau): sign(0) == 0 would silently skip the
                # 45-degree rotation required when the two diagonal entries
                # are exactly equal (e.g. E^T E of an axis-aligned pure
                # translation) and the matrix never diagonalizes — found by
                # review, reproduced on skew((1,1,0)/sqrt(2))
                sgn = jnp.where(tau >= 0.0, 1.0, -1.0)
                t = sgn / (jnp.abs(tau) + jnp.sqrt(1.0 + tau * tau))
                t = jnp.where(jnp.abs(apq) < 1e-30, 0.0, t)
                c = 1.0 / jnp.sqrt(1.0 + t * t)
                s = t * c
                G = G.at[..., p, p].set(c)
                G = G.at[..., q, q].set(c)
                G = G.at[..., p, q].set(s)
                G = G.at[..., q, p].set(-s)
            A = jnp.einsum("...ji,...jk,...kl->...il", G, A, G,
                            precision="highest")
            V = jnp.einsum("...ij,...jk->...ik", V, G,
                            precision="highest")

    w = jnp.diagonal(A, axis1=-2, axis2=-1)
    order = jnp.argsort(w, axis=-1)
    w = jnp.take_along_axis(w, order, axis=-1)
    V = jnp.take_along_axis(V, order[..., None, :], axis=-1)
    return w, V


def svd3_rotation(E: jax.Array, sweeps: int = 7
                  ) -> tuple[jax.Array, jax.Array, jax.Array]:
    """SVD of (..., 3, 3): returns (U, s, Vt) with E = U diag(s) Vt.

    V from Jacobi eigh of E^T E; singular values from its eigenvalues;
    U = E V / s with the (near-)null column completed by the cross product
    of the other two — exact for the rank-2 essential-projection use and
    orthonormal for any input. Columns ordered by DESCENDING s (LAPACK
    convention).
    """
    EtE = jnp.einsum("...ji,...jk->...ik", E, E, precision="highest")
    w, V = eigh_jacobi(EtE, sweeps)
    # descending order
    w = w[..., ::-1]
    V = V[..., ::-1]
    s = jnp.sqrt(jnp.maximum(w, 0.0))
    U01 = jnp.einsum("...ij,...jk->...ik", E, V[..., :2],
                       precision="highest")
    U01 = U01 / jnp.maximum(s[..., None, :2], 1e-20)
    # re-orthonormalize the two leading columns (s2 may be tiny)
    u0 = U01[..., 0]
    u0 = u0 / jnp.maximum(
        jnp.linalg.norm(u0, axis=-1, keepdims=True), 1e-20)
    u1 = U01[..., 1]
    u1 = u1 - jnp.sum(u0 * u1, axis=-1, keepdims=True) * u0
    u1 = u1 / jnp.maximum(
        jnp.linalg.norm(u1, axis=-1, keepdims=True), 1e-20)
    # last column: E v2 / s2 when s2 carries signal (its SIGN matters for
    # full-rank inputs), cross-product completion when E is (near-)rank-2
    u2_raw = jnp.einsum("...ij,...j->...i", E, V[..., 2],
                          precision="highest")
    nrm2 = jnp.linalg.norm(u2_raw, axis=-1, keepdims=True)
    scale = jnp.max(s, axis=-1, keepdims=True)
    u2 = jnp.where(
        nrm2 > 1e-5 * jnp.maximum(scale, 1e-20),
        u2_raw / jnp.maximum(nrm2, 1e-30),
        jnp.cross(u0, u1),
    )
    # orthogonalize against the leading columns (f32 hygiene)
    u2 = u2 - jnp.sum(u0 * u2, axis=-1, keepdims=True) * u0
    u2 = u2 - jnp.sum(u1 * u2, axis=-1, keepdims=True) * u1
    u2 = u2 / jnp.maximum(jnp.linalg.norm(u2, axis=-1, keepdims=True),
                          1e-20)
    U = jnp.stack([u0, u1, u2], axis=-1)
    return U, s, jnp.swapaxes(V, -1, -2)
