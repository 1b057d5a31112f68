"""Exact 5-point minimal essential-matrix solver, as fixed-shape numerics.

The reference's mono path is Nister's 5-point inside
``cv::findEssentialMat`` (reference: src/vo/MonoVisualOdometry.cpp:20).
Classical implementations finish with a non-symmetric eigendecomposition
(Stewenius action matrix) or explicit 10th-degree polynomial root finding —
neither has a fixed-shape batched form. This module reformulates both steps as fixed-shape
numerics:

1. **Nullspace**: the 5x9 epipolar system's 4-dim nullspace via SVD ->
   E(x,y,z) = x E1 + y E2 + z E3 + E4.
2. **Constraint matrix, numerically**: the 10 cubic constraints
   (det E = 0 and 2 E E^T E - tr(E E^T) E = 0) restricted to a FIXED z are
   polynomials in (x, y) over the 10 monomials of degree <= 3. Their
   coefficients are recovered by evaluating the constraints at 10 fixed
   (x, y) sample points and applying a precomputed inverse Vandermonde —
   no symbolic expansion of the 10x20 Nister matrix at all.
3. **Root finding**: a nontrivial (x, y) solution exists iff
   g(z) = det M(z) = 0 — a degree-10 polynomial evaluated IMPLICITLY as a
   batched 10x10 determinant. Real roots come from sign-change bracketing
   on a tan-substituted grid plus fixed-iteration bisection: branch-free,
   batched, no eigensolver. (Even-multiplicity roots produce no sign change
   and are skipped — measure-zero configurations that RANSAC absorbs.)
4. **Back-substitution**: (x, y) from the nullspace of M(z*) (Jacobi eigh
   of M^T M, ops/smallalg.py), read off the linear/constant monomials, and
   a final exact projection onto the essential manifold.

Everything vmaps over RANSAC samples. The degree-10 determinant runs as
unrolled batched Gaussian elimination (det_unrolled) instead of XLA's
LU custom call.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from . import smallalg as sal

# xy-monomial basis of degree <= 3, the column order of M(z):
#   x^3, x^2 y, x y^2, y^3, x^2, x y, y^2, x, y, 1
_MONOS = [(3, 0), (2, 1), (1, 2), (0, 3), (2, 0), (1, 1), (0, 2),
          (1, 0), (0, 1), (0, 0)]
_IDX_X = _MONOS.index((1, 0))
_IDX_Y = _MONOS.index((0, 1))
_IDX_1 = _MONOS.index((0, 0))


def _make_xy_nodes() -> tuple[np.ndarray, np.ndarray]:
    """10 fixed (x, y) evaluation nodes + the inverse Vandermonde over
    _MONOS (float64 at build time; cond ~ 38, fine for f32 use).

    Nodes are the degree-3 principal lattice {(i, j): i + j <= 3} centered
    and scaled — the classic unisolvent set for bivariate interpolation of
    total degree 3 (concentric-circle layouts are near-singular: all 10
    points close to a single cubic curve)."""
    s = 0.8
    pts = np.asarray(
        [(s * (i - 1.0), s * (j - 1.0)) for i in range(4) for j in range(4 - i)]
    )
    V = np.stack(
        [[x**a * y**b for (a, b) in _MONOS] for x, y in pts]
    )  # (10 nodes, 10 monomials)
    return pts, np.linalg.inv(V)


_XY_NODES, _XY_VINV = _make_xy_nodes()


def _constraints(E: jax.Array) -> jax.Array:
    """The 10 essential-manifold cubics at a numeric E: [det E;
    vec(2 E E^T E - tr(E E^T) E)]. (10,)"""
    EEt = E @ E.T
    c = 2.0 * EEt @ E - jnp.trace(EEt) * E
    return jnp.concatenate([jnp.linalg.det(E)[None], c.reshape(9)])


def _M_of_z(basis: jax.Array, z: jax.Array) -> jax.Array:
    """(10, 10) xy-coefficient matrix of the constraint system at numeric z.

    basis: (4, 3, 3) nullspace matrices [E1, E2, E3, E4].
    Rows = constraints, columns = _MONOS monomials.
    """
    nodes = jnp.asarray(_XY_NODES, basis.dtype)  # (10, 2)
    vinv = jnp.asarray(_XY_VINV, basis.dtype)  # (10, 10)

    def at_node(xy):
        E = (xy[0] * basis[0] + xy[1] * basis[1] + z * basis[2] + basis[3])
        return _constraints(E)

    vals = jax.vmap(at_node)(nodes)  # (node, constraint)
    return (vinv @ vals).T  # (constraint, monomial)


def det_unrolled(M: jax.Array) -> jax.Array:
    """Batched small-matrix determinant via UNROLLED partially-pivoted
    Gaussian elimination in pure jnp ops.

    ``jnp.linalg.det`` lowers to XLA's LU custom call, one small
    factorization per matrix. Unrolling the n-1 elimination steps as
    batched elementwise ops + gathers runs the same algorithm (partial
    pivoting, identical stability) as wide vector work. (..., n, n)
    -> (...,); n is static and small.
    """
    n = M.shape[-1]
    batch = M.shape[:-2]
    rows = jnp.arange(n)
    det = jnp.ones(batch, M.dtype)
    for k in range(n - 1):
        absc = jnp.abs(M[..., :, k])
        p = jnp.argmax(jnp.where(rows >= k, absc, -1.0), axis=-1)  # (...,)
        pk = p[..., None]
        idx = jnp.broadcast_to(rows, batch + (n,))
        idx = jnp.where(rows == k, pk, jnp.where(idx == pk, k, idx))
        M = jnp.take_along_axis(M, idx[..., None], axis=-2)
        det = jnp.where(p != k, -det, det)
        piv = M[..., k, k]
        det = det * piv
        safe = jnp.where(jnp.abs(piv) < 1e-30, 1e-30, piv)
        factor = jnp.where(rows > k, M[..., :, k] / safe[..., None], 0.0)
        M = M - factor[..., None] * M[..., k : k + 1, :]
    return det * M[..., n - 1, n - 1]


def _det_sign_value(basis: jax.Array, z: jax.Array) -> jax.Array:
    """Sign-stable evaluation of det M(z): rows scaled by (1+|z|)^-3 (each
    constraint has z-degree <= 3) keeps f32 magnitudes bounded; positive row
    scaling preserves the sign, which is all bracketing needs."""
    M = _M_of_z(basis, z)
    return det_unrolled(M / (1.0 + jnp.abs(z)) ** 3)


# root search domain: |z| <= tan(PHI_MAX). Real-geometry roots are small;
# the tan grid still reaches +-140 to catch eccentric ones.
_PHI_MAX = 1.5637  # tan -> ~140
_N_GRID = 128
_MAX_ROOTS = 10
# Bisection depth is bounded by f32, not by appetite: the initial bracket
# is 2*PHI_MAX/(G-1) ~ 0.0246 rad and phi has ~6e-8 absolute resolution at
# |phi| <= 1.56, so after ~19 halvings the midpoint equals an endpoint and
# further iterations are no-ops (round 3 ran 42 — the extra 22 iterations
# were ~40% of the solver's determinant evaluations doing nothing).
_BISECT_ITERS = 22


def fivepoint_candidates(
    p1: jax.Array, p2: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """All essential matrices consistent with 5 normalized correspondences.

    Args:
      p1, p2: (5, 2) normalized camera coordinates (prev, cur).

    Returns:
      (Es (_MAX_ROOTS, 3, 3), valid (_MAX_ROOTS,) bool) — one candidate per
      found real root of the degree-10 polynomial, masked.
    """
    # Full-precision f32 dots: the implicit-determinant sign bracketing is
    # meaningless under reduced-precision (bf16-pass, TF32) matmuls (tiny 10x10
    # algebra; cost is nil).
    with jax.default_matmul_precision("highest"):
        return _fivepoint_impl(p1, p2)


def _fivepoint_impl(p1, p2):
    dtype = p1.dtype
    x1, y1 = p1[:, 0], p1[:, 1]
    x2, y2 = p2[:, 0], p2[:, 1]
    ones = jnp.ones_like(x1)
    A = jnp.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, ones], axis=-1
    )  # (5, 9)
    # 4-dim nullspace via the LAPACK-path svd. A Jacobi eigh of A^T A was
    # tried in the round-5 custom-call purge and REVERTED: squaring the
    # conditioning degraded the basis just enough to push root jitter into
    # candidate epipolar residuals ~7e-3 (the 5e-3 contract). The 5-point
    # is the hybrid fallback path, so its per-call svd cost is off the
    # common path; accuracy bounds every downstream root, so it wins.
    _, _, Vt = jnp.linalg.svd(A, full_matrices=True)
    basis = Vt[5:9].reshape(4, 3, 3)  # E1..E4 (orthonormal rows of V^T)

    # --- bracket real roots of det M(z) on the tan grid ---
    phi = jnp.linspace(-_PHI_MAX, _PHI_MAX, _N_GRID, dtype=dtype)
    g = jax.vmap(lambda ph: _det_sign_value(basis, jnp.tan(ph)))(phi)
    s = jnp.sign(g)
    # a bracket at i: strict sign change between grid points i, i+1
    change = (s[:-1] * s[1:] < 0.0)  # (G-1,)
    # first _MAX_ROOTS brackets (ordered by grid index)
    order = jnp.where(change, jnp.arange(_N_GRID - 1), _N_GRID)
    idx = jnp.sort(order)[:_MAX_ROOTS]  # (R,) bracket start index or G
    valid = idx < (_N_GRID - 1)
    idx_c = jnp.clip(idx, 0, _N_GRID - 2)

    lo = phi[idx_c]
    hi = phi[idx_c + 1]
    glo = g[idx_c]

    def bisect(_, carry):
        lo, hi, glo = carry
        mid = 0.5 * (lo + hi)
        gm = jax.vmap(lambda ph: _det_sign_value(basis, jnp.tan(ph)))(mid)
        left = (jnp.sign(gm) == jnp.sign(glo)) & (gm != 0.0)
        lo2 = jnp.where(left, mid, lo)
        hi2 = jnp.where(left, hi, mid)
        glo2 = jnp.where(left, gm, glo)
        return lo2, hi2, glo2

    lo, hi, _ = jax.lax.fori_loop(0, _BISECT_ITERS, bisect, (lo, hi, glo))
    z = jnp.tan(0.5 * (lo + hi))  # (R,)

    # --- recover (x, y) from the nullspace of M(z*) ---
    # (a batched least-squares recover was tried round 5 — 10x9 normal
    # equations instead of the 10x10 SVD — and reverted: it degraded exact-
    # scene recovery 30/30 -> 21/30 and emitted off-manifold candidates
    # that break the valid-candidate contract. The SVD stays; the solver's
    # big win was det_unrolled above.)
    def recover(zi):
        M = _M_of_z(basis, zi)
        M = M / (1.0 + jnp.abs(zi)) ** 3
        # right nullvector via Jacobi eigh of M^T M (no svd custom call;
        # 10 sweeps — the normal matrix squares the near-rank-9
        # conditioning exactly where the nullvector lives)
        _, VM = sal.eigh_jacobi(M.T @ M, sweeps=10)
        v = VM[:, 0]  # (10,) monomial weights
        scale = v[_IDX_1]
        ok = jnp.abs(scale) > 1e-5 * jnp.max(jnp.abs(v))
        safe = jnp.where(jnp.abs(scale) < 1e-20, 1e-20, scale)
        x = v[_IDX_X] / safe
        y = v[_IDX_Y] / safe
        E = x * basis[0] + y * basis[1] + zi * basis[2] + basis[3]
        nrm = jnp.linalg.norm(E)
        E = E / jnp.where(nrm < 1e-12, 1.0, nrm)
        # exact essential-manifold polish (Jacobi 3x3 SVD, ops/smallalg):
        # f32 root jitter leaves candidates ~1e-2 off-manifold; projecting
        # singular values to (1,1,0)/sqrt(2) restores det E = 0 and the
        # trace constraint by construction at negligible cost
        U, _, Vt = sal.svd3_rotation(E)
        E = (U @ jnp.diag(jnp.asarray([1.0, 1.0, 0.0], E.dtype)) @ Vt
             ) / jnp.sqrt(2.0).astype(E.dtype)
        return E, ok & jnp.all(jnp.isfinite(E))

    Es, oks = jax.vmap(recover)(z)
    return Es, valid & oks
