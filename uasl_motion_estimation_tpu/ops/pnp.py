"""Closed-form minimal pose solvers for RANSAC hypothesis generation.

The reference generates each RANSAC hypothesis by running a full GN/LM
optimisation on the 3-point minimal sample
(src/vo/StereoVisualOdometry.cpp:59-71: ``optimize(selection)``) — ~12
iterations of 6x6 solves per hypothesis, the most expensive part of the
pose stage once everything is vmapped. These solvers
replace the iterative seed with closed forms that vectorize to pure
elementwise math (triad alignment) or a quartic companion eigensolve
(Grunert P3P, BASELINE config 1), after which one or two GN polish
iterations reach reprojection-optimal accuracy.

All functions are batched over leading axes and jit/vmap friendly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _normalize(v: jax.Array, eps: float = 1e-12) -> jax.Array:
    return v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), eps)


def _triad_basis(p: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Orthonormal frame from a point triple (..., 3, 3) [rows = points].

    Returns (basis (..., 3, 3) with the frame vectors as COLUMNS, ok flag).
    """
    v1 = p[..., 1, :] - p[..., 0, :]
    v2 = p[..., 2, :] - p[..., 0, :]
    e1 = _normalize(v1)
    a = v2 - jnp.sum(v2 * e1, axis=-1, keepdims=True) * e1
    e2 = _normalize(a)
    e3 = jnp.cross(e1, e2)
    ok = (jnp.linalg.norm(v1, axis=-1) > 1e-9) & (
        jnp.linalg.norm(a, axis=-1) > 1e-9
    )
    return jnp.stack([e1, e2, e3], axis=-1), ok


def rigid_align_3pt(p: jax.Array, q: jax.Array
                    ) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Closed-form rigid transform q ~= R @ p + t from exactly 3 point pairs.

    Triad (TRIAD attitude determination) construction: build an orthonormal
    frame from each triangle and compose; exact for congruent triangles, a
    robust hypothesis seed under noise. No SVD, no iteration — batches to
    pure vector math, the batched replacement for the reference's
    per-sample GN (StereoVisualOdometry.cpp:59-71).

    Args:
      p, q: (..., 3, 3) point triples (rows are points).

    Returns (R (..., 3, 3), t (..., 3), ok (...,) bool — False for degenerate
    (collinear/coincident) triples, whose R/t are unusable).
    """
    Bp, ok_p = _triad_basis(p)
    Bq, ok_q = _triad_basis(q)
    # full f32 products: a reduced-precision matmul (bf16 passes) costs ~3e-3 of
    # rotation accuracy, which the downstream GN polish would have to repair
    R = jnp.einsum("...ik,...jk->...ij", Bq, Bp, precision="highest")
    pc = jnp.mean(p, axis=-2)
    qc = jnp.mean(q, axis=-2)
    t = qc - jnp.einsum("...ij,...j->...i", R, pc, precision="highest")
    return R, t, ok_p & ok_q


def rigid_align_umeyama(p: jax.Array, q: jax.Array, weights: jax.Array | None
                        = None) -> tuple[jax.Array, jax.Array]:
    """Least-squares rigid transform q ~= R @ p + t for N weighted pairs.

    SVD (Kabsch/Umeyama) solution — used for >3-point alignment (trajectory
    stitching, scale-free ATE alignment); for minimal 3-point hypotheses use
    ``rigid_align_3pt`` (cheaper, no SVD).
    """
    if weights is None:
        weights = jnp.ones(p.shape[:-1], p.dtype)
    w = weights[..., None] / jnp.maximum(
        jnp.sum(weights, axis=-1, keepdims=True)[..., None], 1e-12
    )
    pc = jnp.sum(p * w, axis=-2)
    qc = jnp.sum(q * w, axis=-2)
    H = jnp.einsum("...ni,...nj->...ij", (q - qc[..., None, :]) * w,
                   p - pc[..., None, :])
    U, _, Vt = jnp.linalg.svd(H)
    d = jnp.sign(jnp.linalg.det(
        jnp.einsum("...ij,...jk->...ik", U, Vt, precision="highest")
    ))
    scale = jnp.stack([jnp.ones_like(d), jnp.ones_like(d), d], axis=-1)
    R = jnp.einsum("...ij,...j,...jk->...ik", U, scale, Vt,
                   precision="highest")
    t = qc - jnp.einsum("...ij,...j->...i", R, pc, precision="highest")
    return R, t


# ---------------------------------------------------------------------------
# Grunert P3P (3D points + bearing rays -> camera pose), BASELINE config 1
# ---------------------------------------------------------------------------


def _cubic_largest_real_root(B, C, D):
    """Largest real root of t^3 + B t^2 + C t + D, branch-free (jnp.where
    over the discriminant cases; no eig — XLA has no batched
    non-symmetric `eig` on accelerators)."""
    P = C - B * B / 3.0
    Q = 2.0 * B**3 / 27.0 - B * C / 3.0 + D
    disc = (Q / 2.0) ** 2 + (P / 3.0) ** 3

    # disc >= 0: one real root via Cardano
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    s_card = jnp.cbrt(-Q / 2.0 + sq) + jnp.cbrt(-Q / 2.0 - sq)

    # disc < 0: three real roots; k=0 of the trigonometric form is largest
    Pn = jnp.minimum(P, -1e-30)  # P < 0 whenever disc < 0
    m = 2.0 * jnp.sqrt(-Pn / 3.0)
    arg = jnp.clip(3.0 * Q / (Pn * m), -1.0, 1.0)
    s_trig = m * jnp.cos(jnp.arccos(arg) / 3.0)

    return jnp.where(disc >= 0, s_card, s_trig) - B / 3.0


def _solve_quartic(c4, c3, c2, c1, c0):
    """Real roots of c4 x^4 + ... + c0 x^0 (batched, branch-free).

    Ferrari factorization into two quadratics via the resolvent cubic,
    plus two Newton polish steps on the original quartic (f32 quartic
    coefficients are delicate). Complex roots are returned with the
    magnitude of their imaginary part so callers can mask them.
    """
    c4s = jnp.where(jnp.abs(c4) < 1e-12, 1e-12, c4)
    a = c3 / c4s
    b = c2 / c4s
    c = c1 / c4s
    d = c0 / c4s

    # depressed quartic y^4 + p y^2 + q y + r, x = y - a/4
    p = b - 3.0 * a * a / 8.0
    q = c - a * b / 2.0 + a**3 / 8.0
    r = d - a * c / 4.0 + a * a * b / 16.0 - 3.0 * a**4 / 256.0

    # resolvent cubic in u = alpha^2: u^3 + 2p u^2 + (p^2 - 4r) u - q^2 = 0
    u = _cubic_largest_real_root(2.0 * p, p * p - 4.0 * r, -q * q)
    u = jnp.maximum(u, 1e-12)
    alpha = jnp.sqrt(u)
    beta = (p + u - q / alpha) / 2.0
    gamma = (p + u + q / alpha) / 2.0

    # y^2 + alpha y + beta = 0  and  y^2 - alpha y + gamma = 0
    d1 = alpha * alpha - 4.0 * beta
    d2 = alpha * alpha - 4.0 * gamma
    sq1 = jnp.sqrt(jnp.maximum(d1, 0.0))
    sq2 = jnp.sqrt(jnp.maximum(d2, 0.0))
    roots_y = jnp.stack(
        [(-alpha + sq1) / 2.0, (-alpha - sq1) / 2.0,
         (alpha + sq2) / 2.0, (alpha - sq2) / 2.0],
        axis=-1,
    )
    imag = jnp.stack(
        [jnp.sqrt(jnp.maximum(-d1, 0.0)) / 2.0] * 2
        + [jnp.sqrt(jnp.maximum(-d2, 0.0)) / 2.0] * 2,
        axis=-1,
    )
    x = roots_y - (a / 4.0)[..., None]

    def quartic(xv):
        return (((c4[..., None] * xv + c3[..., None]) * xv + c2[..., None])
                * xv + c1[..., None]) * xv + c0[..., None]

    def dquartic(xv):
        return ((4.0 * c4[..., None] * xv + 3.0 * c3[..., None]) * xv
                + 2.0 * c2[..., None]) * xv + c1[..., None]

    for _ in range(2):  # Newton polish of the real roots
        f = quartic(x)
        df = dquartic(x)
        step = f / jnp.where(jnp.abs(df) < 1e-12, 1e-12, df)
        x = jnp.where(imag == 0.0, x - step, x)
    return x, imag


def p3p_grunert(pts_world: jax.Array, rays: jax.Array
                ) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Grunert's closed-form P3P: camera pose from 3 world points + 3 unit
    bearing rays (camera frame).

    Solves the law-of-cosines system for the three camera-frame depths
    (classic Grunert 1841 reduction to a quartic in v = s2/s1), then recovers
    (R, t) with ``rigid_align_3pt``. Returns up to 4 candidate poses.

    Args:
      pts_world: (3, 3) world/previous-frame points (rows).
      rays: (3, 3) unit bearing vectors in the camera frame (rows).

    Returns (R (4, 3, 3), t (4, 3), ok (4,) bool) — candidate poses mapping
    world points into the camera frame, invalid slots masked False.
    """
    dtype = pts_world.dtype
    p1, p2, p3 = pts_world[0], pts_world[1], pts_world[2]
    # squared side lengths
    a2 = jnp.sum((p2 - p3) ** 2)  # opposite vertex 1
    b2 = jnp.sum((p1 - p3) ** 2)  # opposite vertex 2
    c2 = jnp.sum((p1 - p2) ** 2)  # opposite vertex 3

    ca = jnp.dot(rays[1], rays[2])  # alpha: angle opposite side a
    cb = jnp.dot(rays[0], rays[2])  # beta
    cg = jnp.dot(rays[0], rays[1])  # gamma

    b2s = jnp.maximum(b2, 1e-12)
    D = (a2 - c2) / b2s
    E = c2 / b2s
    # Quartic in v = s3/s1 from eliminating u = s2/s1 between the law-of-
    # cosines pairs (coefficients machine-derived with sympy from Grunert's
    # system — see the elimination in the docstring).
    A4 = D**2 - 2.0 * D - 4.0 * E * ca**2 + 1.0
    A3 = 4.0 * (
        -(D**2) * cb + D * ca * cg + D * cb
        + 2.0 * E * ca**2 * cb + 2.0 * E * ca * cg - ca * cg
    )
    A2 = 2.0 * (
        2.0 * D**2 * cb**2 + D**2 - 4.0 * D * ca * cb * cg - 2.0 * D * cg**2
        - 2.0 * E * ca**2 - 8.0 * E * ca * cb * cg - 2.0 * E * cg**2
        + 2.0 * ca**2 + 2.0 * cg**2 - 1.0
    )
    A1 = 4.0 * (
        -(D**2) * cb + D * ca * cg + 2.0 * D * cb * cg**2 - D * cb
        + 2.0 * E * ca * cg + 2.0 * E * cb * cg**2 - ca * cg
    )
    A0 = D**2 - 4.0 * D * cg**2 + 2.0 * D - 4.0 * E * cg**2 + 1.0

    v, v_imag = _solve_quartic(A4, A3, A2, A1, A0)  # (4,)
    real_ok = v_imag < 1e-4 * (1.0 + jnp.abs(v))

    # back-substitute: u = ((D-1) v^2 - 2 D cb v + (D+1)) / (2 (cg - v ca))
    num_u = (D - 1.0) * v**2 - 2.0 * D * cb * v + (D + 1.0)
    den_u = 2.0 * (cg - v * ca)
    u = num_u / jnp.where(jnp.abs(den_u) < 1e-12, 1e-12, den_u)

    s1_sq = c2 / jnp.maximum(1.0 + u**2 - 2.0 * u * cg, 1e-12)
    pos_ok = s1_sq > 0
    s1 = jnp.sqrt(jnp.maximum(s1_sq, 1e-12))
    s2 = u * s1
    s3 = v * s1
    ok = real_ok & pos_ok & (s2 > 0) & (s3 > 0)

    # Newton polish of the depth triple on the original law-of-cosines
    # system: the quartic's f32 root error (~1e-3 relative) otherwise leaks
    # ~depth*1e-3 into the pose translation.
    def polish(_, s):
        s1_, s2_, s3_ = s[..., 0], s[..., 1], s[..., 2]
        f = jnp.stack(
            [
                s2_**2 + s3_**2 - 2.0 * s2_ * s3_ * ca - a2,
                s1_**2 + s3_**2 - 2.0 * s1_ * s3_ * cb - b2,
                s1_**2 + s2_**2 - 2.0 * s1_ * s2_ * cg - c2,
            ],
            axis=-1,
        )
        z = jnp.zeros_like(s1_)
        J = jnp.stack(
            [
                jnp.stack([z, 2.0 * (s2_ - s3_ * ca), 2.0 * (s3_ - s2_ * ca)], -1),
                jnp.stack([2.0 * (s1_ - s3_ * cb), z, 2.0 * (s3_ - s1_ * cb)], -1),
                jnp.stack([2.0 * (s1_ - s2_ * cg), 2.0 * (s2_ - s1_ * cg), z], -1),
            ],
            axis=-2,
        )
        ds = jnp.linalg.solve(
            J + 1e-9 * jnp.eye(3, dtype=s.dtype), f[..., None]
        )[..., 0]
        return jnp.where(jnp.isfinite(ds), s - ds, s)

    depths0 = jnp.stack([s1, s2, s3], axis=-1)  # (4, 3)
    depths = jax.lax.fori_loop(0, 3, polish, depths0)
    depths = jnp.where(jnp.all(depths > 0, axis=-1, keepdims=True),
                       depths, depths0)

    # camera-frame points for each candidate, then rigid alignment
    cam_pts = depths[..., None] * rays[None, :, :]  # (4, 3, 3)
    world = jnp.broadcast_to(pts_world, (4, 3, 3)).astype(dtype)
    R, t, align_ok = rigid_align_3pt(world, cam_pts)
    return R, t, ok & align_ok
