"""Closed-form small-matrix linear algebra (3x3 solve / symmetric eigen).

Why this exists: the reference leans on OpenCV's ``cv::solve(DECOMP_QR)`` and
``cv::eigen`` for 3x3/6x6 systems (``src/featureAssociation.cpp:1324-1356``,
``src/mapOptmization.cpp:1126,1189,1273-1305``).  The naive JAX translation —
``jnp.linalg.solve`` / ``jnp.linalg.eigh`` — lowers to pivoted LU and iterative
eigensolvers, scalar-heavy control-flow codes that run orders of magnitude
slower on an accelerator than closed forms, especially inside
``lax.while_loop`` solver iterations and for batched (N, 3, 3) fits.

Everything here is pure VPU elementwise math, batched over leading dims:
  * ``solve3``: Cramer/adjugate 3x3 solve.
  * ``eigh3x3``: analytic symmetric 3x3 eigendecomposition via the
    trigonometric (Cardano) eigenvalue formula + cross-product eigenvectors
    with a robust fallback for (near-)repeated eigenvalues.

Accuracy: ~1e-6 relative for well-conditioned inputs (verified against
``jnp.linalg`` in tests); degeneracy thresholds in the LM solvers (10 / 100)
are far above the error floor.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def det3(A: jax.Array) -> jax.Array:
    """Determinant of (..., 3, 3)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def adjugate3(A: jax.Array) -> jax.Array:
    """Adjugate (transposed cofactor matrix) of (..., 3, 3)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    row0 = jnp.stack([e * i - f * h, c * h - b * i, b * f - c * e], axis=-1)
    row1 = jnp.stack([f * g - d * i, a * i - c * g, c * d - a * f], axis=-1)
    row2 = jnp.stack([d * h - e * g, b * g - a * h, a * e - b * d], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def solve3(A: jax.Array, b: jax.Array, eps: float = 1e-20) -> jax.Array:
    """x = A⁻¹ b for (..., 3, 3) @ (..., 3), Cramer via adjugate.

    Singular systems return 0 (callers guard with their own gates)."""
    det = det3(A)
    x = jnp.einsum("...ij,...j->...i", adjugate3(A), b)
    safe = jnp.abs(det) > eps
    return jnp.where(safe[..., None], x / jnp.where(safe, det, 1.0)[..., None],
                     0.0)


def inv3(A: jax.Array, eps: float = 1e-20) -> jax.Array:
    det = det3(A)
    safe = jnp.abs(det) > eps
    return jnp.where(safe[..., None, None],
                     adjugate3(A) / jnp.where(safe, det, 1.0)[..., None, None],
                     jnp.zeros_like(A))


def eigvalsh3(A: jax.Array) -> jax.Array:
    """Eigenvalues of symmetric (..., 3, 3), ASCENDING — the trigonometric
    (Cardano) closed form (Smith 1961)."""
    q = (A[..., 0, 0] + A[..., 1, 1] + A[..., 2, 2]) / 3.0
    a00 = A[..., 0, 0] - q
    a11 = A[..., 1, 1] - q
    a22 = A[..., 2, 2] - q
    a01, a02, a12 = A[..., 0, 1], A[..., 0, 2], A[..., 1, 2]
    p2 = (a00 * a00 + a11 * a11 + a22 * a22
          + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12)) / 6.0
    p = jnp.sqrt(jnp.maximum(p2, 1e-30))
    # det of (A - qI) / p
    B00, B11, B22 = a00 / p, a11 / p, a22 / p
    B01, B02, B12 = a01 / p, a02 / p, a12 / p
    detB = (B00 * (B11 * B22 - B12 * B12)
            - B01 * (B01 * B22 - B12 * B02)
            + B02 * (B01 * B12 - B11 * B02))
    r = jnp.clip(detB / 2.0, -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    e1 = q + 2.0 * p * jnp.cos(phi)                      # largest
    e3 = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)  # smallest
    e2 = 3.0 * q - e1 - e3
    zerop = p2 < 1e-28  # scalar matrix: all eigenvalues = q
    e1 = jnp.where(zerop, q, e1)
    e2 = jnp.where(zerop, q, e2)
    e3 = jnp.where(zerop, q, e3)
    return jnp.stack([e3, e2, e1], axis=-1)


def _eigvec(A: jax.Array, lam: jax.Array, fallback: jax.Array) -> jax.Array:
    """Eigenvector of symmetric A for eigenvalue lam: the largest cross
    product of two rows of (A - lam I); falls back to ``fallback`` when the
    eigenvalue is (near-)repeated and the cross products vanish."""
    M = A - lam[..., None, None] * jnp.eye(3, dtype=A.dtype)
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    c01 = jnp.cross(r0, r1)
    c02 = jnp.cross(r0, r2)
    c12 = jnp.cross(r1, r2)
    n01 = jnp.sum(c01 * c01, axis=-1)
    n02 = jnp.sum(c02 * c02, axis=-1)
    n12 = jnp.sum(c12 * c12, axis=-1)
    best = jnp.where(
        (n01 >= n02)[..., None] & (n01 >= n12)[..., None], c01,
        jnp.where((n02 >= n12)[..., None], c02, c12))
    norm = jnp.linalg.norm(best, axis=-1, keepdims=True)
    ok = norm[..., 0] > 1e-12
    v = jnp.where(ok[..., None], best / jnp.maximum(norm, 1e-30), fallback)
    return v


def eigh3x3(A: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Symmetric (..., 3, 3) eigendecomposition, ascending eigenvalues.

    Returns (evals (..., 3), evecs (..., 3, 3)) with eigenvectors as COLUMNS
    (same convention as ``jnp.linalg.eigh``)."""
    evals = eigvalsh3(A)
    ex = jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0], A.dtype), A.shape[:-1])
    # Largest first (best separated in the typical PCA/degeneracy inputs).
    v2 = _eigvec(A, evals[..., 2], ex)
    v0 = _eigvec(A, evals[..., 0], _perp(v2))
    # Orthogonalize v0 against v2 then complete the basis by cross product —
    # exact orthonormality matters more than per-vector accuracy.
    v0 = v0 - jnp.sum(v0 * v2, axis=-1, keepdims=True) * v2
    n0 = jnp.linalg.norm(v0, axis=-1, keepdims=True)
    v0 = jnp.where(n0 > 1e-12, v0 / jnp.maximum(n0, 1e-30), _perp(v2))
    v1 = jnp.cross(v2, v0)
    return evals, jnp.stack([v0, v1, v2], axis=-1)


def solve6_spd(A: jax.Array, b: jax.Array, eps: float = 1e-8) -> jax.Array:
    """x = A⁻¹ b for symmetric positive (semi)definite (..., 6, 6) via the
    2x2-block Schur complement over closed-form 3x3 inverses — no pivoted LU.

    A = [[P, Q], [Qᵀ, S]]:  x2 = (S - QᵀP⁻¹Q)⁻¹ (b2 - QᵀP⁻¹ b1),
                            x1 = P⁻¹ (b1 - Q x2).
    A small Tikhonov floor keeps near-singular blocks finite (callers apply
    their own degeneracy projection on top)."""
    reg = eps * jnp.eye(3, dtype=A.dtype)
    P = A[..., :3, :3] + reg
    Q = A[..., :3, 3:]
    S = A[..., 3:, 3:] + reg
    b1, b2 = b[..., :3], b[..., 3:]
    Pinv = inv3(P)
    PinvQ = Pinv @ Q
    schur = S - jnp.swapaxes(Q, -1, -2) @ PinvQ
    rhs2 = b2 - jnp.einsum("...ji,...j->...i",
                           PinvQ, b1)
    x2 = solve3(schur + reg, rhs2)
    x1 = jnp.einsum("...ij,...j->...i", Pinv, b1) \
        - jnp.einsum("...ij,...j->...i", PinvQ, x2)
    return jnp.concatenate([x1, x2], axis=-1)


def _perp(v: jax.Array) -> jax.Array:
    """Any unit vector perpendicular to unit v."""
    # Pick the axis least aligned with v.
    ax = jnp.argmin(jnp.abs(v), axis=-1)
    e = jax.nn.one_hot(ax, 3, dtype=v.dtype)
    p = jnp.cross(v, e)
    n = jnp.linalg.norm(p, axis=-1, keepdims=True)
    return p / jnp.maximum(n, 1e-30)
