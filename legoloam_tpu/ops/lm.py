"""Batched Gauss-Newton/LM building blocks shared by odometry and mapping.

Replaces the reference's OpenCV dense linear algebra (``cv::solve(DECOMP_QR)``,
``cv::eigen``) used in ``calculateTransformationSurf/Corner``
(``src/featureAssociation.cpp:1270-1478``) and ``LMOptimization``
(``src/mapOptmization.cpp:1229-1327``).

Everything here is batched: residual rows are assembled as dense masked arrays
(invalid rows zeroed), the normal equations are one (N, D)ᵀ(N, D) matmul, and
the solve + degeneracy analysis run on tiny DxD systems.

Degeneracy handling mirrors the reference exactly: on the first iteration,
eigen-decompose JᵀJ; zero out eigendirections with eigenvalue below the
threshold (10 for odometry, 100 for mapping) and project every subsequent step
through P = V⁻¹·V_clamped (featureAssociation.cpp:1329-1356,
mapOptmization.cpp:1280-1306).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from . import smallalg


class DegeneracyState(NamedTuple):
    P: jax.Array           # (D, D) step projection matrix
    is_degenerate: jax.Array  # () bool


def identity_degeneracy(d: int) -> DegeneracyState:
    return DegeneracyState(P=jnp.eye(d), is_degenerate=jnp.array(False))


def analyze_degeneracy(AtA: jax.Array, eig_thresh: float) -> DegeneracyState:
    """Reference degeneracy analysis: eigen-decompose the normal matrix and
    build the projection that zeroes under-constrained directions.

    3x3 systems use the closed-form symmetric eigensolver (branch-free);
    larger systems fall back to ``jnp.linalg.eigh``.  For symmetric AtA the
    eigenbasis is orthonormal, so V⁻¹ = Vᵀ and the reference's
    ``matV.inv() * matV2`` is just Vᵀ·V2 — no solve needed."""
    if AtA.shape[-1] == 3:
        evals, evecs = smallalg.eigh3x3(AtA)
    else:
        evals, evecs = jnp.linalg.eigh(AtA)
    keep = evals >= eig_thresh
    # V has eigenvectors as rows (the cv::eigen layout): V = evecsᵀ.
    V = evecs.T
    V2 = jnp.where(keep[:, None], V, 0.0)
    P = V.T @ V2
    return DegeneracyState(P=P, is_degenerate=jnp.any(~keep))


def assemble_normal_equations(
    J: jax.Array, r: jax.Array, row_valid: jax.Array, damping: float,
) -> Tuple[jax.Array, jax.Array]:
    """(N, D) row Jacobians + residuals -> (AtA (D, D), AtB (D,)).

    Normal-equation assembly is a SUM over residual rows, so sharding the row
    axis over a mesh and ``psum``-ing the outputs is exactly equivalent to the
    single-device assembly — this split is the distributed-mapping hook."""
    Jm = jnp.where(row_valid[:, None], J, 0.0)
    rm = jnp.where(row_valid, r, 0.0)
    # HIGHEST precision: below it XLA may feed reduced-precision operands
    # (bf16 or TF32) to these f32 contractions over the (large) row axis,
    # putting ~0.1-0.4% noise on the 6x6 normal equations the GN solve then
    # amplifies.
    hi = jax.lax.Precision.HIGHEST
    return (jnp.matmul(Jm.T, Jm, precision=hi),
            jnp.matmul(Jm.T, -damping * rm, precision=hi))


def solve_assembled(
    AtA: jax.Array,
    AtB: jax.Array,
    deg: DegeneracyState,
    update_degeneracy: jax.Array,
    eig_thresh: float,
) -> Tuple[jax.Array, DegeneracyState]:
    """Solve pre-assembled (possibly psum-reduced) normal equations with the
    reference's degeneracy projection."""
    # The eigendecomposition only happens on the refresh iteration (the
    # reference computes it on iteration 0 only).  With a statically unrolled
    # caller the flag is a Python bool and the branch resolves at trace time;
    # traced flags fall back to lax.cond.
    if isinstance(update_degeneracy, bool):
        if update_degeneracy:
            deg = analyze_degeneracy(AtA, eig_thresh)
    else:
        deg = jax.lax.cond(
            update_degeneracy,
            lambda: analyze_degeneracy(AtA, eig_thresh),
            lambda: deg,
        )
    # Solve the (possibly ill-conditioned) system with a tiny Tikhonov floor to
    # keep the solve finite; the degeneracy projection then removes the bad
    # directions exactly as the reference's matP does.  Closed-form solves
    # (no pivoted LU) — these run inside lax.while_loop on the device.
    d = AtA.shape[0]
    if d == 3:
        delta = smallalg.solve3(AtA + 1e-6 * jnp.eye(3), AtB)
    elif d == 6:
        delta = smallalg.solve6_spd(AtA + 1e-6 * jnp.eye(6), AtB)
    else:
        delta = jnp.linalg.solve(AtA + 1e-6 * jnp.eye(d), AtB)
    delta = jnp.where(deg.is_degenerate, deg.P @ delta, delta)
    delta = jnp.where(jnp.isfinite(delta), delta, 0.0)  # NaN guard (ref: 1362)
    return delta, deg


def solve_normal_equations(
    J: jax.Array,
    r: jax.Array,
    row_valid: jax.Array,
    damping: float,
    deg: DegeneracyState,
    update_degeneracy: jax.Array,
    eig_thresh: float,
) -> Tuple[jax.Array, DegeneracyState]:
    """One damped GN step:  δ = P · (JᵀJ)⁻¹ Jᵀ(−damping·r).

    J: (N, D) row Jacobians (already robust-weighted), r: (N,) residuals,
    row_valid masks dead rows.  ``update_degeneracy`` (scalar bool) refreshes
    the degeneracy projection from this iteration's JᵀJ (the reference does so
    on iteration 0 only).
    """
    AtA, AtB = assemble_normal_equations(J, r, row_valid, damping)
    return solve_assembled(AtA, AtB, deg, update_degeneracy, eig_thresh)


def point_to_plane(
    p: jax.Array, t1: jax.Array, t2: jax.Array, t3: jax.Array
) -> Tuple[jax.Array, jax.Array]:
    """Signed distance of p to the plane through (t1, t2, t3), batched (N, 3).

    Returns (unit normal (N, 3), signed distance (N,)) — the reference's
    pa/pb/pc/pd2 (featureAssociation.cpp:1234-1249)."""
    n = jnp.cross(t2 - t1, t3 - t1)
    norm = jnp.linalg.norm(n, axis=-1, keepdims=True)
    n = n / jnp.maximum(norm, 1e-12)
    d = jnp.sum(n * (p - t1), axis=-1)
    return n, d


def point_to_line(
    p: jax.Array, t1: jax.Array, t2: jax.Array
) -> Tuple[jax.Array, jax.Array]:
    """Distance of p to the 3D line through (t1, t2), batched (N, 3).

    Returns (gradient direction (N, 3) — the reference's la/lb/lc — and the
    distance ld2 (featureAssociation.cpp:1121-1135))."""
    cross = jnp.cross(p - t1, p - t2)
    a012 = jnp.linalg.norm(cross, axis=-1)
    l12 = jnp.linalg.norm(t1 - t2, axis=-1)
    ld2 = a012 / jnp.maximum(l12, 1e-12)
    # Gradient of ld2 wrt p: the unit vector perpendicular to the line pointing
    # from the line to p.  With u = t2-t1, w = p-t1: cross = u×w and
    # (u×w)×u = (u·u)·w_perp, so normalize(cross×u) = +∇D.
    dir_ = jnp.cross(cross, t2 - t1)
    dn = jnp.linalg.norm(dir_, axis=-1, keepdims=True)
    dir_ = dir_ / jnp.maximum(dn, 1e-12)
    return dir_, ld2


def fit_plane_lstsq(pts: jax.Array) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Fit a plane n·x + d = 0 (|n| = 1) to (N, K, 3) neighbor sets by solving
    A·n = −1 — the reference's QR plane fit (mapOptmization.cpp:1184-1189).

    Returns (n (N, 3), d (N,), max_off (N,) — the largest |n·x+d| over the K
    points, used for the 0.2 m planarity gate (mapOptmization.cpp:1199-1207))."""
    # Centered formulation: n = smallest-eigenvalue direction of the neighbor
    # covariance, d = -n·centroid.  Equivalent plane to the reference's
    # A·n = -1 QR solve, but numerically stable at WORLD coordinates: the raw
    # solve's AtA entries grow as ||x||² (~8000 m² at 90 m from the origin)
    # and its f32 conditioning degrades quadratically with distance, while
    # the centered covariance only sees the ~0.4 m neighbor spread.  (The -1
    # RHS trick also degenerates for planes near the origin; this doesn't.)
    c = jnp.mean(pts, axis=1)
    q = pts - c[:, None, :]
    cov = jnp.einsum("nki,nkj->nij", q, q)
    evals, evecs = smallalg.eigh3x3(cov)
    n = evecs[..., 0]                     # ascending order -> smallest
    d = -jnp.sum(n * c, axis=-1)
    off = jnp.abs(jnp.einsum("nki,ni->nk", pts, n) + d[:, None])
    return n, d, jnp.max(off, axis=-1)


def pca_line(pts: jax.Array) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """PCA of (N, K, 3) neighbor sets for the mapping corner line fit
    (mapOptmization.cpp:1102-1127).

    Returns (centroid (N, 3), principal direction (N, 3), eigenvalues (N, 3)
    ascending)."""
    c = jnp.mean(pts, axis=1)
    q = pts - c[:, None, :]
    cov = jnp.einsum("nki,nkj->nij", q, q) / pts.shape[1]
    evals, evecs = smallalg.eigh3x3(cov)   # batched closed form
    return c, evecs[..., -1], evals
