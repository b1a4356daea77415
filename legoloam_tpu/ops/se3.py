"""Batched SE(3)/SO(3) utilities — the geometry core of the rebuild.

The reference represents every pose as ``float transform[6] = {rx, ry, rz, tx, ty,
tz}`` Euler angles in the LOAM camera convention and composes poses through
hand-expanded closed-form Euler expressions (``src/featureAssociation.cpp:1015-1032``
``AccumulateRotation``, ``src/mapOptmization.cpp:376-461`` /
``src/transformFusion.cpp:94-179`` ``transformAssociateToMap``).

The rebuild replaces all of that with rotation matrices and tangent-space
(so(3)/se(3)) updates: composition is a batched 3x3 product, interpolation is
``exp(t * log(R))``, and the "monster expression" ``transformAssociateToMap`` becomes
the three-line ``T_guess = T_aft ∘ T_bef⁻¹ ∘ T_now``.

Everything here broadcasts over leading batch dimensions.  Poses are carried as a
``Pose(R, t)`` NamedTuple (a pytree) with ``R: (..., 3, 3)`` and ``t: (..., 3)``.

Frame convention: single lidar frame (x forward, y left, z up).  The reference's
camera-frame cyclic swap (``src/featureAssociation.cpp:500-502``) is provided only
as ``lidar_to_camera`` / ``camera_to_lidar`` for trajectory comparison.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class Pose(NamedTuple):
    """Rigid transform p_world = R @ p_local + t, broadcastable over batch dims."""

    R: jax.Array  # (..., 3, 3)
    t: jax.Array  # (..., 3)

    @staticmethod
    def identity(batch: tuple = (), dtype=jnp.float32) -> "Pose":
        R = jnp.broadcast_to(jnp.eye(3, dtype=dtype), batch + (3, 3))
        t = jnp.zeros(batch + (3,), dtype)
        return Pose(R, t)

    def matrix(self) -> jax.Array:
        """(..., 4, 4) homogeneous matrix."""
        batch = self.t.shape[:-1]
        bottom = jnp.broadcast_to(
            jnp.array([0.0, 0.0, 0.0, 1.0], self.t.dtype), batch + (4,)
        )
        top = jnp.concatenate([self.R, self.t[..., :, None]], axis=-1)
        return jnp.concatenate([top, bottom[..., None, :]], axis=-2)


def rotate_vec(R: jax.Array, v: jax.Array) -> jax.Array:
    """``R (..., 3, 3) @ v (..., 3)`` as the explicit 9-term expansion.

    Deliberately NOT a matmul/einsum: a K=3 contraction inherits the
    backend's default matmul precision, and a reduced-precision f32 dot
    (bf16 operands: ~0.1 m at 70 m world coordinates; TF32: ~cm) per
    transformed point drove a ring-world mapping runaway (see
    ``legoloam_tpu/__init__``).  The elementwise form is exact f32 whatever
    the precision setting."""
    return jnp.stack([
        R[..., 0, 0] * v[..., 0] + R[..., 0, 1] * v[..., 1]
        + R[..., 0, 2] * v[..., 2],
        R[..., 1, 0] * v[..., 0] + R[..., 1, 1] * v[..., 1]
        + R[..., 1, 2] * v[..., 2],
        R[..., 2, 0] * v[..., 0] + R[..., 2, 1] * v[..., 1]
        + R[..., 2, 2] * v[..., 2],
    ], axis=-1)


def mat3_mul(A: jax.Array, B: jax.Array) -> jax.Array:
    """``A (..., 3, 3) @ B (..., 3, 3)`` as the explicit per-column expansion.

    Deliberately NOT a matmul (same reason as ``rotate_vec``): a 3x3 matmul
    inherits the backend's matmul precision, and a reduced-precision one
    (bf16_3x) carries a SYSTEMATIC ~1e-5 contraction per product (measured:
    det drifts to 0.974 over 800 f32 compositions; raw bf16 is far worse).  Pose rotations pass through thousands of chained
    compositions (odometry integrate, LM retracts, guess projection), and the
    accumulated contraction shrinks world-transformed keyframe clouds — at
    ~130 scans the no-IMU mapped pose had det 0.85, smearing the submap and
    driving the runaway ring-world divergence this fixes.  The
    elementwise form is exact f32 and cheaper at K=3."""
    return jnp.stack([rotate_vec(A, B[..., :, j]) for j in range(3)], axis=-1)


def so3_project(R: jax.Array) -> jax.Array:
    """One symmetric-Newton step toward the nearest rotation:
    R <- R (3I − RᵀR) / 2.  For drift ε (R = Q(I+E), ‖E‖ = ε) the residual
    after one step is O(ε²) — at float32 rounding levels (ε ~ 1e-6) that is
    exact; used as cheap per-step insurance on ACCUMULATED rotations
    (odometry pose, mapped pose) so orthonormality error stays bounded over
    20K-scan runs instead of random-walking."""
    RtR = mat3_mul(jnp.swapaxes(R, -1, -2), R)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=R.dtype), R.shape)
    return mat3_mul(R, 1.5 * eye - 0.5 * RtR)


def compose(a: Pose, b: Pose) -> Pose:
    """a ∘ b: apply b first, then a."""
    return Pose(mat3_mul(a.R, b.R), rotate_vec(a.R, b.t) + a.t)


def inverse(p: Pose) -> Pose:
    Rt = jnp.swapaxes(p.R, -1, -2)
    return Pose(Rt, -rotate_vec(Rt, p.t))


def transform_points(p: Pose, pts: jax.Array) -> jax.Array:
    """Apply pose (batch ``...``) to a cloud ``(..., N, 3)``."""
    return rotate_vec(p.R[..., None, :, :], pts) + p.t[..., None, :]


def apply(p: Pose, x: jax.Array) -> jax.Array:
    """Apply pose to per-item points ``(..., 3)`` (pose batch dims match)."""
    return rotate_vec(p.R, x) + p.t


def relative(a: Pose, b: Pose) -> Pose:
    """a⁻¹ ∘ b — the motion taking frame a to frame b."""
    return compose(inverse(a), b)


# ---------------------------------------------------------------------------
# SO(3)
# ---------------------------------------------------------------------------

def hat(w: jax.Array) -> jax.Array:
    """so(3) hat operator: (..., 3) -> (..., 3, 3) skew matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([z, -wz, wy], axis=-1),
            jnp.stack([wz, z, -wx], axis=-1),
            jnp.stack([-wy, wx, z], axis=-1),
        ],
        axis=-2,
    )


def vee(W: jax.Array) -> jax.Array:
    return jnp.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], axis=-1)


def so3_exp(w: jax.Array) -> jax.Array:
    """Rodrigues formula, numerically safe at ||w|| -> 0."""
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta2, 1e-24))
    # sin(t)/t and (1-cos(t))/t^2 with series fallbacks near zero.
    small = theta2 < 1e-12
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2)
    W = hat(w)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * mat3_mul(W, W)


def so3_log(R: jax.Array) -> jax.Array:
    """Inverse of so3_exp.  Safe for theta in [0, pi)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = jnp.arccos(cos_theta)
    w_vee = vee(R - jnp.swapaxes(R, -1, -2)) * 0.5  # = sin(theta) * axis
    sin_theta = jnp.sin(theta)
    # theta/sin(theta), series near 0; near pi use the symmetric-part fallback.
    small = theta < 1e-4
    scale = jnp.where(
        small, 1.0 + theta * theta / 6.0, theta / jnp.where(small, 1.0, sin_theta)
    )
    w = w_vee * scale[..., None]
    # Near pi the antisymmetric part vanishes; recover axis from R + I diagonal.
    near_pi = theta > 3.0
    axis_sq = jnp.clip((jnp.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]],
                                  axis=-1) + 1.0) * 0.5, 0.0, 1.0)
    axis = jnp.sqrt(axis_sq)
    # Fix signs using the off-diagonals.
    sx = jnp.where(R[..., 2, 1] - R[..., 1, 2] >= 0, 1.0, -1.0)
    sy = jnp.where(R[..., 0, 2] - R[..., 2, 0] >= 0, 1.0, -1.0)
    sz = jnp.where(R[..., 1, 0] - R[..., 0, 1] >= 0, 1.0, -1.0)
    axis = axis * jnp.stack([sx, sy, sz], axis=-1)
    w_pi = axis * theta[..., None]
    return jnp.where(near_pi[..., None], w_pi, w)


def so3_interp(Ra: jax.Array, Rb: jax.Array, s: jax.Array) -> jax.Array:
    """Geodesic interpolation R(s) = Ra exp(s log(RaᵀRb)) (slerp on SO(3))."""
    dR = mat3_mul(jnp.swapaxes(Ra, -1, -2), Rb)
    return mat3_mul(Ra, so3_exp(so3_log(dR) * s[..., None]))


# ---------------------------------------------------------------------------
# SE(3)
# ---------------------------------------------------------------------------

def _left_jacobian(w: jax.Array) -> jax.Array:
    """SO(3) left Jacobian V(w) used in the se(3) exponential."""
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta2, 1e-24))
    small = theta2 < 1e-12
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2)
    c = jnp.where(
        small, 1.0 / 6.0 - theta2 / 120.0, (theta - jnp.sin(theta)) / (theta2 * theta)
    )
    W = hat(w)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + b[..., None, None] * W + c[..., None, None] * mat3_mul(W, W)


def se3_exp(xi: jax.Array) -> Pose:
    """xi = (..., 6) [w | v] twist -> Pose."""
    w, v = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    t = rotate_vec(_left_jacobian(w), v)
    return Pose(R, t)


def se3_log(p: Pose) -> jax.Array:
    from . import smallalg  # local import to avoid a cycle at module load

    w = so3_log(p.R)
    V = _left_jacobian(w)
    v = smallalg.solve3(V, p.t)  # closed form: V is 3x3, well-conditioned
    return jnp.concatenate([w, v], axis=-1)


def retract(p: Pose, xi: jax.Array) -> Pose:
    """Left-multiplicative update: exp(xi) ∘ p.  Used by all GN/LM solvers."""
    return compose(se3_exp(xi), p)


def retract_about(p: Pose, xi: jax.Array, center: jax.Array) -> Pose:
    """Left-multiplicative update whose rotation acts about ``center`` instead
    of the world origin: x -> exp(ω)·(x − center) + center + v.

    Pairs with Jacobians built from CENTERED point coordinates
    (J_rot = (p − center) × n).  A left-global update (plain ``retract``)
    makes J_rot = p_world × n, whose lever arm grows with distance from the
    world origin — the float32 normal equations then turn ill-conditioned and
    Gauss-Newton stops converging (the reference never hits this because its
    Euler linearization is around the scan pose with sensor-local points,
    mapOptmization.cpp:1252-1271).  Centering reproduces the reference's
    sensor-local conditioning with a position-independent twist."""
    Rd = so3_exp(xi[:3])
    td = center + xi[3:] - rotate_vec(Rd, center)
    return compose(Pose(Rd, td), p)


# ---------------------------------------------------------------------------
# Euler (ZYX yaw-pitch-roll, lidar frame) — for I/O and reference comparison
# ---------------------------------------------------------------------------

def rot_x(a):
    c, s = jnp.cos(a), jnp.sin(a)
    o, z = jnp.ones_like(a), jnp.zeros_like(a)
    return jnp.stack(
        [jnp.stack([o, z, z], -1), jnp.stack([z, c, -s], -1),
         jnp.stack([z, s, c], -1)], -2)


def rot_y(a):
    c, s = jnp.cos(a), jnp.sin(a)
    o, z = jnp.ones_like(a), jnp.zeros_like(a)
    return jnp.stack(
        [jnp.stack([c, z, s], -1), jnp.stack([z, o, z], -1),
         jnp.stack([-s, z, c], -1)], -2)


def rot_z(a):
    c, s = jnp.cos(a), jnp.sin(a)
    o, z = jnp.ones_like(a), jnp.zeros_like(a)
    return jnp.stack(
        [jnp.stack([c, -s, z], -1), jnp.stack([s, c, z], -1),
         jnp.stack([z, z, o], -1)], -2)


def euler_zyx_to_mat(roll, pitch, yaw) -> jax.Array:
    """R = Rz(yaw) Ry(pitch) Rx(roll)."""
    return mat3_mul(mat3_mul(rot_z(yaw), rot_y(pitch)), rot_x(roll))


def mat_to_euler_zyx(R: jax.Array):
    """Inverse of euler_zyx_to_mat (gimbal-safe for |pitch| < pi/2)."""
    pitch = jnp.arcsin(jnp.clip(-R[..., 2, 0], -1.0, 1.0))
    roll = jnp.arctan2(R[..., 2, 1], R[..., 2, 2])
    yaw = jnp.arctan2(R[..., 1, 0], R[..., 0, 0])
    return roll, pitch, yaw


# ---------------------------------------------------------------------------
# Reference-frame comparison helpers
# ---------------------------------------------------------------------------

# The reference's camera convention: p_cam = (p_lidar.y, p_lidar.z, p_lidar.x)
# (src/featureAssociation.cpp:500-502).  As a rotation matrix (lidar -> camera):
_SWAP = jnp.array([[0.0, 1.0, 0.0], [0.0, 0.0, 1.0], [1.0, 0.0, 0.0]])


def lidar_to_camera(p: Pose) -> Pose:
    """Express a lidar-frame pose in the reference's camera convention."""
    S = _SWAP.astype(p.t.dtype)
    return Pose(S @ p.R @ S.T, jnp.einsum("ij,...j->...i", S, p.t))


def camera_to_lidar(p: Pose) -> Pose:
    S = _SWAP.astype(p.t.dtype)
    return Pose(S.T @ p.R @ S, jnp.einsum("ji,...j->...i", S, p.t))


def project_through_correction(t_now: Pose, t_bef: Pose, t_aft: Pose) -> Pose:
    """Array-native ``transformAssociateToMap``.

    The reference implements this as ~80 lines of expanded Euler algebra
    (``src/mapOptmization.cpp:376-461`` and again ``src/transformFusion.cpp:94-179``);
    with matrices it is literally ``T_aft ∘ T_bef⁻¹ ∘ T_now``: re-apply the latest
    mapping correction (bef -> aft) to the newest odometry pose.
    """
    return compose(t_aft, compose(inverse(t_bef), t_now))
