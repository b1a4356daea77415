"""IMU integration + per-point motion de-skew.

Reference behavior: ``src/featureAssociation.cpp:391-619`` (``imuHandler``,
``AccumulateIMUShiftAndRotation``, ``adjustDistortion``, ``VeloToStartIMU``,
``TransformToStartIMU``).

The reference maintains 200-slot ring buffers filled one sample at a time by a
ROS callback, then walks pointers per point inside ``adjustDistortion``.  Here
the IMU window covering a scan arrives as fixed-shape arrays; integration is a
cumulative sum and the per-point lookup is one vectorized ``searchsorted`` over
all 28.8K cells at once.

Physics (identical to the reference): orientation comes from the IMU
attitude; gravity is removed using that attitude; acceleration is rotated to
world and double-integrated to a position "shift" and velocity.  De-skew
removes only the NONLINEAR part of intra-scan motion — the deviation from
constant velocity at the scan-start velocity — because the linear part is what
scan-to-scan odometry estimates and removes itself via per-point transform
interpolation (``TransformToStart``, featureAssociation.cpp:854-883):

    shift_from_start(t) = shift(t) - shift(t0) - velo(t0) * (t - t0)
    p_corrected = R(t0)^T R(t) p  +  R(t0)^T shift_from_start(t)

All in the single lidar frame (the reference's camera-frame swap of IMU axes,
featureAssociation.cpp:438-440, does not exist here).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .se3 import euler_zyx_to_mat

GRAVITY = 9.81


class ImuWindow(NamedTuple):
    """Fixed-size window of IMU samples covering (at least) one scan.

    time:  (L,) absolute seconds, nondecreasing over valid entries
    rpy:   (L, 3) orientation roll/pitch/yaw (world attitude of the sensor)
    acc:   (L, 3) specific force in the SENSOR frame (gravity not removed)
    gyro:  (L, 3) angular rate in the sensor frame
    valid: (L,) bool
    """

    time: jax.Array
    rpy: jax.Array
    acc: jax.Array
    gyro: jax.Array
    valid: jax.Array


class ImuIntegral(NamedTuple):
    """Integrated IMU quantities at each sample (world frame)."""

    time: jax.Array    # (L,)
    rpy: jax.Array     # (L, 3)
    velo: jax.Array    # (L, 3) world velocity
    shift: jax.Array   # (L, 3) world position offset
    ang: jax.Array     # (L, 3) integrated gyro angles (odometry seed)
    valid: jax.Array


@jax.jit
def integrate_imu(w: ImuWindow) -> ImuIntegral:
    """Reference ``AccumulateIMUShiftAndRotation`` (featureAssociation.cpp:392-429)
    as one cumulative sum.

    World acceleration: a_w = R(rpy) @ f + g  (f = specific force, g = (0,0,-G)).
    The reference instead subtracts gravity components in the sensor frame
    (featureAssociation.cpp:435-440) — algebraically the same operation.
    Like the reference, integration across gaps > scan_period is suppressed
    (featureAssociation.cpp:413-428) by clamping dt.
    """
    R = euler_zyx_to_mat(w.rpy[:, 0], w.rpy[:, 1], w.rpy[:, 2])
    g = jnp.array([0.0, 0.0, -GRAVITY])
    a_world = jnp.einsum("lij,lj->li", R, w.acc) + g

    dt = jnp.diff(w.time, prepend=w.time[:1])
    dt = jnp.where(w.valid & (dt > 0) & (dt < 0.1), dt, 0.0)

    # velo_i = sum_{j<=i} a_j dt_j ; shift uses the trapezoid-ish same rule as
    # the reference: shift += velo_prev*dt + 0.5*a*dt^2.
    a_dt = a_world * dt[:, None]
    velo = jnp.cumsum(a_dt, axis=0)
    velo_prev = jnp.concatenate([jnp.zeros((1, 3)), velo[:-1]], axis=0)
    shift = jnp.cumsum(velo_prev * dt[:, None] + 0.5 * a_world * dt[:, None] ** 2,
                       axis=0)
    ang = jnp.cumsum(w.gyro * dt[:, None], axis=0)
    return ImuIntegral(time=w.time, rpy=w.rpy, velo=velo, shift=shift, ang=ang,
                       valid=w.valid)


def _interp(integral: ImuIntegral, t: jax.Array):
    """Linear interpolation of rpy/velo/shift at times t (any shape)."""
    L = integral.time.shape[0]
    tt = jnp.where(integral.valid, integral.time, jnp.inf)
    hi = jnp.clip(jnp.searchsorted(tt, t, side="right"), 1, L - 1)
    lo = hi - 1
    t_lo, t_hi = tt[lo], tt[hi]
    denom = jnp.where(t_hi > t_lo, t_hi - t_lo, 1.0)
    f = jnp.clip((t - t_lo) / denom, 0.0, 1.0)
    # Clamp outside the window to the nearest sample (reference behavior when
    # the pointer hits the newest sample, featureAssociation.cpp:533-545).
    f = jnp.where(jnp.isfinite(t_hi), f, 0.0)

    def lerp(a):
        return a[lo] + f[..., None] * (a[hi] - a[lo])

    return lerp(integral.rpy), lerp(integral.velo), lerp(integral.shift), \
        lerp(integral.ang)


class DeskewResult(NamedTuple):
    xyz: jax.Array           # (N, H, 3) corrected coordinates (scan-start frame)
    rpy_start: jax.Array     # (3,) IMU attitude at scan start
    velo_start: jax.Array    # (3,) world velocity at scan start
    ang_delta: jax.Array     # (3,) integrated gyro delta over the scan
    shift_from_start_end: jax.Array  # (3,) nonlinear shift at scan end


@functools.partial(jax.jit, static_argnames=("scan_period",))
def deskew_image(
    xyz: jax.Array,
    rel_time: jax.Array,
    cell_valid: jax.Array,
    scan_start_time: jax.Array,
    integral: ImuIntegral,
    scan_period: float = 0.1,
) -> DeskewResult:
    """De-skew a dense (N, H, 3) image given integrated IMU state.

    Matches ``adjustDistortion`` + ``TransformToStartIMU`` semantics
    (featureAssociation.cpp:491-619) with the constant-velocity deviation model
    described in the module docstring.
    """
    t_pt = scan_start_time + rel_time * scan_period
    rpy_p, velo_p, shift_p, ang_p = _interp(integral, t_pt)
    rpy_s, velo_s, shift_s, ang_s = _interp(integral, scan_start_time[None])
    rpy_e, velo_e, shift_e, ang_e = _interp(
        integral, scan_start_time[None] + scan_period)
    rpy_s, velo_s, shift_s, ang_s = rpy_s[0], velo_s[0], shift_s[0], ang_s[0]

    dt = t_pt - scan_start_time
    shift_from_start = shift_p - shift_s - velo_s * dt[..., None]

    from .se3 import rotate_vec

    R_s = euler_zyx_to_mat(rpy_s[0], rpy_s[1], rpy_s[2])
    R_p = euler_zyx_to_mat(rpy_p[..., 0], rpy_p[..., 1], rpy_p[..., 2])
    # p' = R_s^T R_p p + R_s^T shift_from_start  (rotate_vec: exact-f32
    # elementwise form, independent of matmul precision, see ops/se3.py)
    p_rot = rotate_vec(R_s.T, rotate_vec(R_p, xyz))
    p_corr = p_rot + rotate_vec(R_s.T, shift_from_start)
    out = jnp.where(cell_valid[..., None], p_corr, xyz)

    return DeskewResult(
        xyz=out,
        rpy_start=rpy_s,
        velo_start=velo_s,
        ang_delta=ang_e[0] - ang_s,
        shift_from_start_end=shift_e[0] - shift_s - velo_s * scan_period,
    )
