"""Range-image projection: raw scan -> dense (N_SCAN, Horizon_SCAN) image.

Reference behavior: ``src/imageProjection.cpp:199-257`` (``findStartEndAngle`` +
``projectPointCloud``).  The reference iterates point-by-point filling ``cv::Mat``
images; here the whole scan is projected with one fused batch of vector ops plus
three deterministic segment reductions.

Design notes:
  * Everything downstream consumes the DENSE image — there is no compaction into a
    variable-length "fullCloud"; validity is a mask channel.  Fixed (16, 1800)
    planes vectorize cleanly and remove every dynamic shape.
  * Cell collisions (two points projecting to one cell): the reference overwrites
    in point order (last write wins, nondeterministic under reordering);
    we keep the CLOSEST point per cell, deterministically (ties -> lowest point
    index), via segment-min reductions.
  * Per-point relative scan time is recovered from azimuth with the reference's
    half-pass disambiguation (``src/featureAssociation.cpp:504-522``) and stored
    as a dense channel, replacing the reference's trick of smuggling time in the
    fractional part of ``intensity`` (``featureAssociation.cpp:523``).

Input convention: a raw scan is ``points: (P, 3) float32`` + ``valid: (P,) bool``
(+ optional ``ring: (P,) int32``), fixed-size with padding — P is a static cap.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..config import SensorConfig


class RangeImage(NamedTuple):
    """Dense organized scan.  All arrays (N_SCAN, H) unless noted."""

    xyz: jax.Array        # (N_SCAN, H, 3) point coordinates (lidar frame)
    rng: jax.Array        # range in meters; +inf where no return
    valid: jax.Array      # bool: cell has a return
    rel_time: jax.Array   # per-cell time within the scan, in [0, 1] scan fractions
    start_ori: jax.Array  # () scan start azimuth (radians)
    end_ori: jax.Array    # () scan end azimuth (radians, > start_ori)


def _point_orientations(points, valid, n_points):
    """Reference ``findStartEndAngle`` (imageProjection.cpp:199-209) plus the
    per-point half-pass disambiguation of ``adjustDistortion``
    (featureAssociation.cpp:504-522), vectorized.

    Returns (ori, start_ori, end_ori) with ori unwrapped into [start, end].
    """
    x, y = points[..., 0], points[..., 1]
    yaw = -jnp.arctan2(y, x)
    # First / last valid point (reference assumes point order == firing order).
    idx = jnp.arange(n_points)
    first = jnp.argmax(valid)  # first True
    last = n_points - 1 - jnp.argmax(valid[::-1])
    start_ori = yaw[first]
    end_ori = yaw[last] + 2.0 * math.pi
    # Normalize end into [start + pi, start + 3pi)  (imageProjection.cpp:205-208)
    end_ori = jnp.where(end_ori - start_ori > 3.0 * math.pi, end_ori - 2.0 * math.pi,
                        end_ori)
    end_ori = jnp.where(end_ori - start_ori < math.pi, end_ori + 2.0 * math.pi,
                        end_ori)
    half_passed = idx > (first + last) // 2  # proxy for the reference's running flag
    ori = jnp.where(half_passed, yaw + 2.0 * math.pi, yaw)
    # Pull into the window around start/end as the reference does.
    ori = jnp.where(~half_passed & (ori < start_ori - math.pi / 2), ori + 2 * math.pi,
                    ori)
    ori = jnp.where(~half_passed & (ori > start_ori + math.pi * 3 / 2),
                    ori - 2 * math.pi, ori)
    ori = jnp.where(half_passed & (ori < end_ori - math.pi * 3 / 2), ori + 2 * math.pi,
                    ori)
    ori = jnp.where(half_passed & (ori > end_ori + math.pi / 2), ori - 2 * math.pi,
                    ori)
    return ori, start_ori, end_ori


def project_scan(
    points: jax.Array,
    valid: jax.Array,
    sensor: SensorConfig,
    ring: Optional[jax.Array] = None,
) -> RangeImage:
    """Project a raw scan into a dense range image.

    Row/column math follows ``src/imageProjection.cpp:229-242`` exactly; the
    scatter is replaced by deterministic closest-point-wins segment reductions.
    """
    n, h = sensor.n_scan, sensor.horizon_scan
    n_cells = n * h
    p_cap = points.shape[0]
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    rng = jnp.sqrt(x * x + y * y + z * z)

    # Row index: sensor ring channel if available, else vertical angle binning
    # (imageProjection.cpp:224-231).
    if ring is not None and sensor.use_cloud_ring:
        row = ring.astype(jnp.int32)
    else:
        vert_deg = jnp.degrees(jnp.arctan2(z, jnp.sqrt(x * x + y * y)))
        row = jnp.floor(
            (vert_deg + sensor.ang_bottom_deg) / sensor.ang_res_y_deg
        ).astype(jnp.int32)

    # Column index (imageProjection.cpp:233-242).
    horizon_deg = jnp.degrees(jnp.arctan2(x, y))
    col = (-jnp.round((horizon_deg - 90.0) / sensor.ang_res_x_deg)).astype(jnp.int32) \
        + h // 2
    col = jnp.where(col >= h, col - h, col)

    ok = (
        valid
        & (row >= 0) & (row < n)
        & (col >= 0) & (col < h)
        & (rng >= sensor.min_range)          # imageProjection.cpp:244-246
        & jnp.isfinite(rng)
    )

    flat = jnp.where(ok, row * h + col, n_cells)  # padded cell drops into slot n_cells

    # Closest-point-wins, deterministic, in ONE segment reduction: pack
    # (range, point index) into a single sortable int32 key — the top
    # (31 - idx_bits) bits of the positive-float range bit pattern
    # (order-preserving; the dropped low mantissa bits are a small relative
    # quantization used ONLY to pick the winner) + idx_bits index bits sized
    # to the scan cap (15 bits / 2^-9 quantization for the VLP-16's 28.8K
    # points; 18 bits / 2^-6 for the VLS-128's 230K).  min(key) = closest
    # point, near-ties broken by lowest point index, deterministically.
    # Scatter/gather ops dominate this backend's per-scan cost, so one
    # packed reduction + one gather + one stacked scatter replaces the
    # previous two reductions + two gathers + two scatters.
    idx_bits = max(1, (p_cap - 1).bit_length())
    assert idx_bits <= 18, "packed projection key needs p_cap <= 262144"
    idx_mask = (1 << idx_bits) - 1
    pidx = jnp.arange(p_cap, dtype=jnp.int32)
    rng_bits = jax.lax.bitcast_convert_type(rng, jnp.int32)
    key = jnp.where(ok, (rng_bits & ~idx_mask) | pidx,
                    jnp.int32(0x7FFFFFFF))
    cell_key = jax.ops.segment_min(key, flat, num_segments=n_cells + 1)

    ori, start_ori, end_ori = _point_orientations(points, ok, p_cap)
    # Empty-scan guard: with no valid point, _point_orientations' argmax
    # picks index 0 and start/end are atan2(0,0)-derived garbage; every cell
    # is masked invalid downstream, but zero the timing channel explicitly so
    # it can never leak non-finite values (end - start >= pi by construction,
    # so the division itself is safe).
    rel = jnp.where(jnp.any(ok),
                    (ori - start_ori) / (end_ori - start_ori), 0.0)

    # The packed key's low 15 bits ARE the winning point index, so the cell
    # channels come from one stacked GATHER of point data — no scatter and no
    # winner-mask round trip.
    valid_flat = cell_key[:n_cells] != 0x7FFFFFFF
    win_idx = jnp.where(valid_flat, cell_key[:n_cells] & idx_mask, 0)
    vals = jnp.concatenate(
        [points[..., :3], rel[:, None], rng[:, None]], axis=1)
    img = vals[win_idx] * valid_flat[:, None].astype(vals.dtype)

    valid_img = valid_flat.reshape(n, h)
    xyz_img = img[:, :3].reshape(n, h, 3)
    rel_img = img[:, 3].reshape(n, h)
    rng_img = jnp.where(valid_img, img[:, 4].reshape(n, h), jnp.inf)

    return RangeImage(
        xyz=xyz_img, rng=rng_img, valid=valid_img, rel_time=rel_img,
        start_ori=start_ori, end_ori=end_ori,
    )
