"""Faithful NumPy port of the reference front-end RULES, as a test oracle.

This module re-implements, loop for loop, the per-scan decision rules of the
reference's first two stages so the JAX pipeline can be machine-checked
against them (SURVEY.md §7 build-order step 2):

  * ``findStartEndAngle``    — reference ``src/imageProjection.cpp:199-209``
  * ``projectPointCloud``    — ``src/imageProjection.cpp:211-257``
  * ``groundRemoval``        — ``src/imageProjection.cpp:260-310``
  * ``cloudSegmentation``    — ``src/imageProjection.cpp:312-368``
  * ``labelComponents``      — ``src/imageProjection.cpp:370-460`` (queue BFS,
    including the lineCount quirk: the BFS seed itself is never pushed, so its
    row is counted only if another cell of that row joins the cluster)
  * ``adjustDistortion`` timing recovery (no IMU) —
    ``src/featureAssociation.cpp:491-619``
  * ``calculateSmoothness``  — ``src/featureAssociation.cpp:621-641`` (global
    compacted array, windows crossing ring boundaries)
  * ``markOccludedPoints``   — ``src/featureAssociation.cpp:643-678``
  * ``extractFeatures``      — ``src/featureAssociation.cpp:680-784``
    (global-index section arithmetic, sort over [sp, ep) with the reference's
    exclusive-``ep`` quirk, 2/20/4 picks, ±5 suppression with column-gap break)

It is NOT part of the pipeline: nothing under ``legoloam_tpu/`` imports it
except tests.  It is deliberately written in plain Python/NumPy loops that
mirror the C++ control flow one-to-one, so that a disagreement with the
vectorized JAX pipeline localizes the bug.

Known, deliberate deviations of the pipeline from these rules (asserted as
such by tests/test_oracle_parity.py):
  1. Cell collisions: the pipeline keeps the CLOSEST point per cell
     (deterministic); the reference keeps the last-written.  Parity scans are
     collision-free so both agree.
  2. Curvature/occlusion windows: the pipeline evaluates them per ring; the
     reference's compacted array lets windows straddle ring boundaries.
     Divergence is confined to ±(halfwin+1) compacted positions around ring
     joins.
  3. Section start guard: the reference's startRingIndex lands 4 points into
     each ring (``sizeOfSegCloud - 1 + 5``); the pipeline uses 5 (= halfwin,
     the first position with a full curvature window).  The reference's
     position 4 reads uninitialized curvature state on ring 0.
  4. relTime: the pipeline computes per-point time from emission order at the
     projection stage; the reference re-derives it from azimuth over the
     column-ordered compacted cloud with a single half-pass flag, which
     mis-times points once the flag saturates.  (Not compared.)
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np

from ..config import FeatureConfig, SegmentationConfig, SensorConfig

FLT_MAX = np.float32(3.4028234663852886e38)


def _c_round(x: float) -> float:
    """C round(): half away from zero (numpy rounds half to even)."""
    return math.floor(x + 0.5) if x >= 0 else math.ceil(x - 0.5)


class OracleResult(NamedTuple):
    # Dense images (N_SCAN, H)
    range_mat: np.ndarray     # float32; FLT_MAX where no return
    full_idx: np.ndarray      # int32 winning input point index; -1 empty
    ground_mat: np.ndarray    # int8: -1 no info, 0 not ground, 1 ground
    label_mat: np.ndarray     # int32: -1 skip, >0 cluster id, 999999 invalid
    # Compacted segmented cloud (S points, reference push order)
    seg_row: np.ndarray       # int32 ring
    seg_col: np.ndarray       # int32 column
    seg_rng: np.ndarray       # float32 range
    seg_ground: np.ndarray    # bool segmentedCloudGroundFlag
    seg_cell: np.ndarray      # int32 flat cell id (row*H + col)
    start_ring_index: np.ndarray  # (N,) int32
    end_ring_index: np.ndarray    # (N,) int32
    outlier_cells: np.ndarray     # int32 flat cell ids (thinned 999999 points)
    rel_time: np.ndarray      # (S,) reference-recovered relTime
    # Feature stage (aligned with the compacted cloud)
    curvature: np.ndarray     # (S,) float32
    neighbor_picked: np.ndarray  # (S,) uint8 AFTER occlusion marking,
                                 # BEFORE the pick loops
    label: np.ndarray         # (S,) int8: 2 sharp, 1 less-sharp, -1 flat, 0
    sharp_cells: np.ndarray       # flat cell ids, pick order
    less_sharp_cells: np.ndarray
    flat_cells: np.ndarray
    less_flat_cells: np.ndarray   # pre-downsample (label <= 0 per section)


class OracleFrontend:
    """One-scan oracle.  Stateless across scans (arrays that the reference
    leaves stale across scans are zero-initialized, i.e. first-scan
    steady state)."""

    def __init__(self, sensor: SensorConfig, seg: SegmentationConfig,
                 feat: FeatureConfig):
        self.sensor = sensor
        self.seg = seg
        self.feat = feat

    # -- stage 1: imageProjection ------------------------------------------

    def process(self, points: np.ndarray, valid: np.ndarray,
                ring: Optional[np.ndarray] = None) -> OracleResult:
        sensor, seg_cfg, feat = self.sensor, self.seg, self.feat
        n, h = sensor.n_scan, sensor.horizon_scan
        pts = np.asarray(points, np.float32)
        val = np.asarray(valid, bool)
        # copyPointCloud: NaN/invalid removal keeps emission order.
        keep = np.where(val)[0]
        p = pts[keep]
        rg = np.asarray(ring)[keep] if ring is not None else None

        # findStartEndAngle (imageProjection.cpp:199-209)
        start_ori = -math.atan2(p[0, 1], p[0, 0])
        end_ori = -math.atan2(p[-1, 1], p[-1, 0]) + 2 * math.pi
        if end_ori - start_ori > 3 * math.pi:
            end_ori -= 2 * math.pi
        elif end_ori - start_ori < math.pi:
            end_ori += 2 * math.pi
        ori_diff = end_ori - start_ori

        # projectPointCloud (imageProjection.cpp:211-257)
        range_mat = np.full((n, h), FLT_MAX, np.float32)
        full_idx = np.full((n, h), -1, np.int32)
        for i in range(p.shape[0]):
            x, y, z = float(p[i, 0]), float(p[i, 1]), float(p[i, 2])
            if sensor.use_cloud_ring and rg is not None:
                row = int(rg[i])
            else:
                vert = math.degrees(math.atan2(z, math.hypot(x, y)))
                row = int((vert + sensor.ang_bottom_deg)
                          / sensor.ang_res_y_deg)  # C float->int truncation
            if row < 0 or row >= n:
                continue
            horizon = math.degrees(math.atan2(x, y))
            col = int(-_c_round((horizon - 90.0) / sensor.ang_res_x_deg)
                      + h // 2)
            if col >= h:
                col -= h
            if col < 0 or col >= h:
                continue
            r = math.sqrt(x * x + y * y + z * z)
            if r < sensor.min_range:
                continue
            range_mat[row, col] = np.float32(r)   # last write wins
            full_idx[row, col] = keep[i]

        # groundRemoval (imageProjection.cpp:260-310)
        ground_mat = np.zeros((n, h), np.int8)
        g = sensor.ground_scan_ind
        has = full_idx >= 0
        for j in range(h):
            for i in range(g):
                if not (has[i, j] and has[i + 1, j]):
                    ground_mat[i, j] = -1
                    continue
                lo = pts[full_idx[i, j]]
                up = pts[full_idx[i + 1, j]]
                d = up - lo
                ang = math.degrees(
                    math.atan2(float(d[2]), math.hypot(float(d[0]),
                                                       float(d[1]))))
                if abs(ang - sensor.mount_angle_deg) <= \
                        seg_cfg.ground_angle_thresh_deg:
                    ground_mat[i, j] = 1
                    ground_mat[i + 1, j] = 1
        label_mat = np.zeros((n, h), np.int32)
        label_mat[(ground_mat == 1) | (range_mat == FLT_MAX)] = -1

        # cloudSegmentation: BFS labelComponents per row-major seed
        # (imageProjection.cpp:312-317, 370-460)
        alpha_x = sensor.ang_res_x
        alpha_y = sensor.ang_res_y
        theta = math.radians(seg_cfg.segment_theta_deg)
        label_count = 1
        neighbors = [(-1, 0), (0, 1), (0, -1), (1, 0)]
        for si in range(n):
            for sj in range(h):
                if label_mat[si, sj] != 0:
                    continue
                queue = [(si, sj)]
                all_pushed = [(si, sj)]
                line_flag = np.zeros(n, bool)
                label_mat[si, sj] = label_count
                qh = 0
                while qh < len(queue):
                    fx, fy = queue[qh]
                    qh += 1
                    for dx, dy in neighbors:
                        tx, ty = fx + dx, fy + dy
                        if tx < 0 or tx >= n:
                            continue
                        if ty < 0:
                            ty = h - 1
                        if ty >= h:
                            ty = 0
                        if label_mat[tx, ty] != 0:
                            continue
                        d1 = max(float(range_mat[fx, fy]),
                                 float(range_mat[tx, ty]))
                        d2 = min(float(range_mat[fx, fy]),
                                 float(range_mat[tx, ty]))
                        alpha = alpha_x if dx == 0 else alpha_y
                        ang = math.atan2(d2 * math.sin(alpha),
                                         d1 - d2 * math.cos(alpha))
                        if ang > theta:
                            queue.append((tx, ty))
                            label_mat[tx, ty] = label_count
                            line_flag[tx] = True   # seed row NOT flagged here
                            all_pushed.append((tx, ty))
                # validity (imageProjection.cpp:440-451)
                feasible = len(all_pushed) >= seg_cfg.min_cluster_size
                if not feasible and len(all_pushed) >= seg_cfg.valid_point_num:
                    feasible = int(line_flag.sum()) >= seg_cfg.valid_line_num
                if feasible:
                    label_count += 1
                else:
                    for (ax, ay) in all_pushed:
                        label_mat[ax, ay] = 999999

        # compact segmented cloud (imageProjection.cpp:319-355)
        seg_row, seg_col, seg_rng, seg_ground, seg_cell = [], [], [], [], []
        start_ring = np.zeros(n, np.int32)
        end_ring = np.zeros(n, np.int32)
        outlier_cells = []
        for i in range(n):
            start_ring[i] = len(seg_row) - 1 + 5
            for j in range(h):
                if label_mat[i, j] > 0 or ground_mat[i, j] == 1:
                    if label_mat[i, j] == 999999:
                        if i > g and j % seg_cfg.outlier_downsample == 0:
                            outlier_cells.append(i * h + j)
                        continue
                    if ground_mat[i, j] == 1:
                        if (j % seg_cfg.ground_downsample != 0 and j > 5
                                and j < h - 5):
                            continue
                    seg_ground.append(ground_mat[i, j] == 1)
                    seg_col.append(j)
                    seg_rng.append(float(range_mat[i, j]))
                    seg_row.append(i)
                    seg_cell.append(i * h + j)
            end_ring[i] = len(seg_row) - 1 - 5
        seg_row = np.asarray(seg_row, np.int32)
        seg_col = np.asarray(seg_col, np.int32)
        seg_rng = np.asarray(seg_rng, np.float32)
        seg_ground = np.asarray(seg_ground, bool)
        seg_cell = np.asarray(seg_cell, np.int32)
        size = seg_row.shape[0]

        # adjustDistortion timing recovery, no IMU
        # (featureAssociation.cpp:491-533; camera swap folded away:
        # ori = -atan2(camera.x, camera.z) = -atan2(lidar.y, lidar.x))
        rel_time = np.zeros(size, np.float32)
        half_passed = False
        for i in range(size):
            cp = pts[full_idx[seg_row[i], seg_col[i]]]
            ori = -math.atan2(float(cp[1]), float(cp[0]))
            if not half_passed:
                if ori < start_ori - math.pi / 2:
                    ori += 2 * math.pi
                elif ori > start_ori + math.pi * 3 / 2:
                    ori -= 2 * math.pi
                if ori - start_ori > math.pi:
                    half_passed = True
            else:
                ori += 2 * math.pi
                if ori < end_ori - math.pi * 3 / 2:
                    ori += 2 * math.pi
                elif ori > end_ori + math.pi / 2:
                    ori -= 2 * math.pi
            rel_time[i] = (ori - start_ori) / ori_diff

        # calculateSmoothness (featureAssociation.cpp:621-641): arrays outside
        # [5, size-5) keep their zero initial state (reference: stale values).
        curvature = np.zeros(size, np.float32)
        picked = np.zeros(size, np.uint8)
        labels = np.zeros(size, np.int8)
        smooth_val = np.zeros(size, np.float32)
        smooth_ind = np.arange(size, dtype=np.int32)
        hw = feat.curvature_halfwin
        for i in range(hw, size - hw):
            acc = -2.0 * hw * seg_rng[i]
            for k in range(1, hw + 1):
                acc += seg_rng[i - k] + seg_rng[i + k]
            curvature[i] = acc * acc
            smooth_val[i] = curvature[i]
            smooth_ind[i] = i

        # markOccludedPoints (featureAssociation.cpp:643-678)
        for i in range(5, size - 6):
            depth1, depth2 = seg_rng[i], seg_rng[i + 1]
            col_diff = abs(int(seg_col[i + 1]) - int(seg_col[i]))
            if col_diff < feat.occlusion_col_gap:
                if depth1 - depth2 > feat.occlusion_range_jump:
                    picked[i - 5:i + 1] = 1
                elif depth2 - depth1 > feat.occlusion_range_jump:
                    picked[i + 1:i + 7] = 1
            diff1 = abs(float(seg_rng[i - 1]) - float(seg_rng[i]))
            diff2 = abs(float(seg_rng[i + 1]) - float(seg_rng[i]))
            if (diff1 > feat.parallel_beam_frac * seg_rng[i]
                    and diff2 > feat.parallel_beam_frac * seg_rng[i]):
                picked[i] = 1
        picked_after_occl = picked.copy()

        # extractFeatures (featureAssociation.cpp:680-784).  Pick caps follow
        # the passed FeatureConfig (the reference hard-codes 2/20/4).
        def suppress(ind):
            picked[ind] = 1
            for sgn in (1, -1):
                for d in range(1, 6):
                    a, b = ind + sgn * d, ind + sgn * d - sgn
                    if a < 0 or a >= size:
                        break
                    if abs(int(seg_col[a]) - int(seg_col[b])) > \
                            feat.occlusion_col_gap:
                        break
                    picked[a] = 1

        sharp, less_sharp, flat, less_flat = [], [], [], []
        sections = feat.sections
        for i in range(n):
            for j in range(sections):
                sp = (start_ring[i] * (sections - j)
                      + end_ring[i] * j) // sections
                ep = (start_ring[i] * (sections - 1 - j)
                      + end_ring[i] * (j + 1)) // sections - 1
                if sp >= ep:
                    continue
                # reference sorts smoothness[sp, ep) — ep EXCLUSIVE (its
                # std::sort end iterator is begin()+ep) — so position ep
                # keeps its unsorted (value, ind) pair but IS visited below.
                entries = [(float(smooth_val[k]), int(smooth_ind[k]))
                           for k in range(sp, ep)]
                entries.sort(key=lambda t: t[0])
                row_vals = [ind for _, ind in entries] + [int(smooth_ind[ep])]
                # edge picks, descending curvature (k = ep .. sp)
                n_edge = 0
                for k in range(ep, sp - 1, -1):
                    ind = int(row_vals[k - sp])
                    if (picked[ind] == 0
                            and curvature[ind] > feat.edge_threshold
                            and not seg_ground[ind]):
                        n_edge += 1
                        if n_edge <= feat.edge_per_section:
                            labels[ind] = 2
                            sharp.append(ind)
                            less_sharp.append(ind)
                        elif n_edge <= feat.edge_less_per_section:
                            labels[ind] = 1
                            less_sharp.append(ind)
                        else:
                            break
                        suppress(ind)
                # flat picks, ascending curvature (k = sp .. ep)
                n_flat = 0
                for k in range(sp, ep + 1):
                    ind = int(row_vals[k - sp])
                    if (picked[ind] == 0
                            and curvature[ind] < feat.surf_threshold
                            and seg_ground[ind]):
                        labels[ind] = -1
                        flat.append(ind)
                        n_flat += 1
                        if n_flat >= feat.surf_per_section:
                            break  # reference quirk: last pick unsuppressed
                        suppress(ind)
                # less-flat: POSITIONAL k (not sorted ind) with label <= 0
                for k in range(sp, ep + 1):
                    if labels[k] <= 0:
                        less_flat.append(k)

        def cells(ind_list):
            return seg_cell[np.asarray(ind_list, np.int64)] if ind_list \
                else np.zeros(0, np.int32)

        return OracleResult(
            range_mat=range_mat, full_idx=full_idx, ground_mat=ground_mat,
            label_mat=label_mat, seg_row=seg_row, seg_col=seg_col,
            seg_rng=seg_rng, seg_ground=seg_ground, seg_cell=seg_cell,
            start_ring_index=start_ring, end_ring_index=end_ring,
            outlier_cells=np.asarray(outlier_cells, np.int32),
            rel_time=rel_time, curvature=curvature,
            neighbor_picked=picked_after_occl, label=labels,
            sharp_cells=cells(sharp), less_sharp_cells=cells(less_sharp),
            flat_cells=cells(flat), less_flat_cells=cells(less_flat))
