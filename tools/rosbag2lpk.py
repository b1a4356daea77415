#!/usr/bin/env python
"""Convert a ROS1 bag of sensor_msgs/PointCloud2 (+ optional sensor_msgs/Imu)
into the replay formats this framework ingests: per-scan ``.lpk`` files
(``utils/io.py:write_lpk`` — the ``ScanLoader``/CLI input) and an ``IMU1``
sidecar (``utils/io.py:write_imu``).

The reference consumes rosbags directly over ROS topics
(reference ``README.md:90-102``: ``rosbag play *.bag --clock``,
``/velodyne_points`` + ``/imu/data``); there is no ROS in this environment,
so replay is bag -> files -> ``python -m legoloam_tpu --scans 'out/*.lpk'
--imu out/seq.imu``.

Self-contained ROS1 bag-format (V2.0) reader — no ROS dependencies:
record framing per http://wiki.ros.org/Bags/Format/2.0 (op codes: 0x03 bag
header, 0x05 chunk, 0x07 connection, 0x02 message data), 'none' and 'bz2'
chunk compression (bz2 via stdlib; lz4 bags are rejected with a clear
message).  PointCloud2 and Imu messages are decoded straight from their
serialized layout (md5-stable since ROS Indigo).

Usage:
  python tools/rosbag2lpk.py in.bag --out outdir \
      [--cloud-topic /velodyne_points] [--imu-topic /imu/data] \
      [--n-scan 16] [--ang-bottom 15.1] [--ang-res-y 2.0]

Ring channel: taken from the cloud's ``ring`` field when present
(useCloudRing path, ``src/imageProjection.cpp:165-177``); otherwise derived
from the vertical angle exactly like the reference's fallback
(``src/imageProjection.cpp:229-230``).
"""

import argparse
import bz2
import math
import os
import struct
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


# ---------------------------------------------------------------------------
# ROS1 bag record framing
# ---------------------------------------------------------------------------

def _parse_header(buf):
    """Bag record header: sequence of {u32 len}{name=value} fields."""
    fields = {}
    off = 0
    while off < len(buf):
        (flen,) = struct.unpack_from("<I", buf, off)
        off += 4
        kv = buf[off:off + flen]
        off += flen
        eq = kv.index(b"=")
        fields[kv[:eq].decode()] = kv[eq + 1:]
    return fields


def _iter_records(buf, offset=0):
    """Yield (header_fields, data_bytes) records from ``buf``."""
    n = len(buf)
    while offset + 8 <= n:
        (hlen,) = struct.unpack_from("<I", buf, offset)
        offset += 4
        hdr = _parse_header(buf[offset:offset + hlen])
        offset += hlen
        (dlen,) = struct.unpack_from("<I", buf, offset)
        offset += 4
        data = buf[offset:offset + dlen]
        offset += dlen
        yield hdr, data


def iter_bag_messages(path):
    """Yield (topic, msg_type, t_sec, raw_message_bytes) from a V2.0 bag."""
    with open(path, "rb") as f:
        magic = f.readline()
        if not magic.startswith(b"#ROSBAG V2.0"):
            raise IOError(f"not a ROS1 V2.0 bag: {path} ({magic[:20]!r})")
        buf = f.read()

    connections = {}

    def handle_stream(stream):
        for hdr, data in _iter_records(stream):
            op = hdr["op"][0]
            if op == 0x07:                      # connection
                conn = struct.unpack("<I", hdr["conn"])[0]
                topic = hdr["topic"].decode()
                chdr = _parse_header(data)
                connections[conn] = (topic, chdr.get("type",
                                                     b"?").decode())
            elif op == 0x02:                    # message data
                conn = struct.unpack("<I", hdr["conn"])[0]
                tsec, tnsec = struct.unpack("<II", hdr["time"])
                topic, typ = connections.get(conn, ("?", "?"))
                yield topic, typ, tsec + tnsec * 1e-9, data

    for hdr, data in _iter_records(buf):
        op = hdr["op"][0]
        if op == 0x05:                          # chunk
            comp = hdr.get("compression", b"none").decode()
            if comp == "none":
                chunk = data
            elif comp == "bz2":
                chunk = bz2.decompress(data)
            else:
                raise IOError(f"unsupported chunk compression {comp!r} "
                              f"(re-record with --bz2 or none)")
            yield from handle_stream(chunk)
        elif op == 0x07:                        # unchunked connection
            conn = struct.unpack("<I", hdr["conn"])[0]
            topic = hdr["topic"].decode()
            chdr = _parse_header(data)
            connections[conn] = (topic, chdr.get("type", b"?").decode())
        elif op == 0x02:                        # unchunked message
            conn = struct.unpack("<I", hdr["conn"])[0]
            tsec, tnsec = struct.unpack("<II", hdr["time"])
            topic, typ = connections.get(conn, ("?", "?"))
            yield topic, typ, tsec + tnsec * 1e-9, data


# ---------------------------------------------------------------------------
# Message decoding (serialized ROS1 layouts)
# ---------------------------------------------------------------------------

def _read_string(buf, off):
    (n,) = struct.unpack_from("<I", buf, off)
    off += 4
    return buf[off:off + n].decode(errors="replace"), off + n


_PF_DTYPES = {1: np.int8, 2: np.uint8, 3: np.int16, 4: np.uint16,
              5: np.int32, 6: np.uint32, 7: np.float32, 8: np.float64}


def decode_pointcloud2(buf):
    """sensor_msgs/PointCloud2 -> (stamp, {name: np array of the column})."""
    off = 4                                     # header.seq
    sec, nsec = struct.unpack_from("<II", buf, off)
    off += 8
    _, off = _read_string(buf, off)             # frame_id
    height, width = struct.unpack_from("<II", buf, off)
    off += 8
    (nfields,) = struct.unpack_from("<I", buf, off)
    off += 4
    fields = []
    for _ in range(nfields):
        name, off = _read_string(buf, off)
        foff, dt, cnt = struct.unpack_from("<IBI", buf, off)
        off += 9
        fields.append((name, foff, dt, cnt))
    is_bigendian = buf[off]
    off += 1
    point_step, row_step = struct.unpack_from("<II", buf, off)
    off += 8
    (dlen,) = struct.unpack_from("<I", buf, off)
    off += 4
    data = np.frombuffer(buf, np.uint8, count=dlen, offset=off)
    off += dlen
    if is_bigendian:
        raise IOError("big-endian PointCloud2 not supported")
    npts = height * width
    rows = data[:npts * point_step].reshape(npts, point_step)
    out = {}
    for name, foff, dt, cnt in fields:
        if dt not in _PF_DTYPES or cnt != 1:
            continue
        dtype = np.dtype(_PF_DTYPES[dt]).newbyteorder("<")
        nb = dtype.itemsize
        out[name] = rows[:, foff:foff + nb].copy().view(dtype).ravel()
    return sec + nsec * 1e-9, out


def decode_imu(buf):
    """sensor_msgs/Imu -> (stamp, quat xyzw, angular_velocity, linear_acc)."""
    off = 4
    sec, nsec = struct.unpack_from("<II", buf, off)
    off += 8
    _, off = _read_string(buf, off)
    quat = struct.unpack_from("<4d", buf, off)
    off += 32 + 72                              # orientation + its covariance
    gyro = struct.unpack_from("<3d", buf, off)
    off += 24 + 72
    acc = struct.unpack_from("<3d", buf, off)
    return sec + nsec * 1e-9, quat, gyro, acc


def quat_to_rpy(x, y, z, w):
    roll = math.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = math.asin(max(-1.0, min(1.0, 2 * (w * y - z * x))))
    yaw = math.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return roll, pitch, yaw


# ---------------------------------------------------------------------------
# Conversion
# ---------------------------------------------------------------------------

def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("bag")
    ap.add_argument("--out", required=True)
    ap.add_argument("--cloud-topic", default="/velodyne_points")
    ap.add_argument("--imu-topic", default="/imu/data")
    ap.add_argument("--n-scan", type=int, default=16)
    ap.add_argument("--ang-bottom", type=float, default=15.1)
    ap.add_argument("--ang-res-y", type=float, default=2.0)
    ap.add_argument("--limit", type=int, default=0,
                    help="stop after N scans (0 = all)")
    args = ap.parse_args()

    from legoloam_tpu.utils import io as lio

    os.makedirs(args.out, exist_ok=True)
    n_scans = 0
    t0 = None
    imu_t, imu_rpy, imu_acc, imu_gyro = [], [], [], []

    for topic, typ, _bag_t, raw in iter_bag_messages(args.bag):
        if topic == args.cloud_topic and typ.endswith("PointCloud2"):
            stamp, cols = decode_pointcloud2(raw)
            if t0 is None:
                t0 = stamp
            xyz = np.stack([cols["x"], cols["y"], cols["z"]],
                           axis=1).astype(np.float32)
            valid = np.isfinite(xyz).all(axis=1)
            if "ring" in cols:
                ring = cols["ring"].astype(np.uint16)
            else:
                # Reference fallback (src/imageProjection.cpp:229-230).
                horiz = np.hypot(xyz[:, 0], xyz[:, 1])
                vert = np.degrees(np.arctan2(xyz[:, 2],
                                             np.maximum(horiz, 1e-6)))
                ring = np.clip((vert + args.ang_bottom) / args.ang_res_y,
                               0, args.n_scan - 1).astype(np.uint16)
            lio.write_lpk(os.path.join(args.out, f"{n_scans:06d}.lpk"),
                          xyz[valid], ring[valid],
                          np.ones(int(valid.sum()), bool))
            n_scans += 1
            if args.limit and n_scans >= args.limit:
                break
        elif topic == args.imu_topic and typ.endswith("/Imu"):
            stamp, quat, gyro, acc = decode_imu(raw)
            imu_t.append(stamp)
            imu_rpy.append(quat_to_rpy(*quat))
            imu_gyro.append(gyro)
            imu_acc.append(acc)

    if imu_t and t0 is not None:
        t = np.asarray(imu_t) - t0              # scan-clock relative (f32-safe)
        keep = t >= -1.0
        lio.write_imu(os.path.join(args.out, "seq.imu"), t[keep],
                      np.asarray(imu_rpy)[keep], np.asarray(imu_acc)[keep],
                      np.asarray(imu_gyro)[keep])
        print(f"wrote {int(keep.sum())} IMU records -> seq.imu")
    print(f"wrote {n_scans} scans -> {args.out}/*.lpk")
    if n_scans:
        print(f"replay: python -m legoloam_tpu --scans '{args.out}/*.lpk'"
              + (f" --imu {args.out}/seq.imu" if imu_t else "")
              + " --out /tmp/run")


if __name__ == "__main__":
    main()
