"""Stevens-scale keyframe store on the virtual 8-device mesh.

`parallel/mapping_dist.py` claims the 20K-keyframe Stevens-scale map
(reference `README.md:104-106`: >20K scans) fits a sharded
mesh with room to spare; this EXECUTES that configuration instead of
asserting it: a 16384-capacity store holding 16000 synthetic keyframes on an
8-device mesh, with scaled-down per-keyframe cloud caps so the test stays
CPU-sized (the sharding math is cap-independent).

Checks:
  * per-device cloud bytes are M/n_dev-sized (memory actually shards);
  * the distributed submap selection at high keyframe count covers the
    single-device `extract_submap` voxel set (top-k + dedup stay correct
    when 16K candidates compete);
  * the per-step collective payload (submap all_gather bytes) is recorded.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from legoloam_tpu.config import DEFAULT
from legoloam_tpu.models import mapping
from legoloam_tpu.parallel import mesh as mesh_mod, pipeline_dist

M_CAP = 16384
N_KF = 16000
CFG_M = dataclasses.replace(
    DEFAULT.mapping, max_keyframes=M_CAP,
    scan_corner_cap=64, scan_surf_cap=256,
    submap_corner_cap=8192, submap_surf_cap=32768)


def _big_store():
    """16000 keyframes along a 4.8 km serpentine path, tiny clouds."""
    rng = np.random.RandomState(7)
    k = np.arange(N_KF, dtype=np.float32)
    # 0.3 m keyframe spacing, serpentine rows 60 m apart: a dense revisit
    # neighborhood — a 50 m radius around late keyframes sees thousands of
    # in-radius candidates across many rows.
    row = np.floor(k * 0.3 / 120.0)
    along = (k * 0.3) % 120.0
    x = np.where(row % 2 == 0, along, 120.0 - along)
    t = np.stack([x, row * 6.0, np.full_like(k, 0.8)], axis=1)
    yaw = np.where(row % 2 == 0, 0.0, np.pi).astype(np.float32)
    c, s = np.cos(yaw), np.sin(yaw)
    z = np.zeros_like(c)
    o = np.ones_like(c)
    R = np.stack([np.stack([c, -s, z], -1), np.stack([s, c, z], -1),
                  np.stack([z, z, o], -1)], axis=1).astype(np.float32)

    kf = mapping.init_state(CFG_M).kf
    corner = rng.randn(N_KF, CFG_M.scan_corner_cap, 3).astype(np.float32) * 8
    surf = rng.randn(N_KF, CFG_M.scan_surf_cap, 3).astype(np.float32) * 15
    return kf._replace(
        R=kf.R.at[:N_KF].set(jnp.asarray(R)),
        t=kf.t.at[:N_KF].set(jnp.asarray(t)),
        time=kf.time.at[:N_KF].set(jnp.asarray(k * 0.3)),
        corner=kf.corner.at[:N_KF].set(jnp.asarray(corner)),
        corner_valid=kf.corner_valid.at[:N_KF].set(True),
        surf=kf.surf.at[:N_KF].set(jnp.asarray(surf)),
        surf_valid=kf.surf_valid.at[:N_KF].set(True),
        count=jnp.int32(N_KF))


@pytest.mark.slow
def test_16k_keyframes_shard_and_match_single_device():
    mesh = mesh_mod.make_mesh(8)
    kf = _big_store()
    dkf = pipeline_dist.from_keyframe_store(kf, mesh)

    # --- memory actually shards: each device holds M/8 cloud rows ---
    for name in ("corner", "surf"):
        arr = getattr(dkf, name)
        shards = arr.addressable_shards
        assert len(shards) == 8
        for sh in shards:
            assert sh.data.shape[0] == M_CAP // 8, sh.data.shape
    total_cloud_mb = (kf.corner.size + kf.surf.size) * 4 / 2**20
    per_dev_mb = total_cloud_mb / 8
    # At full VLP-16 caps (2048/8192 pts) the same layout scales to
    # 16384 x 10240 x 3 x 4 B = 1.9 GB total, 120 MB/device on 16 devices.

    # --- submap selection correctness at high count ---
    center = kf.t[N_KF - 100]
    (c1, cv1), (s1, sv1) = mapping.extract_submap(kf, center, CFG_M)
    (c2, cv2), (s2, sv2) = pipeline_dist.extract_submap_dist(
        dkf, center, CFG_M, mesh)

    def cells(pts, ok, leaf):
        q = np.floor(np.asarray(pts)[np.asarray(ok)] / leaf).astype(np.int64)
        return set(map(tuple, q))

    ref_c = cells(c1, cv1, CFG_M.corner_leaf)
    ref_s = cells(s1, sv1, CFG_M.surf_leaf)
    missing_c = ref_c - cells(c2, cv2, CFG_M.corner_leaf)
    missing_s = ref_s - cells(s2, sv2, CFG_M.surf_leaf)
    # Selection is replicated-exact (same keyframe set as single-device);
    # caps are sized so neither side truncates (random clouds never share
    # voxels, so any cap pressure would show as spurious disagreement).
    assert len(missing_c) <= max(4, 0.01 * len(ref_c)), len(missing_c)
    assert len(missing_s) <= max(4, 0.01 * len(ref_s)), len(missing_s)

    # --- collective payload accounting (the submap all_gather) ---
    gathered_mb = (c2.size + s2.size + cv2.size / 4 + sv2.size / 4) \
        * 4 / 2**20
    print(f"[scale] {N_KF} keyframes, cloud state {total_cloud_mb:.1f} MB "
          f"({per_dev_mb:.1f} MB/device), submap all_gather payload "
          f"{gathered_mb:.2f} MB/mapping step")
