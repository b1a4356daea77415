"""Device-mesh helpers for the distributed subsystems.

The reference's only "distribution" is four single-host ROS processes over
TCPROS (SURVEY.md §2 parallelism inventory); the rebuild's first-class axes
(BASELINE.json config 5) are:

  * ``data``  — scan/pipeline parallelism: independent frontend work
    (projection/segmentation/features) for different scans on different chips.
  * ``factor`` (same physical axis, different name in shard_map specs) — the
    pose-graph factor axis and keyframe/map-block axis for the distributed
    mapping backend.

The mesh is flat: on one host the GPUs are joined all to all by NVLink, so
every device reaches every other at the same rate and the mesh follows the
algorithm alone; across hosts JAX's runtime carries the collectives
(jax.distributed).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(n_devices: int | None = None, axis: str = "data") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))
