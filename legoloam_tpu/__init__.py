"""legoloam_tpu — a LiDAR SLAM engine in JAX with the capabilities of LeGO-LOAM.

A from-scratch rebuild of the LeGO-LOAM pipeline (Shan & Englot, IROS 2018)
as a library of pure jitted JAX functions over dense fixed-shape arrays, run
on an NVIDIA GPU (tests run on the CPU):

  * ``ops/``      — per-scan kernels: projection, segmentation, de-skew, features,
                    voxel/NN search, batched LM linear algebra.
  * ``models/``   — the pipeline stages: two-step LM odometry, scan-to-map
                    optimization, pose graph + loop closure, pose fusion.
  * ``parallel/`` — mesh/sharding utilities and the distributed pose-graph solve.
  * ``utils/``    — synthetic worlds, dataset IO, trajectory metrics, profiling.

The reference's four ROS processes become jitted stages passing device arrays;
its PCL/OpenCV/gtsam dependencies are re-implemented from scratch on array
primitives (see SURVEY.md §2 for the component-by-component mapping).
"""

import jax as _jax

# Geometry demands true float32 matmuls.  Below "highest", a float32 dot may
# run with reduced-precision operands (TF32 on NVIDIA tensor cores keeps 10
# mantissa bits): at 70 m world coordinates a single ``transform_points``
# then errs by centimetres per point, which smears every keyframe cloud,
# corrupts the scan-to-map feedback and turns long trajectories into runaway
# drift.  The hot large matmuls request Precision.HIGHEST at their call sites
# anyway; this sets the same default for every other dot/einsum in the
# library — they are small or bandwidth-bound, so the cost is nil.  Callers
# wanting a faster precision for one op can still pass ``precision=`` there.
_jax.config.update("jax_default_matmul_precision", "highest")

from . import config                                              # noqa: E402
from .config import DEFAULT, PipelineConfig, SensorConfig         # noqa: E402

__version__ = "0.1.0"
__all__ = ["config", "DEFAULT", "PipelineConfig", "SensorConfig"]
