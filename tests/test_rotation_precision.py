"""Regression guards for the rotation-precision root cause (round 3).

3x3 rotation matmuls inherit the backend matmul precision; a reduced
precision (bf16_3x) carries a systematic ~1e-5 contraction per product, which random-walks accumulated pose rotations off SO(3) over
thousands of compositions (measured: mapped-pose det 0.85 after 130 scans,
driving the no-IMU ring-world mapping runaway).  The fixes under guard here:

  * ``se3.mat3_mul`` / ``se3.rotate_vec`` everywhere rotations compose —
    elementwise expansions whose jaxprs must contain NO ``dot_general``
    (backend-independent check: CPU f32 matmuls are exact, so a numeric
    test could not catch a reintroduced ``@`` on CPU).
  * ``se3.so3_project`` orthonormality insurance on accumulated rotations.
"""

import jax
import jax.numpy as jnp
import numpy as np

from legoloam_tpu.ops import se3
from legoloam_tpu.ops.se3 import Pose


def _jaxpr_has_dot(fn, *args):
    return "dot_general" in str(jax.make_jaxpr(fn)(*args))


def test_rotation_composition_lowering_has_no_matmul():
    """compose / retract_about / euler_zyx_to_mat / so3_exp / se3_exp must
    lower to elementwise ops only — a ``@`` would reintroduce the
    precision-dependent contraction on an accelerator."""
    p = Pose(jnp.eye(3), jnp.zeros(3))
    xi = jnp.zeros(6)
    assert not _jaxpr_has_dot(se3.compose, p, p)
    assert not _jaxpr_has_dot(se3.retract, p, xi)
    assert not _jaxpr_has_dot(se3.retract_about, p, xi, jnp.zeros(3))
    assert not _jaxpr_has_dot(
        se3.euler_zyx_to_mat, jnp.float32(0.1), jnp.float32(0.2),
        jnp.float32(0.3))
    assert not _jaxpr_has_dot(se3.so3_exp, jnp.zeros(3))
    assert not _jaxpr_has_dot(se3.se3_exp, xi)
    assert not _jaxpr_has_dot(se3.so3_project, jnp.eye(3))
    assert not _jaxpr_has_dot(se3.project_through_correction, p, p, p)


def test_mat3_mul_matches_matmul():
    rng = np.random.RandomState(0)
    A = rng.randn(4, 3, 3).astype(np.float32)
    B = rng.randn(4, 3, 3).astype(np.float32)
    np.testing.assert_allclose(np.asarray(se3.mat3_mul(A, B)),
                               A @ B, rtol=1e-6, atol=1e-6)


def test_so3_project_restores_orthonormality():
    rng = np.random.RandomState(1)
    w = rng.randn(3).astype(np.float32) * 0.7
    Q = np.asarray(se3.so3_exp(jnp.asarray(w)))
    # Contaminate with the measured failure mode: uniform scale + mild shear.
    E = np.eye(3, dtype=np.float32) * (1 - 3e-3) \
        + rng.randn(3, 3).astype(np.float32) * 3e-4
    R_bad = (Q @ E).astype(np.float32)
    R_fix = np.asarray(se3.so3_project(jnp.asarray(R_bad)), np.float64)
    err = R_fix.T @ R_fix - np.eye(3)
    # One Newton step is quadratic: eps=3e-3 contamination -> O(eps^2)~1e-5
    # residual (in-pipeline per-step drift is ~1e-6, where one step cleans
    # to f32 rounding — test_accumulated_compose_stays_orthonormal).
    assert np.abs(err).max() < 1e-4, err
    # One step is quadratic: the result stays close to the true rotation.
    assert np.abs(R_fix - Q).max() < 5e-3


def test_accumulated_compose_stays_orthonormal():
    """2000 odometry-style compositions with the per-step projection keep
    det(R) at f32 rounding level (the runaway had det 0.85 at 130 scans)."""
    def step(R, _):
        m = se3.so3_exp(jnp.array([1e-3, -2e-3, 9e-3], jnp.float32))
        return se3.so3_project(se3.mat3_mul(R, m)), 0.0

    Rn, _ = jax.jit(
        lambda R: jax.lax.scan(step, R, None, length=2000))(jnp.eye(3))
    Rn = np.asarray(Rn, np.float64)
    assert abs(np.linalg.det(Rn) - 1.0) < 1e-5
    assert np.abs(Rn.T @ Rn - np.eye(3)).max() < 1e-5
