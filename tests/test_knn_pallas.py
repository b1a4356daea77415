"""Triton k-NN kernel (interpret mode on the CPU) vs a float64 brute force
and the plain ``voxel.knn`` path, plus the platform choice in ``search``.

The kernel computes distances in difference form, so its distances match
float64 to f32 rounding and its index sets are exact up to exact ties.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from legoloam_tpu.ops.knn_pallas import BIG, knn_pallas, search
from legoloam_tpu.ops.voxel import knn


def _rand_sets(n_q=512, n_r=4096, offset=0.0):
    key = jax.random.PRNGKey(3)
    kq, kr, kv = jax.random.split(key, 3)
    q = jax.random.uniform(kq, (n_q, 3), minval=-30, maxval=30) + offset
    r = jax.random.uniform(kr, (n_r, 3), minval=-30, maxval=30) + offset
    qv = jnp.ones((n_q,), bool).at[7].set(False)
    rv = jax.random.uniform(kv, (n_r,)) > 0.1
    return q, qv, r, rv


def _brute64(q, r, rv, k):
    q, r, rv = (np.asarray(x) for x in (q, r, rv))
    d = ((q[:, None].astype(np.float64) - r[None]) ** 2).sum(-1)
    d[:, ~rv] = np.inf
    i = np.argsort(d, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(d, i, 1), i


@pytest.mark.parametrize("offset", [0.0, 70.0])
def test_knn_pallas_matches_float64(offset):
    """Exact 5-NN at the origin and 70 m out (difference form: no
    cancellation, no recentering needed)."""
    q, qv, r, rv = _rand_sets(offset=offset)
    d_p, i_p = knn_pallas(q, qv, r, rv, k=5, interpret=True)
    D, I = _brute64(q, r, rv, 5)
    ok = np.asarray(qv)
    np.testing.assert_allclose(np.asarray(d_p)[ok], D[ok], atol=2e-4,
                               rtol=1e-5)
    assert (np.asarray(i_p)[ok] == I[ok]).all()
    d_x, i_x = knn(q, qv, r, rv, k=5)
    assert (np.asarray(i_x)[ok] == np.asarray(i_p)[ok]).mean() > 0.99


def test_knn_pallas_gated_culling_exact_within_gate():
    """With a gate, results must be exact for every query whose true 5th
    neighbor is inside the gate — regardless of reference ordering."""
    q, qv, r, rv = _rand_sets()
    # Spatially sort the references (what voxel_downsample's Morton order
    # provides in production) so culling actually skips chunks.
    order = jnp.argsort(r[:, 0] + 1000.0 * jnp.floor(r[:, 1] / 5.0))
    r_s, rv_s = r[order], rv[order]
    d_g, i_g = knn_pallas(q, qv, r_s, rv_s, k=5, gate=5.0, interpret=True)
    D, I = _brute64(q, r, rv, 5)
    back = np.asarray(order)[np.asarray(i_g)]     # sorted idx -> original idx
    rows = (D[:, 4] < 25.0) & np.asarray(qv)
    assert rows.sum() > 100
    np.testing.assert_allclose(np.asarray(d_g)[rows], D[rows], atol=1e-5,
                               rtol=1e-5)
    assert (back[rows] == I[rows]).all()


def test_knn_pallas_gate_decision_matches():
    """The caller's acceptance test d[:,4] < gate² must be decided
    identically with and without culling."""
    q, qv, r, rv = _rand_sets(n_q=256, n_r=2048)
    D, _ = _brute64(q, r, rv, 5)
    d_g, _ = knn_pallas(q, qv, r, rv, k=5, gate=1.0, interpret=True)
    ok = np.asarray(qv)
    assert ((np.asarray(d_g[:, 4]) < 1.0) == (D[:, 4] < 1.0))[ok].all()


def test_knn_pallas_invalid_query_rows():
    q = jnp.zeros((256, 3))
    r = jnp.ones((2048, 3))
    qv = jnp.zeros((256,), bool)
    rv = jnp.ones((2048,), bool)
    d, i = knn_pallas(q, qv, r, rv, k=5, interpret=True)
    assert bool((d >= BIG).all())


def test_knn_pallas_all_refs_invalid():
    q = jnp.zeros((256, 3))
    r = jnp.ones((2048, 3))
    qv = jnp.ones((256,), bool)
    rv = jnp.zeros((2048,), bool)
    d, i = knn_pallas(q, qv, r, rv, k=5, gate=1.0, interpret=True)
    # No candidate at all -> every slot holds the BIG sentinel.
    assert bool((d[:, 4] >= 1.0).all())
    assert bool((d >= BIG).all())


@pytest.mark.parametrize("n_q,n_r,k", [(1, 7, 1), (37, 200, 5), (130, 129, 3)])
def test_knn_pallas_pads_partial_tiles(n_q, n_r, k):
    """Shapes that are not whole tiles (and k not a power of two) are padded
    in the wrapper with invalid points; the result has the caller's shape
    and never returns a padding index."""
    key = jax.random.PRNGKey(n_q + n_r)
    q = jax.random.normal(key, (n_q, 3)) * 3.0
    r = jax.random.normal(jax.random.fold_in(key, 1), (n_r, 3)) * 3.0
    qv = jnp.ones((n_q,), bool)
    rv = jnp.ones((n_r,), bool)
    d, i = knn_pallas(q, qv, r, rv, k=k, interpret=True)
    assert d.shape == (n_q, k) and i.shape == (n_q, k)
    D, I = _brute64(q, r, rv, k)
    kk = min(k, n_r)
    assert (np.asarray(i)[:, :kk] == I[:, :kk]).all()
    assert (np.asarray(i) < n_r).all()
    np.testing.assert_allclose(np.asarray(d)[:, :kk], D[:, :kk], atol=1e-5)


def _lowered(platform, k, gate):
    q, qv, r, rv = _rand_sets(n_q=64, n_r=256)
    fn = jax.jit(lambda a, b, c, d: search(a, b, c, d, k=k, gate=gate))
    exp = jax.export.export(
        fn, platforms=[platform],
        disabled_checks=[jax.export.DisabledSafetyCheck.custom_call(
            "__gpu$xla.gpu.triton")])(q, qv, r, rv)
    return exp.mlir_module()


@pytest.mark.parametrize("k,gate", [(5, 1.0), (1, None)])
def test_search_picks_kernel_on_cuda_only(k, gate):
    """``search`` lowers to the Triton kernel for CUDA (this also proves the
    kernel's Triton lowering succeeds) and to the plain path elsewhere."""
    assert "xla.gpu.triton" in _lowered("cuda", k, gate)
    assert "xla.gpu.triton" not in _lowered("cpu", k, gate)


def test_search_on_cpu_equals_plain_knn():
    q, qv, r, rv = _rand_sets(n_q=128, n_r=1024)
    d_s, i_s = jax.jit(lambda *a: search(*a, k=5, gate=1.0))(q, qv, r, rv)
    d_x, i_x = knn(q, qv, r, rv, k=5)
    np.testing.assert_array_equal(np.asarray(d_s), np.asarray(d_x))
    np.testing.assert_array_equal(np.asarray(i_s), np.asarray(i_x))
