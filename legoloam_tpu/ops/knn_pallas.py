"""Brute-force k-NN (k small: 5 for scan-to-map, 1 for ICP) as a Pallas
kernel for NVIDIA GPUs (``backend="triton"``), with AABB culling.

The plain path (``voxel.knn``) makes k passes, each recomputing the full
(Q, R) distance matrix through a K=3 ``dot`` with no culling.  This kernel
computes each distance once and keeps everything in registers:

  * one program per query tile; a loop inside the program walks the
    reference chunks (no cross-program carry);
  * a chunk whose bounding box lies farther than ``gate`` from the query
    tile's box cannot hold a neighbor that passes the caller's acceptance
    gate, so it is skipped.  With both point sets Morton-sorted
    (``voxel_downsample(..., origin=...)``) a tile touches a handful of chunks;
  * distances are computed in difference form, three FMAs per pair (K=3
    leaves nothing for the tensor cores), which is exact to f32 rounding at
    any world offset — no recentering, no refinement pass;
  * the running top-k is k register vectors per query, updated by sorted
    insertion; a chunk costs extraction rounds only while some query in the
    tile still improves.

Exactness contract (same as ``voxel.knn``): squared Euclidean distances and
indices sorted ascending; for every query whose true k-th neighbor lies
within ``gate`` the result is the exact k-NN (ties broken by lower index);
beyond the gate the k-th distance is only guaranteed to be >= gate², so the
acceptance test ``d[:, k-1] < gate**2`` (mapOptmization.cpp:1101,1183) is
decided identically.  Invalid queries get all-``BIG`` rows; slots with no
candidate hold ``BIG`` and index 0.

``search`` picks the kernel when the program is lowered for CUDA and the
plain path everywhere else (``lax.platform_dependent``, decided per lowering
platform, so a CPU mesh in a GPU process still gets the plain path).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from .voxel import knn

BIG = 1e30
_IMAX = 2**31 - 1
# Invalid points move to opposite far sentinels: any squared distance
# involving one is >= 3e30 > BIG, so it never enters a top-k list.
_FAR_Q = 1e15
_FAR_R = -1e15
_NO_GATE = 3e38            # finite: an empty chunk's infinite box still culls
_GATE_SLACK = 1.0 + 1e-5   # box distance vs pair distance rounding (FMA)
# Query tile, reference chunk and warps per program: the fastest of a sweep
# on an H100 at the scan-to-map and ICP shapes (PERF.md).  Small query tiles
# put many programs on every SM and cull more chunks.
_TQ, _RC, _NUM_WARPS = 8, 512, 2


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _insert(bd, bi, m, am):
    """Sorted insertion of (m, am) into the ascending per-query lists
    bd/bi (k vectors each); rows with m >= bd[-1] are unchanged."""
    nd, ni = [], []
    for j in range(len(bd)):
        here = m < bd[j]
        if j == 0:
            nd.append(jnp.where(here, m, bd[0]))
            ni.append(jnp.where(here, am, bi[0]))
        else:
            shift = m < bd[j - 1]
            nd.append(jnp.where(shift, bd[j - 1], jnp.where(here, m, bd[j])))
            ni.append(jnp.where(shift, bi[j - 1], jnp.where(here, am, bi[j])))
    return nd, ni


def _knn_kernel(qx_ref, qy_ref, qz_ref, qbox_ref, rx_ref, ry_ref, rz_ref,
                cbox_ref, d_ref, i_ref, *, k: int, kp: int, tq: int, rc: int,
                n_chunks: int, cull_sq: float):
    g = pl.program_id(0)
    qx, qy, qz = qx_ref[...], qy_ref[...], qz_ref[...]            # (TQ,)
    qlo = [qbox_ref[g, j] for j in range(3)]
    qhi = [qbox_ref[g, 3 + j] for j in range(3)]
    lane = jax.lax.broadcasted_iota(jnp.int32, (tq, rc), 1)

    def chunk(c, carry):
        bd, bi = carry
        mind = jnp.float32(0.0)
        for j in range(3):
            gap = jnp.maximum(jnp.maximum(qlo[j] - cbox_ref[c, 3 + j],
                                          cbox_ref[c, j] - qhi[j]), 0.0)
            mind = mind + gap * gap

        def scan_chunk(carry):
            bd, bi = carry
            sl = pl.ds(pl.multiple_of(c * rc, rc), rc)
            dx = qx[:, None] - rx_ref[sl][None, :]
            dy = qy[:, None] - ry_ref[sl][None, :]
            dz = qz[:, None] - rz_ref[sl][None, :]
            d = dx * dx + dy * dy + dz * dz                        # (TQ, RC)
            col = lane + c * rc
            m = jnp.min(d, axis=1)

            def improving(st):
                _, m, bd, _, r = st
                return (r < k) & (jnp.max((m < bd[-1]).astype(jnp.int32)) > 0)

            def extract(st):
                d, m, bd, bi, r = st
                am = jnp.min(jnp.where(d == m[:, None], col, _IMAX), axis=1)
                bd, bi = _insert(bd, bi, m, am)
                d = jnp.where(col == am[:, None], jnp.inf, d)
                return d, jnp.min(d, axis=1), bd, bi, r + 1

            _, _, bd, bi, _ = jax.lax.while_loop(
                improving, extract, (d, m, bd, bi, jnp.int32(0)))
            return bd, bi

        return jax.lax.cond(mind <= cull_sq, scan_chunk, lambda cr: cr,
                            (bd, bi))

    init = ([jnp.full((tq,), BIG, jnp.float32) for _ in range(k)],
            [jnp.zeros((tq,), jnp.int32) for _ in range(k)])
    bd, bi = jax.lax.fori_loop(0, n_chunks, chunk, init)

    row = jax.lax.broadcasted_iota(jnp.int32, (kp, tq), 0)
    d_out = jnp.full((kp, tq), BIG, jnp.float32)
    i_out = jnp.zeros((kp, tq), jnp.int32)
    for j in range(k):
        d_out = jnp.where(row == j, bd[j][None, :], d_out)
        i_out = jnp.where(row == j, bi[j][None, :], i_out)
    d_ref[...] = d_out
    i_ref[...] = i_out


def _boxes(pts: jax.Array, valid: jax.Array, size: int) -> jax.Array:
    """(n // size, 6) per-block [lo xyz, hi xyz] over the VALID points; an
    empty block gets lo=+inf, hi=-inf, which every box test rejects."""
    lo = jnp.where(valid[:, None], pts, jnp.inf).reshape(-1, size, 3)
    hi = jnp.where(valid[:, None], pts, -jnp.inf).reshape(-1, size, 3)
    return jnp.concatenate([lo.min(axis=1), hi.max(axis=1)], axis=1)


@functools.partial(jax.jit,
                   static_argnames=("k", "gate", "interpret"))
def knn_pallas(query: jax.Array, q_valid: jax.Array, ref: jax.Array,
               r_valid: jax.Array, k: int = 5, gate: float | None = None,
               interpret: bool = False):
    """``voxel.knn`` contract through the Triton kernel.  Any Q and R: the
    wrapper pads queries to a multiple of the query tile and references to
    a multiple of the chunk with invalid points.

    ``gate``: acceptance radius in meters (exact wherever the true k-th
    neighbor is closer); None disables culling."""
    q_n, r_n = query.shape[0], ref.shape[0]
    tq, rc = _TQ, _RC
    kp = _next_pow2(k)
    qp, rp = _round_up(q_n, tq), _round_up(r_n, rc)

    qv = jnp.zeros((qp,), bool).at[:q_n].set(q_valid)
    rv = jnp.zeros((rp,), bool).at[:r_n].set(r_valid)
    q = jnp.zeros((qp, 3), jnp.float32).at[:q_n].set(query)
    r = jnp.zeros((rp, 3), jnp.float32).at[:r_n].set(ref)
    qbox = _boxes(q, qv, tq)
    cbox = _boxes(r, rv, rc)
    q = jnp.where(qv[:, None], q, _FAR_Q)
    r = jnp.where(rv[:, None], r, _FAR_R)
    cull_sq = (_NO_GATE if gate is None
               else float(gate) ** 2 * _GATE_SLACK)

    n_q_tiles, n_chunks = qp // tq, rp // rc
    q_spec = pl.BlockSpec((tq,), lambda g: (g,))
    out_spec = pl.BlockSpec((kp, tq), lambda g: (0, g))
    d, i = pl.pallas_call(
        functools.partial(_knn_kernel, k=k, kp=kp, tq=tq, rc=rc,
                          n_chunks=n_chunks, cull_sq=cull_sq),
        grid=(n_q_tiles,),
        in_specs=[q_spec, q_spec, q_spec,
                  pl.BlockSpec((n_q_tiles, 6), lambda g: (0, 0)),
                  pl.BlockSpec((rp,), lambda g: (0,)),
                  pl.BlockSpec((rp,), lambda g: (0,)),
                  pl.BlockSpec((rp,), lambda g: (0,)),
                  pl.BlockSpec((n_chunks, 6), lambda g: (0, 0))],
        out_specs=(out_spec, out_spec),
        out_shape=(jax.ShapeDtypeStruct((kp, qp), jnp.float32),
                   jax.ShapeDtypeStruct((kp, qp), jnp.int32)),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=_NUM_WARPS,
                                                 num_stages=1),
        interpret=interpret,
        name="knn_culled",
    )(q[:, 0], q[:, 1], q[:, 2], qbox, r[:, 0], r[:, 1], r[:, 2], cbox)

    d = d[:k, :q_n].T
    i = i[:k, :q_n].T
    return jnp.where(q_valid[:, None], d, BIG), i


def search(query: jax.Array, q_valid: jax.Array, ref: jax.Array,
           r_valid: jax.Array, k: int, gate: float | None = None,
           q_tile: int = 8192):
    """k-NN for the pipeline: the Triton kernel where the program is lowered
    for CUDA, ``voxel.knn`` on every other platform.  ``gate`` only lets the
    kernel cull (see the module docstring); ``q_tile`` only tiles the plain
    path."""
    return jax.lax.platform_dependent(
        query, q_valid, ref, r_valid,
        cuda=functools.partial(knn_pallas, k=k, gate=gate),
        default=functools.partial(knn, k=k, q_tile=q_tile))
