"""Arithmetic masked fills: ``x where keep else fill`` as a multiply-add.

``masked_fill(x, keep, fill) == jnp.where(keep, x, fill)`` for finite
``fill`` (0 * inf = NaN, so fills must be finite).  Callers on the hot path
use these helpers for large masked fills; ``jnp.where`` is equivalent.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def masked_fill(x: jax.Array, keep: jax.Array, fill) -> jax.Array:
    """x where keep else fill, as arithmetic: x*m + fill*(1-m).

    keep broadcasts against x; fill must be finite.  Works for float and int
    dtypes (int path uses multiply in the same dtype)."""
    m = keep.astype(x.dtype)
    return x * m + jnp.asarray(fill, x.dtype) * (1 - m)


def masked_fill_u32(x: jax.Array, keep: jax.Array, fill) -> jax.Array:
    m = keep.astype(jnp.uint32)
    return x * m + jnp.uint32(fill) * (jnp.uint32(1) - m)
