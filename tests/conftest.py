"""Test harness config: force CPU with 8 virtual devices BEFORE jax import.

Mirrors SURVEY.md §4's "multi-host without a cluster" strategy: sharding and
collective paths are unit-tested on a virtual 8-device CPU mesh
(``--xla_force_host_platform_device_count``); GPU numbers come from
``chip_smoke.py`` and ``bench.py`` on the card.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
# The XLA:CPU AOT loader logs a benign per-entry ERROR when replaying cached
# executables ("+prefer-no-scatter ... not supported on the host machine" —
# an XLA tuning pseudo-feature the host-feature check doesn't know about);
# silence it so cached runs aren't drowned in spam.
os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")

import jax  # noqa: E402

# Persistent compilation cache: the suite compiles the same pipeline programs
# in every xdist worker / process; replaying them from disk cuts suite
# wall-clock ~2-3x.  Safe to delete any time.
from legoloam_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
jax.config.update("jax_enable_x64", False)

assert jax.default_backend() == "cpu", "tests must run on the virtual CPU mesh"
assert jax.device_count() == 8, "expected 8 virtual CPU devices"
