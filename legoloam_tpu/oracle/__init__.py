"""Reference-parity oracle: a plain NumPy port of the reference's per-scan
RULES (not its architecture), used only by tests to machine-check behavior
parity of the JAX pipeline.  Never imported by the pipeline itself."""

from .numpy_frontend import OracleFrontend, OracleResult  # noqa: F401
