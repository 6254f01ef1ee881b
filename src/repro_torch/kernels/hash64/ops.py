"""Public hash64 ops, the names the JAX package's ``kernels/hash64/ops.py``
exports; the port's callers (``core/hashing.mix64``,
``core/hdb.intersect_keys``) reach the kernels through this module."""
from .hash64 import combine64, mix64_bulk  # noqa: F401
