"""Public minhash op, the name the JAX package's ``kernels/minhash/ops.py``
exports; ``core/minhash.minhash_tokens`` reaches the kernel through this
module."""
from .minhash import minhash  # noqa: F401
