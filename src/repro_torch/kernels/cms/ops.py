"""Public cms op, the name the JAX package's ``kernels/cms/ops.py``
exports; ``core/sketches`` reaches the kernel through this module."""
from .cms import cms_update  # noqa: F401
