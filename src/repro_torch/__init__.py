"""PyTorch/CUDA port of the Hashed Dynamic Blocking dedup stack.

Mirrors the layout of the JAX package (``core/``, ``kernels/<name>/``,
``data/``). Entry points take ``device=None``, which means ``"cuda"``;
without a CUDA device they raise unless the caller asks for ``"cpu"``.
"""
from .device import resolve_device  # noqa: F401
