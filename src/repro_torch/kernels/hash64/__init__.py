from .hash64 import (COMBINE_KERNEL, GAMMA, MIX_KERNEL,  # noqa: F401
                     combine64_torch, mix64_torch)
from .ops import combine64, mix64_bulk  # noqa: F401
