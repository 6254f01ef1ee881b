from .ops import MIN_PASSES, SORT_BACKENDS, sort_words  # noqa: F401
from .radix import (MAX_PASSES, RADIX, RADIX_BITS, TILE, digit_of,  # noqa: F401
                    radix_pass, radix_pass_torch)
