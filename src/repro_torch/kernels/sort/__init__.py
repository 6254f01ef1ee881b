from .ops import MIN_PASSES, SORT_BACKENDS, sort_words  # noqa: F401
from .radix import (MAX_PASSES, RADIX_BITS, digit_counts,  # noqa: F401
                    digit_counts_torch, sort_pass, sort_pass_torch)
