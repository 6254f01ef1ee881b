from .ops import (PACK_RID_BITS, decode_block_local, decode_chunk,  # noqa: F401
                  dedupe_device, dedupe_packed_device, pack_sort_words,
                  pair_route_owner, radix_passes_for, unpack_words)
from .tri import (MAX_BLOCK_N, MAX_SEARCH_STEPS,  # noqa: F401
                  search_steps_for, tri_decode, tri_decode_torch)
