from .ops import (compact_matched, fused_match_pairs, packed_host,  # noqa: F401
                  pair_jaccard, score_lanes)
from .match import LANES, match_tiles, match_tiles_torch  # noqa: F401
