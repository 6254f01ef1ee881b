"""Streaming incremental blocking: micro-batch ingest + candidate queries
over persistent Hashed-Dynamic-Blocking state.

Port of the JAX package's ``streaming/``. The batch driver
(``core/hdb.py``) re-derives everything per run; this package keeps the
state resident, so records arriving continuously cost work in proportion
to what they change, not to the corpus. Two operations:
``ingest(records)`` (a micro-batch of new rows) and ``query(record)``
(candidate ids for a probe, read-only).

- ``store.BlockStore``: per level, the union's iteration state (host
  numpy rows), the level's Count-Min Sketch (an int32 tensor on the
  store's device, kept by linear fold-in/fold-out) and its exact key
  table; globally the accepted-blocks CSR and the candidate-pair ledger.
- ``delta.DeltaBlocker``: replays Algorithms 1-4 only where a delta can
  have changed a decision; the result equals one batch run on the union.
- ``engine.StreamingEngine``: the slot-scheduled front-end, with optional
  matcher scoring of each ingest's new pairs.

- ``shard.ShardedBlockStore``: the same surface over N fingerprint-routed
  ``StoreShard``s (``ShardRouter``, host owner grouping); a mesh is not
  ported yet.
"""
from .store import BlockStore, LevelState  # noqa: F401
from .delta import DeltaBlocker, IngestReport, QueryResult  # noqa: F401
from .engine import StreamingEngine, RecordBatch  # noqa: F401
from .shard import ShardedBlockStore, ShardRouter, StoreShard  # noqa: F401
