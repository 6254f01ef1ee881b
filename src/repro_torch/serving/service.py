"""DedupeService: async micro-batched blocking-probe service.

Port of the JAX package's ``serving/service.py``. The paper's pipeline
ends at a batch of candidate pairs; the north-star traffic shape is
millions of users issuing ``query_keys``-style probes against hot
``BlockStore``s. This front-end turns the streaming subsystem into that
service:

- **Admission lanes.** Every tenant gets a bounded read (probe) queue and
  a bounded write (ingest) queue. Probes never stall behind ingest ledger
  syncs: each ``step()`` serves one probe micro-batch AND one ingest
  micro-batch from the separate lanes. A full lane rejects at submit time
  (``BackpressureError``); a probe whose deadline expires while queued is
  shed with an explicit ``"expired"`` response. Nothing is silently
  dropped.
- **Padded-bucket batching.** Queued probes are collated (skip-scan FIFO,
  see ``scheduler.collate_fifo``) up to ``probe_slots`` rows and padded to
  a power-of-two ``BucketLadder`` rung, so the walk sees one shape per
  rung, not one per batch size. Batched results equal one-at-a-time
  ``DeltaBlocker.query_keys`` calls (tested for both ``include_probe``
  modes).
- **Per-tenant isolation.** N independent ``BlockStore``s behind one
  service, all on the service's device; round-robin fair-share across
  tenants with queued work, per lane, so one tenant's backlog cannot
  starve another's probes.
- **Metrics.** Counters + streaming histograms (``serving.metrics``)
  exported as a plain dict via ``snapshot()`` — QPS inputs, p50/p99 probe
  latency, batch occupancy, bucket shape count, queue depths, shed and
  reject counts. The contract is the reference's (its docs/SERVING.md);
  the clock is read at the same places, so under one deterministic clock
  the two services' latencies and snapshots are equal. Each step's lanes
  are ``serve.read`` and ``serve.write`` profiler ranges (the walk inside
  is ``stream.query``, the ingest ``stream.ingest``).

Keys are the port's ``(n, K)`` u64 matrices (int64 tensors from
``blocks.build_keys``, or numpy uint64/int64); a request keeps them on the
host. Ingest requests carry no deadline: the write lane is the durability
path (a shed ingest would silently fork the store from its callers'
view). Everything here is host-side scheduling; device work happens
inside the tenant's ``DeltaBlocker``.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Callable, Dict, List, Optional

import numpy as np
from torch.profiler import record_function

from ..core import hdb as hdb_mod
from ..data.components import ClusterResult, cluster_edges
from ..device import DeviceLike, resolve_device
from ..streaming.delta import (DeltaBlocker, IngestReport, QueryResult,
                               host_bool, host_u64)
from ..streaming.store import BlockStore, unpack_pair
from .buckets import BucketLadder, pad_probe_rows
from .metrics import Metrics
from .scheduler import collate_fifo, drain

STATUS_OK = "ok"
STATUS_EXPIRED = "expired"


class BackpressureError(RuntimeError):
    """Admission rejected: the target lane's bounded queue is full."""


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    probe_slots: int = 64          # max probe rows per micro-batch
    ingest_slots: int = 256        # max ingest rows per micro-batch
    max_read_queue: int = 1024     # queued probe requests per tenant
    max_write_queue: int = 256     # queued ingest requests per tenant
    min_bucket: int = 8            # smallest bucket-ladder rung
    default_deadline_s: Optional[float] = None   # probe deadline if unset
    sort_backend: str = "auto"     # pair-ledger dedupe-sort knob
    # > 1: tenants created by the service get a fingerprint-sharded
    # ShardedBlockStore (streaming/shard.py) instead of a single-host
    # BlockStore; results are bit-identical, the snapshot gains per-shard
    # occupancy/skew gauges
    n_shards: int = 1


@dataclasses.dataclass
class ProbeRequest:
    uid: int
    tenant: str
    keys: np.ndarray             # (n, K) uint64, as from build_keys
    valid: np.ndarray            # (n, K) bool
    include_probe: bool
    deadline: Optional[float]    # absolute clock time, None = no deadline
    submitted_at: float

    @property
    def num_rows(self) -> int:
        return int(self.valid.shape[0])


@dataclasses.dataclass
class IngestRequest:
    uid: int
    tenant: str
    keys: np.ndarray
    valid: np.ndarray
    submitted_at: float

    @property
    def num_rows(self) -> int:
        return int(self.valid.shape[0])


@dataclasses.dataclass
class ProbeResponse:
    uid: int
    tenant: str
    status: str                  # STATUS_OK | STATUS_EXPIRED
    results: List[QueryResult]   # one per probe row ([] when shed)
    latency_s: float             # submit -> response


@dataclasses.dataclass
class IngestResponse:
    uid: int
    tenant: str
    status: str
    report: IngestReport         # shared by requests coalesced into one batch
    first_rid: int               # rid assigned to this request's first row
    num_rows: int
    latency_s: float


@dataclasses.dataclass
class Tenant:
    """One isolated store + blocker + its two admission lanes."""

    name: str
    store: BlockStore
    blocker: DeltaBlocker
    read_q: List[ProbeRequest] = dataclasses.field(default_factory=list)
    write_q: List[IngestRequest] = dataclasses.field(default_factory=list)
    # last refresh_clusters() outcome (None until first refresh)
    clusters: Optional[ClusterResult] = None


class DedupeService:
    """Micro-batched probe/ingest service over per-tenant BlockStores."""

    def __init__(self, cfg: hdb_mod.HDBConfig = hdb_mod.HDBConfig(),
                 service: ServiceConfig = ServiceConfig(),
                 clock: Callable[[], float] = time.monotonic,
                 device: DeviceLike = None):
        self.hdb_cfg = cfg
        # every tenant's store lives here (None means the card)
        self.device = resolve_device(device)
        self.cfg = service
        self.ladder = BucketLadder(min_bucket=service.min_bucket)
        self.metrics = Metrics()
        self.probe_responses: List[ProbeResponse] = []
        self.ingest_responses: List[IngestResponse] = []
        self._clock = clock
        self._tenants: Dict[str, Tenant] = {}
        self._order: List[str] = []   # round-robin order (insertion)
        self._rr_read = 0
        self._rr_write = 0
        self._uid = 0
        # (bucket, key width, include_probe) walk shapes this service has
        # sent to the device steps (compile events in the reference)
        self._seen_shapes: set = set()

    # ------------------------------------------------------------------
    # tenants
    # ------------------------------------------------------------------

    def add_tenant(self, name: str,
                   store: Optional[BlockStore] = None) -> Tenant:
        if name in self._tenants:
            raise ValueError(f"tenant {name!r} already exists")
        if store is None:
            if self.cfg.n_shards > 1:
                from ..streaming.shard import ShardedBlockStore
                store = ShardedBlockStore(self.hdb_cfg,
                                          n_shards=self.cfg.n_shards,
                                          device=self.device)
            else:
                store = BlockStore(self.hdb_cfg, device=self.device)
        tenant = Tenant(name, store,
                        DeltaBlocker(store, sort_backend=self.cfg.sort_backend))
        self._tenants[name] = tenant
        self._order.append(name)
        return tenant

    def tenant(self, name: str) -> Tenant:
        """Existing tenant, or a fresh isolated store created on first use."""
        got = self._tenants.get(name)
        return got if got is not None else self.add_tenant(name)

    def refresh_clusters(self, name: str,
                         max_rounds: int = 64) -> ClusterResult:
        """Re-partition a tenant's pair ledger into entity clusters.

        Runs the device CC path (``components.cluster_edges``: min-label
        propagation to a fixed point or ``max_rounds``, then device
        survivor extraction) on the tenant store's device, over its exact
        packed ``a<<32|b`` ledger. Service tenants ingest pre-hashed keys, so
        this partitions the *candidate* graph — the blocking-level
        clusters that upper-bound any downstream matcher. The result is
        cached on the tenant and surfaced through ``snapshot()`` gauges;
        a truncated (non-converged) refresh bumps
        ``cluster_truncated_total`` — never silent.
        """
        t = self.tenant(name)
        t0 = self._clock()
        ma, mb = unpack_pair(t.store.led_pack)
        res = cluster_edges(int(t.store.num_records), ma, mb,
                            max_rounds=max_rounds, device=t.store.device)
        t.clusters = res
        self.metrics.counter("cluster_refreshes_total").inc()
        if not res.converged:
            self.metrics.counter("cluster_truncated_total").inc()
        self.metrics.histogram("cluster_refresh_s").record(
            self._clock() - t0)
        return res

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------

    def submit_probe(self, tenant: str, keys, valid,
                     include_probe: bool = False,
                     deadline_s: Optional[float] = None) -> int:
        """Queue a probe micro-batch on the tenant's read lane.

        ``deadline_s`` is relative to now (falls back to the config's
        ``default_deadline_s``); an expired request is shed with an
        explicit "expired" response instead of being walked. Raises
        ``BackpressureError`` when the lane is full. Returns the request
        uid; the response lands in ``probe_responses``.
        """
        t = self.tenant(tenant)
        if len(t.read_q) >= self.cfg.max_read_queue:
            self.metrics.counter("rejected_total").inc()
            raise BackpressureError(
                f"read lane full for tenant {tenant!r} "
                f"({self.cfg.max_read_queue} queued)")
        now = self._clock()
        if deadline_s is None:
            deadline_s = self.cfg.default_deadline_s
        self._uid += 1
        t.read_q.append(ProbeRequest(
            uid=self._uid, tenant=tenant, keys=host_u64(keys),
            valid=host_bool(valid), include_probe=bool(include_probe),
            deadline=None if deadline_s is None else now + deadline_s,
            submitted_at=now))
        return self._uid

    def submit_ingest(self, tenant: str, keys, valid) -> int:
        """Queue an ingest micro-batch on the tenant's write lane.

        Rids ``store.num_records..+n`` are assigned in service order when
        the batch lands (see ``IngestResponse.first_rid``). Raises
        ``BackpressureError`` when the lane is full.
        """
        t = self.tenant(tenant)
        if len(t.write_q) >= self.cfg.max_write_queue:
            self.metrics.counter("rejected_total").inc()
            raise BackpressureError(
                f"write lane full for tenant {tenant!r} "
                f"({self.cfg.max_write_queue} queued)")
        self._uid += 1
        t.write_q.append(IngestRequest(
            uid=self._uid, tenant=tenant, keys=host_u64(keys),
            valid=host_bool(valid), submitted_at=self._clock()))
        return self._uid

    # ------------------------------------------------------------------
    # scheduling
    # ------------------------------------------------------------------

    @property
    def busy(self) -> bool:
        return any(t.read_q or t.write_q for t in self._tenants.values())

    def queue_depths(self) -> Dict[str, int]:
        return {"read": sum(len(t.read_q) for t in self._tenants.values()),
                "write": sum(len(t.write_q) for t in self._tenants.values())}

    def step(self) -> None:
        """Shed expired probes, then serve one probe micro-batch and one
        ingest micro-batch (read lane first: probes don't wait on syncs)."""
        self._shed_expired()
        with record_function("serve.read"):
            self._step_read()
        with record_function("serve.write"):
            self._step_write()

    def run(self, max_steps: int = 10_000):
        """Drain both lanes; warn if ``max_steps`` truncates the drain."""
        drain(self, max_steps)
        if self.busy:
            depths = self.queue_depths()
            warnings.warn(
                f"DedupeService.run stopped at max_steps={max_steps} with "
                f"{depths['read']} probe and {depths['write']} ingest "
                "requests still queued; call run() again to finish",
                RuntimeWarning, stacklevel=2)
        return self.probe_responses, self.ingest_responses

    def snapshot(self) -> dict:
        """Metrics snapshot (plain dict) with live queue-depth gauges.

        Tenants on sharded stores add occupancy gauges: ``store_shards``
        (max shard count), ``store_shard_skew_max`` (worst max/mean
        per-shard byte skew; 1.0 == balanced), and the two never-silent
        fallback counters (routed ledger syncs and routed key-table
        exchanges that dropped to the lossless host path). Tenants that
        have run ``refresh_clusters`` add ``clustered_tenants`` /
        ``cluster_components`` / ``cluster_rounds_max`` gauges alongside
        the ``cluster_refreshes_total`` / ``cluster_truncated_total``
        counters.
        """
        depths = self.queue_depths()
        shards = 1
        skew = 1.0
        ledger_fb = exchange_fb = 0
        clustered = cluster_components = cluster_rounds_max = 0
        for t in self._tenants.values():
            ledger_fb += getattr(t.blocker, "routed_fallback_total", 0)
            router = getattr(t.store, "router", None)
            if router is not None:
                shards = max(shards, t.store.n_shards)
                skew = max(skew, t.store.shard_skew())
                exchange_fb += router.exchange_fallback_total
            if t.clusters is not None:
                clustered += 1
                cluster_components += len(t.clusters.survivors)
                cluster_rounds_max = max(cluster_rounds_max,
                                         t.clusters.rounds)
        return self.metrics.snapshot(
            read_queue_depth=depths["read"],
            write_queue_depth=depths["write"],
            tenants=len(self._tenants),
            store_shards=shards,
            store_shard_skew_max=skew,
            ledger_routed_fallback_total=ledger_fb,
            store_exchange_fallback_total=exchange_fb,
            clustered_tenants=clustered,
            cluster_components=cluster_components,
            cluster_rounds_max=cluster_rounds_max)

    # ------------------------------------------------------------------

    def _shed_expired(self) -> None:
        now = self._clock()
        for t in self._tenants.values():
            if not any(r.deadline is not None and now >= r.deadline
                       for r in t.read_q):
                continue
            live: List[ProbeRequest] = []
            for r in t.read_q:
                if r.deadline is not None and now >= r.deadline:
                    self.metrics.counter("shed_total").inc()
                    self.probe_responses.append(ProbeResponse(
                        r.uid, t.name, STATUS_EXPIRED, [],
                        now - r.submitted_at))
                else:
                    live.append(r)
            t.read_q[:] = live

    def _pick_tenant(self, start: int, lane: str) -> Optional[int]:
        """Next round-robin position (from ``start``) with queued work."""
        n = len(self._order)
        for k in range(n):
            i = (start + k) % n
            if getattr(self._tenants[self._order[i]], lane):
                return i
        return None

    def _step_read(self) -> None:
        i = self._pick_tenant(self._rr_read, "read_q")
        if i is None:
            return
        self._rr_read = (i + 1) % len(self._order)
        t = self._tenants[self._order[i]]
        # one walk serves one include_probe mode; the head picks it and
        # collation skip-scans past the other mode (FIFO per uid holds)
        mode = t.read_q[0].include_probe
        taken = collate_fifo(
            t.read_q, self.cfg.probe_slots,
            size_fn=lambda r: r.num_rows,
            group_fn=lambda r: r.uid,
            take_if=lambda r: r.include_probe == mode)
        if not taken:
            return
        rows = sum(r.num_rows for r in taken)
        keys = np.concatenate([r.keys for r in taken])
        valid = np.concatenate([r.valid for r in taken])
        bucket = self.ladder.bucket(rows)
        pad_k, pad_v = pad_probe_rows(keys, valid, bucket)
        shape = (bucket, pad_v.shape[1], mode)
        if shape not in self._seen_shapes:
            self._seen_shapes.add(shape)
            self.metrics.counter("bucket_compiles_total").inc()
        results = t.blocker.query_keys(pad_k, pad_v, include_probe=mode,
                                       n_real=rows)
        now = self._clock()
        self.metrics.counter("probe_batches_total").inc()
        self.metrics.counter("probe_rows_total").inc(rows)
        self.metrics.histogram("batch_occupancy", kind="unit").record(
            rows / bucket)
        self.metrics.histogram("probe_batch_rows", kind="count").record(rows)
        off = 0
        for r in taken:
            self.metrics.counter("probe_requests_total").inc()
            self.metrics.histogram("probe_latency_s").record(
                now - r.submitted_at)
            self.probe_responses.append(ProbeResponse(
                r.uid, t.name, STATUS_OK, results[off:off + r.num_rows],
                now - r.submitted_at))
            off += r.num_rows

    def _step_write(self) -> None:
        i = self._pick_tenant(self._rr_write, "write_q")
        if i is None:
            return
        self._rr_write = (i + 1) % len(self._order)
        t = self._tenants[self._order[i]]
        taken = collate_fifo(
            t.write_q, self.cfg.ingest_slots,
            size_fn=lambda r: r.num_rows,
            group_fn=lambda r: r.uid)
        if not taken:
            return
        keys = np.concatenate([r.keys for r in taken])
        valid = np.concatenate([r.valid for r in taken])
        first_rid = t.store.num_records
        report = t.blocker.ingest_keys(keys, valid)
        now = self._clock()
        self.metrics.counter("ingest_batches_total").inc()
        self.metrics.counter("ingest_rows_total").inc(int(valid.shape[0]))
        off = 0
        for r in taken:
            self.metrics.counter("ingest_requests_total").inc()
            self.metrics.histogram("ingest_latency_s").record(
                now - r.submitted_at)
            self.ingest_responses.append(IngestResponse(
                r.uid, t.name, STATUS_OK, report, first_rid + off,
                r.num_rows, now - r.submitted_at))
            off += r.num_rows
