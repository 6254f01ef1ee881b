"""Serving front-ends of the port: the LM continuous-batching engine
(``engine``) and the dedupe probe service (``service``), built on the
shared slot-scheduler helpers (``scheduler``), the padded-bucket ladder
(``buckets``), and the metrics registry (``metrics``).

The same names as the JAX package's ``serving``. Re-exports are lazy so
the two front-ends stay independent: importing the ``DedupeService`` does
not pull in the model code, and importing the LM ``ServingEngine`` does
not pull in the streaming subsystem (which itself imports ``scheduler``
from this package — laziness also breaks that cycle).
"""
from __future__ import annotations

import importlib

_EXPORTS = {
    # dedupe probe service
    "DedupeService": "service",
    "ServiceConfig": "service",
    "Tenant": "service",
    "ProbeRequest": "service",
    "ProbeResponse": "service",
    "IngestRequest": "service",
    "IngestResponse": "service",
    "BackpressureError": "service",
    "STATUS_OK": "service",
    "STATUS_EXPIRED": "service",
    # shared pieces
    "Metrics": "metrics",
    "Counter": "metrics",
    "Histogram": "metrics",
    "BucketLadder": "buckets",
    "pad_probe_rows": "buckets",
    "collate_fifo": "scheduler",
    "drain": "scheduler",
    # LM engine
    "ServingEngine": "engine",
    "Request": "engine",
    "Result": "engine",
}


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f".{module}", __name__), name)
    globals()[name] = value   # cache: subsequent lookups skip __getattr__
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
