"""Serving metrics: counters + fixed-bin streaming histograms.

This package's own copy of the JAX package's ``serving/metrics.py``, so
that snapshots of the two equal each other float for float.

Pure-host bookkeeping (no torch import): a service records into ``Metrics``
on every step and exports ``snapshot()`` as a plain nested dict so benches
and tests can assert on it and serialize it as JSON verbatim.
Histograms are fixed-bin (log-spaced for latencies, linear for ratios):
O(1) per observation, O(bins) memory, and percentile estimates whose error
is bounded by the bin width — enough to tell p50 from p99 without keeping
per-request samples for millions of probes.
"""
from __future__ import annotations

import bisect
import math
from typing import Dict, List


class Counter:
    """Monotonic event counter."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Histogram:
    """Streaming histogram over fixed bin edges.

    ``counts[i]`` holds observations with ``edges[i-1] <= x < edges[i]``;
    the two extra slots catch under/overflow. Percentiles interpolate the
    bin midpoint, clamped to the observed [min, max] so small-count
    snapshots never report a value outside what was actually seen.
    """

    def __init__(self, edges: List[float]):
        if not edges or any(b <= a for a, b in zip(edges, edges[1:])):
            raise ValueError("edges must be strictly increasing and non-empty")
        self.edges = list(edges)
        self.counts = [0] * (len(edges) + 1)
        self.n = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    @classmethod
    def log(cls, lo: float, hi: float, per_decade: int = 5) -> "Histogram":
        """Log-spaced edges from ``lo`` to ``hi`` (for latency-like data)."""
        decades = math.log10(hi / lo)
        n = max(int(round(decades * per_decade)), 1)
        return cls([lo * 10.0 ** (decades * i / n) for i in range(n + 1)])

    @classmethod
    def linear(cls, lo: float, hi: float, nbins: int = 20) -> "Histogram":
        """Evenly spaced edges (for bounded ratios like occupancy)."""
        step = (hi - lo) / nbins
        return cls([lo + step * i for i in range(nbins + 1)])

    def record(self, x: float) -> None:
        x = float(x)
        self.counts[bisect.bisect_right(self.edges, x)] += 1
        self.n += 1
        self.total += x
        if x < self.vmin:
            self.vmin = x
        if x > self.vmax:
            self.vmax = x

    def percentile(self, p: float) -> float:
        """Bin-midpoint estimate of the p-th percentile (0 if empty)."""
        if self.n == 0:
            return 0.0
        rank = p / 100.0 * self.n
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= rank and c:
                if i == 0:
                    mid = self.edges[0]
                elif i == len(self.edges):
                    mid = self.edges[-1]
                else:
                    mid = 0.5 * (self.edges[i - 1] + self.edges[i])
                return min(max(mid, self.vmin), self.vmax)
        return self.vmax

    def snapshot(self) -> dict:
        if self.n == 0:
            return {"count": 0, "sum": 0.0, "mean": 0.0, "min": 0.0,
                    "max": 0.0, "p50": 0.0, "p90": 0.0, "p99": 0.0}
        return {
            "count": self.n,
            "sum": self.total,
            "mean": self.total / self.n,
            "min": self.vmin,
            "max": self.vmax,
            "p50": self.percentile(50),
            "p90": self.percentile(90),
            "p99": self.percentile(99),
        }

    def reset(self) -> None:
        self.counts = [0] * len(self.counts)
        self.n = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf


# histogram kinds: name -> factory (latencies span us..100s; unit ratios
# like occupancy live in [0, 1]; count-like data spans 1..1M rows)
_KINDS = {
    "latency": lambda: Histogram.log(1e-6, 100.0, per_decade=5),
    "unit": lambda: Histogram.linear(0.0, 1.0, nbins=20),
    "count": lambda: Histogram.log(0.5, 1e6, per_decade=4),
}


class Metrics:
    """Create-on-first-use registry of named counters and histograms."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._hists: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter()
        return c

    def histogram(self, name: str, kind: str = "latency") -> Histogram:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = _KINDS[kind]()
        return h

    def snapshot(self, **gauges) -> dict:
        """Plain-dict export; ``gauges`` carries instantaneous values the
        caller owns (queue depths, tenant count)."""
        return {
            "counters": {k: c.value for k, c in sorted(self._counters.items())},
            "histograms": {k: h.snapshot() for k, h in sorted(self._hists.items())},
            "gauges": dict(gauges),
        }

    def reset(self) -> None:
        """Zero every counter and histogram (registry keys survive)."""
        for c in self._counters.values():
            c.value = 0
        for h in self._hists.values():
            h.reset()
