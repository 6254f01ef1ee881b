"""Slot-scheduler helpers: FIFO collation under a slot budget, and the
drain loop.

This package's own copy of the JAX package's ``serving/scheduler.py``.
The streaming engine (``streaming/engine.py``) queues submissions on the
host, and each ``step()`` drains one micro-batch of at most a slot
budget; ``run()`` steps while the engine is busy. Host metadata only.
"""
from __future__ import annotations

from typing import Callable, List, Optional


def collate_fifo(queue: List, budget: int, size_fn: Callable,
                 group_fn: Optional[Callable] = None,
                 take_if: Optional[Callable] = None) -> List:
    """Remove and return queue entries up to ``budget`` total size.

    Skip-scan: an entry that does not fit the remaining budget (or fails
    ``take_if``) no longer blocks smaller entries queued behind it — the
    head-of-line fix over the old take-while-prefix collation. Ordering
    guarantees:

    - taken entries keep their queue order (never reordered);
    - per-group FIFO is preserved: once an entry of group ``group_fn(e)``
      is skipped, no later entry of that group is taken this call, so two
      submissions from one producer can't be answered out of order;
    - an OVERSIZED entry (alone it exceeds the budget) passes through
      alone once it reaches the first eligible position, so it cannot
      starve behind a stream of small entries.

    ``size_fn(entry) -> int`` gives each entry's slot cost; ``take_if``
    optionally gates eligibility (e.g. "same include_probe mode as the
    batch head"). Returns the taken entries; ``queue`` is mutated.
    """
    take_idx: List[int] = []
    total = 0
    skipped = set()
    for i, item in enumerate(queue):
        group = group_fn(item) if group_fn is not None else None
        eligible = (take_if is None or take_if(item)) and group not in skipped
        if eligible:
            size = size_fn(item)
            if not take_idx and size > budget:
                take_idx = [i]       # oversized head: pass through alone
                break
            if total + size <= budget:
                take_idx.append(i)
                total += size
                continue
        if group is not None:
            skipped.add(group)
    taken = [queue[i] for i in take_idx]
    for i in reversed(take_idx):
        del queue[i]
    return taken


def drain(engine, max_steps: int) -> int:
    """Step ``engine`` while it has queued work, up to ``max_steps``.

    Returns the number of steps taken. Callers decide what a truncated
    drain means — the engines warn when ``engine.busy`` is still true so
    a capped ``run()`` can't be mistaken for completion.
    """
    steps = 0
    while engine.busy and steps < max_steps:
        engine.step()
        steps += 1
    return steps
