"""Batched serving engine: continuous-batching decode over the port's
decoder-only models (dense, MoE, hybrid and ssm; attention, MLA, Mamba
or RWKV caches).

Port of the JAX package's ``serving/engine.py``. A slot-based scheduler:
a fixed batch of decode slots; finished sequences free their slot, queued
requests claim it. Every step is one fixed-shape ``decode_step`` over all
slots; the scheduler only flips slot metadata on the host.

The slot scheduling is the reference's, its quirk included: a request is
admitted by feeding its prompt one token at a time through the shared
decode step with token 0 in every other slot, so every slot's cache gains
a row and the one shared ``pos`` advances for all of them (ROADMAP
Queue C). A recurrent cache (Mamba, RWKV) likewise absorbs the token 0
of every other slot into that slot's state.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import List, Optional

import numpy as np
import torch

from ..models.model import Model
from .scheduler import drain


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray           # (L,) int32
    max_new_tokens: int = 32
    eos_id: int = 0


@dataclasses.dataclass
class Result:
    uid: int
    tokens: List[int]


class ServingEngine:
    """Greedy decoding of queued requests over ``batch_slots`` slots of a
    model that carries its own weights and device."""

    def __init__(self, model: Model, batch_slots: int, max_len: int,
                 greedy: bool = True):
        self.model = model
        self.slots = batch_slots
        self.max_len = max_len
        self.greedy = greedy
        self.caches = model.init_caches(batch_slots, max_len)
        self.tokens = np.zeros((batch_slots, 1), np.int32)
        self.slot_req: List[Optional[Request]] = [None] * batch_slots
        self.slot_out: List[List[int]] = [[] for _ in range(batch_slots)]
        self.slot_remaining = np.zeros(batch_slots, np.int64)
        self.queue: List[Request] = []
        self.results: List[Result] = []
        self.n_steps = 0

    def _step(self, tokens: np.ndarray):
        tok = torch.from_numpy(tokens).to(self.model.device)  # repro: noqa[R001] the host tokens, uploaded
        logits, self.caches = self.model.decode_step(tok, self.caches)
        self.n_steps += 1
        return logits

    @property
    def pos(self) -> int:
        """Decode steps run over the shared caches (all slots): the history
        rows an attention cache holds, the tokens a recurrent state has
        absorbed."""
        return self.n_steps

    def submit(self, req: Request):
        self.queue.append(req)

    @property
    def busy(self) -> bool:
        return any(r is not None for r in self.slot_req) or bool(self.queue)

    def _admit(self):
        for slot in range(self.slots):
            if self.slot_req[slot] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            self.slot_req[slot] = req
            self.slot_out[slot] = []
            self.slot_remaining[slot] = req.max_new_tokens
            # teacher-forced prefill of this slot: prompt tokens one at a
            # time through the shared decode step (a shared pos keeps slots
            # in lockstep)
            for t in req.prompt[:-1]:
                tok = np.zeros((self.slots, 1), np.int32)
                tok[slot, 0] = t
                self._step(tok)
            self.tokens[slot, 0] = req.prompt[-1]

    def step(self):
        """One decode iteration for every live slot."""
        self._admit()
        if not any(r is not None for r in self.slot_req):
            return
        logits = self._step(self.tokens)
        # argmax breaks ties at the first index, as jnp.argmax does
        nxt = torch.argmax(logits[:, -1, :], dim=-1).cpu().numpy().astype(np.int32)  # repro: noqa[R001] sampled tokens to the host scheduler
        for slot, req in enumerate(self.slot_req):
            if req is None:
                continue
            tok = int(nxt[slot])
            self.slot_out[slot].append(tok)
            self.slot_remaining[slot] -= 1
            self.tokens[slot, 0] = tok
            if tok == req.eos_id or self.slot_remaining[slot] <= 0:
                self.results.append(Result(req.uid, self.slot_out[slot]))
                self.slot_req[slot] = None

    def run(self, max_steps: int = 10_000) -> List[Result]:
        """Drain the queue; warn if ``max_steps`` truncates the drain."""
        drain(self, max_steps)
        if self.busy:
            live = sum(r is not None for r in self.slot_req)
            warnings.warn(
                f"ServingEngine.run stopped at max_steps={max_steps} with "
                f"{len(self.queue)} queued and {live} in-flight requests; "
                "call run() again to finish", RuntimeWarning, stacklevel=2)
        return self.results
