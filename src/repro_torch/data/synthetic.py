"""Synthetic dedup corpora with planted duplicate clusters + ground truth.

This package's own copy of the JAX package's numpy generator
(``data/synthetic.py``): the same spec and seed give the same arrays,
emitted as this package's ``TokenColumn``s (uint32 token hashes held in
int64, bool masks) on the requested device.

Columns: name / description (multi-token text, LSH blocking), brand /
category / model_no (scalars, identity blocking).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from ..core.blocks import ColumnBlocking, TokenColumn
from ..device import DeviceLike, resolve_device


@dataclasses.dataclass
class SyntheticSpec:
    num_entities: int = 5_000
    dup_rate: float = 0.35          # fraction of entities with >=1 duplicate
    max_dups: int = 4
    name_len: Tuple[int, int] = (3, 8)
    desc_len: Tuple[int, int] = (8, 24)
    vocab: int = 50_000
    zipf_a: float = 1.3
    brand_card: int = 2_000
    category_card: int = 40
    model_no_present: float = 0.6
    # corruption strength for duplicate copies
    tok_dropout: float = 0.15
    tok_substitute: float = 0.10
    seed: int = 0


@dataclasses.dataclass
class Corpus:
    columns: Dict[str, TokenColumn]
    blocking: Dict[str, ColumnBlocking]
    entity_id: np.ndarray       # (N,) ground-truth cluster per record
    num_records: int

    def labeled_pairs(self, max_pairs: int = 200_000, seed: int = 1
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """All (or sampled) positive pairs from ground truth clusters."""
        order = np.argsort(self.entity_id, kind="stable")
        ent = self.entity_id[order]
        starts = np.flatnonzero(np.concatenate([[True], ent[1:] != ent[:-1]]))
        sizes = np.diff(np.concatenate([starts, [len(ent)]]))
        a_l, b_l = [], []
        for s, n in zip(starts, sizes):
            if n < 2:
                continue
            mem = order[s : s + n]
            ii, jj = np.triu_indices(n, 1)
            a_l.append(mem[ii])
            b_l.append(mem[jj])
        if not a_l:
            z = np.zeros((0,), np.int64)
            return z, z
        a = np.concatenate(a_l)
        b = np.concatenate(b_l)
        if len(a) > max_pairs:
            rng = np.random.default_rng(seed)
            pick = rng.choice(len(a), max_pairs, replace=False)
            a, b = a[pick], b[pick]
        lo, hi = np.minimum(a, b), np.maximum(a, b)
        return lo.astype(np.int64), hi.astype(np.int64)

    def is_duplicate(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """Ground truth per pair: do records a and b share an entity?"""
        return self.entity_id[a] == self.entity_id[b]


def _token_hash(ids: np.ndarray, namespace: int) -> np.ndarray:
    """Stable uint32 token hash per vocab id."""
    x = ids.astype(np.uint64) + np.uint64((namespace * 0x9E3779B97F4A7C15) & ((1 << 64) - 1))
    x ^= x >> np.uint64(30)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x &= np.uint64((1 << 64) - 1)
    x ^= x >> np.uint64(27)
    x *= np.uint64(0x94D049BB133111EB)
    x &= np.uint64((1 << 64) - 1)
    x ^= x >> np.uint64(31)
    return (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def _zipf_ids(rng, n, vocab, a):
    ids = rng.zipf(a, size=n)
    return np.minimum(ids - 1, vocab - 1).astype(np.int64)


def _corrupt(rng, tokens: np.ndarray, mask: np.ndarray, spec: SyntheticSpec,
             namespace: int) -> Tuple[np.ndarray, np.ndarray]:
    """Corrupt one record's token row: dropout + substitution."""
    tokens = tokens.copy()
    mask = mask.copy()
    t = len(tokens)
    drop = (rng.random(t) < spec.tok_dropout) & mask
    if drop.sum() >= mask.sum():  # never drop everything
        drop[np.flatnonzero(mask)[0]] = False
    mask &= ~drop
    sub = (rng.random(t) < spec.tok_substitute) & mask
    n_sub = int(sub.sum())
    if n_sub:
        tokens[sub] = _token_hash(_zipf_ids(rng, n_sub, spec.vocab, spec.zipf_a), namespace)
    return tokens, mask


def _blocking() -> Dict[str, ColumnBlocking]:
    return {
        "name": ColumnBlocking.lsh(bands=6, rows_per_band=4),
        "description": ColumnBlocking.lsh(bands=6, rows_per_band=4),
        "brand": ColumnBlocking.identity(),
        "category": ColumnBlocking.identity(),
        "model_no": ColumnBlocking.identity(),
    }


def _column(tokens: np.ndarray, mask: np.ndarray, device) -> TokenColumn:
    tok = torch.from_numpy(np.asarray(tokens, np.uint32).astype(np.int64))
    return TokenColumn(tok.to(device),
                       torch.from_numpy(np.asarray(mask, bool).copy()).to(device))


def generate(spec: SyntheticSpec, device: DeviceLike = None) -> Corpus:
    dev = resolve_device(device)
    rng = np.random.default_rng(spec.seed)
    # -- canonical entities --
    e = spec.num_entities
    name_w = spec.name_len[1]
    desc_w = spec.desc_len[1]
    name_len = rng.integers(spec.name_len[0], spec.name_len[1] + 1, e)
    desc_len = rng.integers(spec.desc_len[0], spec.desc_len[1] + 1, e)
    name_tok = _token_hash(
        _zipf_ids(rng, e * name_w, spec.vocab, spec.zipf_a), 1).reshape(e, name_w)
    desc_tok = _token_hash(
        _zipf_ids(rng, e * desc_w, spec.vocab, spec.zipf_a), 2).reshape(e, desc_w)
    name_mask = np.arange(name_w)[None, :] < name_len[:, None]
    desc_mask = np.arange(desc_w)[None, :] < desc_len[:, None]
    brand = _token_hash(rng.integers(0, spec.brand_card, e), 3)
    # brands skewed: 20% of records share 5 mega-brands
    mega = rng.random(e) < 0.2
    brand[mega] = _token_hash(rng.integers(0, 5, int(mega.sum())), 4)
    category = _token_hash(rng.integers(0, spec.category_card, e), 5)
    model_no = _token_hash(rng.integers(0, 1 << 30, e), 6)
    model_present = rng.random(e) < spec.model_no_present

    # -- expand to records: canonical + duplicates --
    n_dups = np.where(rng.random(e) < spec.dup_rate,
                      rng.integers(1, spec.max_dups + 1, e), 0)
    copies = 1 + n_dups
    entity_id = np.repeat(np.arange(e), copies)
    n = len(entity_id)
    src = np.repeat(np.arange(e), copies)
    is_dup = np.concatenate([np.arange(c) > 0 for c in copies]).astype(bool)

    name_t = name_tok[src].copy()
    name_m = name_mask[src].copy()
    desc_t = desc_tok[src].copy()
    desc_m = desc_mask[src].copy()
    brand_r = brand[src].copy()
    cat_r = category[src].copy()
    model_r = model_no[src].copy()
    model_m = model_present[src].copy()

    for i in np.flatnonzero(is_dup):
        name_t[i], name_m[i] = _corrupt(rng, name_t[i], name_m[i], spec, 1)
        desc_t[i], desc_m[i] = _corrupt(rng, desc_t[i], desc_m[i], spec, 2)
        # duplicates sometimes lose / change scalar fields
        if rng.random() < 0.15:
            brand_r[i] = _token_hash(np.array([rng.integers(0, spec.brand_card)]), 3)[0]
        if rng.random() < 0.5:
            model_m[i] = False

    perm = rng.permutation(n)
    columns = {
        "name": _column(name_t[perm], name_m[perm], dev),
        "description": _column(desc_t[perm], desc_m[perm], dev),
        "brand": _column(brand_r[perm][:, None], np.ones((n, 1), bool), dev),
        "category": _column(cat_r[perm][:, None], np.ones((n, 1), bool), dev),
        "model_no": _column(model_r[perm][:, None], model_m[perm][:, None], dev),
    }
    return Corpus(columns=columns, blocking=_blocking(),
                  entity_id=entity_id[perm], num_records=n)


def corpus_slice(corpus: Corpus, idx: np.ndarray) -> Corpus:
    """Row subset of a corpus (to stream it in micro-batches); the columns
    stay on their device."""
    idx = np.asarray(idx, np.int64)
    cols = {}
    for name, c in corpus.columns.items():
        rows = torch.from_numpy(idx).to(c.tokens.device)
        cols[name] = TokenColumn(c.tokens[rows], c.mask[rows])
    return Corpus(columns=cols, blocking=corpus.blocking,
                  entity_id=corpus.entity_id[idx], num_records=len(idx))


def corpus_from_numpy(columns: Mapping[str, object],
                      blocking: Mapping[str, object], entity_id: np.ndarray,
                      device: DeviceLike = None) -> Corpus:
    """This package's corpus from host arrays of another corpus.

    ``columns`` maps a name to a ``(tokens, mask)`` pair or to an object
    with ``.tokens`` / ``.mask`` (such as ``np.asarray``-able columns of a
    JAX ``Corpus``); ``blocking`` maps a name to anything with ``.kind``,
    ``.bands`` and ``.rows_per_band``.
    """
    dev = resolve_device(device)
    cols = {}
    for name, col in columns.items():
        tok, mask = (col.tokens, col.mask) if hasattr(col, "tokens") else col
        cols[name] = _column(np.asarray(tok), np.asarray(mask), dev)
    blk = {name: ColumnBlocking(b.kind, b.bands, b.rows_per_band)
           for name, b in blocking.items()}
    entity_id = np.asarray(entity_id)
    return Corpus(columns=cols, blocking=blk, entity_id=entity_id,
                  num_records=len(entity_id))


def jaccard_pair_corpus(n_pairs: int, jaccard: float, set_size: int = 40,
                        seed: int = 0):
    """Pairs of token sets with (near-)exact Jaccard j, to check the
    analytic LSH(b, w, j) curve of paper Fig. 1a: (a, b) uint32 (n_pairs,
    set_size) token rows and the realised Jaccard."""
    rng = np.random.default_rng(seed)
    inter = int(round(2 * set_size * jaccard / (1 + jaccard)))
    only = set_size - inter
    total = inter + 2 * only
    base = rng.integers(0, 1 << 31, size=(n_pairs, total)).astype(np.uint32)
    a = np.concatenate([base[:, :inter], base[:, inter:inter + only]], axis=1)
    b = np.concatenate([base[:, :inter], base[:, inter + only:]], axis=1)
    true_j = inter / (2 * set_size - inter) if (2 * set_size - inter) else 1.0
    return a, b, true_j
