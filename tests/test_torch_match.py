"""Port parity: fused match (score + threshold + compaction).

The port's fused path (the match kernel's plain version on the CPU) is
held against ``repro.data.matcher.match_compact(backend="pallas")`` (the
Pallas kernel in interpret mode) and the JAX host scorer, on a synthetic
corpus from a fixed seed, across more than one chunk, with pairs whose
score sits exactly on the threshold. Tolerance: exact equality of
(ca, cb, count), of every match decision, and of the float32 scores
(``torch.equal``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.data import matcher as jmatcher  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.kernels.match import ops as jops  # noqa: E402
from repro_torch.core import u64  # noqa: E402
from repro_torch.data import matcher, synthetic  # noqa: E402
from repro_torch.kernels.match import ops  # noqa: E402

SPEC = dict(num_entities=300, seed=3)


@pytest.fixture(scope="module")
def corpora():
    jc = jsyn.generate(jsyn.SyntheticSpec(**SPEC))
    tc = synthetic.generate(synthetic.SyntheticSpec(**SPEC), device="cpu")
    rng = np.random.default_rng(0)
    n = tc.num_records
    order = np.argsort(tc.entity_id, kind="stable")
    a = rng.integers(0, n, 2500)
    b = rng.integers(0, n, 2500)
    near = rng.random(2500) < 0.5                 # same-entity neighbours
    pos = np.searchsorted(tc.entity_id[order], tc.entity_id[a])
    b[near] = order[np.minimum(pos[near] + 1, n - 1)]
    b[:40] = a[:40]                               # self pairs score 1.0
    return jc, tc, a.astype(np.int64), b.astype(np.int64)


def _cfg(threshold):
    return (jmatcher.MatcherConfig(threshold=threshold),
            matcher.MatcherConfig(threshold=threshold))


def test_scores_bit_identical_to_jax_host_scorer(corpora):
    jc, tc, a, b = corpora
    jcfg, tcfg = _cfg(0.65)
    js = jmatcher.score_pairs(jc.columns, a, b, jcfg)
    ts = matcher.score_pairs(tc.columns, a, b, tcfg)
    assert torch.equal(torch.from_numpy(ts), torch.from_numpy(js))
    assert np.array_equal(matcher.match_pairs(tc.columns, a, b, tcfg),
                          jmatcher.match_pairs(jc.columns, a, b, jcfg))


def _on_threshold(corpora):
    """A threshold equal to a realized float32 score of several pairs."""
    jc, _, a, b = corpora
    s = jmatcher.score_pairs(jc.columns, a, b, jmatcher.MatcherConfig())
    vals, counts = np.unique(s[(s > 0.3) & (s < 1.0)], return_counts=True)
    return float(vals[np.argmax(counts)])


@pytest.mark.parametrize("threshold,chunk", [("default", 1024), ("on_score", 1024),
                                             ("default", 1 << 16), ("one", 1 << 16)])
def test_match_compact_matches_pallas_backend(corpora, threshold, chunk):
    """The reference scores in ``chunk``-lane launches and pads its buffers
    to a whole chunk; the port makes one launch padded to a 128-lane tile,
    so the matched prefix is compared and the port's tail must be zero."""
    jc, tc, a, b = corpora
    thr = {"default": 0.65, "one": 1.0, "on_score": _on_threshold(corpora)}[threshold]
    jcfg, tcfg = _cfg(thr)
    jca, jcb, jcnt = jmatcher.match_compact(jc.columns, a, b, jcfg,
                                            backend="pallas", chunk=chunk)
    tca, tcb, tcnt = matcher.match_compact(tc.columns, a, b, tcfg, device="cpu")
    k = int(tcnt)
    assert k == int(jcnt) > 0
    assert tca.shape[0] == tcb.shape[0] == -(-len(a) // 128) * 128
    assert np.array_equal(tca[:k].numpy(), np.asarray(jca)[:k])
    assert np.array_equal(tcb[:k].numpy(), np.asarray(jcb)[:k])
    assert not tca[k:].any() and not tcb[k:].any()
    if threshold == "on_score":
        s = matcher.score_pairs(tc.columns, a, b, tcfg)
        assert np.sum(s == np.float32(thr)) >= 2   # pairs sit on the threshold
    want = jops.packed_host(jca, jcb, int(jcnt))
    assert np.array_equal(ops.packed_host(tca, tcb, int(tcnt)), want)


def test_match_chunk_matches_pallas_chunk(corpora):
    jc, tc, a, b = corpora
    jcfg, tcfg = _cfg(0.65)
    names = [n for n, _ in jcfg.weights]
    weights = tuple(w for _, w in jcfg.weights)
    n = 2048
    jout = jops._match_chunk(
        tuple(jc.columns[k].tokens for k in names),
        tuple(jc.columns[k].mask for k in names),
        jnp.asarray(a[:2000].astype(np.int32)), jnp.asarray(b[:2000].astype(np.int32)),
        jnp.int32(0), jnp.int32(2000), chunk=n, weights=weights,
        threshold=0.65, use_kernel=True, interpret=True)
    tokens = [tc.columns[k].tokens for k in names]
    col_off = [0] + np.cumsum([t.shape[1] for t in tokens]).tolist()
    tok = u64.to_int32_bits(torch.cat(tokens, 1))
    msk = torch.cat([tc.columns[k].mask for k in names], 1).to(torch.uint8)
    tout = ops._match_chunk(tok, msk, col_off, weights, torch.from_numpy(a[:2000]),
                            torch.from_numpy(b[:2000]), n, 0.65)
    aa, bb, matched, rank, counts = (x.numpy() for x in tout)
    assert np.array_equal(aa, np.asarray(jout[0])) and np.array_equal(bb, np.asarray(jout[1]))
    assert np.array_equal(matched.astype(bool), np.asarray(jout[2]))
    assert np.array_equal(rank, np.asarray(jout[3]))
    assert np.array_equal(counts, np.asarray(jout[4]))


def test_match_compact_empty_and_backends(corpora):
    _, tc, _, _ = corpora
    z = np.zeros(0, np.int64)
    ca, cb, cnt = matcher.match_compact(tc.columns, z, z, device="cpu")
    assert ca.numel() == cb.numel() == int(cnt) == 0
    for bad in ("host", "jnp", "pallas", "bogus"):
        with pytest.raises(ValueError):
            matcher.match_compact(tc.columns, z, z, backend=bad, device="cpu")


def test_compact_matched_prefix_scatter():
    rng = np.random.default_rng(1)
    n = 4 * 128
    aa = torch.from_numpy(rng.integers(1, 1000, n).astype(np.int32))
    bb = torch.from_numpy(rng.integers(1, 1000, n).astype(np.int32))
    m = torch.from_numpy((rng.random(n) < 0.3).astype(np.int32)).reshape(-1, 128)
    rank = (torch.cumsum(m, 1) - m).reshape(-1).to(torch.int32)
    ca, cb, cnt = ops.compact_matched(aa, bb, m.reshape(-1), rank, m.sum(1))
    keep = m.reshape(-1).bool()
    k = int(keep.sum())
    assert int(cnt) == k
    assert torch.equal(ca[:k], aa[keep]) and torch.equal(cb[:k], bb[keep])
    assert not ca[k:].any() and not cb[k:].any()
