"""Port parity: MinHash, key building and the synthetic generator.

Token columns are made with numpy from fixed seeds and given to both
packages. Tolerance: exact equality of every key, mask and token.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import blocks as jblocks  # noqa: E402
from repro.core import minhash as jminhash  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch.core import blocks, minhash, u64  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402


def _columns(seed, n=120, widths=(6, 1, 3)):
    rng = np.random.default_rng(seed)
    cols = {}
    for c, w in enumerate(widths):
        tok = rng.integers(0, 1 << 32, (n, w), dtype=np.uint64).astype(np.uint32)
        tok[rng.random((n, w)) < 0.3] = rng.integers(0, 50)  # shared tokens
        mask = rng.random((n, w)) < 0.8
        mask[: n // 10] = False  # some empty rows
        cols[f"c{c}"] = (tok, mask)
    return cols


def _both(cols):
    jcols = {k: jblocks.TokenColumn(jnp.asarray(t), jnp.asarray(m))
             for k, (t, m) in cols.items()}
    tcols = {k: blocks.TokenColumn(torch.from_numpy(t.astype(np.int64)),
                                   torch.from_numpy(m))
             for k, (t, m) in cols.items()}
    return jcols, tcols


SPECS = {
    "identity": lambda J: {f"c{i}": J.ColumnBlocking.identity() for i in range(3)},
    "token": lambda J: {f"c{i}": J.ColumnBlocking.token() for i in range(3)},
    "lsh": lambda J: {f"c{i}": J.ColumnBlocking.lsh(3, 2) for i in range(3)},
    "mixed": lambda J: {"c0": J.ColumnBlocking.lsh(4, 3),
                        "c1": J.ColumnBlocking.identity(),
                        "c2": J.ColumnBlocking.token()},
}


@pytest.mark.parametrize("kind", sorted(SPECS))
@pytest.mark.parametrize("max_width", [None, 5])
def test_build_keys_bit_identical(kind, max_width):
    jcols, tcols = _both(_columns(1))
    jk, jv = jblocks.build_keys(jcols, SPECS[kind](jblocks), max_width=max_width)
    tk, tv = blocks.build_keys(tcols, SPECS[kind](blocks), max_width=max_width)
    assert np.array_equal(u64.to_limbs(tk), np.asarray(jk))
    assert np.array_equal(tv.numpy(), np.asarray(jv))


def test_minhash_and_band_keys_bit_identical():
    tok, mask = _columns(2)["c0"]
    jm = jminhash.minhash_tokens(jnp.asarray(tok), jnp.asarray(mask), 12)
    tm = minhash.minhash_tokens(torch.from_numpy(tok.astype(np.int64)),
                                torch.from_numpy(mask), 12)
    assert np.array_equal(tm.numpy(), np.asarray(jm).astype(np.int64))
    jb = jminhash.band_keys(jm, 4, 3, column_seed=2)
    tb = minhash.band_keys(tm, 4, 3, column_seed=2)
    assert np.array_equal(u64.to_limbs(tb),
                          np.stack([np.asarray(jb[0]), np.asarray(jb[1])], -1))


SYN_SPECS = [dict(num_entities=150, seed=7),
             dict(num_entities=400, dup_rate=0.15, max_dups=2, name_len=(2, 4),
                  desc_len=(4, 8), brand_card=500, model_no_present=0.9,
                  tok_dropout=0.08, tok_substitute=0.05, seed=6)]


@pytest.mark.parametrize("spec", SYN_SPECS)
def test_generate_matches_reference(spec):
    jc = jsyn.generate(jsyn.SyntheticSpec(**spec))
    tc = synthetic.generate(synthetic.SyntheticSpec(**spec), device="cpu")
    assert tc.num_records == jc.num_records
    assert np.array_equal(tc.entity_id, jc.entity_id)
    assert sorted(tc.columns) == sorted(jc.columns)
    for name, col in jc.columns.items():
        assert np.array_equal(tc.columns[name].tokens.numpy(),
                              np.asarray(col.tokens).astype(np.int64))
        assert np.array_equal(tc.columns[name].mask.numpy(), np.asarray(col.mask))
        assert tc.blocking[name] == blocks.ColumnBlocking(
            jc.blocking[name].kind, jc.blocking[name].bands,
            jc.blocking[name].rows_per_band)
    # the converter gives the same corpus as the generator
    conv = synthetic.corpus_from_numpy(jc.columns, jc.blocking, jc.entity_id,
                                       device="cpu")
    for name, col in tc.columns.items():
        assert torch.equal(conv.columns[name].tokens, col.tokens)
        assert torch.equal(conv.columns[name].mask, col.mask)
    assert conv.blocking == tc.blocking
    ja, jb = jc.labeled_pairs()
    ta, tb = tc.labeled_pairs()
    assert np.array_equal(ja, ta) and np.array_equal(jb, tb)
