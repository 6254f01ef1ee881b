"""Port parity: int64 u64 ops, splitmix hashing and converters.

Inputs are made with numpy from fixed seeds and given to both packages
(or to Python-int semantics). Tolerance: exact equality of every bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import hashing as jhash  # noqa: E402
from repro.core import u64 as ju64  # noqa: E402
from repro_torch.core import hashing, u64  # noqa: E402

MASK = (1 << 64) - 1
EDGES = [0, 1, 2, (1 << 31) - 1, 1 << 31, (1 << 32) - 1, 1 << 32,
         (1 << 63) - 1, 1 << 63, MASK - 1, MASK]


def _values(seed, n=512):
    rng = np.random.default_rng(seed)
    v = rng.integers(0, 1 << 63, n, dtype=np.uint64) * np.uint64(2) \
        + rng.integers(0, 2, n, dtype=np.uint64)
    return np.concatenate([np.array(EDGES, np.uint64), v])


def _t(v):
    return u64.from_numpy_u64(v)


def _ints(t):
    return [int(x) for x in u64.to_numpy_u64(t)]


@pytest.mark.parametrize("seed", [0, 1])
def test_arithmetic_matches_python_ints(seed):
    a_np, b_np = _values(seed), _values(seed + 100)
    a, b = _t(a_np), _t(b_np)
    pa, pb = [int(x) for x in a_np], [int(x) for x in b_np]
    assert _ints(a + b) == [(x + y) & MASK for x, y in zip(pa, pb)]
    assert _ints(a * b) == [(x * y) & MASK for x, y in zip(pa, pb)]
    assert _ints(a ^ b) == [x ^ y for x, y in zip(pa, pb)]
    assert u64.lt(a, b).tolist() == [x < y for x, y in zip(pa, pb)]
    assert u64.le(a, b).tolist() == [x <= y for x, y in zip(pa, pb)]
    assert _ints(u64.minimum(a, b)) == [min(x, y) for x, y in zip(pa, pb)]


@pytest.mark.parametrize("n", [0, 1, 13, 29, 31, 32, 33, 47, 63])
def test_shifts_and_rotations(n):
    v = _values(3)
    x = _t(v)
    p = [int(y) for y in v]
    assert _ints(u64.shr(x, n)) == [y >> n for y in p]
    assert _ints(u64.shl(x, n)) == [(y << n) & MASK for y in p]
    want = [((y << n) | (y >> (64 - n))) & MASK if n else y for y in p]
    assert _ints(u64.rotl(x, n)) == want


def test_sentinel_sorts_last_and_searchsorted():
    v = _values(4)
    got, _ = u64.sort(_t(v))
    assert np.array_equal(u64.to_numpy_u64(got), np.sort(v))
    assert int(got[-1]) == u64.SENTINEL
    table = got.unique_consecutive()
    q = _t(_values(5)[:64])
    pos = u64.searchsorted(table, q)
    want = np.searchsorted(u64.to_numpy_u64(table), u64.to_numpy_u64(q), "left")
    assert np.array_equal(pos.numpy(), want)


def test_converters_round_trip():
    v = _values(6)[:520].reshape(-1, 4)
    limbs = np.stack([(v >> np.uint64(32)).astype(np.uint32),
                      (v & np.uint64(0xFFFFFFFF)).astype(np.uint32)], -1)
    t = u64.from_limbs(limbs)
    assert t.dtype == torch.int64 and t.shape == v.shape
    assert np.array_equal(u64.to_limbs(t), limbs)
    assert np.array_equal(u64.to_numpy_u64(u64.from_numpy_u64(v)), v)
    assert np.array_equal(u64.to_numpy_u64(u64.hi32(t)), v >> np.uint64(32))
    assert np.array_equal(u64.to_numpy_u64(u64.lo32(t)), v & np.uint64(0xFFFFFFFF))
    bits = u64.to_int32_bits(t)
    assert bits.dtype == torch.int32
    assert np.array_equal(bits.numpy().view(np.uint32), limbs[..., 1])


def test_mix64_matches_jax_and_numpy_mirror():
    v = _values(7)
    got = u64.to_numpy_u64(hashing.mix64(_t(v)))
    assert np.array_equal(got, jhash.np_mix64_vec(v))
    hi, lo = jhash.mix64(ju64.unpack(jnp.asarray(u64.to_limbs(_t(v)))))
    assert np.array_equal(u64.to_limbs(hashing.mix64(_t(v))),
                          np.stack([np.asarray(hi), np.asarray(lo)], -1))


@pytest.mark.parametrize("seed", [0, 7, 0xC0DE, 0xB10C, 2**31])
def test_hash_u64_matches_numpy_mirror(seed):
    v = _values(seed % 97)
    got = u64.to_numpy_u64(hashing.hash_u64(_t(v), seed))
    assert np.array_equal(got, jhash.np_hash_u64_vec(v, seed))
    assert np.array_equal(got, hashing.np_hash_u64_vec(v, seed))


def test_hash_u32_and_fingerprint_rid():
    rng = np.random.default_rng(8)
    tok = rng.integers(0, 1 << 32, 300, dtype=np.uint64).astype(np.uint32)
    got = hashing.hash_u32(torch.from_numpy(tok.astype(np.int64)), seed=0x70CE)
    hi, lo = jhash.hash_u32(jnp.asarray(tok), seed=0x70CE)
    assert np.array_equal(u64.to_limbs(got), np.stack([np.asarray(hi), np.asarray(lo)], -1))
    rid = np.arange(0, 5000, 7)
    fp = hashing.fingerprint_rid(torch.from_numpy(rid))
    assert np.array_equal(u64.to_numpy_u64(fp), jhash.np_fingerprint_rid(rid))
    assert np.array_equal(u64.to_numpy_u64(fp), hashing.np_fingerprint_rid(rid))


def test_combine_matches_jax_and_python_mirror():
    a, b = _values(9)[:200], _values(10)[:200]
    got = hashing.combine(_t(a), _t(b))
    ja = ju64.unpack(jnp.asarray(u64.to_limbs(_t(a))))
    jb = ju64.unpack(jnp.asarray(u64.to_limbs(_t(b))))
    hi, lo = jhash.combine(ja, jb)
    assert np.array_equal(u64.to_limbs(got), np.stack([np.asarray(hi), np.asarray(lo)], -1))
    want = [jhash.np_combine(int(x), int(y)) for x, y in zip(a, b)]
    assert _ints(got) == want
    assert want == [hashing.np_combine(int(x), int(y)) for x, y in zip(a, b)]


def test_scalar_mirrors_equal_reference():
    for x in EDGES + [12345, 987654321987]:
        assert hashing.np_mix64(x) == jhash.np_mix64(x)
        assert hashing.np_hash_u64(x, 3) == jhash.np_hash_u64(x, 3)
        assert hashing.np_rotl64(x, 29) == jhash.np_rotl64(x, 29)
