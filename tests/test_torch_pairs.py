"""Port parity: tri-decode, radix sort passes, word sort and the pair engine.

The plain versions of the port's kernels are held against the JAX
package's Pallas kernels in interpret mode, and the port's PairSet
against ``repro.core.pairs.dedupe_pairs(backend="pallas",
sort_backend="radix", interpret=True)``. Inputs come from fixed numpy
seeds. Tolerance: exact equality of every index, word, rank and count.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import hdb as jhdb  # noqa: E402
from repro.core import pairs as jpairs  # noqa: E402
from repro.kernels.pairs import tri_decode_pallas  # noqa: E402
from repro.kernels.sort import np_radix_sort_words, radix_pass_pallas  # noqa: E402
from repro_torch.core import hdb, pairs  # noqa: E402
from repro_torch.kernels import pairs as pk  # noqa: E402
from repro_torch.kernels.pairs import ref  # noqa: E402
from repro_torch.kernels import sort as sort_ops  # noqa: E402


def test_tri_decode_plain_matches_pallas_interpret():
    rng = np.random.default_rng(0)
    count = 16 * 128
    n = rng.integers(2, 400, count)
    n[:6] = [2, 2, 3, pk.MAX_BLOCK_N, pk.MAX_BLOCK_N, 65534]
    t = (rng.random(count) * (n * (n - 1) // 2)).astype(np.int64)
    t[1] = 0
    t[4] = pk.MAX_BLOCK_N * (pk.MAX_BLOCK_N - 1) // 2 - 1
    n[-7:] = [0, 1, 0, 1, 0, 1, 0]               # garbage lanes
    local32, n32 = t.astype(np.int32), n.astype(np.int32)
    ji, jj = tri_decode_pallas(jnp.asarray(local32.reshape(-1, 128)),
                               jnp.asarray(n32.reshape(-1, 128)),
                               steps=pk.MAX_SEARCH_STEPS, interpret=True)
    ti, tj = pk.tri_decode(torch.from_numpy(local32), torch.from_numpy(n32),
                           pk.MAX_SEARCH_STEPS)
    assert np.array_equal(ti.numpy(), np.asarray(ji).reshape(-1))
    assert np.array_equal(tj.numpy(), np.asarray(jj).reshape(-1))
    ok = n >= 2
    i, j = ti.numpy()[ok].astype(np.int64), tj.numpy()[ok].astype(np.int64)
    assert np.array_equal(i * (n[ok] - 1) - i * (i - 1) // 2 + j - i - 1, t[ok])


def _words(seed, count, sentinel_frac=0.1, dup_frac=0.3):
    rng = np.random.default_rng(seed)
    w = (rng.integers(0, 1 << 46, count, dtype=np.int64) << 16) \
        | rng.integers(0, 0xFFFF, count, dtype=np.int64)
    dup = rng.random(count) < dup_frac
    w[dup] = w[rng.integers(0, count, int(dup.sum()))]
    w[rng.random(count) < sentinel_frac] = -1
    return w


def _jax_pass(w, p):
    """One 4-bit pass of the reference: ``radix_pass_pallas`` (interpret
    mode) for the in-tile ranks and tile histograms, then the digit-major
    base scan and the scatter in numpy, as ``_radix_sort_kernel`` does."""
    hi = (w >> np.uint64(32)).astype(np.uint32).reshape(-1, 128)
    lo = (w & np.uint64(0xFFFFFFFF)).astype(np.uint32).reshape(-1, 128)
    jrank, jhist = radix_pass_pallas(jnp.asarray(hi), jnp.asarray(lo), p=p,
                                     interpret=True)
    hist = np.asarray(jhist)[:, :16].astype(np.int64)     # (n_tiles, 16)
    flat = hist.T.reshape(-1)
    base = (np.cumsum(flat) - flat).reshape(16, -1)
    digit = ((w >> np.uint64(4 * p)) & np.uint64(0xF)).astype(np.int64)
    tile = np.arange(len(w)) // 1024
    out = np.empty_like(w)
    out[base[digit, tile] + np.asarray(jrank).reshape(-1)] = w
    return out


@pytest.mark.parametrize("q,bits", [(0, 8), (1, 4), (3, 8), (6, 4), (7, 8)])
def test_sort_pass_plain_matches_pallas_interpret(q, bits):
    """An 8-bit pass at digit q equals the reference's 4-bit passes 2q then
    2q+1 (only 2q when the pass is masked to 4 bits)."""
    w = _words(q, 4 * 1024).view(np.uint64)
    want = _jax_pass(w, 2 * q)
    if bits == 8:
        want = _jax_pass(want, 2 * q + 1)
    got = sort_ops.sort_pass_torch(torch.from_numpy(w.view(np.int64)), q, bits)
    assert np.array_equal(got.numpy().view(np.uint64), want)


@pytest.mark.parametrize("n_digits,last_bits", [(1, 8), (4, 4), (8, 8)])
def test_digit_counts_plain_matches_numpy(n_digits, last_bits):
    w = _words(n_digits, 3000).view(np.uint64)
    got = sort_ops.digit_counts(torch.from_numpy(w.view(np.int64)), n_digits,
                                last_bits).numpy()
    for q in range(n_digits):
        bits = last_bits if q == n_digits - 1 else 8
        d = (w >> np.uint64(8 * q)) & np.uint64((1 << bits) - 1)
        assert np.array_equal(got[q], np.bincount(d.astype(np.int64),
                                                  minlength=256))


@pytest.mark.parametrize("n_passes", [4, 7, 12, 15, 16])
@pytest.mark.parametrize("count", [0, 1, 1000, 3000])
def test_sort_words_matches_numpy_radix_oracle(n_passes, count):
    w = _words(count + n_passes, count)
    got = sort_ops.sort_words(torch.from_numpy(w), backend="radix",
                              n_passes=n_passes)
    want = np_radix_sort_words(w.view(np.uint64), n_passes)
    assert np.array_equal(got.numpy().view(np.uint64), want)
    if n_passes == 16:
        assert np.array_equal(want, np.sort(w.view(np.uint64)))
        comp = sort_ops.sort_words(torch.from_numpy(w), backend="comparator")
        assert torch.equal(comp, got)


def test_sort_words_sentinel_only_and_bad_args():
    w = torch.full((2048,), -1, dtype=torch.int64)
    assert torch.equal(sort_ops.sort_words(w, backend="radix", n_passes=4), w)
    with pytest.raises(ValueError):
        sort_ops.sort_words(w, backend="radix", n_passes=3)
    with pytest.raises(ValueError):
        sort_ops.sort_words(w, backend="bitonic")


def _result(seed, n_blocks=40, max_size=30, n_records=300):
    """A BlockingResult with overlapping blocks (shared pairs)."""
    rng = np.random.default_rng(seed)
    rids, keys = [], []
    for b in range(n_blocks):
        size = int(rng.integers(1, max_size))
        rids.append(rng.choice(n_records, size, replace=False))
        keys.append(np.full(size, b * 0x9E3779B97F4A7C15 % (1 << 64), np.uint64))
    rids = np.concatenate(rids).astype(np.int64)
    key = np.concatenate(keys)
    kw = dict(rids=rids, key_hi=(key >> np.uint64(32)).astype(np.uint32),
              key_lo=(key & np.uint64(0xFFFFFFFF)).astype(np.uint32), stats=[],
              num_records=n_records)
    return jhdb.BlockingResult(**kw), hdb.BlockingResult(**kw)


def _assert_pairset(tp, jp):
    for field in ("a", "b", "src_size"):
        assert np.array_equal(getattr(tp, field), getattr(jp, field)), field
    assert (tp.exact, tp.total_slots) == (jp.exact, jp.total_slots)


@pytest.mark.parametrize("budget", [50_000_000, 1500], ids=["exact", "sampled"])
@pytest.mark.parametrize("seed", [1, 6, 7])
def test_dedupe_pairs_matches_pallas_radix_reference(budget, seed):
    jr, tr = _result(seed)
    jblk, tblk = jpairs.build_blocks(jr), pairs.build_blocks(tr, device="cpu")
    for f in ("key_hi", "key_lo", "start", "size", "members"):
        assert np.array_equal(getattr(tblk, f), getattr(jblk, f))
    jp = jpairs.dedupe_pairs(jblk, budget=budget, backend="pallas",
                             sort_backend="radix", interpret=True,
                             chunk_pairs=8192)
    assert pairs._sort_kind(tblk) == "radix"
    tp = pairs.dedupe_pairs(tblk, budget=budget, device="cpu")
    _assert_pairset(tp, jp)
    assert tp.exact == (budget > tblk.num_pair_slots)
    assert np.array_equal(tp.device_a.numpy(), tp.a.astype(np.int32))
    assert np.array_equal(tp.device_b.numpy(), tp.b.astype(np.int32))
    num = pairs.dedupe_pairs(tblk, budget=budget, backend="numpy", device="cpu")
    _assert_pairset(num, jp)


def test_contract_failure_falls_back_to_numpy_with_warning():
    jr, tr = _result(2)
    tblk = pairs.build_blocks(tr, device="cpu")
    with pytest.warns(RuntimeWarning, match="falling back to numpy"):
        tp = pairs.dedupe_pairs(tblk, budget=2**31, device="cpu")
    jp = jpairs.dedupe_pairs(jpairs.build_blocks(jr), budget=2**31,
                             backend="numpy")
    _assert_pairset(tp, jp)
    assert tp.device_a is None


def test_radix_beyond_pack_bound_uses_comparator():
    jr, tr = _result(3)
    big = (1 << 23) + 5
    for r in (jr, tr):
        r.rids[::3] += big
    tblk = pairs.build_blocks(tr, device="cpu")
    assert pairs._sort_kind(tblk) == "comparator"
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        tp = pairs.dedupe_pairs(tblk, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        jp = jpairs.dedupe_pairs(jpairs.build_blocks(jr), backend="pallas",
                                 sort_backend="radix", interpret=True)
    _assert_pairset(tp, jp)
    assert np.array_equal(tp.device_a.numpy(), tp.a.astype(np.int32))


def test_decode_chunk_matches_reference_decode():
    jr, tr = _result(4)
    blk = pairs.build_blocks(tr, device="cpu")
    cum = ref.cum_pair_counts(blk.size)
    total = int(cum[-1])
    a, b, s, v = pk.decode_chunk(
        torch.from_numpy(cum), torch.from_numpy(blk.start.astype(np.int32)),
        torch.from_numpy(blk.size.astype(np.int32)),
        torch.from_numpy(blk.members.astype(np.int32)), 0, total,
        chunk=total + 100, steps=pk.search_steps_for(int(blk.size.max())))
    ra, rb, rs = ref.decode_slots_ref(blk.start, blk.size, blk.members,
                                      np.arange(total))
    vm = v.numpy()
    assert vm.sum() == total and not vm[total:].any()
    assert np.array_equal(a.numpy()[vm], ra) and np.array_equal(b.numpy()[vm], rb)
    assert np.array_equal(s.numpy()[vm], rs)


def test_empty_and_distributed():
    empty = pairs.Blocks(*(np.zeros((0,), t) for t in
                           (np.uint32, np.uint32, np.int64, np.int64, np.int64)))
    ps = pairs.dedupe_pairs(empty, device="cpu")
    assert ps.exact and ps.total_slots == 0 and len(ps.a) == 0
    _, tr = _result(5)
    # the routed backend needs a process group; none is initialised here
    with pytest.raises(ValueError, match="init_process_group"):
        pairs.dedupe_pairs(pairs.build_blocks(tr, device="cpu"), backend="distributed",
                           device="cpu")
    with pytest.raises(ValueError):
        pairs.dedupe_pairs(pairs.build_blocks(tr, device="cpu"), backend="bogus",
                           device="cpu")


@pytest.mark.parametrize("total,budget", [(10, 10), (1000, 600), (5000, 1500),
                                          (10**7, 30_000), (2**40, 5000)])
def test_sample_slots_matches_reference(total, budget):
    got = pairs._sample_slots(total, budget, 3, torch.device("cpu")).numpy()
    assert np.array_equal(got, jpairs._sample_slots(total, budget, 3))
    assert len(got) == min(total, budget) and np.all(np.diff(got) > 0)


def test_radix_passes_for_matches_reference():
    from repro.kernels.pairs import radix_passes_for as jpasses
    for max_rid in (0, 1, 255, 4096, (1 << 23) - 1):
        assert pk.radix_passes_for(max_rid) == jpasses(max_rid)
