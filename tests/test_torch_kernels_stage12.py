"""Port parity: the stage 1-2 kernels' CPU paths against the Pallas kernels.

For hash64 (combine64, mix64), minhash and cms, the same numpy inputs
from fixed seeds go through the JAX wrapper with its Pallas kernel in
interpret mode (``use_kernel=True, interpret=True``, as
``tests/test_kernels.py`` runs it) and through the port's wrapper on CPU
tensors, which takes the kernel's plain version. The shapes are those of
``tests/test_kernels.py``. Tolerance: exact equality of every output.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.cms import cms_update as j_cms_update  # noqa: E402
from repro.kernels.hash64 import combine64 as j_combine64  # noqa: E402
from repro.kernels.hash64 import mix64_bulk as j_mix64_bulk  # noqa: E402
from repro.kernels.minhash import minhash as j_minhash  # noqa: E402
from repro_torch.core import u64  # noqa: E402
from repro_torch.kernels.cms import ops as cms_ops  # noqa: E402
from repro_torch.kernels.hash64 import ops as hash64_ops  # noqa: E402
from repro_torch.kernels.minhash import ops as minhash_ops  # noqa: E402


def _split(v):
    """numpy uint64 -> the JAX (hi, lo) uint32 limb arrays."""
    limbs = u64.to_limbs(u64.from_numpy_u64(v))
    return jnp.asarray(limbs[..., 0]), jnp.asarray(limbs[..., 1])


def _joined(hi, lo):
    return np.stack([np.asarray(hi), np.asarray(lo)], axis=-1)


# ---------------------------------------------------------------------------
# minhash (B3)
# ---------------------------------------------------------------------------

def _minhash_both(tokens, mask, m):
    want = j_minhash(jnp.asarray(tokens), jnp.asarray(mask), m,
                     use_kernel=True, interpret=True)
    got = minhash_ops.minhash(torch.from_numpy(tokens.astype(np.int64)),
                              torch.from_numpy(mask), m)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("r,t,m", [(8, 16, 8), (64, 128, 24), (100, 70, 16),
                                   (257, 129, 32), (300, 8, 24), (300, 24, 24)])
def test_minhash_matches_pallas(r, t, m):
    rng = np.random.default_rng(r * 1000 + t)
    tokens = rng.integers(0, 1 << 32, (r, t), dtype=np.uint64).astype(np.uint32)
    mask = rng.random((r, t)) < 0.8
    _minhash_both(tokens, mask, m)


@pytest.mark.parametrize("mask_kind", ["all", "none", "empty_rows"])
def test_minhash_mask_edge_cases_match_pallas(mask_kind):
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 1 << 31, (32, 16), dtype=np.int64).astype(np.uint32)
    if mask_kind == "all":
        mask = np.ones((32, 16), bool)
    elif mask_kind == "none":
        mask = np.zeros((32, 16), bool)
    else:
        mask = np.repeat([[True], [False]], [16, 16], axis=0) * np.ones((1, 16), bool)
    _minhash_both(tokens, mask, 8)


@pytest.mark.parametrize("seed", [0, 0x3141, (1 << 64) - 1])
def test_minhash_addends_match_pallas_constants(seed):
    """The plain version's per-hash addends (which the kernel computes from
    the seed on the card) are the JAX kernel's ``add_hi``/``add_lo`` words."""
    import importlib
    jax_mh = importlib.import_module("repro.kernels.minhash.minhash")
    mh = importlib.import_module("repro_torch.kernels.minhash.minhash")
    m = 40
    got = [a & 0xFFFFFFFFFFFFFFFF for a in mh.hash_addends(m, seed)]
    want = [((seed + 977 * i + 1) * jax_mh._GAMMA) & jax_mh._MASK64 for i in range(m)]
    assert got == want


# ---------------------------------------------------------------------------
# hash64 (B1 combine64, B2 mix64)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(16,), (1000,), (64, 80), (3, 5, 7)])
def test_combine64_matches_pallas(shape):
    rng = np.random.default_rng(int(np.prod(shape)))
    a = rng.integers(0, 1 << 64, shape, dtype=np.uint64)
    b = rng.integers(0, 1 << 64, shape, dtype=np.uint64)
    b.reshape(-1)[::5] = a.reshape(-1)[::5]          # ties: a == b
    want = j_combine64(*_split(a), *_split(b), use_kernel=True, interpret=True)
    got = hash64_ops.combine64(u64.from_numpy_u64(a), u64.from_numpy_u64(b))
    assert got.shape == shape
    assert np.array_equal(u64.to_limbs(got), _joined(*want))


def test_combine64_is_symmetric_under_swap():
    rng = np.random.default_rng(5)
    a = u64.from_numpy_u64(rng.integers(0, 1 << 64, 512, dtype=np.uint64))
    b = u64.from_numpy_u64(rng.integers(0, 1 << 64, 512, dtype=np.uint64))
    assert torch.equal(hash64_ops.combine64(a, b), hash64_ops.combine64(b, a))
    want = j_combine64(*_split(u64.to_numpy_u64(b)), *_split(u64.to_numpy_u64(a)),
                       use_kernel=True, interpret=True)
    assert np.array_equal(u64.to_limbs(hash64_ops.combine64(a, b)), _joined(*want))


@pytest.mark.parametrize("n", [1, 512, 5000])
def test_mix64_bulk_matches_pallas(n):
    rng = np.random.default_rng(n)
    v = rng.integers(0, (1 << 64) - 1, n, dtype=np.uint64)
    want = j_mix64_bulk(*_split(v), use_kernel=True, interpret=True)
    got = hash64_ops.mix64_bulk(u64.from_numpy_u64(v))
    assert np.array_equal(u64.to_limbs(got), _joined(*want))


# ---------------------------------------------------------------------------
# cms (B4)
# ---------------------------------------------------------------------------

def _cms_both(idx, mask, width):
    want = j_cms_update(jnp.asarray(idx, jnp.int32), jnp.asarray(mask), width,
                        use_kernel=True, interpret=True, block_keys=256,
                        block_width=1024)
    got = cms_ops.cms_update(torch.from_numpy(idx.astype(np.int32)),
                             torch.from_numpy(mask), width)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("depth,n,width", [(1, 256, 2048), (4, 1024, 4096),
                                           (4, 3000, 2048), (6, 128, 8192)])
def test_cms_update_matches_pallas(depth, n, width):
    rng = np.random.default_rng(depth * n)
    _cms_both(rng.integers(0, width, (depth, n)), rng.random(n) < 0.7, width)


def test_cms_update_heavy_duplicates_match_pallas():
    """One bucket per row taken by thousands of entries (an over-sized
    block's key), the skew the kernel's warp aggregation must count."""
    rng = np.random.default_rng(12)
    depth, n, width = 4, 6000, 2048
    idx = rng.integers(0, width, (depth, n))
    hot = rng.random(n) < 0.8
    idx[:, hot] = rng.integers(0, width, (depth, 1))
    mask = rng.random(n) < 0.9
    _cms_both(idx, mask, width)


def test_cms_update_iteration_one_layout_matches_pallas():
    """The HDB iteration-1 key rows the kernel is sized for: 120 slots a
    record, a valid prefix of about 15, keys repeated across records."""
    rng = np.random.default_rng(13)
    records, slots, width = 40, 120, 4096
    mask = (np.arange(slots)[None, :] < rng.integers(0, 31, records)[:, None]).reshape(-1)
    pool = rng.integers(0, width, (4, 300))
    idx = pool[:, rng.integers(0, 300, records * slots)]
    _cms_both(idx, mask, width)
