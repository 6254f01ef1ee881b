"""LSB radix sort passes: the CUDA kernels' wrappers and plain versions.

The kernels (``csrc/radix_sort.cu``) replace the TPU kernel
``radix_pass_pallas`` (``src/repro/kernels/sort/sort.py:71``), which
ranked one 4-bit digit within (8, 128) tiles and left the base scan and
the scatter to XLA. Here a pass takes an 8-bit digit and does all of it:

- ``digit_counts``: every digit position's 256-bin histogram in one read
  of the words (one launch a sort);
- ``sort_pass``: one onesweep pass, the words stably partitioned by one
  digit (one launch a pass).

Pass counts elsewhere are in 4-bit units (``RADIX_BITS``, as in the
reference); a sort of ``n_passes`` of them takes ``ceil(n_passes / 2)``
8-bit passes, the last masked to 4 bits when ``n_passes`` is odd.
"""
from __future__ import annotations

import ctypes

import torch

from .._build import Kernel, c_helper, check_cuda, ptr

# the unit of n_passes (the reference's digit width)
RADIX_BITS = 4
MAX_PASSES = 64 // RADIX_BITS
# the kernels' digit
DIGIT_BITS = 8
RADIX = 1 << DIGIT_BITS
MAX_DIGITS = 64 // DIGIT_BITS
# the digit counts are int32
MAX_WORDS = (1 << 31) - 1
# words a step of the plain rank's one-hot cumsum (about 4.5 GB of
# transients on the card; fewer, larger steps launch fewer kernels)
_PLAIN_CHUNK = 1 << 21

COUNTS_KERNEL = Kernel("radix_digit_counts", "radix_sort.cu",
                       "radix_counts_launch",
                       [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_int, ctypes.c_void_p])
PASS_KERNEL = Kernel("radix_sort", "radix_sort.cu", "radix_pass_launch",
                     [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                      ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_longlong])


def digit_bits(n_passes: int):
    """The 8-bit passes covering ``n_passes`` 4-bit digits: the bit width
    of each (8, and 4 for the last when ``n_passes`` is odd)."""
    full, half = divmod(int(n_passes), 2)
    return [DIGIT_BITS] * full + [RADIX_BITS] * half


def digit_of(words: torch.Tensor, q: int, bits: int) -> torch.Tensor:
    """Bits ``[8q, 8q + bits)`` of each u64 word, as int64 in [0, 2**bits).

    The mask after the arithmetic shift keeps exactly those bits, so the
    sentinel ``-1`` has every digit all ones.
    """
    return (words >> (q * DIGIT_BITS)) & ((1 << bits) - 1)


def _check_digit(q: int, bits: int) -> None:
    if not 0 <= q < MAX_DIGITS:
        raise ValueError(f"digit {q} outside [0, {MAX_DIGITS})")
    if bits not in (RADIX_BITS, DIGIT_BITS):
        raise ValueError(f"bits must be {RADIX_BITS} or {DIGIT_BITS}, got {bits}")


def _check_words(words: torch.Tensor) -> None:
    check_cuda("words", words, torch.int64)
    if words.numel() > MAX_WORDS:
        raise ValueError(f"{words.numel()} words exceed {MAX_WORDS}")


def digit_counts_torch(words: torch.Tensor, n_digits: int,
                       last_bits: int) -> torch.Tensor:
    """Plain version of ``digit_counts``: one bincount a digit position."""
    rows = [torch.bincount(digit_of(words, q, DIGIT_BITS if q < n_digits - 1
                                    else last_bits), minlength=RADIX)
            for q in range(n_digits)]
    return torch.stack(rows).to(torch.int32)


def digit_counts(words: torch.Tensor, n_digits: int,
                 last_bits: int) -> torch.Tensor:
    """(n,) int64 words -> (n_digits, 256) int32 counts of each 8-bit digit
    value at positions ``0 .. n_digits - 1``, the last masked to
    ``last_bits``. CUDA tensors launch the kernel; CPU tensors take the
    plain version."""
    if not 1 <= n_digits <= MAX_DIGITS:
        raise ValueError(f"n_digits {n_digits} outside [1, {MAX_DIGITS}]")
    _check_digit(n_digits - 1, last_bits)
    if words.device.type == "cpu":
        return digit_counts_torch(words, n_digits, last_bits)
    _check_words(words)
    if words.numel() == 0:
        return torch.zeros((n_digits, RADIX), dtype=torch.int32,
                           device=words.device)
    counts = torch.empty((n_digits, RADIX), dtype=torch.int32,
                         device=words.device)
    COUNTS_KERNEL(ptr(words), words.numel(), n_digits, last_bits, ptr(counts))
    return counts


def sort_pass_torch(words: torch.Tensor, q: int, bits: int) -> torch.Tensor:
    """Plain version of ``sort_pass``: each word's rank among the earlier
    words of its digit from a one-hot cumsum, the digit-major base scan,
    and the scatter."""
    d = digit_of(words, q, bits)
    rank = torch.empty_like(d)
    seen = torch.zeros((RADIX, 1), dtype=torch.int64, device=words.device)
    digits = torch.arange(RADIX, device=words.device)[:, None]
    for lo in range(0, d.numel(), _PLAIN_CHUNK):
        dc = d[lo:lo + _PLAIN_CHUNK]
        # digit-major, so the cumsum runs along the contiguous dimension
        incl = (dc[None, :] == digits).cumsum(dim=1)
        incl += seen
        rank[lo:lo + _PLAIN_CHUNK] = incl[dc, torch.arange(dc.numel(),
                                                           device=d.device)] - 1
        seen = incl[:, -1:]
    seen = seen[:, 0]
    base = torch.cumsum(seen, 0) - seen
    out = torch.empty_like(words)
    out[base[d] + rank] = words
    return out


def sort_pass(words: torch.Tensor, q: int, bits: int,
              totals: torch.Tensor) -> torch.Tensor:
    """(n,) int64 words -> the words stably partitioned by ``digit_of(q,
    bits)``.

    ``totals`` is the (256,) int32 row ``q`` of ``digit_counts`` over
    ``words``; the kernel takes its global digit bases from it. CUDA
    tensors launch the kernel; CPU tensors take the plain version, which
    needs no totals.
    """
    _check_digit(q, bits)
    if words.device.type == "cpu":
        return sort_pass_torch(words, q, bits)
    _check_words(words)
    if words.numel() == 0:
        return torch.empty_like(words)
    if words.data_ptr() % 16:
        raise ValueError("words must be 16-byte aligned for the pass kernel")
    check_cuda("totals", totals, torch.int32)
    if totals.shape != (RADIX,):
        raise ValueError(f"totals must have shape ({RADIX},), got "
                         f"{tuple(totals.shape)}")
    n = words.numel()
    out = torch.empty_like(words)
    status_len = c_helper("radix_sort.cu", "radix_pass_status_len",
                          [ctypes.c_longlong], ctypes.c_longlong)(n)
    status = torch.empty(status_len, dtype=torch.int64, device=words.device)
    PASS_KERNEL(ptr(words), ptr(out), n, q * DIGIT_BITS, bits, ptr(totals),
                ptr(status), status_len)
    return out
