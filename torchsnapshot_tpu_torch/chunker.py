"""Chunk-boundary decisions: plan-time slab packing and content-defined
chunking.

Counterpart of ``torchsnapshot_tpu/chunker.py``, with the same frozen
constants, so both packages cut the same bytes at the same edges and name
the same CAS chunks:

1. Structural (plan time): :func:`plan_slabs`, the greedy packing of small
   writes into slabs (batcher.py), decided from dtype×shape before any
   byte is staged.
2. Content-defined (write time): :func:`boundaries`, FastCDC-style
   rolling-hash chunking (gear hash, normalized two-mask selection) over
   staged bytes.  The CAS writer (cas.py) stores a large payload as the
   sub-chunks between these edges, so an insertion rewrites only the
   chunks it overlaps: every edge after the edit re-synchronizes within
   about one chunk.

The candidate scan runs in the native library (``tpusnap_cdc_boundaries``)
on the worker pool; :func:`boundaries_py` is the numpy implementation of
the same specification, and tests hold the two (and the JAX package) equal.

Algorithm (frozen: changing any constant changes every boundary):

- ``GEAR[256]``: u64 table from splitmix64 seeded with ``_GEAR_SEED``.
- Rolling hash from the START of the buffer: ``h_0 = GEAR[b_0]``,
  ``h_i = (h_{i-1} << 1) + GEAR[b_i]  (mod 2^64)``, which depends only on
  the trailing 64 bytes.
- Selection: with ``bits = floor(log2(avg))``,
  ``mask_s = (1 << min(bits + 2, 62)) - 1`` applies up to the average
  point, ``mask_l = (1 << max(bits - 2, 1)) - 1`` beyond it; a candidate
  at index ``i`` cuts a chunk end at ``i + 1``; chunks are forced at
  ``max`` and never end before ``min`` (except the buffer's tail).
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

# Seed of the gear table: part of the boundary definition.
_GEAR_SEED = 0x7470_7573_6E61_7031  # "tpusnap1"
_M64 = (1 << 64) - 1

_GEAR: Optional[np.ndarray] = None


def gear_table() -> np.ndarray:
    """The 256-entry u64 gear table, from splitmix64 over ``_GEAR_SEED``
    (the native library derives the same table)."""
    global _GEAR
    if _GEAR is None:
        out = np.empty(256, dtype=np.uint64)
        x = _GEAR_SEED
        for i in range(256):
            x = (x + 0x9E3779B97F4A7C15) & _M64
            z = x
            z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
            z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
            out[i] = (z ^ (z >> 31)) & _M64
        _GEAR = out
    return _GEAR


def masks_for(avg_size: int) -> Tuple[int, int]:
    """(mask_s, mask_l) for an average chunk size: stricter before the
    average point, looser after."""
    bits = avg_size.bit_length() - 1
    mask_s = (1 << min(bits + 2, 62)) - 1
    mask_l = (1 << max(bits - 2, 1)) - 1
    return mask_s, mask_l


def params() -> Tuple[int, int, int]:
    """(min, avg, max) chunk sizes from the ``TPUSNAP_CDC_*`` knobs."""
    from . import knobs

    return knobs.get_cdc_params()


def should_split(nbytes: int, max_size: Optional[int] = None) -> bool:
    """Whether a staged payload gets content-defined sub-chunks: the knob
    is on and the payload exceeds one max-size chunk."""
    from . import knobs

    if not knobs.cdc_enabled():
        return False
    if max_size is None:
        max_size = params()[2]
    return nbytes > max_size


# Candidate-scan block of the numpy path: bounds its temporaries (16 bytes
# per input byte).
_PY_BLOCK = 1 << 22


def _candidates_py(view: memoryview, mask_s: int, mask_l: int):
    """(indices, strict flags) of every index with ``(h_i & mask_l) == 0``,
    ascending; mask_s's bits contain mask_l's, so one scan finds both."""
    data = np.frombuffer(view, dtype=np.uint8)
    n = data.size
    gear = gear_table()
    idx_parts: List[np.ndarray] = []
    flag_parts: List[np.ndarray] = []
    m_l = np.uint64(mask_l)
    m_s = np.uint64(mask_s)
    for start in range(0, n, _PY_BLOCK):
        stop = min(n, start + _PY_BLOCK)
        lo = max(0, start - 63)
        g = gear[data[lo:stop]]
        # h_i = sum_{j=0..63} GEAR[b_{i-j}] << j (mod 2^64): a 63-byte
        # prefix makes every value in the block exact.
        h = g.copy()
        for j in range(1, 64):
            np.add(h[j:], g[:-j] << np.uint64(j), out=h[j:], casting="unsafe")
        hh = h[start - lo :]
        cand = np.flatnonzero((hh & m_l) == 0)
        if cand.size:
            idx_parts.append(cand.astype(np.int64) + start)
            flag_parts.append((hh[cand] & m_s) == 0)
    if not idx_parts:
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=bool)
    return np.concatenate(idx_parts), np.concatenate(flag_parts)


def _walk(n: int, cand_idx, cand_s, min_size: int, avg_size: int, max_size: int) -> List[int]:
    """The selection walk (the native library implements the same): chunk
    ends from the candidate stream, enforcing min, avg and max."""
    ends: List[int] = []
    last = 0
    while n - last > min_size:
        window_end = min(last + max_size, n)
        norm_end = min(last + avg_size, window_end)
        cut = 0
        lo = int(np.searchsorted(cand_idx, last + min_size - 1, side="left"))
        hi = int(np.searchsorted(cand_idx, norm_end - 1, side="right"))
        for k in range(lo, hi):
            if cand_s[k]:
                cut = int(cand_idx[k]) + 1
                break
        if cut == 0:
            hi2 = int(np.searchsorted(cand_idx, window_end - 1, side="right"))
            if hi2 > hi:
                cut = int(cand_idx[hi]) + 1
        if cut == 0:
            # No candidate: a max-size chunk mid-buffer, the rest at the tail.
            cut = window_end if window_end < n else n
        ends.append(cut)
        last = cut
    if last < n:
        ends.append(n)
    return ends


def _validate(min_size: int, avg_size: int, max_size: int) -> None:
    if not (64 <= min_size < avg_size <= max_size):
        raise ValueError(
            "CDC parameters must satisfy 64 <= min < avg <= max, got "
            f"min={min_size} avg={avg_size} max={max_size}"
        )


def _byte_view(view: Any) -> memoryview:
    mv = memoryview(view)
    if not mv.c_contiguous:
        mv = memoryview(bytes(mv))
    return mv.cast("B")


def boundaries_py(view: Any, min_size: int, avg_size: int, max_size: int) -> List[int]:
    """Chunk ends computed with numpy: the specification the native scan
    is held to."""
    _validate(min_size, avg_size, max_size)
    mv = _byte_view(view)
    n = mv.nbytes
    if n == 0:
        return []
    if n <= min_size:
        return [n]
    mask_s, mask_l = masks_for(avg_size)
    cand_idx, cand_s = _candidates_py(mv, mask_s, mask_l)
    return _walk(n, cand_idx, cand_s, min_size, avg_size, max_size)


def boundaries(
    view: Any,
    min_size: Optional[int] = None,
    avg_size: Optional[int] = None,
    max_size: Optional[int] = None,
) -> List[int]:
    """Content-defined chunk END offsets of ``view`` (ascending, the last
    its length) under the knobbed (or given) sizes, from the native scan."""
    if min_size is None or avg_size is None or max_size is None:
        k_min, k_avg, k_max = params()
        min_size = k_min if min_size is None else min_size
        avg_size = k_avg if avg_size is None else avg_size
        max_size = k_max if max_size is None else max_size
    _validate(min_size, avg_size, max_size)
    from .native_io import NativeFileIO

    return NativeFileIO.get().cdc_boundaries(view, min_size, avg_size, max_size)


def split(view: Any, ends: Sequence[int]) -> List[memoryview]:
    """The chunk views of ``view`` for its boundary ends."""
    mv = _byte_view(view)
    out: List[memoryview] = []
    last = 0
    for end in ends:
        out.append(mv[last:end])
        last = end
    return out


def plan_slabs(items: Sequence, sizes: Sequence[int], threshold: int):
    """Greedy plan-order packing of ``items`` into slabs capped at
    ``threshold`` bytes: a list of (item list, total bytes), in plan order.
    The same grouping gives the same slab names in both packages.  Order
    preserving, not content-aware: with content-defined chunking on, the
    physical chunk edges inside a slab come from :func:`boundaries`."""
    groups = []
    group: List = []
    group_bytes = 0
    for item, nbytes in zip(items, sizes):
        if group and group_bytes + nbytes > threshold:
            groups.append((group, group_bytes))
            group = []
            group_bytes = 0
        group.append(item)
        group_bytes += nbytes
    if group:
        groups.append((group, group_bytes))
    return groups
