"""Intra-object parallel ranged-read orchestration for the object-store
plugin (a copy of ``torchsnapshot_tpu/storage_plugins/_ranged.py``; it is
framework-neutral, and this package imports nothing of that one).

A single HTTP stream is capped well below the NIC's line rate (the
per-connection TCP window, per-stream throttling at the S3 front end),
while a handful of concurrent ranged GETs scale nearly linearly until the
NIC saturates.  Unlike fs there is no OS readahead to lose by splitting, so
the fan-out is unconditional above ``TPUSNAP_CLOUD_PARALLEL_MIN_BYTES``;
``TPUSNAP_PARALLEL_READ_WAYS`` pins the way count (1 disables).

``read_plan`` validates the destination and the range, ``ranged_chunks``
decides the fan-out, ``orchestrated_read`` runs the read flow and
``execute_fanout`` submits the ranges with the straggler discipline.
"""

from __future__ import annotations

from concurrent.futures import wait as _futures_wait
from typing import Callable, List, Optional, Tuple

# The JAX package's fs chunk reads share these caps.
PARALLEL_READ_CHUNK_BYTES = 32 * 1024 * 1024
PARALLEL_READ_MAX_WAYS = 8


def read_plan(
    byte_range: Optional[List[int]], into
) -> Tuple[int, Optional[int], Optional[memoryview]]:
    """``(base_offset, total_bytes_or_None, into_view_or_None)`` for a read
    request.  Validates that an explicit range and a destination view agree
    on the extent — the same contract fs.py enforces: never silently read a
    different extent than the target expects."""
    into_view = memoryview(into).cast("B") if into is not None else None
    if (
        into_view is not None
        and byte_range is not None
        and into_view.nbytes != byte_range[1] - byte_range[0]
    ):
        # RuntimeError, the class every other extent mismatch of the
        # object-store plugin raises.
        raise RuntimeError(
            f"into-view is {into_view.nbytes} bytes, range is "
            f"{byte_range[1] - byte_range[0]}"
        )
    if into_view is not None:
        total: Optional[int] = into_view.nbytes
    elif byte_range is not None:
        total = byte_range[1] - byte_range[0]
    else:
        total = None
    base = byte_range[0] if byte_range is not None else 0
    return base, total, into_view


def ranged_chunks(total: Optional[int]) -> Optional[List[Tuple[int, int]]]:
    """``[(offset, length), ...]`` covering ``[0, total)`` when a read of
    ``total`` bytes should fan out across concurrent ranged requests;
    ``None`` when a single stream is the right call (small read, unknown
    size, or the knob pins ways to 1)."""
    from .. import knobs

    if total is None:
        return None
    pinned = knobs.get_parallel_read_ways()
    if pinned is not None and pinned <= 1:
        return None
    if total < max(knobs.get_cloud_parallel_min_bytes(), 2):
        return None
    if pinned is not None:
        # The pin overrides the chunk-size heuristic, clamped to the
        # per-read cap (same 8-way cap as fs.py's chunk reads).
        ways = min(pinned, PARALLEL_READ_MAX_WAYS)
    else:
        ways = min(
            PARALLEL_READ_MAX_WAYS, max(2, total // PARALLEL_READ_CHUNK_BYTES)
        )
    if ways <= 1:
        return None
    chunk = -(-total // ways)
    return [(off, min(chunk, total - off)) for off in range(0, total, chunk)]


def orchestrated_read(
    *,
    byte_range: Optional[List[int]],
    into,
    chunk_executor,
    stream_into: Callable[..., None],
    probe_stat: Callable[[], Tuple[int, Optional[str]]],
    single_read: Callable[[], bytearray],
    label: str,
):
    """The object-store read flow:

    - large known-size reads fan out across concurrent ranged fetches,
      **pinned to one object version**: ``probe_stat()`` returns
      ``(size, version_token)`` (S3 ETag, GCS generation) and every ranged
      fetch must match it — without the pin, a concurrent overwrite could
      interleave bytes from two versions into one buffer, a torn read the
      single-stream path cannot produce;
    - an un-ranged into-read's extent is verified against the probed size —
      every planned range is in-bounds even when the object is bigger than
      the view, so a fan-out would otherwise silently truncate where one
      stream errors;
    - sub-threshold into-reads stream straight into the destination
      (``stream_into(None, None, view)`` = whole object, with the stream's
      own overflow/short checks enforcing the extent);
    - everything else takes the backend's plain single read.

    ``stream_into(start, end_exclusive, view, version=None)`` must stream
    exactly ``view.nbytes`` bytes into ``view`` or raise; ``(None, None)``
    means the whole object; a non-None ``version`` must fail the fetch if
    the object no longer matches it."""
    base, total, into_view = read_plan(byte_range, into)
    plan = ranged_chunks(total)
    if plan is not None:
        size, version = probe_stat()
        unranged_into = into is not None and byte_range is None
        if unranged_into and size >= 0 and size != total:
            raise RuntimeError(
                f"{label} is {size} bytes, into-view expects {total}"
            )
        if byte_range is not None and size >= 0 and byte_range[1] > size:
            # The probe already knows the true size — name the real
            # problem instead of letting each chunk fail with its own
            # short-read/ignored-Range diagnostic.
            raise RuntimeError(
                f"byte range [{byte_range[0]}, {byte_range[1]}) extends "
                f"past the end of {label} ({size} bytes)"
            )
        if version is None or (unranged_into and size < 0):
            # No version token to pin to, or no size to verify the extent
            # against (some emulators omit ETag/generation/size): fail
            # closed into a single stream — its own length checks enforce
            # the extent, and one stream cannot tear across versions.
            plan = None
    if plan is not None:
        out = into if into is not None else bytearray(total)
        view = into_view if into_view is not None else memoryview(out).cast("B")
        execute_fanout(
            chunk_executor,
            lambda s, e, v, cancel=None: stream_into(
                s, e, v, version=version, cancel=cancel
            ),
            base,
            view,
            plan,
        )
        return out
    if into_view is not None:
        # Read-into-place: bytes land in the restore target's own memory
        # and the consumer skips its copy.
        if byte_range is not None:
            stream_into(base, base + total, into_view)
        else:
            stream_into(None, None, into_view)
        return into
    return single_read()


def execute_fanout(
    executor,
    fetch_range: Callable[..., None],
    base: int,
    view: memoryview,
    plan: List[Tuple[int, int]],
) -> None:
    """Run ``fetch_range(start, end_exclusive, sub_view, cancel=Event)``
    per chunk on the executor.  On any chunk failure, pending chunks are
    cancelled, the shared cancel event is set (running chunks check it
    between retry attempts, so a sibling's hard failure stops their
    minutes-scale backoff schedules), and running chunks are awaited
    BEFORE the error propagates — a straggler landing bytes in the
    caller's buffer after read() has raised would race with whatever the
    caller does with that memory next (error-path retry, reuse)."""
    import threading

    cancel = threading.Event()
    futures = [
        executor.submit(
            fetch_range,
            base + off,
            base + off + length,
            view[off : off + length],
            cancel=cancel,
        )
        for off, length in plan
    ]
    try:
        for fut in futures:
            fut.result()
    except BaseException:
        cancel.set()
        for fut in futures:
            fut.cancel()
        _futures_wait(futures)
        raise
