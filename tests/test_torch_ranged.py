"""The port's ranged-read machinery (torchsnapshot_tpu_torch.storage_plugins.
_ranged, a copy of the JAX package's): mirrors of the 11 tests of
tests/test_ranged.py — read-plan validation, the fan-out decision's
size and knob boundaries, out-of-order reassembly and the cancel-and-drain
discipline of execute_fanout — and the read batcher's merge-gap
boundaries.  Each plan is also held against the JAX package's on the same
input."""

import random
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from torchsnapshot_tpu.storage_plugins import _ranged as jax_ranged
from torchsnapshot_tpu_torch import knobs
from torchsnapshot_tpu_torch.storage_plugins import _ranged

from torch_env import default_knob_env, no_leaked_threads  # noqa: F401  fixtures

pytestmark = pytest.mark.usefixtures("no_leaked_threads")


def _override_merge_gap(value: int):
    return knobs.override_env(knobs.MAX_READ_MERGE_GAP_ENV_VAR, str(value))


# ------------------------------------------------------------------ read_plan


def test_read_plan_derives_base_total_and_view():
    base, total, view = _ranged.read_plan([100, 356], None)
    assert (base, total, view) == (100, 256, None)

    buf = bytearray(256)
    base, total, view = _ranged.read_plan([100, 356], buf)
    assert (base, total) == (100, 256)
    assert view.nbytes == 256

    base, total, view = _ranged.read_plan(None, buf)
    assert (base, total) == (0, 256)

    base, total, view = _ranged.read_plan(None, None)
    assert (base, total, view) == (0, None, None)


def test_read_plan_rejects_extent_mismatch():
    with pytest.raises(RuntimeError, match="into-view is 128"):
        _ranged.read_plan([0, 256], bytearray(128))


# -------------------------------------------------------------- ranged_chunks


def test_ranged_chunks_min_size_boundary():
    with knobs.override_cloud_parallel_min_bytes(1 << 20):
        assert _ranged.ranged_chunks(None) is None
        assert _ranged.ranged_chunks((1 << 20) - 1) is None  # below the floor
        plan = _ranged.ranged_chunks(1 << 20)  # exactly at the floor
        assert plan is not None and len(plan) >= 2


def test_ranged_chunks_pinned_ways():
    with knobs.override_cloud_parallel_min_bytes(1 << 10):
        with knobs.override_parallel_read_ways(1):
            assert _ranged.ranged_chunks(1 << 20) is None  # pin disables
        with knobs.override_parallel_read_ways(4):
            plan = _ranged.ranged_chunks(1 << 20)
            assert len(plan) == 4
        with knobs.override_parallel_read_ways(64):
            plan = _ranged.ranged_chunks(1 << 20)
            # Clamped to the shared per-read cap (same 8 as fs chunks).
            assert len(plan) <= _ranged.PARALLEL_READ_MAX_WAYS


def test_ranged_chunks_tile_exactly():
    """Whatever the fan-out decides, the plan tiles [0, total) exactly:
    ordered, gapless, non-overlapping (the reference's four sizes)."""
    with knobs.override_cloud_parallel_min_bytes(2), knobs.override_parallel_read_ways(5):
        for total in (2, 1023, 1 << 20, (1 << 20) + 7):
            plan = _ranged.ranged_chunks(total)
            assert plan is not None, total
            assert plan == jax_ranged.ranged_chunks(total), total
            cursor = 0
            for off, length in plan:
                assert off == cursor and length > 0, total
                cursor += length
            assert cursor == total


def test_ranged_chunks_auto_way_heuristic():
    with knobs.override_cloud_parallel_min_bytes(1):
        # One chunk-size worth → the minimum useful fan-out.
        plan = _ranged.ranged_chunks(_ranged.PARALLEL_READ_CHUNK_BYTES)
        assert len(plan) == 2
        # Huge reads cap at the per-read way limit.
        plan = _ranged.ranged_chunks(64 * _ranged.PARALLEL_READ_CHUNK_BYTES)
        assert len(plan) == _ranged.PARALLEL_READ_MAX_WAYS
        assert plan == jax_ranged.ranged_chunks(64 * _ranged.PARALLEL_READ_CHUNK_BYTES)


# ------------------------------------------------------------- execute_fanout


def test_execute_fanout_out_of_order_reassembly():
    """Ranges land in shuffled completion order; the buffer must still
    reassemble byte-exactly (each range writes only its own view)."""
    total = 64 * 1024
    expected = np.frombuffer(
        np.random.RandomState(0).bytes(total), np.uint8
    )
    out = bytearray(total)
    view = memoryview(out)
    plan = [(off, 4096) for off in range(0, total, 4096)]
    rng = random.Random(7)

    def fetch(start, end, sub_view, cancel=None):
        time.sleep(rng.random() * 0.01)  # scramble completion order
        sub_view[:] = expected.tobytes()[start:end]

    with ThreadPoolExecutor(max_workers=8) as pool:
        _ranged.execute_fanout(pool, fetch, 0, view, plan)
    assert bytes(out) == expected.tobytes()


def test_execute_fanout_failure_cancels_and_drains():
    """One failing range: the shared cancel event fires, siblings are
    awaited BEFORE the error propagates (no straggler may land bytes in
    the caller's buffer after the raise)."""
    total = 8 * 4096
    out = bytearray(total)
    plan = [(off, 4096) for off in range(0, total, 4096)]
    cancel_seen = threading.Event()
    in_flight = threading.Semaphore(0)

    def fetch(start, end, sub_view, cancel=None):
        if start == 0:
            # The first future the caller awaits: its raise triggers the
            # cancel-and-drain path while every sibling is still running.
            time.sleep(0.01)
            raise OSError("injected range failure")
        # Siblings observe the cancel event (their retry loops would bail).
        for _ in range(400):
            if cancel is not None and cancel.is_set():
                cancel_seen.set()
                return
            time.sleep(0.005)
        in_flight.release()  # a sibling outlived the drain — must not happen

    with ThreadPoolExecutor(max_workers=8) as pool:
        with pytest.raises(OSError, match="injected"):
            _ranged.execute_fanout(pool, fetch, 0, memoryview(out), plan)
    assert cancel_seen.is_set()
    assert not in_flight.acquire(blocking=False)


# ------------------------------------------------------- batcher merge gap


class _StubConsumer:
    def __init__(self, nbytes):
        self._nbytes = nbytes

    async def consume_buffer(self, buf, executor=None):
        pass

    def get_consuming_cost_bytes(self):
        return self._nbytes


def _reqs(ranges, path="slab"):
    from torchsnapshot_tpu_torch.io_types import ReadReq

    return [
        ReadReq(
            path=path,
            byte_range=list(r),
            buffer_consumer=_StubConsumer(r[1] - r[0]),
        )
        for r in ranges
    ]


def test_merge_gap_boundary_merges_at_and_splits_above():
    from torchsnapshot_tpu_torch.batcher import batch_read_requests

    with _override_merge_gap(100):
        # Hole of exactly the knob: merged into one spanning read.
        merged = batch_read_requests(_reqs([(0, 50), (150, 200)]))
        assert len(merged) == 1
        assert merged[0].byte_range == [0, 200]
        # One byte wider: two independent reads.
        split = batch_read_requests(_reqs([(0, 50), (151, 200)]))
        assert sorted(r.byte_range for r in split) == [[0, 50], [151, 200]]


def test_merge_gap_groups_reassemble_out_of_order_input():
    """Unsorted, interleaved ranged reads across two files regroup by path
    and merge within the gap, preserving every member."""
    from torchsnapshot_tpu_torch.batcher import batch_read_requests

    with _override_merge_gap(10):
        reqs = _reqs([(200, 300), (0, 100)], path="a") + _reqs(
            [(105, 150), (100, 104)], path="b"
        )
        out = batch_read_requests(reqs)
        by_path = {(r.path, tuple(r.byte_range)) for r in out}
        # a: gap of 100 > 10 → stays split; b: gap of 1 ≤ 10 → merges.
        assert ("a", (0, 100)) in by_path
        assert ("a", (200, 300)) in by_path
        assert ("b", (100, 150)) in by_path
        assert len(out) == 3


def test_no_merge_and_into_reads_pass_through():
    from torchsnapshot_tpu_torch.batcher import batch_read_requests
    from torchsnapshot_tpu_torch.io_types import ReadReq

    tiled = ReadReq(
        path="t",
        byte_range=[0, 10],
        buffer_consumer=_StubConsumer(10),
        no_merge=True,
    )
    buf = bytearray(10)
    into = ReadReq(
        path="t",
        byte_range=[10, 20],
        buffer_consumer=_StubConsumer(10),
        into=memoryview(buf),
    )
    out = batch_read_requests([tiled, into])
    assert {id(r) for r in out} == {id(tiled), id(into)}
