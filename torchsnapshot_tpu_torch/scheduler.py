"""Memory-budgeted execution pipelines for write/read requests.

Counterpart of ``torchsnapshot_tpu/scheduler.py``: ``sync_execute_write_reqs``
(with :class:`PendingIOWork` and :class:`DeferredIOWork`) and
``sync_execute_read_reqs``.

Write path: each request moves ready_for_staging → staging → io.  Staging
(the D2H copy into a pinned host buffer, or a zero-copy view of a CPU
value) is admitted while its declared cost fits the remaining memory
budget, with an always-admit-one starvation guard when nothing is in
flight.  The budget is debited by staging cost, re-credited down to the
staged buffer size, and fully re-credited once the write lands.  Storage
I/O concurrency is capped (``TPUSNAP_MAX_PER_RANK_IO_CONCURRENCY``, widened
in place by the preemption deadline mode).  ``sync_execute_write_reqs``
returns once staging has drained, with the writes still running in a
:class:`PendingIOWork`: the synchronous take completes it at once, an async
take on its background thread.

Read path mirrors it: io → consuming, with budget-gated read admission.
A CUDA target's pinned read buffer is allocated at admission
(``ReadReq.into_factory``), so pinned memory counts against the budget on
both paths.

Compression: a framed payload's staging cost counts the staged bytes and
the frame, which coexist while the codec runs; once staged the budget is
re-credited down to the frame's size, which is where a good ratio hands
budget back to waiting stagers.  The codecs release the GIL, so a
pipeline that frames or decodes widens its executor from 4 threads to
min(16, cores) (``TPUSNAP_STAGING_THREADS`` pins it).

The budget is min(60% of available host memory / local ranks, 32 GB),
or ``TPUSNAP_PER_RANK_MEMORY_BUDGET_BYTES``.  Available memory comes from
``/proc/meminfo`` (no psutil).

Progress: each pipeline's :class:`_ProgressReporter` attaches to the
innermost operation the health monitor (telemetry/monitor.py) watches,
refreshes the ``tpusnap_progress_*`` and scheduler gauges every loop turn,
and logs a per-rank progress table every ``TPUSNAP_PROGRESS_INTERVAL_S``
(the loops wake on that interval even when no task completes, so a rank
parked behind hung storage still reports).
"""

from __future__ import annotations

import asyncio
import logging
import os
import socket
import time
from collections import Counter, deque
from concurrent.futures import Executor, ThreadPoolExecutor
from typing import List, Optional

from . import knobs, phase_stats, preemption, retry as retry_policy, rss_profiler
from .event import Event
from .event_handlers import log_event
from .io_types import ReadIO, ReadReq, ScatterBuffer, StoragePlugin, WriteIO, WriteReq
from .pg_wrapper import PGWrapper
from .telemetry import metrics as tmetrics
from .telemetry import monitor as tmonitor
from .telemetry import trace as ttrace
from .utils.loops import call_outside_loop

logger = logging.getLogger(__name__)

_MAX_PER_RANK_MEMORY_BUDGET_BYTES = 32 * 1024 * 1024 * 1024
_AVAILABLE_MEMORY_MULTIPLIER = 0.6
_NUM_EXECUTOR_THREADS = 4
_MAX_EXECUTOR_THREADS = 16


def _wide_executor_workers() -> int:
    return max(_NUM_EXECUTOR_THREADS, min(_MAX_EXECUTOR_THREADS, os.cpu_count() or 1))


def _write_executor_workers() -> int:
    """4 threads for a raw save (storage-bound: more threads only contend),
    min(16, cores) when the configured codec resolves to a real one (the
    save is then bound by the encode)."""
    override = knobs.get_staging_threads()
    if override > 0:
        return override
    codec, _ = knobs.get_compression()
    if codec != "raw":
        from . import compression

        if compression.resolve(codec) != "raw":
            return _wide_executor_workers()
    return _NUM_EXECUTOR_THREADS


def _read_executor_workers(read_reqs: List[ReadReq]) -> int:
    """Keyed off the snapshot being read, not the save-side knob: any
    framed payload makes the restore decode-bound."""
    override = knobs.get_staging_threads()
    if override > 0:
        return override
    if any(getattr(rr.buffer_consumer, "framed", False) for rr in read_reqs):
        return _wide_executor_workers()
    return _NUM_EXECUTOR_THREADS


def available_memory_bytes() -> int:
    """``MemAvailable`` of ``/proc/meminfo``, in bytes."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("/proc/meminfo has no MemAvailable line")


def get_local_world_size(pg: PGWrapper) -> int:
    """Number of ranks on this host."""
    hostname = socket.gethostname()
    return pg.all_reduce_object(hostname, Counter)[hostname]


def get_process_memory_budget_bytes(pg: PGWrapper) -> int:
    """min(60% of available RAM / local ranks, 32 GB), env-overridable."""
    override = knobs.get_per_rank_memory_budget_bytes_override()
    if override is not None:
        return override
    budget = int(available_memory_bytes() * _AVAILABLE_MEMORY_MULTIPLIER)
    budget //= get_local_world_size(pg)
    return min(budget, _MAX_PER_RANK_MEMORY_BUDGET_BYTES)


class _BudgetTracker:
    def __init__(self, budget_bytes: int) -> None:
        self.total = budget_bytes
        self.remaining = budget_bytes
        self.inflight = 0

    @property
    def in_use(self) -> int:
        return self.total - self.remaining


class _ProgressReporter:
    """One pipeline's progress, as the health monitor and the operator see
    it: request and byte counters, the pipeline-state counts of the last
    loop turn, the budget, and ``debug_refs`` closures naming the paths in
    each state for a stall bundle.  ``maybe_report`` refreshes the gauges
    every loop turn and logs the progress table every
    ``TPUSNAP_PROGRESS_INTERVAL_S`` (0 turns the table off)."""

    def __init__(self, rank: int, total: int, verb: str, budget: Optional[_BudgetTracker] = None) -> None:
        self.rank = rank
        self.total = total
        self.verb = verb
        self.staged = 0
        self.io_done = 0
        self.bytes_staged = 0
        self.bytes_done = 0
        self.pending = 0
        self.staging = 0
        self.inflight_io = 0
        self.budget = budget
        self.debug_refs: Optional[dict] = None
        try:
            self.loop: Optional[asyncio.AbstractEventLoop] = asyncio.get_running_loop()
        except RuntimeError:
            self.loop = None
        self._interval_s = knobs.get_progress_interval_s()
        self._last = time.monotonic()
        self._begin = self._last
        try:
            self._rss_base: Optional[int] = rss_profiler.rss_bytes()
        except (OSError, RuntimeError, ValueError):
            self._rss_base = None
        tmonitor.attach_reporter(self)

    def maybe_report(self, budget: _BudgetTracker, pending: int = 0, staging: int = 0, inflight_io: int = 0) -> None:
        self.pending = pending
        self.staging = staging
        self.inflight_io = inflight_io
        # Every loop turn, not only on the log interval: a short operation
        # would otherwise never show in the gauges.
        tmetrics.record_scheduler_state(
            verb=self.verb,
            pending=pending,
            staging=staging,
            inflight_io=inflight_io,
            budget_in_use=budget.in_use,
        )
        tmetrics.record_progress(
            verb=self.verb,
            requests_total=self.total,
            requests_staged=self.staged,
            requests_done=self.io_done,
            bytes_staged=self.bytes_staged,
            bytes_done=self.bytes_done,
        )
        if not self._interval_s:
            return
        now = time.monotonic()
        if now - self._last < self._interval_s:
            return
        self._last = now
        rss_str = "?"
        if self._rss_base is not None:
            try:
                rss_str = f"{(rss_profiler.rss_bytes() - self._rss_base) / 1e6:+.0f}MB"
            except (OSError, RuntimeError, ValueError):
                pass
        stage_verb, io_verb = ("stageable/staging", "writing") if self.verb == "write" else ("unread/reading", "consuming")
        logger.info(
            "[rank %d] %s pipeline: %s=%d/%d %s=%d done=%d/%d "
            "staged=%.1fMB completed=%.1fMB rss%s budget=%.1fMB "
            "elapsed=%.0fs",
            self.rank,
            self.verb,
            stage_verb,
            pending,
            staging,
            io_verb,
            inflight_io,
            self.io_done,
            self.total,
            self.bytes_staged / 1e6,
            self.bytes_done / 1e6,
            rss_str,
            budget.remaining / 1e6,
            now - self._begin,
        )


def _buf_nbytes(buf: object) -> int:
    if isinstance(buf, ScatterBuffer):
        return buf.nbytes
    return memoryview(buf).nbytes  # type: ignore[arg-type]


class _WritePipeline:
    """One write request's state through the pipeline."""

    def __init__(self, write_req: WriteReq, storage: StoragePlugin) -> None:
        self.write_req = write_req
        self.storage = storage
        self.staging_cost = write_req.buffer_stager.get_staging_cost_bytes()
        self.buf: Optional[object] = None
        self.buf_sz_bytes = 0
        self._io_credited = False
        self._digests_done = False
        # Set when the write is dispatched: whether other writes are in
        # flight or queued (WriteIO.batch_hint).
        self.batch_hint = False

    def release_after_io(self, budget: _BudgetTracker) -> None:
        """Release the staged buffer and credit its bytes, exactly once
        (from the io coroutine's finally, or from pipeline teardown when the
        io task was cancelled before it started)."""
        if not self._io_credited:
            self._io_credited = True
            self.buf = None
            budget.remaining += self.buf_sz_bytes

    async def stage_buffer(self, executor: Optional[Executor]) -> "_WritePipeline":
        self.buf = await self.write_req.buffer_stager.stage_buffer(executor)
        self.buf_sz_bytes = _buf_nbytes(self.buf)
        return self

    def _hash_sinks(self) -> Optional[list]:
        return getattr(self.write_req.buffer_stager, "hash_sinks", None)

    def _aligned_parts(self, sinks: list) -> list:
        buf = self.buf
        parts = buf.parts if isinstance(buf, ScatterBuffer) else [buf]
        if len(parts) != len(sinks):
            raise RuntimeError(
                f"{self.write_req.path}: {len(sinks)} digest sinks for "
                f"{len(parts)} buffer parts — stager/batcher mismatch"
            )
        return parts

    async def ensure_digests(self, executor: Optional[Executor]) -> None:
        """Resolve deferred digests for storage WITHOUT fused write+hash:
        one hash pass over the staged parts, on the executor."""
        sinks = self._hash_sinks()
        if not sinks or self._digests_done or self.storage.supports_write_hash:
            return
        from . import integrity

        parts = self._aligned_parts(sinks)
        if executor is not None and self.buf_sz_bytes >= 1 << 20:
            loop = asyncio.get_running_loop()
            digests = await asyncio.gather(
                *(loop.run_in_executor(executor, integrity.digest, p) for p in parts)
            )
        else:
            digests = [integrity.digest(p) for p in parts]
        for sink, d in zip(sinks, digests):
            sink(d)
        self._digests_done = True

    async def write_buffer(self) -> None:
        assert self.buf is not None
        sinks = self._hash_sinks()
        write_io = WriteIO(
            path=self.write_req.path, buf=self.buf, batch_hint=self.batch_hint
        )
        fused = bool(sinks) and not self._digests_done and self.storage.supports_write_hash
        if fused:
            parts = self._aligned_parts(sinks)
            write_io.want_part_hashes = True
        await self.storage.write(write_io)
        if fused:
            from . import integrity

            hashes = write_io.part_hash64
            if hashes is None or len(hashes) != len(sinks):
                raise RuntimeError(
                    f"{self.write_req.path}: storage returned "
                    f"{None if hashes is None else len(hashes)} part digests "
                    f"for {len(sinks)} parts"
                )
            for sink, h, part in zip(sinks, hashes, parts):
                sink(integrity.format_digest(h, memoryview(part).nbytes))
            self._digests_done = True
        self.buf = None  # release host memory promptly


async def _with_retries(fn, what: str, path: str, rank: int, semaphore) -> None:
    """Await ``fn()`` under an I/O slot, retrying transient failures up to
    ``TPUSNAP_IO_RETRIES`` times; the backoff sleeps outside the slot.  A
    retry re-sends the same staged buffer / re-issues the same read."""
    max_retries = knobs.get_io_retries()
    attempt = 0
    while True:
        try:
            async with semaphore:
                await fn()
                return
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001 — classified below
            if attempt >= max_retries or not retry_policy.is_transient(e):
                raise
            attempt += 1
            tmetrics.record_pipeline_retry(what)
            log_event(
                Event(
                    name=f"scheduler.{what}_retry",
                    metadata={"path": path, "attempt": attempt, "error": repr(e)},
                )
            )
            logger.warning(
                "[rank %d] transient %s failure for %s (attempt %d/%d): %r; "
                "retrying",
                rank,
                what,
                path,
                attempt,
                max_retries,
                e,
            )
            await asyncio.sleep(retry_policy.backoff_s(attempt))


class PendingIOWork:
    """The storage I/O of a write pipeline whose staging has drained: owns
    the pipeline's event loop, its executor and the write tasks (each
    already started).  :meth:`sync_complete` drives them to the end, from
    any thread; the first failure cancels the rest."""

    def __init__(
        self,
        loop: asyncio.AbstractEventLoop,
        executor: Executor,
        io_tasks: List["asyncio.Task"],
        bytes_total: int,
        budget: Optional[_BudgetTracker] = None,
        reporter: Optional[_ProgressReporter] = None,
    ) -> None:
        self._loop = loop
        self._executor = executor
        self._io_tasks = io_tasks
        self.bytes_total = bytes_total
        self._budget = budget
        self._reporter = reporter

    def sync_complete(self) -> None:
        call_outside_loop(self._sync_complete_impl)

    async def _drain(self) -> None:
        reporter = self._reporter
        interval = reporter._interval_s if reporter is not None else 0
        pending = set(self._io_tasks)
        while pending:
            # FIRST_COMPLETED: the first failure surfaces at once, never
            # after every other write finished.  The timeout lets the
            # progress table fire while the writes crawl.
            done, pending = await asyncio.wait(
                pending, timeout=interval or None, return_when=asyncio.FIRST_COMPLETED
            )
            for task in done:
                if task.exception() is not None:
                    raise task.exception()
            if reporter is not None and self._budget is not None:
                reporter.maybe_report(self._budget, inflight_io=len(pending))

    def _sync_complete_impl(self) -> None:
        begin = time.monotonic()
        try:
            if self._io_tasks:
                with ttrace.span("io_drain", cat="scheduler", n_tasks=len(self._io_tasks)):
                    self._loop.run_until_complete(self._drain())
        except BaseException:
            # Cancel and drain the rest, so the loop closes clean and the
            # staged host buffers are released.
            pending = [t for t in self._io_tasks if not t.done()]
            for t in pending:
                t.cancel()
            if pending:
                self._loop.run_until_complete(
                    asyncio.gather(*pending, return_exceptions=True)
                )
            raise
        finally:
            self._executor.shutdown()
            self._loop.close()
            # Drained or torn down: a scrape after the take sees an idle
            # pipeline, not its last in-flight gauges.
            tmetrics.record_scheduler_idle("write")
        elapsed = time.monotonic() - begin
        if elapsed > 0 and self.bytes_total:
            logger.debug(
                "Completed pending I/O: %.1f MB in %.2fs (%.1f MB/s)",
                self.bytes_total / 1e6,
                elapsed,
                self.bytes_total / 1e6 / elapsed,
            )


class DeferredIOWork:
    """:class:`PendingIOWork` for device-staged async takes: the whole write
    pipeline, D2H staging included, runs at ``sync_complete`` time on the
    background thread.  Safe because the app state was already copied
    (device_staging.py): the copies, not host staging, make the take safe
    against the caller's mutations."""

    def __init__(
        self,
        write_reqs: List[WriteReq],
        storage: StoragePlugin,
        memory_budget_bytes: int,
        rank: int,
    ) -> None:
        self._write_reqs = write_reqs
        self._storage = storage
        self._memory_budget_bytes = memory_budget_bytes
        self._rank = rank
        self.bytes_total = 0

    def sync_complete(self) -> None:
        pending = sync_execute_write_reqs(
            write_reqs=self._write_reqs,
            storage=self._storage,
            memory_budget_bytes=self._memory_budget_bytes,
            rank=self._rank,
        )
        self._write_reqs = []
        self.bytes_total = pending.bytes_total
        pending.sync_complete()


async def execute_write_reqs(
    write_reqs: List[WriteReq],
    storage: StoragePlugin,
    memory_budget_bytes: int,
    rank: int,
) -> PendingIOWork:
    """Stage every buffer under the memory budget, overlapping staging with
    storage I/O; return once staging has drained.  The returned
    :class:`PendingIOWork` owns this loop and the writes still running."""
    loop = asyncio.get_running_loop()
    executor = ThreadPoolExecutor(max_workers=_write_executor_workers())
    budget = _BudgetTracker(memory_budget_bytes)
    phases_before = phase_stats.snapshot()
    begin = time.monotonic()
    ready_for_staging = deque(
        sorted(
            (_WritePipeline(wr, storage) for wr in write_reqs),
            key=lambda p: p.staging_cost,
        )
    )
    staging_tasks: dict = {}  # task -> pipeline
    io_tasks: dict = {}  # task -> pipeline, every write ever started
    io_live: set = set()  # the writes still running
    # Deadline mode (preemption.py) starts new pipelines at the boosted io
    # width; otherwise the semaphore is registered, so an activation landing
    # mid-drain widens it in place.
    base_io_cap = knobs.get_max_per_rank_io_concurrency()
    io_cap = preemption.effective_io_cap(base_io_cap)
    io_semaphore = asyncio.Semaphore(io_cap)
    if io_cap == base_io_cap:
        preemption.register_write_semaphore(loop, io_semaphore, base_io_cap)
    staged_bytes = 0
    reporter = _ProgressReporter(rank=rank, total=len(write_reqs), verb="write", budget=budget)
    reporter.debug_refs = {
        # Best-effort snapshots for stall bundles (the monitor catches a
        # racing mutation from this loop).
        "ready_for_staging": lambda: [p.write_req.path for p in list(ready_for_staging)],
        "staging": lambda: [p.write_req.path for p in list(staging_tasks.values())],
        "inflight_io": lambda: [p.write_req.path for t, p in list(io_tasks.items()) if not t.done()],
    }

    async def _io(pipeline: _WritePipeline) -> None:
        try:
            # Digests for non-fusing storage resolve outside the io slot.
            await pipeline.ensure_digests(executor)
            await _with_retries(
                pipeline.write_buffer, "write", pipeline.write_req.path, rank, io_semaphore
            )
            reporter.io_done += 1
            reporter.bytes_done += pipeline.buf_sz_bytes
            tmetrics.record_io_bytes("written", pipeline.buf_sz_bytes)
        finally:
            pipeline.release_after_io(budget)

    def dispatch_staging() -> None:
        # Admit while cost fits; always admit one when nothing is in flight
        # at any stage (requests larger than the whole budget).
        while ready_for_staging:
            pipeline = ready_for_staging[0]
            if pipeline.staging_cost <= budget.remaining or (
                budget.inflight == 0 and not staging_tasks and not io_live
            ):
                ready_for_staging.popleft()
                budget.remaining -= pipeline.staging_cost
                budget.inflight += 1
                task = asyncio.ensure_future(pipeline.stage_buffer(executor))
                staging_tasks[task] = pipeline
            else:
                break

    staging_span = ttrace.span("write_staging", cat="scheduler", n_reqs=len(write_reqs))
    staging_span.__enter__()
    try:
        dispatch_staging()
        while staging_tasks or ready_for_staging:
            # With the starvation guard, nothing may be staging while an
            # over-budget request waits for in-flight writes to free budget.
            # The timeout lets the progress table fire while a rank is
            # blocked on hung storage, when no task completes.
            done, _ = await asyncio.wait(
                set(staging_tasks) | io_live,
                timeout=reporter._interval_s or None,
                return_when=asyncio.FIRST_COMPLETED,
            )
            for task in done:
                if task in staging_tasks:
                    pipeline = staging_tasks.pop(task)
                    task.result()  # raises on staging failure
                    # Re-credit declared cost minus the staged buffer, which
                    # stays debited until its write lands.
                    budget.remaining += pipeline.staging_cost - pipeline.buf_sz_bytes
                    budget.inflight -= 1
                    staged_bytes += pipeline.buf_sz_bytes
                    reporter.staged += 1
                    reporter.bytes_staged += pipeline.buf_sz_bytes
                    # Other writes in flight or queued: the storage may
                    # micro-batch this one with them.
                    pipeline.batch_hint = bool(io_live or staging_tasks or ready_for_staging)
                    io_task = asyncio.ensure_future(_io(pipeline))
                    io_tasks[io_task] = pipeline
                    io_live.add(io_task)
                    io_task.add_done_callback(io_live.discard)
                else:
                    task.result()  # a write failure surfaces immediately
            dispatch_staging()
            reporter.maybe_report(
                budget, pending=len(ready_for_staging), staging=len(staging_tasks), inflight_io=len(io_live)
            )
    except BaseException:
        # Cancel and drain everything outstanding before re-raising, so no
        # task is left pending and every buffer is released.
        for t in list(staging_tasks) + list(io_tasks):
            if not t.done():
                t.cancel()
        await asyncio.gather(*staging_tasks, *io_tasks, return_exceptions=True)
        for pipeline in io_tasks.values():
            pipeline.release_after_io(budget)
        executor.shutdown(wait=False)
        tmetrics.record_scheduler_idle("write")
        raise
    staging_span.__exit__(None, None, None)
    elapsed = time.monotonic() - begin
    if staged_bytes and elapsed > 0:
        logger.info(
            "[rank %d] staged %.1f MB in %.2fs (%.1f MB/s), %d requests; phases: %s",
            rank,
            staged_bytes / 1e6,
            elapsed,
            staged_bytes / 1e6 / elapsed,
            len(write_reqs),
            phase_stats.format_line(phase_stats.delta(phases_before)),
        )
    return PendingIOWork(
        loop=loop,
        executor=executor,
        io_tasks=list(io_tasks),
        bytes_total=staged_bytes,
        budget=budget,
        reporter=reporter,
    )


def _run_on_new_loop(coro_fn, *args):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro_fn(*args))
    finally:
        loop.close()


def _stage_on_new_loop(*args) -> PendingIOWork:
    # The returned PendingIOWork owns the loop; it is closed here only when
    # staging failed.
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(execute_write_reqs(*args))
    except BaseException:
        loop.close()
        raise


def sync_execute_write_reqs(
    write_reqs: List[WriteReq],
    storage: StoragePlugin,
    memory_budget_bytes: int,
    rank: int,
) -> PendingIOWork:
    """Run the write pipeline's staging on a private event loop (a helper
    thread when the caller is inside a running loop); the returned
    :class:`PendingIOWork` completes the writes, from any thread."""
    return call_outside_loop(
        _stage_on_new_loop, write_reqs, storage, memory_budget_bytes, rank
    )


class _ReadPipeline:
    def __init__(self, read_req: ReadReq, storage: StoragePlugin) -> None:
        self.read_req = read_req
        self.storage = storage
        self.consuming_cost = read_req.buffer_consumer.get_consuming_cost_bytes()
        self.buf: Optional[object] = None
        self.hash64: Optional[int] = None

    async def read_buffer(self) -> None:
        req = self.read_req
        consumer = req.buffer_consumer
        into = req.into
        if into is None and req.into_factory is not None:
            into = req.into_factory()
        read_io = ReadIO(
            path=req.path,
            byte_range=list(req.byte_range) if req.byte_range is not None else None,
            into=into,
            # A read-fused digest only when this consumer verifies the whole
            # payload against one.
            want_hash=getattr(consumer, "accepts_hash64", False)
            and getattr(consumer, "wants_read_hash", True),
            hash_algo=getattr(consumer, "hash_algo", None),
        )
        await self.storage.read(read_io)
        self.buf = read_io.buf
        self.hash64 = read_io.hash64

    async def consume_buffer(self, executor: Optional[Executor]) -> "_ReadPipeline":
        assert self.buf is not None
        consumer = self.read_req.buffer_consumer
        if self.hash64 is not None and getattr(consumer, "accepts_hash64", False):
            consumer.precomputed_hash64 = self.hash64
        await consumer.consume_buffer(self.buf, executor)
        self.buf = None
        return self


async def execute_read_reqs(
    read_reqs: List[ReadReq],
    storage: StoragePlugin,
    memory_budget_bytes: int,
    rank: int,
) -> None:
    """Budget-gated read → consume pipeline."""
    executor = ThreadPoolExecutor(max_workers=_read_executor_workers(read_reqs))
    budget = _BudgetTracker(memory_budget_bytes)
    ready_for_io = deque(
        sorted(
            (_ReadPipeline(rr, storage) for rr in read_reqs),
            key=lambda p: p.consuming_cost,
        )
    )
    io_semaphore = asyncio.Semaphore(knobs.get_max_per_rank_io_concurrency())
    io_tasks: set = set()
    consume_tasks: set = set()
    pipelines: dict = {}  # task -> pipeline, to re-credit on failure
    reporter = _ProgressReporter(rank=rank, total=len(read_reqs), verb="read", budget=budget)
    reporter.debug_refs = {
        "ready_for_io": lambda: [p.read_req.path for p in list(ready_for_io)],
        "inflight": lambda: [p.read_req.path for t, p in list(pipelines.items()) if not t.done()],
    }

    async def _read(pipeline: _ReadPipeline) -> _ReadPipeline:
        await _with_retries(
            pipeline.read_buffer, "read", pipeline.read_req.path, rank, io_semaphore
        )
        return pipeline

    def dispatch_io() -> None:
        while ready_for_io:
            pipeline = ready_for_io[0]
            if pipeline.consuming_cost <= budget.remaining or (
                budget.inflight == 0 and not io_tasks and not consume_tasks
            ):
                ready_for_io.popleft()
                budget.remaining -= pipeline.consuming_cost
                budget.inflight += 1
                task = asyncio.ensure_future(_read(pipeline))
                io_tasks.add(task)
                pipelines[task] = pipeline
            else:
                break

    read_span = ttrace.span("read_pipeline", cat="scheduler", n_reqs=len(read_reqs))
    read_span.__enter__()
    try:
        dispatch_io()
        while io_tasks or consume_tasks:
            done, _ = await asyncio.wait(
                io_tasks | consume_tasks,
                timeout=reporter._interval_s or None,
                return_when=asyncio.FIRST_COMPLETED,
            )
            for task in done:
                pipeline = pipelines.pop(task)
                if task in io_tasks:
                    io_tasks.discard(task)
                    task.result()  # raises on storage failure
                    consume_task = asyncio.ensure_future(
                        pipeline.consume_buffer(executor)
                    )
                    consume_tasks.add(consume_task)
                    pipelines[consume_task] = pipeline
                else:
                    consume_tasks.discard(task)
                    task.result()  # raises on consume failure
                    budget.remaining += pipeline.consuming_cost
                    budget.inflight -= 1
                    reporter.io_done += 1
                    reporter.bytes_done += pipeline.consuming_cost
                    tmetrics.record_io_bytes("read", pipeline.consuming_cost)
            dispatch_io()
            reporter.maybe_report(
                budget, pending=len(ready_for_io), staging=len(io_tasks), inflight_io=len(consume_tasks)
            )
        read_span.__exit__(None, None, None)
    except BaseException as e:
        read_span.__exit__(type(e), e, e.__traceback__)
        for t in io_tasks | consume_tasks:
            if not t.done():
                t.cancel()
        await asyncio.gather(*io_tasks, *consume_tasks, return_exceptions=True)
        for pipeline in pipelines.values():
            pipeline.buf = None
        raise
    finally:
        executor.shutdown(wait=False)
        tmetrics.record_scheduler_idle("read")


def sync_execute_read_reqs(
    read_reqs: List[ReadReq],
    storage: StoragePlugin,
    memory_budget_bytes: int,
    rank: int,
) -> None:
    call_outside_loop(
        _run_on_new_loop,
        execute_read_reqs,
        read_reqs,
        storage,
        memory_budget_bytes,
        rank,
    )
