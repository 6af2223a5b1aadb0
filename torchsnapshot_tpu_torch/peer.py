"""Peer-to-peer chunk distribution: the fleet half of the serving tier.

Counterpart of ``torchsnapshot_tpu/peer.py``, on the same registry and
wire format, so a client of either package fetches from a daemon
(peerd.py) of either.  The host cache gets co-located workers down to one
origin read per chunk per host; with this tier, hosts that hold a chunk
serve it to hosts that do not, and each chunk leaves origin once per fleet:

- **Identity.**  Only digest-addressed chunks cross hosts (``cas://`` and
  the parts of ``casx://`` locations, cache keys ``cas/<algo>/<hex>``).  A
  peer's body must hash to the name that asked for it before anything
  trusts it, so a corrupt or rogue peer costs a round trip, never a byte
  of a restore.
- **Discovery.**  Daemons register on the coordination store (the
  ``dist_store`` the multi-rank saves use) under ``peerd/slots`` and
  ``peerd/<slot>``, with a stamp refreshed every lease interval and a
  tombstone on a clean stop; a row whose stamp is older than the grace is
  presumed dead.
- **Placement.**  Candidates are ranked by rendezvous hash
  (``sha1(f"{chunk_key}|{addr}")``, highest first): a fleet's requests for
  one chunk meet at the same holder, distinct chunks spread over all peers.
- **Transport.**  ``GET /chunk/<algo>/<hex>`` over HTTP/1.1 on the standard
  library's ``http.client``.

:class:`PeerReaderPlugin` sits outside :class:`cache.CacheReaderPlugin`: a
read the local cache serves never touches the network; a miss is fetched
from a peer, verified, put into the cache, and then read through it (a
hit), so the cache's ``miss_bytes`` stays an exact meter of origin bytes
and this host can serve the chunk onward.  A ``casx://`` location fetches
each part from its own peer.  The tier is never load-bearing: no store, no
live peer, a peer dying mid-transfer, a full disk, each falls back to the
cache-then-origin read.

Not here yet: the ``peer_fetch`` span, the ``traceparent`` header and the
peer metrics of the JAX package's telemetry (step 7a).
"""

from __future__ import annotations

import asyncio
import hashlib
import http.client
import json
import logging
import os
import socket
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

from . import cas, faults, integrity, knobs, phase_stats, retry
from .event import Event
from .event_handlers import log_event
from .io_types import ReadIO, StoragePlugin, WriteIO
from .telemetry import metrics as tmetrics
from .telemetry import trace as ttrace

logger = logging.getLogger(__name__)

__all__ = [
    "PEERD_PREFIX",
    "PeerInfo",
    "PeerRegistration",
    "live_peers",
    "rendezvous_order",
    "PeerClient",
    "PeerReaderPlugin",
    "maybe_wrap_peer_reads",
    "find_peer_reader",
    "reader_stats",
    "process_stats",
    "reset_process_stats",
    "peer_scoreboard",
    "reset_peer_scoreboard",
    "record_fetch_outcome",
    "calibrated_scoreboard_cost_s",
]

# Threads of a reader plugin's fetch pool: each holds at most one chunk
# body (up to the 512 MiB chunk size) in memory.
_FETCH_THREADS = 16

# ------------------------------------------------------------ process stats

_TOTALS_LOCK = threading.Lock()
_TOTALS: Dict[str, int] = {
    "hits": 0,
    "misses": 0,
    "hit_bytes": 0,
    "miss_bytes": 0,
    "rejects": 0,
}


def process_stats() -> Dict[str, int]:
    """This process's peer-tier outcomes, folded in by each reader plugin
    when it closes: chunks and bytes from peers, from origin, and digest
    rejects."""
    with _TOTALS_LOCK:
        return dict(_TOTALS)


def reset_process_stats() -> None:
    with _TOTALS_LOCK:
        for k in _TOTALS:
            _TOTALS[k] = 0
    reset_peer_scoreboard()


def _add_totals(**deltas: int) -> None:
    with _TOTALS_LOCK:
        for k, v in deltas.items():
            _TOTALS[k] += v


# --------------------------------------------------------------- scoreboard
#
# Per-peer serving health: latency and error EWMAs, a bounded latency ring
# for percentiles, outcome and byte counters, the quarantine stamp.  It
# feeds fetch policy: a peer whose latency EWMA exceeds
# TPUSNAP_PEER_DEMOTE_FACTOR times the fleet median (or whose error EWMA
# passes 0.5) is demoted, tried after every healthy peer.

_SCORE_LOCK = threading.Lock()
_SCORE_ALPHA = 0.2
_SCORE_RING = 128
_SCOREBOARD: Dict[str, Dict[str, Any]] = {}
_SCORE_UPDATES = 0

_OUTCOME_COUNTER = {"hit": "hits", "miss": "misses", "error": "errors", "reject": "rejects"}


def _score_entry_locked(addr: str) -> Dict[str, Any]:
    entry = _SCOREBOARD.get(addr)
    if entry is None:
        entry = {
            "ewma_latency_s": 0.0,
            "ewma_error": 0.0,
            "latencies": [],
            "hits": 0,
            "misses": 0,
            "errors": 0,
            "rejects": 0,
            "bytes": 0,
            "quarantined_until": 0.0,
            "demoted": False,
        }
        _SCOREBOARD[addr] = entry
    return entry


def _outcomes(entry: Dict[str, Any]) -> int:
    return entry["hits"] + entry["misses"] + entry["errors"] + entry["rejects"]


def record_fetch_outcome(addr: str, wall_s: float, status: str, nbytes: int = 0) -> bool:
    """Fold one fetch's outcome (``hit``, ``miss``, ``error``, ``reject``)
    into the peer's row.  True when this update newly demoted the peer (the
    caller emits the event, outside the lock)."""
    global _SCORE_UPDATES
    factor = knobs.get_peer_demote_factor()
    with _SCORE_LOCK:
        _SCORE_UPDATES += 1
        entry = _score_entry_locked(addr)
        if _outcomes(entry) == 0:
            entry["ewma_latency_s"] = wall_s
        else:
            entry["ewma_latency_s"] = (1.0 - _SCORE_ALPHA) * entry["ewma_latency_s"] + _SCORE_ALPHA * wall_s
        err = 0.0 if status in ("hit", "miss") else 1.0
        entry["ewma_error"] = (1.0 - _SCORE_ALPHA) * entry["ewma_error"] + _SCORE_ALPHA * err
        entry["latencies"].append(wall_s)
        if len(entry["latencies"]) > _SCORE_RING:
            del entry["latencies"][: len(entry["latencies"]) - _SCORE_RING]
        entry[_OUTCOME_COUNTER.get(status, "errors")] += 1
        entry["bytes"] += nbytes
        was_demoted = entry["demoted"]
        # Relative health: against the fleet median of latency EWMAs, so a
        # uniformly slow network demotes no one.
        ewmas = sorted(e["ewma_latency_s"] for e in _SCOREBOARD.values() if _outcomes(e) > 0)
        median = ewmas[len(ewmas) // 2] if ewmas else 0.0
        slow = factor > 0.0 and len(ewmas) >= 2 and median > 0.0 and entry["ewma_latency_s"] > factor * median
        entry["demoted"] = slow or entry["ewma_error"] > 0.5
        return entry["demoted"] and not was_demoted


def record_quarantine(addr: str, ttl_s: float) -> None:
    with _SCORE_LOCK:
        entry = _score_entry_locked(addr)
        entry["quarantined_until"] = max(entry["quarantined_until"], time.time() + ttl_s)


def _demoted_addrs() -> set:
    with _SCORE_LOCK:
        return {a for a, e in _SCOREBOARD.items() if e["demoted"]}


def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    return sorted_vals[min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1)))]


def peer_scoreboard() -> Dict[str, Dict[str, Any]]:
    """Each peer's EWMAs, ring percentiles and counters (the latency ring
    itself stays private)."""
    with _SCORE_LOCK:
        out: Dict[str, Dict[str, Any]] = {}
        for addr, entry in _SCOREBOARD.items():
            lats = sorted(entry["latencies"])
            out[addr] = {
                "ewma_latency_s": entry["ewma_latency_s"],
                "ewma_error": entry["ewma_error"],
                "p50_s": _percentile(lats, 0.50),
                "p99_s": _percentile(lats, 0.99),
                **{k: entry[k] for k in ("hits", "misses", "errors", "rejects", "bytes", "quarantined_until", "demoted")},
            }
        return out


def reset_peer_scoreboard() -> None:
    global _SCORE_UPDATES
    with _SCORE_LOCK:
        _SCOREBOARD.clear()
        _SCORE_UPDATES = 0


def calibrated_scoreboard_cost_s(samples: int = 200) -> Dict[str, Any]:
    """The cost of one scoreboard update, measured on a synthetic peer that
    is removed afterwards, times this process's updates so far."""
    global _SCORE_UPDATES
    updates = _SCORE_UPDATES
    samples = max(1, samples)
    probe_addr = "calibration.invalid:0"
    t0 = time.perf_counter()
    for _ in range(samples):
        record_fetch_outcome(probe_addr, 0.001, "hit", 1)
    per_update = (time.perf_counter() - t0) / samples
    with _SCORE_LOCK:
        _SCOREBOARD.pop(probe_addr, None)
        _SCORE_UPDATES = max(0, _SCORE_UPDATES - samples)
    return {"per_update_s": per_update, "updates": updates, "estimated_s": per_update * updates}


# ------------------------------------------------------------- the registry
#
# The op-lease lifecycle of dist_store: a slot drawn from a counter, a
# wall-clock stamp refreshed every lease interval, a tombstone on a clean
# stop, the grace rule on the read side.  Readers scan the slot range.

PEERD_PREFIX = "peerd"
_SLOTS_KEY = PEERD_PREFIX + "/slots"


class PeerInfo:
    """One live daemon of the registry."""

    __slots__ = ("slot", "addr", "host", "pid", "stamp")

    def __init__(self, slot: int, addr: str, host: str, pid: int, stamp: float) -> None:
        self.slot = slot
        self.addr = addr
        self.host = host
        self.pid = pid
        self.stamp = stamp

    def __repr__(self) -> str:
        return f"PeerInfo(slot={self.slot}, addr={self.addr!r})"


class PeerRegistration:
    """This process's row of the registry: the slot claim, a refresh thread
    and the tombstone on :meth:`close`, which joins the thread.  A kill -9
    stops the stamps, and the grace window retires the row."""

    def __init__(self, store: Any, addr: str, interval_s: Optional[float] = None) -> None:
        self._store = store
        self.addr = addr
        self._interval_s = knobs.get_lease_interval_s() if interval_s is None else interval_s
        self.slot = int(store.add(_SLOTS_KEY, 1)) - 1
        self._key = f"{PEERD_PREFIX}/{self.slot}"
        self._stop = threading.Event()
        self._write(done=False)
        self._thread = threading.Thread(target=self._run, name="tpusnap_peerd_lease", daemon=True)
        self._thread.start()

    def _write(self, done: bool) -> None:
        record = {"addr": self.addr, "host": socket.gethostname(), "pid": os.getpid(), "stamp": time.time(), "done": done}
        self._store.set(self._key, json.dumps(record).encode("utf-8"))

    def _run(self) -> None:
        while not self._stop.wait(self._interval_s):
            try:
                self._write(done=False)
            except Exception:  # noqa: BLE001 — a failed refresh must not end the daemon
                logger.warning("peer registry refresh failed", exc_info=True)

    def close(self) -> None:
        """Stop refreshing and tombstone the row: readers drop it at once
        instead of waiting out the grace."""
        self._stop.set()
        self._thread.join()
        try:
            self._write(done=True)
        except Exception:  # noqa: BLE001 — the grace retires the row anyway
            logger.warning("peer registry tombstone failed", exc_info=True)


def live_peers(store: Any, grace_s: Optional[float] = None, exclude_addr: Optional[str] = None) -> List[PeerInfo]:
    """Every registered daemon whose stamp is within the grace: the
    candidate set.  Tombstoned, stale and malformed rows are skipped (the
    registry is advisory)."""
    if grace_s is None:
        grace_s = knobs.get_peer_grace_s()
    raw = store.try_get(_SLOTS_KEY)
    try:
        count = int(raw) if raw else 0
    except ValueError:
        count = 0
    now = time.time()
    peers: List[PeerInfo] = []
    for slot in range(count):
        blob = store.try_get(f"{PEERD_PREFIX}/{slot}")
        if blob is None:
            continue
        try:
            rec = json.loads(blob)
            addr = str(rec["addr"])
            stamp = float(rec.get("stamp", 0.0))
        except (ValueError, KeyError, TypeError):
            continue
        if rec.get("done") or (grace_s > 0 and now - stamp > grace_s) or addr == exclude_addr:
            continue
        peers.append(PeerInfo(slot=slot, addr=addr, host=str(rec.get("host", "")), pid=int(rec.get("pid", 0)), stamp=stamp))
    return peers


def rendezvous_order(chunk_key: str, peers: List[PeerInfo]) -> List[PeerInfo]:
    """Peers by rendezvous (highest random weight) hash of the chunk and the
    peer: every host ranks one membership the same way, and a change of
    membership moves only the affected share of chunks."""

    def _score(peer: PeerInfo) -> bytes:
        return hashlib.sha1(f"{chunk_key}|{peer.addr}".encode("utf-8")).digest()

    return sorted(peers, key=_score, reverse=True)


# ---------------------------------------------------------------- transport


def http_request(
    addr: str, method: str, path: str, timeout_s: float, headers: Optional[Dict[str, str]] = None
) -> Tuple[int, Dict[str, str], bytes]:
    """One HTTP/1.1 request to ``host:port``: ``(status, headers, body)``.
    A body shorter than its ``Content-Length`` raises ``IncompleteRead``
    (transient)."""
    status, resp_headers, body, _ = _timed_request(addr, method, path, timeout_s, headers)
    return status, resp_headers, body


def _timed_request(
    addr: str, method: str, path: str, timeout_s: float, headers: Optional[Dict[str, str]] = None
) -> Tuple[int, Dict[str, str], bytes, float]:
    """:func:`http_request` and its time to first byte: the connect, the
    request and the response headers, apart from the body's transfer."""
    begin = time.monotonic()
    conn = http.client.HTTPConnection(addr, timeout=timeout_s)
    try:
        conn.request(method, path, headers=headers or {})
        resp = conn.getresponse()
        ttfb_s = time.monotonic() - begin  # headers in hand, body pending
        body = resp.read()
        return resp.status, {k.lower(): v for k, v in resp.getheaders()}, body, ttfb_s
    finally:
        conn.close()


# --------------------------------------------------------------- the client


class PeerClient:
    """Digest-addressed chunk fetches against the live peer set.

    Per chunk: the candidates in rendezvous order (quarantined peers left
    out, demoted ones last); against each, transient failures retry up to
    ``TPUSNAP_PEER_RETRIES`` times, a 404 moves on (not resident there), a
    body that does not hash to its name is rejected and its peer
    quarantined.  None when no peer served it: the caller reads origin.
    """

    def __init__(self, store: Any, self_addr: Optional[str] = None) -> None:
        self._store = store
        self._self_addr = self_addr
        self._timeout_s = knobs.get_peer_timeout_s()
        self._retries = knobs.get_peer_retries()
        self._grace_s = knobs.get_peer_grace_s()
        self._bad_ttl_s = knobs.get_peer_bad_ttl_s()
        self._lock = threading.Lock()
        self._bad: Dict[str, float] = {}
        self.rejects = 0
        self._injector = faults.maybe_peer_injector(knobs.get_faults_spec())

    # ------------------------------------------------------- membership

    def candidates(self, chunk_key: str) -> List[PeerInfo]:
        try:
            peers = live_peers(self._store, grace_s=self._grace_s, exclude_addr=self._self_addr)
        except Exception:  # noqa: BLE001 — a broken store means no peers
            logger.warning("peer registry scan failed", exc_info=True)
            return []
        now = time.monotonic()
        with self._lock:
            healthy = [p for p in peers if self._bad.get(p.addr, 0.0) <= now]
        ranked = rendezvous_order(chunk_key, healthy)
        # Demoted peers stay reachable (one may be the only holder) but go
        # last, so a slow peer stops setting the fleet's tail latency.
        demoted = _demoted_addrs()
        if demoted:
            ranked = [p for p in ranked if p.addr not in demoted] + [p for p in ranked if p.addr in demoted]
        return ranked

    def mark_bad(self, addr: str) -> None:
        with self._lock:
            self._bad[addr] = time.monotonic() + self._bad_ttl_s
        record_quarantine(addr, self._bad_ttl_s)

    def _record_reject(self, addr: str, reason: str) -> None:
        with self._lock:
            self.rejects += 1
        tmetrics.record_peer_reject(reason)
        metadata: Dict[str, Any] = {"peer": addr, "reason": reason}
        trace_id = ttrace.current_trace_id()
        if trace_id is not None:
            metadata["trace"] = trace_id
        log_event(Event(name="peer.reject", metadata=metadata))
        logger.warning("rejecting peer %s: %s", addr, reason)

    # ------------------------------------------------------------ fetch

    def fetch_chunk(self, algo: str, hexdigest: str) -> Optional[bytes]:
        """The chunk's verified bytes from the best live peer, or None."""
        for peer in self.candidates(f"{algo}/{hexdigest}"):
            data = self._fetch_from(peer.addr, algo, hexdigest)
            if data is not None:
                return data
        return None

    def _fetch_from(self, addr: str, algo: str, hexdigest: str) -> Optional[bytes]:
        path = f"/chunk/{algo}/{hexdigest}"
        begin = time.monotonic()
        result: Optional[bytes] = None
        ttfb_s = 0.0
        attempt = 0
        # The span's id rides the GET's traceparent: the daemon's
        # peerd_handle span names it as its parent.
        with ttrace.span("peer_fetch", cat="phase", peer=addr, digest=f"{algo}:{hexdigest}") as sp:
            while True:
                try:
                    data, ttfb_s = self._http_get(addr, path)
                except retry.HTTPStatusError as e:
                    if e.status == 404:
                        status = "miss"  # not resident there, not a fault
                        break
                    if e.status in retry.TRANSIENT_HTTP_STATUS and attempt < self._retries:
                        attempt += 1
                        retry.sleep_backoff(attempt, base_s=0.1)
                        continue
                    self.mark_bad(addr)
                    status = "error"
                    break
                except Exception as e:  # noqa: BLE001 — classified below
                    if self._transportish(e) and attempt < self._retries:
                        attempt += 1
                        retry.sleep_backoff(attempt, base_s=0.1)
                        continue
                    self.mark_bad(addr)
                    status = "error"
                    break
                expect = f"{algo}:{hexdigest}"
                if integrity.digest_as(data, expect) != expect:
                    self._record_reject(addr, "digest_mismatch")
                    self.mark_bad(addr)
                    status = "reject"
                    break
                status = "hit"
                result = data
                break
            wall_s = time.monotonic() - begin
            sp.set(
                status=status,
                attempts=attempt + 1,
                ttfb_s=ttfb_s,
                transfer_s=max(0.0, wall_s - ttfb_s),
                bytes=len(result) if result is not None else 0,
            )
        tmetrics.record_peer_fetch_seconds(wall_s)
        if record_fetch_outcome(addr, wall_s, status, len(result) if result is not None else 0):
            tmetrics.record_peer_demoted()
            metadata: Dict[str, Any] = {"peer": addr, "status": status}
            trace_id = ttrace.current_trace_id()
            if trace_id is not None:
                metadata["trace"] = trace_id
            log_event(Event(name="peer.demoted", metadata=metadata))
            logger.warning("demoting slow or flaky peer %s", addr)
        return result

    @staticmethod
    def _transportish(exc: BaseException) -> bool:
        """Transient for the HTTP client: socket errors of any errno and
        malformed responses retry, as do ``retry.is_transient``'s."""
        return retry.is_transient(exc) or isinstance(exc, (OSError, http.client.HTTPException))

    def _http_get(
        self, addr: str, path: str, byte_range: Optional[Tuple[int, int]] = None
    ) -> Tuple[bytes, float]:
        """One GET against a peer: ``(body, ttfb_s)`` of a 2xx, else
        ``retry.HTTPStatusError``.  The time to first byte (connect, request,
        response headers) is split from the body's transfer, so that the
        peer_fetch span tells a slow network from a slow daemon.  The GET
        carries the active trace's ``traceparent``.  An injected ``peer``
        fault acts here:
        ``peer_unreachable`` raises before the connect, ``peer_slow``
        sleeps, ``peer_truncated`` cuts the body after the framing check,
        so only the digest gate can catch it."""
        rule = self._injector.fire(path) if self._injector is not None else None
        if rule is not None:
            if rule.kind == "peer_unreachable":
                raise ConnectionError(f"injected peer_unreachable for {path}")
            if rule.kind == "peer_slow":
                time.sleep(rule.param if rule.param is not None else 0.25)
        begin = time.monotonic()
        headers = {}
        traceparent = ttrace.current_traceparent()
        if traceparent is not None:
            headers["traceparent"] = traceparent
        if path.startswith("/chunk/"):
            headers["tpusnap-chunk"] = path[len("/chunk/") :].replace("/", ":", 1)
        if byte_range is not None:
            headers["Range"] = f"bytes={byte_range[0]}-{byte_range[1] - 1}"
        status, _, body, ttfb_s = _timed_request(addr, "GET", path, self._timeout_s, headers)
        if not 200 <= status < 300:
            raise retry.HTTPStatusError(f"GET http://{addr}{path}: HTTP {status}", status)
        if rule is not None and rule.kind == "peer_truncated":
            body = body[: len(body) // 2]
        phase_stats.add("peer_read", time.monotonic() - begin, len(body))
        return body, ttfb_s


# --------------------------------------------------------------- the plugin


class PeerReaderPlugin(StoragePlugin):
    """Resolves digest-addressed cache misses peer-first.

    Outside the cache reader: a miss on a ``cas://`` chunk (or a part of a
    ``casx://`` location) is fetched from a peer, verified, put into the
    cache, and the read then goes inward, where the cache serves it as a
    hit.  Other paths (protocol files, fingerprint-keyed objects) pass
    straight through: only content verifiable by its name crosses hosts.
    """

    def __init__(self, inner: StoragePlugin, store: Any, namespace: str, client: PeerClient) -> None:
        self._inner = inner
        self._store = store
        self._ns = namespace
        self._client = client
        self.supports_scatter = getattr(inner, "supports_scatter", False)
        self.supports_write_hash = getattr(inner, "supports_write_hash", False)
        # Own pool: fetches block on the network and must not hold the
        # cache reader's threads, where its populate-lock waiters park.
        self._executor = ThreadPoolExecutor(max_workers=_FETCH_THREADS, thread_name_prefix="tpusnap_peer")
        self._lock = threading.Lock()
        self._inflight: Dict[str, threading.Lock] = {}
        self.hits = 0
        self.misses = 0
        self.hit_bytes = 0
        self.miss_bytes = 0
        self._closed = False

    def _record_hit(self, nbytes: int) -> None:
        with self._lock:
            self.hits += 1
            self.hit_bytes += nbytes

    def _record_miss(self, nbytes: int) -> None:
        with self._lock:
            self.misses += 1
            self.miss_bytes += nbytes

    # ------------------------------------------------------------- reads

    async def read(self, read_io: ReadIO) -> None:
        try:
            if cas.is_cas_location(read_io.path):
                # Whole or ranged: the whole chunk is made resident (a peer
                # body verifies only whole), and the cache slices the range.
                await self._read_cas(read_io)
                return
            if cas.is_casx_location(read_io.path):
                if read_io.byte_range is None:
                    await self._read_casx(read_io)
                else:
                    await self._read_casx_range(read_io)
                return
        except Exception:  # noqa: BLE001 — the peer tier is never load-bearing
            logger.warning("peer-first read failed for %s; origin fallback", read_io.path, exc_info=True)
        await self._inner.read(read_io)

    def _ensure_chunk(self, algo: str, hexdigest: str) -> Optional[int]:
        """Make ``cas/<algo>/<hex>`` resident through a peer unless it is:
        the bytes fetched, 0 when already resident, None when no peer
        served it (origin's turn).  Single-flight per key in this process:
        a restore reads many ranges of one slab chunk at once, and each
        would otherwise pull the whole chunk."""
        key = f"cas/{algo}/{hexdigest}"
        if self._store.resident_nbytes(key) is not None:
            return 0
        with self._lock:
            gate = self._inflight.setdefault(key, threading.Lock())
        with gate:
            if self._store.resident_nbytes(key) is not None:
                return 0  # a sibling's fetch landed while this one queued
            try:
                data = self._client.fetch_chunk(algo, hexdigest)
                if data is None:
                    return None
                if not self._store.put(key, data, expect_digest=f"{algo}:{hexdigest}"):
                    return None  # the populate failed (disk?): origin serves
                self._record_hit(len(data))
                return len(data)
            finally:
                with self._lock:
                    self._inflight.pop(key, None)

    async def _read_cas(self, read_io: ReadIO) -> None:
        algo, hexdigest = cas.parse_cas_location(read_io.path)
        loop = asyncio.get_running_loop()
        fetched = await loop.run_in_executor(self._executor, self._ensure_chunk, algo, hexdigest)
        await self._inner.read(read_io)
        if fetched is None:
            self._record_miss(memoryview(read_io.buf).nbytes)

    def _out_buffer(self, read_io: ReadIO, nbytes: int, what: str) -> memoryview:
        if read_io.into is None:
            return memoryview(bytearray(nbytes))
        out = memoryview(read_io.into).cast("B")
        if out.nbytes != nbytes:
            raise ValueError(f"casx {what} size mismatch: into={out.nbytes} parts={nbytes}")
        return out

    async def _read_casx(self, read_io: ReadIO) -> None:
        """Each part of a ``casx://`` location from its own peer; a part no
        peer holds is one origin read through the inner stack (the cache
        populates it); the payload is then assembled from the resident
        parts.  The whole-entry key is not populated: parts are what this
        host can serve onward, and the assembly would double the disk."""
        from . import cache as cache_mod

        parts = cas.parse_casx_location(read_io.path)
        exact_key, _, _ = cache_mod.keys_for(self._ns, read_io.path, None)
        loop = asyncio.get_running_loop()
        if await loop.run_in_executor(self._executor, self._store.resident_nbytes, exact_key) is not None:
            await self._inner.read(read_io)
            return
        outcomes = await asyncio.gather(
            *(loop.run_in_executor(self._executor, self._ensure_chunk, algo, hexd) for algo, hexd, _ in parts)
        )
        for (algo, hexd, _), outcome in zip(parts, outcomes):
            if outcome is None:
                sub = ReadIO(path=cas.location_for(algo, hexd))
                await self._inner.read(sub)
                self._record_miss(memoryview(sub.buf).nbytes)
        out = self._out_buffer(read_io, sum(n for _, _, n in parts), "assembly")

        def _assemble() -> None:
            offset = 0
            for algo, hexd, nbytes in parts:
                if self._store.get(f"cas/{algo}/{hexd}", into=out[offset : offset + nbytes]) is not True:
                    raise KeyError(f"cas/{algo}/{hexd} not resident")
                offset += nbytes

        await loop.run_in_executor(self._executor, _assemble)
        read_io.buf = read_io.into if read_io.into is not None else out
        read_io.hash64 = None  # the consumer verifies with its own pass

    async def _read_casx_range(self, read_io: ReadIO) -> None:
        """A range of a ``casx://`` entry: only the parts it overlaps are
        made resident, and the range is spliced out of them.  A part no
        peer holds sends the whole request inward (one origin ranged read
        costs fewer round trips than a per-part assembly)."""
        from . import cache as cache_mod

        exact_key, full_key, _ = cache_mod.keys_for(self._ns, read_io.path, read_io.byte_range)
        loop = asyncio.get_running_loop()
        a, b = read_io.byte_range

        def _already_served() -> bool:
            if self._store.resident_nbytes(exact_key) is not None:
                return True
            nbytes = self._store.resident_nbytes(full_key)
            return nbytes is not None and b <= nbytes

        if await loop.run_in_executor(self._executor, _already_served):
            await self._inner.read(read_io)
            return
        overlap = []  # (algo, hexd, start in part, end in part, offset in range)
        offset = 0
        for algo, hexd, nbytes in cas.parse_casx_location(read_io.path):
            lo, hi = max(a, offset), min(b, offset + nbytes)
            if lo < hi:
                overlap.append((algo, hexd, lo - offset, hi - offset, lo - a))
            offset += nbytes
        if b > offset:
            raise ValueError(f"range {read_io.byte_range} exceeds casx extent {offset}")
        outcomes = await asyncio.gather(
            *(loop.run_in_executor(self._executor, self._ensure_chunk, algo, hexd) for algo, hexd, _, _, _ in overlap)
        )
        if any(outcome is None for outcome in outcomes):
            await self._inner.read(read_io)
            self._record_miss(b - a)
            return
        out = self._out_buffer(read_io, b - a, "range")

        def _assemble() -> None:
            for algo, hexd, lo, hi, dest in overlap:
                got = self._store.get(f"cas/{algo}/{hexd}", into=out[dest : dest + (hi - lo)], byte_range=[lo, hi])
                if got is not True:
                    raise KeyError(f"cas/{algo}/{hexd} not resident")

        await loop.run_in_executor(self._executor, _assemble)
        read_io.buf = read_io.into if read_io.into is not None else out
        read_io.hash64 = None  # the consumer verifies with its own pass

    # ------------------------------------------------------- passthroughs

    async def write(self, write_io: WriteIO) -> None:
        await self._inner.write(write_io)

    async def exists(self, path: str) -> bool:
        return await self._inner.exists(path)

    async def list_dir(self, path: str) -> List[str]:
        return await self._inner.list_dir(path)

    async def delete(self, path: str) -> None:
        await self._inner.delete(path)

    async def delete_dir(self, path: str) -> None:
        await self._inner.delete_dir(path)

    async def copy_from_sibling(self, src_root: str, path: str) -> bool:
        return await self._inner.copy_from_sibling(src_root, path)

    async def close(self) -> None:
        self._emit_summary()
        try:
            await self._inner.close()
        finally:
            # Every read awaited its executor work, so the pool is idle.
            self._executor.shutdown(wait=True)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "hit_bytes": self.hit_bytes,
                "miss_bytes": self.miss_bytes,
                "rejects": self._client.rejects,
            }

    def _emit_summary(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        stats = self.stats()
        if not (stats["hits"] or stats["misses"] or stats["rejects"]):
            return
        _add_totals(**stats)
        tmetrics.record_peer(stats["hits"], stats["misses"], stats["hit_bytes"], stats["miss_bytes"])
        if stats["hits"]:
            log_event(Event(name="peer.hit", metadata={"count": stats["hits"], "bytes": stats["hit_bytes"]}))
        if stats["misses"]:
            log_event(Event(name="peer.miss", metadata={"count": stats["misses"], "bytes": stats["miss_bytes"]}))
        logger.debug(
            "peer: %d chunks (%.1f MB) from peers, %d (%.1f MB) from origin, %d rejects",
            stats["hits"],
            stats["hit_bytes"] / 1e6,
            stats["misses"],
            stats["miss_bytes"] / 1e6,
            stats["rejects"],
        )


# ------------------------------------------------------------------- wiring


def resolve_kv_store() -> Optional[Any]:
    """The coordination store the peer plane runs on (``TPUSNAP_STORE_ADDR``,
    ``TPUSNAP_STORE_PATH``, else the default process group's), or None when
    there is none: peer serving is then off (it is an optimization)."""
    from . import dist_store

    try:
        return dist_store.get_or_create_store(0, 1)
    except Exception:  # noqa: BLE001
        return None


def maybe_wrap_peer_reads(storage: StoragePlugin, self_addr: Optional[str] = None) -> StoragePlugin:
    """Wrap a cache-wrapped read stack with the peer fetch policy when
    ``TPUSNAP_PEER_FETCH`` is on and a coordination store is configured;
    otherwise (no cache reader below, no store) the stack as it is."""
    from . import cache as cache_mod

    if not knobs.peer_fetch_enabled():
        return storage
    cache_reader = cache_mod.find_reader(storage)
    if cache_reader is None:
        return storage
    kv = resolve_kv_store()
    if kv is None:
        logger.warning("TPUSNAP_PEER_FETCH set but no coordination store configured; peer fetch disabled")
        return storage
    if self_addr is None:
        self_addr = knobs.get_peer_addr()
    return PeerReaderPlugin(
        inner=storage,
        store=cache_reader.store,
        namespace=cache_reader.namespace,
        client=PeerClient(kv, self_addr=self_addr),
    )


def find_peer_reader(storage: StoragePlugin) -> Optional[PeerReaderPlugin]:
    """The PeerReaderPlugin in a wrapped storage stack, or None."""
    for _ in range(8):
        if storage is None:
            return None
        if isinstance(storage, PeerReaderPlugin):
            return storage
        storage = getattr(storage, "_inner", None)
    return None


def reader_stats(storage: StoragePlugin) -> Optional[Dict[str, int]]:
    reader = find_peer_reader(storage)
    return reader.stats() if reader is not None else None
