"""peerd: the per-host chunk-serving daemon of the peer tier.

Counterpart of ``torchsnapshot_tpu/peerd.py``, on the same wire and
registry format, so a daemon of either package serves a client of either.
A small HTTP/1.1 server (the standard library's ``ThreadingHTTPServer``)
that offers this host's chunk cache to the fleet:

- ``GET /chunk/<algo>/<hex>`` — the chunk's bytes, verified against their
  name in the local cache before they leave the host.  One ``Range:``
  header is honoured (``206`` and ``Content-Range``); a chunk that is not
  resident is a ``404``.  Content-addressed bytes never change, hence
  ``Cache-Control: immutable``; any HTTP client can verify what it got
  (examples/http_range_pull.py).
- ``GET /healthz`` — liveness and the daemon's identity.
- ``GET /inventory`` — what this host can serve (a listing capped at
  ``_INVENTORY_CAP`` entries, with ``chunks_total`` and ``truncated``).
- ``GET /metrics`` — the process's metrics registry in the Prometheus text
  format (requests served, bytes, peer-fetch latency; ``TPUSNAP_METRICS=1``).
- ``POST /rollout?step=N`` — warm the delta of a manager root's step into
  the local cache through the read stack (peer-first with
  ``TPUSNAP_PEER_FETCH``: a canary pulls from origin once, the fleet from
  the canaries) and report what moved.

The daemon serves only what the host holds: it never proxies an origin
read, so fleet traffic cannot add origin traffic.  On start it registers on
the coordination store (peer.PeerRegistration); with no store configured it
serves without discovery, reachable by address only.

Observability: with ``TPUSNAP_TRACE_DIR`` set, each request is a
``peerd_handle`` span in the daemon's own trace file (telemetry/trace.py
``ServerTracer``), parented on the client's ``peer_fetch`` span through the
request's ``traceparent``, and a line of the JSON-lines access log
(``TPUSNAP_PEERD_ACCESS_LOG``, by default beside the traces).  The daemon's
lifetime is a monitored ``serve`` op and each rollout a monitored
``rollout`` op; with ``TPUSNAP_FLEET_TELEMETRY`` set their monitors keep
fleet-spool entries fresh, and :func:`rollout_fleet` publishes its live
progress document (wave, hosts completed of total, delta bytes from peers
and from origin, ETA) at each wave and after every host.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor, as_completed
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from . import cache as cache_mod
from . import cas as cas_mod
from . import integrity, knobs
from . import journal as journal_mod
from . import peer as peer_mod
from .event import Event
from .event_handlers import log_event
from .storage_plugin import url_to_storage_plugin
from .telemetry import fleet as tfleet
from .telemetry import metrics as tmetrics
from .telemetry import monitor as tmonitor
from .telemetry import trace as ttrace

logger = logging.getLogger(__name__)

__all__ = [
    "PeerDaemon",
    "resolve_rollout_target",
    "delta_locations",
    "rollout_fleet",
]

_INVENTORY_CAP = 5000


# ------------------------------------------------------------ delta resolve


def resolve_rollout_target(root: str, step: Optional[int]):
    """``(step, snapshot path, metadata, previous metadata)`` of a rollout
    of ``step`` (default: the latest) under a manager root.  The previous
    metadata is the merged view of the restore point before ``step``, the
    baseline of the delta, or None when ``step`` is the first."""
    from .manager import SnapshotManager
    from .pg_wrapper import PGWrapper
    from .snapshot import Snapshot

    points = SnapshotManager(root, pg=PGWrapper()).restore_points()
    if not points:
        raise ValueError(f"{root} has no committed restore points")
    steps = sorted({s for s, _ in points})
    if step is None:
        step = steps[-1]
    if step not in steps:
        raise ValueError(f"step {step} has no committed restore point")

    def _resolve(s: int):
        if "full" in [k for ss, k in points if ss == s]:
            snap_path = f"{root.rstrip('/')}/step_{s}"
            return snap_path, Snapshot(snap_path).metadata
        storage = url_to_storage_plugin(root)
        try:
            merged, _ = journal_mod.merged_metadata(storage, s)
        finally:
            storage.sync_close()
        return journal_mod.segment_path(root.rstrip("/"), s), merged

    snap_path, metadata = _resolve(step)
    prior = [s for s in steps if s < step]
    prev_metadata = _resolve(prior[-1])[1] if prior else None
    return step, snap_path, metadata, prev_metadata


def delta_locations(metadata: Any, prev_metadata: Optional[Any]):
    """The ``(location, nbytes)`` items a step introduced over the previous
    restore point: under CAS or a journal exactly the changed chunks, so a
    fine-tune rolls out as a delta.  With no baseline, everything."""
    items = cache_mod.payload_locations(metadata)
    if prev_metadata is None:
        return items
    prev = {loc for loc, _ in cache_mod.payload_locations(prev_metadata)}
    return [(loc, nbytes) for loc, nbytes in items if loc not in prev]


def _rollout_storage(snap_path: str, metadata: Any):
    """The read stack a warm uses: backend (with faults), CAS resolution,
    the cache, and the peer tier when it is on."""
    storage = url_to_storage_plugin(snap_path)
    try:
        storage = cas_mod.maybe_wrap_cas_reads(storage, snap_path, metadata)
        return cache_mod.maybe_wrap_cache_reads(storage, metadata)
    except BaseException:
        storage.sync_close()
        raise


# --------------------------------------------------------------- the daemon


class PeerDaemon:
    """One host's chunk server and its registry row.

    ``root`` (optional) is the manager root ``/rollout`` warms from;
    ``cache_dir`` (default ``TPUSNAP_CACHE_DIR``) is what ``/chunk`` serves.
    ``advertise`` overrides the registered ``host:port`` (a bare host is
    joined with the bound port).  Registration needs a coordination store
    (``TPUSNAP_STORE_PATH``/``_ADDR``); without one the daemon serves
    unregistered.
    """

    def __init__(
        self,
        root: Optional[str] = None,
        cache_dir: Optional[str] = None,
        port: Optional[int] = None,
        advertise: Optional[str] = None,
        register: bool = True,
    ) -> None:
        self.root = root
        cache_dir = cache_dir or knobs.get_cache_dir()
        if not cache_dir:
            raise ValueError("peerd needs a cache to serve: set TPUSNAP_CACHE_DIR or pass cache_dir")
        self.cache_dir = cache_dir
        self.store = cache_mod.CacheStore(cache_dir)
        self._port = knobs.get_peer_port() if port is None else port
        self._advertise = advertise if advertise is not None else knobs.get_peer_addr()
        self._register = register
        self._registration: Optional[peer_mod.PeerRegistration] = None
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._rollout_lock = threading.Lock()
        self.started_at = time.time()
        self.addr: Optional[str] = None
        self.ident = uuid.uuid4().hex
        self.tracer: Optional[ttrace.ServerTracer] = None
        self.access_log: Optional[ttrace.AccessLog] = None
        self._serve_mon: Optional[tmonitor.OpMonitor] = None

    # ------------------------------------------------------------ lifecycle

    def start(self) -> str:
        """Bind, serve on a background thread, register; returns the
        advertised ``host:port``.  Server-side spans and the access log
        follow the ``TPUSNAP_TRACE_DIR`` the rest of the pipeline traces
        to, so a traced restore finds the daemon's spans to stitch."""
        trace_dir = knobs.get_trace_dir()
        if trace_dir:
            self.tracer = ttrace.ServerTracer(trace_dir, self.ident)
        log_path = knobs.get_peerd_access_log()
        if log_path is None and trace_dir:
            log_path = os.path.join(trace_dir, f"peerd-{os.getpid()}{ttrace.ACCESS_LOG_SUFFIX}")
        if log_path:
            self.access_log = ttrace.AccessLog(log_path, max_bytes=knobs.get_peerd_access_log_max_bytes())
        handler = type("_BoundHandler", (_ChunkRequestHandler,), {"daemon": self})
        self._server = ThreadingHTTPServer(("", self._port), handler)
        self._server.daemon_threads = True
        self.addr = self._advertised_addr(self._server.server_address[1])
        self._thread = threading.Thread(target=self._server.serve_forever, name="tpusnap_peerd", daemon=True)
        self._thread.start()
        if self._register:
            kv = peer_mod.resolve_kv_store()
            if kv is not None:
                self._registration = peer_mod.PeerRegistration(kv, self.addr)
            else:
                logger.warning("peerd serving on %s without registration: no coordination store configured", self.addr)
        # A monitored `serve` op for the daemon's lifetime (no watchdog:
        # serving has no pipeline to stall); its flight-recorder records
        # say when the daemon served.
        self._serve_mon = tmonitor.op_started("serve", self.ident, 0, watchdog=False)
        logger.info("peerd serving %s on %s", self.cache_dir, self.addr)
        return self.addr

    def _advertised_addr(self, bound_port: int) -> str:
        adv = self._advertise
        if adv and ":" in adv:
            return adv
        return f"{adv or _default_host()}:{bound_port}"

    def close(self) -> None:
        """Tombstone the registration (peers drop this host at once), stop
        serving, close the socket and join the serving thread."""
        if self._registration is not None:
            self._registration.close()
            self._registration = None
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._serve_mon is not None:
            tmonitor.op_finished(self._serve_mon, success=True)
            self._serve_mon = None
        if self.tracer is not None:
            self.tracer.close()  # the final flush; the access log appends per line
            self.tracer = None

    # ----------------------------------------------------------- endpoints

    def read_chunk(self, algo: str, hexdigest: str) -> Optional[memoryview]:
        """The chunk's bytes from the local cache (sent from the buffer the
        store read them into, uncopied), or None.  The store verifies the
        digest of a whole read, so a corrupt local entry is dropped rather
        than spread to the fleet."""
        return self.store.get(f"cas/{algo}/{hexdigest}")

    def healthz(self) -> Dict[str, Any]:
        return {
            "ok": True,
            "addr": self.addr,
            "host": socket.gethostname(),
            "pid": os.getpid(),
            "cache_dir": self.cache_dir,
            "uptime_s": round(time.time() - self.started_at, 3),
        }

    def inventory(self) -> Dict[str, Any]:
        """The cache's totals and a listing of its entries (key and size),
        capped at ``_INVENTORY_CAP``; ``chunks_total`` counts them all."""
        totals = self.store.stats()
        chunks: List[Dict[str, Any]] = []
        chunks_total = 0
        truncated = False
        for _, nbytes, _, meta_path in self.store._walk_entries():
            chunks_total += 1
            if len(chunks) >= _INVENTORY_CAP:
                truncated = True
                continue
            try:
                with open(meta_path, "r", encoding="utf-8") as f:
                    meta = json.load(f)
            except (OSError, ValueError):
                continue
            chunks.append({"key": meta.get("key"), "nbytes": nbytes})
        return {
            "entries": totals["entries"],
            "bytes": totals["bytes"],
            "max_bytes": totals["max_bytes"],
            "chunks": chunks,
            "chunks_total": chunks_total,
            "truncated": truncated,
        }

    def observe_request(
        self,
        *,
        path: str,
        begin_us: float,
        wall_s: float,
        status: int,
        nbytes: int,
        kind: str,
        traceparent: Optional[str],
        chunk_header: Optional[str],
        byte_range: Optional[str],
        client: str,
    ) -> None:
        """Record one served request: a ``peerd_handle`` span in the
        daemon's trace file (a child of the client's span when the request
        carried a ``traceparent``) and one access-log line."""
        digest = chunk_header
        if digest is None and path.startswith("/chunk/"):
            digest = path[len("/chunk/") :].replace("/", ":", 1)
        parsed = ttrace.parse_traceparent(traceparent) if traceparent else None
        if self.tracer is not None:
            args: Dict[str, Any] = {"path": path, "kind": kind, "status": status, "bytes": nbytes, "client": client}
            if digest:
                args["digest"] = digest
            if parsed is not None:
                args["trace"] = parsed[0]
                args["parent"] = f"{parsed[1]:016x}"
            self.tracer.record_span("peerd_handle", begin_us, wall_s * 1e6, args)
        if self.access_log is not None:
            self.access_log.log(
                ts=round(time.time(), 6),
                trace=parsed[0] if parsed is not None else None,
                digest=digest,
                range=byte_range,
                status=status,
                bytes=nbytes,
                wall_s=round(wall_s, 6),
                client=client,
            )

    def rollout(self, step: Optional[int], concurrency: int = 8) -> Dict[str, Any]:
        """Warm ``step``'s delta into this daemon's cache and report the
        split: bytes from peers, from origin, already resident.  One rollout
        at a time per daemon (concurrent waves would fetch the delta twice).
        The read stack is built on this daemon's cache, so what a rollout
        pulls is exactly what ``/chunk`` offers, and its peer tier leaves
        this daemon out of the candidates."""
        if not self.root:
            raise ValueError("this daemon serves no manager root")
        with self._rollout_lock:
            step, snap_path, metadata, prev_md = resolve_rollout_target(self.root, step)
            items = delta_locations(metadata, prev_md)
            storage = url_to_storage_plugin(snap_path)
            try:
                storage = cas_mod.maybe_wrap_cas_reads(storage, snap_path, metadata)
                storage = cache_mod.CacheReaderPlugin(storage, self.store, cache_mod.snapshot_fingerprint(metadata))
                storage = peer_mod.maybe_wrap_peer_reads(storage, self_addr=self.addr)
                health = tmonitor.op_started("rollout", uuid.uuid4().hex, 0, watchdog=False)
                begin = time.monotonic()
                try:
                    stats = cache_mod.warm_snapshot(storage, metadata, concurrency=concurrency, items=items)
                except BaseException:
                    tmonitor.op_finished(health, success=False)
                    raise
                tmonitor.op_finished(health, success=True)
                wall = time.monotonic() - begin
            finally:
                storage.sync_close()
        return {
            "step": step,
            "snapshot": snap_path,
            "delta_locations": len(items),
            "delta_bytes": stats["bytes"],
            "wall_s": round(wall, 4),
            "cache": {k: stats.get(k, 0) for k in ("hits", "misses", "hit_bytes", "miss_bytes")},
            "peer": {k: stats.get(f"peer_{k}", 0) for k in ("hits", "misses", "hit_bytes", "miss_bytes")},
        }


def _default_host() -> str:
    """The host peers should dial: this machine's name when it resolves,
    else loopback."""
    host = socket.gethostname()
    try:
        socket.getaddrinfo(host, None)
        return host
    except OSError:
        return "127.0.0.1"


# ------------------------------------------------------------ HTTP plumbing

_RANGE_INVALID = object()


class _ChunkRequestHandler(BaseHTTPRequestHandler):
    server_version = "tpusnap-peerd/1.0"
    protocol_version = "HTTP/1.1"
    daemon: PeerDaemon  # bound by subclassing in PeerDaemon.start

    def do_GET(self) -> None:  # noqa: N802 — http.server API
        self._observed(self._route_get)

    def do_POST(self) -> None:  # noqa: N802 — http.server API
        self._observed(self._route_post)

    def _observed(self, route) -> None:
        """Run one route and hand its outcome (stashed by ``_begin``) and
        its wall to the daemon's tracer and access log, which never fail a
        request."""
        self._resp_status = 0
        self._resp_bytes = 0
        self._resp_kind = "other"
        begin_us = ttrace._now_us()
        t0 = time.monotonic()
        try:
            route()
        finally:
            try:
                self.daemon.observe_request(
                    path=self.path.split("?", 1)[0],
                    begin_us=begin_us,
                    wall_s=time.monotonic() - t0,
                    status=self._resp_status,
                    nbytes=self._resp_bytes,
                    kind=self._resp_kind,
                    traceparent=self.headers.get("traceparent"),
                    chunk_header=self.headers.get("tpusnap-chunk"),
                    byte_range=self.headers.get("Range"),
                    client=self.client_address[0],
                )
            except Exception:  # noqa: BLE001 — observability never breaks serving
                logger.debug("peerd observe_request failed", exc_info=True)

    def _route_get(self) -> None:
        path = self.path.split("?", 1)[0]
        if path == "/healthz":
            self._send_json(200, self.daemon.healthz(), kind="healthz")
        elif path == "/inventory":
            self._send_json(200, self.daemon.inventory(), kind="inventory")
        elif path == "/metrics":
            self._serve_metrics()
        elif path.startswith("/chunk/"):
            self._serve_chunk(path)
        else:
            self._send_json(404, {"error": f"no such endpoint: {path}"}, kind="other")

    def _serve_metrics(self) -> None:
        """The process's registry in the Prometheus text format: what this
        daemon counted (requests served, their bytes) and the peer-fetch
        latency of its own rollout warms."""
        body = tmetrics.render_prometheus().encode("utf-8")
        self._begin(200, "text/plain; version=0.0.4; charset=utf-8", len(body), kind="metrics")
        self.end_headers()
        self._write_body(body)

    def _route_post(self) -> None:
        parsed = urlparse(self.path)
        if parsed.path != "/rollout":
            self._send_json(404, {"error": f"no such endpoint: {parsed.path}"}, kind="other")
            return
        query = parse_qs(parsed.query)
        try:
            step = int(query["step"][0]) if "step" in query else None
            concurrency = int(query["concurrency"][0]) if "concurrency" in query else 8
        except ValueError:
            self._send_json(400, {"error": "step/concurrency must be integers"}, kind="rollout")
            return
        try:
            result = self.daemon.rollout(step, concurrency=concurrency)
        except Exception as e:  # noqa: BLE001 — report it; the daemon serves on
            logger.warning("rollout failed", exc_info=True)
            self._send_json(500, {"error": str(e)}, kind="rollout")
            return
        self._send_json(200, result, kind="rollout")

    def _serve_chunk(self, path: str) -> None:
        parts = path.split("/")  # "", "chunk", algo, hexdigest
        if len(parts) != 4 or not parts[2] or not parts[3]:
            self._send_json(400, {"error": "expected /chunk/<algo>/<digest>"}, kind="chunk")
            return
        algo, hexdigest = parts[2], parts[3]
        data = self.daemon.read_chunk(algo, hexdigest)
        if data is None:
            self._send_json(404, {"error": f"{algo}/{hexdigest} not resident"}, kind="chunk")
            return
        total = len(data)
        byte_range = self._parse_range(total)
        if byte_range is _RANGE_INVALID:
            self._begin(416, "application/json", 0, kind="chunk")
            self.send_header("Content-Range", f"bytes */{total}")
            self.end_headers()
            return
        if byte_range is not None:
            start, end = byte_range
            body = data[start : end + 1]
            self._begin(206, "application/octet-stream", len(body), kind="chunk")
            self.send_header("Content-Range", f"bytes {start}-{end}/{total}")
        else:
            body = data
            self._begin(200, "application/octet-stream", total, kind="chunk")
        # Content-addressed: the name is the checksum, the bytes never change.
        self.send_header("Cache-Control", "public, max-age=31536000, immutable")
        self.send_header("Accept-Ranges", "bytes")
        self.send_header("X-Chunk-Digest", f"{algo}:{hexdigest}")
        self.end_headers()
        self._write_body(body)

    def _parse_range(self, total: int):
        """One ``Range: bytes=a-b`` / ``a-`` / ``-n`` header as a closed
        interval; None when absent or multi-range (answered whole, as RFC
        7233 allows); ``_RANGE_INVALID`` when unsatisfiable."""
        header = self.headers.get("Range")
        if not header or not header.startswith("bytes="):
            return None
        spec = header[len("bytes=") :].strip()
        if "," in spec:
            return None
        start_s, sep, end_s = spec.partition("-")
        if not sep:
            return _RANGE_INVALID
        try:
            if start_s == "":
                n = int(end_s)
                if n <= 0:
                    return _RANGE_INVALID
                return max(0, total - n), total - 1
            start = int(start_s)
            end = int(end_s) if end_s else total - 1
        except ValueError:
            return _RANGE_INVALID
        if start >= total or end < start:
            return _RANGE_INVALID
        return start, min(end, total - 1)

    def _begin(self, status: int, ctype: str, nbytes: int, kind: str) -> None:
        # The outcome for _observed's span and access-log line (the last
        # _begin wins, e.g. a 416 after a parsed but unsatisfiable Range).
        self._resp_status = status
        self._resp_bytes = nbytes
        self._resp_kind = kind
        tmetrics.record_peerd_request(kind, status, nbytes)
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(nbytes))

    def _send_json(self, status: int, doc: Dict[str, Any], kind: str) -> None:
        body = json.dumps(doc).encode("utf-8")
        self._begin(status, "application/json", len(body), kind=kind)
        self.end_headers()
        self._write_body(body)

    def _write_body(self, body) -> None:
        try:
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            pass  # the client went away mid-body; its digest gate handles it

    def log_message(self, fmt: str, *args: Any) -> None:
        logger.debug("peerd %s: " + fmt, self.client_address[0], *args)


# --------------------------------------------------------- rollout (client)


def rollout_fleet(
    root: str,
    step: Optional[int],
    canary: int = 1,
    verify_chunks: int = 4,
    concurrency: int = 8,
    timeout_s: float = 600.0,
) -> Dict[str, Any]:
    """Staged delta broadcast of ``step`` to every live daemon.  The first
    ``canary`` hosts (rendezvous-ranked by the rollout's identity, so a
    repeated rollout picks the same canaries) warm first; then each canary
    must serve a sample of the delta's chunks whose bytes hash to their
    names; only then does the rest of the fleet warm, peer-first with
    ``TPUSNAP_PEER_FETCH`` in the daemons' environment, so the delta leaves
    origin about once.  A canary failure aborts before any fleet host."""
    kv = peer_mod.resolve_kv_store()
    if kv is None:
        raise ValueError("rollout needs the coordination store: set TPUSNAP_STORE_PATH or TPUSNAP_STORE_ADDR")
    peers = peer_mod.live_peers(kv)
    if not peers:
        raise ValueError("no live peer daemons registered")
    ranked = peer_mod.rendezvous_order(f"rollout/{root}/{step}", peers)
    canaries = ranked[: max(1, canary)]
    fleet = ranked[max(1, canary) :]
    log_event(
        Event(name="rollout.start", metadata={"root": root, "step": step, "canaries": len(canaries), "fleet": len(fleet)})
    )

    def _roll_one(p: peer_mod.PeerInfo) -> Dict[str, Any]:
        path = f"/rollout?concurrency={concurrency}" + (f"&step={step}" if step is not None else "")
        try:
            status, _, body = peer_mod.http_request(p.addr, "POST", path, timeout_s)
            if status != 200:
                return {"peer": p.addr, "ok": False, "error": f"HTTP {status}: {body[:512].decode('utf-8', 'replace')}"}
            doc = json.loads(body)
        except Exception as e:  # noqa: BLE001 — a failed host fails its wave
            return {"peer": p.addr, "ok": False, "error": repr(e)}
        return {"peer": p.addr, "ok": True, "warm": doc}

    def _verify_one(p: peer_mod.PeerInfo, sample: List[Tuple[str, str]]) -> Dict[str, Any]:
        """The canary must serve delta chunks that hash to their names: the
        trust gate of every peer fetch, applied before the fleet follows."""
        for algo, hexdigest in sample:
            try:
                status, _, body = peer_mod.http_request(p.addr, "GET", f"/chunk/{algo}/{hexdigest}", timeout_s)
            except Exception as e:  # noqa: BLE001
                return {"peer": p.addr, "ok": False, "error": repr(e)}
            if status != 200:
                return {"peer": p.addr, "ok": False, "error": f"HTTP {status} serving {algo}:{hexdigest}"}
            expect = f"{algo}:{hexdigest}"
            if integrity.digest_as(body, expect) != expect:
                return {"peer": p.addr, "ok": False, "error": f"digest mismatch serving {expect}"}
        return {"peer": p.addr, "ok": True, "chunks_verified": len(sample)}

    def _enter_wave(wave: str, total: int) -> None:
        progress.update(wave=wave, completed=0, total=total, eta_s=None)
        tmetrics.record_rollout_wave(wave)
        log_event(Event(name="rollout.wave", metadata={"root": root, "step": progress["step"], "wave": wave, "hosts": total}))
        tfleet.publish(mon)

    def _run_wave(pool, fn, targets) -> List[Dict[str, Any]]:
        """Order-preserving fan-out that publishes the progress document
        (hosts done, delta bytes from peers and from origin, an ETA from the
        pace so far) after every host that completes."""
        begin = time.monotonic()
        futures = {pool.submit(fn, p): i for i, p in enumerate(targets)}
        out: Dict[int, Dict[str, Any]] = {}
        for fut in as_completed(futures):
            r = fut.result()
            out[futures[fut]] = r
            progress["completed"] += 1
            peer_split = (r.get("warm") or {}).get("peer") or {}
            progress["peer_bytes"] += int(peer_split.get("hit_bytes", 0) or 0)
            progress["origin_bytes"] += int(peer_split.get("miss_bytes", 0) or 0)
            remaining = len(targets) - progress["completed"]
            progress["eta_s"] = (
                round((time.monotonic() - begin) / progress["completed"] * remaining, 1) if remaining else 0.0
            )
            tfleet.publish(mon)
        return [out[i] for i in range(len(targets))]

    def _end(success: bool) -> Dict[str, Any]:
        result["ok"] = success
        log_event(Event(name="rollout.end", metadata={"root": root, "step": result["step"], "success": success}))
        return result

    result: Dict[str, Any] = {
        "root": root,
        "step": step,
        "canaries": [p.addr for p in canaries],
        "fleet": [p.addr for p in fleet],
    }
    # The rollout is a monitored op: its start and end go to the flight
    # recorder, its tick thread refreshes its fleet-spool entry, and the
    # progress document rides every entry it publishes (fleet_extra), which
    # `top` renders as the in-flight rollout.
    mon = tmonitor.op_started("rollout", uuid.uuid4().hex, 0, watchdog=False)
    progress: Dict[str, Any] = {
        "root": root,
        "step": step,
        "wave": "canary",
        "completed": 0,
        "total": len(canaries),
        "peer_bytes": 0,
        "origin_bytes": 0,
        "eta_s": None,
    }
    mon.fleet_extra = {"rollout": progress}
    try:
        with ThreadPoolExecutor(max_workers=max(1, len(peers)), thread_name_prefix="tpusnap_rollout") as pool:
            _enter_wave("canary", len(canaries))
            result["canary_results"] = _run_wave(pool, _roll_one, canaries)
            if not all(r["ok"] for r in result["canary_results"]):
                result["aborted"] = "canary warm failed"
                return _end(False)
            # Spot-check each canary on a sample of the delta it warmed.
            resolved_step, _, metadata, prev_md = resolve_rollout_target(root, step)
            result["step"] = progress["step"] = resolved_step
            sample: List[Tuple[str, str]] = []
            for loc, _ in delta_locations(metadata, prev_md):
                if cas_mod.is_cas_location(loc):
                    sample.append(cas_mod.parse_cas_location(loc))
                elif cas_mod.is_casx_location(loc):
                    sample.extend((algo, hexd) for algo, hexd, _ in cas_mod.parse_casx_location(loc))
                if len(sample) >= verify_chunks:
                    break
            sample = sample[:verify_chunks]
            _enter_wave("verify", len(canaries))
            result["canary_verify"] = _run_wave(pool, lambda p: _verify_one(p, sample), canaries)
            if not all(r["ok"] for r in result["canary_verify"]):
                result["aborted"] = "canary digest verification failed"
                return _end(False)
            _enter_wave("fleet", len(fleet))
            result["fleet_results"] = _run_wave(pool, _roll_one, fleet)
            return _end(all(r["ok"] for r in result["fleet_results"]))
    finally:
        # The terminal entry: success mirrors the rollout's outcome, and an
        # abort or a raise folds as failed.
        tmonitor.op_finished(mon, success=bool(result.get("ok")))
