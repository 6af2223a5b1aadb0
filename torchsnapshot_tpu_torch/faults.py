"""Deterministic fault injection for storage plugins.

A :class:`FaultyStoragePlugin` wraps any backend (fs/memory/gcs/s3 — or a
third-party plugin) and fails chosen calls with chosen error classes, so
every failure path in the pipeline is testable on CPU with no cloud fake:
the scheduler's bounded write retry, the commit's cleanup-on-abort, GC of
orphaned snapshot dirs, and ``restore_latest``'s last-good fallback all run
against the same injected faults.

A copy of ``torchsnapshot_tpu/faults.py`` with the same spec grammar and
counters, so one ``TPUSNAP_FAULTS`` setting drives both packages.  This
package has no metrics or flight recorder yet (telemetry is a later
slice), so a fired rule is only logged, and its storage plugins have no
``list``/``copy_from_sibling`` verbs yet.  The ``peer`` rules act in the
peer client (peer.PeerClient), through :class:`PeerFaultInjector`.

Configured via ``TPUSNAP_FAULTS=<spec>`` (storage_plugin.py wraps every
plugin it resolves).  Spec grammar::

    spec  := rule (";" rule)*             # "none" = no rules (wrapper only)
    rule  := op ":" when ":" kind [":" param] ["@" glob]
    op    := write | read | delete | delete_dir | list | exists | any | peer
           | ledger   any storage op on a shared-store control path
                      (ledger/, sweep/, tenants/, leases/, quarantine/) —
                      the reference-journal appends, lease stamps, epoch
                      bumps, condemn markers, and quarantine moves of
                      store.py, regardless of the underlying verb
    when  := N        fire on the Nth matching call only (1-based)
           | N+       fire on the Nth matching call and every one after
           | *        alias for 1+
    kind  := transient            raise StorageTransientError (retryable)
           | terminal             raise FaultInjectionError (not retryable)
           | latency[:seconds]    sleep, then let the call proceed (0.05)
           | torn[:fraction]      writes only: persist a prefix of the
                                  payload (default half), then raise
                                  transient — a short/torn write
           | crash                os._exit(1) at the faulted call: process
                                  death (no teardown, no finally blocks) —
                                  the kill-chaos harness's seeded SIGKILL
                                  analogue
           | peer_unreachable     op=peer only: the peer fetch raises
                                  ConnectionError (dead/refusing host)
           | peer_slow[:seconds]  op=peer only: delay the fetch (0.25)
           | peer_truncated       op=peer only: the received body is cut
                                  in half AFTER wire framing — only the
                                  digest gate can catch it
    glob  := fnmatch pattern on the storage-relative path

Each rule keeps its own call counter **per plugin instance** — and the
resolver builds one plugin instance per operation, so "the 2nd write of
this take" is well-defined and deterministic.  Counters only advance on
calls the rule's op/glob match.

Examples::

    TPUSNAP_FAULTS="write:2:transient"           # 2nd write fails once
    TPUSNAP_FAULTS="write:1+:transient"          # every write fails
    TPUSNAP_FAULTS="write:1:torn:0.25@*.data"    # torn first payload write
    TPUSNAP_FAULTS="read:1:latency:0.2;read:3:terminal"
    TPUSNAP_FAULTS="delete:1:transient@cas/*"    # 1st chunk removal fails
    TPUSNAP_FAULTS="ledger:1:terminal@ledger/*"  # 1st ref-journal append
    TPUSNAP_FAULTS="ledger:2:crash"              # die at the 2nd store
                                                 # control-plane op
    TPUSNAP_FAULTS="none"                        # wrapper installed, no
                                                 # faults (overhead probe)
"""

from __future__ import annotations

import asyncio
import fnmatch
import logging
import threading
from dataclasses import dataclass
from typing import List, Optional

from .io_types import ReadIO, StoragePlugin, WriteIO, contiguous
from .retry import StorageTransientError
from .telemetry import metrics as tmetrics

logger = logging.getLogger(__name__)

_OPS = frozenset(
    {
        "write",
        "read",
        "delete",
        "delete_dir",
        "list",
        "exists",
        "any",
        "peer",
        "ledger",
    }
)
_KINDS = frozenset({"transient", "terminal", "latency", "torn", "crash"})
# Shared-store (store.py) control-plane namespaces: a rule with op=ledger
# matches ANY storage verb whose path lives under one of these — the
# reference-journal appends, writer/sweep lease stamps, epoch bumps,
# condemn markers, and quarantine moves a sweep crash window lives in.
_LEDGER_PREFIXES = (
    "ledger/",
    "sweep/",
    "tenants/",
    "leases/",
    "quarantine/",
)
# Peer-side kinds fire in the peer HTTP *client* (peer.PeerClient builds
# its own injector from the same spec), never in the storage wrapper: a
# peer fault's blast radius is one candidate fetch, and the observable
# outcome is always "fell back to the next peer / origin".
_PEER_KINDS = frozenset({"peer_unreachable", "peer_slow", "peer_truncated"})

_DEFAULT_LATENCY_S = 0.05
_DEFAULT_TORN_FRACTION = 0.5


class FaultInjectionError(RuntimeError):
    """A deliberately injected *terminal* fault (never classified
    transient, so no retry layer masks it)."""


# ------------------------------------------------------- origin accounting
#
# Every read that passes THROUGH a fault wrapper is tallied here (bytes the
# wrapped backend was actually asked for, per path) — the counting half of
# the wrapper.  ``TPUSNAP_FAULTS=none`` installs it with zero rules, turning
# it into a pure origin-traffic meter: the partial-read and serve-cache
# tests assert "bytes requested from origin" against these counters.
# Process-wide (wrapper instances are per-operation and unreachable from
# test code after the operation returns), guarded by one lock.

_READ_COUNTER_LOCK = threading.Lock()
_READ_BYTES_BY_PATH: dict = {}


def reset_read_counters() -> None:
    with _READ_COUNTER_LOCK:
        _READ_BYTES_BY_PATH.clear()


def read_counters() -> dict:
    """``{path: bytes requested from the wrapped backend}`` since the last
    reset.  Ranged reads count their range, whole reads the returned size."""
    with _READ_COUNTER_LOCK:
        return dict(_READ_BYTES_BY_PATH)


def total_read_bytes() -> int:
    with _READ_COUNTER_LOCK:
        return sum(_READ_BYTES_BY_PATH.values())


def _record_read(path: str, nbytes: int) -> None:
    with _READ_COUNTER_LOCK:
        _READ_BYTES_BY_PATH[path] = _READ_BYTES_BY_PATH.get(path, 0) + nbytes


# The write-side mirror: bytes the wrapped backend was actually asked to
# persist, per path.  ``TPUSNAP_FAULTS=none`` turns the wrapper into a pure
# write meter — the resumable-take tests assert "a retried take adopts the
# dead attempt's durable chunks" against these counters (adopted chunks are
# pure manifest references and never reach a write call).

_WRITE_BYTES_BY_PATH: dict = {}


def reset_write_counters() -> None:
    with _READ_COUNTER_LOCK:
        _WRITE_BYTES_BY_PATH.clear()


def write_counters() -> dict:
    """``{path: bytes handed to the wrapped backend's write}`` since the
    last reset.  Torn writes count the persisted prefix only."""
    with _READ_COUNTER_LOCK:
        return dict(_WRITE_BYTES_BY_PATH)


def total_write_bytes() -> int:
    with _READ_COUNTER_LOCK:
        return sum(_WRITE_BYTES_BY_PATH.values())


def _record_write(path: str, nbytes: int) -> None:
    with _READ_COUNTER_LOCK:
        _WRITE_BYTES_BY_PATH[path] = (
            _WRITE_BYTES_BY_PATH.get(path, 0) + nbytes
        )


def _nbytes_of(buf) -> int:
    """Size without materializing: joining a ScatterBuffer just to meter
    it would memcpy the whole slab."""
    nbytes = getattr(buf, "nbytes", None)
    if isinstance(nbytes, int):
        return nbytes
    try:
        return memoryview(buf).nbytes
    except (TypeError, ValueError):
        return len(buf) if isinstance(buf, (bytes, bytearray)) else 0


class InjectedTransientError(StorageTransientError):
    """A deliberately injected *transient* fault: retry layers treat it
    exactly like a real retryable storage error."""


@dataclass
class FaultRule:
    op: str  # write|read|delete|delete_dir|list|exists|any
    first: int  # 1-based matching-call index where the rule starts firing
    open_ended: bool  # True for "N+" / "*"
    kind: str  # transient|terminal|latency|torn
    param: Optional[float]  # latency seconds / torn fraction
    path_glob: Optional[str]

    def matches_op(self, op: str) -> bool:
        return self.op == "any" or self.op == op

    def matches_path(self, path: str) -> bool:
        return self.path_glob is None or fnmatch.fnmatch(path, self.path_glob)

    def matches(self, op: str, path: str) -> bool:
        """Whether this rule applies to a (storage verb, path) call.  An
        ``op=ledger`` rule matches on the PATH — any verb touching a
        shared-store control namespace — composing with the glob as a
        further restriction."""
        if self.op == "ledger":
            return path.startswith(_LEDGER_PREFIXES) and self.matches_path(
                path
            )
        return self.matches_op(op) and self.matches_path(path)


def parse_fault_spec(spec: str) -> List[FaultRule]:
    """Parse a fault spec (grammar above); raises ``ValueError`` with the
    offending rule on any malformed input — a typo'd spec silently
    injecting nothing would make a chaos run vacuously green."""
    spec = (spec or "").strip()
    if not spec or spec.lower() == "none":
        return []
    rules: List[FaultRule] = []
    for raw in spec.split(";"):
        raw = raw.strip()
        if not raw:
            continue
        rule, _, glob = raw.partition("@")
        parts = rule.strip().split(":")
        if len(parts) < 3:
            raise ValueError(
                f"fault rule {raw!r}: expected op:when:kind[:param][@glob]"
            )
        op, when, kind = parts[0].strip(), parts[1].strip(), parts[2].strip()
        param_str = parts[3].strip() if len(parts) > 3 else None
        if len(parts) > 4:
            raise ValueError(f"fault rule {raw!r}: too many ':' fields")
        if op not in _OPS:
            raise ValueError(
                f"fault rule {raw!r}: unknown op {op!r} (one of {sorted(_OPS)})"
            )
        if kind not in _KINDS and kind not in _PEER_KINDS:
            raise ValueError(
                f"fault rule {raw!r}: unknown kind {kind!r} "
                f"(one of {sorted(_KINDS | _PEER_KINDS)})"
            )
        if kind in _PEER_KINDS and op != "peer":
            raise ValueError(
                f"fault rule {raw!r}: {kind!r} applies to op 'peer' only"
            )
        if op == "peer" and kind not in _PEER_KINDS:
            raise ValueError(
                f"fault rule {raw!r}: op 'peer' takes one of "
                f"{sorted(_PEER_KINDS)}"
            )
        if kind == "torn" and op != "write":
            raise ValueError(
                f"fault rule {raw!r}: 'torn' applies to writes only"
            )
        if kind == "crash" and param_str is not None:
            raise ValueError(f"fault rule {raw!r}: 'crash' takes no param")
        if kind in ("peer_unreachable", "peer_truncated") and param_str is not None:
            raise ValueError(f"fault rule {raw!r}: {kind!r} takes no param")
        if when == "*":
            first, open_ended = 1, True
        elif when.endswith("+"):
            first, open_ended = int(when[:-1]), True
        else:
            first, open_ended = int(when), False
        if first < 1:
            raise ValueError(f"fault rule {raw!r}: call index is 1-based")
        param: Optional[float] = None
        if param_str is not None:
            param = float(param_str)
            if kind == "torn" and not (0.0 <= param < 1.0):
                raise ValueError(
                    f"fault rule {raw!r}: torn fraction must be in [0, 1)"
                )
            if kind in ("latency", "peer_slow") and param < 0:
                raise ValueError(f"fault rule {raw!r}: negative latency")
        rules.append(
            FaultRule(
                op=op,
                first=first,
                open_ended=open_ended,
                kind=kind,
                param=param,
                path_glob=glob.strip() or None if glob else None,
            )
        )
    return rules


class FaultyStoragePlugin(StoragePlugin):
    """Deterministic fault-injecting wrapper over any storage plugin.

    Composable anywhere a plugin is.  Ops without a matching rule pass
    straight through; ``close`` always passes through.
    """

    def __init__(self, inner: StoragePlugin, rules: List[FaultRule]) -> None:
        self._inner = inner
        self._rules = rules
        self._lock = threading.Lock()
        self._counts = [0] * len(rules)
        # Mirror the inner plugin's scatter capability: the batcher keys
        # slab staging costs on it, and injection must not change planning.
        self.supports_scatter = getattr(inner, "supports_scatter", False)
        # And the fused write+hash capability: the torn-write kind builds
        # its own prefix WriteIO (no hash request), so digests recorded on
        # the eventual successful retry still describe the full payload.
        self.supports_write_hash = getattr(inner, "supports_write_hash", False)

    # ------------------------------------------------------------ injection

    def _fire(self, op: str, path: str) -> Optional[FaultRule]:
        """Advance matching rules' counters; return the first rule that
        fires for this call (or None)."""
        fired: Optional[FaultRule] = None
        with self._lock:
            for i, rule in enumerate(self._rules):
                if not rule.matches(op, path):
                    continue
                self._counts[i] += 1
                n = self._counts[i]
                hits = (
                    n >= rule.first if rule.open_ended else n == rule.first
                )
                if hits and fired is None:
                    fired = rule
        if fired is not None:
            tmetrics.record_fault(op, fired.kind)
            logger.info(
                "fault injected: op=%s kind=%s path=%s", op, fired.kind, path
            )
        return fired

    async def _raise_or_delay(
        self, rule: Optional[FaultRule], op: str, path: str
    ) -> None:
        if rule is None:
            return
        if rule.kind == "crash":
            # Process death, not an exception: no teardown, no finally
            # blocks, no commit-marker cleanup — the debris is exactly
            # what a SIGKILL leaves.  Log first (best-effort) so a chaos
            # run's transcript shows where the schedule struck.
            logger.warning(
                "fault injected: CRASH at %s %s (os._exit)", op, path
            )
            import os

            os._exit(1)
        if rule.kind == "latency":
            await asyncio.sleep(
                rule.param if rule.param is not None else _DEFAULT_LATENCY_S
            )
        elif rule.kind == "transient":
            raise InjectedTransientError(
                f"injected transient fault ({op} {path})"
            )
        elif rule.kind == "terminal":
            raise FaultInjectionError(f"injected terminal fault ({op} {path})")
        # 'torn' is handled by write() itself.

    # ----------------------------------------------------------- plugin API

    async def write(self, write_io: WriteIO) -> None:
        rule = self._fire("write", write_io.path)
        if rule is not None and rule.kind == "torn":
            # Persist a prefix of the payload, then fail transiently — the
            # short write a crash mid-PUT leaves behind.  The prefix goes
            # through the inner plugin so the torn object is really there
            # for GC / checksum audits to find.
            view = memoryview(contiguous(write_io.buf)).cast("B")
            fraction = (
                rule.param if rule.param is not None else _DEFAULT_TORN_FRACTION
            )
            prefix = view[: int(view.nbytes * fraction)]
            await self._inner.write(
                WriteIO(
                    path=write_io.path,
                    buf=prefix,
                    durable=getattr(write_io, "durable", False),
                )
            )
            _record_write(write_io.path, prefix.nbytes)
            raise InjectedTransientError(
                f"injected torn write ({write_io.path}: "
                f"{prefix.nbytes}/{view.nbytes} bytes persisted)"
            )
        await self._raise_or_delay(rule, "write", write_io.path)
        await self._inner.write(write_io)
        _record_write(write_io.path, _nbytes_of(write_io.buf))

    async def read(self, read_io: ReadIO) -> None:
        await self._raise_or_delay(
            self._fire("read", read_io.path), "read", read_io.path
        )
        await self._inner.read(read_io)
        if read_io.byte_range is not None:
            nbytes = read_io.byte_range[1] - read_io.byte_range[0]
        else:
            try:
                nbytes = memoryview(read_io.buf).nbytes
            except (TypeError, ValueError):
                nbytes = 0
        _record_read(read_io.path, nbytes)

    async def delete(self, path: str) -> None:
        await self._raise_or_delay(self._fire("delete", path), "delete", path)
        await self._inner.delete(path)

    async def delete_dir(self, path: str) -> None:
        await self._raise_or_delay(
            self._fire("delete_dir", path), "delete_dir", path
        )
        await self._inner.delete_dir(path)

    async def exists(self, path: str) -> bool:
        await self._raise_or_delay(self._fire("exists", path), "exists", path)
        return await self._inner.exists(path)

    async def list_dir(self, path: str) -> List[str]:
        await self._raise_or_delay(self._fire("list", path), "list", path)
        return await self._inner.list_dir(path)

    async def copy_from_sibling(self, src_root: str, path: str) -> bool:
        return await self._inner.copy_from_sibling(src_root, path)

    def _get_executor(self):
        getter = getattr(self._inner, "_get_executor", None)
        return getter() if getter is not None else None

    async def close(self) -> None:
        await self._inner.close()


def maybe_wrap_faults(
    plugin: StoragePlugin, spec: Optional[str]
) -> StoragePlugin:
    """Wrap ``plugin`` when a fault spec is configured.  A spec of
    ``"none"`` installs the wrapper with zero rules: a pure byte meter."""
    if spec is None or not spec.strip():
        return plugin
    return FaultyStoragePlugin(plugin, parse_fault_spec(spec))


class PeerFaultInjector:
    """The peer HTTP client's side of the spec: only ``op=peer`` rules,
    one counter per rule per injector instance (one injector per
    PeerClient, so "the 2nd peer fetch of this operation" is
    deterministic).  ``fire(path)`` advances counters and returns the rule
    the client must act out — the *client* owns the behavior, because
    ``peer_truncated`` must corrupt bytes after receipt and
    ``peer_unreachable`` must look like a connect failure, neither of
    which a storage-op wrapper can stage."""

    def __init__(self, rules: List[FaultRule]) -> None:
        self._rules = [r for r in rules if r.op == "peer"]
        self._lock = threading.Lock()
        self._counts = [0] * len(self._rules)

    def __len__(self) -> int:
        return len(self._rules)

    def fire(self, path: str) -> Optional[FaultRule]:
        fired: Optional[FaultRule] = None
        with self._lock:
            for i, rule in enumerate(self._rules):
                if not rule.matches_path(path):
                    continue
                self._counts[i] += 1
                n = self._counts[i]
                hits = n >= rule.first if rule.open_ended else n == rule.first
                if hits and fired is None:
                    fired = rule
        if fired is not None:
            tmetrics.record_fault("peer", fired.kind)
            logger.info(
                "fault injected: op=peer kind=%s path=%s", fired.kind, path
            )
        return fired


def maybe_peer_injector(spec: Optional[str]) -> Optional[PeerFaultInjector]:
    """A :class:`PeerFaultInjector` for the ``op=peer`` rules of ``spec``,
    or None when there are none (the common case — the client skips the
    per-fetch rule scan entirely).  A malformed spec disables injection
    rather than failing the read path; the storage-side wrapper is the
    layer that surfaces spec typos loudly."""
    if spec is None or not spec.strip():
        return None
    try:
        rules = parse_fault_spec(spec)
    except ValueError:
        return None
    injector = PeerFaultInjector(rules)
    return injector if len(injector) else None
