"""KV store, liveness leases and the two-phase barrier of multi-rank
snapshots.

Counterpart of ``torchsnapshot_tpu/dist_store.py``; the module is
framework-neutral and is copied here with two changes: there is no flight
recorder (telemetry is a later slice of this package), and the last
fallback of :func:`get_or_create_store` is the torch.distributed bootstrap
of coordination.py instead of the JAX coordination service.  Stores:

- :class:`FileStore`: shared-filesystem store (atomic rename, link(2)
  locks with stale-lock breaking).  Used by the multi-process tests and
  valid wherever the ranks share a filesystem.
- ``tpustore.TCPStore``: client of the native TCP server in ``_native``,
  the production path; blocking GETs wait server-side.

Object collectives never move payloads, only pickled metadata, and they
run host-side over one of these stores (pg_wrapper.py).

:class:`LinearBarrier` is the two-phase arrive/depart barrier of the async
commit: usable off the main thread (an async take's background thread
issues no collectives), the leader acts between the phases, and
``report_error`` wakes every waiting peer with :class:`StorePeerError`.
"""

from __future__ import annotations

import abc
import os
import tempfile
import threading
import time
import uuid
from typing import Callable, Dict, Optional, Tuple

from . import knobs, phase_stats
from .telemetry import blackbox


class StorePeerError(RuntimeError):
    """Raised on ranks whose peer reported an error through the barrier."""


def resolve_wait_timeout_s(timeout_s: Optional[float]) -> float:
    """``None`` means "use the ``TPUSNAP_BARRIER_TIMEOUT_S`` knob" — one
    resolution point so every store implementation and the barrier agree
    on what an unspecified wait bound is."""
    return knobs.get_barrier_timeout_s() if timeout_s is None else timeout_s


# ------------------------------------------------------------ liveness leases
#
# The dominant failure on real fleets is a *dying process* — preemption,
# OOM-kill, a vanished host — not a flaky storage RPC.  Before these leases,
# a SIGKILLed rank parked every peer in its barrier/collective waits until
# TPUSNAP_BARRIER_TIMEOUT_S expired (1800 s by default).  Now every rank of
# an in-flight operation refreshes a store-side lease (``oplease/<rank>`` =
# wall-clock stamp) on a small daemon thread; a waiter whose blocking GET
# slices past the grace window re-reads the peers' leases and converts an
# expired one into a fast, symmetric ``StorePeerError`` — the same error
# class a peer's explicit ``report_error`` produces, so the abort rides the
# existing teardown paths.  Stamps are wall-clock because they are compared
# ACROSS processes (clock skew is noise next to a 10 s grace); absence of a
# lease is treated as *no information* (the peer may simply not have
# started its op yet), so a rank that dies before its first refresh still
# surfaces as a plain timeout.

OP_LEASE_PREFIX = "oplease"
# A lease holder that finished cleanly overwrites its stamp with this
# tombstone (key deletion is prefix-based in FileStore and rank 1 vs 10
# share a prefix) — waiters treat it as "exited cleanly", never as dead.
_LEASE_DONE = b"done"
# Fallback debris floor for waiters that hold no lease of their own (a
# manager's pre-take collectives, direct barrier users): peer stamps from
# before THIS process existed belong to a previous incarnation of the job
# and are no information.  A process restarted after a crash therefore
# never aborts on its predecessor's corpse, while deaths during this
# process's lifetime stay detectable everywhere.
_PROCESS_EPOCH = time.time()


class OpLease:
    """Store-side liveness lease for this process while >= 1 multi-rank
    operation is in flight.  One refresh thread per (store, process),
    refcounted across concurrent ops (an async_take draining in the
    background while the next take starts shares the lease)."""

    def __init__(self, store: "KVStore", rank: int, interval_s: float) -> None:
        self._store = store
        self._rank = rank
        self._interval_s = interval_s
        self._stop = threading.Event()
        self.refcount = 1
        # Wall-clock op-start epoch: waiters ignore PEER stamps older than
        # (this - grace) as a previous incarnation's debris — see
        # PeerLivenessChecker.
        self.acquired_at = time.time()
        self._write_stamp()
        self._thread = threading.Thread(
            target=self._run, name="tpusnap-op-lease", daemon=True
        )
        self._thread.start()

    @property
    def store(self) -> "KVStore":
        return self._store

    def key(self) -> str:
        return f"{OP_LEASE_PREFIX}/{self._rank}"

    def _write_stamp(self) -> None:
        try:
            self._store.set(self.key(), repr(time.time()).encode())
        except Exception:
            pass  # a liveness beacon must never fail the op it describes

    def _run(self) -> None:
        while not self._stop.wait(self._interval_s):
            self._write_stamp()

    def stop(self) -> None:
        """Stop refreshing.  The clean-exit tombstone is written by
        :func:`release_op_lease` — and only when no successor lease has
        taken over the key, so a back-to-back op's fresh stamp is never
        overwritten with ``done`` (a kill in that window would otherwise
        read as a clean exit and peers would ride out the full timeout)."""
        self._stop.set()
        self._thread.join(timeout=5.0)

    def write_tombstone(self) -> None:
        try:
            self._store.set(self.key(), _LEASE_DONE)
        except Exception:
            pass


_OP_LEASE_LOCK = threading.Lock()
_OP_LEASES: Dict[int, OpLease] = {}  # id(store) -> lease (store held via lease)


def acquire_op_lease(store: Optional["KVStore"], rank: int) -> Optional[OpLease]:
    """Start (or share) the liveness lease for an operation over ``store``.
    Returns None — and costs nothing — when liveness detection is disabled
    (``TPUSNAP_LEASE_GRACE_S=0``) or there is no store (world size 1)."""
    if store is None or knobs.get_lease_grace_s() <= 0:
        return None
    with _OP_LEASE_LOCK:
        lease = _OP_LEASES.get(id(store))
        if lease is not None and lease.store is store:
            lease.refcount += 1
            return lease
        lease = OpLease(store, rank, knobs.get_lease_interval_s())
        _OP_LEASES[id(store)] = lease
    blackbox.record("lease", "op_lease.acquire", {"rank": rank})
    return lease


def release_op_lease(lease: Optional[OpLease]) -> None:
    """Idempotence is the caller's job (each acquire pairs with exactly one
    release); the last release stops the refresh thread and tombstones the
    lease so peers read a clean exit, not a decaying stamp."""
    if lease is None:
        return
    with _OP_LEASE_LOCK:
        lease.refcount -= 1
        if lease.refcount > 0:
            return
        # Identity-guarded: a successor lease may already be registered
        # under this store — evicting IT would orphan its refcounting.
        if _OP_LEASES.get(id(lease.store)) is lease:
            _OP_LEASES.pop(id(lease.store), None)
    lease.stop()
    with _OP_LEASE_LOCK:
        if id(lease.store) in _OP_LEASES:
            return  # a successor lease owns the key now — its stamps rule
        lease.write_tombstone()
    blackbox.record("lease", "op_lease.release", {"rank": lease._rank})


def own_lease_start(store: Optional["KVStore"]) -> Optional[float]:
    """Wall-clock instant this process's live lease over ``store`` was
    acquired, or None — the epoch waiters use to discount a previous
    incarnation's lease debris."""
    if store is None:
        return None
    with _OP_LEASE_LOCK:
        lease = _OP_LEASES.get(id(store))
        return lease.acquired_at if lease is not None else None


class PeerLivenessChecker:
    """Reads peers' leases during a blocking wait.  Only a rank with a
    PRESENT, non-tombstone lease whose stamp aged past the grace is
    presumed dead — a missing lease is no information (the peer may not
    have entered the op yet), so plain-timeout semantics are preserved for
    store uses outside the snapshot protocol.

    ``not_before`` (the waiter's own op-start epoch when it holds a lease,
    else this process's import epoch): peer stamps older than
    ``not_before - grace`` are a *previous incarnation's* debris — a rank
    killed in an earlier attempt over this job-scoped store whose decaying
    stamp nobody tombstoned.  Discounting them keeps a restarted job from
    aborting on its predecessor's corpse; the restarted peer gets the
    usual grace window to write its first fresh stamp, after which normal
    detection resumes.  A live peer of THIS op always passes the filter:
    its stamps are at most one refresh interval old, far newer than any
    plausible ``not_before - grace``.

    Probe cost: reads are cached per rank — a tombstone is terminal, and a
    fresh stamp cannot possibly expire before ``stamp + grace``, so each
    waiter re-reads each peer at most ~once per grace window (not once per
    wait slice).  Steady-state barrier skew at world size N still costs
    O(N²/grace) reads fleet-wide; the barrier path needs only ONE detector
    in practice (its report_error fan-out wakes everyone), so the residual
    load is the pg-collective waits' — revisit with a designated-prober
    scheme if thousand-rank FileStore jobs show probe pressure."""

    def __init__(
        self,
        store: "KVStore",
        rank: int,
        world_size: int,
        grace_s: float,
        not_before: Optional[float] = None,
    ) -> None:
        self._store = store
        self._rank = rank
        self._world_size = world_size
        self._grace_s = grace_s
        self._stamp_floor = (
            not_before - grace_s if not_before is not None else None
        )
        # rank -> monotonic instant before which re-reading its lease is
        # pointless (fresh stamp can't have expired yet); None = terminal
        # tombstone, never re-read.
        self._next_probe: Dict[int, Optional[float]] = {}

    def dead_peer(self) -> Optional[Tuple[int, float]]:
        """``(rank, lease_age_s)`` of the first peer whose lease expired,
        or None.  Store errors read as "no information" — a flaky probe
        must never fail a healthy barrier."""
        now = time.time()
        mono = time.monotonic()
        for r in range(self._world_size):
            if r == self._rank:
                continue
            cached = self._next_probe.get(r, 0.0)
            if cached is None or (cached and mono < cached):
                continue
            try:
                raw = self._store.try_get(f"{OP_LEASE_PREFIX}/{r}")
            except Exception:
                return None
            if raw == _LEASE_DONE:
                self._next_probe[r] = None  # clean exit: terminal
                continue
            if raw is None:
                continue  # no lease yet: keep probing (cheap negative)
            try:
                stamp = float(raw)
            except ValueError:
                continue
            if self._stamp_floor is not None and stamp < self._stamp_floor:
                continue  # a previous incarnation's debris: no information
            age = now - stamp
            if age > self._grace_s:
                return r, age
            # Fresh: can't possibly expire before the remaining grace runs
            # out — skip re-reads until then.
            self._next_probe[r] = mono + (self._grace_s - age)
        return None


def wait_with_liveness(
    store: "KVStore",
    key: str,
    timeout_s: Optional[float],
    rank: int,
    world_size: int,
    lease_store: Optional["KVStore"] = None,
    on_dead: Optional[Callable[[int, float, str], None]] = None,
) -> bytes:
    """Blocking GET bounded by the barrier timeout, sliced so a peer's
    lease expiry surfaces in ~grace seconds instead of the full timeout.

    ``lease_store``: where the ``oplease/<rank>`` keys live when ``store``
    is a namespaced view (LinearBarrier's PrefixStore).  ``on_dead`` runs
    before the :class:`StorePeerError` raise — the barrier points it at
    ``report_error`` so every other waiter wakes symmetrically."""
    grace = knobs.get_lease_grace_s()
    resolved = resolve_wait_timeout_s(timeout_s)
    if grace <= 0 or world_size <= 1:
        return store.get(key, timeout_s=resolved)
    deadline = time.monotonic() + resolved
    slice_s = max(0.05, min(grace / 4.0, 5.0))
    checker: Optional[PeerLivenessChecker] = None
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise TimeoutError(f"Timed out waiting for store key: {key}")
        try:
            return store.get(key, timeout_s=min(slice_s, remaining))
        except TimeoutError:
            if checker is None:  # lazily: fast waits never pay for one
                base = lease_store if lease_store is not None else store
                # Our own op-start epoch discounts lease debris from a
                # previous incarnation of this job over the same store;
                # waiters outside any op (pre-take manager collectives)
                # fall back to the process epoch — debris predating this
                # process is equally not ours to act on.
                not_before = own_lease_start(base)
                if not_before is None:
                    not_before = _PROCESS_EPOCH
                checker = PeerLivenessChecker(
                    base, rank, world_size, grace, not_before=not_before
                )
            dead = checker.dead_peer()
            if dead is None:
                continue
            peer, age = dead
            msg = (
                f"rank {peer} presumed dead: liveness lease unrefreshed for "
                f"{age:.1f}s (grace {grace:.1f}s) while waiting on {key}"
            )
            # Flight-recorder evidence: the survivor's verdict on which peer
            # died and how stale its lease was.
            blackbox.record(
                "lease",
                "peer_dead",
                {"peer": peer, "age_s": round(age, 3), "rank": rank, "key": key},
            )
            if on_dead is not None:
                try:
                    on_dead(peer, age, msg)
                except Exception:
                    pass  # best-effort fan-out; the raise below still fires
            raise StorePeerError(msg) from None


class KVStore(abc.ABC):
    @abc.abstractmethod
    def set(self, key: str, value: bytes) -> None:
        ...

    @abc.abstractmethod
    def get(self, key: str, timeout_s: Optional[float] = None) -> bytes:
        """Block until ``key`` exists, then return its value.  ``None``
        timeout resolves through the ``TPUSNAP_BARRIER_TIMEOUT_S`` knob
        (default 1800 s)."""
        ...

    @abc.abstractmethod
    def try_get(self, key: str) -> Optional[bytes]:
        ...

    @abc.abstractmethod
    def add(self, key: str, amount: int) -> int:
        """Atomically add to an integer counter; returns the new value."""
        ...

    def delete_prefix(self, prefix: str) -> int:
        """Best-effort sweep of every key under ``prefix`` (which callers
        terminate with ``/`` so generation ``3`` never matches ``30``).
        Returns the number of keys removed; 0 when the backend can't sweep.
        Keeps coordinator memory bounded across thousands of snapshots —
        upstream torchsnapshot tears its TCPStore down per run, a job-scoped store
        cannot."""
        return 0

    def wait_hint(self, iteration: int) -> None:
        """Polling back-off helper for spin-wait loops."""
        time.sleep(min(0.001 * (2 ** min(iteration, 7)), 0.2))


class FileStore(KVStore):
    """Shared-filesystem KV store.

    set() is atomic via write-to-temp + rename; add() serializes through an
    O_EXCL lock file with stale-lock recovery (a rank dying between lock
    create and unlink must not hang every peer forever — torch's TCPStore
    ``add`` is server-atomic and cannot deadlock this way, so neither may
    the FileStore analogue).  Polling intervals back off to 200 ms.
    """

    # A waiter that has watched the SAME lock instance for this long breaks
    # it.  The critical section is a small-file read + write + rename (ms
    # even on NFS), so anything holding a lock this long is dead or paused;
    # the deadline errs high because breaking a live holder's lock can lose
    # an increment.
    LOCK_STALE_S = 30.0

    def __init__(self, path: str, lock_stale_s: Optional[float] = None) -> None:
        self._root = path
        self._lock_stale_s = (
            lock_stale_s if lock_stale_s is not None else self.LOCK_STALE_S
        )
        os.makedirs(path, exist_ok=True)

    def _key_path(self, key: str) -> str:
        return os.path.join(self._root, key.replace("/", "%2F"))

    def set(self, key: str, value: bytes) -> None:
        target = self._key_path(key)
        fd, tmp = tempfile.mkstemp(dir=self._root, prefix=".tmp.")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(value)
            # KV values are live coordination state, re-derivable by the
            # protocol on restart; atomicity (no torn reads by peers) is
            # what matters, crash-durability is not.
            os.replace(tmp, target)  # tpusnap-lint: disable=durability-flow
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def try_get(self, key: str) -> Optional[bytes]:
        target = self._key_path(key)
        try:
            with open(target, "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def get(self, key: str, timeout_s: Optional[float] = None) -> bytes:
        deadline = time.monotonic() + resolve_wait_timeout_s(timeout_s)
        i = 0
        while True:
            value = self.try_get(key)
            if value is not None:
                return value
            if time.monotonic() > deadline:
                raise TimeoutError(f"Timed out waiting for store key: {key}")
            self.wait_hint(i)
            i += 1

    def add(self, key: str, amount: int) -> int:
        lock = self._key_path(key) + ".lock"
        token = f"{os.getpid()}:{uuid.uuid4().hex}".encode()
        i = 0
        # Stale detection is clock-skew-free: the waiter times how long the
        # SAME lock instance has blocked it on its own monotonic clock,
        # rather than comparing the lock's mtime (NFS server time) against
        # local wall time.  Identity is the holder's token CONTENT, not
        # (inode, mtime): inode numbers recycle and mtime granularity can be
        # a full second on NFS/ext3, so a broken lock's live successor could
        # collide with its predecessor's identity and inherit a nearly
        # expired staleness clock.
        waiting_since: Optional[tuple] = None
        # Acquisition is link(2), not O_EXCL-create-then-write: the token is
        # written to a private temp file first, so the lock appears with its
        # content ATOMICALLY and no reader can ever observe an empty lock —
        # an empty identity would let two waiters' staleness clocks collide
        # across different lock instances.
        fd, tmp = tempfile.mkstemp(dir=self._root, prefix=".locktmp.")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(token)
            while True:
                try:
                    os.link(tmp, lock)
                    break
                except FileExistsError:
                    # NFS caveat: link(2) is not idempotent — the server can
                    # apply the link, lose the reply, and the retransmit
                    # returns EEXIST.  st_nlink == 2 on our temp file means
                    # the link actually landed: we hold the lock.
                    try:
                        if os.stat(tmp).st_nlink == 2:
                            break
                    except OSError:
                        pass
                try:
                    with open(lock, "rb") as f:
                        ident = f.read()
                except OSError:
                    # Lock likely released between link and read — but still
                    # back off: on NFS a cached dentry can keep the link
                    # failing while the read raises ESTALE for the
                    # revalidation window, and skipping the wait would turn
                    # that window into a hot spin against the server.
                    waiting_since = None
                    self.wait_hint(i)
                    i += 1
                    continue
                now = time.monotonic()
                if waiting_since is None or waiting_since[0] != ident:
                    waiting_since = (ident, now)
                elif now - waiting_since[1] > self._lock_stale_s:
                    self._break_stale_lock(lock, ident)
                    waiting_since = None
                    continue
                self.wait_hint(i)
                i += 1
        finally:
            try:
                os.unlink(tmp)
            except OSError:
                pass
        try:
            current = self.try_get(key)
            value = (int(current) if current is not None else 0) + amount
            self.set(key, str(value).encode())
            return value
        finally:
            # Release only if the lock is still OURS: a peer may have broken
            # it as stale (e.g. this process was paused past the deadline)
            # and a new holder created a fresh lock at the same path —
            # unlinking that would hand the lock to two waiters at once.
            try:
                with open(lock, "rb") as f:
                    still_ours = f.read() == token
                if still_ours:
                    os.unlink(lock)
            except OSError:
                pass

    def _break_stale_lock(self, lock: str, ident: bytes) -> None:
        """Break a lock whose holder is presumed dead.  The rename is atomic,
        so of N waiters that all observed the lock as stale exactly one wins
        and the rest fall back to normal acquisition."""
        try:
            with open(lock, "rb") as f:
                if f.read() != ident:
                    return  # a fresh holder re-created it; not stale
        except OSError:
            return  # gone already
        broken = f"{lock}.broken.{uuid.uuid4().hex}"
        try:
            # Lock-file shuffle (atomic steal), not a data commit: the
            # rename IS the operation; there are no bytes to sync.  (The
            # flow-sensitive durability rule proves this itself — no
            # bytes were written in this flow — so no suppression.)
            os.rename(lock, broken)
        except OSError:
            return  # another waiter broke it first
        try:
            with open(broken, "rb") as f:
                grabbed_live = f.read() != ident
            if grabbed_live:
                # The read→rename window let another waiter break the stale
                # lock AND a new holder re-acquire: what we renamed away is
                # that holder's LIVE lock.  Put it back via link (restores
                # the same inode; unlike rename it cannot clobber a third
                # waiter's even-newer lock — if one exists the EEXIST is
                # swallowed and the holder's token-checked release keeps the
                # path safe).
                try:
                    os.link(broken, lock)
                except OSError:
                    pass
            os.unlink(broken)
        except OSError:
            pass

    def delete_prefix(self, prefix: str) -> int:
        encoded = os.path.basename(self._key_path(prefix))
        count = 0
        try:
            names = os.listdir(self._root)
        except OSError:
            return 0
        for name in names:
            if name.startswith(encoded):
                try:
                    os.unlink(os.path.join(self._root, name))
                    count += 1
                except OSError:
                    pass
        return count


class PrefixStore(KVStore):
    """Namespaced view of another store (torch's PrefixStore equivalent)."""

    def __init__(self, prefix: str, store: KVStore) -> None:
        self._prefix = prefix
        self._store = store

    def _k(self, key: str) -> str:
        return f"{self._prefix}/{key}"

    def set(self, key: str, value: bytes) -> None:
        self._store.set(self._k(key), value)

    def get(self, key: str, timeout_s: Optional[float] = None) -> bytes:
        return self._store.get(self._k(key), timeout_s)

    def try_get(self, key: str) -> Optional[bytes]:
        return self._store.try_get(self._k(key))

    def add(self, key: str, amount: int) -> int:
        return self._store.add(self._k(key), amount)

    def delete_prefix(self, prefix: str) -> int:
        return self._store.delete_prefix(self._k(prefix))


def get_or_create_store(rank: int, world_size: int) -> KVStore:
    """The coordination store of a process group, resolved in this order:
    a running TCP store (``TPUSNAP_STORE_ADDR``), a FileStore
    (``TPUSNAP_STORE_PATH``), else the torch.distributed bootstrap: rank 0
    starts a TCP store server on a free port and broadcasts its address
    over the default process group (coordination.py)."""
    addr = knobs.get_store_addr()
    if addr:
        from .tpustore import TCPStore

        host, _, port = addr.rpartition(":")
        return TCPStore(host, int(port))
    path = knobs.get_store_path()
    if path:
        return FileStore(path)
    from .coordination import bootstrap_store

    store = bootstrap_store(rank, world_size)
    if store is not None:
        return store
    raise RuntimeError(
        "No coordination store configured: set TPUSNAP_STORE_ADDR / "
        "TPUSNAP_STORE_PATH or initialize torch.distributed"
    )


class LinearBarrier:
    """Two-phase arrive/depart barrier with leader action in between.

    Safe off the main thread: only store ops, no collectives.  Error
    propagation: any rank may ``report_error``; every peer blocked in
    ``arrive``/``depart`` raises :class:`StorePeerError`.

    Waits are O(1) store ops per rank: the last arriver sets a sentinel key
    and the leader blocks on it server-side (CV-blocking GET on the C++
    store), instead of polling a counter.  ``report_error`` also sets both
    sentinels so blocked peers wake immediately and observe the error.
    """

    def __init__(
        self,
        prefix: str,
        store: KVStore,
        rank: int,
        world_size: int,
        leader_rank: int = 0,
    ) -> None:
        self.prefix = f"linear_barrier/{prefix}"
        self._store = PrefixStore(self.prefix, store)
        # The un-namespaced store: liveness leases (oplease/<rank>) live at
        # the store root so every barrier/collective over one store reads
        # the same per-process lease.
        self._base_store = store
        self._rank = rank
        self._world_size = world_size
        self._leader_rank = leader_rank

    def _check_error(self) -> None:
        err = self._store.try_get("error")
        if err is not None:
            raise StorePeerError(err.decode("utf-8", errors="replace"))

    def _blocking_wait(self, key: str, timeout_s: Optional[float]) -> None:
        # Timed as `barrier_wait` (classified as a wait group in
        # analyze.PHASE_GROUPS): commit-barrier skew used to be invisible
        # wall — the straggler's peers burned it here with no phase record.
        # Liveness-aware: a peer whose op lease expired mid-wait is
        # presumed dead, reported through report_error (so EVERY waiter
        # wakes with the same symmetric StorePeerError), and surfaced here
        # in ~grace seconds instead of the full barrier timeout.
        begin = time.monotonic()
        try:
            wait_with_liveness(
                self._store,
                key,
                timeout_s,
                rank=self._rank,
                world_size=self._world_size,
                lease_store=self._base_store,
                on_dead=lambda peer, age, msg: self.report_error(msg),
            )
        except TimeoutError:
            self._check_error()
            raise TimeoutError(f"LinearBarrier timed out waiting on {key}")
        finally:
            phase_stats.add("barrier_wait", time.monotonic() - begin)
        self._check_error()

    def _stamp(self, phase: str) -> None:
        """Best-effort wall-clock stamp of this rank reaching ``phase`` —
        the raw input for analyze's cross-rank barrier-blame table.  Epoch
        time on purpose: the stamps are compared ACROSS ranks (clock skew
        is noise well below the multi-second skews worth blaming)."""
        try:
            self._store.set(f"ts_{phase}/{self._rank}", repr(time.time()).encode())
        except Exception:
            pass  # telemetry, never load-bearing for the barrier protocol

    def arrive(self, timeout_s: Optional[float] = None) -> None:
        self._stamp("arrive")
        if self._store.add("arrived", 1) >= self._world_size:
            self._store.set("all_arrived", b"1")
        if self._rank == self._leader_rank:
            self._blocking_wait("all_arrived", timeout_s)

    def depart(self, timeout_s: Optional[float] = None) -> None:
        if self._rank == self._leader_rank:
            self._store.set("departed", b"1")
        else:
            self._blocking_wait("departed", timeout_s)
        self._stamp("depart")
        # Per-rank completion mark: the barrier's keys may only be swept once
        # this counter reaches world_size — a peer's completion thread can
        # still be parked on `departed` long after the leader moved on.
        self._store.add("done", 1)

    def arrival_table(self) -> Dict[int, Dict[str, float]]:
        """Every rank's arrive/depart wall-clock stamps, read non-blocking
        after the barrier completed (post-``arrive`` every rank's arrive
        stamp is provably present; depart stamps are best-effort).  Keys
        live under the barrier's own prefix, so the normal retire sweep
        reclaims them with the rest."""
        table: Dict[int, Dict[str, float]] = {}
        for rank in range(self._world_size):
            row: Dict[str, float] = {}
            for phase in ("arrive", "depart"):
                raw = self._store.try_get(f"ts_{phase}/{rank}")
                if raw is None:
                    continue
                try:
                    row[phase] = float(raw)
                except ValueError:
                    continue
            if row:
                table[rank] = row
        return table

    def done_guard(self) -> tuple:
        """(key, target) telling a sweeper when this barrier's keys are dead."""
        return f"{self.prefix}/done", self._world_size

    def report_error(self, message: str) -> None:
        self._store.set("error", message.encode())
        # Wake any peer blocked on a sentinel; they re-check the error key.
        self._store.set("all_arrived", b"error")
        self._store.set("departed", b"error")
