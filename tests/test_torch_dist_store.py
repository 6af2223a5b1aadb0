"""Coordination layer of torchsnapshot_tpu_torch: object collectives, the
barriers, the key sweep, the FileStore lock, and the liveness leases.

Mirrors of tests/test_distributed.py (collectives through the FileStore
lock cases) and of tests/test_kill_chaos.py's lease checks, run against the
port's ``pg_wrapper``/``dist_store``.  Both packages' stores share their
key encoding, so the mixed-package cases run one collective with a rank of
each package: the port is held to the JAX package's protocol, key for key.
Multi-process bodies run in forkserver children (test_utils.run_with_procs)
and touch no JAX.
"""

import os
import threading
import time

import pytest

from torchsnapshot_tpu_torch import knobs
from torchsnapshot_tpu_torch.test_utils import make_test_pg, run_with_procs

from torch_env import default_knob_env  # noqa: F401  autouse fixture


@run_with_procs(nproc=4)
def _collectives_body():
    pg = make_test_pg()
    rank, ws = pg.get_rank(), pg.get_world_size()
    assert ws == 4

    gathered = pg.all_gather_object({"rank": rank, "data": rank * 10})
    assert [g["rank"] for g in gathered] == [0, 1, 2, 3]
    assert gathered[2]["data"] == 20

    objs = [None]
    if rank == 0:
        objs = [{"cfg": 42}]
    pg.broadcast_object_list(objs, src=0)
    assert objs[0] == {"cfg": 42}

    out = [None]
    pg.scatter_object_list(out, [f"item{r}" for r in range(ws)] if rank == 0 else None, src=0)
    assert out[0] == f"item{rank}"

    gathered_root = pg.gather_object_root({"r": rank})
    if rank == 0:
        assert [g["r"] for g in gathered_root] == [0, 1, 2, 3]
    else:
        assert gathered_root is None

    union = pg.all_reduce_object(
        {f"key{rank}", "shared"},
        lambda per_rank: sorted(set().union(*per_rank)),
    )
    assert union == ["key0", "key1", "key2", "key3", "shared"]

    gathered_r2 = pg.gather_object_root(rank * 100, root=2)
    if rank == 2:
        assert gathered_r2 == [0, 100, 200, 300]
    else:
        assert gathered_r2 is None
    pg.barrier()


def test_pg_collectives():
    _collectives_body()


@run_with_procs(nproc=2)
def _linear_barrier_body():
    from torchsnapshot_tpu_torch.dist_store import LinearBarrier

    pg = make_test_pg()
    barrier = LinearBarrier(prefix="t1", store=pg.store, rank=pg.get_rank(), world_size=2)
    barrier.arrive(timeout_s=30)
    barrier.depart(timeout_s=30)


def test_linear_barrier():
    _linear_barrier_body()


@run_with_procs(nproc=2)
def _linear_barrier_error_body():
    from torchsnapshot_tpu_torch.dist_store import LinearBarrier, StorePeerError

    pg = make_test_pg()
    barrier = LinearBarrier(prefix="t2", store=pg.store, rank=pg.get_rank(), world_size=2)
    if pg.get_rank() == 1:
        barrier.report_error("rank1 exploded")
        return
    try:
        barrier.arrive(timeout_s=30)
        raise AssertionError("leader should have seen the peer error")
    except StorePeerError as e:
        assert "rank1 exploded" in str(e)


def test_linear_barrier_error_propagation():
    _linear_barrier_error_body()


class _CountingStore:
    """KVStore wrapper counting API-level ops (not backend-internal polls)."""

    def __init__(self, inner):
        self._inner = inner
        self.ops = 0

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if name in ("set", "get", "try_get", "add", "delete_prefix"):

            def counted(*args, **kwargs):
                self.ops += 1
                return attr(*args, **kwargs)

            return counted
        return attr


def _run_threads(fns):
    threads = [threading.Thread(target=fn) for fn in fns]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)


def test_barrier_is_o1_store_ops(tmp_path):
    """A barrier costs O(1) store ops per rank: counter arrive, one
    blocking sentinel GET, the last arriver's set, rank 0's sweep."""
    from torchsnapshot_tpu_torch.dist_store import FileStore
    from torchsnapshot_tpu_torch.pg_wrapper import PGWrapper

    base = FileStore(str(tmp_path))
    stores = [_CountingStore(base) for _ in range(2)]
    pgs = [PGWrapper(store=stores[r], rank=r, world_size=2, timeout_s=30) for r in range(2)]
    _run_threads([pg.barrier for pg in pgs])
    for r, s in enumerate(stores):
        assert s.ops <= 4, f"rank {r} used {s.ops} store ops for one barrier"


def test_barrier_timeout(tmp_path):
    """A peer that never arrives surfaces as TimeoutError, not a hang."""
    from torchsnapshot_tpu_torch.dist_store import FileStore
    from torchsnapshot_tpu_torch.pg_wrapper import PGWrapper

    pg = PGWrapper(store=FileStore(str(tmp_path)), rank=0, world_size=2, timeout_s=0.5)
    with pytest.raises(TimeoutError):
        pg.barrier()


def test_collective_keys_swept_after_barrier(tmp_path):
    """Keys of completed collectives are deleted once a later barrier proves
    every rank moved past them."""
    from torchsnapshot_tpu_torch.dist_store import FileStore
    from torchsnapshot_tpu_torch.pg_wrapper import PGWrapper

    base = FileStore(str(tmp_path))
    pgs = [PGWrapper(store=base, rank=r, world_size=2, timeout_s=30) for r in range(2)]

    def _workload(r):
        pg = pgs[r]
        for _ in range(5):
            pg.all_gather_object({"rank": r, "blob": "x" * 1000})
            objs = [{"cfg": 1}] if r == 0 else [None]
            pg.broadcast_object_list(objs, src=0)
        pg.barrier()
        pg.barrier()

    _run_threads([lambda r=r: _workload(r) for r in range(2)])
    remaining = [n for n in os.listdir(str(tmp_path)) if not n.startswith(".")]
    assert len(remaining) <= 2, f"stale store keys not swept: {remaining}"


def test_retired_prefix_swept_only_after_guard(tmp_path):
    """A retired namespace (an async commit's LinearBarrier) is swept at a
    barrier only once its guard counter reached the target."""
    from torchsnapshot_tpu_torch.dist_store import FileStore
    from torchsnapshot_tpu_torch.pg_wrapper import PGWrapper

    base = FileStore(str(tmp_path))
    base.set("linear_barrier/x/k", b"1")
    pgs = [PGWrapper(store=base, rank=r, world_size=2, timeout_s=30) for r in range(2)]
    for pg in pgs:
        pg.retire_prefix("linear_barrier/x", guard_key="linear_barrier/x/done", guard_target=2)
    _run_threads([pg.barrier for pg in pgs])
    assert base.try_get("linear_barrier/x/k") == b"1"  # guard not met
    base.add("linear_barrier/x/done", 2)
    _run_threads([pg.barrier for pg in pgs])
    assert base.try_get("linear_barrier/x/k") is None


def test_linear_barrier_error_wakes_blocked_leader(tmp_path):
    from torchsnapshot_tpu_torch.dist_store import FileStore, LinearBarrier, StorePeerError

    store = FileStore(str(tmp_path))
    b0 = LinearBarrier(prefix="t", store=store, rank=0, world_size=2)
    b1 = LinearBarrier(prefix="t", store=store, rank=1, world_size=2)
    result = {}

    def _leader():
        try:
            b0.arrive(timeout_s=30)
        except StorePeerError as e:
            result["err"] = str(e)

    t = threading.Thread(target=_leader)
    t.start()
    time.sleep(0.2)  # the leader is parked waiting for all_arrived
    b1.report_error("peer died mid-flight")
    t.join(timeout=10)
    assert "peer died mid-flight" in result.get("err", "")


@pytest.mark.parametrize("jax_rank", [0, 1], ids=["jax_leader", "port_leader"])
def test_mixed_package_collectives_share_one_filestore(tmp_path, jax_rank):
    """One rank of each package, one FileStore: barrier, gather, broadcast,
    all-reduce and the LinearBarrier interoperate, so the port speaks the
    JAX package's key protocol exactly."""
    from torchsnapshot_tpu import dist_store as jds
    from torchsnapshot_tpu.pg_wrapper import PGWrapper as JaxPG
    from torchsnapshot_tpu_torch import dist_store as tds
    from torchsnapshot_tpu_torch.pg_wrapper import PGWrapper as TorchPG

    results = {}

    def _rank(r):
        jax_side = r == jax_rank
        ds = jds if jax_side else tds
        store = ds.FileStore(str(tmp_path))
        pg = (JaxPG if jax_side else TorchPG)(store=store, rank=r, world_size=2, timeout_s=30)
        pg.barrier()
        gathered = pg.gather_object_root({"r": r, "pkg": "jax" if jax_side else "torch"})
        objs = [gathered] if r == 0 else [None]
        pg.broadcast_object_list(objs, src=0)
        total = pg.all_reduce_object(r + 1, sum)
        barrier = ds.LinearBarrier(prefix="mixed", store=store, rank=r, world_size=2)
        barrier.arrive(timeout_s=30)
        barrier.depart(timeout_s=30)
        pg.barrier()
        results[r] = (objs[0], total)

    _run_threads([lambda r=r: _rank(r) for r in range(2)])
    expected = [{"r": r, "pkg": "jax" if r == jax_rank else "torch"} for r in range(2)]
    assert results == {0: (expected, 3), 1: (expected, 3)}


def test_filestore_add_recovers_from_crashed_lock_holder(tmp_path):
    """A holder dying between the add() lock's create and unlink must not
    hang its peers: a waiter past the staleness deadline breaks the lock."""
    from torchsnapshot_tpu_torch.dist_store import FileStore

    store = FileStore(str(tmp_path), lock_stale_s=1.0)
    assert store.add("counter", 1) == 1
    # The lock exactly as a holder that died before releasing leaves it.
    lock = store._key_path("counter") + ".lock"
    fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    os.write(fd, b"crashed-rank-token")
    os.close(fd)

    begin = time.monotonic()
    assert store.add("counter", 1) == 2  # breaks the stale lock
    elapsed = time.monotonic() - begin
    assert 1.0 <= elapsed < 10.0, f"recovered in {elapsed:.2f}s"
    begin = time.monotonic()
    assert store.add("counter", 1) == 3
    assert time.monotonic() - begin < 1.0


def test_filestore_add_does_not_break_live_lock(tmp_path):
    """Lock instances are tracked by identity: a waiter breaks only a lock
    it watched unchanged past the deadline, so no increment is lost."""
    from torchsnapshot_tpu_torch.dist_store import FileStore

    store = FileStore(str(tmp_path), lock_stale_s=1.5)

    def hammer():
        for _ in range(8):
            store.add("c", 1)
            time.sleep(0.05)

    begin = time.monotonic()
    _run_threads([hammer] * 3)
    assert time.monotonic() - begin < 15.0
    assert store.add("c", 0) == 24


def test_store_resolution_order(tmp_path, monkeypatch):
    """TPUSNAP_STORE_ADDR wins over TPUSNAP_STORE_PATH; without either and
    without torch.distributed there is no store to find."""
    from torchsnapshot_tpu_torch.dist_store import FileStore, get_or_create_store
    from torchsnapshot_tpu_torch.tpustore import TCPStore, TCPStoreServer

    monkeypatch.delenv(knobs.STORE_ADDR_ENV_VAR, raising=False)
    monkeypatch.delenv(knobs.STORE_PATH_ENV_VAR, raising=False)
    with pytest.raises(RuntimeError, match="No coordination store"):
        get_or_create_store(0, 2)
    monkeypatch.setenv(knobs.STORE_PATH_ENV_VAR, str(tmp_path))
    assert isinstance(get_or_create_store(0, 2), FileStore)
    server = TCPStoreServer()
    try:
        monkeypatch.setenv(knobs.STORE_ADDR_ENV_VAR, f"127.0.0.1:{server.port}")
        store = get_or_create_store(0, 2)
        assert isinstance(store, TCPStore)
        store.close()
    finally:
        server.stop()


def test_from_torch_without_distributed_is_a_world_of_one(monkeypatch):
    from torchsnapshot_tpu_torch.pg_wrapper import PGWrapper

    monkeypatch.delenv(knobs.RANK_ENV_VAR, raising=False)
    monkeypatch.delenv(knobs.WORLD_SIZE_ENV_VAR, raising=False)
    pg = PGWrapper.from_torch()
    assert (pg.get_rank(), pg.get_world_size(), pg.store) == (0, 1, None)
    assert pg.all_reduce_object(3, sum) == 3


@run_with_procs(nproc=2, gloo=True)
def _from_torch_bootstrap_body():
    """Without a store in the environment, from_torch bootstraps the TCP
    store over the gloo group; the wrapper is cached per default group, and
    a group made again gets a new wrapper with a fresh key namespace."""
    import torch.distributed as dist

    from torchsnapshot_tpu_torch.pg_wrapper import PGWrapper
    from torchsnapshot_tpu_torch.tpustore import TCPStore

    with knobs.override_env(knobs.STORE_PATH_ENV_VAR, None):
        pg = PGWrapper.from_torch()
    assert isinstance(pg.store, TCPStore)
    assert (pg.get_rank(), pg.get_world_size()) == (dist.get_rank(), 2)
    assert PGWrapper.from_torch() is pg
    assert pg.all_reduce_object(pg.get_rank() + 1, sum) == 3
    pg.barrier()
    init = dist.distributed_c10d._default_pg_init_method
    dist.destroy_process_group()
    dist.init_process_group("gloo", init_method=init + "_again", rank=pg.get_rank(), world_size=2)
    again = PGWrapper.from_torch()
    assert again is not pg and again._prefix != pg._prefix
    assert again.all_gather_object(again.get_rank()) == [0, 1]
    again.barrier()


def test_from_torch_bootstraps_tcp_store_over_gloo():
    _from_torch_bootstrap_body()


# ------------------------------------------------------------ liveness leases


def test_dead_peer_lease_aborts_barrier_fast(tmp_path):
    """A peer whose lease stops refreshing (the kill -9 signature) surfaces
    as a fast StorePeerError on the waiter and, through report_error, on
    every other participant."""
    from torchsnapshot_tpu_torch.dist_store import (
        OP_LEASE_PREFIX,
        FileStore,
        LinearBarrier,
        StorePeerError,
    )

    store = FileStore(str(tmp_path))
    store.set(f"{OP_LEASE_PREFIX}/1", repr(time.time()).encode())
    b0 = LinearBarrier(prefix="t", store=store, rank=0, world_size=2)
    with knobs.override_lease_interval_s(0.1), knobs.override_lease_grace_s(0.5):
        begin = time.monotonic()
        with pytest.raises(StorePeerError, match="presumed dead"):
            b0.arrive(timeout_s=60)
        assert time.monotonic() - begin < 10.0
        b1 = LinearBarrier(prefix="t", store=store, rank=1, world_size=2)
        with pytest.raises(StorePeerError, match="presumed dead"):
            b1.depart(timeout_s=5)


def test_missing_lease_still_times_out(tmp_path):
    """No lease is no information: a peer that never established one
    surfaces as the plain TimeoutError."""
    from torchsnapshot_tpu_torch.dist_store import FileStore
    from torchsnapshot_tpu_torch.pg_wrapper import PGWrapper

    pg = PGWrapper(store=FileStore(str(tmp_path)), rank=0, world_size=2, timeout_s=1.0)
    with knobs.override_lease_interval_s(0.1), knobs.override_lease_grace_s(0.2):
        with pytest.raises(TimeoutError):
            pg.barrier()


def test_fresh_lease_keeps_barrier_waiting(tmp_path):
    from torchsnapshot_tpu_torch.dist_store import OP_LEASE_PREFIX, FileStore
    from torchsnapshot_tpu_torch.pg_wrapper import PGWrapper

    store = FileStore(str(tmp_path))
    store.set(f"{OP_LEASE_PREFIX}/1", repr(time.time()).encode())
    pg = PGWrapper(store=store, rank=0, world_size=2, timeout_s=1.5)
    with knobs.override_lease_grace_s(10.0):
        begin = time.monotonic()
        with pytest.raises(TimeoutError):
            pg.barrier()
        assert time.monotonic() - begin >= 1.4


def test_previous_incarnation_debris_does_not_abort(tmp_path):
    """A stamp older than the waiter's own op start is a previous
    incarnation's debris, not a dead peer."""
    from torchsnapshot_tpu_torch import dist_store as ds
    from torchsnapshot_tpu_torch.pg_wrapper import PGWrapper

    store = ds.FileStore(str(tmp_path))
    store.set(f"{ds.OP_LEASE_PREFIX}/1", repr(time.time() - 300.0).encode())
    with knobs.override_lease_grace_s(0.5), knobs.override_lease_interval_s(0.1):
        lease = ds.acquire_op_lease(store, rank=0)
        try:
            pg = PGWrapper(store=store, rank=0, world_size=2, timeout_s=1.5)
            begin = time.monotonic()
            with pytest.raises(TimeoutError):
                pg.barrier()
            assert time.monotonic() - begin >= 1.4
        finally:
            ds.release_op_lease(lease)


def test_release_tombstone_yields_to_successor_lease(tmp_path):
    from torchsnapshot_tpu_torch import dist_store as ds

    store = ds.FileStore(str(tmp_path))
    with knobs.override_lease_interval_s(0.05), knobs.override_lease_grace_s(5.0):
        old = ds.acquire_op_lease(store, rank=2)
        ds.release_op_lease(old)
        assert store.try_get("oplease/2") == b"done"

        old = ds.acquire_op_lease(store, rank=2)
        ds._OP_LEASES.pop(id(store), None)
        new = ds.acquire_op_lease(store, rank=2)
        assert new is not old
        ds.release_op_lease(old)
        raw = store.try_get("oplease/2")
        assert raw != b"done"
        assert float(raw) > 0
        ds.release_op_lease(new)
        assert store.try_get("oplease/2") == b"done"


def test_op_lease_lifecycle(tmp_path):
    from torchsnapshot_tpu_torch import dist_store as ds

    store = ds.FileStore(str(tmp_path))
    with knobs.override_lease_interval_s(0.05), knobs.override_lease_grace_s(5.0):
        lease = ds.acquire_op_lease(store, rank=3)
        assert lease is not None
        again = ds.acquire_op_lease(store, rank=3)
        assert again is lease
        stamp1 = float(store.try_get("oplease/3"))
        time.sleep(0.15)
        stamp2 = float(store.try_get("oplease/3"))
        assert stamp2 > stamp1
        ds.release_op_lease(again)
        time.sleep(0.15)
        assert float(store.try_get("oplease/3")) > stamp2
        ds.release_op_lease(lease)
        assert store.try_get("oplease/3") == b"done"

    with knobs.override_lease_grace_s(0):
        assert ds.acquire_op_lease(store, rank=0) is None


def test_lease_grace_clamped_above_interval():
    with knobs.override_lease_interval_s(2.0), knobs.override_lease_grace_s(1.0):
        assert knobs.get_lease_grace_s() == 4.0
    with knobs.override_lease_interval_s(0.1), knobs.override_lease_grace_s(1.0):
        assert knobs.get_lease_grace_s() == 1.0
    with knobs.override_lease_grace_s(0):
        assert knobs.get_lease_grace_s() == 0.0


def test_lease_knobs_match_the_jax_package():
    """Same variable names and defaults as torchsnapshot_tpu/knobs.py."""
    from torchsnapshot_tpu import knobs as jknobs

    for name in (
        "STORE_ADDR_ENV_VAR",
        "STORE_PATH_ENV_VAR",
        "RANK_ENV_VAR",
        "WORLD_SIZE_ENV_VAR",
        "LEASE_INTERVAL_S_ENV_VAR",
        "LEASE_GRACE_S_ENV_VAR",
        "BARRIER_TIMEOUT_S_ENV_VAR",
        "MAX_SHARD_SIZE_ENV_VAR",
        "FAULTS_ENV_VAR",
    ):
        assert getattr(knobs, name) == getattr(jknobs, name)
    assert knobs.get_lease_grace_s() == jknobs.get_lease_grace_s()
    assert knobs.get_lease_interval_s() == jknobs.get_lease_interval_s()
    assert knobs.get_barrier_timeout_s() == jknobs.get_barrier_timeout_s()
    assert knobs.get_max_shard_size_bytes() == jknobs.get_max_shard_size_bytes()


def test_process_epoch_floor_for_leaseless_waiters(tmp_path):
    from torchsnapshot_tpu_torch import dist_store as ds
    from torchsnapshot_tpu_torch.pg_wrapper import PGWrapper

    store = ds.FileStore(str(tmp_path))
    store.set(f"{ds.OP_LEASE_PREFIX}/1", repr(ds._PROCESS_EPOCH - 600.0).encode())
    pg = PGWrapper(store=store, rank=0, world_size=2, timeout_s=1.0)
    with knobs.override_lease_interval_s(0.05), knobs.override_lease_grace_s(0.2):
        with pytest.raises(TimeoutError):
            pg.barrier()
