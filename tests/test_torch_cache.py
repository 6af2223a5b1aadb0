"""The port's shared host chunk cache at the store and plugin level.

Mirrors the store-level cases of ``tests/test_serve.py`` against
``torchsnapshot_tpu_torch.cache``: single-flight populates, a corrupt entry
re-fetched, the LRU bound with open-fd safety, the whole-entry check of the
first ranged slice, the stale-tmp sweep, ranged reads served from a warmed
whole entry, the fingerprint namespace; plus ``residency``, an unusable
cache directory, the held-fd read after an eviction's unlink, hits read
into the caller's buffer, and the cache's events and phases.  Origin
traffic is metered by the fault wrapper (``TPUSNAP_FAULTS=none``)."""

import glob
import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch

import torchsnapshot_tpu_torch as ts
from torchsnapshot_tpu_torch import cache as cache_mod
from torchsnapshot_tpu_torch import cas, event_handlers, faults, knobs, phase_stats
from torchsnapshot_tpu_torch.io_types import ReadIO, StoragePlugin
from torchsnapshot_tpu_torch.storage_plugin import url_to_storage_plugin
from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin

from torch_env import default_knob_env, no_leaked_threads  # noqa: F401  fixtures

pytestmark = pytest.mark.usefixtures("no_leaked_threads")


def _payload_read_bytes() -> int:
    """Origin bytes requested for payloads (metadata and sidecars left out)."""
    return sum(
        nbytes
        for path, nbytes in faults.read_counters().items()
        if not path.rsplit("/", 1)[-1].startswith(".") and not path.startswith("telemetry/")
    )


def _arrays(nbytes_per_leaf=1 << 20, leaves=4, seed=0):
    return {
        f"w{i}": np.frombuffer(np.random.RandomState(seed * 100 + i).bytes(nbytes_per_leaf), np.uint8).copy()
        for i in range(leaves)
    }


def _state(arrays):
    return {"m": ts.StateDict({k: torch.from_numpy(v.copy()) for k, v in arrays.items()})}


def _zeros(arrays):
    return {"m": ts.StateDict({k: torch.zeros(v.shape, dtype=torch.uint8) for k, v in arrays.items()})}


def _assert_equal(dst, arrays):
    for k, v in arrays.items():
        assert dst["m"][k].numpy().tobytes() == v.tobytes(), k


def _cache_data_files(cache_dir):
    return [
        p
        for p in glob.glob(os.path.join(cache_dir, "objects", "**", "*"), recursive=True)
        if os.path.isfile(p) and not p.endswith((".meta", ".lock")) and ".tmp." not in p
    ]


class _CountingPlugin(StoragePlugin):
    """Origin meter for in-process single-flight tests."""

    def __init__(self, inner):
        self._inner = inner
        self.reads = 0
        self._lock = threading.Lock()

    async def read(self, read_io):
        with self._lock:
            self.reads += 1
        await self._inner.read(read_io)

    async def write(self, write_io):
        await self._inner.write(write_io)

    async def exists(self, path):
        return await self._inner.exists(path)

    async def list_dir(self, path):
        return await self._inner.list_dir(path)

    async def delete(self, path):
        await self._inner.delete(path)

    async def delete_dir(self, path):
        await self._inner.delete_dir(path)

    async def close(self):
        await self._inner.close()


def _origin_with(tmp_path, payload, name="chunk"):
    origin_dir = tmp_path / "origin"
    os.makedirs(origin_dir, exist_ok=True)
    with open(origin_dir / name, "wb") as f:
        f.write(payload)
    return _CountingPlugin(FSStoragePlugin(root=str(origin_dir)))


def test_concurrent_populate_single_flight_and_untorn(tmp_path):
    """8 threads cold-read one key at once: the per-key populate lock lets
    one fetch reach origin, and every caller gets the same whole bytes."""
    payload = np.random.RandomState(3).bytes(1 << 20)
    counting = _origin_with(tmp_path, payload)
    store = cache_mod.CacheStore(str(tmp_path / "cache"))
    plugin = cache_mod.CacheReaderPlugin(inner=counting, store=store, namespace="t")
    results = [None] * 8
    errors = []

    def _reader(i):
        try:
            read_io = ReadIO(path="chunk")
            plugin.sync_read(read_io)
            results[i] = bytes(read_io.buf)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=_reader, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    plugin.sync_close()
    assert not errors
    assert all(r == payload for r in results)
    assert counting.reads == 1, counting.reads


def test_corrupt_cache_entry_detected_and_refetched(tmp_path):
    arrays = _arrays(leaves=1)
    snap = ts.Snapshot.take(str(tmp_path / "root" / "step_1"), _state(arrays))
    cache_dir = str(tmp_path / "cache")
    with knobs.override_cache_dir(cache_dir), knobs.override_faults("none"):
        snap.restore(_zeros(arrays))
        files = _cache_data_files(cache_dir)
        assert files
        # Same size: a short file would be caught by the cheaper size check.
        for path in files:
            with open(path, "r+b") as f:
                f.seek(8)
                f.write(b"\xde\xad\xbe\xef")
        faults.reset_read_counters()
        dst = _zeros(arrays)
        snap.restore(dst)
        refetched = _payload_read_bytes()
    _assert_equal(dst, arrays)
    assert refetched == arrays["w0"].nbytes


def test_eviction_lru_bound_and_open_fd_semantics(tmp_path):
    store = cache_mod.CacheStore(str(tmp_path / "cache"), max_bytes=3 << 20)
    payloads = {f"k{i}": np.random.RandomState(i).bytes(1 << 20) for i in range(3)}
    now = time.time()
    for i, (key, data) in enumerate(payloads.items()):
        assert store.put(key, data)
        # A fixed LRU order whatever the file system's timestamp grain.
        data_path, _ = store._paths(key)
        os.utime(data_path, (now - 100 + i, now - 100 + i))
    assert store.get("k0") is not None  # k1 becomes the victim
    victim_path, _ = store._paths("k1")
    fd = os.open(victim_path, os.O_RDONLY)
    try:
        assert store.put("k3", np.random.RandomState(9).bytes(1 << 20))
        store.maybe_evict()
        assert store.stats()["bytes"] <= 3 << 20
        assert store.resident_nbytes("k1") is None
        assert store.resident_nbytes("k0") is not None
        held = b""
        while True:
            chunk = os.read(fd, 1 << 16)
            if not chunk:
                break
            held += chunk
        assert held == payloads["k1"]  # evicted mid-read, still whole
    finally:
        os.close(fd)
    assert cache_mod.process_stats()["evictions"] >= 1


def test_ranged_slice_verifies_whole_entry_once(tmp_path):
    """The first ranged slice of an entry checks the WHOLE entry against
    its digest, so damage outside the slice is still found."""
    store = cache_mod.CacheStore(str(tmp_path / "cache"))
    data = np.random.RandomState(1).bytes(1 << 20)
    assert store.put("k", data)
    assert bytes(store.get("k", byte_range=[0, 4096])) == data[:4096]
    data_path, _ = store._paths("k")
    with open(data_path, "r+b") as f:
        f.seek(1 << 19)
        f.write(b"\x00\x11\x22\x33")
    # This process verified the entry already, so its slices fast-path.
    assert bytes(store.get("k", byte_range=[0, 4096])) == data[:4096]
    fresh = cache_mod.CacheStore(str(tmp_path / "cache"))  # another process's view
    assert fresh.get("k", byte_range=[0, 4096]) is None
    assert fresh.resident_nbytes("k") is None


def test_stale_tmp_debris_swept(tmp_path):
    store = cache_mod.CacheStore(str(tmp_path / "cache"), max_bytes=0)
    assert store.put("k", b"x" * 1024)
    data_path, _ = store._paths("k")
    stale = f"{data_path}.tmp.999.1"
    with open(stale, "wb") as f:
        f.write(b"y" * (1 << 16))
    old = time.time() - 7200
    os.utime(stale, (old, old))
    fresh = f"{data_path}.tmp.999.2"
    with open(fresh, "wb") as f:
        f.write(b"z")
    store.maybe_evict()
    assert not os.path.exists(stale)
    assert os.path.exists(fresh)  # a live populate's tmp stays
    assert store.get("k") is not None


def test_ranged_read_served_from_warmed_full_entry(tmp_path):
    """``warm_snapshot`` caches whole objects; a later restore's ranged
    slab reads slice them and never reach origin."""
    arrays = _arrays(nbytes_per_leaf=1 << 18, leaves=4)
    path = str(tmp_path / "root" / "step_1")
    snap = ts.Snapshot.take(path, _state(arrays))
    assert any(e.location.startswith("batched/") for e in snap.get_manifest().values() if hasattr(e, "location"))
    cache_dir = str(tmp_path / "cache")
    with knobs.override_cache_dir(cache_dir), knobs.override_faults("none"):
        md = snap.metadata
        storage = cache_mod.maybe_wrap_cache_reads(cas.maybe_wrap_cas_reads(url_to_storage_plugin(path), path, md), md)
        try:
            warmed = cache_mod.warm_snapshot(storage, md)
        finally:
            storage.sync_close()
        assert warmed["misses"] == warmed["locations"] and warmed["hits"] == 0
        faults.reset_read_counters()
        dst = _zeros(arrays)
        # A restore of one slab member asks for its byte range.
        snap.read_object("0/m/w3", obj_out=dst["m"]["w3"])
        assert _payload_read_bytes() == 0
    assert dst["m"]["w3"].numpy().tobytes() == arrays["w3"].tobytes()


def test_cache_namespace_prevents_stale_bytes(tmp_path):
    """A step pruned and re-saved at the same path with other content is
    not served the old step's bytes (the fingerprint namespaces them)."""
    path = str(tmp_path / "root" / "step_1")
    old = _arrays(leaves=1, seed=1)
    new = _arrays(leaves=1, seed=2)
    with knobs.override_cache_dir(str(tmp_path / "cache")):
        ts.Snapshot.take(path, _state(old)).restore(_zeros(old))
        shutil.rmtree(path)
        snap = ts.Snapshot.take(path, _state(new))
        dst = _zeros(new)
        snap.restore(dst)
    _assert_equal(dst, new)


def test_residency_counts_whole_entries(tmp_path):
    arrays = _arrays(nbytes_per_leaf=1 << 16, leaves=3)
    path = str(tmp_path / "root" / "step_1")
    with knobs.override_slab_size_threshold_bytes(64):  # one payload per leaf
        snap = ts.Snapshot.take(path, _state(arrays))
    md = snap.metadata
    ns = cache_mod.snapshot_fingerprint(md)
    store = cache_mod.CacheStore(str(tmp_path / "cache"))
    items = cache_mod.payload_locations(md)
    assert [n for _, n in items] == [1 << 16] * 3
    assert cache_mod.residency(store, md, ns) == {
        "locations": 3,
        "resident": 0,
        "bytes_total": 3 << 16,
        "bytes_resident": 0,
    }
    location = items[0][0]
    with open(os.path.join(path, location), "rb") as f:
        assert store.put(cache_mod.full_key_for(ns, location)[0], f.read())
    # A range-keyed entry is not whole-object residency.
    assert store.put(cache_mod.keys_for(ns, items[1][0], [0, 16])[0], b"x" * 16)
    got = cache_mod.residency(store, md, ns)
    assert (got["resident"], got["bytes_resident"]) == (1, 1 << 16)


def test_unusable_cache_dir_warns_and_reads_origin(tmp_path, caplog):
    arrays = _arrays(nbytes_per_leaf=1 << 16, leaves=1)
    snap = ts.Snapshot.take(str(tmp_path / "root" / "step_1"), _state(arrays))
    blocker = tmp_path / "not_a_dir"
    blocker.write_bytes(b"x")
    with knobs.override_cache_dir(str(blocker)), knobs.override_faults("none"):
        faults.reset_read_counters()
        dst = _zeros(arrays)
        with caplog.at_level("WARNING", logger="torchsnapshot_tpu_torch.cache"):
            snap.restore(dst)
        assert _payload_read_bytes() == arrays["w0"].nbytes
    assert "chunk cache disabled" in caplog.text
    _assert_equal(dst, arrays)


def test_hit_after_unlink_reads_through_held_fd(tmp_path, monkeypatch):
    """An eviction that unlinks an entry between the reader's open and
    its read: the native read by name fails, the held fd serves the bytes."""
    store = cache_mod.CacheStore(str(tmp_path / "cache"))
    data = np.random.RandomState(4).bytes(1 << 16)
    assert store.put("k", data)
    real_read_into = store._read_into

    def _evict_then_read(fd, data_path, start, dest):
        os.unlink(data_path)
        return real_read_into(fd, data_path, start, dest)

    monkeypatch.setattr(store, "_read_into", _evict_then_read)
    assert bytes(store.get("k")) == data


def test_hit_lands_in_the_callers_buffer(tmp_path):
    """A hit fills ``ReadIO.into`` in place (the restore's pinned buffer
    needs no copy) and clears ``hash64`` so the consumer verifies."""
    payload = np.random.RandomState(5).bytes(1 << 18)
    counting = _origin_with(tmp_path, payload)
    plugin = cache_mod.CacheReaderPlugin(
        inner=counting, store=cache_mod.CacheStore(str(tmp_path / "cache")), namespace="t"
    )
    try:
        plugin.sync_read(ReadIO(path="chunk"))
        into = memoryview(np.zeros(1 << 18, np.uint8))
        read_io = ReadIO(path="chunk", into=into, want_hash=True, hash_algo="xxh64", hash64=123)
        plugin.sync_read(read_io)
    finally:
        plugin.sync_close()
    assert read_io.buf is into and read_io.hash64 is None
    assert bytes(into) == payload and counting.reads == 1
    assert plugin.stats() == {"hits": 1, "misses": 1, "hit_bytes": 1 << 18, "miss_bytes": 1 << 18}


def test_events_and_phases(tmp_path):
    arrays = _arrays(nbytes_per_leaf=1 << 16, leaves=2)
    snap = ts.Snapshot.take(str(tmp_path / "root" / "step_1"), _state(arrays))
    events = []
    event_handlers.register_event_handler(events.append)
    try:
        with knobs.override_cache_dir(str(tmp_path / "cache")):
            phase_stats.reset()
            snap.restore(_zeros(arrays))
            cold = phase_stats.snapshot()
            phase_stats.reset()
            snap.restore(_zeros(arrays))
            warm = phase_stats.snapshot()
    finally:
        event_handlers.unregister_event_handler(events.append)
    names = [(e.name, e.metadata.get("bytes")) for e in events if e.name.startswith("cache.")]
    assert names == [("cache.miss", 1 << 17), ("cache.hit", 1 << 17)]
    assert cold["cache_populate"]["bytes"] == 1 << 17 and "cache_read" not in cold
    assert warm["cache_read"]["bytes"] == 1 << 17 and "cache_populate" not in warm
