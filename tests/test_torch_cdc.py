"""Content-defined chunking (torchsnapshot_tpu_torch.chunker, casx
references) and streaming delta detection (cas.prestage_delta_skip):
mirrors of tests/test_cdc.py:55-139, :314, :383 and :401, the manager
cases rewritten as takes into ``<root>/step_N``, and the port's native
scan, its numpy scan and the JAX package's boundaries held equal on the
same seeded buffers."""

import contextlib
import os

import numpy as np
import pytest
import torch

from torchsnapshot_tpu import chunker as jax_chunker
from torchsnapshot_tpu_torch import Snapshot, StateDict, cas, chunker, event_handlers, faults, knobs
from torchsnapshot_tpu_torch.manifest import CDC_MANIFEST_VERSION
from torchsnapshot_tpu_torch.native_io import NativeFileIO

from torch_env import default_knob_env  # noqa: F401  autouse fixture

SMALL = dict(min_size=1024, avg_size=4096, max_size=16384)


def _chunks_of(data, ends):
    out, last = [], 0
    for e in ends:
        out.append(bytes(data[last:e]))
        last = e
    return out


def test_boundary_invariants_and_coverage():
    rng = np.random.RandomState(3)
    for n in (0, 100, 1024, 5000, 60_000, 300_000):
        data = rng.bytes(n)
        ends = chunker.boundaries_py(data, **SMALL)
        if n == 0:
            assert ends == []
            continue
        assert ends[-1] == n
        assert ends == sorted(set(ends))
        sizes = [b - a for a, b in zip([0] + ends[:-1], ends)]
        assert all(s <= SMALL["max_size"] for s in sizes)
        assert all(s >= SMALL["min_size"] for s in sizes[:-1])


@pytest.mark.parametrize(
    "n,params",
    [
        (1, SMALL),
        (1023, SMALL),
        (65_536, SMALL),
        (300_000, SMALL),
        (300_000, dict(min_size=64, avg_size=128, max_size=256)),
        ((9 << 20) + 12345, dict(min_size=65536, avg_size=262144, max_size=1 << 20)),
    ],
)
def test_native_python_and_jax_boundaries_identical(n, params):
    """Boundaries name chunks: the port's native scan (striped over the
    pool; over 8 MiB it crosses a stripe's 63-byte warm-up), its numpy
    scan and the JAX package's chunker agree on random and
    insertion-shifted buffers."""
    rng = np.random.RandomState(11 + n % 97)
    data = rng.bytes(n)
    shifted = data[: n // 2] + rng.bytes(53) + data[n // 2 :]
    native = NativeFileIO.get()
    for buf in (data, shifted):
        args = (params["min_size"], params["avg_size"], params["max_size"])
        ours = native.cdc_boundaries(buf, *args)
        assert ours == chunker.boundaries_py(buf, *args)
        assert ours == jax_chunker.boundaries(buf, *args)
        assert ours == chunker.boundaries(buf, *args)


def test_boundary_stability_under_insertion():
    rng = np.random.RandomState(7)
    data = rng.bytes(400_000)
    pos = 200_000
    edited = data[:pos] + rng.bytes(53) + data[pos:]
    before = set(_chunks_of(data, chunker.boundaries(data, **SMALL)))
    after = _chunks_of(edited, chunker.boundaries(edited, **SMALL))
    fresh = [c for c in after if c not in before]
    assert len(fresh) <= 4, len(fresh)
    assert sum(len(c) for c in fresh) <= 4 * SMALL["max_size"]


def test_gear_table_is_frozen():
    table = chunker.gear_table()
    assert len(table) == 256
    m64 = (1 << 64) - 1
    x = (0x7470_7573_6E61_7031 + 0x9E3779B97F4A7C15) & m64
    z = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & m64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & m64
    assert int(table[0]) == (z ^ (z >> 31)) & m64
    np.testing.assert_array_equal(table, jax_chunker.gear_table())


def test_bad_params_raise():
    with pytest.raises(ValueError):
        chunker.boundaries_py(b"x" * 100, 32, 64, 128)
    with pytest.raises(ValueError):
        chunker.boundaries_py(b"x" * 100, 1024, 512, 2048)
    with pytest.raises(ValueError):
        NativeFileIO.get().cdc_boundaries(b"x" * 100, 32, 64, 128)
    with knobs.override_cdc_params(4096, 1024, 8192):
        with pytest.raises(ValueError):
            knobs.get_cdc_params()


def test_casx_location_roundtrip():
    parts = [("xxh64", "ab" * 8, 1000), ("xxh64", "cd" * 8, 2000)]
    loc = cas.casx_location_for(parts)
    assert cas.is_casx_location(loc)
    assert cas.parse_casx_location(loc) == parts
    mixed = parts + [("xxh64s", "ef" * 8, 3000)]
    assert cas.parse_casx_location(cas.casx_location_for(mixed)) == mixed
    single = cas.casx_location_for(parts[:1])
    assert cas.is_cas_location(single) and not cas.is_casx_location(single)
    assert cas.chunk_relpaths_of_location(loc) == [
        cas.chunk_relpath("xxh64", "ab" * 8),
        cas.chunk_relpath("xxh64", "cd" * 8),
    ]
    with pytest.raises(ValueError):
        cas.parse_casx_location("casx://xxh64/")


def test_prestage_survives_sweeps():
    index = cas.DigestIndex({"xxh64/" + "ab" * 8}, {"xxh64:cafe": ("cas://xxh64/" + "ab" * 8, None)})
    assert index.lookup_payload("xxh64:cafe") is not None
    index.discard("xxh64/" + "ab" * 8)
    assert index.lookup_payload("xxh64:cafe") is None
    assert index.payload_count() == 0


def test_staging_executor_sizes_from_codec(monkeypatch):
    from torchsnapshot_tpu_torch.scheduler import _write_executor_workers

    monkeypatch.delenv("TPUSNAP_COMPRESSION", raising=False)
    monkeypatch.delenv("TPUSNAP_STAGING_THREADS", raising=False)
    assert _write_executor_workers() == 4
    wide = max(4, min(16, os.cpu_count() or 4))
    with knobs.override_compression("zlib"):
        assert _write_executor_workers() == wide
        with knobs.override_staging_threads(2):
            assert _write_executor_workers() == 2
    with knobs.override_compression("lz4"):
        assert _write_executor_workers() == 4  # resolves to raw here


def test_read_executor_sizes_from_workload(monkeypatch):
    from torchsnapshot_tpu_torch.io_types import BufferConsumer, ReadReq
    from torchsnapshot_tpu_torch.scheduler import _read_executor_workers

    monkeypatch.delenv("TPUSNAP_STAGING_THREADS", raising=False)

    class _C(BufferConsumer):
        def __init__(self, framed):
            self.framed = framed

        async def consume_buffer(self, buf, executor=None):
            pass

        def get_consuming_cost_bytes(self):
            return 0

    raw = [ReadReq(path="a", buffer_consumer=_C(False))]
    framed = raw + [ReadReq(path="b", buffer_consumer=_C(True))]
    assert _read_executor_workers(raw) == 4
    with knobs.override_compression("zlib"):
        assert _read_executor_workers(raw) == 4
    assert _read_executor_workers(framed) == max(4, min(16, os.cpu_count() or 4))
    with knobs.override_staging_threads(3):
        assert _read_executor_workers(framed) == 3


# ------------------------------------------------------------- end to end

_CDC = dict(min_bytes=2048, avg_bytes=8192, max_bytes=32768)


@contextlib.contextmanager
def _cdc_env(slab_threshold=1 << 20):
    with knobs.override_cas(True), knobs.override_cdc(True), knobs.override_cdc_params(
        _CDC["min_bytes"], _CDC["avg_bytes"], _CDC["max_bytes"]
    ), knobs.override_slab_size_threshold_bytes(slab_threshold):
        yield


def _leaves(seed=0, n=8, leaf_bytes=48 * 1024):
    rs = np.random.RandomState(seed)
    return {f"l{i}": torch.from_numpy(np.frombuffer(rs.bytes(leaf_bytes), np.uint8).copy()) for i in range(n)}


def _restore_equal(path, expected):
    dst = {"m": StateDict({k: torch.zeros_like(v) for k, v in expected.items()})}
    Snapshot(path).restore(dst)
    for k, v in expected.items():
        assert torch.equal(dst["m"][k], v), k


def _payload_written():
    return sum(n for p, n in faults.write_counters().items() if p.startswith("cas/"))


def test_take_restore_casx(tmp_path):
    """Slab-packed leaves plus one large leaf produce casx references
    (manifest 0.6.0) that restore and read_object bit-exact."""
    leaves = _leaves()
    leaves["big"] = torch.from_numpy(np.frombuffer(np.random.RandomState(9).bytes(256 * 1024), np.uint8).copy())
    path = str(tmp_path / "root" / "step_1")
    with _cdc_env():
        snap = Snapshot.take(path, {"m": StateDict(dict(leaves))})
    md = snap.metadata
    assert md.version == CDC_MANIFEST_VERSION
    assert cas.is_casx_location(md.manifest["0/m/big"].location)
    _restore_equal(path, leaves)
    assert torch.equal(Snapshot(path).read_object("0/m/big", device="cpu"), leaves["big"])


def test_insertion_rewrites_only_overlapping_chunks(tmp_path):
    """Inserting 64 bytes into one slab member rewrites only the chunks
    overlapping the edit (the fault wrapper's write meter), and the grown
    state restores bit-exact."""
    leaves = _leaves(seed=1)
    slab_logical = sum(v.numel() for v in leaves.values())
    root = tmp_path / "root"
    with _cdc_env(), knobs.override_faults("none"):
        Snapshot.take(str(root / "step_1"), {"m": StateDict(dict(leaves))})
        grown = dict(leaves)
        mid = leaves["l3"].numel() // 2
        noise = torch.from_numpy(np.frombuffer(np.random.RandomState(2).bytes(64), np.uint8).copy())
        grown["l3"] = torch.cat([leaves["l3"][:mid], noise, leaves["l3"][mid:]])
        faults.reset_write_counters()
        Snapshot.take(str(root / "step_2"), {"m": StateDict(dict(grown))})
        written = _payload_written()
        assert 0 < written <= 4 * _CDC["max_bytes"], (written, slab_logical)
        assert written < 0.5 * slab_logical
    _restore_equal(str(root / "step_2"), grown)


def test_unchanged_leaf_costs_one_hash_zero_pipeline_requests(tmp_path):
    """A step whose state is unchanged sends nothing through the write
    pipeline: the take.end event counts zero staged bytes and one
    prestage hit per leaf, no chunk is written, and every entry references
    step 1's location."""
    leaves = _leaves(seed=2)
    root = tmp_path / "root"
    seen = []
    with _cdc_env(), knobs.override_faults("none"):
        Snapshot.take(str(root / "step_1"), {"m": StateDict(dict(leaves))})
        faults.reset_write_counters()
        event_handlers.register_event_handler(seen.append)
        try:
            snap2 = Snapshot.take(str(root / "step_2"), {"m": StateDict(dict(leaves))})
        finally:
            event_handlers.unregister_event_handler(seen.append)
        payload = {
            p: n
            for p, n in faults.write_counters().items()
            if p.startswith("cas/") or not (p.rsplit("/", 1)[-1].startswith(".") or p.startswith("telemetry/"))
        }
        assert payload == {}, payload
    end = [e for e in seen if e.name == "take.end"][-1].metadata
    assert end["bytes"] == 0
    stats = end["cas"]
    assert stats["prestage_probed"] == stats["prestage_hits"] == len(leaves)
    assert stats["prestage_bytes"] == sum(v.numel() for v in leaves.values())
    assert stats["chunks_written"] == 0 and stats["physical_bytes_written"] == 0
    md1 = Snapshot(str(root / "step_1")).metadata
    for path, entry in snap2.metadata.manifest.items():
        loc = getattr(entry, "location", None)
        if loc is not None:
            assert loc == md1.manifest[path].location
            assert entry.byte_range == md1.manifest[path].byte_range
    _restore_equal(str(root / "step_2"), leaves)
