"""The port's fs plugin: round trips, ranged and into-place reads, the
adaptive read strategy, and the same bytes and digests as the JAX
package's plugin (mirrors tests/test_fs_storage_plugin.py).  Inputs are
made from a seed with numpy; comparisons are exact."""

import asyncio

import numpy as np
import pytest

from torchsnapshot_tpu.io_types import ReadIO as JaxReadIO
from torchsnapshot_tpu.io_types import ScatterBuffer as JaxScatterBuffer
from torchsnapshot_tpu.io_types import WriteIO as JaxWriteIO
from torchsnapshot_tpu.storage_plugins.fs import FSStoragePlugin as JaxFSStoragePlugin
from torchsnapshot_tpu_torch import phase_stats
from torchsnapshot_tpu_torch.io_types import ReadIO, ScatterBuffer, WriteIO
from torchsnapshot_tpu_torch.storage_plugins import fs as fs_mod
from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin

from torch_env import default_knob_env, no_leaked_threads  # noqa: F401  fixtures

pytestmark = pytest.mark.usefixtures("no_leaked_threads")


def _payload(seed: int, n: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


def test_fs_roundtrip(tmp_path):
    plugin = FSStoragePlugin(root=str(tmp_path))
    data = bytes(range(256)) * 10

    async def go():
        await plugin.write(WriteIO(path="a/b/c.bin", buf=data))
        read_io = ReadIO(path="a/b/c.bin")
        await plugin.read(read_io)
        assert bytes(read_io.buf) == data

        ranged = ReadIO(path="a/b/c.bin", byte_range=[256, 512])
        await plugin.read(ranged)
        assert bytes(ranged.buf) == data[256:512]

        await plugin.delete("a/b/c.bin")
        await plugin.close()

    asyncio.run(go())
    assert not (tmp_path / "a" / "b" / "c.bin").exists()


def test_fs_write_memoryview(tmp_path):
    plugin = FSStoragePlugin(root=str(tmp_path))
    data = memoryview(b"hello world")

    async def go():
        await plugin.write(WriteIO(path="mv.bin", buf=data))
        read_io = ReadIO(path="mv.bin")
        await plugin.read(read_io)
        assert bytes(read_io.buf) == b"hello world"
        await plugin.close()

    asyncio.run(go())


def test_fs_sync_wrappers(tmp_path):
    plugin = FSStoragePlugin(root=str(tmp_path))
    plugin.sync_write(WriteIO(path="s.bin", buf=b"sync"))
    read_io = ReadIO(path="s.bin")
    plugin.sync_read(read_io)
    assert bytes(read_io.buf) == b"sync"
    plugin.sync_close()


def test_parallel_into_reads_saturating_io_pool(tmp_path, monkeypatch):
    """More concurrent into-place reads than the plugin has io threads,
    each large enough for the parallel read, all complete (the JAX
    package's chunk reads once deadlocked in the pool their parents held;
    the port's parallel read is one native call)."""
    monkeypatch.setattr(fs_mod, "_PARALLEL_READ_MIN_BYTES", 1024)
    monkeypatch.setenv("TPUSNAP_PARALLEL_READ_WAYS", "8")
    plugin = FSStoragePlugin(root=str(tmp_path))
    n = fs_mod._DEFAULT_IO_THREADS + 4
    payloads = {f"p{i}.bin": _payload(i, 8192) for i in range(n)}
    targets = {name: bytearray(8192) for name in payloads}

    async def go():
        await asyncio.gather(*(plugin.write(WriteIO(path=name, buf=data)) for name, data in payloads.items()))
        await asyncio.wait_for(
            asyncio.gather(
                *(plugin.read(ReadIO(path=name, into=memoryview(targets[name]))) for name in payloads)
            ),
            timeout=60,
        )
        await plugin.close()

    phase_stats.reset()
    asyncio.run(go())
    for name, data in payloads.items():
        assert bytes(targets[name]) == data
    assert phase_stats.snapshot()["native_read"]["n"] == n  # all took the parallel read


def test_parallel_into_read_range_mismatch_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(fs_mod, "_PARALLEL_READ_MIN_BYTES", 1024)
    plugin = FSStoragePlugin(root=str(tmp_path))
    plugin.sync_write(WriteIO(path="m.bin", buf=b"x" * 8192))
    with pytest.raises(ValueError, match="into-view"):
        plugin.sync_read(ReadIO(path="m.bin", byte_range=[0, 4096], into=memoryview(bytearray(8192))))
    plugin.sync_close()


def test_into_read_strategy_selection(tmp_path, monkeypatch):
    """Checksummed into-reads take the fused read+hash path and measure
    nothing; unchecksummed large reads measure sequential once, then
    parallel once."""
    monkeypatch.setattr(fs_mod, "_PARALLEL_READ_MIN_BYTES", 1024)
    data = bytes(range(256)) * 32  # 8 KiB

    plugin = FSStoragePlugin(root=str(tmp_path))
    plugin.sync_write(WriteIO(path="a.bin", buf=data))
    read_io = ReadIO(path="a.bin", into=memoryview(bytearray(len(data))), want_hash=True, hash_algo="xxh64")
    plugin.sync_read(read_io)
    assert bytes(read_io.buf) == data
    assert read_io.hash64 == plugin._native.xxhash64(data)
    assert plugin._seq_gbps is None and plugin._par_gbps is None

    # A read whose issuer asked for no digest pays for none.
    io_nohash = ReadIO(path="a.bin", into=memoryview(bytearray(len(data))))
    plugin.sync_read(io_nohash)
    assert io_nohash.hash64 is None
    plugin.sync_close()

    # Checksums off: no digest even when asked; the first large read
    # measures sequential, the second parallel.
    monkeypatch.setenv("TPUSNAP_CHECKSUM", "0")
    plugin = FSStoragePlugin(root=str(tmp_path))
    for _ in range(3):
        io_ = ReadIO(path="a.bin", into=memoryview(bytearray(len(data))), want_hash=True, hash_algo="xxh64")
        plugin.sync_read(io_)
        assert bytes(io_.buf) == data
        assert io_.hash64 is None
    assert plugin._seq_gbps is not None and plugin._par_gbps is not None
    plugin.sync_close()


@pytest.mark.parametrize(
    "seq_gbps, par_gbps, first, reprobe",
    [(1.0, 2.0, "native_read", "fs_read"), (2.0, 1.0, "fs_read", "native_read")],
    ids=["parallel_wins", "sequential_wins"],
)
def test_adaptive_pick_follows_the_measured_rates_and_reprobes(tmp_path, monkeypatch, seq_gbps, par_gbps, first, reprobe):
    """With both rates measured (set here, not timed), the faster strategy
    serves each read, and the read after ``_ADAPTIVE_REPROBE_EVERY`` of
    them measures the slower one again."""
    monkeypatch.setattr(fs_mod, "_PARALLEL_READ_MIN_BYTES", 1024)
    data = _payload(3, 4096)
    plugin = FSStoragePlugin(root=str(tmp_path))
    plugin.sync_write(WriteIO(path="r.bin", buf=data))
    plugin._seq_gbps, plugin._par_gbps = seq_gbps, par_gbps
    phases = []
    for _ in range(fs_mod._ADAPTIVE_REPROBE_EVERY):
        phase_stats.reset()
        io_ = ReadIO(path="r.bin", into=memoryview(bytearray(len(data))))
        plugin.sync_read(io_)
        assert bytes(io_.buf) == data
        phases.extend(phase_stats.snapshot())
    plugin.sync_close()
    assert phases == [first] * (fs_mod._ADAPTIVE_REPROBE_EVERY - 1) + [reprobe]
    # The re-measured strategy holds a fresh rate again.
    assert plugin._seq_gbps is not None and plugin._par_gbps is not None


@pytest.mark.parametrize("ways, phase", [("1", "fs_read"), ("8", "native_read"), ("auto", "fs_read")])
def test_pinned_read_ways_win_over_the_measurement(tmp_path, monkeypatch, ways, phase):
    """``TPUSNAP_PARALLEL_READ_WAYS`` pins the strategy of large reads, as
    in the JAX package (1 sequential, more parallel); ``auto`` measures,
    and its first read is sequential.  Reads below the threshold stay
    sequential whatever is pinned."""
    monkeypatch.setattr(fs_mod, "_PARALLEL_READ_MIN_BYTES", 2048)
    monkeypatch.setenv("TPUSNAP_PARALLEL_READ_WAYS", ways)
    data = _payload(4, 4096)
    plugin = FSStoragePlugin(root=str(tmp_path))
    plugin.sync_write(WriteIO(path="w.bin", buf=data))
    plugin._seq_gbps, plugin._par_gbps = (None, None) if ways == "auto" else (1.0, 9.0)
    phase_stats.reset()
    big = ReadIO(path="w.bin", into=memoryview(bytearray(len(data))))
    plugin.sync_read(big)
    assert list(phase_stats.snapshot()) == [phase]
    phase_stats.reset()
    small = ReadIO(path="w.bin", byte_range=[0, 1024])
    plugin.sync_read(small)
    assert list(phase_stats.snapshot()) == ["fs_read"]
    plugin.sync_close()
    assert bytes(big.buf) == data and bytes(small.buf) == data[:1024]


def test_whole_read_without_target_is_uninitialised_buffer_of_the_range(tmp_path):
    """A read with no target returns a writable buffer of exactly the
    range's length (not a zero-filled bytearray), holding the file's bytes;
    every consumer reads it through the buffer protocol."""
    data = _payload(5, 100_003)
    plugin = FSStoragePlugin(root=str(tmp_path))
    plugin.sync_write(WriteIO(path="u.bin", buf=data))
    whole, ranged = ReadIO(path="u.bin"), ReadIO(path="u.bin", byte_range=[17, 50_017])
    plugin.sync_read(whole)
    plugin.sync_read(ranged)
    plugin.sync_close()
    for io_, expect in ((whole, data), (ranged, data[17:50_017])):
        assert not isinstance(io_.buf, bytearray)
        view = memoryview(io_.buf)
        assert not view.readonly and view.nbytes == len(expect)
        assert bytes(io_.buf) == expect and view.cast("B") == memoryview(expect)


@pytest.mark.parametrize("nbytes", [1000, 40 << 20], ids=["plain", "striped"])
def test_writes_and_digests_equal_the_jax_plugin_both_ways(tmp_path, nbytes):
    """Each package's plugin writes the same slab (fused write+hash, an
    empty member included) to the same bytes with the same part digests,
    and each reads the other's file with the same read-fused digest."""
    parts = [_payload(6, nbytes), b"", _payload(7, 77)]
    port, jax = FSStoragePlugin(str(tmp_path / "port")), JaxFSStoragePlugin(str(tmp_path / "jax"))
    port_io = WriteIO(path="s.bin", buf=ScatterBuffer(parts), want_part_hashes=True)
    port.sync_write(port_io)
    jax_io = JaxWriteIO(path="s.bin", buf=JaxScatterBuffer(parts), want_part_hashes=True)
    jax.sync_write(jax_io)
    assert (tmp_path / "port" / "s.bin").read_bytes() == (tmp_path / "jax" / "s.bin").read_bytes() == b"".join(parts)
    assert port_io.part_hash64 == jax_io.part_hash64
    algo = "xxh64s" if nbytes >= 32 << 20 else "xxh64"
    reads = []
    for plugin, cls, root in ((port, ReadIO, "jax"), (jax, JaxReadIO, "port")):
        plugin.root = str(tmp_path / root)
        io_ = cls(path="s.bin", byte_range=[0, nbytes], want_hash=True, hash_algo=algo)
        plugin.sync_read(io_)
        assert bytes(io_.buf) == parts[0]
        reads.append(io_.hash64)
    port.sync_close()
    jax.sync_close()
    assert reads[0] == reads[1] == port_io.part_hash64[0]
