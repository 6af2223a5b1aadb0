"""The port's GCS plugin (torchsnapshot_tpu_torch.storage_plugins.gcs)
against the in-repo fake server (tests/fake_gcs.py): mirrors of the 10
tests of tests/test_gcs_fake_server.py (resumable uploads in 256 KiB
chunks, the recovery probe and rewind after a chunk lost mid-upload, a
snapshot through a ``gs://`` URL, a burst of 503s on the download path,
``delete_dir``, the generation-pinned fan-out, into-reads and their extent
checks, the generation guard of a chunked read).  The transport's own
contract is in test_torch_gcs_transport.py.  Payloads are made from seeded
numpy generators."""

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch import Snapshot, StateDict, knobs, phase_stats
from torchsnapshot_tpu_torch.io_types import ReadIO, WriteIO
from torchsnapshot_tpu_torch.storage_plugins import gcs as gcs_mod

from torch_env import default_knob_env, gcs_plugin, gcs_server, no_leaked_threads  # noqa: F401  fixtures

pytestmark = pytest.mark.usefixtures("no_leaked_threads")


@pytest.fixture(autouse=True)
def small_chunks(monkeypatch):
    # Multi-chunk transfers at KB sizes (GCS wants multiples of 256 KiB).
    monkeypatch.setattr(gcs_mod, "_CHUNK_SIZE_BYTES", 256 * 1024)


def _bytes(n: int, seed: int = 0) -> bytes:
    return np.random.RandomState(seed).randint(0, 256, size=n, dtype=np.uint8).tobytes()


def test_resumable_upload_and_chunked_download(gcs_server, gcs_plugin):
    plugin = gcs_plugin()
    payload = _bytes(1024 * 1024)  # 4 chunks of 256 KiB
    phase_stats.reset()
    plugin.sync_write(WriteIO(path="x/y.bin", buf=payload))
    read_io = ReadIO(path="x/y.bin")
    plugin.sync_read(read_io)
    assert bytes(read_io.buf) == payload
    ranged = ReadIO(path="x/y.bin", byte_range=[1000, 300000])
    plugin.sync_read(ranged)
    assert bytes(ranged.buf) == payload[1000:300000]
    assert gcs_server.objects["bkt/pre/x/y.bin"] == payload
    assert gcs_server.chunk_puts == 4
    stats = phase_stats.snapshot()
    assert stats["gcs_upload"]["n"] == 1 and stats["gcs_chunk_put"]["n"] == 4
    assert stats["gcs_get"]["n"] == 4 + 2  # 4 chunks whole, 2 of the range


def test_upload_killed_mid_chunk_recovers_and_rewinds(gcs_server, gcs_plugin):
    """The 3rd chunk PUT is discarded with a 503 (two chunks persisted):
    the plugin probes how many bytes landed, rewinds to that offset and
    completes with intact data."""
    plugin = gcs_plugin(root="bkt")
    payload = bytes(i % 251 for i in range(1024 * 1024))  # 4 chunks
    gcs_server.chunk_puts = 0
    gcs_server.fail_at_chunks = {3}
    plugin.sync_write(WriteIO(path="killed.bin", buf=payload))
    read_io = ReadIO(path="killed.bin")
    plugin.sync_read(read_io)
    assert bytes(read_io.buf) == payload
    assert gcs_server.objects["bkt/killed.bin"] == payload
    # 4 good chunks and the killed one (the recovery probe is no chunk PUT)
    assert gcs_server.chunk_puts == 5
    assert plugin.retries == 1


def test_snapshot_roundtrip_via_gs_url(gcs_server):
    w = torch.arange(2048, dtype=torch.float32)
    app = {"m": StateDict({"w": w.clone(), "step": 3})}
    snapshot = Snapshot.take("gs://ckpt/run/s3", app)
    dst = {"m": StateDict({"w": torch.zeros(2048), "step": -1})}
    ptr = dst["m"]["w"].data_ptr()
    snapshot.restore(dst)
    assert torch.equal(dst["m"]["w"], w) and dst["m"]["w"].data_ptr() == ptr
    assert dst["m"]["step"] == 3
    assert any(k.startswith("ckpt/run/s3/") for k in gcs_server.objects)


def test_restore_survives_transient_get_burst(gcs_server):
    """A burst of 503s on the download path mid-restore is absorbed by the
    plugin's shared-deadline retries, and the restore lands bit-exact."""
    w = torch.arange(4096, dtype=torch.float32)
    snapshot = Snapshot.take("gs://ckpt/run/burst", {"m": StateDict({"w": w.clone(), "step": 5})})
    gcs_server.fail_gets = 3  # the next three media GETs 503
    dst = {"m": StateDict({"w": torch.zeros(4096), "step": -1})}
    snapshot.restore(dst)
    assert torch.equal(dst["m"]["w"], w) and dst["m"]["step"] == 5
    assert gcs_server.fail_gets == 0  # the burst really fired


def test_delete_dir(gcs_server, gcs_plugin):
    plugin = gcs_plugin(root="bkt")
    plugin.sync_write(WriteIO(path="d/a.bin", buf=b"aaa"))
    plugin.sync_write(WriteIO(path="d/b.bin", buf=b"bbb"))
    plugin.sync_write(WriteIO(path="keep/c.bin", buf=b"ccc"))
    assert plugin.sync_list_dir("") == ["d", "keep"] and plugin.sync_list_dir("d") == ["a.bin", "b.bin"]
    plugin.sync_delete_dir("d")
    assert "bkt/d/a.bin" not in gcs_server.objects
    assert "bkt/d/b.bin" not in gcs_server.objects
    assert gcs_server.objects["bkt/keep/c.bin"] == b"ccc"
    plugin.sync_delete("keep/c.bin")
    assert not plugin.sync_exists("keep/c.bin") and plugin.sync_list_dir("") == []


def test_parallel_ranged_fanout(gcs_server, gcs_plugin, monkeypatch):
    """Large reads of known size fan out across concurrent ranged GETs and
    land bit-exact: whole into-reads, ranged reads and both combined."""
    # One request per range (chunk >= payload), so the download count tells
    # a 4-way fan-out (4 GETs) from one stream (1).
    monkeypatch.setattr(gcs_mod, "_CHUNK_SIZE_BYTES", 8 << 20)
    plugin = gcs_plugin()
    payload = _bytes(6 << 20)
    plugin.sync_write(WriteIO(path="big.bin", buf=payload))
    phase_stats.reset()
    with knobs.override_cloud_parallel_min_bytes(1 << 20), knobs.override_parallel_read_ways(4):
        before = gcs_server.downloads
        dst = bytearray(len(payload))
        read_io = ReadIO(path="big.bin", into=memoryview(dst))
        plugin.sync_read(read_io)
        assert read_io.buf is read_io.into  # landed in the caller's memory
        assert dst == payload
        assert gcs_server.downloads - before == 4

        ranged = ReadIO(path="big.bin", byte_range=[1 << 20, 5 << 20])
        plugin.sync_read(ranged)
        assert bytes(ranged.buf) == payload[1 << 20 : 5 << 20]

        slice_dst = bytearray(2 << 20)
        both = ReadIO(path="big.bin", byte_range=[1 << 20, 3 << 20], into=memoryview(slice_dst))
        plugin.sync_read(both)
        assert both.buf is both.into
        assert slice_dst == payload[1 << 20 : 3 << 20]
    assert phase_stats.snapshot()["gcs_fanout"]["n"] == 3


def test_into_read_single_stream_and_mismatch(gcs_server, gcs_plugin):
    """Below the threshold an into-read lands in place through one stream;
    an into-view that disagrees with the object size raises rather than
    leaving stale bytes in the restore target."""
    plugin = gcs_plugin()
    payload = _bytes(1 << 16)
    plugin.sync_write(WriteIO(path="small.bin", buf=payload))
    dst = bytearray(len(payload))
    read_io = ReadIO(path="small.bin", into=memoryview(dst))
    plugin.sync_read(read_io)
    assert read_io.buf is read_io.into
    assert dst == payload
    with pytest.raises(RuntimeError, match="past end"):
        plugin.sync_read(ReadIO(path="small.bin", into=memoryview(bytearray(512))))
    with pytest.raises(RuntimeError, match="expected 131072"):
        plugin.sync_read(ReadIO(path="small.bin", into=memoryview(bytearray(1 << 17))))
    # The refused body was not read to its end: the thread's next request
    # still works.
    again = ReadIO(path="small.bin")
    plugin.sync_read(again)
    assert bytes(again.buf) == payload


def test_fanout_into_wrong_size_raises(gcs_server, gcs_plugin):
    """Above the fan-out threshold an un-ranged into-read probes the object
    size and raises on a mismatch instead of silently truncating."""
    plugin = gcs_plugin()
    plugin.sync_write(WriteIO(path="t.bin", buf=_bytes(2 << 20)))
    with knobs.override_cloud_parallel_min_bytes(1 << 20), knobs.override_parallel_read_ways(2):
        bad = ReadIO(path="t.bin", into=memoryview(bytearray((2 << 20) - 4096)))
        with pytest.raises(RuntimeError, match="into-view expects"):
            plugin.sync_read(bad)


def test_fanout_version_pin_rejects_overwrite(gcs_server, gcs_plugin):
    """Fan-out ranges pin the probed generation: an object overwritten since
    the probe fails the read (the pinned generation 404s, as a superseded
    generation does on GCS) instead of mixing two versions' bytes."""
    plugin = gcs_plugin()
    plugin.sync_write(WriteIO(path="v.bin", buf=_bytes(1 << 20, seed=1)))
    _, stale_gen = plugin._object_stat("v.bin")
    plugin.sync_write(WriteIO(path="v.bin", buf=_bytes(1 << 20, seed=2)))
    with pytest.raises(RuntimeError, match="changed mid-read"):
        plugin._stream_download_into("v.bin", 0, 1 << 19, memoryview(bytearray(1 << 19)), version=stale_gen)


def test_generation_guard_detects_mid_read_overwrite(gcs_server, gcs_plugin):
    """A single-stream read of several requests carries no pin; instead every
    response's x-goog-generation must match the first, so an overwrite
    between two chunk requests fails the read."""
    plugin = gcs_plugin()
    plugin.sync_write(WriteIO(path="g.bin", buf=_bytes(1 << 20)))  # 4 chunks
    send = plugin._send
    served = []

    def hooked(method, url, body=None, headers=None):
        conn, resp = send(method, url, body, headers)
        if method == "GET" and resp.status in (200, 206):
            served.append(url)
            if len(served) == 1:  # overwrite once chunk 1 is on its way
                gcs_server.objects["bkt/pre/g.bin"] = _bytes(1 << 20, seed=3)
        return conn, resp

    plugin._send = hooked
    with pytest.raises(RuntimeError, match="changed mid-read"):
        plugin._download_range("g.bin", None)
    assert len(served) == 2
