"""The port's S3 plugin (torchsnapshot_tpu_torch.storage_plugins.s3) against
the in-repo fake server: mirrors of the 16 tests of
tests/test_s3_storage_plugin.py (the 6 GB round trip stays skipped unless
TPUSNAP_TEST_HUGE_S3 is set, as there), plus the standard-library
transport's own contracts: SigV4 headers equal to the JAX plugin's, one
connection per worker thread reused across requests and reopened after an
unread body, and no thread or socket left after ``close()``.  Payloads are
made from seeded numpy generators."""

import asyncio
import datetime
import os
import threading

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch import Snapshot, StateDict, knobs, phase_stats
from torchsnapshot_tpu_torch.io_types import ReadIO, WriteIO
from torchsnapshot_tpu_torch.storage_plugins.s3 import S3StoragePlugin

from torch_env import default_knob_env, no_leaked_threads, s3_plugin, s3_server  # noqa: F401  fixtures

pytestmark = pytest.mark.usefixtures("no_leaked_threads")


def _bytes(n: int, seed: int = 0) -> bytes:
    return np.random.RandomState(seed).randint(0, 256, size=n, dtype=np.uint8).tobytes()


def test_put_get_roundtrip(s3_server, s3_plugin):
    plugin = s3_plugin()
    payload = _bytes(1 << 16)
    plugin.sync_write(WriteIO(path="a/b.bin", buf=payload))
    read_io = ReadIO(path="a/b.bin")
    plugin.sync_read(read_io)
    assert bytes(read_io.buf) == payload
    assert "bkt/pre/a/b.bin" in s3_server.objects


def test_ranged_reads_inclusive_end_correction(s3_server, s3_plugin):
    plugin = s3_plugin()
    payload = bytes(range(256)) * 4
    plugin.sync_write(WriteIO(path="r.bin", buf=payload))
    for start, end in [(0, 1), (0, 256), (100, 612), (1000, 1024)]:
        read_io = ReadIO(path="r.bin", byte_range=[start, end])
        plugin.sync_read(read_io)
        assert bytes(read_io.buf) == payload[start:end], (start, end)


def test_snapshot_roundtrip_via_s3_url(s3_server):
    w = torch.from_numpy(np.random.RandomState(1).rand(4096).astype(np.float32))
    app = {"m": StateDict({"w": w, "b": torch.ones(16), "step": 7})}
    snapshot = Snapshot.take("s3://ckpt-bucket/run1/step7", app)
    dst = {"m": StateDict({"w": torch.zeros(4096), "b": torch.zeros(16), "step": -1})}
    ptr = dst["m"]["w"].data_ptr()
    snapshot.restore(dst)
    assert torch.equal(dst["m"]["w"], w) and dst["m"]["w"].data_ptr() == ptr
    assert torch.equal(dst["m"]["b"], torch.ones(16)) and dst["m"]["step"] == 7
    assert any(k.startswith("ckpt-bucket/run1/step7/") for k in s3_server.objects)


def test_delete_and_delete_dir(s3_server, s3_plugin):
    plugin = s3_plugin(root="bkt")
    for name in ("d/x", "d/y", "keep/z"):
        plugin.sync_write(WriteIO(path=name, buf=b"data"))
    plugin.sync_delete("d/x")
    assert "bkt/d/x" not in s3_server.objects
    plugin.sync_delete_dir("d")
    assert "bkt/d/y" not in s3_server.objects
    assert "bkt/keep/z" in s3_server.objects
    assert plugin.sync_list_dir("") == ["keep"]
    assert plugin.sync_exists("keep/z") and not plugin.sync_exists("d/y")


def test_transient_errors_retried(s3_server, s3_plugin):
    plugin = s3_plugin(root="bkt")
    s3_server.fail_next = 2  # two 503s, then success
    plugin.sync_write(WriteIO(path="retry.bin", buf=b"persisted"))
    assert s3_server.objects["bkt/retry.bin"] == b"persisted"
    s3_server.fail_next = 2
    read_io = ReadIO(path="retry.bin")
    plugin.sync_read(read_io)
    assert bytes(read_io.buf) == b"persisted"
    assert plugin.retries == 4


def test_missing_key_raises(s3_server, s3_plugin):
    from torchsnapshot_tpu_torch.retry import HTTPStatusError, is_transient

    plugin = s3_plugin(root="bkt")
    with pytest.raises(HTTPStatusError, match="404") as excinfo:
        plugin.sync_read(ReadIO(path="nope.bin"))
    assert excinfo.value.status == 404 and not is_transient(excinfo.value)


def test_multipart_upload_roundtrip(s3_server, s3_plugin, monkeypatch):
    """Above the threshold a write is initiate → parallel part PUTs →
    complete; the assembled object reads back whole and ranged."""
    monkeypatch.setenv("TPUSNAP_S3_MULTIPART_THRESHOLD_BYTES", str(1 << 20))
    monkeypatch.setenv("TPUSNAP_S3_MULTIPART_PART_BYTES", str(3 << 20))
    plugin = s3_plugin(root="bkt")
    payload = _bytes(8 << 20)  # 3 parts of 3/3/2 MiB
    phase_stats.reset()
    plugin.sync_write(WriteIO(path="big.bin", buf=memoryview(payload)))
    stats = phase_stats.snapshot()
    assert stats["s3_multipart"]["n"] == 1 and stats["s3_multipart_part"]["n"] == 3
    assert "s3_put" not in stats
    assert s3_server.multipart_completed == 1
    assert s3_server.objects["bkt/big.bin"] == payload
    read_io = ReadIO(path="big.bin", byte_range=[(3 << 20) - 7, (3 << 20) + 9])
    plugin.sync_read(read_io)
    assert bytes(read_io.buf) == payload[(3 << 20) - 7 : (3 << 20) + 9]
    read_io = ReadIO(path="big.bin")
    plugin.sync_read(read_io)
    assert bytes(read_io.buf) == payload
    assert not s3_server.uploads  # nothing orphaned


def test_multipart_upload_aborts_on_failure(s3_server, s3_plugin, monkeypatch):
    """Parts failing past the retry budget abort the upload: no orphaned
    parts, and the object never appears."""
    monkeypatch.setenv("TPUSNAP_S3_MULTIPART_THRESHOLD_BYTES", str(1 << 20))
    monkeypatch.setenv("TPUSNAP_S3_MULTIPART_PART_BYTES", str(1 << 20))
    plugin = s3_plugin(root="bkt")
    s3_server.fail_parts = 99
    with pytest.raises(RuntimeError):
        plugin.sync_write(WriteIO(path="doomed.bin", buf=_bytes(4 << 20)))
    s3_server.fail_parts = 0
    assert "bkt/doomed.bin" not in s3_server.objects
    assert not s3_server.uploads  # aborted


@pytest.mark.skipif(
    not os.environ.get("TPUSNAP_TEST_HUGE_S3"),
    reason="6 GB in-memory round trip; set TPUSNAP_TEST_HUGE_S3=1",
)
def test_multipart_upload_true_5gb(s3_server, s3_plugin):
    """A genuinely >5 GB object round-trips with the default threshold."""
    plugin = s3_plugin(root="bkt")
    chunk = _bytes(64 << 20)
    n = (5 * (1 << 30)) // len(chunk) + 2
    payload = bytearray(chunk * n)
    plugin.sync_write(WriteIO(path="huge.bin", buf=payload))
    assert s3_server.multipart_completed == 1
    stored = s3_server.objects["bkt/huge.bin"]
    assert len(stored) == len(payload)
    assert stored[:1024] == payload[:1024] and stored[-1024:] == payload[-1024:]


def test_multipart_server_side_copy_over_5gb_limit(s3_server, s3_plugin, monkeypatch):
    """copy_from_sibling over the CopyObject ceiling goes through
    UploadPartCopy: ranged server-side part copies, no byte uploaded."""
    monkeypatch.setattr(S3StoragePlugin, "_COPY_MAX_BYTES", 1 << 20)
    monkeypatch.setattr(S3StoragePlugin, "_COPY_PART_BYTES", 2 << 20)
    plugin = s3_plugin(root="bkt/new")
    payload = _bytes(5 << 20)  # 3 copy parts of 2/2/1 MiB
    s3_server.objects["bkt/base/big.bin"] = payload
    uploaded_before = s3_server.put_bytes
    assert asyncio.run(plugin.copy_from_sibling("bkt/base", "big.bin"))
    assert s3_server.objects["bkt/new/big.bin"] == payload
    assert s3_server.put_bytes == uploaded_before
    assert s3_server.copies >= 3
    assert not s3_server.uploads
    assert not asyncio.run(plugin.copy_from_sibling("bkt/base", "absent.bin"))
    assert not asyncio.run(plugin.copy_from_sibling("other-bkt/base", "big.bin"))


def test_multipart_boundary_sizes(s3_server, s3_plugin, monkeypatch):
    """Payloads of exactly N parts and N parts ±1 byte assemble right."""
    part = 1 << 20
    monkeypatch.setenv("TPUSNAP_S3_MULTIPART_THRESHOLD_BYTES", str(1 << 18))
    monkeypatch.setenv("TPUSNAP_S3_MULTIPART_PART_BYTES", str(part))
    plugin = s3_plugin(root="bkt")
    sizes = (part, part - 1, part + 1, 2 * part, 2 * part + 1, 3 * part - 1)
    for i, size in enumerate(sizes):
        payload = _bytes(size, seed=i)
        plugin.sync_write(WriteIO(path=f"b{size}.bin", buf=payload))
        assert s3_server.objects[f"bkt/b{size}.bin"] == payload, size
        read_io = ReadIO(path=f"b{size}.bin")
        plugin.sync_read(read_io)
        assert bytes(read_io.buf) == payload, size
    assert s3_server.multipart_completed == len(sizes)
    assert not s3_server.uploads


def test_parallel_ranged_fanout(s3_server, s3_plugin):
    """Large reads of known size fan out across ranged GETs and land
    bit-exact: whole into-reads, ranged reads and both combined."""
    plugin = s3_plugin()
    payload = _bytes(6 << 20)
    plugin.sync_write(WriteIO(path="big.bin", buf=payload))
    gets_before = s3_server.gets
    phase_stats.reset()
    with knobs.override_cloud_parallel_min_bytes(1 << 20), knobs.override_parallel_read_ways(4):
        dst = bytearray(len(payload))
        read_io = ReadIO(path="big.bin", into=memoryview(dst))
        plugin.sync_read(read_io)
        assert read_io.buf is read_io.into  # landed in the caller's memory
        assert dst == payload

        ranged = ReadIO(path="big.bin", byte_range=[1 << 20, 5 << 20])
        plugin.sync_read(ranged)
        assert bytes(ranged.buf) == payload[1 << 20 : 5 << 20]

        slice_dst = bytearray(2 << 20)
        both = ReadIO(path="big.bin", byte_range=[1 << 20, 3 << 20], into=memoryview(slice_dst))
        plugin.sync_read(both)
        assert both.buf is both.into
        assert slice_dst == payload[1 << 20 : 3 << 20]
    assert s3_server.gets - gets_before == 12  # 3 reads x 4 ways
    assert phase_stats.snapshot()["s3_fanout"]["n"] == 3


def test_fanout_into_wrong_size_raises(s3_server, s3_plugin):
    plugin = s3_plugin()
    plugin.sync_write(WriteIO(path="t.bin", buf=_bytes(2 << 20)))
    with knobs.override_cloud_parallel_min_bytes(1 << 20), knobs.override_parallel_read_ways(2):
        bad = ReadIO(path="t.bin", into=memoryview(bytearray((2 << 20) - 4096)))
        with pytest.raises(RuntimeError, match="into-view expects"):
            plugin.sync_read(bad)


def test_into_read_single_stream(s3_server, s3_plugin):
    plugin = s3_plugin()
    payload = _bytes(1 << 16)
    plugin.sync_write(WriteIO(path="small.bin", buf=payload))
    dst = bytearray(len(payload))
    read_io = ReadIO(path="small.bin", into=memoryview(dst))
    plugin.sync_read(read_io)
    assert read_io.buf is read_io.into
    assert dst == payload


def test_into_size_mismatch_raises(s3_server, s3_plugin):
    plugin = s3_plugin()
    plugin.sync_write(WriteIO(path="obj.bin", buf=_bytes(1024)))
    with pytest.raises(RuntimeError, match="expected 512"):
        plugin.sync_read(ReadIO(path="obj.bin", into=memoryview(bytearray(512))))
    # The refused body was not read to its end: the next request on this
    # thread's connection still works.
    read_io = ReadIO(path="obj.bin")
    plugin.sync_read(read_io)
    assert bytes(read_io.buf) == _bytes(1024)


def test_fanout_version_pin_rejects_overwrite(s3_server, s3_plugin):
    plugin = s3_plugin()
    plugin.sync_write(WriteIO(path="v.bin", buf=_bytes(2 << 20, seed=1)))
    _, stale_etag = plugin._object_stat("v.bin")
    plugin.sync_write(WriteIO(path="v.bin", buf=_bytes(2 << 20, seed=2)))
    with pytest.raises(RuntimeError, match="changed mid-read"):
        plugin._stream_get_into("v.bin", 0, 1 << 20, memoryview(bytearray(1 << 20)), version=stale_etag)


def test_sigv4_headers_equal_the_jax_plugins(monkeypatch):
    """Same credentials, region, request and clock: the same canonical
    request, so the same Authorization header as the JAX plugin's signer."""
    from torchsnapshot_tpu.storage_plugins import s3 as jax_s3

    from torchsnapshot_tpu_torch.storage_plugins.s3 import _SigV4

    fixed = datetime.datetime(2026, 10, 17, 12, 34, 56, tzinfo=datetime.timezone.utc)

    class _Clock(datetime.datetime):
        @classmethod
        def now(cls, tz=None):
            return fixed

    monkeypatch.setattr(jax_s3.datetime, "datetime", _Clock)
    for token in (None, "session-token"):
        for target, extra in [
            ("/bkt/pre/a%20b/c.bin", {"Range": "bytes=0-99"}),
            ("/bkt/pre/k?partNumber=2&uploadId=upload-1", {}),
            ("/bkt?list-type=2&delimiter=%2F&prefix=pre%2F", {}),
        ]:
            jax_headers, port_headers = dict(extra), dict(extra)
            jax_s3._SigV4("AKID", "secret", token, "eu-west-1").sign(
                "GET", "http://127.0.0.1:9000" + target, jax_headers
            )
            _SigV4("AKID", "secret", token, "eu-west-1").sign("GET", "127.0.0.1:9000", target, port_headers, now=fixed)
            assert port_headers == jax_headers, target


def test_one_connection_per_thread_and_none_after_close(s3_server, s3_plugin, monkeypatch):
    """Each thread that issues requests reuses one connection; close()
    joins the pools and closes every connection it opened.  How many pool
    threads serve the sequential calls is the executor's choice (a caller
    woken by its result can submit before the worker goes idle), so the
    connections are counted against the threads that asked for one."""
    from torchsnapshot_tpu_torch.storage_plugins import s3 as s3_mod

    plugin = s3_plugin()
    callers = set()
    connection = plugin._connection

    def counted_connection():
        callers.add(threading.get_ident())
        return connection()

    monkeypatch.setattr(plugin, "_connection", counted_connection)
    for i in range(6):
        plugin.sync_write(WriteIO(path=f"o{i}", buf=_bytes(1024, seed=i)))
        read_io = ReadIO(path=f"o{i}")
        plugin.sync_read(read_io)
    assert 1 <= len(callers) <= s3_mod._IO_THREADS + s3_mod._CHUNK_THREADS
    assert len(plugin._conns) == len(callers)
    conns = list(plugin._conns)
    plugin.sync_close()
    assert plugin._conns == [] and all(c.sock is None for c in conns)


def test_read_wanting_a_hash_goes_unhashed(s3_server, s3_plugin):
    """The plugin computes no digest: a read that asks for one gets none,
    and the consumer verifies the recorded digest itself."""
    plugin = s3_plugin()
    plugin.sync_write(WriteIO(path="h.bin", buf=_bytes(4096)))
    read_io = ReadIO(path="h.bin", want_hash=True, hash_algo="xxh64")
    plugin.sync_read(read_io)
    assert bytes(read_io.buf) == _bytes(4096) and read_io.hash64 is None
