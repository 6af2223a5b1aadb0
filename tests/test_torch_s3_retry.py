"""Retries of the port's S3 plugin: mirrors of the 6 tests of
tests/test_s3_retry.py.  The transient taxonomy (retry.py) now classifies
HTTP statuses and ``http.client``'s dropped-connection errors; the
discarded-body 5xx faults of the fake server must be re-sent; each retry
is counted on the plugin (the port has no metrics registry).  The
reference's wall-clock bound on an exhausted budget is an attempt count
here, with ``TPUSNAP_RETRY_BASE_S`` at 1 ms (the ``s3_server`` fixture)."""

import http.client

import pytest

from torchsnapshot_tpu_torch import knobs, retry
from torchsnapshot_tpu_torch.io_types import ReadIO, WriteIO

from torch_env import default_knob_env, no_leaked_threads, s3_plugin, s3_server  # noqa: F401  fixtures

pytestmark = pytest.mark.usefixtures("no_leaked_threads")


def test_shared_transient_classification():
    from torchsnapshot_tpu_torch.storage_plugins.s3 import TRANSIENT_STATUS

    for status in (408, 429, 500, 502, 503, 504):
        assert status in TRANSIENT_STATUS
        assert retry.is_transient(retry.HTTPStatusError("x", status))
    for status in (400, 401, 403, 404, 412):
        assert status not in TRANSIENT_STATUS
        assert not retry.is_transient(retry.HTTPStatusError("x", status))
    for exc in (
        http.client.RemoteDisconnected("gone"),
        http.client.IncompleteRead(b"", 10),
        http.client.BadStatusLine("garbage"),
        ConnectionResetError("reset"),
        ConnectionError("reset"),
        TimeoutError(),
        retry.StorageTransientError("typed"),
    ):
        assert retry.is_transient(exc), exc
    assert not retry.is_transient(ValueError("bad request body"))
    assert not retry.is_transient(http.client.InvalidURL("x"))


def test_shared_backoff_bounds():
    for attempt in range(1, 6):
        for _ in range(20):
            delay = retry.backoff_s(attempt, base_s=0.2, cap_s=2.0)
            ideal = min(2.0, 0.2 * 2 ** (attempt - 1))
            assert 0.5 * ideal <= delay <= 1.5 * ideal
    with knobs.override_retry_base_s(0.001):
        assert retry.backoff_s(1) <= 0.0015
        assert retry.backoff_s(1, base_s=2.0) <= 0.0015  # the knob wins


def test_put_retries_after_discarded_5xx(s3_server, s3_plugin):
    """The fake discards the body before its 503: the retried PUT must
    re-send the bytes, and each retry is counted."""
    plugin = s3_plugin()
    payload = bytes(range(256)) * 16
    s3_server.fail_puts = 2
    plugin.sync_write(WriteIO(path="retry.bin", buf=payload))
    assert s3_server.objects["bkt/pre/retry.bin"] == payload
    assert s3_server.fail_puts == 0
    assert plugin.retries >= 2


def test_get_retries_after_5xx(s3_server, s3_plugin):
    plugin = s3_plugin()
    payload = b"stable-bytes" * 100
    plugin.sync_write(WriteIO(path="g.bin", buf=payload))
    s3_server.fail_gets = 2
    read_io = ReadIO(path="g.bin")
    plugin.sync_read(read_io)
    assert bytes(read_io.buf) == payload
    assert plugin.retries >= 2


def test_deterministic_fail_at_requests(s3_server, s3_plugin):
    plugin = s3_plugin()
    s3_server.fail_at_requests = {1}  # this PUT's first attempt
    plugin.sync_write(WriteIO(path="d.bin", buf=b"deterministic"))
    assert s3_server.objects["bkt/pre/d.bin"] == b"deterministic"
    assert s3_server.request_count == 2 and plugin.retries == 1


def test_exhausted_attempts_surface_terminal(s3_server, s3_plugin):
    """A persistent 5xx spends the plugin's five attempts and surfaces as a
    terminal error: the scheduler must not retry a spent budget again."""
    plugin = s3_plugin()
    s3_server.fail_next = 99
    with pytest.raises(RuntimeError, match="failed after 5 attempts") as excinfo:
        plugin.sync_write(WriteIO(path="x.bin", buf=b"doomed"))
    assert not retry.is_transient(excinfo.value)
    assert isinstance(excinfo.value.__cause__, retry.HTTPStatusError)
    assert s3_server.request_count == 5 and plugin.retries == 4
    s3_server.fail_next = 0
