"""Retries and credentials of the port's GCS plugin: mirrors of the 4 tests
of tests/test_gcs_retry.py (the transient taxonomy, expressed in the port's
``HTTPStatusError``; the shared deadline expiring without progress and
refreshed by it; the backoff's attempt count reset by progress, at a 1 ms
``TPUSNAP_RETRY_BASE_S`` where the reference sleeps whole seconds), the
credential-gated round trip of tests/test_gcs_storage_plugin.py (skipped
unless ``TPUSNAP_TEST_GCS_BUCKET`` names a bucket and application-default
credentials exist, as there)."""

import http.client
import os
import time
import uuid

import pytest

from torchsnapshot_tpu_torch import knobs, retry
from torchsnapshot_tpu_torch.io_types import ReadIO, WriteIO
from torchsnapshot_tpu_torch.storage_plugins.gcs import GCSStoragePlugin, _is_transient, _SharedDeadlineRetryStrategy

from torch_env import default_knob_env, no_leaked_threads  # noqa: F401  fixtures

pytestmark = pytest.mark.usefixtures("no_leaked_threads")


def test_transient_classification():
    for status in (408, 429, 500, 502, 503, 504):
        assert _is_transient(retry.HTTPStatusError("x", status))
    for status in (400, 401, 403, 404, 412):
        assert not _is_transient(retry.HTTPStatusError("x", status))
    assert _is_transient(ConnectionError("reset"))
    assert _is_transient(http.client.RemoteDisconnected("gone"))
    assert _is_transient(TimeoutError())
    assert not _is_transient(ValueError("bad request body"))


def test_shared_deadline_expires_without_progress():
    strategy = _SharedDeadlineRetryStrategy(deadline_s=0.2)
    time.sleep(0.25)
    with pytest.raises(TimeoutError, match="no collective progress"):
        strategy.check_and_backoff(ConnectionError("x"))


def test_progress_refreshes_deadline():
    strategy = _SharedDeadlineRetryStrategy(deadline_s=0.3)
    with knobs.override_retry_base_s(0.001):
        for _ in range(3):
            time.sleep(0.2)
            strategy.report_progress()  # any transfer's progress refreshes
        # 0.6 s elapsed > the first deadline, but it was refreshed
        strategy.check_and_backoff(ConnectionError("transient"))
    assert strategy.retries == 1


def test_backoff_resets_after_progress():
    strategy = _SharedDeadlineRetryStrategy(deadline_s=10.0)
    with knobs.override_retry_base_s(0.001):
        strategy.check_and_backoff(ConnectionError("1"))
        strategy.check_and_backoff(ConnectionError("2"))
    assert strategy._attempts == 2
    strategy.report_progress()
    assert strategy._attempts == 0
    assert strategy.retries == 2  # the count of retries is not reset


def _gcs_available() -> bool:
    if not os.environ.get("TPUSNAP_TEST_GCS_BUCKET"):
        return False
    try:
        import google.auth

        google.auth.default()
        return True
    except Exception:  # noqa: BLE001 — no credentials: skip
        return False


@pytest.mark.gcs_integration_test
@pytest.mark.skipif(
    not _gcs_available(),
    reason="set TPUSNAP_TEST_GCS_BUCKET and provide application-default credentials to run GCS integration tests",
)
def test_gcs_roundtrip():
    bucket = os.environ["TPUSNAP_TEST_GCS_BUCKET"]
    plugin = GCSStoragePlugin(root=f"{bucket}/tpusnap_test_{uuid.uuid4().hex}")
    data = bytes(range(256)) * 64
    try:
        plugin.sync_write(WriteIO(path="x/y.bin", buf=data))
        read_io = ReadIO(path="x/y.bin")
        plugin.sync_read(read_io)
        assert bytes(read_io.buf) == data
        ranged = ReadIO(path="x/y.bin", byte_range=[128, 512])
        plugin.sync_read(ranged)
        assert bytes(ranged.buf) == data[128:512]
        plugin.sync_delete_dir("x")
    finally:
        plugin.sync_close()
