"""Fixtures that the port's test files import.

``default_knob_env`` (autouse): every test starts from the default knob
environment.  Both packages read their knobs from the same ``TPUSNAP_*``
variables, and a test of torchsnapshot_tpu whose threads override one
concurrently (its manager pins ``TPUSNAP_STORE`` and ``TPUSNAP_CAS`` for
each take) can leave it set in the process for whichever test file runs
next.  The variables a multi-process test hands its ranks
(``TPUSNAP_TEST_*``) are kept.  After the test, the port's process-global
direct-I/O mode is put back to off, when the native library is loaded (the
fixture never loads or builds it).

``no_leaked_threads``: the test leaves no Python thread it started alive,
so that nothing it started runs on in the worker process under the tests
that follow.  The native library's worker pool is C++ threads that live
for the process by design; ``threading.enumerate()`` does not list them.

``s3_server`` (requests ``no_leaked_threads``): a fake S3 server
(tests/fake_s3.py) that ``TPUSNAP_S3_ENDPOINT`` points at, with SigV4
credentials set (the fake ignores them) and ``TPUSNAP_RETRY_BASE_S`` at
1 ms.  ``s3_plugin`` builds port plugins on it.  At teardown every plugin
is closed (its pools joined, its connections closed), the server is
stopped (``stop_server``), and the server's handler threads, which live
until their client closes the connection, are waited for, at most 5 s.

``gcs_server`` and ``gcs_plugin``: the same for a fake GCS server
(tests/fake_gcs.py) that ``TPUSNAP_GCS_ENDPOINT`` points at (requests to
it are anonymous)."""

import os
import socket
import threading
import time

import pytest


@pytest.fixture(autouse=True)
def default_knob_env(monkeypatch):
    for name in [k for k in os.environ if k.startswith("TPUSNAP_") and not k.startswith("TPUSNAP_TEST_")]:
        monkeypatch.delenv(name)
    yield
    from torchsnapshot_tpu_torch.native_io import NativeFileIO

    native = NativeFileIO._instance
    if native is not None and native.direct_io_mode() != 0:
        native.configure_direct_io(False)


@pytest.fixture
def no_leaked_threads():
    before = set(threading.enumerate())
    yield
    leaked = [t.name for t in threading.enumerate() if t not in before]
    assert leaked == [], f"threads left alive: {leaked}"


def wait_for_threads(before, timeout_s: float = 5.0) -> None:
    """Wait, at most ``timeout_s``, until no thread outside ``before`` is
    alive (a stopped server's handler threads end once their sockets do)."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if all(t in before for t in threading.enumerate()):
            return
        time.sleep(0.005)


def stop_server(server) -> None:
    """``server.stop()`` without waiting out ``serve_forever``'s 0.5 s poll:
    a connection made once the stop is requested wakes its ``select``, so a
    test does not sit idle in its teardown."""
    stopper = threading.Thread(target=server.stop)
    stopper.start()
    while stopper.is_alive():
        try:
            socket.create_connection(("127.0.0.1", server.port), timeout=1).close()
        except OSError:
            pass  # already closed
        stopper.join(0.01)


@pytest.fixture
def s3_server(no_leaked_threads, monkeypatch):
    from fake_s3 import FakeS3Server

    before = set(threading.enumerate())
    server = FakeS3Server()
    monkeypatch.setenv("TPUSNAP_S3_ENDPOINT", server.endpoint)
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", "test-access-key")
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "test-secret-key")
    monkeypatch.setenv("TPUSNAP_RETRY_BASE_S", "0.001")
    yield server
    stop_server(server)
    wait_for_threads(before)


@pytest.fixture
def s3_plugin(s3_server):
    """``make(root="bkt/pre")``: a port S3 plugin on the fake server,
    closed at teardown."""
    from torchsnapshot_tpu_torch.storage_plugins.s3 import S3StoragePlugin

    plugins = []

    def make(root: str = "bkt/pre"):
        plugin = S3StoragePlugin(root=root)
        plugins.append(plugin)
        return plugin

    yield make
    for plugin in plugins:
        plugin.sync_close()


@pytest.fixture
def gcs_server(no_leaked_threads, monkeypatch):
    from fake_gcs import FakeGCSServer

    before = set(threading.enumerate())
    server = FakeGCSServer()
    monkeypatch.setenv("TPUSNAP_GCS_ENDPOINT", server.endpoint)
    monkeypatch.setenv("TPUSNAP_RETRY_BASE_S", "0.001")
    yield server
    stop_server(server)
    wait_for_threads(before)


@pytest.fixture
def gcs_plugin(gcs_server):
    """``make(root="bkt/pre")``: a port GCS plugin on the fake server,
    closed at teardown."""
    from torchsnapshot_tpu_torch.storage_plugins.gcs import GCSStoragePlugin

    plugins = []

    def make(root: str = "bkt/pre"):
        plugin = GCSStoragePlugin(root=root)
        plugins.append(plugin)
        return plugin

    yield make
    for plugin in plugins:
        plugin.sync_close()
