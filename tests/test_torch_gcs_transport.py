"""The standard-library transport of the port's GCS plugin, against the
in-repo fake server (tests/fake_gcs.py): one connection per worker thread
and none left after ``close()``; no ``requests``, ``google.resumable_media``
or ``google.auth`` needed with an endpoint; an empty object finalized by one
``bytes */0`` PUT; and, without an endpoint, a refusal to start without
``google.auth``, else the credentials' bearer token on every request,
refreshed once it expires.  Payloads are made from seeded numpy
generators."""

import datetime
import importlib
import sys

import numpy as np
import pytest

from torchsnapshot_tpu_torch.io_types import ReadIO, WriteIO
from torchsnapshot_tpu_torch.storage_plugins import gcs as gcs_mod
from torchsnapshot_tpu_torch.storage_plugins.gcs import GCSStoragePlugin

from torch_env import default_knob_env, gcs_plugin, gcs_server, no_leaked_threads  # noqa: F401  fixtures

pytestmark = pytest.mark.usefixtures("no_leaked_threads")


def _bytes(n: int, seed: int = 0) -> bytes:
    return np.random.RandomState(seed).randint(0, 256, size=n, dtype=np.uint8).tobytes()


def test_one_connection_per_thread_and_none_after_close(gcs_server, gcs_plugin):
    """Sequential requests reuse the worker thread's connection; close()
    joins both pools and closes every connection it opened."""
    plugin = gcs_plugin()
    for i in range(6):
        plugin.sync_write(WriteIO(path=f"o{i}", buf=_bytes(1024, seed=i)))
        read_io = ReadIO(path=f"o{i}")
        plugin.sync_read(read_io)
        assert bytes(read_io.buf) == _bytes(1024, seed=i)
    assert 1 <= len(plugin._conns) <= 2
    conns = list(plugin._conns)
    plugin.sync_close()
    assert plugin._conns == [] and all(c.sock is None for c in conns)


def test_plugin_runs_without_requests_or_google_packages(gcs_server, monkeypatch):
    """The card's machine has no ``requests``, ``google-resumable-media`` or
    ``google-auth``: with an endpoint the plugin needs none of them."""
    import torchsnapshot_tpu_torch.storage_plugins as plugins_pkg

    name = "torchsnapshot_tpu_torch.storage_plugins.gcs"
    for blocked in ("requests", "google.resumable_media", "google.auth", "google.auth.transport.requests"):
        monkeypatch.setitem(sys.modules, blocked, None)
    monkeypatch.delitem(sys.modules, name)  # put back at teardown
    monkeypatch.setattr(plugins_pkg, "gcs", gcs_mod)
    fresh = importlib.import_module(name)
    assert fresh is not gcs_mod
    plugin = fresh.GCSStoragePlugin("bkt/no-google")
    try:
        payload = _bytes(300 * 1024)
        plugin.sync_write(WriteIO(path="p.bin", buf=payload))
        read_io = ReadIO(path="p.bin")
        plugin.sync_read(read_io)
        assert bytes(read_io.buf) == payload
    finally:
        plugin.sync_close()


def test_empty_object_finalizes_with_bytes_star_zero(gcs_server, gcs_plugin):
    """An empty object's upload is one ``Content-Range: bytes */0`` PUT that
    GCS answers 200 (answered here for the fake, which reads it as a
    recovery probe and answers 308; unanswered, the plugin raises naming
    the upload instead of probing forever).  It reads back empty."""
    plugin = gcs_plugin(root="bkt")
    with pytest.raises(RuntimeError, match="did not finalize the upload of e.bin"):
        plugin.sync_write(WriteIO(path="e.bin", buf=b""))
    request = plugin._request
    finals = []

    def gcs_answer(method, url, body=None, headers=None):
        if method == "PUT" and (headers or {}).get("Content-Range") == "bytes */0":
            finals.append(url)
            gcs_server.objects["bkt/e.bin"] = b""
            return gcs_mod._Response(200, {}, b"{}")
        return request(method, url, body, headers)

    plugin._request = gcs_answer
    plugin.sync_write(WriteIO(path="e.bin", buf=b""))
    assert len(finals) == 1 and gcs_server.chunk_puts == 0
    read_io = ReadIO(path="e.bin")
    plugin.sync_read(read_io)
    assert bytes(read_io.buf) == b""


def test_no_endpoint_without_google_auth_refuses_to_start(monkeypatch):
    """No endpoint and no google-auth: a RuntimeError naming the package,
    never an anonymous request to the public endpoint."""
    import google.auth
    import google.auth.exceptions

    monkeypatch.setitem(sys.modules, "google.auth", None)
    with pytest.raises(RuntimeError, match="google-auth package, which is not installed"):
        GCSStoragePlugin("bkt/pre")

    def no_credentials(*args, **kwargs):
        raise google.auth.exceptions.DefaultCredentialsError("none here")

    monkeypatch.setitem(sys.modules, "google.auth", google.auth)
    monkeypatch.setattr(google.auth, "default", no_credentials)
    with pytest.raises(RuntimeError, match="google.auth.default failed: none here"):
        GCSStoragePlugin("bkt/pre")


def _utcnow() -> datetime.datetime:
    # google.auth compares naive UTC expiries.
    return datetime.datetime.now(datetime.timezone.utc).replace(tzinfo=None)


def test_no_endpoint_sends_the_bearer_token_and_refreshes_it(gcs_server, monkeypatch):
    """With application-default credentials every request carries
    ``Authorization: Bearer``; an expired token is refreshed first."""
    import google.auth
    import google.auth.credentials

    class _Credentials(google.auth.credentials.Credentials):
        def __init__(self):
            super().__init__()
            self.refreshes = 0

        def refresh(self, request):
            assert callable(request)  # the plugin's http.client transport
            self.refreshes += 1
            self.token = f"token-{self.refreshes}"
            self.expiry = _utcnow() + datetime.timedelta(hours=1)

    credentials = _Credentials()
    monkeypatch.setattr(google.auth, "default", lambda *a, **k: (credentials, "project"))
    monkeypatch.delenv("TPUSNAP_GCS_ENDPOINT")
    # The public bases, pointed at the fake.
    monkeypatch.setattr(gcs_mod, "_UPLOAD_BASE", gcs_server.endpoint)
    monkeypatch.setattr(gcs_mod, "_DOWNLOAD_BASE", gcs_server.endpoint)
    plugin = GCSStoragePlugin("bkt/auth")
    seen = []
    authorize = plugin._authorize

    def spy(method, url, headers):
        authorize(method, url, headers)
        seen.append(headers.get("authorization"))

    plugin._authorize = spy
    try:
        plugin.sync_write(WriteIO(path="a.bin", buf=b"payload"))
        assert credentials.refreshes == 1 and set(seen) == {"Bearer token-1"}
        credentials.expiry = _utcnow() - datetime.timedelta(seconds=1)
        read_io = ReadIO(path="a.bin")
        plugin.sync_read(read_io)
        assert bytes(read_io.buf) == b"payload"
        assert credentials.refreshes == 2 and seen[-1] == "Bearer token-2"
    finally:
        plugin.sync_close()
    assert gcs_server.objects["bkt/auth/a.bin"] == b"payload"
