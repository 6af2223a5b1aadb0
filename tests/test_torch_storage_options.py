"""Per-call storage_options of the port: mirrors of the 5 tests of
tests/test_storage_options.py (two plugins on different endpoints in one
process, takes and async takes with options, unknown keys refused, the
URL aliases), and the resolver held against the JAX package's: ``fs`` and
``memory`` refuse an unknown key with the same ValueError, ``faults`` is
popped before the plugin sees the options, ``gs`` normalises to ``gcs``,
and the same bad option fails the same ``Snapshot.take`` in both; an
unknown gcs option is refused with the JAX package's ValueError by both."""

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch import Snapshot, StateDict
from torchsnapshot_tpu_torch.io_types import ReadIO, WriteIO
from torchsnapshot_tpu_torch.storage_plugin import PROTOCOL_ALIASES, parse_url, url_to_storage_plugin

from torch_env import default_knob_env, no_leaked_threads, stop_server, wait_for_threads  # noqa: F401  fixtures

pytestmark = pytest.mark.usefixtures("no_leaked_threads")


@pytest.fixture()
def two_s3_servers(no_leaked_threads, monkeypatch):  # noqa: F811
    import threading

    from fake_s3 import FakeS3Server

    before = set(threading.enumerate())
    # A poisoned env endpoint proves the options override wins.
    monkeypatch.setenv("TPUSNAP_S3_ENDPOINT", "http://127.0.0.1:1")
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", "k")
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "s")
    a, b = FakeS3Server(), FakeS3Server()
    yield a, b
    stop_server(a)
    stop_server(b)
    wait_for_threads(before)


def test_two_endpoints_one_process(two_s3_servers):
    a, b = two_s3_servers
    plug_a = url_to_storage_plugin("s3://bkt/x", storage_options={"endpoint": a.endpoint})
    plug_b = url_to_storage_plugin("s3://bkt/x", storage_options={"endpoint": b.endpoint})
    try:
        plug_a.sync_write(WriteIO(path="p", buf=b"from-a"))
        plug_b.sync_write(WriteIO(path="p", buf=b"from-b"))
        ra, rb = ReadIO(path="p"), ReadIO(path="p")
        plug_a.sync_read(ra)
        plug_b.sync_read(rb)
        assert bytes(ra.buf) == b"from-a"
        assert bytes(rb.buf) == b"from-b"
    finally:
        plug_a.sync_close()
        plug_b.sync_close()


def test_snapshot_take_restore_with_options(two_s3_servers):
    a, _ = two_s3_servers
    opts = {"endpoint": a.endpoint}
    w = torch.arange(256, dtype=torch.float32)
    snapshot = Snapshot.take("s3://bkt/snap", {"m": StateDict({"w": w})}, storage_options=opts)
    dst = {"m": StateDict({"w": torch.zeros(256)})}
    snapshot.restore(dst)
    assert torch.equal(dst["m"]["w"], w)
    reopened = Snapshot("s3://bkt/snap", storage_options=opts)
    assert any("w" in k for k in reopened.get_manifest())
    assert any(k.startswith("bkt/snap/") for k in a.objects)


def test_async_take_with_options(two_s3_servers):
    _, b = two_s3_servers
    opts = {"endpoint": b.endpoint}
    pending = Snapshot.async_take("s3://bkt/asnap", {"m": StateDict({"w": torch.full((64,), 7.0)})}, storage_options=opts)
    snapshot = pending.wait()
    dst = {"m": StateDict({"w": torch.zeros(64)})}
    snapshot.restore(dst)
    assert torch.equal(dst["m"]["w"], torch.full((64,), 7.0))


def test_unknown_option_rejected():
    with pytest.raises(ValueError, match="storage_options"):
        url_to_storage_plugin("s3://bkt/x", storage_options={"bogus": 1})
    with pytest.raises(ValueError, match="storage_options"):
        url_to_storage_plugin("/tmp/x", storage_options={"bogus": 1})
    with pytest.raises(ValueError, match="storage_options"):
        url_to_storage_plugin("memory://x", storage_options={"bogus": 1})
    from torchsnapshot_tpu.storage_plugin import url_to_storage_plugin as jax_url_to_storage_plugin

    messages = []
    for resolve in (url_to_storage_plugin, jax_url_to_storage_plugin):
        with pytest.raises(ValueError, match=r"Unknown gcs storage_options: \['bogus'\]") as excinfo:
            resolve("gs://bkt/x", storage_options={"bogus": 1})
        messages.append(str(excinfo.value))
    assert messages[0] == messages[1]


def test_parse_url_aliases():
    assert parse_url("gs://bkt/p") == ("gcs", "bkt/p")
    assert parse_url("gcs://bkt/p") == ("gcs", "bkt/p")
    assert parse_url("/local/path") == ("fs", "/local/path")
    assert parse_url("://odd") == ("fs", "odd")
    assert PROTOCOL_ALIASES["gs"] == "gcs"


# ------------------------------------------------ against the JAX package


def _resolvers():
    from torchsnapshot_tpu import storage_plugin as jax_resolver
    from torchsnapshot_tpu_torch import storage_plugin as port_resolver

    return {"jax": jax_resolver, "port": port_resolver}


def test_fs_and_memory_refuse_unknown_keys_as_the_jax_package_does(tmp_path):
    for url in (str(tmp_path / "x"), f"fs://{tmp_path / 'x'}", "memory://x"):
        messages = {}
        for name, resolver in _resolvers().items():
            with pytest.raises(ValueError) as excinfo:
                resolver.url_to_storage_plugin(url, storage_options={"endpoint": "http://a"})
            messages[name] = str(excinfo.value)
        assert messages["port"] == messages["jax"], url


def test_faults_is_popped_before_the_plugin_in_both(tmp_path):
    """``faults`` is the resolver's key: fs, which refuses every other key,
    never sees it, and the plugin comes back wrapped by the injector."""
    for name, resolver in _resolvers().items():
        plugin = resolver.url_to_storage_plugin(str(tmp_path / name), storage_options={"faults": "none"})
        try:
            assert type(plugin).__name__ == "FaultyStoragePlugin", name
        finally:
            plugin.sync_close()
        with pytest.raises(ValueError, match="fs accepts no storage_options"):
            resolver.url_to_storage_plugin(str(tmp_path / name), storage_options={"faults": "none", "bogus": 1})


def test_parse_url_equals_the_jax_package():
    resolvers = _resolvers()
    for url in ("gs://bkt/p", "gcs://bkt/p", "s3://bkt/p", "memory://m", "/a/b", "://odd", "fs://c"):
        assert resolvers["port"].parse_url(url) == resolvers["jax"].parse_url(url), url
    assert resolvers["port"].PROTOCOL_ALIASES == resolvers["jax"].PROTOCOL_ALIASES


def test_same_bad_option_fails_the_same_take_in_both(tmp_path):
    import torchsnapshot_tpu as jax_ts

    with pytest.raises(ValueError, match="fs accepts no storage_options"):
        jax_ts.Snapshot.take(
            str(tmp_path / "jax"),
            {"m": jax_ts.StateDict({"w": np.ones(4, np.float32)})},
            storage_options={"endpoint": "http://a"},
        )
    with pytest.raises(ValueError, match="fs accepts no storage_options"):
        Snapshot.take(str(tmp_path / "port"), {"m": StateDict({"w": torch.ones(4)})}, storage_options={"endpoint": "http://a"})
    assert not (tmp_path / "port" / ".snapshot_metadata").exists()
