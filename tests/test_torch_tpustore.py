"""The native TCP store of torchsnapshot_tpu_torch (``tpustore.py`` over
``_native/tpustore.cc``).

Mirror of tests/test_tpustore.py's store cases.  Every single-process case
runs on each pairing of server and client across the two packages
(port/port, port server with the JAX client, JAX server with the port
client): the wire protocol is the JAX package's, byte for byte.
"""

import os
import threading
import time

import pytest

from torchsnapshot_tpu_torch import knobs
from torchsnapshot_tpu_torch.test_utils import run_with_procs

from torch_env import default_knob_env  # noqa: F401  autouse fixture

PAIRINGS = ["port-port", "port-jax", "jax-port"]


def _server_and_client_cls(pairing):
    """(TCPStoreServer, TCPStore) classes: "<server pkg>-<client pkg>"."""
    from torchsnapshot_tpu import tpustore as jax_tpustore
    from torchsnapshot_tpu_torch import tpustore as port_tpustore

    pkgs = {"port": port_tpustore, "jax": jax_tpustore}
    server_pkg, client_pkg = pairing.split("-")
    return pkgs[server_pkg].TCPStoreServer, pkgs[client_pkg].TCPStore


@pytest.fixture(params=PAIRINGS)
def server_client(request):
    server_cls, client_cls = _server_and_client_cls(request.param)
    server = server_cls()
    clients = []

    def connect():
        client = client_cls("127.0.0.1", server.port)
        clients.append(client)
        return client

    try:
        yield connect
    finally:
        for client in clients:
            client.close()
        server.stop()


def test_server_client_basics(server_client):
    client = server_client()
    client.set("k1", b"hello")
    assert client.get("k1", timeout_s=5) == b"hello"
    assert client.try_get("k1") == b"hello"
    assert client.try_get("missing") is None
    assert client.add("counter", 3) == 3
    assert client.add("counter", 4) == 7
    assert client.add("counter", 0) == 7
    with pytest.raises(TimeoutError):
        client.get("never", timeout_s=0.2)


def test_blocking_get_wakes_on_set(server_client):
    waiter, setter = server_client(), server_client()
    result = {}

    def _wait():
        result["value"] = waiter.get("slow_key", timeout_s=10)

    t = threading.Thread(target=_wait)
    t.start()
    time.sleep(0.1)
    setter.set("slow_key", b"payload")
    t.join(timeout=5)
    assert result["value"] == b"payload"


def test_large_value(server_client):
    client = server_client()
    blob = os.urandom(4 << 20)  # a manifest-sized object
    client.set("big", blob)
    assert client.get("big", timeout_s=10) == blob


def test_concurrent_threads_no_value_clobber(server_client):
    """One client shared by threads: each op checks out its own
    connection, so request/value pairs never mix."""
    store = server_client()
    errors = []

    def _hammer(tid):
        try:
            for i in range(200):
                payload = (f"thread{tid}-iter{i}-" * 20).encode()
                store.set(f"t{tid}/{i}", payload)
                assert store.get(f"t{tid}/{i}", timeout_s=10) == payload
                assert store.try_get(f"t{tid}/{i}") == payload
                assert store.add(f"ctr{tid}", 1) == i + 1
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=_hammer, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors


def test_blocking_get_does_not_convoy_other_threads(server_client):
    store = server_client()
    blocked = threading.Event()

    def _block():
        blocked.set()
        with pytest.raises(TimeoutError):
            store.get("never_set", timeout_s=2.0)

    t = threading.Thread(target=_block)
    t.start()
    blocked.wait(timeout=5)
    time.sleep(0.05)  # the GET reaches the server and parks on the CV
    t0 = time.monotonic()
    store.set("quick", b"v")
    assert store.get("quick", timeout_s=5) == b"v"
    elapsed = time.monotonic() - t0
    t.join(timeout=10)
    assert elapsed < 1.0, f"ops convoyed behind a blocking GET: {elapsed:.2f}s"


def test_delete_prefix(server_client):
    client = server_client()
    client.set("gen/3/a", b"x")
    client.set("gen/3/b", b"y")
    client.set("gen/30/a", b"keep")  # "gen/3/" must not match "gen/30/"
    client.set("other", b"keep")
    assert client.delete_prefix("gen/3/") == 2
    assert client.try_get("gen/3/a") is None
    assert client.try_get("gen/3/b") is None
    assert client.try_get("gen/30/a") == b"keep"
    assert client.try_get("other") == b"keep"
    assert client.delete_prefix("gen/3/") == 0


def test_native_library_abi_and_exports():
    """The store lives in the same library as the file I/O, whose ABI
    generation went to 2 with the store's exports and to 3 with the zstd
    and content-defined chunking exports."""
    import ctypes

    from torchsnapshot_tpu_torch._native.build import get_native_lib_path
    from torchsnapshot_tpu_torch.native_io import NATIVE_ABI_VERSION

    lib = ctypes.CDLL(get_native_lib_path())
    assert lib.tpusnap_abi_version() == NATIVE_ABI_VERSION == 3
    for name in (
        "tpusnap_cdc_boundaries",
        "tpusnap_has_zstd",
        "tpusnap_zstd_encode",
        "tpusnap_zstd_encode2",
        "tpusnap_zstd_decode",
        "tpustore_server_start",
        "tpustore_server_port",
        "tpustore_server_stop",
        "tpustore_client_connect",
        "tpustore_client_set",
        "tpustore_client_get",
        "tpustore_client_tryget",
        "tpustore_client_add",
        "tpustore_client_ping",
        "tpustore_client_delete_prefix",
        "tpustore_client_value_len",
        "tpustore_client_value",
        "tpustore_client_close",
    ):
        assert hasattr(lib, name), name


@run_with_procs(nproc=4)
def _tcpstore_pg_body():
    """PGWrapper collectives over the native TCP store, one server per
    job."""
    from torchsnapshot_tpu_torch.dist_store import FileStore
    from torchsnapshot_tpu_torch.pg_wrapper import PGWrapper
    from torchsnapshot_tpu_torch.tpustore import TCPStore, TCPStoreServer

    rank = knobs.get_env_rank()
    world_size = knobs.get_env_world_size()
    bootstrap = FileStore(knobs.get_store_path())
    if rank == 0:
        server = TCPStoreServer()
        bootstrap.set("addr", f"127.0.0.1:{server.port}".encode())
    addr = bootstrap.get("addr", timeout_s=30).decode()
    host, _, port = addr.rpartition(":")
    store = TCPStore(host, int(port))
    pg = PGWrapper(store=store, rank=rank, world_size=world_size)

    assert pg.all_gather_object(rank * rank) == [0, 1, 4, 9]
    pg.barrier()
    objs = ["cfg"] if rank == 0 else [None]
    pg.broadcast_object_list(objs, src=0)
    assert objs[0] == "cfg"

    bootstrap.add("done", 1)
    if rank == 0:
        i = 0
        while bootstrap.add("done", 0) < world_size:
            bootstrap.wait_hint(i)
            i += 1
        server.stop()


def test_tcpstore_collectives_multiprocess():
    _tcpstore_pg_body()
