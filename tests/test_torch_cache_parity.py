"""One host cache directory, two packages: torchsnapshot_tpu and
torchsnapshot_tpu_torch read through and populate the same cache.

For a plain root and a content-addressed root, in both directions: one
package's restore populates the cache and the other's restore then reads
no origin payload byte, bit-exact; one package's ``warm_snapshot`` is
100% resident to the other's ``residency``.  A range-keyed entry written
by one package serves the other.  Both packages write the same keys, data
files and ``.meta`` JSON, and give the same ``snapshot_fingerprint`` of
one commit marker.  Inputs are numpy arrays from a seed."""

import json
import os
import threading

import numpy as np
import pytest
import torch

import torchsnapshot_tpu as jax_pkg
import torchsnapshot_tpu_torch as port_pkg
from torchsnapshot_tpu import cache as jax_cache
from torchsnapshot_tpu import cas as jax_cas
from torchsnapshot_tpu import faults as jax_faults
from torchsnapshot_tpu.storage_plugin import url_to_storage_plugin as jax_url_to_storage_plugin
from torchsnapshot_tpu_torch import cache as port_cache
from torchsnapshot_tpu_torch import cas as port_cas
from torchsnapshot_tpu_torch import faults as port_faults
from torchsnapshot_tpu_torch import knobs
from torchsnapshot_tpu_torch.io_types import ReadIO
from torchsnapshot_tpu_torch.serialization import state_from_numpy
from torchsnapshot_tpu_torch.storage_plugin import url_to_storage_plugin as port_url_to_storage_plugin

from torch_env import default_knob_env, no_leaked_threads, wait_for_threads  # noqa: F401  fixtures

PKGS = {
    "jax": (jax_pkg, jax_cache, jax_cas, jax_faults, jax_url_to_storage_plugin),
    "port": (port_pkg, port_cache, port_cas, port_faults, port_url_to_storage_plugin),
}
ORDERS = [("jax", "port"), ("port", "jax")]
ROOTS = ["plain", "cas"]


@pytest.fixture(autouse=True)
def reader_pools_joined(no_leaked_threads):
    """The JAX package's cache reader shuts its pool down without waiting
    for it: give those threads their few milliseconds to end before
    ``no_leaked_threads`` looks."""
    before = set(threading.enumerate())
    yield
    wait_for_threads(before)


def _arrays():
    rng = np.random.default_rng(14)
    return {
        "w": rng.standard_normal((512, 256)).astype(np.float32),
        "emb": rng.standard_normal((1024, 64)).astype(np.float32),
        "b": rng.standard_normal(512).astype(np.float32),
        "norm": np.ones(256, np.float32),
        "step": 7,
    }


def _app_state(pkg, arrays):
    if pkg == "port":
        return {"m": port_pkg.StateDict(state_from_numpy(dict(arrays)))}
    return {"m": jax_pkg.StateDict(dict(arrays))}


def _take(pkg, tmp_path, root_kind):
    """The snapshot path of a take by ``pkg``: a plain step, or a step of a
    content-addressed root."""
    path = str(tmp_path / "root" / "step_1")
    with knobs.override_cas(root_kind == "cas"):
        PKGS[pkg][0].Snapshot.take(path, _app_state(pkg, _arrays()))
    return path


def _payload_read_bytes(pkg) -> int:
    return sum(
        nbytes
        for path, nbytes in PKGS[pkg][3].read_counters().items()
        if not path.rsplit("/", 1)[-1].startswith(".") and not path.startswith("telemetry/")
    )


def _restore(pkg, path):
    """Restore ``path`` through ``pkg`` into zeroed targets; bit-exact.
    Returns the origin payload bytes the restore read."""
    want = _arrays()
    zeros = {k: np.zeros_like(v) if isinstance(v, np.ndarray) else -1 for k, v in want.items()}
    dst = _app_state(pkg, zeros)
    PKGS[pkg][3].reset_read_counters()
    PKGS[pkg][0].Snapshot(path).restore(dst)
    origin = _payload_read_bytes(pkg)
    for k, v in want.items():
        got = dst["m"][k]
        if isinstance(v, np.ndarray):
            got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
            assert got.tobytes() == v.tobytes(), k
        else:
            assert got == v, k
    return origin


def _cache_files(cache_dir):
    """{relative path: bytes} of every data and ``.meta`` file."""
    out = {}
    for dirpath, _, files in os.walk(os.path.join(cache_dir, "objects")):
        for name in files:
            if name.endswith(".lock") or ".tmp." in name:
                continue
            full = os.path.join(dirpath, name)
            with open(full, "rb") as f:
                out[os.path.relpath(full, cache_dir)] = f.read()
    return out


@pytest.mark.parametrize("root_kind", ROOTS)
@pytest.mark.parametrize("first,second", ORDERS)
def test_one_package_populates_the_other_reads_no_origin_byte(tmp_path, first, second, root_kind):
    path = _take(first, tmp_path, root_kind)
    with knobs.override_cache_dir(str(tmp_path / "cache")), knobs.override_faults("none"):
        assert _restore(first, path) > 0
        assert _restore(second, path) == 0


@pytest.mark.parametrize("root_kind", ROOTS)
@pytest.mark.parametrize("first,second", ORDERS)
def test_warm_by_one_package_is_resident_to_the_other(tmp_path, first, second, root_kind):
    path = _take(first, tmp_path, root_kind)
    cache_dir = str(tmp_path / "cache")
    pkg, cache_mod, cas_mod, _, url_to_storage_plugin = PKGS[first]
    md = pkg.Snapshot(path).metadata
    with knobs.override_cache_dir(cache_dir):
        storage = cache_mod.maybe_wrap_cache_reads(
            cas_mod.maybe_wrap_cas_reads(url_to_storage_plugin(path), path, md), md
        )
        try:
            warmed = cache_mod.warm_snapshot(storage, md)
        finally:
            storage.sync_close()
    assert warmed["misses"] == warmed["locations"] > 0
    other, other_cache = PKGS[second][0], PKGS[second][1]
    other_md = other.Snapshot(path).metadata
    got = other_cache.residency(
        other_cache.CacheStore(cache_dir), other_md, other_cache.snapshot_fingerprint(other_md)
    )
    assert got["resident"] == got["locations"] == warmed["locations"]
    assert got["bytes_resident"] == got["bytes_total"] > 0
    with knobs.override_cache_dir(cache_dir), knobs.override_faults("none"):
        assert _restore(second, path) == 0


@pytest.mark.parametrize("first,second", ORDERS)
def test_range_keyed_entry_serves_the_other_package(tmp_path, first, second):
    payload = np.random.RandomState(2).bytes(1 << 16)
    origin = tmp_path / "origin"
    origin.mkdir()
    (origin / "piece").write_bytes(payload)
    cache_dir = str(tmp_path / "cache")
    for pkg, want_origin in ((first, 4096), (second, 0)):
        _, cache_mod, _, faults_mod, url_to_storage_plugin = PKGS[pkg]
        faults_mod.reset_read_counters()
        reader = cache_mod.CacheReaderPlugin(
            inner=url_to_storage_plugin(str(origin), {"faults": "none"}),
            store=cache_mod.CacheStore(cache_dir),
            namespace="ns",
        )
        read_io = ReadIO(path="piece", byte_range=[4096, 8192])
        try:
            reader.sync_read(read_io)
        finally:
            reader.sync_close()
        assert bytes(read_io.buf) == payload[4096:8192]
        assert faults_mod.total_read_bytes() == want_origin, pkg
    key = port_cache.keys_for("ns", "piece", [4096, 8192])[0]
    assert key == "obj/ns/piece@4096-8192"
    assert port_cache.CacheStore(cache_dir).resident_nbytes(key) == 4096


@pytest.mark.parametrize("root_kind", ROOTS)
def test_both_packages_write_the_same_entries(tmp_path, root_kind):
    """Each package restores the same snapshot into its own cache
    directory: the same files, data and ``.meta`` JSON byte for byte."""
    path = _take("jax", tmp_path, root_kind)
    dirs = {}
    for pkg in ("jax", "port"):
        dirs[pkg] = str(tmp_path / f"cache_{pkg}")
        with knobs.override_cache_dir(dirs[pkg]):
            _restore(pkg, path)
    jax_files, port_files = _cache_files(dirs["jax"]), _cache_files(dirs["port"])
    assert jax_files and sorted(jax_files) == sorted(port_files)
    assert jax_files == port_files
    metas = [k for k in port_files if k.endswith(".meta")]
    keys = {json.loads(port_files[k])["key"] for k in metas}
    prefix = "cas/" if root_kind == "cas" else "obj/"
    assert all(k.startswith(prefix) for k in keys), keys


def test_keys_and_fingerprints_agree(tmp_path):
    paths = {kind: _take("port", tmp_path / kind, kind) for kind in ROOTS}
    for path in paths.values():
        jax_md, port_md = jax_pkg.Snapshot(path).metadata, port_pkg.Snapshot(path).metadata
        assert jax_cache.snapshot_fingerprint(jax_md) == port_cache.snapshot_fingerprint(port_md)
        assert jax_cache.payload_locations(jax_md) == port_cache.payload_locations(port_md)
    locations = [
        "0/m/w",
        "cas://xxh64/0123456789abcdef",
        "cas://xxh64s/fedcba9876543210",
        "casx://xxh64:aa:10,xxh64:bb:20",
    ]
    for location in locations:
        for byte_range in (None, [0, 10], [5, 9]):
            assert jax_cache.keys_for("ns", location, byte_range) == port_cache.keys_for("ns", location, byte_range)
