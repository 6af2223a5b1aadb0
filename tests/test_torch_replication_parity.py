"""Replication across the two packages: the port's ``copy_snapshot`` of a
snapshot the JAX package wrote, and the JAX package's ``copy_snapshot`` of
one the port wrote, over fs → fs (hard links, and streamed), fs → s3,
s3 → s3 and gs → gs (server-side within a bucket), and a journal segment
with its replay chain.  Both packages copy the same source; the two
replicas must hold the same files with the same bytes, and each replica
restores bit-exact through both packages.  Inputs are made from seeded
numpy generators and fed to both packages."""

import os

import numpy as np
import pytest
import torch

import torchsnapshot_tpu_torch as ts
from torchsnapshot_tpu import Snapshot as JaxSnapshot
from torchsnapshot_tpu import StateDict as JaxStateDict
from torchsnapshot_tpu import copy_snapshot as jax_copy_snapshot
from torchsnapshot_tpu.manager import SnapshotManager as JaxManager
from torchsnapshot_tpu_torch import knobs
from torchsnapshot_tpu_torch.serialization import state_from_numpy

from torch_env import default_knob_env, gcs_server, no_leaked_threads, s3_server  # noqa: F401  fixtures

pytestmark = pytest.mark.usefixtures("no_leaked_threads")

# route -> (source url, destination url of each package's copy, copy kwargs)
ROUTES = {
    "fs_link": ("{tmp}/src", "{tmp}/{pkg}", {}),
    "fs_stream": ("{tmp}/src", "{tmp}/{pkg}", {"force_stream": True}),
    "fs_to_s3": ("{tmp}/src", "s3://bkt/{pkg}", {}),
    "s3_to_s3": ("s3://bkt/src", "s3://bkt/{pkg}", {}),
    "gs_to_gs": ("gs://bkt/src", "gs://bkt/{pkg}", {}),
    "journal_chain": ("{tmp}/src/seg_3", "{tmp}/{pkg}/seg_3", {}),
}


def _state(step=11):
    rng = np.random.default_rng(7)
    return {
        "w": rng.standard_normal((500, 200)).astype(np.float32),
        "b": rng.standard_normal(64).astype(np.float32),
        "opt": np.full(4096, float(step), np.float32),
        "step": step,
    }


def _tree(url, servers):
    """{relative name: bytes} of every object under ``url``."""
    if "://" in url:
        scheme, path = url.split("://", 1)
        objects = servers[scheme].objects
        return {k[len(path) + 1 :]: bytes(v) for k, v in objects.items() if k.startswith(path + "/")}
    out = {}
    for dirpath, _, files in os.walk(url):
        for fname in files:
            full = os.path.join(dirpath, fname)
            with open(full, "rb") as f:
                out[os.path.relpath(full, url)] = f.read()
    return out


def _write_source(writer, route, src):
    if route == "journal_chain":
        root = src.rsplit("/", 1)[0]
        with knobs.override_journal(True), knobs.override_sidecar(False):
            for step in (1, 2, 3):
                if writer == "port":
                    ts.SnapshotManager(root).save(step, {"m": ts.StateDict(state_from_numpy(_state(step)))})
                else:
                    JaxManager(root).save(step, {"m": JaxStateDict(_state(step))})
        return
    with knobs.override_sidecar(False):
        if writer == "port":
            ts.Snapshot.take(src, {"m": ts.StateDict(state_from_numpy(_state()))})
        else:
            JaxSnapshot.take(src, {"m": JaxStateDict(_state())})


def _assert_restores_through_both(route, dst):
    want = _state(3 if route == "journal_chain" else 11)
    zeros = {k: np.zeros_like(v) if isinstance(v, np.ndarray) else -1 for k, v in want.items()}
    port_dst = ts.StateDict(state_from_numpy(dict(zeros)))
    ptrs = {k: v.data_ptr() for k, v in port_dst.items() if isinstance(v, torch.Tensor)}
    jax_dst = JaxStateDict(dict(zeros))
    if route == "journal_chain":
        root = dst.rsplit("/", 1)[0]
        assert ts.SnapshotManager(root).restore_latest({"m": port_dst}) == 3
        assert JaxManager(root).restore_latest({"m": jax_dst}) == 3
    else:
        ts.Snapshot(dst).restore({"m": port_dst})
        JaxSnapshot(dst).restore({"m": jax_dst})
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert port_dst[k].data_ptr() == ptrs[k]
            assert port_dst[k].numpy().tobytes() == v.tobytes(), k
            assert np.asarray(jax_dst[k]).tobytes() == v.tobytes(), k
        else:
            assert port_dst[k] == v and jax_dst[k] == v, k


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_both_packages_copy_one_source_alike(tmp_path, route, writer, request):
    servers = {}
    if "s3" in route:
        servers["s3"] = request.getfixturevalue("s3_server")
    if "gs" in route:
        servers["gs"] = request.getfixturevalue("gcs_server")
    src_t, dst_t, kwargs = ROUTES[route]
    src = src_t.format(tmp=tmp_path)
    _write_source(writer, route, src)
    dsts = {pkg: dst_t.format(tmp=tmp_path, pkg=pkg) for pkg in ("port", "jax")}
    copies_before = sum(server.copies for server in servers.values())
    ts.copy_snapshot(src, dsts["port"], verify=True, **kwargs)
    jax_copy_snapshot(src, dsts["jax"], verify=True, **kwargs)
    if route == "journal_chain":
        trees = {pkg: _tree(url.rsplit("/", 1)[0], servers) for pkg, url in dsts.items()}
        assert {"step_1/.snapshot_metadata", "seg_2/.snapshot_metadata", "seg_3/.snapshot_metadata"} <= set(trees["port"])
    else:
        trees = {pkg: _tree(url, servers) for pkg, url in dsts.items()}
        source = _tree(src, servers)
        assert trees["port"] == {k: v for k, v in source.items() if not k.startswith("telemetry/")}
    assert trees["port"] == trees["jax"]
    if route in ("s3_to_s3", "gs_to_gs"):
        payloads = len(trees["port"]) - 1  # all but the marker went server-side
        assert sum(server.copies for server in servers.values()) - copies_before == 2 * payloads
    if route in ("fs_link", "fs_stream"):
        for pkg, dst in dsts.items():
            payloads = [n for n in trees[pkg] if not n.startswith(".")]
            linked = {os.stat(os.path.join(dst, n)).st_ino == os.stat(os.path.join(src, n)).st_ino for n in payloads}
            assert linked == {route == "fs_link"}, pkg
    for dst in dsts.values():
        _assert_restores_through_both(route, dst)
