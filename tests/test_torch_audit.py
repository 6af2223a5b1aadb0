"""The port's integrity audit (``integrity.payload_checksums``,
``payload_referrers`` and ``audit``) held against the JAX package's.

- tests/test_native_parity.py:93 and :111 in the port's one mode (native
  hashing; the port has no pure-Python hash): a clean snapshot audits
  clean, and one flipped byte of a striped payload fails the audit;
- the payload maps equal the JAX package's over manifests that either
  package wrote: dense, slab, chunked, CAS, CDC and sharded (a 2-rank
  DTensor take in the port, a NamedSharding take in the JAX package);
- ``audit`` returns what the JAX package's returns on the same damaged
  roots: a flipped byte, a missing payload, and a missing CAS chunk that
  many slab members share (one problem line naming its referrers).

Inputs are made from seeded numpy generators and fed to both packages."""

import contextlib
import os

import numpy as np
import pytest

import torchsnapshot_tpu_torch as ts
from torchsnapshot_tpu import Snapshot as JaxSnapshot
from torchsnapshot_tpu import StateDict as JaxStateDict
from torchsnapshot_tpu import cas as jax_cas
from torchsnapshot_tpu import integrity as jax_integrity
from torchsnapshot_tpu.storage_plugin import url_to_storage_plugin as jax_url_to_storage_plugin
from torchsnapshot_tpu_torch import cas, integrity, knobs
from torchsnapshot_tpu_torch.serialization import state_from_numpy
from torchsnapshot_tpu_torch.storage_plugin import url_to_storage_plugin

from test_torch_native_parity import _state as _striped_state
from test_torch_parity import _jax_sharded_state
from test_torch_sharded import parity_take_2
from torch_env import default_knob_env, no_leaked_threads  # noqa: F401  fixtures

pytestmark = pytest.mark.usefixtures("no_leaked_threads")


def _state():
    rng = np.random.default_rng(5)
    w = rng.random((256, 64), dtype=np.float32)  # 64 KiB
    return {
        "w": w,
        "w_copy": w.copy(),  # the same bytes: one shared CAS chunk
        "b": rng.random(64, dtype=np.float32),
        **{f"tiny{i}": np.full((16,), i, np.float32) for i in range(12)},  # slab members
        "obj": {"nested": [1, "two", 3.0]},
        "step": 5,
    }


KINDS = {
    "dense": lambda: knobs.override_batching_disabled(True),
    "slab": contextlib.nullcontext,
    "chunked": lambda: _stack(knobs.override_batching_disabled(True), knobs.override_max_chunk_size_bytes(16384)),
    "cas": lambda: _stack(knobs.override_batching_disabled(True), knobs.override_cas(True)),
    "cdc": lambda: _stack(knobs.override_cas(True), knobs.override_cdc(True), knobs.override_cdc_params(1024, 4096, 16384)),
}


@contextlib.contextmanager
def _stack(*managers):
    with contextlib.ExitStack() as stack:
        for m in managers:
            stack.enter_context(m)
        yield


def _take(path, writer, state):
    if writer == "port":
        ts.Snapshot.take(path, {"m": ts.StateDict(state_from_numpy(state))})
    else:
        JaxSnapshot.take(path, {"m": JaxStateDict(state)})


def _port_audit(path):
    md = ts.Snapshot(path).metadata
    storage = cas.maybe_wrap_cas_reads(url_to_storage_plugin(path), path, md)
    try:
        return integrity.audit(storage, md)
    finally:
        storage.sync_close()


def _jax_audit(path):
    md = JaxSnapshot(path).metadata
    storage = jax_cas.maybe_wrap_cas_reads(jax_url_to_storage_plugin(path), path, md)
    try:
        return jax_integrity.audit(storage, md)
    finally:
        storage.sync_close()


def _flip(path, offset_fraction=0.5):
    with open(path, "r+b") as f:
        f.seek(int(os.path.getsize(path) * offset_fraction))
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0xFF]))


def test_audit_passes_on_a_clean_snapshot(tmp_path):
    path = str(tmp_path / "snap")
    with knobs.override_sidecar(False):
        ts.Snapshot.take(path, {"m": ts.StateDict(state_from_numpy(_striped_state()))})
    result = _port_audit(path)
    assert result[1:] == (0, 0, []) and result[0] > 0
    assert result == _jax_audit(path)


def test_audit_catches_a_flipped_byte_of_a_striped_payload(tmp_path):
    path = str(tmp_path / "snap")
    with knobs.override_sidecar(False):
        snapshot = ts.Snapshot.take(path, {"m": ts.StateDict(state_from_numpy(_striped_state()))})
    entry = snapshot.get_manifest()["0/m/big"]
    assert entry.checksum.startswith("xxh64s:")
    _flip(os.path.join(path, entry.location))
    ok, corrupt, unreadable, problems = _port_audit(path)
    assert (corrupt, unreadable) == (1, 0) and ok > 0
    assert problems[0].startswith(f"CORRUPT Checksum mismatch for {entry.location}: stored xxh64s:")
    assert (ok, corrupt, unreadable, problems) == _jax_audit(path)


@pytest.mark.parametrize("kind", [*KINDS, "sharded"])
def test_payload_maps_match_the_jax_package(tmp_path, kind, monkeypatch):
    """For a snapshot each package wrote, both packages' payload maps and
    clean audits are equal, and every payload item carries a digest."""
    for writer in ("port", "jax"):
        path = str(tmp_path / writer / "step_1")
        if kind == "sharded":
            if writer == "port":
                monkeypatch.setenv("TPUSNAP_TEST_SNAPSHOT", path)
                parity_take_2()
            else:
                JaxSnapshot.take(path, {"m": JaxStateDict(_jax_sharded_state())})
        else:
            with KINDS[kind]():
                _take(path, writer, _state())
        port_md, jax_md = ts.Snapshot(path).metadata, JaxSnapshot(path).metadata
        checksums = integrity.payload_checksums(port_md)
        assert checksums == jax_integrity.payload_checksums(jax_md), writer
        assert integrity.payload_referrers(port_md) == jax_integrity.payload_referrers(jax_md), writer
        assert checksums and None not in checksums.values()
        assert _port_audit(path) == _jax_audit(path) == (len(checksums), 0, 0, []), writer


def test_payload_maps_name_each_kind_of_payload(tmp_path, monkeypatch):
    """The kinds above really differ: slab members carry byte ranges,
    chunked tensors several chunk items under one key, CAS and CDC
    manifests chunk references, and the sharded take one item per box."""
    seen = {}
    for kind in KINDS:
        path = str(tmp_path / kind / "step_1")
        with KINDS[kind]():
            _take(path, "port", _state())
        seen[kind] = ts.Snapshot(path).metadata
    monkeypatch.setenv("TPUSNAP_TEST_SNAPSHOT", str(tmp_path / "sharded"))
    parity_take_2()
    seen["sharded"] = ts.Snapshot(str(tmp_path / "sharded")).metadata
    assert not any(br for _, br in integrity.payload_checksums(seen["dense"]))
    assert any(br for _, br in integrity.payload_checksums(seen["slab"]))
    chunked_refs = integrity.payload_referrers(seen["chunked"])
    assert sum(1 for refs in chunked_refs.values() if refs == ["0/m/w"]) == 4
    assert all(cas.is_cas_location(loc) for loc in integrity.payload_referrers(seen["cas"]))
    w_location = ts.Snapshot(str(tmp_path / "cas" / "step_1")).get_manifest()["0/m/w"].location
    assert integrity.payload_referrers(seen["cas"])[w_location] == ["0/m/w", "0/m/w_copy"]
    assert any(cas.is_casx_location(loc) for loc in integrity.payload_referrers(seen["cdc"]))
    # Each rank's box of the Shard(1) tensor lands in that rank's own slab.
    sharded_refs = integrity.payload_referrers(seen["sharded"]).values()
    assert len([r for r in sharded_refs if any(k.endswith("/m/w_f32") for k in r)]) == 2


@pytest.mark.parametrize("damage", ["flipped_byte", "missing_payload", "missing_shared_chunk"])
def test_audit_reports_damage_as_the_jax_package_does(tmp_path, damage):
    state = _state()
    if damage == "missing_shared_chunk":
        # A CAS take with slabs: all 15 tensors share the slab's chunk.
        path = str(tmp_path / "root" / "step_1")
        with knobs.override_cas(True):
            snapshot = ts.Snapshot.take(path, {"m": ts.StateDict(state_from_numpy(state))})
        location = snapshot.get_manifest()["0/m/tiny0"].location
        os.remove(os.path.join(str(tmp_path / "root"), cas.relpath_for_location(location)))
    else:
        path = str(tmp_path / "snap")
        with knobs.override_batching_disabled(True):
            snapshot = ts.Snapshot.take(path, {"m": ts.StateDict(state_from_numpy(state))})
        location = snapshot.get_manifest()["0/m/w"].location
        if damage == "flipped_byte":
            _flip(os.path.join(path, location))
        else:
            os.remove(os.path.join(path, location))
    ok, corrupt, unreadable, problems = result = _port_audit(path)
    assert result == _jax_audit(path)
    assert len(problems) == 1 and location in problems[0]
    if damage == "flipped_byte":
        assert (corrupt, unreadable) == (1, 0) and problems[0].startswith("CORRUPT ")
    elif damage == "missing_payload":
        assert (corrupt, unreadable) == (0, 1) and problems[0].endswith("(referenced by: 0/m/w)")
    else:
        # Counted per member, reported once, naming 8 members and the rest.
        assert (corrupt, unreadable) == (0, 15)
        assert problems[0].startswith(f"UNREADABLE {location}: ")
        named = "0/m/b, 0/m/tiny0, 0/m/tiny1, 0/m/tiny10, 0/m/tiny11, 0/m/tiny2, 0/m/tiny3, 0/m/tiny4"
        assert problems[0].endswith(f"(referenced by: {named}, ... 7 more)")
    assert ok == len(integrity.payload_checksums(ts.Snapshot(path).metadata)) - corrupt - unreadable
