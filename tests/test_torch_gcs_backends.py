"""The GCS backend of the port through its entry points, against the
in-repo fake GCS server (tests/fake_gcs.py), and against the JAX package:

- the GCS case of tests/test_manager.py:127 (retention, resume and
  incremental saves on a ``gs://`` root, the JAX manager reading it alike);
- the gcs case of tests/test_cas.py:98 (the frozen payload uploaded once);
- tests/test_incremental.py:233 and :264 (server-side ``rewriteTo`` copies
  and their token continuation), and the same-bucket guard, as on S3;
- ``gs://`` parity, as the S3 pair of test_torch_parity.py: a snapshot
  either package takes restores bit-exact through the other, and both
  store the same object names with the same bytes.

These cases live in a file of their own rather than in the manager, CAS,
incremental and parity files, so that those files keep their test counts,
and with them their places in ``--dist loadfile``'s queue, which the
timing-sensitive reference tests depend on (ROADMAP C.4).

The parity takes run with slab batching on (the default): with it off, the
state's empty array is an object of its own, of zero bytes, and the fake
cannot store one from either package (it reads the finalizing
``Content-Range: bytes */0`` as a recovery probe and answers 308)."""

import asyncio
import json
import logging

import numpy as np
import pytest
import torch

import torchsnapshot_tpu_torch as ts
from torchsnapshot_tpu import Snapshot as JaxSnapshot
from torchsnapshot_tpu import StateDict as JaxStateDict
from torchsnapshot_tpu_torch import Snapshot, SnapshotManager, StateDict, knobs
from torchsnapshot_tpu_torch.serialization import state_from_numpy

from test_torch_cas import FROZEN, _assert_roundtrip
from test_torch_cas import _state as _cas_state
from test_torch_parity import _assert_same_bytes, _numpy_state, _s3_payload_objects, _zeros_numpy
from torch_env import default_knob_env, gcs_plugin, gcs_server, no_leaked_threads  # noqa: F401  fixtures

pytestmark = pytest.mark.usefixtures("no_leaked_threads")


def test_manager_on_gcs_backend(gcs_server):
    """Step listing through the delimiter JSON API and commit detection
    through metadata GETs: retention prunes step 1's objects, resume
    restores the latest step, incremental saves copy the frozen payload
    server-side, and the JAX package's manager reads the same root alike."""
    from torchsnapshot_tpu.manager import SnapshotManager as JaxManager

    frozen = torch.from_numpy(np.random.RandomState(1).rand(512).astype(np.float32))

    def state(v):
        return {"m": StateDict({"w": torch.full((256,), float(v)), "frozen": frozen.clone(), "step": v})}

    mgr = SnapshotManager("gs://bkt/ckpts", max_to_keep=2)
    with knobs.override_batching_disabled(True):
        for step in (1, 2, 3):
            mgr.save(step, state(step), incremental=True)
    assert mgr.all_steps() == [2, 3]
    assert not any(k.startswith("bkt/ckpts/step_1/") for k in gcs_server.objects), "step_1 not pruned"
    assert gcs_server.copies == 2  # the frozen payload, rewritten server-side twice
    dst = state(-1)
    dst["m"]["frozen"].zero_()
    assert mgr.restore_latest(dst) == 3
    assert torch.equal(dst["m"]["w"], torch.full((256,), 3.0)) and dst["m"]["step"] == 3
    assert torch.equal(dst["m"]["frozen"], frozen)
    assert JaxManager("gs://bkt/ckpts", max_to_keep=2).all_steps() == [2, 3]


def test_cas_roundtrip_on_fake_gcs(gcs_server):
    """A CAS manager root on GCS stores the frozen payload once, every step
    restores, and every chunk is referenced."""
    mgr = SnapshotManager("gs://bkt/casrun")
    with knobs.override_cas(True), knobs.override_batching_disabled(True):
        for step in (1, 2, 3):
            mgr.save(step, _cas_state(step))
    chunk_keys = [k for k in gcs_server.objects if "/cas/" in k]
    assert not [k for k in gcs_server.objects if ".tmp" in k]
    assert len([k for k in chunk_keys if gcs_server.objects[k] == FROZEN.tobytes()]) == 1
    for step in (1, 2, 3):
        _assert_roundtrip(mgr.path_for_step(step), step)
    referenced, orphan = mgr.chunk_classification()
    assert orphan == []
    assert len(referenced) == len(chunk_keys)


def test_incremental_on_gcs_server_side_copy(gcs_server):
    """Unchanged payloads are rewritten server-side: step 2 uploads the
    step and the metadata, not the backbone, and restores bit-exact."""
    backbone = np.random.RandomState(1).rand(400_000).astype(np.float32)
    with knobs.override_batching_disabled(True):
        Snapshot.take("gs://bkt/run/step_1", {"m": StateDict({"backbone": torch.from_numpy(backbone.copy()), "step": 1})})
        chunk_puts = gcs_server.chunk_puts
        snap2 = Snapshot.take(
            "gs://bkt/run/step_2",
            {"m": StateDict({"backbone": torch.from_numpy(backbone.copy()), "step": 2})},
            incremental_from="gs://bkt/run/step_1",
        )
    assert gcs_server.copies >= 1, "backbone was not copied server-side"
    # Every step-2 object was either uploaded (one chunk PUT each at the
    # default chunk size) or copied, never both.
    step2 = [k for k in gcs_server.objects if k.startswith("bkt/run/step_2/")]
    assert gcs_server.chunk_puts - chunk_puts == len(step2) - gcs_server.copies
    dst = {"m": StateDict({"backbone": torch.zeros(400_000), "step": -1})}
    snap2.restore(dst)
    np.testing.assert_array_equal(dst["m"]["backbone"].numpy(), backbone)
    assert dst["m"]["step"] == 2


def test_gcs_rewrite_token_continuation(gcs_server, gcs_plugin):
    """A copy answered done=false with a rewriteToken for N rounds loops the
    token through until done; a missing source falls back (False), and so
    does a source in another bucket."""
    gcs_server.rewrite_rounds = 3  # two done=false rounds, then done
    plugin = gcs_plugin(root="bkt/new")
    payload = np.random.RandomState(2).bytes(1 << 16)
    gcs_server.objects["bkt/base/big.bin"] = payload
    assert asyncio.run(plugin.copy_from_sibling("bkt/base", "big.bin"))
    assert gcs_server.objects["bkt/new/big.bin"] == payload
    assert gcs_server.copies == 1
    assert not asyncio.run(plugin.copy_from_sibling("bkt/base", "absent.bin"))
    assert not asyncio.run(plugin.copy_from_sibling("other-bkt/base", "big.bin"))
    assert gcs_server.copies == 1


def test_incremental_gcs_base_in_another_bucket_is_ignored(gcs_server, caplog):
    """Server-side copies are same-bucket only, on GCS as on S3: the take
    warns once and writes everything, copying nothing."""
    state = {"m": StateDict({"w": torch.arange(1024, dtype=torch.float32)})}
    with knobs.override_batching_disabled(True):
        Snapshot.take("gs://other-bkt/run/step_1", state)
        with caplog.at_level(logging.WARNING, logger="torchsnapshot_tpu_torch.incremental"):
            Snapshot.take("gs://bkt/run/step_2", state, incremental_from="gs://other-bkt/run/step_1")
    assert gcs_server.copies == 0
    assert any("incremental_from ignored: base bucket other-bkt != target bucket bkt" in r.getMessage()
               for r in caplog.records)
    dst = {"m": StateDict({"w": torch.zeros(1024)})}
    Snapshot("gs://bkt/run/step_2").restore(dst)
    assert torch.equal(dst["m"]["w"], state["m"]["w"])


@pytest.mark.parametrize("taker", ["jax", "port"])
def test_gcs_snapshot_of_one_package_restores_through_the_other(gcs_server, monkeypatch, taker):
    monkeypatch.setenv("TPUSNAP_MAX_CHUNK_SIZE_BYTES", "4096")
    state = _numpy_state()
    url = "gs://bkt/cross/snap"
    if taker == "jax":
        JaxSnapshot.take(url, {"m": JaxStateDict(state)})
        targets = state_from_numpy(_zeros_numpy(state))
        ptrs = {k: v.data_ptr() for k, v in targets.items() if isinstance(v, torch.Tensor)}
        ts.Snapshot(url).restore({"m": ts.StateDict(targets)})
        _assert_same_bytes(state, targets)
        assert all(targets[k].data_ptr() == ptr for k, ptr in ptrs.items())
    else:
        ts.Snapshot.take(url, {"m": ts.StateDict(state_from_numpy(state))})
        dst = {"m": JaxStateDict(_zeros_numpy(state))}
        JaxSnapshot(url).restore(dst)
        _assert_same_bytes(state, dst["m"].state_dict())


def test_gcs_takes_of_both_packages_store_the_same_objects(gcs_server, monkeypatch):
    monkeypatch.setenv("TPUSNAP_MAX_CHUNK_SIZE_BYTES", "4096")
    state = _numpy_state()
    JaxSnapshot.take("gs://bkt/same/jax", {"m": JaxStateDict(state)})
    ts.Snapshot.take("gs://bkt/same/port", {"m": ts.StateDict(state_from_numpy(state))})
    jax_objects = _s3_payload_objects(gcs_server, "bkt/same/jax")
    port_objects = _s3_payload_objects(gcs_server, "bkt/same/port")
    assert jax_objects and sorted(port_objects) == sorted(jax_objects)
    assert port_objects == jax_objects
    docs = {pkg: json.loads(gcs_server.objects[f"bkt/same/{pkg}/.snapshot_metadata"]) for pkg in ("jax", "port")}
    assert docs["port"]["manifest"] == docs["jax"]["manifest"]
