"""End-to-end take → restore → read_object of torch state through the port
(mirrors of tests/test_snapshot.py's single-process cases, plus the torch
specifics: int-key optimizer state, non-contiguous and requires_grad
tensors, in-place restore with the same data_ptr).  Every comparison is
exact (torch.equal / bitwise), since restore moves bytes."""

import asyncio
import random

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from torchsnapshot_tpu import Snapshot as JaxSnapshot
from torchsnapshot_tpu import StateDict as JaxStateDict
from torchsnapshot_tpu_torch import (
    ChecksumError,
    DtypeUnavailableError,
    RNGState,
    Snapshot,
    StateDict,
    knobs,
)
from torchsnapshot_tpu_torch.manifest import (
    ChunkedTensorEntry,
    ObjectEntry,
    PrimitiveEntry,
    SnapshotMetadata,
    TensorEntry,
    UnsupportedSnapshotError,
)

from torch_env import default_knob_env  # noqa: F401  autouse fixture


def _app_state():
    g = torch.Generator().manual_seed(0)
    return {
        "model": StateDict(
            {
                "w": torch.rand(16, 8, generator=g),
                "b": torch.arange(8, dtype=torch.bfloat16),
                "nested": {"scale": 0.5, "steps": [1, 2, 3]},
            }
        ),
        "extra": StateDict({"step": 7, "name": "run", "blob": b"\x01\x02"}),
    }


def _zeros_like_app_state():
    return {
        "model": StateDict(
            {
                "w": torch.zeros(16, 8),
                "b": torch.zeros(8, dtype=torch.bfloat16),
                "nested": {"scale": 0.0, "steps": [0, 0, 0]},
            }
        ),
        "extra": StateDict({"step": 0, "name": "", "blob": b""}),
    }


def _assert_tree_equal(a, b):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor), type(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.uint8) if a.dtype == torch.bool else a, b.view(torch.uint8) if b.dtype == torch.bool else b)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    else:
        assert a == b


def test_take_restore_roundtrip(tmp_path, toggle_batching):
    app_state = _app_state()
    snapshot = Snapshot.take(str(tmp_path / "snap"), app_state)
    dst = _zeros_like_app_state()
    ptrs = {k: v.data_ptr() for k, v in dst["model"].items() if isinstance(v, torch.Tensor)}
    snapshot.restore(dst)
    _assert_tree_equal(dst["model"].state_dict(), app_state["model"].state_dict())
    _assert_tree_equal(dst["extra"].state_dict(), app_state["extra"].state_dict())
    for k, ptr in ptrs.items():
        assert dst["model"][k].data_ptr() == ptr  # restored in place


def test_restore_into_fresh_snapshot_object(tmp_path):
    app_state = _app_state()
    Snapshot.take(str(tmp_path / "snap"), app_state)
    dst = _zeros_like_app_state()
    Snapshot(str(tmp_path / "snap")).restore(dst)
    _assert_tree_equal(dst["model"].state_dict(), app_state["model"].state_dict())


def test_read_object(tmp_path):
    app_state = _app_state()
    snapshot = Snapshot.take(str(tmp_path / "snap"), app_state)
    w = snapshot.read_object("0/model/w", device="cpu")
    assert torch.equal(w, app_state["model"]["w"])
    assert snapshot.read_object("0/extra/step") == 7
    assert snapshot.read_object("0/extra/name") == "run"
    out = torch.empty(16, 8)
    ptr = out.data_ptr()
    assert snapshot.read_object("0/model/w", obj_out=out) is out
    assert out.data_ptr() == ptr and torch.equal(out, app_state["model"]["w"])


def test_read_object_defaults_to_cuda(tmp_path, monkeypatch):
    """A fresh tensor lands on "cuda" unless the caller asks for the CPU;
    without CUDA that default raises rather than falling back."""
    snapshot = Snapshot.take(str(tmp_path / "snap"), _app_state())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        snapshot.read_object("0/model/w")


def test_read_object_with_budget(tmp_path):
    big = torch.arange(10000, dtype=torch.float32)
    snapshot = Snapshot.take(str(tmp_path / "snap"), {"m": StateDict({"big": big})})
    out = snapshot.read_object("0/m/big", device="cpu", memory_budget_bytes=1024)
    assert torch.equal(out, big)


def test_get_manifest(tmp_path):
    manifest = Snapshot.take(str(tmp_path / "snap"), _app_state()).get_manifest()
    assert isinstance(manifest["0/model/w"], TensorEntry)
    assert isinstance(manifest["0/extra/step"], PrimitiveEntry)
    assert manifest["0/model/b"].dtype == "bfloat16"


def test_get_state_dict_for_key(tmp_path):
    app_state = _app_state()
    snapshot = Snapshot.take(str(tmp_path / "snap"), app_state)
    sd = snapshot.get_state_dict_for_key("model", device="cpu")
    _assert_tree_equal(sd, app_state["model"].state_dict())


def test_rng_state_determinism(tmp_path):
    random.seed(17)
    np.random.seed(17)
    torch.manual_seed(17)
    app_state = {"rng": RNGState(), "m": StateDict({"x": 1})}
    snapshot = Snapshot.take(str(tmp_path / "snap"), app_state)
    # Taking a snapshot must not perturb the RNGs.
    expected = (random.random(), np.random.rand(), torch.rand(3))

    random.seed(99)
    np.random.seed(99)
    torch.manual_seed(99)
    snapshot.restore({"rng": RNGState(), "m": StateDict({"x": 0})})
    got = (random.random(), np.random.rand(), torch.rand(3))
    assert got[0] == expected[0] and got[1] == expected[1]
    assert torch.equal(got[2], expected[2])


def test_restore_strict_false_forwarded(tmp_path):
    calls = {}

    class StrictAware:
        def __init__(self):
            self.state = {"x": 1}

        def state_dict(self):
            return self.state

        def load_state_dict(self, sd, strict=True):
            calls["strict"] = strict
            self.state = dict(sd)

    snapshot = Snapshot.take(str(tmp_path / "snap"), {"m": StrictAware()})
    dst = StrictAware()
    snapshot.restore({"m": dst}, strict=False)
    assert calls["strict"] is False and dst.state == {"x": 1}
    snapshot.restore({"m": dst})
    assert calls["strict"] is True


def test_non_stateful_value_raises(tmp_path):
    with pytest.raises(TypeError, match="Stateful"):
        Snapshot.take(str(tmp_path / "snap"), {"m": {"w": 1}})


def test_missing_metadata_is_invalid_snapshot(tmp_path):
    with pytest.raises(RuntimeError, match="valid snapshot"):
        Snapshot(str(tmp_path / "nonexistent")).restore({"m": StateDict({"x": 0})})


def test_corrupt_metadata_is_clear_error(tmp_path):
    path = tmp_path / "snap"
    Snapshot.take(str(path), {"m": StateDict({"x": 1})})
    (path / ".snapshot_metadata").write_text("{not json!!")
    with pytest.raises(ValueError):
        Snapshot(str(path)).restore({"m": StateDict({"x": 0})})


def test_read_object_unknown_path(tmp_path):
    snapshot = Snapshot.take(str(tmp_path / "snap"), {"m": StateDict({"x": 1})})
    with pytest.raises(RuntimeError, match="does not exist"):
        snapshot.read_object("0/m/nope")


def test_tiny_memory_budget_end_to_end(tmp_path):
    """A budget far below any buffer still completes via the always-admit-one
    starvation guard, on save and restore."""
    g = torch.Generator().manual_seed(1)
    state = {f"w{i}": torch.rand(4096, generator=g) for i in range(6)}
    with knobs.override_per_rank_memory_budget_bytes(512):
        snapshot = Snapshot.take(str(tmp_path / "snap"), {"m": StateDict(state)})
        dst = {"m": StateDict({})}
        snapshot.restore(dst)
    for k, v in state.items():
        assert torch.equal(dst["m"][k], v)


def test_chunked_through_snapshot(tmp_path, toggle_chunking):
    big = torch.rand(64, 8, generator=torch.Generator().manual_seed(7))
    snapshot = Snapshot.take(str(tmp_path / "snap"), {"m": StateDict({"big": big})})
    entry = snapshot.get_manifest()["0/m/big"]
    assert isinstance(entry, ChunkedTensorEntry) == toggle_chunking
    dst = torch.zeros(64, 8)
    ptr = dst.data_ptr()
    snapshot.restore({"m": StateDict({"big": dst})})
    assert torch.equal(dst, big) and dst.data_ptr() == ptr
    assert torch.equal(snapshot.read_object("0/m/big", device="cpu"), big)


def test_api_callable_from_running_event_loop(tmp_path):
    async def scenario():
        app = {"m": StateDict({"w": torch.arange(32, dtype=torch.float32), "s": 9})}
        snap = Snapshot.take(str(tmp_path / "snap"), app)
        dst = {"m": StateDict({"w": torch.zeros(32), "s": -1})}
        snap.restore(dst)
        assert torch.equal(dst["m"]["w"], app["m"]["w"])
        assert int(snap.read_object("0/m/s")) == 9

    asyncio.run(scenario())


def test_module_and_int_key_optimizer_state(tmp_path, toggle_batching):
    """nn.Module parameters restore in place; optimizer state dicts (int
    keys, 0-d step tensors, tuple betas) round-trip exactly."""
    torch.manual_seed(3)
    model = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(), torch.nn.Linear(16, 4))
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    model(torch.randn(5, 8)).sum().backward()
    opt.step()
    snapshot = Snapshot.take(str(tmp_path / "snap"), {"model": model, "opt": opt})
    assert "0/opt/state/0/exp_avg" in snapshot.get_manifest()

    torch.manual_seed(4)
    model2 = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(), torch.nn.Linear(16, 4))
    opt2 = torch.optim.Adam(model2.parameters(), lr=5e-2)
    model2(torch.randn(5, 8)).sum().backward()
    opt2.step()
    ptrs = [p.data_ptr() for p in model2.parameters()]
    snapshot.restore({"model": model2, "opt": opt2})
    assert [p.data_ptr() for p in model2.parameters()] == ptrs
    _assert_tree_equal(model2.state_dict(), model.state_dict())
    _assert_tree_equal(opt2.state_dict(), opt.state_dict())
    assert 0 in opt2.state_dict()["state"]  # int keys survive


def test_non_contiguous_and_requires_grad_tensors(tmp_path):
    base = torch.arange(48, dtype=torch.float32).reshape(6, 8)
    nc = base.t()  # non-contiguous
    param = torch.nn.Parameter(torch.rand(4, 4))
    snapshot = Snapshot.take(str(tmp_path / "snap"), {"m": StateDict({"nc": nc, "p": param})})
    dst_nc = torch.zeros(8, 6).t().contiguous().t()  # non-contiguous target
    assert not dst_nc.is_contiguous()
    dst_p = torch.nn.Parameter(torch.zeros(4, 4))
    ptr = dst_p.data_ptr()
    dst = {"m": StateDict({"nc": dst_nc, "p": dst_p})}
    snapshot.restore(dst)
    assert torch.equal(dst["m"]["nc"], nc)
    assert dst["m"]["p"] is dst_p and dst_p.data_ptr() == ptr
    assert torch.equal(dst_p.detach(), param.detach()) and dst_p.requires_grad


def test_dtype_mismatch_converts_like_copyto(tmp_path):
    src = torch.arange(10, dtype=torch.float32) / 4
    snapshot = Snapshot.take(str(tmp_path / "snap"), {"m": StateDict({"x": src})})
    dst = torch.zeros(10, dtype=torch.float64)
    snapshot.restore({"m": StateDict({"x": dst})})
    assert torch.equal(dst, src.double())


def test_numpy_leaves_and_scalars(tmp_path):
    state = {"a": np.arange(6, dtype=np.int32).reshape(2, 3), "s": np.float32(2.5), "t": torch.tensor(3.0)}
    snapshot = Snapshot.take(str(tmp_path / "snap"), {"m": StateDict(state)})
    dst_a = np.zeros((2, 3), np.int32)
    dst = {"m": StateDict({"a": dst_a, "t": torch.tensor(0.0)})}
    snapshot.restore(dst)
    assert dst["m"]["a"] is dst_a
    np.testing.assert_array_equal(dst_a, state["a"])
    assert float(dst["m"]["s"]) == 2.5 and float(dst["m"]["t"]) == 3.0


def test_unregistered_dtypes(tmp_path):
    """A tensor outside the dtype registry is refused at plan time (torch
    cannot unpickle such tensors); a numpy array outside it pickles."""
    x = torch.zeros(3, dtype=torch.float8_e4m3fnuz)
    with pytest.raises(TypeError, match="float8_e4m3fnuz"):
        Snapshot.take(str(tmp_path / "bad"), {"m": StateDict({"x": x})})
    obj_arr = np.array([1, "a", None], dtype=object)
    snapshot = Snapshot.take(str(tmp_path / "snap"), {"m": StateDict({"o": obj_arr})})
    assert isinstance(snapshot.get_manifest()["0/m/o"], ObjectEntry)
    np.testing.assert_array_equal(snapshot.read_object("0/m/o"), obj_arr)


def test_flipped_byte_raises_checksum_error(tmp_path):
    w = torch.rand(64, 64, generator=torch.Generator().manual_seed(5))
    path = tmp_path / "snap"
    snapshot = Snapshot.take(str(path), {"m": StateDict({"w": w})})
    entry = snapshot.get_manifest()["0/m/w"]
    payload = path / entry.location
    data = bytearray(payload.read_bytes())
    offset = entry.byte_range[0] if entry.byte_range else 0
    data[offset + 100] ^= 0xFF
    payload.write_bytes(bytes(data))
    with pytest.raises(ChecksumError):
        Snapshot(str(path)).restore({"m": StateDict({"w": torch.zeros(64, 64)})})


def test_failed_take_removes_partial_directory(tmp_path):
    class Unpicklable:
        def __reduce__(self):
            raise RuntimeError("cannot pickle")

    path = tmp_path / "snap"
    state = {"w": torch.rand(1000), "bad": Unpicklable()}
    with pytest.raises(RuntimeError, match="cannot pickle"):
        Snapshot.take(str(path), {"m": StateDict(state)})
    assert not path.exists()


def test_memory_storage_roundtrip(toggle_batching):
    """Storage without fused write+hash: the scheduler hashes before the
    write, and the manifest digests equal the fs plugin's."""
    from torchsnapshot_tpu_torch.storage_plugins.memory import MemoryStoragePlugin

    app_state = _app_state()
    try:
        snapshot = Snapshot.take("memory://torch-snap", app_state)
        dst = _zeros_like_app_state()
        snapshot.restore(dst)
        _assert_tree_equal(dst["model"].state_dict(), app_state["model"].state_dict())
        assert snapshot.get_manifest()["0/model/w"].checksum.startswith("xxh64:")
    finally:
        MemoryStoragePlugin.reset()


def test_later_manifest_versions_name_the_missing_feature(tmp_path):
    """Compression (0.2.0), content addressing (0.4.0), journal delta
    segments (0.5.0) and content-defined chunking (0.6.0) are read; a
    direct restore of a delta segment is refused, naming the manager's
    replay; a version past the reader's is refused."""
    for version in ("0.2.0", "0.4.0", "0.5.0", "0.6.0"):
        doc = SnapshotMetadata(version=version, world_size=1).to_json()
        assert SnapshotMetadata.from_json(doc).version == version
    seg = tmp_path / "seg_2"
    seg.mkdir()
    doc = SnapshotMetadata(version="0.5.0", world_size=1, journal={"base_step": 1}).to_json()
    (seg / ".snapshot_metadata").write_text(doc)
    with pytest.raises(RuntimeError, match="journal delta segment.*restore_latest"):
        Snapshot(str(seg)).restore({"m": StateDict({"w": torch.zeros(2)})})
    doc = SnapshotMetadata(version="0.7.0", world_size=1).to_json()
    with pytest.raises(UnsupportedSnapshotError, match="newer than this reader"):
        SnapshotMetadata.from_json(doc)


def test_float8_e4m3b11fnuz_from_jax_snapshot(tmp_path):
    """The registry dtype torch lacks: restoring it into a tensor raises the
    named error; read_object returns its raw bytes as uint8."""
    value = np.arange(12, dtype=np.float32).reshape(3, 4).astype(ml_dtypes.float8_e4m3b11fnuz)
    JaxSnapshot.take(str(tmp_path / "snap"), {"m": JaxStateDict({"f8": jnp.asarray(value)})})
    snapshot = Snapshot(str(tmp_path / "snap"))
    raw = snapshot.read_object("0/m/f8", device="cpu")
    assert raw.dtype == torch.uint8 and list(raw.shape) == [3, 4]
    np.testing.assert_array_equal(raw.numpy(), value.view(np.uint8))
    with pytest.raises(DtypeUnavailableError, match="float8_e4m3b11fnuz"):
        snapshot.restore({"m": StateDict({"f8": torch.zeros(3, 4, dtype=torch.uint8)})})


def test_lifecycle_events_reach_registered_handlers(tmp_path):
    from torchsnapshot_tpu_torch.event_handlers import (
        register_event_handler,
        unregister_event_handler,
    )

    seen = []
    register_event_handler(seen.append)
    try:
        snapshot = Snapshot.take(str(tmp_path / "snap"), _app_state())
        snapshot.restore(_zeros_like_app_state())
        snapshot.read_object("0/extra/step")
    finally:
        unregister_event_handler(seen.append)
    names = [e.name for e in seen]
    assert names == [
        "take.start", "take.end", "restore.start", "restore.end",
        "read_object.start", "read_object.end",
    ]
    assert all(e.metadata["is_success"] for e in seen if e.name.endswith(".end"))
    assert seen[1].metadata["bytes"] > 0


@pytest.mark.parametrize("error", ["transient", "terminal"])
def test_scheduler_retries_only_transient_write_failures(monkeypatch, error):
    """The write pipeline re-sends a staged buffer after a transient storage
    failure (TPUSNAP_IO_RETRIES) and fails at once on a terminal one."""
    from torchsnapshot_tpu_torch import io_preparer
    from torchsnapshot_tpu_torch.io_types import ReadIO
    from torchsnapshot_tpu_torch.retry import StorageTransientError
    from torchsnapshot_tpu_torch.scheduler import sync_execute_write_reqs
    from torchsnapshot_tpu_torch.storage_plugins.memory import MemoryStoragePlugin

    monkeypatch.setenv("TPUSNAP_RETRY_BASE_S", "0")
    attempts = []

    class Flaky(MemoryStoragePlugin):
        async def write(self, write_io):
            attempts.append(write_io.path)
            if len(attempts) == 1:
                raise StorageTransientError("503") if error == "transient" else PermissionError("denied")
            await super().write(write_io)

    storage = Flaky(root="torch-flaky")
    try:
        x = torch.arange(100, dtype=torch.int64)
        entry, reqs = io_preparer.prepare_write(x, "m/x", rank=0)
        if error == "terminal":
            with pytest.raises(PermissionError):
                sync_execute_write_reqs(reqs, storage, 1 << 20, rank=0).sync_complete()
            assert len(attempts) == 1
            return
        pending = sync_execute_write_reqs(reqs, storage, 1 << 20, rank=0)
        pending.sync_complete()
        assert pending.bytes_total == x.numel() * 8
        assert len(attempts) == 2
        read_io = ReadIO(path=entry.location)
        storage.sync_read(read_io)
        assert bytes(read_io.buf) == x.numpy().tobytes()
        assert entry.checksum is not None
    finally:
        MemoryStoragePlugin.reset()
