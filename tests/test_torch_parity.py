"""Cross-package parity: a snapshot taken by torchsnapshot_tpu restores
bit-exact through torchsnapshot_tpu_torch and the reverse, for every dtype
both packages have, under toggled batching and chunking; the two packages'
manifests for the same state are equal entry by entry; a flipped payload
byte raises ChecksumError in both.  Every comparison is exact (bytes)."""

import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import torchsnapshot_tpu_torch as ts
from torchsnapshot_tpu import Snapshot as JaxSnapshot
from torchsnapshot_tpu import StateDict as JaxStateDict
from torchsnapshot_tpu import serialization as jax_ser
from torchsnapshot_tpu.integrity import ChecksumError as JaxChecksumError
from torchsnapshot_tpu.models.llama import LlamaConfig, init_params
from torchsnapshot_tpu_torch.serialization import host_bytes, state_from_numpy

from torch_env import default_knob_env  # noqa: F401  autouse fixture

SHARED_DTYPES = sorted(d for d in jax_ser._STRING_TO_DTYPE if d != "float8_e4m3b11fnuz")


def _array(dtype_str: str, shape, seed: int) -> np.ndarray:
    np_dtype = jax_ser.string_to_dtype(dtype_str)
    n = int(np.prod(shape))
    rng = np.random.RandomState(seed)
    if dtype_str == "bool":
        return rng.randint(0, 2, size=shape).astype(bool)
    if dtype_str in ("int4", "uint4"):
        lo, hi = (-8, 8) if dtype_str == "int4" else (0, 16)
        return rng.randint(lo, hi, size=shape).astype(np_dtype)
    raw = rng.randint(0, 256, size=n * np_dtype.itemsize).astype(np.uint8)
    return raw.view(np_dtype).reshape(shape)


def _numpy_state():
    """Every shared dtype at a chunkable shape (over 1 KiB), plus a 0-d, an
    empty and a tiny one, primitives and nested containers."""
    state = {}
    for i, d in enumerate(SHARED_DTYPES):
        state[f"big_{d}"] = _array(d, (64, 40), seed=i)
        state[f"small_{d}"] = _array(d, (3,), seed=100 + i)
    state["scalar"] = _array("float32", (), seed=7)
    state["empty"] = _array("int32", (0, 4), seed=8)
    state["nested"] = {"step": 11, "lr": 0.25, "tags": ["a", "b"], "t": (1, 2.5)}
    return state


def _raw(value) -> bytes:
    if isinstance(value, torch.Tensor):
        assert not value.is_cuda
        return host_bytes(value).tobytes()
    arr = np.asarray(value)
    return arr.reshape(-1).view(np.uint8).tobytes() if arr.size else b""


def _assert_same_bytes(expected: dict, got: dict):
    assert set(expected) == set(got)
    for k, v in expected.items():
        if isinstance(v, dict):
            _assert_same_bytes(v, got[k])
        elif isinstance(v, np.ndarray):
            assert list(np.shape(got[k])) == list(v.shape), k
            assert _raw(got[k]) == _raw(v), k
        else:
            assert got[k] == v, k


def _zeros_numpy(state):
    return {
        k: (_zeros_numpy(v) if isinstance(v, dict) else np.zeros_like(v))
        if isinstance(v, (dict, np.ndarray))
        else v
        for k, v in state.items()
    }


def test_jax_take_port_restore(tmp_path, toggle_batching, toggle_chunking):
    state = _numpy_state()
    JaxSnapshot.take(str(tmp_path / "snap"), {"m": JaxStateDict(state)})
    targets = state_from_numpy(_zeros_numpy(state))
    ptrs = {k: v.data_ptr() for k, v in targets.items() if isinstance(v, torch.Tensor)}
    dst = {"m": ts.StateDict(targets)}
    ts.Snapshot(str(tmp_path / "snap")).restore(dst)
    _assert_same_bytes(state, dst["m"].state_dict())
    for k, ptr in ptrs.items():
        assert dst["m"][k].data_ptr() == ptr, k


def test_port_take_jax_restore(tmp_path, toggle_batching, toggle_chunking):
    state = _numpy_state()
    ts.Snapshot.take(str(tmp_path / "snap"), {"m": ts.StateDict(state_from_numpy(state))})
    dst = {"m": JaxStateDict(_zeros_numpy(state))}
    JaxSnapshot(str(tmp_path / "snap")).restore(dst)
    _assert_same_bytes(state, dst["m"].state_dict())


def test_manifests_equal_entry_by_entry(tmp_path, toggle_batching, toggle_chunking):
    state = _numpy_state()
    jax_snap = JaxSnapshot.take(str(tmp_path / "jax"), {"m": JaxStateDict(state)})
    port_snap = ts.Snapshot.take(
        str(tmp_path / "port"), {"m": ts.StateDict(state_from_numpy(state))}
    )
    jax_doc = json.loads((tmp_path / "jax" / ".snapshot_metadata").read_text())
    port_doc = json.loads((tmp_path / "port" / ".snapshot_metadata").read_text())
    assert port_doc["version"] == jax_doc["version"] == "0.1.0"
    assert sorted(port_doc["manifest"]) == sorted(jax_doc["manifest"])
    for key, jax_entry in jax_doc["manifest"].items():
        # location, dtype, shape, byte range, checksum, chunk layout …
        assert port_doc["manifest"][key] == jax_entry, key
    assert len(jax_snap.get_manifest()) == len(port_snap.get_manifest())


def _tiny_llama_params():
    params = init_params(jax.random.key(0), LlamaConfig.tiny())
    return jax.tree_util.tree_map(np.asarray, params)


def test_tiny_llama_both_directions(tmp_path, toggle_batching, toggle_chunking):
    params = _tiny_llama_params()
    jax_params = jax.tree_util.tree_map(jnp.asarray, params)

    # JAX takes jax.Arrays → the port restores in place into torch tensors.
    JaxSnapshot.take(str(tmp_path / "jax"), {"params": JaxStateDict(jax_params)})
    targets = state_from_numpy(_zeros_numpy(params))
    ts.Snapshot(str(tmp_path / "jax")).restore({"params": ts.StateDict(targets)})
    _assert_same_bytes(params, targets)

    # The port takes torch tensors → JAX restores into jax.Arrays.
    ts.Snapshot.take(str(tmp_path / "port"), {"params": ts.StateDict(state_from_numpy(params))})
    dst = JaxStateDict(jax.tree_util.tree_map(jnp.zeros_like, jax_params))
    JaxSnapshot(str(tmp_path / "port")).restore({"params": dst})
    _assert_same_bytes(params, jax.tree_util.tree_map(np.asarray, dict(dst)))

    jax_doc = json.loads((tmp_path / "jax" / ".snapshot_metadata").read_text())
    port_doc = json.loads((tmp_path / "port" / ".snapshot_metadata").read_text())
    assert port_doc == jax_doc


@pytest.mark.parametrize("taker", ["jax", "port"])
def test_flipped_byte_raises_checksum_error_in_both(tmp_path, taker):
    state = {"w": _array("float32", (128, 64), seed=3), "b": _array("bfloat16", (4,), seed=4)}
    path = tmp_path / "snap"
    if taker == "jax":
        JaxSnapshot.take(str(path), {"m": JaxStateDict(state)})
    else:
        ts.Snapshot.take(str(path), {"m": ts.StateDict(state_from_numpy(state))})
    entry = json.loads((path / ".snapshot_metadata").read_text())["manifest"]["0/m/w"]
    payload = path / entry["location"]
    data = bytearray(payload.read_bytes())
    data[(entry.get("byte_range") or [0])[0] + 17] ^= 0x01
    payload.write_bytes(bytes(data))
    with pytest.raises(ts.ChecksumError):
        ts.Snapshot(str(path)).restore({"m": ts.StateDict(state_from_numpy(_zeros_numpy(state)))})
    with pytest.raises(JaxChecksumError):
        JaxSnapshot(str(path)).restore({"m": JaxStateDict(_zeros_numpy(state))})


def test_jax_rng_state_crosses_as_raw_key_data(tmp_path):
    """A JAX RNGState restores into the port's: python and numpy state as
    saved, the JAX key as its raw numpy key data."""
    import random

    from torchsnapshot_tpu import RNGState as JaxRNGState

    random.seed(5)
    np.random.seed(5)
    key = jax.random.key(42)
    JaxSnapshot.take(str(tmp_path / "snap"), {"rng": JaxRNGState(jax_key=key)})
    expected = (random.random(), np.random.rand())
    random.seed(0)
    np.random.seed(0)
    rng = ts.RNGState()
    ts.Snapshot(str(tmp_path / "snap")).restore({"rng": rng})
    assert (random.random(), np.random.rand()) == expected
    np.testing.assert_array_equal(rng.jax_key_data, np.asarray(jax.random.key_data(key)))


@pytest.mark.parametrize(
    "tree",
    [
        {"a": 1, "b": [1, 2, {"c": "x"}], "d": (3.5, None)},
        {0: {"step": 1}, 1: {"step": 2}, "param_groups": [{"lr": 0.1, "params": [0, 1]}]},
        {"": 1, "a/b": 2, "%": [3], "nested": {"": {"x": 4}}},
        {"mixed_keys": {1: "a", "1": "b"}, "frozen": frozenset({1})},
    ],
    ids=["containers", "int_keys", "escaped_keys", "opaque_leaves"],
)
def test_flatten_matches_jax_package(tree):
    """The port's flatten/inflate is the JAX package's logic: same container
    entries, same leaf paths, same rebuilt structure."""
    from torchsnapshot_tpu import flatten as jax_flatten
    from torchsnapshot_tpu_torch import flatten as port_flatten

    jax_manifest, jax_leaves = jax_flatten.flatten(tree, prefix="k")
    port_manifest, port_leaves = port_flatten.flatten(tree, prefix="k")
    assert {p: (type(e).__name__, vars(e)) for p, e in port_manifest.items()} == {
        p: (type(e).__name__, vars(e)) for p, e in jax_manifest.items()
    }
    assert port_leaves == jax_leaves
    assert port_flatten.inflate(port_manifest, port_leaves, prefix="k") == tree


def test_manifest_json_roundtrips_across_packages(tmp_path):
    """Each package parses the other's .snapshot_metadata into entries that
    serialize back to the identical document."""
    from torchsnapshot_tpu.manifest import SnapshotMetadata as JaxMetadata
    from torchsnapshot_tpu_torch.manifest import SnapshotMetadata as PortMetadata

    state = _numpy_state()
    JaxSnapshot.take(str(tmp_path / "jax"), {"m": JaxStateDict(state)})
    ts.Snapshot.take(str(tmp_path / "port"), {"m": ts.StateDict(state_from_numpy(state))})
    for taker in ("jax", "port"):
        doc = (tmp_path / taker / ".snapshot_metadata").read_text()
        assert PortMetadata.from_json(doc).to_json() == doc
        assert JaxMetadata.from_json(doc).to_json() == doc


# ------------------------------------------------------------------- async take

ASYNC_MODES = ["host", "device", "pinned_host"]
_64BIT = {"float64", "int64", "uint64", "complex128"}


@pytest.fixture
def cpu_as_device(monkeypatch):
    """Drive the port's device and pinned_host staging on CPU tensors (the
    residency predicate accepts every tensor; pinned buffers are plain)."""
    from torchsnapshot_tpu_torch import device_staging, staging

    device_staging.reset_pinned_host_health()
    monkeypatch.setattr(device_staging, "_is_device_resident", lambda obj: isinstance(obj, torch.Tensor))
    monkeypatch.setattr(staging, "pinned_empty", lambda n: torch.empty(n, dtype=torch.uint8))


def _async_port_state(state):
    """The numpy state as torch tensors, plus a numpy array and a pickled
    object that stay what they are."""
    port = state_from_numpy(state)
    port["np_arr"] = np.arange(100, dtype=np.int32)
    port["tags"] = {"a", "b"}
    return port


def _mutate_everything(port):
    for v in port.values():
        if isinstance(v, torch.Tensor):
            v.reshape(-1).view(torch.uint8).fill_(0x55)
        elif isinstance(v, np.ndarray):
            v.fill(-1)
        elif isinstance(v, set):
            v.add("c")
    port["nested"]["step"] = -1


@pytest.mark.parametrize("mode", ASYNC_MODES)
def test_port_async_take_restores_through_both(tmp_path, cpu_as_device, mode):
    """Mutating tensors, numpy arrays and objects right after async_take
    returns leaves the snapshot at the values of the take: bit-exact
    through the port and through the JAX package."""
    state = _numpy_state()
    port = _async_port_state(state)
    with ts.knobs.override_async_staging(mode):
        pending = ts.Snapshot.async_take(str(tmp_path / "snap"), {"m": ts.StateDict(port)})
    _mutate_everything(port)
    assert pending.staging_mode == mode
    pending.wait()
    expected = dict(state, np_arr=np.arange(100, dtype=np.int32))

    dst = {"m": JaxStateDict(_zeros_numpy(expected))}
    JaxSnapshot(str(tmp_path / "snap")).restore(dst)
    _assert_same_bytes(expected, {k: v for k, v in dst["m"].state_dict().items() if k != "tags"})
    assert dst["m"]["tags"] == {"a", "b"}

    targets = state_from_numpy(_zeros_numpy(expected))
    targets["np_arr"] = np.zeros(100, dtype=np.int32)
    port_dst = {"m": ts.StateDict(targets)}
    ts.Snapshot(str(tmp_path / "snap")).restore(port_dst)
    _assert_same_bytes(expected, {k: v for k, v in port_dst["m"].state_dict().items() if k != "tags"})
    assert port_dst["m"]["tags"] == {"a", "b"}


@pytest.mark.parametrize("mode", ASYNC_MODES)
def test_jax_async_take_port_restore(tmp_path, mode):
    """A JAX async_take on CPU (jax.Arrays for the 32-bit-safe dtypes, numpy
    for the rest) restores bit-exact through the port."""
    from torchsnapshot_tpu import knobs as jax_knobs

    state = _numpy_state()
    jax_state = {
        k: jnp.asarray(v) if isinstance(v, np.ndarray) and str(v.dtype) not in _64BIT else v
        for k, v in state.items()
    }
    with jax_knobs.override_async_staging(mode):
        pending = JaxSnapshot.async_take(str(tmp_path / "snap"), {"m": JaxStateDict(jax_state)})
        pending.wait()
    targets = state_from_numpy(_zeros_numpy(state))
    dst = {"m": ts.StateDict(targets)}
    ts.Snapshot(str(tmp_path / "snap")).restore(dst)
    _assert_same_bytes(state, dst["m"].state_dict())


@pytest.mark.parametrize("mode", ASYNC_MODES)
def test_async_manifest_equals_sync_manifest(tmp_path, cpu_as_device, toggle_batching, mode):
    """A port async take writes the manifest of the sync take, entry by
    entry (locations, dtypes, shapes, byte ranges, digests), and the JAX
    package's sync take writes it too."""
    state = _numpy_state()
    ts.Snapshot.take(str(tmp_path / "sync"), {"m": ts.StateDict(state_from_numpy(state))})
    with ts.knobs.override_async_staging(mode):
        ts.Snapshot.async_take(str(tmp_path / "async"), {"m": ts.StateDict(state_from_numpy(state))}).wait()
    JaxSnapshot.take(str(tmp_path / "jax"), {"m": JaxStateDict(state)})
    docs = {
        name: json.loads((tmp_path / name / ".snapshot_metadata").read_text())
        for name in ("sync", "async", "jax")
    }
    assert sorted(docs["async"]["manifest"]) == sorted(docs["sync"]["manifest"])
    for key, entry in docs["sync"]["manifest"].items():
        assert docs["async"]["manifest"][key] == entry == docs["jax"]["manifest"][key], key


# ------------------------------------------------------ sharded, multi-rank
#
# The JAX side runs in this process on the 8-device CPU mesh
# (tests/conftest.py); the port side runs on 2 or 4 gloo ranks whose bodies
# live in tests/test_torch_sharded.py (a module without JAX).

from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402
from test_torch_sharded import (  # noqa: E402
    PARITY_SHAPES,
    parity_restore_jax_snapshot_2,
    parity_restore_jax_snapshot_4,
    parity_async_take_for_jax,
    parity_restore_raises_checksum_error,
    parity_take_for_jax,
    parity_take_hsdp_layout,
    parity_value,
)


def _jax_mesh(shape, names):
    devices = np.array(jax.devices()[: int(np.prod(shape))]).reshape(shape)
    return Mesh(devices, names)


def _parity_np(name) -> np.ndarray:
    """parity_value as numpy, bf16 through ml_dtypes with the same bits."""
    t = parity_value(name)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


JAX_SOURCE_SHARDINGS = {
    "w_f32": lambda: NamedSharding(_jax_mesh((8,), ("x",)), P("x", None)),
    "w_bf16": lambda: NamedSharding(_jax_mesh((4, 2), ("x", "y")), P(("x", "y"), None)),
    "w_i32": lambda: NamedSharding(_jax_mesh((2, 4), ("r", "s")), P(None, None)),
}


def _jax_sharded_state():
    return {
        name: jax.device_put(jnp.asarray(_parity_np(name)), JAX_SOURCE_SHARDINGS[name]())
        for name in PARITY_SHAPES
    }


@pytest.mark.parametrize("world", [2, 4])
def test_jax_sharded_snapshot_restores_into_dtensors(tmp_path, monkeypatch, world):
    """A snapshot the JAX package took of NamedSharding arrays on its
    8-device mesh restores in place into torch DTensors across 2 and 4
    gloo ranks, every rank's box bit-exact."""
    JaxSnapshot.take(str(tmp_path / "snap"), {"m": JaxStateDict(_jax_sharded_state())})
    monkeypatch.setenv("TPUSNAP_TEST_SNAPSHOT", str(tmp_path / "snap"))
    (parity_restore_jax_snapshot_2 if world == 2 else parity_restore_jax_snapshot_4)()


JAX_TARGET_SHARDINGS = {
    "w_f32": lambda: NamedSharding(_jax_mesh((4, 2), ("x", "y")), P(None, "y")),
    "w_bf16": lambda: NamedSharding(_jax_mesh((2, 4), ("a", "b")), P("b", "a")),
    "w_i32": lambda: NamedSharding(_jax_mesh((4, 2), ("x", "y")), P("x", "y")),
}


def test_port_sharded_snapshot_restores_through_jax(tmp_path, monkeypatch):
    """DTensors that 4 torch ranks took (HSDP, two mesh axes, an uneven
    Shard(1) with an empty box) restore through the JAX package into other
    NamedShardings with equal global values, and read_object assembles
    them whole in both packages."""
    monkeypatch.setenv("TPUSNAP_TEST_SNAPSHOT", str(tmp_path / "snap"))
    parity_take_for_jax()
    targets = {
        name: jax.device_put(jnp.zeros(shape, _parity_np(name).dtype), JAX_TARGET_SHARDINGS[name]())
        for name, (shape, _) in PARITY_SHAPES.items()
    }
    dst = {"m": JaxStateDict(targets)}
    JaxSnapshot(str(tmp_path / "snap")).restore(dst)
    port_snap = ts.Snapshot(str(tmp_path / "snap"))
    for name in PARITY_SHAPES:
        got = dst["m"][name]
        assert got.sharding == targets[name].sharding
        assert _raw(np.asarray(got)) == _raw(_parity_np(name)), name
        whole = port_snap.read_object(f"0/m/{name}", device="cpu")
        assert torch.equal(whole.view(torch.uint8), parity_value(name).view(torch.uint8)), name


def test_sharded_entry_fields_match_across_packages(tmp_path, monkeypatch):
    """For a layout both can express (a (2, 2) mesh, dim 0 sharded over
    "shard", replicated over "replicate") both packages write the same
    ShardedArrayEntry: shape, dtype, shard boxes and piece paths, mesh
    shape, axis names and partition spec; each replicated box once."""
    jax_arr = jax.device_put(
        jnp.asarray(_parity_np("w_f32")),
        NamedSharding(_jax_mesh((2, 2), ("replicate", "shard")), P("shard", None)),
    )
    # Unbatched on both sides: the JAX package, at world size 1, would pack
    # both small pieces into one slab, each port rank has one piece.
    monkeypatch.setenv(ts.knobs.DISABLE_BATCHING_ENV_VAR, "1")
    jax_snap = JaxSnapshot.take(str(tmp_path / "jax"), {"m": JaxStateDict({"w_f32": jax_arr})})
    monkeypatch.setenv("TPUSNAP_TEST_SNAPSHOT", str(tmp_path / "port"))
    parity_take_hsdp_layout()
    port_snap = ts.Snapshot(str(tmp_path / "port"))

    from torchsnapshot_tpu.manifest_ops import get_manifest_for_rank as jax_view
    from torchsnapshot_tpu_torch.manifest_ops import get_manifest_for_rank as port_view

    def fields(entry):
        return {
            "shape": entry.shape,
            "dtype": entry.dtype,
            "boxes": sorted((s.offsets, s.sizes, s.tensor.location, s.tensor.shape) for s in entry.shards),
            "mesh_shape": entry.mesh_shape,
            "axis_names": entry.axis_names,
            "partition_spec": entry.partition_spec,
        }

    jax_entry = jax_view(jax_snap.metadata, 0)[0]["m/w_f32"]
    port_entry = port_view(port_snap.metadata, 0)[0]["m/w_f32"]
    assert fields(port_entry) == fields(jax_entry)
    assert fields(port_entry)["partition_spec"] == [["shard"], []]
    assert len(port_entry.shards) == 2  # 4 ranks, each HSDP box written once


@pytest.mark.parametrize("taker", ["jax", "port"])
def test_flipped_shard_byte_raises_checksum_error_in_both(tmp_path, monkeypatch, taker):
    """A flipped byte in one shard piece raises ChecksumError in both
    packages, whichever took the snapshot."""
    snap = tmp_path / "snap"
    monkeypatch.setenv("TPUSNAP_TEST_SNAPSHOT", str(snap))
    if taker == "jax":
        JaxSnapshot.take(str(snap), {"m": JaxStateDict(_jax_sharded_state())})
    else:
        parity_take_for_jax()
    entry = ts.Snapshot(str(snap)).get_manifest()["0/m/w_f32"]
    piece = entry.shards[0].tensor
    with open(snap / piece.location, "r+b") as f:
        f.seek((piece.byte_range or [0])[0] + 5)
        byte = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([byte[0] ^ 0x10]))
    with pytest.raises(ts.ChecksumError):
        ts.Snapshot(str(snap)).read_object("0/m/w_f32", device="cpu")
    with pytest.raises(JaxChecksumError):
        JaxSnapshot(str(snap)).read_object("0/m/w_f32")
    parity_restore_raises_checksum_error()


@pytest.mark.parametrize("mode", ASYNC_MODES)
def test_port_multi_rank_async_take_matches_sync_and_jax(tmp_path, monkeypatch, mode):
    """4 gloo ranks async_take HSDP, fully Replicate and uneven Shard(1)
    DTensors and a ``replicated=`` step in each staging mode, mutating
    them right after the return.  The manifest equals that of a sync take
    on the same ranks, entry by entry; the sharded and replicated entries
    equal those of the JAX package's take of the same layouts; and the
    JAX package restores the snapshot into other NamedShardings with the
    values of the take."""
    from torchsnapshot_tpu.manifest import _entry_to_dict as jax_entry_dict
    from torchsnapshot_tpu.manifest_ops import get_manifest_for_rank as jax_view
    from torchsnapshot_tpu_torch.manifest import _entry_to_dict as port_entry_dict
    from torchsnapshot_tpu_torch.manifest_ops import get_manifest_for_rank as port_view

    # Unbatched everywhere: the single-process JAX take would pack small
    # pieces into one slab (test_sharded_entry_fields_match_across_packages).
    monkeypatch.setenv(ts.knobs.DISABLE_BATCHING_ENV_VAR, "1")
    monkeypatch.setenv(ts.knobs.ASYNC_STAGING_ENV_VAR, mode)
    monkeypatch.setenv("TPUSNAP_TEST_CPU_AS_DEVICE", "1")
    monkeypatch.setenv("TPUSNAP_TEST_SNAPSHOT", str(tmp_path))
    parity_async_take_for_jax()

    jax_state = {
        "w_f32": jax.device_put(
            jnp.asarray(_parity_np("w_f32")),
            NamedSharding(_jax_mesh((2, 2), ("replicate", "shard")), P("shard", None)),
        ),
        "w_bf16": jax.device_put(jnp.asarray(_parity_np("w_bf16")), NamedSharding(_jax_mesh((4,), ("x",)), P())),
        "step": 7,
    }
    jax_snap = JaxSnapshot.take(str(tmp_path / "jax"), {"m": JaxStateDict(jax_state)}, replicated=["m/step"])

    docs = {name: json.loads((tmp_path / name / ".snapshot_metadata").read_text()) for name in ("sync", "async")}
    assert docs["async"]["world_size"] == 4
    assert sorted(docs["async"]["manifest"]) == sorted(docs["sync"]["manifest"])
    for key, entry in docs["sync"]["manifest"].items():
        assert docs["async"]["manifest"][key] == entry, key

    def as_dict(entry, to_dict):
        d = to_dict(entry)
        if "shards" in d:
            d["shards"] = sorted(d["shards"], key=lambda s: (s["offsets"], s["sizes"]))
        return d

    def entries(view):
        local, merged = view
        return {path: merged[path] if path in merged else local.get(path) for path in ("m/w_f32", "m/w_bf16", "m/step", "m/w_i32")}

    port_snap = ts.Snapshot(str(tmp_path / "async"))
    jax_entries = entries(jax_view(jax_snap.metadata, 0))
    for rank in range(4):
        port_entries = entries(port_view(port_snap.metadata, rank))
        for path in ("m/w_f32", "m/w_bf16", "m/step"):
            got, want = as_dict(port_entries[path], port_entry_dict), as_dict(jax_entries[path], jax_entry_dict)
            assert got == want, (rank, path)
        # The uneven layout JAX cannot express: each non-empty box once.
        boxes = sorted((s.offsets, s.sizes) for s in port_entries["m/w_i32"].shards)
        assert boxes == [([0, 0], [8, 2]), ([0, 2], [8, 2]), ([0, 4], [8, 2])]
        assert port_entries["m/w_f32"].partition_spec == [["shard"], []]
        assert port_entries["m/w_bf16"].replicated and port_entries["m/step"].replicated

    targets = {
        name: jax.device_put(jnp.zeros(shape, _parity_np(name).dtype), JAX_TARGET_SHARDINGS[name]())
        for name, (shape, _) in PARITY_SHAPES.items()
    }
    dst = {"m": JaxStateDict(dict(targets, step=-1))}
    JaxSnapshot(str(tmp_path / "async")).restore(dst)
    assert dst["m"]["step"] == 7
    for name in PARITY_SHAPES:
        got = dst["m"][name]
        assert got.sharding == targets[name].sharding
        assert _raw(np.asarray(got)) == _raw(_parity_np(name)), name


# ------------------------------------------------ storage depth (0.2/0.4/0.6)
#
# Compression (manifest 0.2.0), content addressing (0.4.0) and
# content-defined chunking (0.6.0): either package takes, the other
# restores bit-exact, and the manifests are equal entry by entry (codec,
# location, byte range, checksum): the same bytes give the same frames,
# the same cas:// digests and the same casx:// boundaries.

import glob  # noqa: E402
import os  # noqa: E402

from test_torch_sharded import STORAGE_DEPTH_VARIANTS, changed_parity_value, parity_storage_depth_4  # noqa: E402

DEPTH_ENVS = {
    "zstd": {"TPUSNAP_COMPRESSION": "zstd", "TPUSNAP_COMPRESSION_MIN_BYTES": "0"},
    "zlib": {"TPUSNAP_COMPRESSION": "zlib", "TPUSNAP_COMPRESSION_MIN_BYTES": "0"},
    "cas": {"TPUSNAP_CAS": "1"},
    "cdc": dict(STORAGE_DEPTH_VARIANTS["cdc"], TPUSNAP_CDC_MIN_BYTES="256", TPUSNAP_CDC_AVG_BYTES="1024", TPUSNAP_CDC_MAX_BYTES="4096"),
    "cas_zstd": {"TPUSNAP_CAS": "1", "TPUSNAP_COMPRESSION": "zstd", "TPUSNAP_COMPRESSION_MIN_BYTES": "1024"},
}
DEPTH_VERSIONS = {"zstd": "0.2.0", "zlib": "0.2.0", "cas": "0.4.0", "cdc": "0.6.0", "cas_zstd": "0.4.0"}


def _set_env(monkeypatch, env):
    for key, value in env.items():
        monkeypatch.setenv(key, value)


def _chunk_files(root):
    return set(glob.glob(os.path.join(str(root), "cas", "*", "*", "*")))


@pytest.mark.parametrize("variant", sorted(DEPTH_ENVS))
def test_storage_depth_crosses_both_ways_with_equal_manifests(tmp_path, monkeypatch, variant):
    state = _numpy_state()
    _set_env(monkeypatch, DEPTH_ENVS[variant])
    with ts.knobs.override_max_chunk_size_bytes(4096):
        JaxSnapshot.take(str(tmp_path / "jax" / "step_0"), {"m": JaxStateDict(state)})
        ts.Snapshot.take(str(tmp_path / "port" / "step_0"), {"m": ts.StateDict(state_from_numpy(state))})
    docs = {pkg: json.loads((tmp_path / pkg / "step_0" / ".snapshot_metadata").read_text()) for pkg in ("jax", "port")}
    assert docs["port"]["version"] == docs["jax"]["version"] == DEPTH_VERSIONS[variant]
    assert sorted(docs["port"]["manifest"]) == sorted(docs["jax"]["manifest"])
    for key, entry in docs["jax"]["manifest"].items():
        assert docs["port"]["manifest"][key] == entry, key
    if variant.startswith("cas") or variant == "cdc":
        assert _chunk_files(tmp_path / "jax") and {
            os.path.relpath(p, tmp_path / "jax") for p in _chunk_files(tmp_path / "jax")
        } == {os.path.relpath(p, tmp_path / "port") for p in _chunk_files(tmp_path / "port")}

    # Restores run with the knobs unset: reading needs none of them.
    for key in DEPTH_ENVS[variant]:
        monkeypatch.delenv(key)
    targets = state_from_numpy(_zeros_numpy(state))
    ptrs = {k: v.data_ptr() for k, v in targets.items() if isinstance(v, torch.Tensor)}
    dst = {"m": ts.StateDict(targets)}
    ts.Snapshot(str(tmp_path / "jax" / "step_0")).restore(dst)
    _assert_same_bytes(state, dst["m"].state_dict())
    for k, ptr in ptrs.items():
        assert dst["m"][k].data_ptr() == ptr, k
    jax_dst = {"m": JaxStateDict(_zeros_numpy(state))}
    JaxSnapshot(str(tmp_path / "port" / "step_0")).restore(jax_dst)
    _assert_same_bytes(state, jax_dst["m"].state_dict())


def _mixed_state(seed):
    rng = np.random.RandomState(seed)
    return {
        "frozen": rng.standard_normal((128, 64)).astype(np.float32),
        "hot": rng.standard_normal((64, 64)).astype(np.float32),
        "small": rng.standard_normal(16).astype(np.float32),
        "step": 3,
    }


@pytest.mark.parametrize("first", ["jax", "port"])
@pytest.mark.parametrize("variant", ["cas", "cdc"])
def test_mixed_root_writes_no_chunk_the_root_holds(tmp_path, monkeypatch, first, variant):
    """One package takes step_0 into a root, the other takes step_1 with
    ``hot`` changed: step_1 writes only chunks of the changed bytes, and
    each package restores the other's step bit-exact."""
    _set_env(monkeypatch, DEPTH_ENVS[variant])
    take = {
        "jax": lambda path, st: JaxSnapshot.take(path, {"m": JaxStateDict(st)}),
        "port": lambda path, st: ts.Snapshot.take(path, {"m": ts.StateDict(state_from_numpy(st))}),
    }
    second = "port" if first == "jax" else "jax"
    root = tmp_path / "root"
    state0 = _mixed_state(0)
    take[first](str(root / "step_0"), state0)
    before = _chunk_files(root)
    state1 = dict(state0, hot=state0["hot"] + 1.0)
    take[second](str(root / "step_1"), state1)
    new = _chunk_files(root) - before
    hot_bytes = state1["hot"].nbytes
    assert new, "the changed tensor wrote nothing"
    assert sum(os.path.getsize(p) for p in new) <= hot_bytes + 2 * 4096

    port_dst = {"m": ts.StateDict(state_from_numpy(_zeros_numpy(state1)))}
    ts.Snapshot(str(root / "step_1")).restore(port_dst)
    _assert_same_bytes(state1, port_dst["m"].state_dict())
    jax_dst = {"m": JaxStateDict(_zeros_numpy(state1))}
    JaxSnapshot(str(root / "step_1")).restore(jax_dst)
    _assert_same_bytes(state1, jax_dst["m"].state_dict())


@pytest.mark.parametrize("base_pkg", ["jax", "port"])
def test_incremental_from_base_of_the_other_package(tmp_path, monkeypatch, base_pkg):
    """``incremental_from`` a base the other package wrote hard-links the
    unchanged payloads (same inode) and rewrites the changed one."""
    monkeypatch.setenv(ts.knobs.DISABLE_BATCHING_ENV_VAR, "1")
    state0 = _mixed_state(1)
    state1 = dict(state0, hot=state0["hot"] * 2.0)
    base, new = tmp_path / "base", tmp_path / "new"
    if base_pkg == "jax":
        JaxSnapshot.take(str(base), {"m": JaxStateDict(state0)})
        ts.Snapshot.take(str(new), {"m": ts.StateDict(state_from_numpy(state1))}, incremental_from=str(base))
    else:
        ts.Snapshot.take(str(base), {"m": ts.StateDict(state_from_numpy(state0))})
        JaxSnapshot.take(str(new), {"m": JaxStateDict(state1)}, incremental_from=str(base))
    for name, linked in (("frozen", True), ("small", True), ("hot", False)):
        loc = f"0/m/{name}"
        same = os.stat(base / loc).st_ino == os.stat(new / loc).st_ino
        assert same == linked, name
    jax_dst = {"m": JaxStateDict(_zeros_numpy(state1))}
    JaxSnapshot(str(new)).restore(jax_dst)
    _assert_same_bytes(state1, jax_dst["m"].state_dict())
    port_dst = {"m": ts.StateDict(state_from_numpy(_zeros_numpy(state1)))}
    ts.Snapshot(str(new)).restore(port_dst)
    _assert_same_bytes(state1, port_dst["m"].state_dict())


def test_jax_manager_sidecar_seeds_the_port_index(tmp_path, monkeypatch):
    """The JAX manager's digest-index sidecar is read as is (the manifests
    are not re-read), and a port take of the same state into the root
    writes no chunk."""
    from torchsnapshot_tpu.manager import SnapshotManager
    from torchsnapshot_tpu_torch import cas

    monkeypatch.setenv("TPUSNAP_CAS", "1")
    root = tmp_path / "root"
    state = _mixed_state(2)
    SnapshotManager(str(root)).save(1, {"m": JaxStateDict(state)})
    assert (root / cas.INDEX_SIDECAR_FNAME).exists()
    doc = json.loads((root / cas.INDEX_SIDECAR_FNAME).read_text())

    def _no_seed(storage):
        raise AssertionError("seeded from manifests although the sidecar is current")

    monkeypatch.setattr(cas, "seed_digest_index", _no_seed)
    storage = ts.storage_plugin.url_to_storage_plugin(str(root))
    try:
        index = cas.load_or_seed_index(str(root), storage, "xxh64")
    finally:
        storage.sync_close()
    assert index.snapshot_keys() == set(doc["keys"]) and index.payload_count() == len(doc["payloads"])
    before = _chunk_files(root)
    ts.Snapshot.take(str(root / "step_2"), {"m": ts.StateDict(state_from_numpy(state))})
    assert _chunk_files(root) == before
    port_dst = {"m": ts.StateDict(state_from_numpy(_zeros_numpy(state)))}
    ts.Snapshot(str(root / "step_2")).restore(port_dst)
    _assert_same_bytes(state, port_dst["m"].state_dict())


def test_multi_rank_storage_depth_both_directions(tmp_path, monkeypatch):
    """4 gloo ranks and the JAX package's 8-device mesh, under compression,
    CAS and CDC: the ranks restore the JAX package's sharded snapshots in
    place into DTensors, and take HSDP, fully Replicate and uneven Shard(1)
    DTensors that the JAX package restores into other NamedShardings; a
    second CAS take with one tensor changed adds only that tensor's
    chunks."""
    for variant, env in STORAGE_DEPTH_VARIANTS.items():
        _set_env(monkeypatch, env)
        JaxSnapshot.take(str(tmp_path / f"jax_{variant}" / "step_0"), {"m": JaxStateDict(_jax_sharded_state())})
        for key in env:
            monkeypatch.delenv(key)
    monkeypatch.setenv("TPUSNAP_TEST_SNAPSHOT", str(tmp_path))
    parity_storage_depth_4()

    versions = {"zstd": "0.2.0", "cas": "0.4.0", "cdc": "0.6.0"}
    for variant in STORAGE_DEPTH_VARIANTS:
        steps = ["step_0"] if variant == "zstd" else ["step_0", "step_1"]
        for step in steps:
            path = tmp_path / f"port_{variant}" / step
            doc = json.loads((path / ".snapshot_metadata").read_text())
            assert doc["world_size"] == 4
            assert doc["version"] == versions[variant]
            targets = {
                name: jax.device_put(jnp.zeros(shape, _parity_np(name).dtype), JAX_TARGET_SHARDINGS[name]())
                for name, (shape, _) in PARITY_SHAPES.items()
            }
            dst = {"m": JaxStateDict(targets)}
            JaxSnapshot(str(path)).restore(dst)
            for name in PARITY_SHAPES:
                want = changed_parity_value(name) if (step == "step_1" and name == "w_bf16") else parity_value(name)
                got = dst["m"][name]
                assert got.sharding == targets[name].sharding
                assert _raw(np.asarray(got)) == want.view(torch.uint8).numpy().tobytes(), (variant, step, name)
        if variant == "zstd":
            continue
        from torchsnapshot_tpu_torch import cas

        refs = {
            step: cas.referenced_chunk_relpaths(ts.Snapshot(str(tmp_path / f"port_{variant}" / step)).metadata.manifest)
            for step in ("step_0", "step_1")
        }
        on_disk = {os.path.relpath(p, tmp_path / f"port_{variant}") for p in _chunk_files(tmp_path / f"port_{variant}")}
        assert on_disk == refs["step_0"] | refs["step_1"]
        new_bytes = sum(os.path.getsize(tmp_path / f"port_{variant}" / rel) for rel in refs["step_1"] - refs["step_0"])
        changed = changed_parity_value("w_bf16").numel() * 2
        assert 0 < new_bytes <= changed + 2 * 256


# ------------------------------------------------ cross-management (manager)
#
# Either package's SnapshotManager manages a root the other wrote: journal
# chains (also mixed-writer ones), gc reports, in-flight markers, the
# digest-index sidecar, and segment manifests for the same change.

from test_torch_sharded import MANAGER_PARITY_LAYOUTS, manager_parity_value, parity_manager_journal_2  # noqa: E402


def _managers():
    from torchsnapshot_tpu.manager import SnapshotManager as JaxManager

    return {"jax": JaxManager, "port": ts.SnapshotManager}


def _mgr_state(seed, step):
    """A manager test state at ``step``: ``frozen`` never changes, ``hot``
    does every step, ``small`` at step 2."""
    rng = np.random.RandomState(seed)
    frozen = rng.standard_normal((64, 32)).astype(np.float32)
    hot = rng.standard_normal((32, 32)).astype(np.float32) + step
    small = rng.standard_normal(16).astype(np.float32) + (step >= 2)
    return {"frozen": frozen, "hot": hot, "small": small, "step": step}


def _mgr_save(pkg, mgr, step, seed=0, **kwargs):
    state = _mgr_state(seed, step)
    app = {"m": JaxStateDict(state)} if pkg == "jax" else {"m": ts.StateDict(state_from_numpy(state))}
    return mgr.save(step, app, **kwargs)


def _restore_both(mgr_by_pkg, step, seed=0, at=None):
    """Restore ``step`` (the latest when ``at`` is None) through both
    packages' managers, each bit-exact against the state."""
    want = _mgr_state(seed, step)
    for pkg, mgr in mgr_by_pkg.items():
        zeros = _zeros_numpy(want)
        app = {"m": JaxStateDict(zeros)} if pkg == "jax" else {"m": ts.StateDict(state_from_numpy(zeros))}
        got = mgr.restore_latest(app) if at is None else mgr.restore_at(at, app)
        assert got == step, pkg
        _assert_same_bytes(want, app["m"].state_dict())


@pytest.fixture
def small_slabs():
    with ts.knobs.override_slab_size_threshold_bytes(64):
        yield


@pytest.mark.parametrize("journal", [False, True])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_manager_root_of_one_package_restores_through_the_other(tmp_path, small_slabs, writer, journal):
    """A root whose base and segments (or full steps) one package wrote is
    replayed by both packages' restore_latest and restore_at, bit-exact."""
    root = str(tmp_path / "ckpts")
    managers = _managers()
    mgr = managers[writer](root, journal=journal)
    for step in (1, 2, 3):
        _mgr_save(writer, mgr, step)
    readers = {pkg: cls(root, journal=journal) for pkg, cls in managers.items()}
    kinds = ["full", "seg", "seg"] if journal else ["full"] * 3
    for reader in readers.values():
        assert reader.restore_points() == list(zip((1, 2, 3), kinds))
    _restore_both(readers, 3)
    for step in (1, 2):
        _restore_both(readers, step, at=step)


def test_mixed_writer_chain_replays_in_both(tmp_path, small_slabs):
    """A base from the port, a segment from the JAX package, then one from
    the port: one chain, replayed bit-exact by both."""
    root = str(tmp_path / "ckpts")
    managers = _managers()
    for step, pkg in ((1, "port"), (2, "jax"), (3, "port")):
        _mgr_save(pkg, managers[pkg](root, journal=True), step)
    readers = {pkg: cls(root, journal=True) for pkg, cls in managers.items()}
    from torchsnapshot_tpu_torch import journal

    storage = ts.storage_plugin.url_to_storage_plugin(root)
    try:
        assert journal.read_segment_metadata(storage, 3).journal["prior_segments"] == [2]
    finally:
        storage.sync_close()
    _restore_both(readers, 3)
    _restore_both(readers, 2, at=2)


def test_gc_reports_agree_across_packages(tmp_path, small_slabs):
    """On one root holding an orphan step, an uncommitted segment, stale
    segments and orphan chunks, both packages' gc_detail(apply=False) name
    the same steps, chunks and segments, and applied on two copies of the
    root they remove the same (the chunks only a swept stale segment
    referenced too); the JAX package then finds nothing left."""
    import shutil
    from torchsnapshot_tpu.io_types import WriteIO as JaxWriteIO
    from torchsnapshot_tpu.storage_plugin import url_to_storage_plugin as jax_plugin

    from torchsnapshot_tpu_torch import journal

    root = tmp_path / "ckpts"
    managers = _managers()
    with ts.knobs.override_journal_max_segments(100):
        _mgr_save("jax", managers["jax"](str(root), journal=True), 1)
        for step in (2, 3):
            _mgr_save("port", managers["port"](str(root), journal=True), step)
    storage = ts.storage_plugin.url_to_storage_plugin(str(root))
    try:
        merged, _ = journal.merged_metadata(storage, 3)
    finally:
        storage.sync_close()
    jax_storage = jax_plugin(str(root))
    try:  # a fold that crashed before it swept its segments
        jax_storage.sync_write(JaxWriteIO(path="step_3/.snapshot_metadata", buf=merged.to_json().encode(), durable=True))
    finally:
        jax_storage.sync_close()
    (root / "step_7").mkdir()
    (root / "step_7" / "0").write_bytes(b"torn")
    (root / "seg_8").mkdir()
    (root / "cas" / "xxh64" / "ab").mkdir(parents=True, exist_ok=True)
    (root / "cas" / "xxh64" / "ab" / "abababababababab").write_bytes(b"debris")
    reports = {pkg: cls(str(root)).gc_detail(apply=False) for pkg, cls in managers.items()}
    assert reports["port"] == reports["jax"]
    steps, chunks, segs = reports["port"]
    assert steps == [7] and segs == [2, 3, 8] and "cas/xxh64/ab/abababababababab" in chunks
    shutil.copytree(root, tmp_path / "copy")
    applied = managers["port"](str(root)).gc_detail(apply=True)
    assert applied == managers["jax"](str(tmp_path / "copy")).gc_detail(apply=True)
    assert applied[0] == steps and applied[2] == segs and set(chunks) < set(applied[1])
    assert managers["jax"](str(root)).gc_detail(apply=False) == ([], [], [])
    _restore_both({pkg: cls(str(root)) for pkg, cls in managers.items()}, 3)


@pytest.mark.parametrize("marker_pkg", ["jax", "port"])
def test_live_inflight_marker_of_one_blocks_the_others_gc(tmp_path, marker_pkg):
    """A refreshed in-flight marker one package's manager holds blocks the
    other's applied gc unless force; once released, gc runs."""
    root = tmp_path / "ckpts"
    managers = _managers()
    owner = managers[marker_pkg](str(root))
    _mgr_save(marker_pkg, owner, 1)
    (root / "step_2").mkdir()
    owner._write_inflight_marker(2, "step")
    try:
        other = managers["port" if marker_pkg == "jax" else "jax"](str(root))
        with pytest.raises(RuntimeError, match="in-flight save marker"):
            other.gc(apply=True)
        assert (root / "step_2").exists()
        assert other.gc(apply=False) == [2]
    finally:
        owner._remove_inflight_marker(2, "step")
    assert other.gc(apply=True) == [2]
    owner._write_inflight_marker(3, "step")
    (root / "step_3").mkdir()
    try:
        assert other.gc(apply=True, force=True) == [3]
    finally:
        owner._remove_inflight_marker(3, "step")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_digest_index_sidecar_seeds_the_other_package(tmp_path, monkeypatch, small_slabs, writer):
    """The .digest_index.json one package's manager writes is loaded by the
    other's without re-reading manifests, with the same keys and payloads,
    and a save of an unchanged state through the other writes no chunk."""
    from torchsnapshot_tpu import cas as jax_cas
    from torchsnapshot_tpu.storage_plugin import url_to_storage_plugin as jax_plugin

    from torchsnapshot_tpu_torch import cas

    root = tmp_path / "root"
    managers = _managers()
    with ts.knobs.override_cas(True):
        _mgr_save(writer, managers[writer](str(root)), 1)
    doc = json.loads((root / cas.INDEX_SIDECAR_FNAME).read_text())

    def _no_seed(*args, **kwargs):
        raise AssertionError("seeded from manifests although the sidecar is current")

    monkeypatch.setattr(cas, "seed_digest_index", _no_seed)
    monkeypatch.setattr(jax_cas, "seed_digest_index", _no_seed)
    loaded = {}
    for pkg, plugin, mod in (("port", ts.storage_plugin.url_to_storage_plugin, cas), ("jax", jax_plugin, jax_cas)):
        storage = plugin(str(root))
        try:
            loaded[pkg] = mod.load_or_seed_index(str(root), storage, "xxh64")
        finally:
            storage.sync_close()
    for index in loaded.values():
        assert index.snapshot_keys() == set(doc["keys"]) and index.payload_count() == len(doc["payloads"])
    other = "port" if writer == "jax" else "jax"
    before = _chunk_files(root)
    with ts.knobs.override_cas(True):
        state = _mgr_state(0, 1)
        app = {"m": JaxStateDict(state)} if other == "jax" else {"m": ts.StateDict(state_from_numpy(state))}
        managers[other](str(root)).save(2, app)
    assert _chunk_files(root) == before
    persisted = json.loads((root / cas.INDEX_SIDECAR_FNAME).read_text())
    assert persisted["committed"] == ["step_1/.snapshot_metadata", "step_2/.snapshot_metadata"]


def test_segment_manifests_agree_across_packages(tmp_path, small_slabs):
    """For the same state and the same change, the two packages' managers
    commit equal base and segment manifests, entry by entry."""
    managers = _managers()
    for pkg, cls in managers.items():
        mgr = cls(str(tmp_path / pkg), journal=True)
        for step in (1, 2, 3):
            _mgr_save(pkg, mgr, step)
    for marker in ("step_1", "seg_2", "seg_3"):
        docs = {pkg: json.loads((tmp_path / pkg / marker / ".snapshot_metadata").read_text()) for pkg in managers}
        assert sorted(docs["port"]["manifest"]) == sorted(docs["jax"]["manifest"]), marker
        for key, entry in docs["jax"]["manifest"].items():
            assert docs["port"]["manifest"][key] == entry, (marker, key)
        assert docs["port"].get("journal") == docs["jax"].get("journal"), marker
        assert docs["port"]["version"] == docs["jax"]["version"]


def test_two_rank_journal_root_restores_through_the_jax_manager(tmp_path, monkeypatch):
    """2 gloo ranks take HSDP and uneven Shard DTensors through a journal
    manager (a base, then a segment) and replay it; the JAX package's
    manager then restores the root into NamedShardings, bit-exact."""
    from torchsnapshot_tpu.manager import SnapshotManager as JaxManager

    root = tmp_path / "ckpts"
    monkeypatch.setenv("TPUSNAP_TEST_SNAPSHOT", str(root))
    parity_manager_journal_2()
    shardings = {
        "w_f32": NamedSharding(_jax_mesh((4, 2), ("x", "y")), P("y", None)),
        "w_bf16": NamedSharding(_jax_mesh((2, 4), ("a", "b")), P(None, "b")),
        "uneven": NamedSharding(_jax_mesh((8,), ("x",)), P(None, None)),
    }
    targets = {}
    for name in MANAGER_PARITY_LAYOUTS:
        want = manager_parity_value(name, 2)
        np_dtype = ml_dtypes.bfloat16 if want.dtype == torch.bfloat16 else want.numpy().dtype
        targets[name] = jax.device_put(jnp.zeros(tuple(want.shape), np_dtype), shardings[name])
    dst = {"m": JaxStateDict(dict(targets, step=-1))}
    assert JaxManager(str(root), journal=True).restore_latest(dst) == 2
    assert dst["m"]["step"] == 2
    for name in MANAGER_PARITY_LAYOUTS:
        got = dst["m"][name]
        assert got.sharding == targets[name].sharding
        assert _raw(np.asarray(got)) == manager_parity_value(name, 2).view(torch.uint8).numpy().tobytes(), name


# ------------------------------------------------------- host data plane

import hashlib  # noqa: E402

from torchsnapshot_tpu import native_io as jax_native_io  # noqa: E402
from torchsnapshot_tpu_torch import phase_stats  # noqa: E402
from torchsnapshot_tpu_torch.native_io import NativeFileIO  # noqa: E402

PLANE_ON = {"TPUSNAP_DIRECT_IO": "1", "TPUSNAP_NATIVE_BATCH": "8"}
PLANE_OFF = {"TPUSNAP_DIRECT_IO": "0", "TPUSNAP_NATIVE_BATCH": "0"}


def _plane_state():
    """A striped leaf, a mid-sized one, and 48 small leaves (each its own
    payload with the slab batcher off, so the micro-batcher has members)."""
    rng = np.random.default_rng(17)
    return {
        "big": rng.standard_normal((33 << 20) // 4 + 1000).astype(np.float32),
        "mid": rng.integers(0, 1 << 30, (300, 257), dtype=np.int64),
        **{f"leaf{i}": rng.standard_normal((24, 40 + i)).astype(np.float32) for i in range(48)},
        "step": 5,
    }


def _payload_digests(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            rel = os.path.relpath(os.path.join(dirpath, name), root)
            if not (name.startswith(".") or rel.startswith("telemetry/")):
                with open(os.path.join(dirpath, name), "rb") as f:
                    out[rel] = hashlib.sha1(f.read()).hexdigest()
    return out


@pytest.mark.parametrize("slab_batching", [False, True], ids=["slabs_off", "slabs_on"])
@pytest.mark.parametrize("port_knobs", ["on", "off"], ids=["port_direct_batched", "jax_direct_batched"])
def test_data_plane_knobs_leave_the_bytes_identical_across_packages(tmp_path, monkeypatch, port_knobs, slab_batching):
    """One package takes with direct I/O and micro-batching on, the other
    with both off: every payload file and every manifest entry (digests
    included) are identical, and each package restores the other's
    snapshot bit-exact."""
    state = _plane_state()
    monkeypatch.setenv("TPUSNAP_SIDECAR", "0")
    monkeypatch.setenv("TPUSNAP_DISABLE_BATCHER", "0" if slab_batching else "1")
    port_env, jax_env = (PLANE_ON, PLANE_OFF) if port_knobs == "on" else (PLANE_OFF, PLANE_ON)
    jax_native = jax_native_io.NativeFileIO.maybe_create()
    try:
        _set_env(monkeypatch, port_env)
        phase_stats.reset()
        ts.Snapshot.take(str(tmp_path / "port"), {"m": ts.StateDict(state_from_numpy(state))})
        port_mode = NativeFileIO.get().direct_io_mode()
        batched = phase_stats.snapshot().get("native_write_batched", {}).get("n", 0)
        _set_env(monkeypatch, jax_env)
        JaxSnapshot.take(str(tmp_path / "jax"), {"m": JaxStateDict(state)})
        jax_mode = jax_native.direct_io_mode()
    finally:
        jax_native.configure_direct_io(False)
    on_mode, off_mode = (port_mode, jax_mode) if port_knobs == "on" else (jax_mode, port_mode)
    assert on_mode in (1, 2, 3) and off_mode == 0
    assert (batched > 0) == (port_knobs == "on" and not slab_batching)
    digests = _payload_digests(tmp_path / "port")
    assert digests and digests == _payload_digests(tmp_path / "jax")
    docs = {pkg: json.loads((tmp_path / pkg / ".snapshot_metadata").read_text()) for pkg in ("jax", "port")}
    assert docs["port"]["manifest"] == docs["jax"]["manifest"]

    for key in PLANE_ON:
        monkeypatch.delenv(key)
    targets = state_from_numpy(_zeros_numpy(state))
    ts.Snapshot(str(tmp_path / "jax")).restore({"m": ts.StateDict(targets)})
    _assert_same_bytes(state, targets)
    jax_dst = {"m": JaxStateDict(_zeros_numpy(state))}
    JaxSnapshot(str(tmp_path / "port")).restore(jax_dst)
    _assert_same_bytes(state, jax_dst["m"].state_dict())
