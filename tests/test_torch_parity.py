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
