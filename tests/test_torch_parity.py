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
