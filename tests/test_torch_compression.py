"""The port's compression codecs and frames (torchsnapshot_tpu_torch.
compression), mirrors of tests/test_compression.py (all but the CLI case),
plus the frames held byte for byte against the JAX package's encoder and
a decode straight into a caller's buffer.  Inputs are made from seeded
numpy generators; every comparison is exact."""

import json
import random

import ml_dtypes
import numpy as np
import pytest
import torch

from torchsnapshot_tpu import compression as jax_compression
from torchsnapshot_tpu_torch import Snapshot, StateDict, compression, knobs
from torchsnapshot_tpu_torch.compression import FrameError
from torchsnapshot_tpu_torch.manifest import (
    FRAMED_MANIFEST_VERSION,
    MANIFEST_VERSION,
    SnapshotMetadata,
    TensorEntry,
    UnsupportedSnapshotError,
)
from torchsnapshot_tpu_torch.serialization import state_from_numpy

from torch_env import default_knob_env  # noqa: F401  autouse fixture

ALL_CODEC_NAMES = ["raw", "zstd", "lz4", "zlib"]

_DTYPES = [
    np.float32,
    np.float64,
    np.int16,
    np.uint8,
    np.bool_,
    ml_dtypes.bfloat16,
    ml_dtypes.float8_e4m3fn,
]


@pytest.mark.parametrize("codec", ALL_CODEC_NAMES)
@pytest.mark.parametrize("seed", range(4))
def test_frame_roundtrip_property(codec, seed):
    """Random dtypes and shapes under every codec: encode→decode is
    bit-exact, a fallback is recorded honestly, and the frame equals the
    JAX package's for the same bytes wherever both resolve the codec."""
    rng = random.Random(seed * 31 + ALL_CODEC_NAMES.index(codec))
    np_rng = np.random.RandomState(seed)
    dtype = rng.choice(_DTYPES)
    shape = tuple(rng.randrange(1, 40) for _ in range(rng.randrange(0, 4)))
    arr = (np_rng.uniform(-4, 4, size=shape) if rng.random() < 0.5 else np.zeros(shape)).astype(dtype)
    raw = arr.tobytes()

    resolved = compression.resolve(codec)
    frame, inner = compression.encode(raw, resolved)
    assert inner in ("raw", "zstd", "zlib")
    if resolved == "raw":
        assert inner == "raw"
    assert bytes(compression.decode(frame, expected_nbytes=len(raw))) == raw
    if jax_compression.resolve(codec) == resolved:
        jax_frame, jax_inner = jax_compression.encode(raw, resolved)
        assert (jax_inner, bytes(jax_frame)) == (inner, bytes(frame))
    assert bytes(jax_compression.decode(frame, expected_nbytes=len(raw))) == raw


def test_zlib_actually_compresses():
    data = bytes(1 << 20)
    frame, inner = compression.encode(data, "zlib")
    assert inner == "zlib"
    assert len(frame) < len(data) // 100
    assert bytes(compression.decode(frame, expected_nbytes=len(data))) == data


def test_incompressible_falls_back_to_raw_in_frame():
    data = np.random.RandomState(0).bytes(1 << 16)
    frame, inner = compression.encode(data, "zlib")
    assert inner == "raw"
    assert len(frame) == len(data) + compression.HEADER_BYTES
    assert bytes(compression.decode(frame)) == data


def test_missing_codec_resolves_to_raw():
    """lz4 has no backend in the port: it resolves to raw (never raises);
    an unknown name raises."""
    for name in ("zstd", "lz4"):
        assert compression.resolve(name) in (name, "raw")
    assert compression.resolve("lz4") == "raw"
    assert "lz4" not in compression.available_codecs()
    with pytest.raises(ValueError, match="Unknown compression codec"):
        compression.get_codec("snappy")


@pytest.mark.parametrize(
    "mutate",
    ["truncate_header", "truncate_body", "bad_magic", "bad_length", "bad_codec_id", "flip_body"],
)
def test_corrupted_frame_clean_error(mutate):
    data = bytes(range(256)) * 64
    frame, inner = compression.encode(data, "zlib")
    assert inner == "zlib"
    frame = bytearray(frame)
    if mutate == "truncate_header":
        frame = frame[:8]
    elif mutate == "truncate_body":
        frame = frame[: compression.HEADER_BYTES + 3]
    elif mutate == "bad_magic":
        frame[0] ^= 0xFF
    elif mutate == "bad_length":
        frame[8] ^= 0xFF
    elif mutate == "bad_codec_id":
        frame[4] = 250
    elif mutate == "flip_body":
        frame[compression.HEADER_BYTES + 1] ^= 0xFF
    with pytest.raises(FrameError):
        compression.decode(bytes(frame), expected_nbytes=len(data))


def test_decode_length_mismatch_vs_manifest():
    frame, _ = compression.encode(bytes(64), "raw")
    with pytest.raises(FrameError, match="manifest implies"):
        compression.decode(frame, expected_nbytes=65)


@pytest.mark.parametrize("codec", ["zstd", "zlib", "raw"])
def test_decode_into_caller_buffer(codec):
    """The restore path decodes straight into its destination (a pinned
    read buffer on CUDA): the result is a view of that buffer."""
    data = (np.random.RandomState(5).standard_normal(1 << 19) * 0.01).astype(ml_dtypes.bfloat16).tobytes()
    frame, _ = compression.encode(data, codec)
    out = np.zeros(len(data), dtype=np.uint8)
    got = compression.decode(frame, expected_nbytes=len(data), out=memoryview(out))
    assert got.obj is memoryview(out).obj or np.shares_memory(np.frombuffer(got, np.uint8), out)
    assert out.tobytes() == data
    with pytest.raises(ValueError, match="destination holds"):
        compression.decode(frame, out=memoryview(np.empty(len(data) - 1, np.uint8)))


@pytest.mark.parametrize("codec", ["zstd", "zlib"])
def test_snapshot_roundtrip_all_entry_types(tmp_path, codec, monkeypatch):
    """Dense, bf16, chunked tensors, objects and primitives round-trip
    bit-exact under a codec, restored under another environment (the
    frame header drives decoding).  Sharded entries are covered on gloo
    ranks in test_torch_parity.py."""
    monkeypatch.setenv("TPUSNAP_COMPRESSION", codec)
    monkeypatch.setenv("TPUSNAP_COMPRESSION_MIN_BYTES", "0")
    state = {
        "dense": np.arange(4096, dtype=np.float32).reshape(64, 64),
        "bf16": np.arange(256, dtype=np.float32).astype(ml_dtypes.bfloat16),
        "big": np.arange(32 * 256, dtype=np.float32).reshape(32, 256),
        "obj": {"nested": [1, 2, 3]},
        "prim": 42,
    }
    with knobs.override_max_chunk_size_bytes(16 * 1024):
        snapshot = Snapshot.take(str(tmp_path / "snap"), {"m": StateDict(state_from_numpy(dict(state)))})
    man = snapshot.get_manifest()
    assert man["0/m/dense"].codec == codec
    assert man["0/m/dense"].compressed_nbytes is not None
    assert man["0/m/big"].type == "ChunkedTensor"
    assert all(c.tensor.codec == codec for c in man["0/m/big"].chunks)

    monkeypatch.delenv("TPUSNAP_COMPRESSION")
    dst = {
        "m": StateDict(
            {
                "dense": torch.zeros(64, 64),
                "bf16": torch.zeros(256, dtype=torch.bfloat16),
                "big": torch.zeros(32, 256),
                "obj": None,
                "prim": 0,
            }
        )
    }
    ptr = dst["m"]["dense"].data_ptr()
    Snapshot(str(tmp_path / "snap")).restore(dst)
    sd = dst["m"].state_dict()
    assert sd["dense"].data_ptr() == ptr
    np.testing.assert_array_equal(sd["dense"].numpy(), state["dense"])
    assert sd["bf16"].view(torch.uint8).numpy().tobytes() == state["bf16"].tobytes()
    np.testing.assert_array_equal(sd["big"].numpy(), state["big"])
    assert sd["obj"] == {"nested": [1, 2, 3]}
    assert sd["prim"] == 42
    # read_object of a framed chunked entry, and a tiled read budget that a
    # frame ignores (it is read whole).
    got = Snapshot(str(tmp_path / "snap")).read_object("0/m/big", device="cpu", memory_budget_bytes=4096)
    np.testing.assert_array_equal(got.numpy(), state["big"])


def test_compression_min_bytes_floor(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUSNAP_COMPRESSION", "zlib")
    monkeypatch.setenv("TPUSNAP_COMPRESSION_MIN_BYTES", str(1 << 12))
    state = {"small": torch.zeros(16), "large": torch.zeros(4096)}
    man = Snapshot.take(str(tmp_path / "snap"), {"m": StateDict(state)}).get_manifest()
    assert man["0/m/small"].codec is None
    assert man["0/m/large"].codec == "zlib"
    assert man["0/m/large"].compressed_nbytes < 4096 * 4


def test_compressed_entries_not_slab_batched(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUSNAP_COMPRESSION", "zlib")
    monkeypatch.setenv("TPUSNAP_COMPRESSION_MIN_BYTES", str(1 << 10))
    state = {f"w{i}": torch.zeros(512) for i in range(8)}
    state.update({f"t{i}": torch.zeros(16) for i in range(8)})
    man = Snapshot.take(str(tmp_path / "snap"), {"m": StateDict(state)}).get_manifest()
    for i in range(8):
        assert man[f"0/m/w{i}"].codec == "zlib"
        assert man[f"0/m/w{i}"].byte_range is None
        assert man[f"0/m/t{i}"].codec is None
        assert man[f"0/m/t{i}"].byte_range is not None
    dst = {"m": StateDict({k: torch.ones_like(v) for k, v in state.items()})}
    Snapshot(str(tmp_path / "snap")).restore(dst)
    for k, v in state.items():
        assert torch.equal(dst["m"][k], v)


def test_old_manifest_without_codec_field_loads():
    old_json = json.dumps(
        {
            "version": "0.1.0",
            "world_size": 1,
            "manifest": {
                "0/m/w": {
                    "type": "Tensor",
                    "location": "0/m/w",
                    "serializer": "buffer_protocol",
                    "dtype": "float32",
                    "shape": [4, 4],
                    "replicated": False,
                    "checksum": "xxh64:0123456789abcdef",
                }
            },
        }
    )
    md = SnapshotMetadata.from_json(old_json)
    entry = md.manifest["0/m/w"]
    assert isinstance(entry, TensorEntry)
    assert entry.codec is None and entry.compressed_nbytes is None
    assert not compression.is_framed(entry)
    round_tripped = json.loads(md.to_json())
    assert "codec" not in round_tripped["manifest"]["0/m/w"]
    assert "compressed_nbytes" not in round_tripped["manifest"]["0/m/w"]


def test_uncompressed_snapshot_restores_with_compression_configured(tmp_path, monkeypatch):
    value = torch.arange(8192, dtype=torch.float32)
    Snapshot.take(str(tmp_path / "snap"), {"m": StateDict({"w": value.clone()})})
    monkeypatch.setenv("TPUSNAP_COMPRESSION", "zlib")
    monkeypatch.setenv("TPUSNAP_COMPRESSION_MIN_BYTES", "0")
    dst = {"m": StateDict({"w": torch.zeros(8192)})}
    Snapshot(str(tmp_path / "snap")).restore(dst)
    assert torch.equal(dst["m"]["w"], value)


def test_manifest_version_gates_framed_snapshots(tmp_path, monkeypatch):
    state = {"w": torch.zeros(8192)}
    raw_snap = Snapshot.take(str(tmp_path / "raw"), {"m": StateDict(dict(state))})
    assert raw_snap.metadata.version == MANIFEST_VERSION
    monkeypatch.setenv("TPUSNAP_COMPRESSION", "zlib")
    monkeypatch.setenv("TPUSNAP_COMPRESSION_MIN_BYTES", "0")
    Snapshot.take(str(tmp_path / "comp"), {"m": StateDict(dict(state))})
    assert Snapshot(str(tmp_path / "comp")).metadata.version == FRAMED_MANIFEST_VERSION
    dst = {"m": StateDict({"w": torch.ones(8192)})}
    Snapshot(str(tmp_path / "comp")).restore(dst)
    assert torch.equal(dst["m"]["w"], state["w"])
    future = json.dumps({"version": "0.3.0", "world_size": 1, "manifest": {}})
    with pytest.raises(UnsupportedSnapshotError, match="newer than this reader"):
        SnapshotMetadata.from_json(future)


def test_compression_knob_parsing(monkeypatch):
    monkeypatch.delenv("TPUSNAP_COMPRESSION", raising=False)
    assert knobs.get_compression() == ("raw", None)
    for off in ("raw", "none", "off", "0", " off ", "raw "):
        monkeypatch.setenv("TPUSNAP_COMPRESSION", off)
        assert knobs.get_compression() == ("raw", None)
    monkeypatch.setenv("TPUSNAP_COMPRESSION", "zstd")
    assert knobs.get_compression() == ("zstd", None)
    monkeypatch.setenv("TPUSNAP_COMPRESSION", "zstd:6")
    assert knobs.get_compression() == ("zstd", 6)
    monkeypatch.setenv("TPUSNAP_COMPRESSION", "ZLIB:1")
    assert knobs.get_compression() == ("zlib", 1)
    monkeypatch.setenv("TPUSNAP_COMPRESSION", "zstd:x")
    with pytest.raises(ValueError, match="not an integer"):
        knobs.get_compression()
    with knobs.override_compression("lz4:9"):
        assert knobs.get_compression() == ("lz4", 9)
    with knobs.override_compression_min_bytes(123):
        assert knobs.get_compression_min_bytes() == 123


def test_memoryview_stream_reads_and_seeks():
    from torchsnapshot_tpu_torch.memoryview_stream import MemoryviewStream

    data = np.arange(100, dtype=np.uint8)
    stream = MemoryviewStream(memoryview(data))
    assert stream.read(10) == bytes(range(10))
    assert stream.seek(-5, 2) == 95 and stream.read() == bytes(range(95, 100))
    stream.seek(50)
    buf = bytearray(8)
    assert stream.readinto(buf) == 8 and bytes(buf) == bytes(range(50, 58))
    assert stream.tell() == 58
