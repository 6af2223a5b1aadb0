"""The port's native data plane held against the JAX package's: digests by
every route, fused and batched writes, ranged reads, micro-batched and
direct-I/O takes, and the data plane knobs (mirrors the cases of
tests/test_native_parity.py that apply to a port whose native library is
required).  Inputs are made from a seed with numpy; comparisons are exact."""

import hashlib
import logging
import os
import struct

import numpy as np
import pytest
import torch

import torchsnapshot_tpu_torch as ts
from torchsnapshot_tpu import Snapshot as JaxSnapshot
from torchsnapshot_tpu import StateDict as JaxStateDict
from torchsnapshot_tpu import integrity as jax_integrity
from torchsnapshot_tpu import knobs as jax_knobs
from torchsnapshot_tpu.native_io import striped_hash64 as jax_striped_hash64
from torchsnapshot_tpu_torch import event_handlers, integrity, knobs, phase_stats
from torchsnapshot_tpu_torch._native import build as native_build
from torchsnapshot_tpu_torch.native_io import STRIPE_BYTES, STRIPED_MIN_BYTES, NativeFileIO
from torchsnapshot_tpu_torch.serialization import state_from_numpy
from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin, _FusedWriteBatcher

from torch_env import default_knob_env, no_leaked_threads  # noqa: F401  fixtures

pytestmark = pytest.mark.usefixtures("no_leaked_threads")

# Just over the striping threshold (33 MiB of float32): real stripe
# parallelism at a size the CPU tests can afford.
_BIG_N = (STRIPED_MIN_BYTES // 4) + 300_000


def _bytes(seed: int, n: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


def _state():
    rng = np.random.default_rng(3)
    return {
        "big": np.arange(_BIG_N, dtype=np.float32),  # striped digest
        "mid": rng.random((512, 512), dtype=np.float32),
        **{f"tiny{i}": np.full((64,), i, np.float32) for i in range(12)},  # slab members
        "obj": {"nested": [1, "two", 3.0]},
    }


def _leaf_state(n: int = 64):
    return {f"leaf{i}": np.random.default_rng(i).random((32, 32), dtype=np.float32) for i in range(n)}


def _take(path, state):
    return ts.Snapshot.take(str(path), {"m": ts.StateDict(state_from_numpy(state))})


def _dir_digest(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for fname in sorted(files):
            path = os.path.join(dirpath, fname)
            rel = os.path.relpath(path, root)
            if rel.startswith("telemetry/"):
                continue  # op-id-named sidecars, not payload
            with open(path, "rb") as f:
                out[rel] = hashlib.sha1(f.read()).hexdigest()
    return out


def _restore_and_check(snapshot, state):
    zeros = {k: np.zeros_like(v) if isinstance(v, np.ndarray) else v for k, v in state.items()}
    targets = state_from_numpy(zeros)
    snapshot.restore({"m": ts.StateDict(targets)})
    for k, v in state.items():
        if isinstance(v, np.ndarray):
            assert targets[k].numpy().tobytes() == v.tobytes(), k
        else:
            assert targets[k] == v, k


def _native() -> NativeFileIO:
    return NativeFileIO.get()


# ------------------------------------------------------------- digests


def test_digest_policy_is_size_only(monkeypatch):
    """The port's digest equals the JAX package's native and pure-Python
    digests of the same bytes, plain below the striping threshold and
    striped above it."""
    small = _bytes(11, 100_000)
    big = _bytes(12, STRIPED_MIN_BYTES + 12_345)
    port = (integrity.digest(small), integrity.digest(big))
    assert port[0].startswith("xxh64:") and port[1].startswith("xxh64s:")
    assert port == (jax_integrity.digest(small), jax_integrity.digest(big))
    monkeypatch.setenv("TPUSNAP_NATIVE", "0")  # the JAX package's pure-Python route
    assert port == (jax_integrity.digest(small), jax_integrity.digest(big))


def test_striped_digest_matches_python_reference():
    """The xxh64s combination: per-STRIPE_BYTES xxh64 digests, combined by
    xxh64 over their little-endian u64 stream (seed 0 throughout)."""
    xxhash = pytest.importorskip("xxhash")
    data = _bytes(5, 3 * STRIPE_BYTES + 777)
    packed = b"".join(
        struct.pack("<Q", xxhash.xxh64(data[o : o + STRIPE_BYTES]).intdigest())
        for o in range(0, len(data), STRIPE_BYTES)
    )
    expected = xxhash.xxh64(packed).intdigest()
    native = _native()
    assert native.xxhash64_striped(data) == expected
    assert jax_striped_hash64(memoryview(data), native.xxhash64) == expected
    assert integrity._hash64(data, "xxh64s") == expected


def test_fused_write_hash_matches_separate_passes(tmp_path):
    """The fused write's digests equal separate hashing of each part, in
    both packages: manifests cannot depend on the route."""
    parts = [_bytes(7 + i, n) for i, n in enumerate((0, 5, 1_000_000, STRIPED_MIN_BYTES + 3))]
    path = str(tmp_path / "fused.bin")
    hashes = _native().write_parts_hash(path, parts)
    with open(path, "rb") as f:
        assert f.read() == b"".join(parts)
    for h, part in zip(hashes, parts):
        assert integrity.format_digest(h, len(part)) == integrity.digest(part) == jax_integrity.digest(part)


def test_read_ranges_into_parity(tmp_path):
    data = _bytes(9, STRIPED_MIN_BYTES + 50_000)
    path = str(tmp_path / "r.bin")
    with open(path, "wb") as f:
        f.write(data)
    native = _native()
    ranges = [(0, 10_000), (10_000, len(data))]
    views = [bytearray(end - off) for off, end in ranges]
    hashes = native.read_ranges_into(path, ranges, views, want_hash=True)
    for (off, end), view, h in zip(ranges, views, hashes):
        assert bytes(view) == data[off:end]
        assert integrity.format_digest(h, end - off) == jax_integrity.digest(data[off:end])
    views2 = [bytearray(end - off) for off, end in ranges]
    assert native.read_ranges_into(path, ranges, views2) is None
    assert all(bytes(v) == data[off:end] for (off, end), v in zip(ranges, views2))
    # The sequential one-stream read lands the same bytes.
    whole = bytearray(len(data) - 3)
    native.read_file_into(path, 3, whole)
    assert bytes(whole) == data[3:]
    with pytest.raises(OSError):
        native.read_file_into(path, 4, bytearray(len(data)))  # past the end


# ------------------------------------------------------ batched dispatch


def test_batched_write_hash_matches_single(tmp_path):
    """The batch call's per-part digests and bytes on disk equal what N
    single fused calls produce."""
    rng = np.random.default_rng(21)
    native = _native()
    jobs = []
    for f in range(6):
        parts = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in (0, 17, 64 << 10, (1 << 20) + 3)[: f % 4 + 1]]
        jobs.append((str(tmp_path / f"batch_{f}"), parts))
    results = native.write_parts_hash_batch(jobs)
    assert len(results) == len(jobs)
    for (path, parts), hashes in zip(jobs, results):
        assert not isinstance(hashes, OSError)
        assert hashes == native.write_parts_hash(path + ".single", parts)
        with open(path, "rb") as f:
            assert f.read() == b"".join(parts)
        for h, part in zip(hashes, parts):
            assert integrity.format_digest(h, len(part)) == jax_integrity.digest(part)


def test_batched_write_error_isolation(tmp_path):
    """One member's failing write (a missing parent directory) is ITS
    OSError while its sibling's write and digest complete."""
    good = str(tmp_path / "good")
    bad = str(tmp_path / "no_such_dir" / "bad")
    payload = b"x" * 10_000
    results = _native().write_parts_hash_batch([(bad, [payload]), (good, [payload])])
    assert isinstance(results[0], OSError) and results[0].filename == bad
    assert results[1] == [_native().xxhash64(payload)]
    with open(good, "rb") as f:
        assert f.read() == payload


def _member(path, parts):
    return {"path": path, "parts": parts, "done": False, "result": None, "error": None}


def test_batcher_coalesces_pending_members_up_to_its_cap(tmp_path):
    """A leader takes every member pending when it leads, at most the cap
    per native call, and leads again while its own write is pending; a
    failing member gets its own error and its siblings their digests."""
    native = _native()
    batcher = _FusedWriteBatcher(native, 8)
    payloads = [_bytes(30 + i, 1000 + i) for i in range(10)]
    pending = [_member(str(tmp_path / f"m{i}"), [payloads[i]]) for i in range(9)]
    pending[4]["path"] = str(tmp_path / "missing" / "m4")
    batcher._pending.extend(pending)
    phase_stats.reset()
    own = batcher.write(str(tmp_path / "own"), [payloads[9]])
    stats = phase_stats.snapshot()
    assert stats["native_write_batch"]["n"] == 2  # 8 members, then 1 + its own
    assert stats["native_write_batched"]["n"] == 1
    assert own == [native.xxhash64(payloads[9])]
    for i, m in enumerate(pending):
        assert m["done"]
        if i == 4:
            assert isinstance(m["error"], FileNotFoundError) and m["result"] is None
        else:
            assert m["result"] == [native.xxhash64(payloads[i])] and m["error"] is None
            assert (tmp_path / f"m{i}").read_bytes() == payloads[i]


def test_batcher_falls_back_to_single_calls_when_the_batch_call_fails(tmp_path, monkeypatch):
    """A failed whole batch call writes every member through its own native
    single call, so batching never loses a write the single path makes."""
    native = _native()

    def _broken(jobs):
        raise RuntimeError("batch entry point failed")

    monkeypatch.setattr(native, "write_parts_hash_batch", _broken)
    batcher = _FusedWriteBatcher(native, 8)
    sibling = _member(str(tmp_path / "sib"), [b"s" * 300])
    batcher._pending.append(sibling)
    assert batcher.write(str(tmp_path / "own"), [b"o" * 500]) == [native.xxhash64(b"o" * 500)]
    assert sibling["result"] == [native.xxhash64(b"s" * 300)]
    assert (tmp_path / "sib").read_bytes() == b"s" * 300 and (tmp_path / "own").read_bytes() == b"o" * 500


@pytest.mark.parametrize("slab_batching", [False, True], ids=["slabs_off", "slabs_on"])
def test_take_with_micro_batching_byte_identical(tmp_path, monkeypatch, slab_batching):
    """A take whose small payloads flow through the fs micro-batcher writes
    the same bytes as one with micro-batching off, and as the JAX package's
    take of the same state."""
    monkeypatch.setenv("TPUSNAP_SIDECAR", "0")
    monkeypatch.setenv("TPUSNAP_DISABLE_BATCHER", "0" if slab_batching else "1")
    state = _leaf_state()
    monkeypatch.setenv("TPUSNAP_NATIVE_BATCH", "8")
    phase_stats.reset()
    _take(tmp_path / "batched", state)
    members = phase_stats.snapshot().get("native_write_batched", {}).get("n", 0)
    monkeypatch.setenv("TPUSNAP_NATIVE_BATCH", "0")
    phase_stats.reset()
    snap_single = _take(tmp_path / "single", state)
    assert "native_write_batched" not in phase_stats.snapshot()
    JaxSnapshot.take(str(tmp_path / "jax"), {"m": JaxStateDict(state)})
    da, db, dj = (_dir_digest(str(tmp_path / d)) for d in ("batched", "single", "jax"))
    assert da == db and da
    assert {k: v for k, v in da.items() if not k.startswith(".")} == {k: v for k, v in dj.items() if not k.startswith(".")}
    # One slab holds every leaf when slabs are on, so no member is small
    # and alone; with slabs off each of the 64 leaves is its own payload.
    assert (members == 0) if slab_batching else (0 < members <= len(state))
    _restore_and_check(snap_single, state)


# ------------------------------------------------------------ direct I/O


def test_direct_io_take_parity(tmp_path, monkeypatch):
    """TPUSNAP_DIRECT_IO=1 writes byte-identical snapshots through whatever
    rung of the ladder this host resolves (io_uring, O_DIRECT pwrite or the
    buffered fallback)."""
    monkeypatch.setenv("TPUSNAP_SIDECAR", "0")
    state = _state()
    snap_buffered = _take(tmp_path / "buffered", state)
    monkeypatch.setenv("TPUSNAP_DIRECT_IO", "1")
    direct = _take(tmp_path / "direct", state)
    mode = _native().direct_io_mode()
    assert mode in (1, 2, 3), mode
    da = _dir_digest(str(tmp_path / "buffered"))
    assert da == _dir_digest(str(tmp_path / "direct")) and da
    _restore_and_check(snap_buffered, state)
    _restore_and_check(direct, state)


def test_direct_io_degrade_emits_event_once(tmp_path, monkeypatch, caplog):
    """A filesystem that rejects O_DIRECT moves the writes to buffered I/O
    with ONE native.degraded event and one warning, not one per write, and
    never a failed take.  Mode 3 is simulated (this host's filesystems
    accept O_DIRECT); the writes run with the knob on, so the check after
    each write is the production one."""
    monkeypatch.setattr(NativeFileIO, "_direct_io_reported", False)
    monkeypatch.setattr(NativeFileIO, "direct_io_mode", lambda self: 3)
    events = []
    event_handlers.register_event_handler(events.append)
    monkeypatch.setenv("TPUSNAP_SIDECAR", "0")
    monkeypatch.setenv("TPUSNAP_DIRECT_IO", "1")
    try:
        with caplog.at_level(logging.WARNING, logger="torchsnapshot_tpu_torch.native_io"):
            snapshot = _take(tmp_path / "snap", _state())
    finally:
        event_handlers.unregister_event_handler(events.append)
    degraded = [e for e in events if e.name == "native.degraded" and "direct_io" in e.metadata.get("missing", [])]
    assert len(degraded) == 1, [e.name for e in events]
    assert sum("rejected O_DIRECT" in r.getMessage() for r in caplog.records) == 1
    _restore_and_check(snapshot, _state())


def test_direct_io_mode_follows_the_knob_only_when_they_disagree(tmp_path, monkeypatch):
    """The mode is process-global: a plugin sets it only when the knob
    disagrees with it, so a sibling plugin with the knob on keeps the mode
    (and a buffered fallback) it found, and the knob off turns it off."""
    native = _native()
    calls = []
    configure = native.configure_direct_io
    monkeypatch.setattr(native, "configure_direct_io", lambda enabled: calls.append(enabled) or configure(enabled))
    with knobs.override_direct_io(True):
        first = FSStoragePlugin(str(tmp_path))
        mode = native.direct_io_mode()
        assert calls == [True] and mode in (1, 2)
        second = FSStoragePlugin(str(tmp_path))
        assert calls == [True] and native.direct_io_mode() == mode
    third = FSStoragePlugin(str(tmp_path))
    assert calls == [True, False] and native.direct_io_mode() == 0
    for plugin in (first, second, third):
        plugin.sync_close()


# ----------------------------------------------------------------- knobs

KNOB_CASES = [
    ("TPUSNAP_NATIVE_BATCH", None, "get_native_batch"),
    ("TPUSNAP_NATIVE_BATCH", "0", "get_native_batch"),
    ("TPUSNAP_NATIVE_BATCH", "3", "get_native_batch"),
    ("TPUSNAP_NATIVE_BATCH", "-2", "get_native_batch"),
    ("TPUSNAP_DIRECT_IO", None, "direct_io_enabled"),
    ("TPUSNAP_DIRECT_IO", "1", "direct_io_enabled"),
    ("TPUSNAP_DIRECT_IO", "false", "direct_io_enabled"),
    ("TPUSNAP_PARALLEL_READ_WAYS", None, "get_parallel_read_ways"),
    ("TPUSNAP_PARALLEL_READ_WAYS", "auto", "get_parallel_read_ways"),
    ("TPUSNAP_PARALLEL_READ_WAYS", "4", "get_parallel_read_ways"),
    ("TPUSNAP_NATIVE_SANITIZE", None, "get_native_sanitize"),
    ("TPUSNAP_NATIVE_SANITIZE", "off", "get_native_sanitize"),
    ("TPUSNAP_NATIVE_SANITIZE", " TSan ", "get_native_sanitize"),
    ("TPUSNAP_NATIVE_SANITIZE", "ubsan", "get_native_sanitize"),
]


@pytest.mark.parametrize("name, value, getter", KNOB_CASES)
def test_data_plane_knobs_parse_as_the_jax_package(monkeypatch, name, value, getter):
    if value is not None:
        monkeypatch.setenv(name, value)
    assert getattr(knobs, getter)() == getattr(jax_knobs, getter)()


def test_data_plane_knob_overrides_match_the_jax_package():
    for port_cm, jax_cm, getter in (
        (knobs.override_native_batch(5), jax_knobs.override_native_batch(5), "get_native_batch"),
        (knobs.override_direct_io(True), jax_knobs.override_direct_io(True), "direct_io_enabled"),
        (knobs.override_parallel_read_ways(3), jax_knobs.override_parallel_read_ways(3), "get_parallel_read_ways"),
        (knobs.override_native_sanitize("asan"), jax_knobs.override_native_sanitize("asan"), "get_native_sanitize"),
    ):
        with port_cm:
            port_value = getattr(knobs, getter)()
        with jax_cm:
            assert getattr(knobs, getter)() == port_value == getattr(jax_knobs, getter)()
        assert getattr(knobs, getter)() == getattr(jax_knobs, getter)()


def test_native_sanitize_typo_raises_loudly(tmp_path, monkeypatch):
    """An unknown sanitizer raises in both packages, also once the port's
    library is loaded: an uninstrumented race run would report "clean"."""
    _native()
    monkeypatch.setenv("TPUSNAP_NATIVE_SANITIZE", "tsna")
    for getter in (knobs.get_native_sanitize, jax_knobs.get_native_sanitize, native_build.get_native_lib_path):
        with pytest.raises(ValueError, match="unsupported sanitizer"):
            getter()
    with pytest.raises(ValueError, match="unsupported sanitizer"):
        FSStoragePlugin(str(tmp_path))


@pytest.fixture
def fake_build(tmp_path, monkeypatch):
    """Builds into ``tmp_path`` record their output and flags instead of
    compiling: no test compiles into the shared ``_native/_build/``."""
    builds = []

    def _build(out=native_build._LIB, extra_flags=()):
        builds.append((out, list(extra_flags)))
        with open(out, "wb"):
            pass

    monkeypatch.setattr(native_build, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native_build, "_LIB", str(tmp_path / "libtpusnap_torch.so"))
    monkeypatch.setattr(native_build, "_build", _build)
    return builds


@pytest.mark.parametrize("mode, flag", [("tsan", "-fsanitize=thread"), ("asan", "-fsanitize=address"), ("ubsan", "-fsanitize=undefined")])
def test_sanitized_library_is_built_under_its_own_name(tmp_path, monkeypatch, fake_build, mode, flag):
    monkeypatch.setattr(native_build, "_runtime_is_mapped", lambda m: True)
    monkeypatch.setenv("TPUSNAP_NATIVE_SANITIZE", mode)
    path = native_build.get_native_lib_path()
    assert path == str(tmp_path / f"libtpusnap_torch-{mode}.so")
    assert fake_build == [(path, native_build._SANITIZE_FLAGS[mode])] and flag in fake_build[0][1]
    assert native_build.get_native_lib_path() == path and len(fake_build) == 1  # fresh: no rebuild
    assert not os.path.exists(native_build._LIB)  # the production library untouched


def test_sanitized_library_without_its_runtime_raises(tmp_path, monkeypatch, fake_build):
    """Loading an instrumented library into a process without its runtime
    mapped first raises, naming the preload; nothing falls back to the
    uninstrumented library."""
    monkeypatch.setattr(native_build, "sanitizer_runtime", lambda m: "/usr/lib/libtsan.so.2")
    monkeypatch.setenv("TPUSNAP_NATIVE_SANITIZE", "tsan")
    with pytest.raises(native_build.NativeBuildError, match="LD_PRELOAD=/usr/lib/libtsan.so.2"):
        native_build.get_native_lib_path()
    assert [out for out, _ in fake_build] == [str(tmp_path / "libtpusnap_torch-tsan.so")]
    monkeypatch.delenv("TPUSNAP_NATIVE_SANITIZE")
    assert native_build.get_native_lib_path() == native_build._LIB


def test_native_knob_still_warns_once(tmp_path, monkeypatch, recwarn):
    """``TPUSNAP_NATIVE`` selects the JAX package's pure-Python data plane,
    which the port does not have: a take warns once and still writes
    through the native library, byte-identical to a take without it."""
    monkeypatch.setattr(knobs, "_warned_knobs", set())
    monkeypatch.setenv("TPUSNAP_SIDECAR", "0")
    state = {"w": np.arange(1000, dtype=np.float32)}
    monkeypatch.setenv("TPUSNAP_NATIVE", "0")
    _take(tmp_path / "a", state)
    _take(tmp_path / "b", state)
    warned = [w for w in recwarn if "TPUSNAP_NATIVE is set" in str(w.message)]
    assert len(warned) == 1
    monkeypatch.delenv("TPUSNAP_NATIVE")
    _take(tmp_path / "c", state)
    assert _dir_digest(str(tmp_path / "a")) == _dir_digest(str(tmp_path / "c"))
    assert torch.equal(ts.Snapshot(str(tmp_path / "a")).read_object("0/m/w", device="cpu"), torch.arange(1000, dtype=torch.float32))
