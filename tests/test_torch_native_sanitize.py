"""Race and memory checks of the port's native worker pool under sanitizer
builds (mirrors tests/test_native_sanitize.py).

``TPUSNAP_NATIVE_SANITIZE={tsan,asan,ubsan}`` compiles ``tpustore.cc`` into
its own instrumented ``libtpusnap_torch-<mode>.so`` (``_native/build.py``).
Each test loads it in a SUBPROCESS with the sanitizer runtime preloaded (an
instrumented library needs its runtime mapped first; the port refuses to
load it otherwise) and drives the pool with the access patterns that race
in thread pools: concurrent fused write+hash, striped hashing over one
shared buffer, content-defined chunking, ranged reads with verify, batched
dispatch, direct-I/O writes, and a fork while the pool is hot.  The
subprocess imports only the data plane modules of the port (a stub package
object stands in for ``torchsnapshot_tpu_torch/__init__.py``), so torch
never runs under the sanitizer.

A sanitizer report makes the subprocess exit non-zero (``exitcode=66``)
and print a ``WARNING: <X>Sanitizer`` banner; either fails the test.  A
host whose toolchain cannot build or host the instrumented library skips.
Marked ``slow``: instrumented builds and runs are too heavy for tier-1."""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap

import pytest

from torchsnapshot_tpu_torch import knobs
from torchsnapshot_tpu_torch._native import build as native_build

from torch_env import default_knob_env  # noqa: F401  autouse fixture

pytestmark = pytest.mark.slow

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SANITIZER_ENV = {
    "tsan": {"TSAN_OPTIONS": "exitcode=66 halt_on_error=0"},
    # The interpreter is uninstrumented: leak reports would be its noise,
    # and the link-order check rejects the deliberate preload.
    "asan": {"ASAN_OPTIONS": "exitcode=66 detect_leaks=0 verify_asan_link_order=0"},
    "ubsan": {"UBSAN_OPTIONS": "print_stacktrace=1 halt_on_error=1"},
}

_BANNERS = ("WARNING: ThreadSanitizer", "ERROR: AddressSanitizer", "runtime error:")


def _sanitized_setup(mode: str):
    """(lib_path, runtime_path), or a skip when the toolchain cannot."""
    with knobs.override_native_sanitize(mode):
        try:
            native_build.get_native_lib_path()
        except native_build.NativeBuildError as e:
            # Built, but this (uninstrumented) process cannot load it.
            if "needs its runtime" not in str(e):
                pytest.skip(f"toolchain cannot build the {mode}-instrumented library: {e}")
    runtime = native_build.sanitizer_runtime(mode)
    if runtime is None:
        pytest.skip(f"no {mode} runtime library to preload on this host")
    return native_build.sanitized_lib_path(mode), runtime


def _run_body(mode: str, body: str, timeout_s: float = 300.0):
    """Run ``body`` in a subprocess with the instrumented library loaded."""
    _, runtime = _sanitized_setup(mode)
    env = dict(os.environ)
    env.update(_SANITIZER_ENV[mode])
    env["TPUSNAP_NATIVE_SANITIZE"] = mode
    env["LD_PRELOAD"] = runtime
    prologue = textwrap.dedent(
        f"""
        import os, sys, tempfile, threading, types
        pkg = types.ModuleType("torchsnapshot_tpu_torch")
        pkg.__path__ = [os.path.join({REPO_ROOT!r}, "torchsnapshot_tpu_torch")]
        sys.modules["torchsnapshot_tpu_torch"] = pkg
        from torchsnapshot_tpu_torch.native_io import NativeFileIO
        io = NativeFileIO.get()
        assert io.path.endswith("libtpusnap_torch-{mode}.so"), io.path
        assert "torch" not in sys.modules
        """
    )
    return subprocess.run(
        [sys.executable, "-c", prologue + textwrap.dedent(body)],
        capture_output=True,
        text=True,
        timeout=timeout_s,
        env=env,
        cwd=REPO_ROOT,
    )


def _assert_clean(proc) -> None:
    output = proc.stdout + proc.stderr
    banner = next((b for b in _BANNERS if b in output), None)
    assert proc.returncode == 0 and banner is None, (
        f"sanitizer run failed (rc={proc.returncode}, banner={banner!r}):\n" + output[-4000:]
    )
    assert "BODY_OK" in output, f"body did not complete:\n{output[-4000:]}"


def _preflight(mode: str) -> None:
    """One trivial instrumented call; an environment where even this fails
    (kernel against tsan mappings, container ASLR) skips the suite rather
    than reporting phantom races."""
    proc = _run_body(mode, "io.xxhash64(b'x'); print('BODY_OK')", 120.0)
    output = proc.stdout + proc.stderr
    if proc.returncode != 0 and not any(b in output for b in _BANNERS):
        pytest.skip(f"{mode} runtime cannot host the library here: {output[-300:]}")
    _assert_clean(proc)


def test_tsan_build_separate_lib():
    """The instrumented library never replaces the production one."""
    lib, _ = _sanitized_setup("tsan")
    assert os.path.basename(lib) == "libtpusnap_torch-tsan.so"
    assert os.path.abspath(lib) != os.path.abspath(native_build._LIB)


def test_tsan_concurrent_fused_write_hash():
    """Many threads × fused write+hash: pool hashing concurrent with the
    sequential writer, all workers sharing the task queue."""
    _preflight("tsan")
    proc = _run_body(
        "tsan",
        """
        def leg(tid, tmp):
            parts = [bytes([tid + i & 0xFF]) * (64 << 10) for i in range(16)]
            for round in range(4):
                hashes = io.write_parts_hash(os.path.join(tmp, f"f{tid}_{round}"), parts)
                assert len(hashes) == len(parts)
        with tempfile.TemporaryDirectory() as tmp:
            threads = [threading.Thread(target=leg, args=(t, tmp)) for t in range(8)]
            [t.start() for t in threads]
            [t.join() for t in threads]
        print('BODY_OK')
        """,
    )
    _assert_clean(proc)


def test_tsan_concurrent_striped_hash_shared_buffer():
    """Several threads striping ONE shared 40 MiB buffer."""
    _preflight("tsan")
    proc = _run_body(
        "tsan",
        """
        buf = (b'\\x5a' * (40 << 20))
        results = []
        def leg():
            results.append(io.xxhash64_striped(buf))
        threads = [threading.Thread(target=leg) for _ in range(6)]
        [t.start() for t in threads]
        [t.join() for t in threads]
        assert len(set(results)) == 1, results
        print('BODY_OK')
        """,
    )
    _assert_clean(proc)


def test_tsan_concurrent_cdc_over_shared_staged_buffer():
    """Several threads scanning content-defined boundaries of ONE shared
    buffer: per-stripe candidate vectors and task bookkeeping interleave
    across calls, and the cuts must agree."""
    _preflight("tsan")
    proc = _run_body(
        "tsan",
        """
        buf = os.urandom(24 << 20)
        results = []
        lock = threading.Lock()
        def leg():
            ends = io.cdc_boundaries(buf, 65536, 262144, 1 << 20)
            with lock:
                results.append(tuple(ends))
        threads = [threading.Thread(target=leg) for _ in range(6)]
        [t.start() for t in threads]
        [t.join() for t in threads]
        assert len(set(results)) == 1, [len(r) for r in results]
        assert results[0][-1] == len(buf)
        print('BODY_OK')
        """,
    )
    _assert_clean(proc)


def test_tsan_concurrent_ranged_reads_with_verify():
    """Parallel multi-range reads with fused per-range hashing, and the
    sequential one-stream read, from several threads against one file."""
    _preflight("tsan")
    proc = _run_body(
        "tsan",
        """
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, 'blob')
            payload = bytes(range(256)) * (32 << 10)  # 8 MiB
            io.write_file_parts(path, [payload])
            n = len(payload)
            ranges = [(i * n // 8, (i + 1) * n // 8) for i in range(8)]
            def leg():
                views = [bytearray(end - off) for off, end in ranges]
                hashes = io.read_ranges_into(path, ranges, views, want_hash=True)
                assert hashes is not None and len(hashes) == 8
                assert b''.join(bytes(v) for v in views) == payload
                whole = bytearray(n)
                io.read_file_into(path, 0, whole)
                assert bytes(whole) == payload
            threads = [threading.Thread(target=leg) for _ in range(6)]
            [t.start() for t in threads]
            [t.join() for t in threads]
        print('BODY_OK')
        """,
    )
    _assert_clean(proc)


def test_tsan_concurrent_batched_dispatch():
    """Many threads × batched write+hash: per-file write tasks and per-part
    hash tasks of several batches interleave on one shared pool."""
    _preflight("tsan")
    proc = _run_body(
        "tsan",
        """
        def leg(tid, tmp):
            for round in range(3):
                jobs = [
                    (os.path.join(tmp, f"b{tid}_{round}_{j}"),
                     [bytes([tid + j + i & 0xFF]) * (32 << 10) for i in range(4)])
                    for j in range(6)
                ]
                results = io.write_parts_hash_batch(jobs)
                assert all(not isinstance(r, OSError) for r in results)
                assert all(len(r) == 4 for r in results)
        with tempfile.TemporaryDirectory() as tmp:
            threads = [threading.Thread(target=leg, args=(t, tmp)) for t in range(6)]
            [t.start() for t in threads]
            [t.join() for t in threads]
        print('BODY_OK')
        """,
    )
    _assert_clean(proc)


def test_tsan_direct_io_write_path():
    """Concurrent fused writes with direct I/O on: whatever rung the host
    resolves, the bounce buffers and the per-file degrade bookkeeping race
    against pool hashing and sibling writers; the bytes must be exact."""
    _preflight("tsan")
    proc = _run_body(
        "tsan",
        """
        mode = io.configure_direct_io(True)
        assert mode in (1, 2, 3), mode
        payload = bytes(range(256)) * (64 << 4)  # 256 KiB
        big = bytes(range(251)) * ((9 << 20) // 251)  # several bounce chunks
        def leg(tid, tmp):
            for round in range(4):
                path = os.path.join(tmp, f"d{tid}_{round}")
                parts = [payload, payload[: 4096 * 3 + 17], big if round == 0 else b'']
                hashes = io.write_parts_hash(path, parts)
                assert len(hashes) == 3
                with open(path, 'rb') as f:
                    assert f.read() == b''.join(parts)
        try:
            with tempfile.TemporaryDirectory() as tmp:
                threads = [threading.Thread(target=leg, args=(t, tmp)) for t in range(6)]
                [t.start() for t in threads]
                [t.join() for t in threads]
        finally:
            io.configure_direct_io(False)
        print('BODY_OK')
        """,
    )
    _assert_clean(proc)


def test_asan_fork_resets_pool():
    """Fork while the pool is hot, then drive the pool in BOTH processes:
    the child builds a fresh pool (no inherited dead threads) and the
    parent's workers stay intact, with no heap corruption on either side.
    Under ASAN, not TSAN: TSAN's fork interceptor deadlocks against live
    instrumented threads."""
    _preflight("asan")
    proc = _run_body(
        "asan",
        """
        buf = b'\\xa5' * (34 << 20)
        io.xxhash64_striped(buf)
        assert io.pool_size() > 0
        pid = os.fork()
        if pid == 0:
            ok = io.xxhash64_striped(buf) != 0 and io.pool_size() > 0
            os._exit(0 if ok else 1)
        _, status = os.waitpid(pid, 0)
        assert os.waitstatus_to_exitcode(status) == 0
        io.xxhash64_striped(buf)
        print('BODY_OK')
        """,
        timeout_s=180.0,
    )
    _assert_clean(proc)


@pytest.mark.parametrize("mode", ["asan", "ubsan"])
def test_memory_sanitizers_smoke(mode):
    """ASAN/UBSAN over one mixed round of the fused, batched, direct-I/O,
    striped, read and zstd paths."""
    _preflight(mode)
    proc = _run_body(
        mode,
        """
        with tempfile.TemporaryDirectory() as tmp:
            parts = [bytes([i]) * (128 << 10) for i in range(8)]
            path = os.path.join(tmp, 'f')
            assert len(io.write_parts_hash(path, parts)) == 8
            io.write_parts_hash_batch([(path + str(i), parts[:i + 1]) for i in range(4)])
            io.configure_direct_io(True)
            io.write_parts_hash(path + 'd', [parts[0][:5000], parts[1]])
            io.configure_direct_io(False)
            io.xxhash64_striped(b'\\x11' * (33 << 20))
            size = os.path.getsize(path)
            io.read_ranges_into(path, [(0, size)], [bytearray(size)], want_hash=True)
            io.read_file_into(path, 0, bytearray(size))
            if io.has_zstd:
                src = bytes(range(256)) * 4096
                dst = bytearray(len(src) + 1024)
                n = io.zstd_encode_into(src, dst, 3)
                out = bytearray(len(src))
                assert io.zstd_decode_into(memoryview(dst)[:n], out) == len(src) and out == src
        print('BODY_OK')
        """,
    )
    _assert_clean(proc)
