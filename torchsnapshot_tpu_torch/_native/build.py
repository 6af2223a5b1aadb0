"""Lazy build of the native library (g++ → ``_build/libtpusnap_torch.so``).

Counterpart of ``torchsnapshot_tpu/_native/build.py``.  The library is
compiled from ``tpustore.cc`` on first use into ``_build/`` next to the
source (listed in ``.gitignore``) and rebuilt whenever the source is newer
than the library.  Unlike the JAX package there is no degraded mode: no
stale library is served and nothing falls back to pure Python — a build
failure raises, naming the compiler's error.

zstd, as in the JAX build: the first attempt compiles against ``zstd.h``
and links ``-lzstd`` (``-DTPUSNAP_WITH_ZSTD``); where the headers are
missing the second attempt builds the dlopen shim over the runtime
``libzstd.so.1``, and ``tpusnap_has_zstd()`` reports what the running
process found.

Sanitizer builds (``TPUSNAP_NATIVE_SANITIZE={tsan,asan,ubsan}``): the same
source compiles with ``-fsanitize=...`` into its own
``_build/libtpusnap_torch-<mode>.so``, so the production library is never
replaced by an instrumented one.  An instrumented library can only be
loaded into a process that has its runtime mapped first (``LD_PRELOAD`` of
:func:`sanitizer_runtime`): :func:`get_native_lib_path` raises otherwise,
and a sanitizer build that fails raises too.  Nothing falls back to the
uninstrumented library.
"""

from __future__ import annotations

import os
import subprocess
import threading
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "tpustore.cc")
_BUILD_DIR = os.path.join(_HERE, "_build")
_LIB = os.path.join(_BUILD_DIR, "libtpusnap_torch.so")
_LOCK = threading.Lock()

_CMD = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread"]
# Extra flags per attempt, in order: linked zstd, then the dlopen shim.
_ATTEMPTS = (["-DTPUSNAP_WITH_ZSTD", "-lzstd", "-ldl"], ["-ldl"])

# Per-sanitizer compile flags, the JAX build's: -O1 with frame pointers
# keeps usable stacks while the instrumented code stays fast enough.
_SANITIZE_FLAGS = {
    "tsan": ["-fsanitize=thread", "-O1", "-g", "-fno-omit-frame-pointer"],
    "asan": ["-fsanitize=address", "-O1", "-g", "-fno-omit-frame-pointer"],
    "ubsan": ["-fsanitize=undefined", "-O1", "-g", "-fno-omit-frame-pointer"],
}
_SANITIZER_RUNTIMES = {"tsan": "libtsan.so", "asan": "libasan.so", "ubsan": "libubsan.so"}


class NativeBuildError(RuntimeError):
    """The native library could not be compiled or loaded."""


def sanitized_lib_path(mode: str) -> str:
    """Where the ``mode``-instrumented library lives (never the normal one)."""
    return os.path.join(_BUILD_DIR, f"libtpusnap_torch-{mode}.so")


def _is_stale(lib: str) -> bool:
    try:
        return os.path.getmtime(lib) < os.path.getmtime(_SRC)
    except OSError:
        return True


def lib_is_stale() -> bool:
    """Whether ``tpustore.cc`` is newer than the built library (or the
    library is missing)."""
    return _is_stale(_LIB)


def _build(out: str = _LIB, extra_flags=()) -> None:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    # Unique temp name per process, then an atomic rename: concurrent
    # first users (test workers) never load a half-written library.
    tmp = f"{out}.tmp.{os.getpid()}"
    proc = None
    for extra in _ATTEMPTS:
        try:
            proc = subprocess.run(
                _CMD + list(extra_flags) + [_SRC, "-o", tmp] + extra,
                capture_output=True,
                text=True,
                timeout=300,
            )
        except (OSError, subprocess.TimeoutExpired) as e:
            raise NativeBuildError(f"g++ could not run: {e}") from e
        if proc.returncode == 0:
            break
    assert proc is not None
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise NativeBuildError(
            f"g++ failed (rc {proc.returncode}): {proc.stderr.strip()[-2000:]}"
        )
    os.replace(tmp, out)


def _runtime_is_mapped(mode: str) -> bool:
    """Whether this process has the ``mode`` sanitizer runtime mapped (it
    was preloaded, or the interpreter links it)."""
    stem = _SANITIZER_RUNTIMES[mode].rsplit(".so", 1)[0]
    try:
        with open("/proc/self/maps") as f:
            return any(
                os.path.basename(line.split()[-1]).startswith(stem + ".so")
                for line in f
                if "/" in line
            )
    except OSError:
        return False


def get_native_lib_path() -> str:
    """Path to an up-to-date library, building it when needed.  With
    ``TPUSNAP_NATIVE_SANITIZE`` set, the instrumented variant instead,
    which raises :class:`NativeBuildError` unless its runtime is already
    mapped into this process."""
    from .. import knobs

    mode = knobs.get_native_sanitize()
    lib = sanitized_lib_path(mode) if mode else _LIB
    with _LOCK:
        if _is_stale(lib):
            _build(lib, _SANITIZE_FLAGS[mode] if mode else ())
    if mode and not _runtime_is_mapped(mode):
        runtime = sanitizer_runtime(mode)
        raise NativeBuildError(
            f"TPUSNAP_NATIVE_SANITIZE={mode}: {os.path.basename(lib)} needs its "
            f"runtime loaded first; run with LD_PRELOAD={runtime or _SANITIZER_RUNTIMES[mode]}"
        )
    return lib


def sanitizer_runtime(mode: str) -> Optional[str]:
    """Path of the ``mode`` sanitizer runtime (``libtsan.so``, ...) for
    ``LD_PRELOAD``, or None when no compiler on this host ships it."""
    runtime = _SANITIZER_RUNTIMES[mode]
    for compiler in ("g++", "gcc", "clang"):
        try:
            out = subprocess.run(
                [compiler, f"-print-file-name={runtime}"],
                check=True,
                capture_output=True,
                timeout=30,
                text=True,
            ).stdout.strip()
        except (OSError, subprocess.SubprocessError):
            continue
        # An unknown runtime echoes the bare name back; a real one is a path.
        if out and os.path.sep in out and os.path.exists(out):
            return os.path.realpath(out)
    return None
