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
"""

from __future__ import annotations

import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "tpustore.cc")
_BUILD_DIR = os.path.join(_HERE, "_build")
_LIB = os.path.join(_BUILD_DIR, "libtpusnap_torch.so")
_LOCK = threading.Lock()

_CMD = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread"]
# Extra flags per attempt, in order: linked zstd, then the dlopen shim.
_ATTEMPTS = (["-DTPUSNAP_WITH_ZSTD", "-lzstd", "-ldl"], ["-ldl"])


class NativeBuildError(RuntimeError):
    """The native library could not be compiled."""


def lib_is_stale() -> bool:
    """Whether ``tpustore.cc`` is newer than the built library (or the
    library is missing)."""
    try:
        return os.path.getmtime(_LIB) < os.path.getmtime(_SRC)
    except OSError:
        return True


def _build() -> None:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    # Unique temp name per process, then an atomic rename: concurrent
    # first users (test workers) never load a half-written library.
    tmp = f"{_LIB}.tmp.{os.getpid()}"
    proc = None
    for extra in _ATTEMPTS:
        try:
            proc = subprocess.run(
                _CMD + [_SRC, "-o", tmp] + extra,
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
    os.replace(tmp, _LIB)


def get_native_lib_path() -> str:
    """Path to an up-to-date library, building it when needed."""
    with _LOCK:
        if lib_is_stale():
            _build()
        return _LIB
