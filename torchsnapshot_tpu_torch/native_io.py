"""Native file I/O data plane (ctypes over ``libtpusnap_torch``).

Counterpart of ``torchsnapshot_tpu/native_io.py``, cut to the entry points
the synchronous take/restore path calls:

- ``write_parts_hash`` — ONE call per payload or slab that writes every
  part and returns each part's digest, hash and write fused over the same
  bytes (the pool hashes while the calling thread writes);
- ``write_file_parts`` — the same write without digests (checksums off);
- ``xxhash64`` / ``xxhash64_striped`` — the "xxh64" and "xxh64s" digests;
- ``read_ranges_into`` — parallel pread into caller-owned buffers, with
  optional fused per-range digests.

The library is required: :meth:`NativeFileIO.get` builds and loads it, and
raises if it cannot.  The GIL is released for every call (ctypes).
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

# Digest striping policy — these constants DEFINE the "xxh64s" digest value
# recorded in manifests; they match torchsnapshot_tpu's so the two packages'
# digests agree.  Never change them without a new algo tag.
STRIPE_BYTES = 8 << 20
STRIPED_MIN_BYTES = 32 << 20

# ABI generation of the library; a mismatch (a library built from another
# source) is refused at load.
NATIVE_ABI_VERSION = 2

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_U64 = ctypes.c_uint64


def _u8(buf: Any) -> np.ndarray:
    """A C-contiguous uint8 numpy view of ``buf`` (copied once when the
    buffer is not contiguous).  ``np.frombuffer`` aliases read-only buffers
    too, and exposes the address the native call needs."""
    view = memoryview(buf)
    if not view.c_contiguous:
        view = memoryview(bytes(view))
    return np.frombuffer(view.cast("B"), np.uint8)


def _ptrs(arrs: Sequence[np.ndarray]):
    """(pointer array, size array) for the native calls; empty buffers
    marshal as NULL/0.  The caller keeps ``arrs`` alive for the call."""
    n = max(len(arrs), 1)
    bufs = (_P * n)(*(a.ctypes.data if a.nbytes else None for a in arrs))
    sizes = (_I64 * n)(*(a.nbytes for a in arrs))
    return bufs, sizes


def _check(rc: int, path: str) -> None:
    if rc != 0:
        raise OSError(-rc, os.strerror(-rc), path)


class NativeFileIO:
    _instance: Optional["NativeFileIO"] = None
    _lock = threading.Lock()

    def __init__(self, path: str) -> None:
        from . import knobs

        lib = ctypes.CDLL(path)
        lib.tpusnap_abi_version.restype = ctypes.c_int
        lib.tpusnap_abi_version.argtypes = []
        abi = int(lib.tpusnap_abi_version())
        if abi != NATIVE_ABI_VERSION:
            raise RuntimeError(
                f"{path} has native ABI {abi}, expected {NATIVE_ABI_VERSION}"
            )
        sigs = {
            "tpusnap_pool_configure": (None, [ctypes.c_int]),
            "tpusnap_pool_size": (ctypes.c_int, []),
            "tpusnap_xxhash64": (_U64, [_P, _I64, _U64]),
            "tpusnap_xxhash64_striped": (_U64, [_P, _I64, _U64, _I64]),
            "tpusnap_write_file_parts": (
                ctypes.c_int,
                [ctypes.c_char_p, ctypes.POINTER(_P), ctypes.POINTER(_I64), ctypes.c_int],
            ),
            "tpusnap_write_parts_hash": (
                ctypes.c_int,
                [
                    ctypes.c_char_p,
                    ctypes.POINTER(_P),
                    ctypes.POINTER(_I64),
                    ctypes.c_int,
                    _U64,
                    _I64,
                    _I64,
                    ctypes.POINTER(_U64),
                ],
            ),
            "tpusnap_read_ranges_hash": (
                ctypes.c_int,
                [
                    ctypes.c_char_p,
                    ctypes.c_int,
                    ctypes.POINTER(_I64),
                    ctypes.POINTER(_I64),
                    ctypes.POINTER(_P),
                    ctypes.c_int,
                    _U64,
                    _I64,
                    _I64,
                    ctypes.POINTER(_U64),
                ],
            ),
            "tpusnap_file_size": (_I64, [ctypes.c_char_p]),
        }
        for name, (restype, argtypes) in sigs.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        lib.tpusnap_pool_configure(knobs.get_native_threads())
        self._lib = lib
        self.path = path

    @classmethod
    def get(cls) -> "NativeFileIO":
        """The process's loaded library, built on first use."""
        if cls._instance is None:
            with cls._lock:
                if cls._instance is None:
                    from ._native.build import get_native_lib_path

                    cls._instance = cls(get_native_lib_path())
        return cls._instance

    def pool_size(self) -> int:
        return int(self._lib.tpusnap_pool_size())

    def xxhash64(self, buf: Any) -> int:
        arr = _u8(buf)
        return int(self._lib.tpusnap_xxhash64(arr.ctypes.data, arr.nbytes, 0))

    def xxhash64_striped(self, buf: Any) -> int:
        """The striped ("xxh64s") digest: per-STRIPE_BYTES xxh64 digests,
        computed in parallel on the native pool and combined via xxh64 over
        their little-endian stream."""
        arr = _u8(buf)
        return int(
            self._lib.tpusnap_xxhash64_striped(
                arr.ctypes.data, arr.nbytes, 0, STRIPE_BYTES
            )
        )

    def write_parts_hash(self, path: str, parts: Sequence[Any]) -> List[int]:
        """Fused write+hash: ``parts`` land sequentially in one file while
        each part's digest is computed on the native pool.  Returns one
        64-bit digest per part, in order (parts of >= STRIPED_MIN_BYTES are
        "xxh64s" digests, smaller ones "xxh64")."""
        arrs = [_u8(p) for p in parts]
        bufs, sizes = _ptrs(arrs)
        out = (_U64 * max(len(arrs), 1))()
        rc = self._lib.tpusnap_write_parts_hash(
            path.encode(),
            bufs,
            sizes,
            len(arrs),
            0,
            STRIPE_BYTES,
            STRIPED_MIN_BYTES,
            out,
        )
        _check(rc, path)
        return [int(out[i]) for i in range(len(arrs))]

    def write_file_parts(self, path: str, parts: Sequence[Any]) -> None:
        """Scatter-gather write with no digests."""
        arrs = [_u8(p) for p in parts]
        bufs, sizes = _ptrs(arrs)
        _check(
            self._lib.tpusnap_write_file_parts(path.encode(), bufs, sizes, len(arrs)),
            path,
        )

    def file_size(self, path: str) -> int:
        size = int(self._lib.tpusnap_file_size(path.encode()))
        if size < 0:
            raise OSError(-size, os.strerror(-size), path)
        return size

    def read_ranges_into(
        self,
        path: str,
        ranges: Sequence[Tuple[int, int]],
        views: Sequence[Any],
        want_hash: bool = False,
    ) -> Optional[List[int]]:
        """Parallel multi-range pread into caller-owned writable buffers,
        optionally fused with per-range digests (striped for ranges >=
        STRIPED_MIN_BYTES, plain below).  ``ranges`` are absolute
        ``(offset, end)`` extents; ``views[i]`` must hold exactly
        ``end - offset`` bytes.  Returns per-range digests when
        ``want_hash``, else None.  A short file raises ``OSError(EIO)``."""
        n = len(ranges)
        arrs = []
        for (off, end), view in zip(ranges, views):
            arr = np.frombuffer(memoryview(view).cast("B"), np.uint8)
            if arr.nbytes != end - off:
                raise ValueError(
                    f"range [{off}, {end}) needs {end - off} bytes, "
                    f"destination has {arr.nbytes}"
                )
            arrs.append(arr)
        bufs, _ = _ptrs(arrs)
        offs = (_I64 * max(n, 1))(*(off for off, _ in ranges))
        lens = (_I64 * max(n, 1))(*(end - off for off, end in ranges))
        out = (_U64 * max(n, 1))()
        rc = self._lib.tpusnap_read_ranges_hash(
            path.encode(),
            n,
            offs,
            lens,
            bufs,
            1 if want_hash else 0,
            0,
            STRIPE_BYTES,
            STRIPED_MIN_BYTES,
            out,
        )
        _check(rc, path)
        return [int(out[i]) for i in range(n)] if want_hash else None
