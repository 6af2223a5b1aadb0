"""Native file I/O data plane (ctypes over ``libtpusnap_torch``).

Counterpart of ``torchsnapshot_tpu/native_io.py``, cut to the entry points
the synchronous take/restore path calls:

- ``write_parts_hash`` — ONE call per payload or slab that writes every
  part and returns each part's digest, hash and write fused over the same
  bytes (the pool hashes while the calling thread writes);
- ``write_parts_hash_batch`` — N payloads in ONE call and ONE pool
  submission (the fs plugin's micro-batcher feeds it), each member's write
  outcome isolated;
- ``write_file_parts`` — the same write without digests (checksums off);
- ``configure_direct_io`` / ``direct_io_mode`` / ``check_direct_io_degrade``
  — the opt-in direct-I/O write plane (``TPUSNAP_DIRECT_IO``): io_uring,
  then aligned pwrite with ``O_DIRECT``, then buffered, with one
  ``native.degraded`` event when a filesystem forces the last rung;
- ``xxhash64`` / ``xxhash64_striped`` — the "xxh64" and "xxh64s" digests;
- ``read_ranges_into`` — parallel pread into caller-owned buffers, with
  optional fused per-range digests;
- ``read_file_into`` — one sequential pread stream into a caller-owned
  buffer on the calling thread;
- ``cdc_boundaries`` — content-defined chunk edges (chunker.py), the
  candidate scan striped over the worker pool;
- ``zstd_encode_into`` / ``zstd_encode2_into`` / ``zstd_decode_into`` — the
  compression frame's zstd codec (compression.py), straight into and out of
  caller-owned buffers.  ``has_zstd`` says whether the library found a zstd
  backend (linked at build time, or ``libzstd.so.1`` at run time).

The library is required: :meth:`NativeFileIO.get` builds and loads it, and
raises if it cannot.  The GIL is released for every call (ctypes).
"""

from __future__ import annotations

import ctypes
import logging
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
NATIVE_ABI_VERSION = 3

logger = logging.getLogger(__name__)

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


class NativeZstdError(RuntimeError):
    """Native zstd could not run: no backend, a real codec failure, or (for
    the advanced encode) a libzstd without the cctx API."""


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
            "tpusnap_write_parts_hash_batch": (
                ctypes.c_int,
                [
                    ctypes.POINTER(ctypes.c_char_p),
                    ctypes.c_int,
                    ctypes.POINTER(ctypes.c_int),
                    ctypes.POINTER(_P),
                    ctypes.POINTER(_I64),
                    ctypes.c_int,
                    _U64,
                    _I64,
                    _I64,
                    ctypes.POINTER(_U64),
                    ctypes.POINTER(ctypes.c_int),
                ],
            ),
            "tpusnap_direct_io_configure": (ctypes.c_int, [ctypes.c_int]),
            "tpusnap_direct_io_mode": (ctypes.c_int, []),
            "tpusnap_read_range": (ctypes.c_int, [ctypes.c_char_p, _P, _I64, _I64]),
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
            "tpusnap_cdc_boundaries": (
                _I64,
                [_P, _I64, _I64, _I64, _I64, ctypes.POINTER(_I64), _I64],
            ),
            "tpusnap_has_zstd": (ctypes.c_int, []),
            "tpusnap_zstd_encode": (_I64, [_P, _I64, _P, _I64, ctypes.c_int]),
            "tpusnap_zstd_encode2": (
                _I64,
                [_P, _I64, _P, _I64, ctypes.c_int, ctypes.c_int, ctypes.c_int],
            ),
            "tpusnap_zstd_decode": (_I64, [_P, _I64, _P, _I64]),
        }
        for name, (restype, argtypes) in sigs.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        lib.tpusnap_pool_configure(knobs.get_native_threads())
        self._lib = lib
        self.path = path
        self.has_zstd = bool(lib.tpusnap_has_zstd())

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

    def write_parts_hash_batch(
        self, jobs: Sequence[Tuple[str, Sequence[Any]]]
    ) -> List[Any]:
        """Fused write+hash of several payload files in ONE native call and
        one pool submission.  Returns one result per ``(path, parts)`` job,
        in order: the job's per-part digests (what :meth:`write_parts_hash`
        returns), or an ``OSError`` when that job's write failed; one
        member's failure leaves its siblings' writes standing."""
        if not jobs:
            return []
        paths = [path.encode() for path, _ in jobs]
        per_job = [[_u8(p) for p in parts] for _, parts in jobs]
        arrs = [a for job in per_job for a in job]
        bufs, sizes = _ptrs(arrs)
        njobs = len(jobs)
        out = (_U64 * max(len(arrs), 1))()
        errs = (ctypes.c_int * njobs)()
        self._lib.tpusnap_write_parts_hash_batch(
            (ctypes.c_char_p * njobs)(*paths),
            njobs,
            (ctypes.c_int * njobs)(*(len(job) for job in per_job)),
            bufs,
            sizes,
            len(arrs),
            0,
            STRIPE_BYTES,
            STRIPED_MIN_BYTES,
            out,
            errs,
        )  # the per-job outcomes are in errs; rc is the first of them
        results: List[Any] = []
        index = 0
        for i, job in enumerate(per_job):
            err = int(errs[i])
            if err != 0:
                results.append(OSError(-err, os.strerror(-err), jobs[i][0]))
            else:
                results.append([int(out[index + k]) for k in range(len(job))])
            index += len(job)
        return results

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

    def read_file_into(self, path: str, offset: int, view: Any) -> None:
        """One sequential pread stream of ``[offset, offset + len(view))``
        into the writable ``view``, on the calling thread (no pool tasks).
        A short file raises ``OSError(EIO)``."""
        arr = np.frombuffer(memoryview(view).cast("B"), np.uint8)
        if arr.nbytes:
            _check(
                self._lib.tpusnap_read_range(
                    path.encode(), arr.ctypes.data, offset, arr.nbytes
                ),
                path,
            )

    # ------------------------------------------------------- direct I/O

    _direct_io_reported = False

    def configure_direct_io(self, enabled: bool) -> int:
        """Set the PROCESS-global direct-I/O mode (``TPUSNAP_DIRECT_IO``):
        resolves io_uring, then aligned pwrite with ``O_DIRECT``.  Returns
        the mode: 0 off, 1 io_uring, 2 ``O_DIRECT`` pwrite, 3 buffered (a
        filesystem rejected ``O_DIRECT`` earlier in this process)."""
        return int(self._lib.tpusnap_direct_io_configure(1 if enabled else 0))

    def direct_io_mode(self) -> int:
        """The current mode (see :meth:`configure_direct_io`); it moves
        from 1 or 2 to 3 at the first write to a filesystem that rejects
        ``O_DIRECT``."""
        return int(self._lib.tpusnap_direct_io_mode())

    def check_direct_io_degrade(self) -> None:
        """One ``native.degraded`` event and one warning per process once
        direct I/O was asked for and the writes fell back to buffered I/O
        (mode 3).  The writes themselves succeeded; this makes the fallback
        visible."""
        if NativeFileIO._direct_io_reported or self.direct_io_mode() != 3:
            return
        NativeFileIO._direct_io_reported = True
        logger.warning(
            "TPUSNAP_DIRECT_IO is set but the filesystem rejected O_DIRECT; "
            "payload writes fall back to buffered I/O"
        )
        from .event import Event
        from .event_handlers import log_event

        log_event(
            Event(
                name="native.degraded",
                metadata={"missing": ["direct_io"], "mode": "buffered"},
            )
        )

    def cdc_boundaries(
        self, buf: Any, min_size: int, avg_size: int, max_size: int
    ) -> List[int]:
        """Content-defined chunk END offsets of ``buf`` (ascending, the last
        one its length), byte-identical to ``chunker.boundaries_py``."""
        arr = _u8(buf)
        n = arr.nbytes
        if n == 0:
            return []
        cap = n // min_size + 2
        out = (_I64 * cap)()
        rc = self._lib.tpusnap_cdc_boundaries(
            arr.ctypes.data, n, min_size, avg_size, max_size, out, cap
        )
        if rc < 0:
            raise ValueError(
                f"tpusnap_cdc_boundaries failed (rc {int(rc)}) for "
                f"min={min_size} avg={avg_size} max={max_size}"
            )
        return list(out[: int(rc)])

    def _zstd_args(self, src: Any, dst: Any) -> Tuple[np.ndarray, np.ndarray]:
        if not self.has_zstd:
            raise NativeZstdError("no zstd backend (libzstd.so.1 not found)")
        src_arr = _u8(src)
        dst_arr = np.frombuffer(memoryview(dst).cast("B"), np.uint8)
        return src_arr, dst_arr

    def zstd_encode_into(self, src: Any, dst: Any, level: int) -> Optional[int]:
        """zstd of ``src`` written into the writable ``dst``.  Returns the
        encoded length, or None when it does not fit ``dst`` (the caller
        stores the payload raw); a real failure raises NativeZstdError."""
        src_arr, dst_arr = self._zstd_args(src, dst)
        if src_arr.nbytes == 0:
            raise NativeZstdError("empty input")
        n = self._lib.tpusnap_zstd_encode(
            src_arr.ctypes.data, src_arr.nbytes, dst_arr.ctypes.data, dst_arr.nbytes, int(level)
        )
        if n > 0:
            return int(n)
        if n == -1:
            return None
        raise NativeZstdError(f"ZSTD_compress failed (rc {int(n)})")

    def zstd_encode2_into(
        self, src: Any, dst: Any, level: int, window_log: int, enable_ldm: bool
    ) -> Optional[int]:
        """:meth:`zstd_encode_into` with a window log and long-distance
        matching; raises NativeZstdError when the advanced API is missing."""
        src_arr, dst_arr = self._zstd_args(src, dst)
        if src_arr.nbytes == 0:
            raise NativeZstdError("empty input")
        n = self._lib.tpusnap_zstd_encode2(
            src_arr.ctypes.data,
            src_arr.nbytes,
            dst_arr.ctypes.data,
            dst_arr.nbytes,
            int(level),
            int(window_log),
            1 if enable_ldm else 0,
        )
        if n > 0:
            return int(n)
        if n == -1:
            return None
        raise NativeZstdError(f"ZSTD_compress2 failed (rc {int(n)})")

    def zstd_decode_into(self, src: Any, dst: Any) -> int:
        """Decode one zstd frame into ``dst`` (sized to the recorded
        uncompressed length); returns the decoded length."""
        src_arr, dst_arr = self._zstd_args(src, dst)
        n = self._lib.tpusnap_zstd_decode(
            src_arr.ctypes.data, src_arr.nbytes, dst_arr.ctypes.data, dst_arr.nbytes
        )
        if n < 0:
            raise NativeZstdError(f"ZSTD_decompress failed (rc {int(n)})")
        return int(n)
