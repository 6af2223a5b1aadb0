"""Chunk-compression codecs and the self-describing frame format.

Counterpart of ``torchsnapshot_tpu/compression.py``, with the same frame,
codec ids and resolution rules, so either package decodes the other's
frames.  Frame layout (little-endian, 16 bytes)::

    offset  size  field
    0       4     magic  b"TSNC"
    4       1     codec id (0=raw 1=zstd 2=lz4 3=zlib)
    5       1     flags  (reserved, 0)
    6       2     reserved (0)
    8       8     uncompressed payload length (u64)

followed by the codec's compressed bytes.  The header, not the manifest,
decides decoding: a payload planned for zstd that does not shrink is
stored raw inside a frame (codec id 0).  The manifest's ``codec`` field
only says whether a payload is framed at all (``None`` = bare bytes).

Backends: zstd runs in the native library (``libzstd``, linked at build
time or opened at run time; the JAX package's first choice too, so the
same bytes give the same frames), zlib is the standard library (deflate
output identical to the JAX package's native and Python paths), and lz4
has no backend in this package.  A configured codec with no backend
resolves to ``raw`` with a one-time warning; decoding a frame whose codec
has no backend raises :class:`FrameError`.

Manifest checksums cover the FRAME (the bytes on disk), so verification
precedes decoding and a corrupt frame fails as ``ChecksumError`` first.
"""

from __future__ import annotations

import logging
import struct
import zlib
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

MAGIC = b"TSNC"
_HEADER = struct.Struct("<4sBBHQ")
HEADER_BYTES = _HEADER.size  # 16


class FrameError(RuntimeError):
    """A frame that cannot be decoded: truncated, corrupted, an unknown
    codec, or a codec with no backend on this host."""


class _Codec:
    __slots__ = ("name", "codec_id", "_compress", "_decompress", "default_level", "_available")

    def __init__(
        self,
        name: str,
        codec_id: int,
        compress: Optional[Callable[[Any, Optional[int]], Any]],
        decompress: Callable[[Any, int, Optional[memoryview]], Any],
        default_level: Optional[int] = None,
        available: Optional[Callable[[], bool]] = None,
    ) -> None:
        self.name = name
        self.codec_id = codec_id
        self._compress = compress
        self._decompress = decompress
        self.default_level = default_level
        self._available = available

    def compress(self, data: Any, level: Optional[int] = None) -> Any:
        """The compressed bytes.  zstd has no such step: :func:`encode`
        runs it natively straight into the frame."""
        if self._compress is None:
            raise NotImplementedError(f"{self.name} encodes only through encode()")
        return self._compress(data, level if level is not None else self.default_level)

    def decompress(
        self, data: Any, uncompressed_len: int, out: Optional[memoryview] = None
    ) -> Any:
        """The decoded bytes; written into ``out`` (``uncompressed_len``
        bytes) when it is given."""
        return self._decompress(data, uncompressed_len, out)

    def is_available(self) -> bool:
        return True if self._available is None else bool(self._available())


def _into(out: Optional[memoryview], data: Any) -> Any:
    """``data``, copied into ``out`` when the caller supplied one."""
    if out is None:
        return data
    src = memoryview(data).cast("B")
    if src.nbytes != out.nbytes:
        return data  # decode() reports the length mismatch
    out[:] = src
    return out


def _raw_compress(data: Any, level: Optional[int]) -> bytes:
    return bytes(data)


def _raw_decompress(data: Any, uncompressed_len: int, out: Optional[memoryview]) -> Any:
    return _into(out, data)


def _native():
    from .native_io import NativeFileIO

    return NativeFileIO.get()


def _zstd_params() -> Tuple[int, bool]:
    """(window_log, enable_ldm) from the ``TPUSNAP_ZSTD_*`` knobs; (0,
    False) is the plain level-only encode."""
    from . import knobs

    return knobs.get_zstd_window_log(), knobs.zstd_ldm_enabled()


def _zstd_encode_into(native: Any, mv: Any, out: memoryview, level: int) -> Optional[int]:
    """Native zstd of ``mv`` into ``out``, with the window-log and LDM
    knobs when set; a libzstd without the advanced API falls back to the
    plain encode with a one-time warning (frames are standard either way)."""
    from .native_io import NativeZstdError

    window_log, ldm = _zstd_params()
    if window_log or ldm:
        try:
            return native.zstd_encode2_into(mv, out, level, window_log, ldm)
        except NativeZstdError:
            if "zstd-params" not in _WARNED:
                _WARNED.add("zstd-params")
                logger.warning(
                    "TPUSNAP_ZSTD_WINDOW_LOG/TPUSNAP_ZSTD_LDM requested but "
                    "libzstd lacks the advanced API; encoding level-only"
                )
    return native.zstd_encode_into(mv, out, level)


def _zstd_decompress(data: Any, uncompressed_len: int, out: Optional[memoryview]) -> Any:
    dst = out if out is not None else memoryview(np.empty(uncompressed_len, dtype=np.uint8))
    n = _native().zstd_decode_into(data, dst)
    return dst[:n]


def _zstd_available() -> bool:
    return _native().has_zstd


def _zlib_compress(data: Any, level: Optional[int]) -> bytes:
    return zlib.compress(data, -1 if level is None else level)


def _zlib_decompress(data: Any, uncompressed_len: int, out: Optional[memoryview]) -> Any:
    return _into(out, zlib.decompress(data, bufsize=max(uncompressed_len, 1)))


RAW = _Codec("raw", 0, _raw_compress, _raw_decompress)

# Level 1 for both real codecs, as in the JAX package: the checkpoint path
# wants throughput; ratio-hungry callers pass ``zstd:3`` or ``zlib:6``.
_FACTORIES: Dict[str, Callable[[], Optional[_Codec]]] = {
    "zstd": lambda: _Codec(
        "zstd", 1, None, _zstd_decompress, default_level=1, available=_zstd_available
    ),
    # No lz4 backend in this package: the codec resolves to raw.
    "lz4": lambda: None,
    "zlib": lambda: _Codec("zlib", 3, _zlib_compress, _zlib_decompress, default_level=1),
}

_CODECS: Dict[str, Optional[_Codec]] = {"raw": RAW}
_BY_ID: Dict[int, _Codec] = {0: RAW}
_WARNED: set = set()


def get_codec(name: str) -> Optional[_Codec]:
    """The codec named ``name``, or None when it has no backend here.
    Unknown names raise: a typo must not silently disable compression."""
    if name == "raw":
        return RAW
    factory = _FACTORIES.get(name)
    if factory is None:
        raise ValueError(
            f"Unknown compression codec {name!r} "
            f"(known: raw, {', '.join(sorted(_FACTORIES))})"
        )
    if name not in _CODECS:
        codec = factory()
        _CODECS[name] = codec
        if codec is not None:
            _BY_ID[codec.codec_id] = codec
    return _CODECS[name]


def resolve(name: str) -> str:
    """The configured codec if this host can run it, else ``raw`` (with a
    one-time warning)."""
    if name == "raw":
        return "raw"
    codec = get_codec(name)
    if codec is not None and codec.is_available():
        return name
    if name not in _WARNED:
        _WARNED.add(name)
        logger.warning(
            "Compression codec %r requested but it has no backend on this "
            "host; storing chunks raw",
            name,
        )
    return "raw"


def available_codecs() -> Tuple[str, ...]:
    """Codec names usable on this host, best first."""
    out = []
    for name in ("zstd", "lz4", "zlib"):
        codec = get_codec(name)
        if codec is not None and codec.is_available():
            out.append(name)
    return tuple(out)


def _native_codec_frame(mv: memoryview, usize: int, codec: _Codec, level: Optional[int]):
    """zstd straight into the frame's payload region: one allocation, no
    copy of the compressed bytes.  Returns the frame, or ``None`` when the
    payload does not shrink (the caller frames it raw); a failed native
    encode raises :class:`NativeZstdError`."""
    from . import phase_stats

    # np.empty, not bytearray: no zero-fill pass under the GIL.  The
    # payload region holds usize - 1 bytes, so a fit means it shrank.
    arr = np.empty(HEADER_BYTES + usize - 1, dtype=np.uint8)
    frame = memoryview(arr)
    eff_level = level if level is not None else codec.default_level
    with phase_stats.timed("compress", usize):
        elen = _zstd_encode_into(_native(), mv, frame[HEADER_BYTES:], eff_level)
    if elen is None:
        return None
    _HEADER.pack_into(arr, 0, MAGIC, codec.codec_id, 0, 0, usize)
    flen = HEADER_BYTES + elen
    if flen < usize // 2:
        # A slice would pin the whole uncompressed-bound allocation while
        # the scheduler credits only the frame's bytes: copy out when the
        # allocation is more than twice the frame.
        return bytearray(frame[:flen])
    return frame[:flen]


def encode(buf: Any, codec_name: str, level: Optional[int] = None) -> Tuple[Any, str]:
    """Frame ``buf``'s bytes with ``codec_name``; returns ``(frame,
    inner_codec_name)``.  Stores raw inside the frame when compression
    does not shrink the payload or the codec fails; the preemption
    deadline mode frames raw regardless of the codec."""
    from . import phase_stats, preemption

    mv = memoryview(buf).cast("B")
    usize = mv.nbytes
    codec = None if preemption.deadline_active() else get_codec(codec_name)
    payload: Any = mv
    inner = RAW
    if codec is not None and codec.codec_id != 0 and usize > 0:
        try:
            if codec.name == "zstd":
                native_frame = _native_codec_frame(mv, usize, codec, level)
                if native_frame is not None:
                    return native_frame, codec.name
            else:
                with phase_stats.timed("compress", usize):
                    candidate = codec.compress(mv, level)
                if memoryview(candidate).nbytes < usize:
                    payload = candidate
                    inner = codec
        except Exception:
            logger.warning(
                "Compression with %r failed; storing chunk raw", codec_name, exc_info=True
            )
    frame = bytearray(HEADER_BYTES + memoryview(payload).nbytes)
    _HEADER.pack_into(frame, 0, MAGIC, inner.codec_id, 0, 0, usize)
    frame[HEADER_BYTES:] = payload
    return frame, inner.name


def decode(
    buf: Any,
    expected_nbytes: Optional[int] = None,
    location: str = "",
    out: Optional[memoryview] = None,
) -> memoryview:
    """Decode one frame back to its payload bytes.  ``out``: a writable
    buffer of the payload's size to decode into (a pinned read buffer);
    the result is then a view of it.

    Raises :class:`FrameError` on a truncated or corrupted frame, an
    unknown codec id, a codec with no backend, or an uncompressed length
    that disagrees with ``expected_nbytes`` (what the manifest implies)."""
    from . import phase_stats

    mv = memoryview(buf).cast("B")
    where = f" for {location}" if location else ""
    if mv.nbytes < HEADER_BYTES:
        raise FrameError(
            f"Truncated compression frame{where}: {mv.nbytes} bytes < "
            f"{HEADER_BYTES}-byte header"
        )
    magic, codec_id, _flags, _reserved, usize = _HEADER.unpack(mv[:HEADER_BYTES])
    if magic != MAGIC:
        raise FrameError(f"Bad compression frame magic{where}: {bytes(magic)!r} != {MAGIC!r}")
    if expected_nbytes is not None and usize != expected_nbytes:
        raise FrameError(
            f"Compression frame{where} records {usize} uncompressed bytes; "
            f"manifest implies {expected_nbytes}"
        )
    if out is not None and memoryview(out).nbytes != usize:
        raise ValueError(
            f"decode destination holds {memoryview(out).nbytes} bytes, frame{where} "
            f"records {usize}"
        )
    codec = _BY_ID.get(codec_id)
    if codec is None:
        for name in _FACTORIES:
            get_codec(name)
        codec = _BY_ID.get(codec_id)
    if codec is None or not codec.is_available():
        raise FrameError(
            f"Compression frame{where} uses codec id {codec_id}, which is "
            "unknown or has no backend on this host"
        )
    body = mv[HEADER_BYTES:]
    dst = None if out is None else memoryview(out).cast("B")
    if codec.codec_id == 0:
        if body.nbytes != usize:
            raise FrameError(
                f"Truncated raw frame{where}: {body.nbytes} payload bytes, header records {usize}"
            )
        return body if dst is None else memoryview(_into(dst, body))
    try:
        with phase_stats.timed("decompress", usize):
            decoded = codec.decompress(body, usize, dst)
    except FrameError:
        raise
    except Exception as e:
        raise FrameError(f"Corrupt {codec.name} frame{where}: {type(e).__name__}: {e}") from e
    decoded_mv = memoryview(decoded).cast("B")
    if decoded_mv.nbytes != usize:
        raise FrameError(
            f"Corrupt {codec.name} frame{where}: decompressed to {decoded_mv.nbytes} "
            f"bytes, header records {usize}"
        )
    return decoded_mv


def is_framed(entry: Any) -> bool:
    """Whether a manifest entry's payload is frame-encoded (its ``codec``
    is set, ``"raw"`` included); None means bare bytes."""
    return getattr(entry, "codec", None) is not None
