"""Payload integrity: digests recorded in the manifest, verified on restore.

Counterpart of ``torchsnapshot_tpu/integrity.py``.  Every array/object
payload gets a digest of its exact stored bytes on its manifest entry,
verified whenever a consumer receives a payload in full.  Tiled partial
reads skip verification.  ``TPUSNAP_CHECKSUM=0`` disables both sides.

Two algorithms, chosen by payload size (size-only, so the fused native
write and a separate hash pass give the same manifest):

- ``xxh64:<hex>`` — plain xxHash64 (seed 0) below ``STRIPED_MIN_BYTES``;
- ``xxh64s:<hex>`` — independent xxh64 per ``STRIPE_BYTES`` window,
  combined via xxh64 over the little-endian digest stream.

Digests come from the native library only (native_io); the port has no
pure-Python hash backend.
"""

from __future__ import annotations

import asyncio
from typing import Optional

from . import knobs, phase_stats
from .native_io import STRIPED_MIN_BYTES, NativeFileIO


class ChecksumError(RuntimeError):
    """A payload's bytes do not match the digest its manifest entry records."""


_KNOWN_ALGOS = ("xxh64", "xxh64s")

# Below this the executor round-trip costs more than the hash itself.
_INLINE_DIGEST_MAX_BYTES = 1 << 20


def checksums_enabled() -> bool:
    return knobs.checksum_enabled()


def save_checksums_enabled() -> bool:
    """Whether saves RECORD digests (``TPUSNAP_CHECKSUM_ON_SAVE``)."""
    return checksums_enabled() and knobs.checksum_on_save_enabled()


def digest_algo_for(nbytes: int) -> str:
    return "xxh64s" if nbytes >= STRIPED_MIN_BYTES else "xxh64"


def format_digest(hash64: int, nbytes: int) -> str:
    return f"{digest_algo_for(nbytes)}:{hash64:016x}"


def hash_algo_of(checksum: Optional[str]) -> Optional[str]:
    """The algo tag of a recorded digest, or None when absent/unknown."""
    if not checksum:
        return None
    algo = checksum.partition(":")[0]
    return algo if algo in _KNOWN_ALGOS else None


def _hash64(buf, algo: str) -> int:
    native = NativeFileIO.get()
    if algo == "xxh64s":
        return native.xxhash64_striped(buf)
    return native.xxhash64(buf)


def digest(buf) -> str:
    """The digest of ``buf`` under the size policy."""
    nbytes = memoryview(buf).nbytes
    algo = digest_algo_for(nbytes)
    with phase_stats.timed("checksum", nbytes):
        h = _hash64(buf, algo)
    return f"{algo}:{h:016x}"


def digest_as(buf, expected: Optional[str]) -> str:
    """The digest of ``buf`` under the algorithm an existing recorded
    digest used (the size policy when its tag is absent or unknown): dedup
    compares against a base's digests the base's way."""
    algo = hash_algo_of(expected)
    if algo is None:
        return digest(buf)
    with phase_stats.timed("checksum", memoryview(buf).nbytes):
        h = _hash64(buf, algo)
    return f"{algo}:{h:016x}"


async def compute_on(buf, executor) -> Optional[str]:
    """A recording digest (None when saves record none), hashed on the
    executor for large buffers — the native hashers release the GIL."""
    if not save_checksums_enabled():
        return None
    if executor is None or memoryview(buf).nbytes < _INLINE_DIGEST_MAX_BYTES:
        return digest(buf)
    return await asyncio.get_running_loop().run_in_executor(executor, digest, buf)


def verify(
    buf,
    expected: Optional[str],
    location: str,
    precomputed: Optional[int] = None,
) -> None:
    """Verify ``buf`` against its manifest digest.  ``precomputed`` is a
    64-bit digest under the EXPECTED algorithm already computed over exactly
    these bytes (fused with the read), so the buffer is not traversed
    again."""
    if expected is None or not checksums_enabled():
        return
    algo, _, digest_hex = expected.partition(":")
    if algo not in _KNOWN_ALGOS:
        return  # unknown algorithm: tolerate (forward compat)
    if precomputed is not None:
        actual = f"{precomputed:016x}"
    else:
        with phase_stats.timed("checksum", memoryview(buf).nbytes):
            actual = f"{_hash64(buf, algo):016x}"
    if actual != digest_hex:
        raise ChecksumError(
            f"Checksum mismatch for {location}: stored {algo}:{digest_hex}, "
            f"computed {algo}:{actual} — the payload is corrupt"
        )
