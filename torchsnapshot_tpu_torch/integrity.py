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

``audit`` proves a snapshot's stored bytes against its manifest without
restoring it (``copy_snapshot(verify=True)`` runs it on the replica).
"""

from __future__ import annotations

import asyncio
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

from . import knobs, phase_stats
from .io_types import ReadIO
from .manifest import iter_payload_entries
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


def payload_checksums(metadata) -> dict:
    """``{(location, byte_range_tuple_or_None): checksum_or_None}`` for every
    payload the manifest references, deduplicated (replicated entries and
    slab members share durable payloads).  A digest-carrying reference wins
    over a digest-less duplicate of the same payload, so the audit never
    skips it."""
    payloads: dict = {}
    for _, entry in iter_payload_entries(metadata.manifest):
        byte_range = getattr(entry, "byte_range", None)
        key = (entry.location, tuple(byte_range) if byte_range else None)
        if payloads.get(key) is None:
            payloads[key] = entry.checksum
    return payloads


def payload_referrers(metadata) -> dict:
    """``{location: sorted manifest keys referencing it}``: who to name when
    a shared payload (a slab, a deduplicated CAS chunk) is missing."""
    referrers: dict = {}
    for key, entry in iter_payload_entries(metadata.manifest):
        referrers.setdefault(entry.location, set()).add(key)
    return {loc: sorted(keys) for loc, keys in referrers.items()}


def audit(storage, metadata, io_concurrency: int = 4) -> tuple:
    """Read every checksummed payload item and verify its digest, without
    restoring.  Returns ``(ok, corrupt, unreadable, problems)``, where
    ``problems`` holds one line per failure; digest-less payloads are
    skipped.

    Reads fan across ``io_concurrency`` threads and results are counted in
    payload order.  Each read carries its digest's algorithm, so a plugin
    that fuses hashing into the read (fs) verifies with no second pass.  An
    unreadable shared payload is reported once per location, naming up to
    8 referencing entries; the ``unreadable`` count stays per item."""
    items = sorted((k, v) for k, v in payload_checksums(metadata).items() if v is not None)

    def _check_one(item) -> tuple:
        (location, byte_range), checksum = item
        read_io = ReadIO(
            path=location,
            byte_range=list(byte_range) if byte_range else None,
            want_hash=True,
            hash_algo=hash_algo_of(checksum),
        )
        try:
            storage.sync_read(read_io)
        except Exception as e:  # noqa: BLE001 — reported, not raised
            return "unreadable", location, str(e)
        try:
            verify(read_io.buf, checksum, location, precomputed=read_io.hash64)
            return "ok", location, None
        except ChecksumError as e:
            return "corrupt", location, f"CORRUPT {e}"

    ok = corrupt = unreadable = 0
    problems = []
    unreadable_locations: dict = {}
    if not items:
        return ok, corrupt, unreadable, problems
    with ThreadPoolExecutor(max_workers=max(1, io_concurrency), thread_name_prefix="snap_audit") as pool:
        for status, location, problem in pool.map(_check_one, items):
            if status == "ok":
                ok += 1
            elif status == "corrupt":
                corrupt += 1
                problems.append(problem)
            else:
                unreadable += 1
                unreadable_locations.setdefault(location, problem)
    if unreadable_locations:
        referrers = payload_referrers(metadata)
        for location in sorted(unreadable_locations):
            refs = referrers.get(location, [])
            named = ", ".join(refs[:8]) + (f", ... {len(refs) - 8} more" if len(refs) > 8 else "")
            problems.append(
                f"UNREADABLE {location}: {unreadable_locations[location]}"
                + (f" (referenced by: {named})" if refs else "")
            )
    return ok, corrupt, unreadable, problems
