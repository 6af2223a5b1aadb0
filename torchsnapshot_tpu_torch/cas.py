"""Content-addressed chunk store: cross-snapshot dedup through digest
references.

Counterpart of the write and read side of ``torchsnapshot_tpu/cas.py``,
with the same layout and location grammars, so a root holds chunks of
either package and either package reads them:

- chunks live once under the snapshot's parent directory (the root) at
  ``<root>/cas/<algo>/<digest[:2]>/<digest>``;
- manifest entries reference them as ``cas://<algo>/<digest>`` (manifest
  0.4.0), or, for a payload split on content-defined edges (chunker.py),
  as ``casx://<algo>/<hex>@<n>+<hex>@<n>+...`` (0.6.0); slab members keep
  their byte range into the chunk;
- :class:`CASWriterPlugin` hashes every staged payload, writes a chunk the
  root does not hold yet (durably: temp file, fsync, rename) and records a
  pure reference otherwise, against a :class:`DigestIndex` seeded from
  the root's committed manifests (or the digest-index sidecar either
  package's manager left);
- :class:`CASReaderPlugin` resolves chunk locations against the root, so
  restore and read_object need no knowledge of the layout;
- :func:`prestage_delta_skip` resolves unchanged leaves to references
  before batching, compression and the write pipeline.

The manager (manager.py) persists the index as a root sidecar, lists the
chunks present and sweeps those no committed manifest references.  Not in
this package yet: repack and export, and the shared chunk store
(``TPUSNAP_STORE``), which a CAS take refuses.

Trust: a hit against the seeded index trusts committed manifests (chunks
are immutable once visible).  A chunk that exists but no committed
manifest references (a crashed take's debris, a concurrent writer) is
read and hashed before it is reused, else rewritten.
"""

from __future__ import annotations

import asyncio
import json
import logging
import threading
from typing import Any, Dict, List, Optional, Set, Tuple

from .io_types import ReadIO, StoragePlugin, WriteIO, contiguous

logger = logging.getLogger(__name__)

CAS_DIR = "cas"
CAS_SCHEME = "cas://"
CASX_SCHEME = "casx://"

# Either package's manager caches the digest index here between processes
# (persist_index_sidecar); load_or_seed_index trusts it while the committed
# markers it recorded still match the root.
INDEX_SIDECAR_FNAME = ".digest_index.json"
_INDEX_SIDECAR_VERSION = 2


# --------------------------------------------------------------- references


def is_cas_location(location: Any) -> bool:
    """A whole-chunk digest reference (``cas://``)."""
    return isinstance(location, str) and location.startswith(CAS_SCHEME)


def is_casx_location(location: Any) -> bool:
    """A multi-chunk reference (``casx://``)."""
    return isinstance(location, str) and location.startswith(CASX_SCHEME)


def is_chunk_location(location: Any) -> bool:
    """Whether a location references the content-addressed store at all."""
    return is_cas_location(location) or is_casx_location(location)


def parse_cas_location(location: str) -> Tuple[str, str]:
    """``"cas://<algo>/<hexdigest>"`` → ``(algo, hexdigest)``."""
    body = location[len(CAS_SCHEME) :]
    algo, sep, hexdigest = body.partition("/")
    if not sep or not algo or not hexdigest or "/" in hexdigest:
        raise ValueError(f"malformed CAS location: {location!r}")
    return algo, hexdigest


def location_for(algo: str, hexdigest: str) -> str:
    return f"{CAS_SCHEME}{algo}/{hexdigest}"


def chunk_relpath(algo: str, hexdigest: str) -> str:
    """Root-relative path of a chunk; the two-hex-char fan-out bounds any
    one directory's size."""
    return f"{CAS_DIR}/{algo}/{hexdigest[:2]}/{hexdigest}"


def relpath_for_location(location: str) -> str:
    return chunk_relpath(*parse_cas_location(location))


def parse_casx_location(location: str) -> List[Tuple[str, str, int]]:
    """``casx://...`` → ordered ``[(algo, hexdigest, nbytes), ...]``.  A part
    whose algo differs from the head's is written ``<algo>:<hex>@<n>``."""
    body = location[len(CASX_SCHEME) :]
    head_algo, sep, spec = body.partition("/")
    if not sep or not head_algo or not spec:
        raise ValueError(f"malformed casx location: {location!r}")
    parts: List[Tuple[str, str, int]] = []
    for token in spec.split("+"):
        algo = head_algo
        if ":" in token:
            algo, _, token = token.partition(":")
        hexdigest, sep, nbytes = token.partition("@")
        if not sep or not hexdigest or not algo:
            raise ValueError(f"malformed casx part {token!r} in {location!r}")
        parts.append((algo, hexdigest, int(nbytes)))
    return parts


def casx_location_for(parts: List[Tuple[str, str, int]]) -> str:
    """The ``casx://`` string for ordered (algo, hexdigest, nbytes) parts;
    a single part collapses to a plain ``cas://`` reference."""
    if len(parts) == 1:
        return location_for(parts[0][0], parts[0][1])
    head_algo = parts[0][0]
    tokens = []
    for algo, hexdigest, nbytes in parts:
        prefix = "" if algo == head_algo else f"{algo}:"
        tokens.append(f"{prefix}{hexdigest}@{nbytes}")
    return f"{CASX_SCHEME}{head_algo}/" + "+".join(tokens)


def _digest_key(algo: str, hexdigest: str) -> str:
    return f"{algo}/{hexdigest}"


def key_for_relpath(relpath: str) -> Optional[str]:
    """``"cas/<algo>/<p2>/<digest>"`` → the index key ``"<algo>/<digest>"``,
    or None for a path outside the chunk layout: a chunk sweep keeps the
    digest index in step with the disk through it."""
    parts = relpath.split("/")
    if len(parts) != 4 or parts[0] != CAS_DIR:
        return None
    return _digest_key(parts[1], parts[3])


def chunk_relpaths_of_location(location: str) -> List[str]:
    """Every chunk path a (cas or casx) location references, in order."""
    if is_cas_location(location):
        return [relpath_for_location(location)]
    return [chunk_relpath(a, h) for a, h, _ in parse_casx_location(location)]


def chunk_keys_of_location(location: str) -> List[str]:
    """Digest-index keys of every chunk a (cas or casx) location references."""
    if is_cas_location(location):
        return [_digest_key(*parse_cas_location(location))]
    return [_digest_key(a, h) for a, h, _ in parse_casx_location(location)]


def parent_root_url(snapshot_url: str) -> Optional[str]:
    """The directory holding a snapshot, where its ``cas/`` lives, or None
    for a path without a parent."""
    from .storage_plugin import parse_url

    protocol, path = parse_url(snapshot_url)
    path = path.rstrip("/")
    if "/" not in path:
        return None
    return f"{protocol}://{path.rsplit('/', 1)[0]}"


def manifest_uses_cas(manifest: Dict[str, Any]) -> bool:
    from .manifest import iter_payload_entries

    return any(is_chunk_location(e.location) for _, e in iter_payload_entries(manifest))


def referenced_chunk_relpaths(manifest: Dict[str, Any]) -> Set[str]:
    """Root-relative chunk paths a manifest references, casx parts included."""
    from .manifest import iter_payload_entries

    out: Set[str] = set()
    for _, entry in iter_payload_entries(manifest):
        if is_chunk_location(entry.location):
            out.update(chunk_relpaths_of_location(entry.location))
    return out


# ------------------------------------------------------------- digest index


class DigestIndex:
    """Chunks known durable under the root (``keys``: ``<algo>/<hex>``),
    and a whole-payload map (``payloads``: recorded payload digest →
    ``(location, byte_range)``) that lets a later take reference an
    unchanged leaf without staging it.  A payload lookup whose chunks are
    no longer indexed is dropped instead of returned.  Thread-safe."""

    def __init__(
        self,
        keys: Optional[Set[str]] = None,
        payloads: Optional[Dict[str, Tuple[str, Optional[Tuple[int, int]]]]] = None,
    ) -> None:
        self._keys: Set[str] = set(keys or ())
        self._payloads: Dict[str, Tuple[str, Optional[Tuple[int, int]]]] = dict(payloads or {})
        self._lock = threading.Lock()

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._keys

    def __len__(self) -> int:
        with self._lock:
            return len(self._keys)

    def add(self, key: str) -> None:
        with self._lock:
            self._keys.add(key)

    def discard(self, key: str) -> None:
        with self._lock:
            self._keys.discard(key)

    def record_payload(
        self, digest: Optional[str], location: str, byte_range: Optional[Any] = None
    ) -> None:
        if not digest:
            return
        with self._lock:
            self._payloads[digest] = (location, tuple(byte_range) if byte_range else None)

    def lookup_payload(
        self, digest: Optional[str]
    ) -> Optional[Tuple[str, Optional[Tuple[int, int]]]]:
        if not digest:
            return None
        with self._lock:
            hit = self._payloads.get(digest)
            if hit is None:
                return None
            try:
                keys = chunk_keys_of_location(hit[0])
            except ValueError:
                keys = []
            if not keys or any(k not in self._keys for k in keys):
                del self._payloads[digest]
                return None
            return hit

    def payload_count(self) -> int:
        with self._lock:
            return len(self._payloads)

    def snapshot_payloads(self) -> Dict[str, Tuple[str, Optional[Tuple[int, int]]]]:
        with self._lock:
            return dict(self._payloads)

    def snapshot_keys(self) -> Set[str]:
        with self._lock:
            return set(self._keys)


def committed_marker_relpaths(storage: StoragePlugin) -> List[str]:
    """Root-relative ``.snapshot_metadata`` paths of every committed step
    and journal segment under a root, sorted."""
    try:
        names = storage.sync_list_dir("")
    except (NotImplementedError, FileNotFoundError):
        return []
    out: List[str] = []
    for name in sorted(names):
        if not (name.startswith("step_") or name.startswith("seg_")):
            continue
        marker = f"{name}/.snapshot_metadata"
        try:
            if storage.sync_exists(marker):
                out.append(marker)
        except Exception:  # noqa: BLE001 — an unreadable step contributes nothing
            continue
    return out


def seed_digest_index(storage: StoragePlugin) -> DigestIndex:
    """A :class:`DigestIndex` from every committed manifest under a root
    (journal segments included: their chunks are committed too).  An
    unreadable manifest contributes nothing; dedup then falls back to
    per-chunk existence probes, never to a wrong reference."""
    from .manifest import SnapshotMetadata, iter_payload_entries

    keys: Set[str] = set()
    payloads: Dict[str, Tuple[str, Optional[Tuple[int, int]]]] = {}
    for marker in committed_marker_relpaths(storage):
        read_io = ReadIO(path=marker)
        try:
            storage.sync_read(read_io)
            metadata = SnapshotMetadata.from_json(bytes(read_io.buf).decode("utf-8"))
        except Exception:  # noqa: BLE001 — torn, absent or foreign
            continue
        for _, entry in iter_payload_entries(metadata.manifest):
            if not is_chunk_location(entry.location):
                continue
            keys.update(chunk_keys_of_location(entry.location))
            # The recorded checksum is the digest of exactly the bytes this
            # location (and range) serves.
            if entry.checksum:
                byte_range = getattr(entry, "byte_range", None)
                payloads[entry.checksum] = (
                    entry.location,
                    tuple(byte_range) if byte_range else None,
                )
    return DigestIndex(keys, payloads)


def persist_index_sidecar(storage: StoragePlugin, index: DigestIndex, algo: str) -> None:
    """Write the root's index sidecar: the digest set, the payload map, and
    the committed marker set they were derived from (what a load checks).
    Durable, so a torn sidecar cannot half-parse; callers treat a failure
    as best-effort, since the manifests stay the source of truth."""
    doc = {
        "version": _INDEX_SIDECAR_VERSION,
        "algo": algo,
        "keys": sorted(index.snapshot_keys()),
        "payloads": {
            digest: [location, list(byte_range) if byte_range else None]
            for digest, (location, byte_range) in sorted(index.snapshot_payloads().items())
        },
        "committed": committed_marker_relpaths(storage),
    }
    storage.sync_write(WriteIO(path=INDEX_SIDECAR_FNAME, buf=json.dumps(doc).encode("utf-8"), durable=True))


def drop_index_sidecar(storage: StoragePlugin) -> None:
    """Remove the root's index sidecar (best-effort): after chunks were
    swept by a process that holds no index, the sidecar would still list
    them while the committed marker set it is checked against is unchanged."""
    try:
        storage.sync_delete(INDEX_SIDECAR_FNAME)
    except Exception:  # noqa: BLE001 — absent already, or the next load re-seeds
        pass


def load_or_seed_index(root_url: str, storage: StoragePlugin, algo: str) -> DigestIndex:
    """The digest index of a root: a manager's sidecar when the set of
    committed markers it recorded still matches the root, else a seed from
    the committed manifests.  A stale or unreadable sidecar only costs the
    seed."""
    try:
        read_io = ReadIO(path=INDEX_SIDECAR_FNAME)
        storage.sync_read(read_io)
        doc = json.loads(bytes(read_io.buf).decode("utf-8"))
        if (
            doc.get("version") == _INDEX_SIDECAR_VERSION
            and doc.get("algo") == algo
            and isinstance(doc.get("keys"), list)
            and isinstance(doc.get("payloads"), dict)
            and doc.get("committed") == committed_marker_relpaths(storage)
        ):
            payloads = {
                digest: (rec[0], tuple(rec[1]) if rec[1] else None)
                for digest, rec in doc["payloads"].items()
                if isinstance(rec, list) and len(rec) == 2
            }
            return DigestIndex(set(doc["keys"]), payloads)
        logger.debug("digest index sidecar of %s is stale; seeding", root_url)
    except Exception:  # noqa: BLE001 — the sidecar is only a cache
        pass
    return seed_digest_index(storage)


def list_chunk_relpaths(storage: StoragePlugin) -> List[str]:
    """Every chunk present under a root's ``cas/`` directory, as sorted
    root-relative paths (``cas/<algo>/<p2>/<digest>``)."""
    out: List[str] = []
    try:
        algos = storage.sync_list_dir(CAS_DIR)
    except (NotImplementedError, FileNotFoundError):
        return out
    for algo in algos:
        try:
            prefixes = storage.sync_list_dir(f"{CAS_DIR}/{algo}")
        except FileNotFoundError:
            continue
        for prefix in prefixes:
            try:
                names = storage.sync_list_dir(f"{CAS_DIR}/{algo}/{prefix}")
            except FileNotFoundError:
                continue
            out.extend(f"{CAS_DIR}/{algo}/{prefix}/{name}" for name in names)
    return sorted(out)


# ------------------------------------------------------------------- reads


async def _read_via_root(root: StoragePlugin, read_io: ReadIO) -> None:
    """Resolve one ``cas://`` or ``casx://`` read against the root."""
    if is_casx_location(read_io.path):
        await _read_casx_via_root(root, read_io)
        return
    sub = ReadIO(
        path=relpath_for_location(read_io.path),
        byte_range=read_io.byte_range,
        into=read_io.into,
        want_hash=read_io.want_hash,
        hash_algo=read_io.hash_algo,
    )
    await root.read(sub)
    read_io.buf = sub.buf
    read_io.hash64 = sub.hash64


async def _read_casx_via_root(root: StoragePlugin, read_io: ReadIO) -> None:
    """Assemble a ``casx://`` read: one read per chunk that the requested
    range intersects, each straight into its offset of one destination (the
    caller's ``into``, such as a CUDA target's pinned read buffer, when it
    has the range's size).  No fused digest: the consumer verifies the
    assembled bytes against the payload's checksum."""
    import numpy as np

    parts = parse_casx_location(read_io.path)
    total = sum(nbytes for _, _, nbytes in parts)
    start, end = read_io.byte_range if read_io.byte_range is not None else (0, total)
    if not (0 <= start <= end <= total):
        raise ValueError(
            f"byte range [{start}, {end}) outside casx payload of {total} bytes: {read_io.path}"
        )
    if read_io.into is not None and memoryview(read_io.into).nbytes == end - start:
        out = memoryview(read_io.into).cast("B")
    else:
        out = memoryview(np.empty(end - start, dtype=np.uint8))

    async def _one(relpath: str, sub_range: List[int], dst: memoryview) -> None:
        sub = ReadIO(path=relpath, byte_range=sub_range, into=dst)
        await root.read(sub)
        if sub.buf is not dst:
            src = memoryview(sub.buf).cast("B")
            if src.nbytes != dst.nbytes:
                raise RuntimeError(
                    f"casx part {relpath}[{sub_range[0]}:{sub_range[1]}] returned "
                    f"{src.nbytes} bytes, expected {dst.nbytes}"
                )
            dst[:] = src

    coros = []
    offset = 0
    for algo, hexdigest, nbytes in parts:
        p0, p1 = max(start, offset), min(end, offset + nbytes)
        if p0 < p1:
            coros.append(
                _one(
                    chunk_relpath(algo, hexdigest),
                    [p0 - offset, p1 - offset],
                    out[p0 - start : p1 - start],
                )
            )
        offset += nbytes
    if coros:
        await asyncio.gather(*coros)
    read_io.buf = out
    read_io.hash64 = None


async def _read_chunk_digest(root: StoragePlugin, relpath: str, executor=None) -> Optional[str]:
    """The digest of the chunk's bytes at ``relpath``, or None when it is
    absent or unreadable: the check before trusting a chunk no committed
    manifest references."""
    from . import integrity

    try:
        read_io = ReadIO(path=relpath)
        await root.read(read_io)
    except Exception:  # noqa: BLE001 — absent or unreadable: not trusted
        return None
    return await asyncio.get_running_loop().run_in_executor(executor, integrity.digest, read_io.buf)


class CASReaderPlugin(StoragePlugin):
    """Resolves chunk locations against the root; every other path goes to
    the snapshot's own plugin.  Installed whenever a manifest references
    chunks, whatever the knobs say."""

    def __init__(self, inner: StoragePlugin, root: StoragePlugin) -> None:
        self._inner = inner
        self._root = root
        self.supports_scatter = getattr(inner, "supports_scatter", False)

    def _get_executor(self):
        getter = getattr(self._inner, "_get_executor", None)
        return getter() if getter is not None else None

    async def read(self, read_io: ReadIO) -> None:
        if is_chunk_location(read_io.path):
            await _read_via_root(self._root, read_io)
        else:
            await self._inner.read(read_io)

    async def write(self, write_io: WriteIO) -> None:
        await self._inner.write(write_io)

    async def exists(self, path: str) -> bool:
        return await self._inner.exists(path)

    async def list_dir(self, path: str) -> List[str]:
        return await self._inner.list_dir(path)

    async def delete(self, path: str) -> None:
        await self._inner.delete(path)

    async def delete_dir(self, path: str) -> None:
        await self._inner.delete_dir(path)

    async def copy_from_sibling(self, src_root: str, path: str) -> bool:
        return await self._inner.copy_from_sibling(src_root, path)

    async def close(self) -> None:
        try:
            await self._inner.close()
        finally:
            await self._root.close()


# ------------------------------------------------------------------ writes


class CASWriterPlugin(StoragePlugin):
    """Diverts payload writes into the root's chunk store.

    For each payload: hash the staged bytes, then reference the chunk when
    the index holds it (no bytes written), adopt a content-verified chunk
    that exists unindexed, or write the chunk durably under its digest.
    The ``path → cas://`` map (``relocations``) is applied to the manifest
    after the pipeline drains (:func:`apply_relocations`).  Dot-prefixed
    protocol files (the commit marker, rank sidecars) pass through to the
    step's plugin, so commit semantics are unchanged."""

    # Slabs are joined before hashing: one digest names the whole slab.
    supports_scatter = False

    def __init__(
        self, inner: StoragePlugin, root: StoragePlugin, index: DigestIndex, algo: str
    ) -> None:
        self._inner = inner
        self._root = root
        self._index = index
        self._algo = algo
        self._lock = threading.Lock()
        self.relocations: Dict[str, str] = {}
        self.dedup_hits = 0
        self.bytes_saved = 0
        self.chunks_written = 0
        self.bytes_written = 0
        self.adopted_chunks = 0
        self.adopted_bytes = 0
        self.prestage_probed = 0
        self.prestage_hits = 0
        self.prestage_bytes = 0
        self._prestaged: Dict[str, Tuple[str, int]] = {}
        self.cdc_payloads = 0
        self.cdc_chunks = 0
        self.cdc_dedup_hits = 0
        self.cdc_bytes_saved = 0
        self._closed = False

    def _get_executor(self):
        getter = getattr(self._inner, "_get_executor", None)
        return getter() if getter is not None else None

    @staticmethod
    def _is_payload_path(path: str) -> bool:
        name = path.rsplit("/", 1)[-1]
        return not (path.startswith(".") or name.startswith(".") or path.startswith("telemetry/"))

    def note_prestaged(self, path: str, digest: str, nbytes: int) -> None:
        """The digest the prestage pass computed for a changed leaf, reused
        by its write so it hashes once."""
        with self._lock:
            self._prestaged[path] = (digest, nbytes)

    def record_prestage_hit(self, nbytes: int) -> None:
        with self._lock:
            self.prestage_hits += 1
            self.prestage_bytes += nbytes
            self.dedup_hits += 1
            self.bytes_saved += nbytes

    async def write(self, write_io: WriteIO) -> None:
        if not self._is_payload_path(write_io.path):
            await self._inner.write(write_io)
            return
        from . import chunker, integrity
        from .compression import MAGIC as FRAME_MAGIC

        buf = write_io.buf
        with self._lock:
            prestaged = self._prestaged.pop(write_io.path, None)

        def _hash() -> str:
            nonlocal buf
            buf = contiguous(buf)
            if prestaged is not None and prestaged[1] == memoryview(buf).nbytes:
                return prestaged[0]
            return integrity.digest(buf)

        executor = self._get_executor()
        digest = await asyncio.get_running_loop().run_in_executor(executor, _hash)
        view = memoryview(buf).cast("B")
        nbytes = view.nbytes
        # Content-defined sub-chunks for payloads above one max-size chunk;
        # compression frames are exempt (their bytes mix under the codec).
        if chunker.should_split(nbytes) and bytes(view[:4]) != FRAME_MAGIC:
            location = await self._write_cdc(view, executor)
        else:
            # The digest's own tag ("xxh64" or the striped "xxh64s") names
            # the chunk's namespace: a chunk's name always matches its bytes.
            algo, _, hexdigest = digest.partition(":")
            await self._store_chunk(view, algo, hexdigest, digest, nbytes, executor)
            location = location_for(algo, hexdigest)
        with self._lock:
            self.relocations[write_io.path] = location
        self._index.record_payload(digest, location, None)

    async def _write_cdc(self, view: memoryview, executor) -> str:
        """Store ``view`` as the chunks between its content-defined edges;
        returns the ``casx://`` (or collapsed ``cas://``) location."""
        from . import chunker, integrity, phase_stats

        loop = asyncio.get_running_loop()
        with phase_stats.timed("cdc_chunk", view.nbytes):
            ends = await loop.run_in_executor(executor, chunker.boundaries, view)
        parts = chunker.split(view, ends)
        digests = await asyncio.gather(
            *(loop.run_in_executor(executor, integrity.digest, p) for p in parts)
        )
        # Bounded concurrency: one payload must not take every storage slot.
        sem = asyncio.Semaphore(4)

        async def _store_one(part: memoryview, digest: str) -> Tuple[str, str, int]:
            algo, _, hexdigest = digest.partition(":")
            async with sem:
                await self._store_chunk(part, algo, hexdigest, digest, part.nbytes, executor, cdc=True)
            return algo, hexdigest, part.nbytes

        tasks = [asyncio.ensure_future(_store_one(p, d)) for p, d in zip(parts, digests)]
        try:
            spec = list(await asyncio.gather(*tasks))
        except BaseException:
            for t in tasks:
                if not t.done():
                    t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            raise
        with self._lock:
            self.cdc_payloads += 1
            self.cdc_chunks += len(parts)
        return casx_location_for(spec)

    async def _store_chunk(
        self,
        view: memoryview,
        algo: str,
        hexdigest: str,
        digest: str,
        nbytes: int,
        executor,
        cdc: bool = False,
    ) -> None:
        """Index hit (pure reference) → content-verified adoption of an
        unindexed chunk → durable write, deleting debris on failure."""
        key = _digest_key(algo, hexdigest)
        relpath = chunk_relpath(algo, hexdigest)
        if key in self._index:
            self._count_dedup(nbytes, cdc)
            return
        if await self._probe_existing(relpath, digest, executor):
            self._index.add(key)
            with self._lock:
                self.adopted_chunks += 1
                self.adopted_bytes += nbytes
            self._count_dedup(nbytes, cdc)
            return
        try:
            await self._root.write(WriteIO(path=relpath, buf=view, durable=True))
        except BaseException:
            # Remove torn debris, but never a chunk whose bytes match its
            # name (a concurrent writer's valid chunk).
            try:
                actual = await _read_chunk_digest(self._root, relpath, executor)
                if actual is not None and actual != digest:
                    await self._root.delete(relpath)
            except Exception:  # noqa: BLE001 — the write's error is what raises
                pass
            raise
        self._index.add(key)
        with self._lock:
            self.chunks_written += 1
            self.bytes_written += nbytes

    def _count_dedup(self, nbytes: int, cdc: bool) -> None:
        with self._lock:
            self.dedup_hits += 1
            self.bytes_saved += nbytes
            if cdc:
                self.cdc_dedup_hits += 1
                self.cdc_bytes_saved += nbytes

    async def _probe_existing(self, relpath: str, digest: str, executor) -> bool:
        """Whether an unindexed chunk already holds the right bytes."""
        try:
            if not await self._root.exists(relpath):
                return False
        except Exception:  # noqa: BLE001 — unknown: write it
            return False
        actual = await _read_chunk_digest(self._root, relpath, executor)
        if actual is not None and actual != digest:
            logger.warning(
                "CAS chunk %s exists with mismatched content (%s != %s); rewriting",
                relpath,
                actual,
                digest,
            )
        return actual == digest

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "dedup_hits": self.dedup_hits,
                "dedup_bytes_saved": self.bytes_saved,
                "chunks_written": self.chunks_written,
                "physical_bytes_written": self.bytes_written,
                "logical_bytes": self.bytes_written + self.bytes_saved,
                "adopted_chunks": self.adopted_chunks,
                "adopted_bytes": self.adopted_bytes,
                "prestage_probed": self.prestage_probed,
                "prestage_hits": self.prestage_hits,
                "prestage_bytes": self.prestage_bytes,
                "cdc_payloads": self.cdc_payloads,
                "cdc_chunks": self.cdc_chunks,
                "cdc_dedup_hits": self.cdc_dedup_hits,
                "cdc_bytes_saved": self.cdc_bytes_saved,
            }

    async def read(self, read_io: ReadIO) -> None:
        await self._inner.read(read_io)

    async def exists(self, path: str) -> bool:
        return await self._inner.exists(path)

    async def list_dir(self, path: str) -> List[str]:
        return await self._inner.list_dir(path)

    async def delete(self, path: str) -> None:
        await self._inner.delete(path)

    async def delete_dir(self, path: str) -> None:
        await self._inner.delete_dir(path)

    async def copy_from_sibling(self, src_root: str, path: str) -> bool:
        return await self._inner.copy_from_sibling(src_root, path)

    async def close(self) -> None:
        self._emit_summary()
        try:
            await self._inner.close()
        finally:
            await self._root.close()

    def _emit_summary(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        stats = self.stats()
        if not (stats["dedup_hits"] or stats["chunks_written"]):
            return
        from .event import Event
        from .event_handlers import log_event

        log_event(Event(name="cas.dedup", metadata=stats))
        logger.info(
            "CAS: %d payloads deduplicated (%.1f MB saved, %d prestage-skipped), "
            "%d new chunks (%.1f MB written)",
            stats["dedup_hits"],
            stats["dedup_bytes_saved"] / 1e6,
            stats["prestage_hits"],
            stats["chunks_written"],
            stats["physical_bytes_written"] / 1e6,
        )


# ------------------------------------------------------------------ wiring


def maybe_wrap_cas_writes(
    storage: StoragePlugin,
    path: str,
    storage_options: Optional[Dict[str, Any]] = None,
    index: Optional[DigestIndex] = None,
) -> StoragePlugin:
    """Wrap a take's storage for content-addressed writes when
    ``TPUSNAP_CAS`` is on and the snapshot has a parent directory for the
    store; otherwise return ``storage``.  ``index``: a caller-maintained
    :class:`DigestIndex` (skips seeding)."""
    from . import knobs
    from .storage_plugin import url_to_storage_plugin

    if not knobs.cas_enabled():
        return storage
    if knobs.get_store_url() is not None:
        raise NotImplementedError(
            "TPUSNAP_STORE is set: the shared chunk store (store.py) is not "
            "ported to torchsnapshot_tpu_torch yet; unset TPUSNAP_STORE to "
            "keep chunks under the snapshot's root, or take with "
            "torchsnapshot_tpu"
        )
    algo = knobs.get_cas_algo()
    root_url = parent_root_url(path)
    if root_url is None:
        logger.warning(
            "TPUSNAP_CAS ignored for %s: the snapshot path has no parent "
            "directory to hold the cas/ store",
            path,
        )
        return storage
    root = url_to_storage_plugin(root_url, storage_options)
    if index is None:
        index = load_or_seed_index(root_url, root, algo)
    logger.debug("CAS writes for %s (root %s, %d indexed chunks)", path, root_url, len(index))
    return CASWriterPlugin(inner=storage, root=root, index=index, algo=algo)


def maybe_wrap_cas_reads(
    storage: StoragePlugin,
    snapshot_path: str,
    metadata: Any,
    storage_options: Optional[Dict[str, Any]] = None,
) -> StoragePlugin:
    """Wrap a snapshot's storage so chunk locations resolve, when its
    manifest references any."""
    if not manifest_uses_cas(metadata.manifest):
        return storage
    from . import knobs
    from .storage_plugin import url_to_storage_plugin

    if knobs.get_store_url() is not None:
        raise NotImplementedError(
            "TPUSNAP_STORE is set: the shared chunk store (store.py) is not "
            "ported to torchsnapshot_tpu_torch yet; unset it to read chunks "
            "from the snapshot's root"
        )
    root_url = parent_root_url(snapshot_path)
    if root_url is None:
        raise RuntimeError(
            f"{snapshot_path} references content-addressed chunks but has no "
            "parent directory to resolve the cas/ store from"
        )
    return CASReaderPlugin(inner=storage, root=url_to_storage_plugin(root_url, storage_options))


def find_writer(storage: Optional[StoragePlugin]) -> Optional[CASWriterPlugin]:
    """The :class:`CASWriterPlugin` in a (possibly wrapped) storage stack."""
    for _ in range(8):
        if storage is None:
            return None
        if isinstance(storage, CASWriterPlugin):
            return storage
        storage = getattr(storage, "_inner", None)
    return None


def apply_relocations(storage: StoragePlugin, entries: Dict[str, Any]) -> None:
    """Point the entries whose payloads went into the chunk store at their
    chunks, after the write pipeline drained and before the manifest is
    gathered; and record every entry's digest (slab members included) in
    the index's payload map.  No-op without a CAS writer."""
    writer = find_writer(storage)
    if writer is None:
        return
    from .manifest import iter_payload_entries

    with writer._lock:
        relocations = dict(writer.relocations)
    for _, entry in iter_payload_entries(entries):
        new_location = relocations.get(entry.location)
        if new_location is not None:
            entry.location = new_location
        if entry.checksum and is_chunk_location(entry.location):
            writer._index.record_payload(
                entry.checksum, entry.location, getattr(entry, "byte_range", None)
            )


def writer_stats(storage: StoragePlugin) -> Optional[Dict[str, int]]:
    writer = find_writer(storage)
    return writer.stats() if writer is not None else None


# ------------------------------------------------- streaming delta detection


def _is_device_leaf(obj: Any) -> bool:
    """A CUDA tensor, or a DTensor whose local tensor is on CUDA."""
    from . import staging

    if staging.is_dtensor(obj):
        return obj.to_local().is_cuda
    return staging.is_cuda_tensor(obj)


def prestage_delta_skip(
    storage: StoragePlugin, entries: Dict[str, Any], write_reqs: List[Any]
) -> Tuple[List[Any], Optional[Dict[str, int]]]:
    """Resolve unchanged leaves to references before batching, compression
    and the write pipeline.

    Each raw tensor request is staged (CUDA: one D2H), hashed, and looked
    up in the index's payload map; a hit points the entry at the committed
    location (and range) and drops the request, so the leaf costs one
    hash and no pipeline work.  A miss leaves its digest with the writer,
    so the changed leaf hashes once.  CUDA leaves are probed one at a time,
    each into a pinned buffer from the caching host allocator (the same
    block comes back for the next probe) that is outside the scheduler's
    budget, so the bound is one leaf; the copy waits on the caller's
    stream, and its bytes count in the ``d2h`` phase.  A changed CUDA leaf
    pays its D2H twice (probe, then stage).  CPU leaves are views, hashed
    on a thread pool.

    Returns ``(remaining_write_reqs, {"probed", "hits", "hit_bytes"})``, or
    the requests unchanged and None when there is no CAS writer or the
    index has no payload map yet (a first take into an empty root)."""
    writer = find_writer(storage)
    if writer is None:
        return write_reqs, None
    index = writer._index
    if index.payload_count() == 0:
        return write_reqs, None

    from concurrent.futures import ThreadPoolExecutor

    from . import integrity, phase_stats, serialization, staging
    from .batcher import _index_tensor_entries
    from .compression import is_framed
    from .io_preparers.array import ArrayBufferStager
    from .serialization import Serializer

    entry_index = _index_tensor_entries(entries)

    def _qualifies(wr) -> Optional[Any]:
        stager = wr.buffer_stager
        if not isinstance(stager, ArrayBufferStager):
            return None
        entry = entry_index.get(wr.path)
        if (
            entry is None
            or entry.serializer != Serializer.BUFFER_PROTOCOL.value
            or is_framed(entry)
            or entry.byte_range is not None
            or stager.source is None
        ):
            return None
        return entry

    def _probe_host(wr) -> Optional[Tuple[Any, str, int]]:
        entry = _qualifies(wr)
        if entry is None:
            return None
        mv = serialization.array_as_memoryview(serialization.host_bytes(wr.buffer_stager.source))
        return entry, integrity.digest(mv), mv.nbytes

    def _probe_device(wr) -> Optional[Tuple[Any, str, int]]:
        entry = _qualifies(wr)
        if entry is None:
            return None
        obj = wr.buffer_stager.source
        if staging.is_dtensor(obj):
            obj = obj.to_local()
        host = staging.finish_d2h(staging.begin_d2h(obj))
        mv = serialization.array_as_memoryview(host)
        digest = integrity.digest(mv)
        return entry, digest, mv.nbytes

    device_ids = {
        id(wr) for wr in write_reqs if _is_device_leaf(getattr(wr.buffer_stager, "source", None))
    }
    results: Dict[int, Any] = {}
    with phase_stats.timed("prestage_delta"):
        host_reqs = [wr for wr in write_reqs if id(wr) not in device_ids]
        with ThreadPoolExecutor(max_workers=4, thread_name_prefix="snap_prestage") as pool:
            for wr, res in zip(host_reqs, pool.map(_probe_host, host_reqs)):
                results[id(wr)] = res
        for wr in write_reqs:
            if id(wr) in device_ids:
                results[id(wr)] = _probe_device(wr)

    kept: List[Any] = []
    probed = hits = hit_bytes = 0
    record_checksums = integrity.save_checksums_enabled()
    # In request order, so the slab grouping downstream stays deterministic.
    for wr in write_reqs:
        res = results[id(wr)]
        if res is None:
            kept.append(wr)
            continue
        entry, digest, nbytes = res
        probed += 1
        hit = index.lookup_payload(digest)
        if hit is None:
            writer.note_prestaged(wr.path, digest, nbytes)
            kept.append(wr)
            continue
        location, byte_range = hit
        entry.location = location
        entry.byte_range = list(byte_range) if byte_range is not None else None
        if record_checksums:
            entry.checksum = digest
        writer.record_prestage_hit(nbytes)
        hits += 1
        hit_bytes += nbytes
    with writer._lock:
        writer.prestage_probed += probed
    return kept, {"probed": probed, "hits": hits, "hit_bytes": hit_bytes}
