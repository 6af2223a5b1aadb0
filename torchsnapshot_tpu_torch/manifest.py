"""Snapshot manifest: typed entry schema + metadata (de)serialization.

A copy of ``torchsnapshot_tpu/manifest.py``: both packages write and read
the same JSON ``.snapshot_metadata``, entry for entry, at every version
either writes: 0.1.0, compression frames 0.2.0, content addressing 0.4.0,
journal delta segments 0.5.0 and content-defined chunking 0.6.0.  A later
version is refused (:class:`UnsupportedSnapshotError`).  A 0.5.0 segment
is read by the journal and the manager; ``Snapshot.restore`` refuses one
outside the manager's replay, as the JAX package does.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import struct
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union


@dataclass
class Entry:
    """Base of the tagged union; ``type`` discriminates on (de)serialization."""

    type: str


@dataclass
class TensorEntry(Entry):
    """A single unsharded array stored contiguously at ``location``.

    Mirrors reference TensorEntry (manifest.py:50-94). ``serializer`` is
    ``buffer_protocol`` (zero-copy raw bytes) or ``pickle`` (fallback).
    ``byte_range`` is [start, end) within the file at ``location`` when the
    entry was batched into a slab; None means the whole file.

    ``codec`` (compression.py): None = legacy bare bytes (the
    pre-compression format — old manifests without the field load
    unchanged); a name (``"zstd"``/``"lz4"``/``"zlib"``/``"raw"``) = the
    payload is a self-describing compression frame whose header carries
    the codec actually used.  ``compressed_nbytes`` records the stored
    frame size (the uncompressed size is already implied by dtype×shape);
    checksums cover the frame — exactly the bytes on disk.
    """

    location: str
    serializer: str
    dtype: str
    shape: List[int]
    replicated: bool
    byte_range: Optional[List[int]] = None
    checksum: Optional[str] = None  # "xxh64:<hex>" of the payload bytes
    codec: Optional[str] = None
    compressed_nbytes: Optional[int] = None

    def __init__(
        self,
        location: str,
        serializer: str,
        dtype: str,
        shape: List[int],
        replicated: bool,
        byte_range: Optional[List[int]] = None,
        checksum: Optional[str] = None,
        codec: Optional[str] = None,
        compressed_nbytes: Optional[int] = None,
    ) -> None:
        super().__init__(type="Tensor")
        self.location = location
        self.serializer = serializer
        self.dtype = dtype
        self.shape = shape
        self.replicated = replicated
        self.byte_range = byte_range
        self.checksum = checksum
        self.codec = codec
        self.compressed_nbytes = compressed_nbytes


@dataclass
class Shard:
    """One saved shard of a sharded array (reference manifest.py:96-116)."""

    offsets: List[int]
    sizes: List[int]
    tensor: TensorEntry

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Shard":
        return cls(
            offsets=list(d["offsets"]),
            sizes=list(d["sizes"]),
            tensor=_entry_from_dict(d["tensor"]),
        )

    def to_dict(self) -> Dict[str, Any]:
        return {
            "offsets": self.offsets,
            "sizes": self.sizes,
            "tensor": _entry_to_dict(self.tensor),
        }


@dataclass
class ShardedArrayEntry(Entry):
    """A GSPMD-sharded array; unifies ShardedTensorEntry + DTensorEntry.

    ``shards`` carry everything restore needs (overlap-region planning reads
    only offsets/sizes/tensor).  ``mesh_shape``/``axis_names``/``partition_spec``
    record the logical jax sharding at save time; ``partition_spec`` is a list
    (one element per array dim) of lists of mesh-axis names the dim is sharded
    over ([] = replicated on that dim) — the JAX-native equivalent of the
    reference's dim_map (manifest.py:222-241).
    """

    dtype: str
    shape: List[int]
    shards: List[Shard]
    mesh_shape: Optional[List[int]] = None
    axis_names: Optional[List[str]] = None
    partition_spec: Optional[List[List[str]]] = None

    def __init__(
        self,
        dtype: str,
        shape: List[int],
        shards: List[Shard],
        mesh_shape: Optional[List[int]] = None,
        axis_names: Optional[List[str]] = None,
        partition_spec: Optional[List[List[str]]] = None,
    ) -> None:
        super().__init__(type="ShardedArray")
        self.dtype = dtype
        self.shape = shape
        self.shards = shards
        self.mesh_shape = mesh_shape
        self.axis_names = axis_names
        self.partition_spec = partition_spec


@dataclass
class Chunk:
    """Chunking instruction: one dim-0 slice of a large array (reference
    manifest.py:160-169).  Not serialized itself — ChunkedTensorEntry stores
    self-contained :class:`Shard` records per chunk."""

    offsets: List[int]
    sizes: List[int]
    dtype: str

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Chunk":
        return cls(offsets=list(d["offsets"]), sizes=list(d["sizes"]), dtype=d["dtype"])

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclass
class ChunkedTensorEntry(Entry):
    """A large array split into dim-0 chunks, each carried as a Shard with an
    embedded TensorEntry (reference manifest.py:171-209)."""

    dtype: str
    shape: List[int]
    chunks: List[Shard]
    replicated: bool

    def __init__(
        self, dtype: str, shape: List[int], chunks: List[Shard], replicated: bool
    ) -> None:
        super().__init__(type="ChunkedTensor")
        self.dtype = dtype
        self.shape = shape
        self.chunks = chunks
        self.replicated = replicated


@dataclass
class ObjectEntry(Entry):
    """Pickled opaque object (reference manifest.py:264-289)."""

    location: str
    serializer: str
    obj_type: str
    replicated: bool
    checksum: Optional[str] = None

    def __init__(
        self,
        location: str,
        serializer: str,
        obj_type: str,
        replicated: bool,
        checksum: Optional[str] = None,
    ) -> None:
        super().__init__(type="object")
        self.location = location
        self.serializer = serializer
        self.obj_type = obj_type
        self.replicated = replicated
        self.checksum = checksum


@dataclass
class ListEntry(Entry):
    def __init__(self) -> None:
        super().__init__(type="list")


@dataclass
class TupleEntry(Entry):
    """JAX addition: tuples are common pytree containers (no reference
    analogue; the reference only handles dict/list/OrderedDict)."""

    def __init__(self) -> None:
        super().__init__(type="tuple")


@dataclass
class NamedTupleEntry(Entry):
    """JAX addition: optax optimizer states are NamedTuples (ScaleByAdamState
    etc.) — they must flatten as containers, not opaque pickles, so their
    array fields go through the sharded-array machinery.  ``cls`` records
    ``module:qualname`` for exact reconstruction; inflate degrades to a
    same-shaped anonymous namedtuple if the class cannot be imported."""

    keys: List[str]
    cls: str

    def __init__(self, keys: List[str], cls: str) -> None:
        super().__init__(type="namedtuple")
        self.keys = keys
        self.cls = cls


@dataclass
class DictEntry(Entry):
    keys: List[Union[str, int]]

    def __init__(self, keys: List[Union[str, int]]) -> None:
        super().__init__(type="dict")
        self.keys = keys


@dataclass
class OrderedDictEntry(Entry):
    keys: List[Union[str, int]]

    def __init__(self, keys: List[Union[str, int]]) -> None:
        super().__init__(type="OrderedDict")
        self.keys = keys


@dataclass
class PrimitiveEntry(Entry):
    """Primitive value inlined into metadata — no storage I/O on read
    (reference manifest.py:335-423).  Floats keep an exact binary form
    (base64 of C-double, little-endian) alongside the readable repr, mirroring
    reference manifest.py:383-407."""

    entry_type: str  # int | float | str | bool | bytes
    readable: str
    serialized: Optional[str] = None  # exact form for float/bytes
    replicated: bool = False

    def __init__(
        self,
        entry_type: str,
        readable: str,
        serialized: Optional[str] = None,
        replicated: bool = False,
    ) -> None:
        super().__init__(type="primitive")
        self.entry_type = entry_type
        self.readable = readable
        self.serialized = serialized
        self.replicated = replicated

    @classmethod
    def from_object(cls, obj: Any, replicated: bool = False) -> "PrimitiveEntry":
        if isinstance(obj, bool):
            return cls("bool", str(obj), replicated=replicated)
        if isinstance(obj, int):
            return cls("int", str(obj), replicated=replicated)
        if isinstance(obj, float):
            packed = base64.b64encode(struct.pack("<d", obj)).decode("ascii")
            return cls("float", str(obj), serialized=packed, replicated=replicated)
        if isinstance(obj, str):
            return cls("str", obj, replicated=replicated)
        if isinstance(obj, bytes):
            return cls(
                "bytes",
                repr(obj),
                serialized=base64.b64encode(obj).decode("ascii"),
                replicated=replicated,
            )
        raise TypeError(f"Unsupported primitive type: {type(obj)}")

    @staticmethod
    def supports(obj: Any) -> bool:
        return isinstance(obj, (bool, int, float, str, bytes))

    def get_value(self) -> Any:
        if self.entry_type == "bool":
            return self.readable == "True"
        if self.entry_type == "int":
            return int(self.readable)
        if self.entry_type == "float":
            if self.serialized is not None:
                return struct.unpack("<d", base64.b64decode(self.serialized))[0]
            return float(self.readable)
        if self.entry_type == "str":
            return self.readable
        if self.entry_type == "bytes":
            assert self.serialized is not None
            return base64.b64decode(self.serialized)
        raise ValueError(f"Unknown primitive entry_type: {self.entry_type}")


Manifest = Dict[str, Entry]

_ENTRY_TYPE_TO_CLS: Dict[str, type] = {
    "Tensor": TensorEntry,
    "ShardedArray": ShardedArrayEntry,
    "ChunkedTensor": ChunkedTensorEntry,
    "object": ObjectEntry,
    "list": ListEntry,
    "tuple": TupleEntry,
    "namedtuple": NamedTupleEntry,
    "dict": DictEntry,
    "OrderedDict": OrderedDictEntry,
    "primitive": PrimitiveEntry,
}


def _entry_to_dict(entry: Entry) -> Dict[str, Any]:
    d: Dict[str, Any] = {"type": entry.type}
    if isinstance(entry, TensorEntry):
        d.update(
            location=entry.location,
            serializer=entry.serializer,
            dtype=entry.dtype,
            shape=entry.shape,
            replicated=entry.replicated,
        )
        if entry.byte_range is not None:
            d["byte_range"] = entry.byte_range
        if entry.checksum is not None:
            d["checksum"] = entry.checksum
        # Emitted only when set: snapshots without compression serialize
        # byte-identically to the pre-codec format.
        if entry.codec is not None:
            d["codec"] = entry.codec
        if entry.compressed_nbytes is not None:
            d["compressed_nbytes"] = entry.compressed_nbytes
    elif isinstance(entry, ShardedArrayEntry):
        d.update(
            dtype=entry.dtype,
            shape=entry.shape,
            shards=[s.to_dict() for s in entry.shards],
        )
        if entry.mesh_shape is not None:
            d["mesh_shape"] = entry.mesh_shape
        if entry.axis_names is not None:
            d["axis_names"] = entry.axis_names
        if entry.partition_spec is not None:
            d["partition_spec"] = entry.partition_spec
    elif isinstance(entry, ChunkedTensorEntry):
        d.update(
            dtype=entry.dtype,
            shape=entry.shape,
            chunks=[s.to_dict() for s in entry.chunks],
            replicated=entry.replicated,
        )
    elif isinstance(entry, ObjectEntry):
        d.update(
            location=entry.location,
            serializer=entry.serializer,
            obj_type=entry.obj_type,
            replicated=entry.replicated,
        )
        if entry.checksum is not None:
            d["checksum"] = entry.checksum
    elif isinstance(entry, (DictEntry, OrderedDictEntry)):
        d["keys"] = entry.keys
    elif isinstance(entry, NamedTupleEntry):
        d["keys"] = entry.keys
        d["cls"] = entry.cls
    elif isinstance(entry, PrimitiveEntry):
        d.update(
            entry_type=entry.entry_type,
            readable=entry.readable,
            replicated=entry.replicated,
        )
        if entry.serialized is not None:
            d["serialized"] = entry.serialized
    elif isinstance(entry, (ListEntry, TupleEntry)):
        pass
    else:  # pragma: no cover
        raise TypeError(f"Unknown entry type: {entry}")
    return d


def _entry_from_dict(d: Dict[str, Any]) -> Any:
    typ = d["type"]
    if typ == "Tensor":
        return TensorEntry(
            location=d["location"],
            serializer=d["serializer"],
            dtype=d["dtype"],
            shape=list(d["shape"]),
            replicated=bool(d["replicated"]),
            byte_range=list(d["byte_range"]) if d.get("byte_range") else None,
            checksum=d.get("checksum"),
            # Absent in pre-compression manifests: None means bare bytes.
            codec=d.get("codec"),
            compressed_nbytes=d.get("compressed_nbytes"),
        )
    if typ == "ShardedArray":
        return ShardedArrayEntry(
            dtype=d["dtype"],
            shape=list(d["shape"]),
            shards=[Shard.from_dict(s) for s in d["shards"]],
            mesh_shape=list(d["mesh_shape"]) if d.get("mesh_shape") else None,
            axis_names=list(d["axis_names"]) if d.get("axis_names") else None,
            partition_spec=(
                [list(p) for p in d["partition_spec"]]
                if d.get("partition_spec") is not None
                else None
            ),
        )
    if typ == "ChunkedTensor":
        return ChunkedTensorEntry(
            dtype=d["dtype"],
            shape=list(d["shape"]),
            chunks=[Shard.from_dict(c) for c in d["chunks"]],
            replicated=bool(d["replicated"]),
        )
    if typ == "object":
        return ObjectEntry(
            location=d["location"],
            serializer=d["serializer"],
            obj_type=d["obj_type"],
            replicated=bool(d["replicated"]),
            checksum=d.get("checksum"),
        )
    if typ == "list":
        return ListEntry()
    if typ == "tuple":
        return TupleEntry()
    if typ == "namedtuple":
        return NamedTupleEntry(keys=list(d["keys"]), cls=d["cls"])
    if typ == "dict":
        return DictEntry(keys=list(d["keys"]))
    if typ == "OrderedDict":
        return OrderedDictEntry(keys=list(d["keys"]))
    if typ == "primitive":
        return PrimitiveEntry(
            entry_type=d["entry_type"],
            readable=d["readable"],
            serialized=d.get("serialized"),
            replicated=bool(d.get("replicated", False)),
        )
    raise ValueError(f"Unknown manifest entry type: {typ}")


MANIFEST_VERSION = "0.1.0"
# Snapshots containing framed (compressed) payloads declare 0.2.0: a reader
# that predates the codec subsystem would interpret the stored frame bytes as
# the array payload — for the raw-in-frame incompressible fallback that is
# silent corruption shifted by the 16-byte header.  Readers that already
# shipped can't be retrofitted, but from 0.2.0 on ``from_json`` validates the
# version, so every FUTURE format change fails old readers with a clear
# "upgrade to restore" error instead.  Uncompressed snapshots keep declaring
# 0.1.0 — their on-disk format is byte-identical to the pre-codec one.
FRAMED_MANIFEST_VERSION = "0.2.0"
# Snapshots whose entries reference content-addressed chunks (``cas://``
# locations resolved under the root's shared ``cas/`` store, cas.py) declare
# 0.4.0: a pre-CAS reader would treat the reference as a step-relative file
# path and fail with a misleading not-found.  0.1–0.3 readers reject it
# cleanly via the from_json version validation below.  (0.3.0 was reserved
# by an earlier roadmap draft of this feature and never shipped.)
CAS_MANIFEST_VERSION = "0.4.0"
# Journal delta segments (journal.py) declare 0.5.0: their manifest is a
# DELTA — only the entries whose content changed since the chain recorded in
# the ``journal`` metadata block — so a pre-journal reader that restored one
# directly would silently produce partial state.  0.1–0.4 readers reject it
# cleanly via the from_json version validation; journal-aware readers refuse
# to restore a delta outside the replay path (Snapshot.restore guards on
# ``metadata.journal``).
JOURNAL_MANIFEST_VERSION = "0.5.0"
# Snapshots whose entries reference content-defined SUB-chunks
# (``casx://<algo>/<hex>@<n>+...`` locations, cas.py) declare 0.6.0: the
# payload bytes are the concatenation of several CAS chunks split on
# FastCDC edges, which a 0.4/0.5 reader would treat as one malformed
# ``cas://`` reference and fail confusingly.  0.1–0.5 readers reject 0.6.0
# cleanly via the from_json version validation below.
CDC_MANIFEST_VERSION = "0.6.0"
SUPPORTED_MANIFEST_VERSIONS = (
    MANIFEST_VERSION,
    FRAMED_MANIFEST_VERSION,
    CAS_MANIFEST_VERSION,
    JOURNAL_MANIFEST_VERSION,
    CDC_MANIFEST_VERSION,
)


class UnsupportedSnapshotError(ValueError):
    """The snapshot declares a manifest version newer than this reader."""


def iter_payload_entries(manifest: "Manifest"):
    """Yield ``(manifest_key, leaf_entry)`` for every payload-carrying entry
    — ``TensorEntry``/``ObjectEntry``, including the tensors nested inside
    sharded and chunked entries (their manifest key is the parent's).

    The ONE manifest walk shared by incremental dedup
    (``incremental.checksums_by_location``), integrity auditing
    (``integrity.payload_checksums``), and the CAS digest index (cas.py) —
    so the three can never disagree about what counts as a payload."""
    for key, entry in manifest.items():
        if isinstance(entry, (TensorEntry, ObjectEntry)):
            yield key, entry
        elif isinstance(entry, ShardedArrayEntry):
            for shard in entry.shards:
                yield key, shard.tensor
        elif isinstance(entry, ChunkedTensorEntry):
            for chunk in entry.chunks:
                yield key, chunk.tensor


def manifest_version_for(manifest: "Manifest") -> str:
    """The version a manifest must declare: ``CDC_MANIFEST_VERSION`` when
    any payload is a multi-chunk (content-defined sub-slab) reference,
    ``CAS_MANIFEST_VERSION`` when any payload is a whole-chunk digest
    reference into the content-addressed store, ``FRAMED_MANIFEST_VERSION``
    when any payload is frame-encoded, else the base ``MANIFEST_VERSION``."""
    from .cas import is_cas_location, is_casx_location
    from .compression import is_framed

    framed = False
    cas = False
    for _, entry in iter_payload_entries(manifest):
        if is_casx_location(entry.location):
            return CDC_MANIFEST_VERSION
        cas = cas or is_cas_location(entry.location)
        framed = framed or is_framed(entry)
    if cas:
        return CAS_MANIFEST_VERSION
    return FRAMED_MANIFEST_VERSION if framed else MANIFEST_VERSION


@dataclass
class SnapshotMetadata:
    """Top-level snapshot metadata (reference manifest.py:425-475).

    ``journal``: set only on journal delta segments (journal.py) — a dict
    recording the replay chain (``base_step``, ``prior_segments``), the
    paths ``deleted`` since the prior merged view, and delta size counters.
    ``None`` (the default, and the only value full snapshots carry) means
    the manifest is self-contained.
    """

    version: str
    world_size: int
    manifest: Manifest = field(default_factory=dict)
    journal: Optional[Dict[str, Any]] = None

    def to_json(self) -> str:
        doc: Dict[str, Any] = {
            "version": self.version,
            "world_size": self.world_size,
            "manifest": {
                path: _entry_to_dict(entry)
                for path, entry in self.manifest.items()
            },
        }
        # Emitted only when set: full snapshots serialize byte-identically
        # to the pre-journal format.
        if self.journal is not None:
            doc["journal"] = self.journal
        return json.dumps(doc, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "SnapshotMetadata":
        """Parse a ``.snapshot_metadata`` document, journal delta segments
        (0.5.0) included."""
        d = json.loads(s)
        version = d["version"]
        if version not in SUPPORTED_MANIFEST_VERSIONS:
            raise UnsupportedSnapshotError(
                f"Snapshot manifest version {version!r} is newer than this "
                f"reader supports ({', '.join(SUPPORTED_MANIFEST_VERSIONS)})"
            )
        return cls(
            version=version,
            world_size=int(d["world_size"]),
            manifest={
                path: _entry_from_dict(ed) for path, ed in d["manifest"].items()
            },
            journal=d.get("journal"),
        )

    # Back-compat aliases matching the reference API names
    # (SnapshotMetadata.to_yaml/from_yaml, manifest.py:442-450); the payload
    # the reference writes is JSON anyway.
    def to_yaml(self) -> str:
        return self.to_json()

    @classmethod
    def from_yaml(cls, s: str) -> "SnapshotMetadata":
        return cls.from_json(s)
