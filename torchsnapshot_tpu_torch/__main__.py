"""Snapshot inspection CLI (counterpart of ``torchsnapshot_tpu/__main__.py``).

    python -m torchsnapshot_tpu_torch ls <snapshot-url> [--rank N]
    python -m torchsnapshot_tpu_torch cat <snapshot-url> <rank/logical/path> [--device D]
    python -m torchsnapshot_tpu_torch info <snapshot-url>
    python -m torchsnapshot_tpu_torch steps <manager-root-url>
    python -m torchsnapshot_tpu_torch gc <manager-root-url> [--apply [--force]]
    python -m torchsnapshot_tpu_torch verify <snapshot-url>
    python -m torchsnapshot_tpu_torch diff <snapshot-url-a> <snapshot-url-b>
    python -m torchsnapshot_tpu_torch cp <src-url> <dst-url> [--verify]
    python -m torchsnapshot_tpu_torch stats <snapshot-url> [--json] [--metrics]
    python -m torchsnapshot_tpu_torch trace <trace-dir> [--out merged.json] [--fleet [--spool DIR]]
    python -m torchsnapshot_tpu_torch analyze <trace-dir> [--snapshot URL] [--json]
    python -m torchsnapshot_tpu_torch analyze <trace-dir> --profile [--json]
    python -m torchsnapshot_tpu_torch analyze <trace-dir> --peer [--json]
    python -m torchsnapshot_tpu_torch analyze <snapshot-url> --barrier [--json]
    python -m torchsnapshot_tpu_torch profile diff <a> <b> [--top N] [--json]
    python -m torchsnapshot_tpu_torch history <manager-root-url> [--json]
    python -m torchsnapshot_tpu_torch postmortem <manager-root-url> [--json | --perfetto]
    python -m torchsnapshot_tpu_torch top [spool-or-root] [--json | --prometheus | --once]

Each command prints what the JAX package's command of that name prints over
the same snapshot or root, and returns the same exit code; the two packages
read and write one on-disk format, so either CLI reads either package's
snapshots, traces, profiles and fleet spools.  Read-only except ``cp``,
``gc --apply`` and ``top``'s table, which sweeps stale spool entries
(``--json`` and ``--prometheus`` are pure reads); works against any storage
backend URL.

``cat`` is the one command that touches the device: like
``Snapshot.read_object`` it places a tensor on ``--device`` (default
``cuda``), and without a GPU it fails unless given ``--device cpu``.  It
prints through numpy where the tensor's dtype has a numpy counterpart, and
through torch, with the same threshold and edge items, where it has none
(``bfloat16``, the float8 types).

The JAX package's ``lint``, ``repack``, ``warm``, ``serve`` and ``rollout``
have no counterpart here yet.
"""

from __future__ import annotations

import argparse
import sys

from .store import _resolve_store_url

_PRINT_THRESHOLD = 64
_PRINT_EDGEITEMS = 4


def _human(n: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if n < 1024:
            return f"{n:.1f}{unit}"
        n /= 1024
    return f"{n:.1f}PB"


def _shards(entry):
    """Shard or chunk records of a sharded or chunked entry, else None."""
    from .manifest import ChunkedTensorEntry, ShardedArrayEntry

    if isinstance(entry, ShardedArrayEntry):
        return entry.shards
    if isinstance(entry, ChunkedTensorEntry):
        return entry.chunks
    return None


def _entry_size(entry) -> int:
    from . import serialization
    from .manifest import TensorEntry

    if isinstance(entry, TensorEntry):
        try:
            return serialization.array_nbytes(entry.shape, entry.dtype)
        except ValueError:
            return 0
    shards = _shards(entry)
    if shards is not None:
        return sum(_entry_size(s.tensor) for s in shards)
    return 0


def _compression_stats(md) -> tuple:
    """``(logical_bytes, stored_bytes, {codec: payload_count})`` over every
    distinct array payload in a manifest.  ``stored`` uses the recorded
    frame size for compressed entries and the logical size otherwise, so
    ``logical / stored`` is the snapshot's effective compression ratio
    (manifests without codec fields report ratio 1.0)."""
    from .compression import is_framed
    from .manifest import TensorEntry

    seen = set()
    logical = stored = 0
    codecs: dict = {}

    def _add(t) -> None:
        nonlocal logical, stored
        key = (t.location, tuple(t.byte_range) if t.byte_range else None)
        if key in seen:
            return
        seen.add(key)
        nbytes = _entry_size(t)
        logical += nbytes
        if is_framed(t):
            codecs[t.codec] = codecs.get(t.codec, 0) + 1
            stored += t.compressed_nbytes if t.compressed_nbytes else nbytes
        else:
            stored += nbytes

    for entry in md.manifest.values():
        if isinstance(entry, TensorEntry):
            _add(entry)
        else:
            for shard in _shards(entry) or []:
                _add(shard.tensor)
    return logical, stored, codecs


def _compression_line(md) -> str:
    logical, stored, codecs = _compression_stats(md)
    if not codecs:
        return "compression: none"
    ratio = logical / stored if stored else 1.0
    by_codec = ", ".join(f"{c}×{n}" for c, n in sorted(codecs.items()))
    return f"compression: {by_codec}; stored {_human(stored)} of {_human(logical)} (ratio {ratio:.2f}x)"


def _cas_line(md) -> str:
    """Dedup summary for a CAS-mode manifest: unique chunks, physical vs
    logical bytes.  Physical size per chunk is the best manifest-derivable
    bound (max byte-range end or entry size over its referents)."""
    from . import cas
    from .manifest import iter_payload_entries

    chunk_bytes: dict = {}
    logical = 0
    seen = set()
    for _, entry in iter_payload_entries(md.manifest):
        if not cas.is_chunk_location(entry.location):
            continue
        byte_range = getattr(entry, "byte_range", None)
        key = (entry.location, tuple(byte_range) if byte_range else None)
        if key in seen:
            continue
        seen.add(key)
        nbytes = getattr(entry, "compressed_nbytes", None) or _entry_size(entry)
        logical += nbytes
        if cas.is_casx_location(entry.location):
            # A sub-chunked reference states its parts' sizes itself.
            for algo, hexdigest, part_nbytes in cas.parse_casx_location(entry.location):
                chunk_bytes[f"{algo}/{hexdigest}"] = part_nbytes
            continue
        end = byte_range[1] if byte_range else nbytes
        chunk_bytes[entry.location] = max(chunk_bytes.get(entry.location, 0), end)
    if not chunk_bytes:
        return ""
    physical = sum(chunk_bytes.values())
    if not physical:
        # Only object (pickle) chunks, whose sizes the manifest doesn't
        # record: a byte breakdown here would be a meaningless 0/0.
        return f"cas:         {len(chunk_bytes)} chunk(s) referenced"
    ratio = logical / physical
    return (
        f"cas:         {len(chunk_bytes)} chunk(s); this step references "
        f"{_human(physical)} physical for {_human(logical)} logical "
        f"(dedup {ratio:.2f}x within-step; cross-step sharing not counted)"
    )


def _journal_line(md) -> str:
    """Delta-segment summary for a journal manifest (version 0.5.0)."""
    info = md.journal
    if info is None:
        return ""
    return (
        f"journal:     delta segment over step_{info.get('base_step')} "
        f"(+{len(info.get('prior_segments', []))} prior segment(s)); "
        f"{info.get('entries_delta')} of {info.get('entries_total')} "
        f"entries changed, {len(info.get('deleted', []))} deleted, "
        f"{_human(info.get('delta_bytes') or 0)} logical delta"
    )


def cmd_info(args: argparse.Namespace) -> int:
    from .manifest import ShardedArrayEntry
    from .snapshot import Snapshot

    md = Snapshot(args.path).metadata
    # Un-partitioned saves may leave identical shard records on several
    # ranks; count each (logical path, offsets, sizes) once, as the
    # restore-time merge does (manifest_ops._get_merged_sharded_entries).
    total = 0
    seen_shards = set()
    for path, entry in md.manifest.items():
        if isinstance(entry, ShardedArrayEntry):
            _, _, logical = path.partition("/")
            for shard in entry.shards:
                key = (logical, tuple(shard.offsets), tuple(shard.sizes))
                if key in seen_shards:
                    continue
                seen_shards.add(key)
                total += _entry_size(shard.tensor)
        else:
            total += _entry_size(entry)
    print(f"path:        {args.path}")
    print(f"version:     {md.version}")
    print(f"world_size:  {md.world_size}")
    print(f"entries:     {len(md.manifest)}")
    print(f"array bytes: {_human(total)}")
    print(_compression_line(md))
    for line in (_cas_line(md), _journal_line(md)):
        if line:
            print(line)
    store_url = _resolve_store_url(args.path)
    if store_url is not None:
        print(f"store:       shared CAS at {store_url}")
    return 0


def cmd_ls(args: argparse.Namespace) -> int:
    from .manifest import PrimitiveEntry, ShardedArrayEntry
    from .manifest_ops import get_manifest_for_rank
    from .snapshot import Snapshot

    md = Snapshot(args.path).metadata
    if args.rank is not None:
        # The per-rank view re-injects consolidated replicated entries and
        # merges shards: what the rank would actually restore.
        local, _ = get_manifest_for_rank(md, args.rank)
        manifest = {f"{args.rank}/{p}": e for p, e in local.items()}
    else:
        manifest = md.manifest
    for path in sorted(manifest):
        entry = manifest[path]
        desc = entry.type
        if hasattr(entry, "dtype") and hasattr(entry, "shape"):
            desc = f"{entry.type}[{entry.dtype}{list(entry.shape)}]"
            size = _entry_size(entry)
            if size:
                desc += f" {_human(size)}"
        if isinstance(entry, ShardedArrayEntry):
            desc += f" shards={len(entry.shards)}"
            if entry.partition_spec is not None:
                desc += f" spec={entry.partition_spec}"
        if isinstance(entry, PrimitiveEntry):
            desc = f"primitive:{entry.entry_type}={entry.readable[:40]}"
        if getattr(entry, "replicated", False):
            desc += " (replicated)"
        print(f"{path}  {desc}")
    return 0


def _print_tensor(value) -> None:
    """Print a tensor through numpy where its dtype has a numpy counterpart,
    else through torch, both with the same threshold and edge items."""
    import numpy as np
    import torch

    try:
        array = value.detach().cpu().numpy()
    except TypeError:  # bfloat16, the float8 types: no numpy dtype
        opts = torch._tensor_str.PRINT_OPTS
        saved = (opts.threshold, opts.edgeitems)
        opts.threshold, opts.edgeitems = _PRINT_THRESHOLD, _PRINT_EDGEITEMS
        try:
            print(value)
        finally:
            opts.threshold, opts.edgeitems = saved
        return
    with np.printoptions(threshold=_PRINT_THRESHOLD, edgeitems=_PRINT_EDGEITEMS):
        print(array)


def cmd_cat(args: argparse.Namespace) -> int:
    """Print one value.  A tensor lands on ``--device`` first, as
    ``read_object`` places it; without CUDA the default device raises."""
    import torch

    from .snapshot import Snapshot

    value = Snapshot(args.path).read_object(args.object_path, device=args.device)
    if isinstance(value, torch.Tensor):
        _print_tensor(value)
        return 0
    try:
        import numpy as np

        if isinstance(value, np.ndarray) or hasattr(value, "shape"):
            with np.printoptions(threshold=_PRINT_THRESHOLD, edgeitems=_PRINT_EDGEITEMS):
                print(np.asarray(value))
            return 0
    except Exception:  # noqa: BLE001 — not array-like after all: print it as is
        pass
    print(value)
    return 0


def cmd_steps(args: argparse.Namespace) -> int:
    from datetime import datetime

    from .manager import SnapshotManager
    from .pg_wrapper import PGWrapper

    points = SnapshotManager(args.path, pg=PGWrapper()).restore_point_times()
    if not points:
        print("no committed steps")
        return 0
    for step, kind, ts in points:
        # The committed-at instant (from the point's history entry or
        # sidecar) is what restore_as_of selects on.
        when = f"  committed {datetime.fromtimestamp(ts).isoformat(timespec='seconds')}" if ts is not None else ""
        if kind == "full":
            print(f"step_{step}{when}")
        else:
            print(f"seg_{step} (journal delta){when}")
    print(f"latest: {points[-1][0]}")
    store_url = _resolve_store_url(args.path)
    if store_url is not None:
        print(f"store: shared CAS at {store_url}")
    return 0


def cmd_gc(args: argparse.Namespace) -> int:
    """List (default) or remove (``--apply``) uncommitted snapshot and
    segment directories under a SnapshotManager root: ``step_*``/``seg_*``
    dirs without a ``.snapshot_metadata`` commit marker, what a crashed take
    leaves when its cleanup never ran, plus compaction-subsumed journal
    segments and orphan CAS chunks.  ``--apply`` refuses (exit 3) while an
    advisory in-flight save marker looks live; ``--force`` overrides, for
    markers a crash orphaned that the liveness checks can't classify.
    Refuses a committed snapshot (exit 2): its payload dirs are no orphans."""
    from .manager import SnapshotManager
    from .pg_wrapper import PGWrapper
    from .snapshot import SNAPSHOT_METADATA_FNAME
    from .storage_plugin import url_to_storage_plugin

    storage = url_to_storage_plugin(args.path)
    try:
        if storage.sync_exists(SNAPSHOT_METADATA_FNAME):
            print(f"{args.path} is a committed snapshot, not a manager root; refusing to gc inside it")
            return 2
    finally:
        storage.sync_close()
    mgr = SnapshotManager(args.path, pg=PGWrapper())
    if args.apply:
        try:
            removed, removed_chunks, removed_segs = mgr.gc_detail(apply=True, force=args.force)
        except RuntimeError as e:
            print(str(e))
            return 3
        for step in removed:
            print(f"removed step_{step} (uncommitted)")
        print(f"{len(removed)} orphaned snapshot dir(s) removed")
        for seg in removed_segs:
            print(f"removed seg_{seg} (journal)")
        if removed_segs:
            print(f"{len(removed_segs)} journal segment(s) removed")
        for chunk in removed_chunks:
            print(f"removed orphan chunk {chunk}")
        if removed_chunks:
            print(f"{len(removed_chunks)} orphan CAS chunk(s) removed")
        return 0
    orphans, orphan_chunks, orphan_segs = mgr.gc_detail(apply=False)
    for step in orphans:
        print(f"orphan step_{step} (no {SNAPSHOT_METADATA_FNAME})")
    print(f"{len(orphans)} orphaned snapshot dir(s); re-run with --apply to remove (only when no save is in flight)")
    for seg in orphan_segs:
        print(f"orphan/stale journal segment seg_{seg}")
    if orphan_segs:
        print(f"{len(orphan_segs)} journal segment(s); --apply sweeps them too")
    for chunk in orphan_chunks:
        print(f"orphan chunk {chunk} (referenced by no committed step)")
    if orphan_chunks:
        print(f"{len(orphan_chunks)} orphan CAS chunk(s); --apply sweeps them too")
    for doc in mgr.inflight_markers():
        print(f"in-flight marker {doc['name']} (pid {doc.get('pid')} on {doc.get('host')})")
    store_url = _resolve_store_url(args.path)
    if store_url is not None:
        from . import store as store_mod

        cls = store_mod.chunk_classification(store_url)
        print(
            f"shared store {store_url}: {len(cls['referenced'])} referenced, {len(cls['orphan'])} orphan, "
            f"{len(cls['condemned'])} condemned chunk(s) store-wide"
        )
    return 0


def cmd_verify(args: argparse.Namespace) -> int:
    """Audit every payload checksum without restoring: catches bit rot and
    truncation before a resume depends on the snapshot.  Exit 1 on any
    corrupt or unreadable payload, 2 when checksums are off (a no-op audit
    must not pass for a clean one)."""
    from . import cas, integrity
    from .snapshot import Snapshot
    from .storage_plugin import url_to_storage_plugin

    # The native library is required, so checksums off is the one way to
    # have no hash backend; the message is the JAX package's.
    if not integrity.checksums_enabled():
        print(
            "cannot verify: checksums disabled (TPUSNAP_CHECKSUM=0) or "
            "no hash backend available (native library and xxhash missing)"
        )
        return 2
    md = Snapshot(args.path).metadata
    # Digest references resolve into the root's cas/ store: without the
    # wrapper every CAS payload would audit as a missing step-relative file.
    storage = url_to_storage_plugin(args.path)
    try:
        storage = cas.maybe_wrap_cas_reads(storage, args.path, md)
        ok, corrupt, unreadable, problems = integrity.audit(storage, md)
    finally:
        storage.sync_close()
    for line in problems:
        print(line)
    skipped = "" if ok or corrupt or unreadable else " (no checksums recorded)"
    # Digests cover the stored (compressed) bytes, so the audit verified
    # frames as they are; say what the codec layer did to them.
    print(_compression_line(md))
    cas_line = _cas_line(md)
    if cas_line:
        print(cas_line)
    print(f"verified {ok} payloads, {corrupt} corrupt, {unreadable} unreadable{skipped}")
    return 1 if corrupt or unreadable else 0


def _compare(ea, eb):
    """(changed, proven) of two entries at one logical path: ``proven``
    means the equality or difference is digest- or value-backed, not merely
    structural."""
    from .manifest import ObjectEntry, PrimitiveEntry, TensorEntry

    if type(ea) is not type(eb):
        return True, True
    if isinstance(ea, PrimitiveEntry):
        return (ea.entry_type, ea.serialized or ea.readable) != (eb.entry_type, eb.serialized or eb.readable), True
    if isinstance(ea, TensorEntry):
        if (ea.dtype, tuple(ea.shape)) != (eb.dtype, tuple(eb.shape)):
            return True, True
        if ea.checksum is not None and eb.checksum is not None:
            return ea.checksum != eb.checksum, True
        return False, False  # same structure, content unprovable
    shards_a, shards_b = _shards(ea), _shards(eb)
    if shards_a is not None:
        # Entry-level structure first: global dtype or shape differences
        # are provable without digests.
        if (ea.dtype, tuple(ea.shape)) != (eb.dtype, tuple(eb.shape)):
            return True, True
        # Shard records sorted by offsets: the two saves' meshes may
        # enumerate their devices in another order.
        recs_a = sorted((tuple(s.offsets), tuple(s.sizes), s.tensor.checksum) for s in shards_a)
        recs_b = sorted((tuple(s.offsets), tuple(s.sizes), s.tensor.checksum) for s in shards_b)
        if [r[:2] for r in recs_a] != [r[:2] for r in recs_b]:
            return True, True  # different shard layouts
        digests_a = [r[2] for r in recs_a]
        digests_b = [r[2] for r in recs_b]
        if None not in digests_a and None not in digests_b:
            return digests_a != digests_b, True
        return False, False
    if isinstance(ea, ObjectEntry):
        if (ea.obj_type, ea.serializer) != (eb.obj_type, eb.serializer):
            return True, True  # provably different object kinds
        if ea.checksum is not None and eb.checksum is not None:
            return ea.checksum != eb.checksum, True
        return False, False
    return False, False  # unknown entry type: unprovable


def cmd_diff(args: argparse.Namespace) -> int:
    """What changed between two snapshots, by logical path: added and
    removed paths, payloads whose content provably differs, and common paths
    whose equality CANNOT be proven (digests missing on either side).
    Reads the manifests only, as they are: a journal segment's manifest
    holds its delta entries alone."""
    from .manifest_utils import is_container_entry
    from .snapshot import Snapshot

    def _leaves(path):
        return {p: e for p, e in Snapshot(path).metadata.manifest.items() if not is_container_entry(e)}

    a, b = _leaves(args.path_a), _leaves(args.path_b)
    added = sorted(set(b) - set(a))
    removed = sorted(set(a) - set(b))
    changed, identical, unverified = [], 0, []
    for p in sorted(set(a) & set(b)):
        delta, proven = _compare(a[p], b[p])
        if delta:
            changed.append(p)
        elif proven:
            identical += 1
        else:
            unverified.append(p)
    for label, paths in (("added", added), ("removed", removed), ("changed", changed), ("unverified", unverified)):
        for p in paths[: args.limit]:
            print(f"{label:>10}  {p}")
        if len(paths) > args.limit:
            print(f"{label:>10}  ... and {len(paths) - args.limit} more")
    summary = f"{len(added)} added, {len(removed)} removed, {len(changed)} changed, {identical} identical"
    if unverified:
        summary += (
            f", {len(unverified)} UNVERIFIED (digests missing — structural match only, content equality unproven)"
        )
    print(summary)
    return 1 if added or removed or changed else 0


def cmd_cp(args: argparse.Namespace) -> int:
    """Replicate a committed snapshot between storage backends (fs, s3, gs,
    any direction).  Payloads first, commit marker last: an interrupted
    copy never leaves a destination that opens as a valid snapshot."""
    from .replication import copy_snapshot

    copy_snapshot(
        args.src, args.dst, overwrite=args.overwrite, io_concurrency=args.concurrency, verify=args.verify
    )
    print(f"copied {args.src} -> {args.dst}" + (" (verified)" if args.verify else ""))
    return 0


def cmd_stats(args: argparse.Namespace) -> int:
    """Render a snapshot's telemetry sidecars (telemetry/sidecar.py): per
    operation its duration, bytes, throughput and dominant phases, and, for
    a store-backed snapshot, the shared store's per-tenant usage."""
    import json

    from .storage_plugin import url_to_storage_plugin
    from .telemetry import metrics, sidecar

    storage = url_to_storage_plugin(args.path)
    try:
        docs = sidecar.read_all(storage)
    finally:
        storage.sync_close()
    if args.json:
        print(json.dumps(docs, indent=1))
    elif not docs:
        print("no telemetry sidecars (snapshot predates telemetry, or TPUSNAP_SIDECAR=0 at take/restore time)")
    else:
        for doc in docs:
            print(sidecar.summarize(doc))
        print(f"{len(docs)} operation(s) recorded")
    store_url = _resolve_store_url(args.path)
    if store_url is not None:
        from . import store as store_mod

        try:
            usage = store_mod.tenant_usage(store_url)
        except Exception as e:  # noqa: BLE001 — report the store, keep the sidecars' output
            print(f"shared store {store_url}: usage unavailable ({e})")
            usage = None
        if usage is not None:
            # Publishing makes the per-tenant gauges visible to the
            # --metrics exposition below.
            store_mod.publish_usage_metrics(usage)
            if not args.json:
                ratio = usage.get("dedup_ratio")
                print(
                    f"shared store {store_url}: "
                    f"{_human(usage['physical_bytes'])} physical across "
                    f"{usage['chunks']} chunk(s), "
                    f"{_human(usage['logical_bytes'])} logical" + (f", dedup {ratio}x" if ratio else "")
                )
                for tid, t in sorted(usage.get("tenants", {}).items()):
                    print(
                        f"  tenant {tid} ({t['root']}): "
                        f"{_human(t['logical_bytes'])} logical, "
                        f"{_human(t['exclusive_bytes'])} exclusive, "
                        f"{t['chunks']} chunk(s)"
                    )
    if args.metrics:
        # The in-process registry (filled if this run itself took
        # metrics-enabled operations).
        print(metrics.render_prometheus(), end="")
    return 0


def cmd_trace(args: argparse.Namespace) -> int:
    """Validate and merge the per-rank, per-op trace files of a
    ``TPUSNAP_TRACE_DIR`` into one Perfetto-loadable JSON.  ``--fleet``
    stitches a fleet's files (client ranks and peer daemons) into one
    distributed timeline: clock skew is corrected per host from the fleet
    spool's publish stamps, and spans group by the trace id propagated in
    ``traceparent`` headers."""
    import glob
    import json
    import os as _os

    from .telemetry import trace

    paths = sorted(glob.glob(_os.path.join(args.trace_dir, f"*{trace.TRACE_FILE_SUFFIX}")))
    if not paths:
        print(f"no *{trace.TRACE_FILE_SUFFIX} files under {args.trace_dir}")
        return 2
    try:
        if args.fleet:
            from . import knobs as _knobs

            spool = args.spool or _knobs.get_fleet_telemetry_dir()
            merged = trace.merge_fleet_traces(paths, spool=spool)
        else:
            merged = trace.merge_trace_files(paths)
    except ValueError as e:
        print(f"invalid trace input: {e}")
        return 1
    n_spans = sum(1 for ev in merged["traceEvents"] if ev.get("ph") == "X")
    ops: dict = {}
    for src in merged["otherData"]["merged_from"]:
        ops[src.get("kind", "?")] = ops.get(src.get("kind", "?"), 0) + 1
    for path in paths:
        print(f"  {_os.path.basename(path)}")
    print(
        f"merged {len(paths)} trace file(s): "
        + ", ".join(f"{n}x {k}" for k, n in sorted(ops.items()))
        + f", {n_spans} spans"
    )
    if args.fleet:
        for tid, count in merged["otherData"].get("trace_ids", {}).items():
            print(f"  trace {tid}: {count} span(s)")
        skews = {src.get("skew_s", 0.0) for src in merged["otherData"]["merged_from"]}
        if any(abs(s) > 0.0005 for s in skews):
            print(f"  clock skew corrected: up to {max(abs(s) for s in skews) * 1e3:.1f}ms across hosts")
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(merged, f)
        print(f"wrote {args.out} (open in ui.perfetto.dev or chrome://tracing)")
    return 0


def cmd_analyze(args: argparse.Namespace) -> int:
    """Cross-rank, cross-phase bottleneck analysis over a trace directory
    (telemetry/analyze.py): per-phase exclusive wall, scheduler idle, the
    limiting resource (d2h, serialize, storage, or budget or I/O-cap
    throttling) and the straggler rank; ``--snapshot`` joins that
    snapshot's telemetry sidecars.  ``--barrier`` switches to the commit
    barrier's blame report over the sidecars' barrier stamps (the
    positional argument is then the snapshot URL), ``--peer`` to the
    serving plane's per-peer report from ``peer_fetch`` and
    ``peerd_handle`` spans, and ``--profile`` folds the profile files of
    the same directory into the report."""
    import json

    from .telemetry import analyze, trace

    if args.barrier:
        sidecars = analyze.load_sidecars(args.snapshot or args.trace_dir)
        reports = analyze.barrier_blame(sidecars)
        if args.json:
            print(json.dumps(reports, indent=1))
        else:
            print(analyze.render_barrier(reports))
        return 0 if reports else 2

    profile_docs = None
    if args.profile:
        try:
            profile_docs = analyze.load_profile_dir(args.trace_dir)
        except ValueError as e:
            print(f"invalid profile input: {e}")
            return 1
    try:
        docs = analyze.load_trace_dir(args.trace_dir)
    except ValueError as e:
        print(f"invalid trace input: {e}")
        return 1
    if not docs and not profile_docs:
        suffixes = f"*{trace.TRACE_FILE_SUFFIX}"
        if args.profile:
            from .telemetry import profiler

            suffixes += f" / *{profiler.PROFILE_FILE_SUFFIX}"
        print(f"no {suffixes} files under {args.trace_dir}")
        return 2
    if args.peer:
        report = analyze.peer_report(docs)
        if args.json:
            print(json.dumps(report, indent=1))
        else:
            print(analyze.render_peer(report))
        return 0 if report.get("peers") else 2
    sidecars = analyze.load_sidecars(args.snapshot) if args.snapshot else None
    analysis = analyze.analyze_traces(docs, sidecars)
    if profile_docs is not None:
        analysis["profiles"] = analyze.profile_report(profile_docs)["profiles"]
    if args.json:
        print(json.dumps(analysis, indent=1))
        return 0
    if docs:
        print(analyze.render(analysis))
    if profile_docs is not None:
        if docs:
            print()
        print(analyze.render_profile({"profiles": analysis.get("profiles", [])}))
    return 0


def cmd_profile_diff(args: argparse.Namespace) -> int:
    """Differential profile of two runs (telemetry/profiler.py): the frames
    that gained or lost self on-CPU seconds from A to B.  Each argument is a
    ``*.profile.json`` file or a profile directory, whose per-rank and
    per-op files merge first.  An invalid profile exits 1, an empty
    directory 2, as ``trace`` does."""
    import json
    import os as _os

    from .telemetry import profiler

    def _load(path: str):
        if _os.path.isdir(path):
            docs = profiler.load_profile_dir(path)
            if not docs:
                raise FileNotFoundError(f"no *{profiler.PROFILE_FILE_SUFFIX} files under {path}")
            return profiler.merge_metas([d["tpusnap"] for d in docs])
        return profiler.load_profile_file(path)["tpusnap"]

    try:
        meta_a = _load(args.a)
        meta_b = _load(args.b)
    except FileNotFoundError as e:
        print(e)
        return 2
    except ValueError as e:
        print(f"invalid profile input: {e}")
        return 1
    diff = profiler.diff_profiles(meta_a, meta_b, top=args.top)
    if args.json:
        print(json.dumps(diff, indent=1))
    else:
        print(f"profile diff: A={args.a}  B={args.b}")
        print(profiler.render_diff(diff))
    return 0


def cmd_history(args: argparse.Namespace) -> int:
    """Render a SnapshotManager root's step-save history
    (telemetry/history.jsonl): the per-step duration and GB/s trend with
    regression flags."""
    import json

    from .storage_plugin import url_to_storage_plugin
    from .telemetry import history

    storage = url_to_storage_plugin(args.path)
    try:
        entries = history.read(storage)
    finally:
        storage.sync_close()
    if args.json:
        print(json.dumps(entries, indent=1))
    else:
        print(history.render(entries, limit=args.limit))
    return 0


def cmd_postmortem(args: argparse.Namespace) -> int:
    """Crash forensics for a SnapshotManager root (telemetry/postmortem.py):
    one skew-corrected timeline of the flight-recorder rings, the frozen
    heartbeat, the lease stamps, the in-flight markers and the store's
    state; the first-dead pid, its op and phase, the debris, and the
    remediation that converges (its ``gc`` line is this CLI's)."""
    import json

    from .telemetry import postmortem

    report = postmortem.analyze_root(
        args.path,
        store_url=args.store,
        coord_dir=args.coord,
        heartbeat_path=args.heartbeat,
        blackbox_dir=args.blackbox,
    )
    if args.perfetto:
        doc = postmortem.to_perfetto(report)
        out = args.out or "postmortem.perfetto.json"
        with open(out, "w", encoding="utf-8") as f:
            json.dump(doc, f)
        print(f"wrote {len(doc['traceEvents'])} timeline event(s) to {out}")
        return 0
    if args.json:
        print(json.dumps(report, indent=1, default=str))
    else:
        print(postmortem.format_report(report))
    return 0


def _store_usage_lines(store_url) -> list:
    """``top``'s view of the shared store (``TPUSNAP_STORE``): one line for
    the store, one per tenant."""
    if store_url is None:
        return []
    from . import store as store_mod

    try:
        usage = store_mod.tenant_usage(store_url)
    except Exception as e:  # noqa: BLE001 — report the store, keep the table
        return [f"store {store_url}: usage unavailable ({e})"]
    ratio = usage.get("dedup_ratio")
    lines = [
        f"store {store_url}: {_human(usage['physical_bytes'])} physical"
        f" / {_human(usage['logical_bytes'])} logical" + (f" (dedup {ratio}x)" if ratio else "")
    ]
    for tid, t in sorted(usage.get("tenants", {}).items()):
        lines.append(
            f"  tenant {tid}: {_human(t['logical_bytes'])} logical, {_human(t['exclusive_bytes'])} exclusive"
        )
    return lines


def cmd_top(args: argparse.Namespace) -> int:
    """Cross-process fleet view (telemetry/fleet.py): every op publishing
    into the ``TPUSNAP_FLEET_TELEMETRY`` spool is one row (phase state,
    bytes staged and written, ETA) under the aggregate bandwidth, the cache
    hit ratio and origin bytes, and the straggler.  The table refreshes
    every ``--interval`` until Ctrl-C (``--once``: one table); ``--json``
    is one machine-readable view, ``--prometheus`` one merged exposition
    of the whole fleet."""
    import json
    import os as _os
    import time as _time

    from . import knobs as _knobs
    from .telemetry import fleet

    spool = fleet.resolve_spool(args.path)
    if spool is None or not _os.path.isdir(spool):
        print(
            "no fleet telemetry spool found: pass a spool dir (or a root "
            "with telemetry/live under it) or set TPUSNAP_FLEET_TELEMETRY"
        )
        return 2
    if args.prometheus:
        print(fleet.render_prometheus(fleet.collect(spool, stale_s=args.stale, sweep=False)), end="")
        return 0
    store_url = _knobs.get_store_url()
    if args.json:
        doc = fleet.aggregate(fleet.collect(spool, stale_s=args.stale, sweep=False))
        if store_url is not None:
            from . import store as store_mod

            try:
                doc["store"] = store_mod.tenant_usage(store_url)
            except Exception as e:  # noqa: BLE001 — the view stands without the store
                doc["store"] = {"error": str(e)}
        print(json.dumps(doc, indent=1))
        return 0
    try:
        while True:
            print(fleet.render(fleet.aggregate(fleet.collect(spool, stale_s=args.stale)), spool))
            for line in _store_usage_lines(store_url):
                print(line)
            if args.once:
                return 0
            print()
            _time.sleep(max(0.1, args.interval))
    except KeyboardInterrupt:
        pass
    return 0


def main(argv=None) -> int:
    # The ported commands, with the JAX parser's options, defaults and
    # help, plus ``cat --device``.
    parser = argparse.ArgumentParser(prog="python -m torchsnapshot_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("info", help="snapshot summary")
    p.add_argument("path")
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("ls", help="list manifest entries")
    p.add_argument("path")
    p.add_argument("--rank", type=int, default=None)
    p.set_defaults(fn=cmd_ls)

    p = sub.add_parser("cat", help="print one value (rank/logical/path)")
    p.add_argument("path")
    p.add_argument("object_path")
    p.add_argument(
        "--device",
        default="cuda",
        help="device a tensor is read onto, as read_object places it (default: cuda; 'cpu' without a GPU)",
    )
    p.set_defaults(fn=cmd_cat)

    p = sub.add_parser("steps", help="list a SnapshotManager root's steps")
    p.add_argument("path")
    p.set_defaults(fn=cmd_steps)

    p = sub.add_parser("verify", help="audit all payload checksums without restoring")
    p.add_argument("path")
    p.set_defaults(fn=cmd_verify)

    p = sub.add_parser("gc", help="list/remove uncommitted snapshot dirs under a root")
    p.add_argument("path")
    p.add_argument("--apply", action="store_true", help="remove the orphans (default: dry-run listing)")
    p.add_argument(
        "--force",
        action="store_true",
        help="override the in-flight save guard (only when certain no save is running)",
    )
    p.set_defaults(fn=cmd_gc)

    p = sub.add_parser("diff", help="compare two snapshots' content by logical path")
    p.add_argument("path_a")
    p.add_argument("path_b")
    p.add_argument("--limit", type=int, default=20, help="paths shown per bucket")
    p.set_defaults(fn=cmd_diff)

    p = sub.add_parser("cp", help="replicate a snapshot to another storage backend")
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--overwrite", action="store_true", help="replace a committed snapshot at dst")
    p.add_argument("--verify", action="store_true", help="audit all checksummed payloads on dst after the copy")
    p.add_argument("--concurrency", type=int, default=4, help="concurrent payload copies")
    p.set_defaults(fn=cmd_cp)

    p = sub.add_parser("stats", help="render a snapshot's telemetry sidecars")
    p.add_argument("path")
    p.add_argument("--json", action="store_true", help="dump raw sidecar JSON")
    p.add_argument("--metrics", action="store_true", help="also print the in-process Prometheus registry")
    p.set_defaults(fn=cmd_stats)

    p = sub.add_parser("trace", help="validate + merge per-rank Perfetto trace files")
    p.add_argument("trace_dir")
    p.add_argument("--out", default=None, help="write the merged trace-event JSON here")
    p.add_argument(
        "--fleet",
        action="store_true",
        help="stitch client + peer-daemon trace files into one distributed timeline grouped by propagated trace id "
        "(clock-skew corrected per host)",
    )
    p.add_argument(
        "--spool",
        default=None,
        help="fleet telemetry spool used for clock-skew correction (default: $TPUSNAP_FLEET_TELEMETRY; only with "
        "--fleet)",
    )
    p.set_defaults(fn=cmd_trace)

    p = sub.add_parser("analyze", help="cross-rank bottleneck analysis over per-rank trace files")
    p.add_argument("trace_dir")
    p.add_argument("--snapshot", default=None, help="snapshot URL whose telemetry sidecars enrich the report")
    p.add_argument(
        "--barrier",
        action="store_true",
        help="cross-rank commit-barrier blame report from the snapshot's sidecars (the positional argument is the "
        "snapshot URL)",
    )
    p.add_argument(
        "--peer",
        action="store_true",
        help="serving-plane report from peer_fetch/peerd_handle spans: per-peer p50/p99 latency, "
        "hit/reject/fallback rates, TTFB-vs-transfer split",
    )
    p.add_argument(
        "--profile",
        action="store_true",
        help="fold continuous-profiling files (*.profile.json in the same dir) into the report: per-phase CPU "
        "seconds, hottest frames, on/off-CPU split, dominant CPU sink",
    )
    p.add_argument("--json", action="store_true", help="machine-readable output")
    p.set_defaults(fn=cmd_analyze)

    p = sub.add_parser("profile", help="continuous-profiling tools over *.profile.json files")
    psub = p.add_subparsers(dest="profile_cmd", required=True)
    pd = psub.add_parser(
        "diff", help="differential profile: which frames gained/lost CPU seconds between run A and run B"
    )
    pd.add_argument("a", help="profile file or dir (baseline)")
    pd.add_argument("b", help="profile file or dir (comparison)")
    pd.add_argument("--top", type=int, default=10, help="rows per direction")
    pd.add_argument("--json", action="store_true", help="machine-readable output")
    pd.set_defaults(fn=cmd_profile_diff)

    p = sub.add_parser("top", help="live fleet view over a TPUSNAP_FLEET_TELEMETRY spool")
    p.add_argument(
        "path",
        nargs="?",
        default=None,
        help="spool dir, or a root with telemetry/live under it (default: $TPUSNAP_FLEET_TELEMETRY)",
    )
    p.add_argument("--json", action="store_true", help="one-shot aggregated snapshot")
    p.add_argument("--prometheus", action="store_true", help="one-shot merged Prometheus exposition across the fleet")
    p.add_argument("--once", action="store_true", help="render the table once and exit")
    p.add_argument("--interval", type=float, default=2.0, help="refresh seconds for the live table")
    p.add_argument(
        "--stale", type=float, default=None, help="age-out seconds (default: TPUSNAP_FLEET_TELEMETRY_STALE_S)"
    )
    p.set_defaults(fn=cmd_top)

    p = sub.add_parser(
        "postmortem",
        help="crash forensics: stitch flight-recorder rings, leases, and store state into a causal timeline with "
        "remediation",
    )
    p.add_argument("path", help="SnapshotManager root to analyze")
    p.add_argument("--store", default=None, help="shared CAS store URL (default: TPUSNAP_STORE or the root's .store pointer)")
    p.add_argument(
        "--coord", default=None, help="FileStore coordination dir holding oplease stamps (default: TPUSNAP_STORE_PATH)"
    )
    p.add_argument("--heartbeat", default=None, help="heartbeat file to fold in (default: TPUSNAP_HEARTBEAT_FILE)")
    p.add_argument(
        "--blackbox",
        default=None,
        help="flight-recorder ring dir (default: TPUSNAP_BLACKBOX or <root>/telemetry/blackbox)",
    )
    p.add_argument("--json", action="store_true", help="machine-readable report")
    p.add_argument(
        "--perfetto",
        action="store_true",
        help="export the stitched timeline as Chrome/Perfetto instant events instead of the text report",
    )
    p.add_argument("--out", default=None, help="output path for --perfetto (default: postmortem.perfetto.json)")
    p.set_defaults(fn=cmd_postmortem)

    p = sub.add_parser("history", help="render a manager root's step-save history/trend")
    p.add_argument("path")
    p.add_argument("--json", action="store_true", help="raw history entries")
    p.add_argument("--limit", type=int, default=50, help="entries shown (newest last)")
    p.set_defaults(fn=cmd_history)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
