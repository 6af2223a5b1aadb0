#!/usr/bin/env python3
"""Drive torchsnapshot_tpu_torch's main path once on one CUDA GPU.

    python3 chip_smoke.py [--seed N] [--n-layers L]

Checkpoints the Llama-3-8B parameter set (stacked layers, bf16, 16.06 GB,
built on the card from a seeded ``torch.Generator``) plus an RNGState, an
int step and a small pickled object, through the entry points a user
calls, in phases that each print one JSON line:

1. device     — requires CUDA; the card's name and power limit (nvidia-smi)
2. build      — builds the native library from this checkout; requires the
                fused write+hash entry point
   dist_*     — several ranks on this one card, before this process builds
                any state: spawned processes on cuda:0 in a gloo group,
                each holding only its own boxes of the same parameter set
                as DTensors (built from a per-tensor seed and the global
                index).  Four ranks on a 2x2 ("replicate", "shard") mesh,
                weights HSDP [Replicate(), Shard(0)], norms Replicate:
                ``dist_take`` (the ranks' bytes written must sum to the
                payload on disk: each replicated box written once),
                ``dist_restore`` (zeroed, restored in place: bit-exact,
                ``data_ptr()`` unchanged), ``dist_async_take`` (mutated
                after the return; one commit through the LinearBarrier;
                the restore equals the state before the mutation),
                ``dist_cas_take`` (two ``TPUSNAP_CAS`` takes into
                ``<root>/step_0`` and ``step_1`` with every box of ``wk``
                refilled between them: step 1's bytes written, summed over
                the ranks, must equal ``wk``'s; step 1 restores bit-exact
                in place), ``dist_manager_journal`` (a journal
                ``SnapshotManager`` saves step 0, then a segment with
                ``wk`` refilled: the segment's bytes written, summed over
                the ranks, must equal ``wk``'s; ``restore_latest`` replays
                it bit-exact in place on every rank); then
                two fresh ranks on a 1-D mesh restore every tensor
                ``Shard(-1)`` (``dist_elastic_restore``, bit-exact), and
                this process reads the largest sharded entry whole onto
                the card (``dist_read_object``).  A rank that fails or
                times out fails the phase.
3. state      — builds the state and a device-side reference copy; cuts
                the depth (n_layers) if card memory or disk is short
4. take       — ``Snapshot.take`` to local disk: seconds, GB/s, per-phase
                stats (``d2h`` bytes must equal the state's bytes), and a
                manifest holding chunked, dense, slab, object and primitive
                entries
5. restore    — overwrites every target, ``Snapshot.restore``: bit-exact
                against the reference, ``data_ptr()`` unchanged, ``h2d``
                bytes equal to the state's bytes
6. read_object — reads the chunked ``embed.tokens`` onto the card
7. integrity  — a flipped payload byte must raise ``ChecksumError``
   async_*    — ``Snapshot.async_take`` forced into each staging mode
                (``async_pinned_host`` twice: ``auto``, which must resolve
                to pinned_host, then ``pinned_host``; ``async_device``;
                ``async_host``).  Each times the stall (until async_take
                returns), mutates every tensor in place and frees and
                refills the largest, runs training steps (bf16 8192^2
                matmuls) while the drain runs, times them against the same
                steps before the take (stream-local and device-wide syncs),
                then ``wait()``s, restores into zeroed targets and requires
                bit-exact equality with the state before the mutation,
                ``device_stage`` (device modes) and ``d2h`` bytes equal to
                the state's bytes, the forced mode, and no
                ``async_take.staging_downgrade`` event; it reports the RSS
                high-water mark and pinned host bytes
   storage depth — each phase removes its directories before the next:
   compress_take / compress_restore — ``TPUSNAP_COMPRESSION=zstd``
                (native libzstd; zlib, said so, where the machine has no
                libzstd): every model entry above the size floor framed
                with the codec asked for; bytes on disk over state bytes;
                then a bit-exact in-place restore
   cas_take   — ``TPUSNAP_CAS=1`` takes into ``<root>/step_0`` and, after
                flipping every bit of ``wk`` and of a contiguous 1% row
                range of ``w_gate``, ``step_1``: the bytes step 1 wrote
                must be its new chunks, at most ``wk`` plus the ``w_gate``
                chunks the rows touch; step 1 restores bit-exact in place,
                and ``read_object`` of an unchanged tensor reads step 0's
                chunks
   async_cas  — ``async_take`` in pinned_host mode with CAS into
                ``step_2`` (step 1's state): its model entries equal the
                sync take's (leaves of identical bytes may reference each
                other's equal range), restore bit-exact
   cdc_take   — cas_take with ``TPUSNAP_CDC=1``: step 1's new bytes are
                bounded by the changed bytes plus two maximum-size chunks
                per changed region
   incremental_take — step 1 with ``incremental_from=step_0``, CAS off:
                every payload whose checksum did not change is a hard
                link, the bytes written are at most ``wk`` plus the
                ``w_gate`` chunks the rows touch, bit-exact restore
   manager_journal — ``SnapshotManager(root, max_to_keep=1, journal=True)``
                with ``TPUSNAP_JOURNAL_MAX_SEGMENTS=3``: step 0 (the base),
                steps 1-3 (segments of the step change; the third folds
                into ``step_3`` and retention prunes step 0), step 4 (a
                segment over the fold).  Per save: wall, bytes written
                against the whole-chunk bound, the ``prestage_delta`` wall,
                ``entries_delta``/``entries_total``.  The fold writes no
                payload byte; fold and prune reclaim exactly the chunks
                ``step_3`` does not reference; ``restore_latest`` (seg 4)
                and ``restore_at(3)`` are bit-exact in place; a corrupt
                seg 4 falls back to step 3 with the ``restore_latest`` and
                ``journal`` fallback events; with it removed, ``gc_detail``
                reclaims exactly its chunks, bytes as its manifest states
   manager_async_journal — a segment saved with ``async_=True`` in
                pinned_host mode (every tensor mutated after the return):
                stall and total; its manifest equals the sync segment of
                the same change entry by entry; bit-exact replayed restore
8. yardsticks — raw pinned D2H and H2D GB/s over a 1 GiB copy and raw
                fsync'd disk write GB/s

The port writes no GPU kernel (the JAX package has no Pallas kernel), so
the kernels line is empty and says why.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failure exits non-zero without that line.  Temporary files live in
``.chip_smoke_tmp/`` beside this script and are removed at exit.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
GB = 1e9

# Llama-3-8B (torchsnapshot_tpu/models/llama.py LlamaConfig.llama3_8b).
VOCAB, D_MODEL, N_LAYERS, N_HEADS, N_KV_HEADS, D_FF = 128256, 4096, 32, 32, 8, 14336


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def llama_shapes(n_layers: int):
    """(path, shape, init scale) of the stacked-layer parameter set, in the
    layout of torchsnapshot_tpu/models/llama.py init_params; scale None
    marks the norms (ones)."""
    d, f, v, L = D_MODEL, D_FF, VOCAB, n_layers
    kv = N_KV_HEADS * (D_MODEL // N_HEADS)
    s = d ** -0.5
    return [
        (("embed", "tokens"), (v, d), 1.0),
        (("layers", "attn", "wq"), (L, d, d), s),
        (("layers", "attn", "wk"), (L, d, kv), s),
        (("layers", "attn", "wv"), (L, d, kv), s),
        (("layers", "attn", "wo"), (L, d, d), s),
        (("layers", "mlp", "w_gate"), (L, d, f), s),
        (("layers", "mlp", "w_up"), (L, d, f), s),
        (("layers", "mlp", "w_down"), (L, f, d), f ** -0.5),
        (("layers", "attn_norm"), (L, d), None),
        (("layers", "mlp_norm"), (L, d), None),
        (("final_norm",), (d,), None),
        (("output", "kernel"), (d, v), s),
    ]


def state_bytes(n_layers: int) -> int:
    total = 0
    for _, shape, _ in llama_shapes(n_layers):
        n = 1
        for x in shape:
            n *= x
        total += 2 * n  # bf16
    return total


def build_params(torch, n_layers: int, seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    params: dict = {}
    for path, shape, scale in llama_shapes(n_layers):
        if scale is None:
            t = torch.ones(shape, dtype=torch.bfloat16, device="cuda")
        else:
            t = torch.randn(shape, generator=g, dtype=torch.bfloat16, device="cuda")
            t.mul_(scale)
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t
    return params


def leaves(tree, prefix=""):
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from leaves(v, p)
        else:
            yield p, v


def bit_equal(torch, a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int16), b.view(torch.int16))


def phase_summary(stats):
    return {
        k: {"s": round(v["s"], 4), "wall": round(v.get("wall", v["s"]), 4), "bytes": int(v["bytes"]), "n": int(v["n"])}
        for k, v in sorted(stats.items())
    }


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return out.stdout.strip().splitlines()[0]


N_STEPS = 5
STEP_DIM = 8192


def training_steps(torch, mats, n: int, device_sync: bool):
    """Milliseconds of ``n`` stand-in training steps (three bf16 matmuls
    each), each ended by a stream-local or a device-wide synchronize."""
    times = []
    for _ in range(n):
        begin = time.perf_counter()
        x = mats[0] @ mats[1]
        x = x @ mats[0]
        x = x @ mats[1]
        if device_sync:
            torch.cuda.synchronize()
        else:
            torch.cuda.current_stream().synchronize()
        times.append((time.perf_counter() - begin) * 1e3)
    del x
    return times


class RSSSampler:
    """Samples an ``RSSWatermark`` every 20 ms on a thread."""

    def __init__(self, watermark) -> None:
        self.watermark = watermark
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        while not self._stop.wait(0.02):
            self.watermark.sample()

    def __enter__(self):
        self._thread.start()
        return self.watermark

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join()
        self.watermark.sample()


def pinned_host_bytes(torch):
    """Byte counters of CUDA's caching host (pinned) allocator, where this
    torch has them."""
    stats_fn = getattr(torch.cuda, "host_memory_stats", None)
    if stats_fn is None:
        return None
    return {k: int(v) for k, v in stats_fn().items() if "bytes" in k and k.endswith((".current", ".peak"))}


def get_leaf(tree, path):
    node = tree
    for key in path.split("/"):
        node = node[key]
    return node


def set_leaf(tree, path, value):
    *parents, last = path.split("/")
    node = tree
    for key in parents:
        node = node[key]
    node[last] = value


def async_phase(torch, ts, knobs, phase_stats, RSSWatermark, app_state, ref, nbytes, mats, events, workdir,
                label, mode, expect_mode, run=1):
    """One async take in ``mode``: stall, mutation after return, steps
    during the drain, wait, bit-exact restore, byte and mode checks."""
    snap_path = os.path.join(workdir, f"{label}_{run}")
    idle_stream = training_steps(torch, mats, N_STEPS, device_sync=False)
    idle_device = training_steps(torch, mats, N_STEPS, device_sync=True)
    n_events = len(events)
    largest = max(ref, key=lambda p: ref[p].numel())
    torch.cuda.synchronize()
    phase_stats.reset()
    with RSSSampler(RSSWatermark()) as rss:
        begin = time.monotonic()
        with knobs.override_async_staging(mode):
            pending = ts.Snapshot.async_take(snap_path, app_state)
        stall_s = time.monotonic() - begin
        pinned_after_stage = pinned_host_bytes(torch)
        # Training resumes: every tensor changes in place, and the largest
        # is freed and its memory reused (a stand-in for donation).
        model = app_state["model"].state_dict()
        for path in ref:
            get_leaf(model, path).view(torch.int16).bitwise_not_()
        shape = ref[largest].shape
        set_leaf(model, largest, None)
        refill = torch.empty(shape, dtype=torch.bfloat16, device="cuda")
        refill.view(torch.int16).fill_(0x3F80)
        set_leaf(model, largest, refill)
        del refill
        drain_stream = training_steps(torch, mats, N_STEPS, device_sync=False)
        drain_device = training_steps(torch, mats, N_STEPS, device_sync=True)
        steps_overlapped_drain = not pending.done()
        snapshot = pending.wait()
        total_s = time.monotonic() - begin
    stats = phase_stats.snapshot()
    staging_mode = pending.staging_mode
    downgrades = [e.metadata for e in events[n_events:] if e.name == "async_take.staging_downgrade"]

    model = app_state["model"].state_dict()
    for path in ref:
        get_leaf(model, path).zero_()
    torch.cuda.synchronize()
    begin = time.monotonic()
    snapshot.restore(app_state)
    torch.cuda.synchronize()
    restore_s = time.monotonic() - begin
    model = app_state["model"].state_dict()
    mismatched = [p for p in ref if not bit_equal(torch, get_leaf(model, p), ref[p])]

    stage_bytes = int(stats.get("device_stage", {}).get("bytes", 0))
    d2h_bytes = int(stats.get("d2h", {}).get("bytes", 0))
    ok = (
        not mismatched
        and staging_mode == expect_mode
        and not downgrades
        and d2h_bytes == nbytes
        and (mode == "host" or stage_bytes == nbytes)
    )
    emit({"phase": label, "run": run, "ok": ok, "mode": mode, "staging_mode": staging_mode, "downgrades": downgrades,
          "stall_s": round(stall_s, 4), "total_s": round(total_s, 3), "gbps": round(nbytes / GB / total_s, 3),
          "stall_gbps": round(nbytes / GB / stall_s, 3), "restore_s": round(restore_s, 3),
          "bit_exact": not mismatched, "mismatched": mismatched[:5], "state_bytes": nbytes,
          "device_stage_bytes": stage_bytes, "d2h_bytes": d2h_bytes,
          "step_ms_idle": round(statistics.median(idle_stream), 3),
          "step_ms_during_drain": round(statistics.median(drain_stream), 3),
          "step_ms_idle_device_sync": round(statistics.median(idle_device), 3),
          "step_ms_during_drain_device_sync": round(statistics.median(drain_device), 3),
          "steps_ms_during_drain": [round(t, 3) for t in drain_stream],
          "steps_overlapped_drain": steps_overlapped_drain,
          "rss_high_water_bytes": rss.high_water, "rss_baseline_bytes": rss.baseline,
          "pinned_host_after_stage": pinned_after_stage, "pinned_host_after_wait": pinned_host_bytes(torch),
          "pinned_alloc": phase_summary({k: v for k, v in stats.items() if k == "pinned_alloc"}).get("pinned_alloc"),
          "phases": phase_summary(stats)})
    shutil.rmtree(snap_path, ignore_errors=True)
    if not ok:
        raise RuntimeError(f"{label}: not bit-exact, wrong mode, a downgrade, or stage/d2h bytes differ")
    return stall_s


def copy_gbps(torch, dst, src, reps: int = 5) -> float:
    dst.copy_(src, non_blocking=True)  # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        dst.copy_(src, non_blocking=True)
    end.record()
    end.synchronize()
    return reps * src.numel() * src.element_size() / GB / (start.elapsed_time(end) / 1e3)


def fsync_write_gbps(np, path: str, nbytes: int) -> float:
    buf = np.random.default_rng(0).integers(0, 256, size=nbytes, dtype=np.uint8)
    view = memoryview(buf)
    step = 64 << 20
    begin = time.monotonic()
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        for off in range(0, nbytes, step):
            chunk = view[off : off + step]
            done = 0
            while done < len(chunk):
                done += os.write(fd, chunk[done:])
        os.fsync(fd)
    finally:
        os.close(fd)
    seconds = time.monotonic() - begin
    os.unlink(path)
    return nbytes / GB / seconds



# ----------------------------------------------------- storage-depth phases
#
# Compression, content addressing (CAS), content-defined chunking (CDC) and
# incremental takes of the full state.  Every phase removes its directories
# before the next starts (the disk holds about four copies of the state).

CHANGED_ROW_FRACTION = 0.01


def payload_file(relpath: str) -> bool:
    """Whether a snapshot-relative file holds payload: not the commit marker
    or another dot-file, and not a telemetry sidecar."""
    return not (relpath.rsplit("/", 1)[-1].startswith(".") or relpath.startswith("telemetry/"))


def dir_bytes(path: str) -> int:
    total = 0
    for dirpath, _, files in os.walk(path):
        for name in files:
            full = os.path.join(dirpath, name)
            if payload_file(os.path.relpath(full, path)):
                total += os.path.getsize(full)
    return total


def mutate_step(torch, model, ref, pattern: int = -1):
    """A step's change, applied to the state and to its reference alike:
    every bit of ``wk`` and of a contiguous 1% row range of ``w_gate`` (rows
    of its last dim) XORed with the int16 ``pattern`` (the default flips
    them, an involution).  Returns (changed bytes, number of changed
    regions)."""
    wk = get_leaf(model, "layers/attn/wk")
    gate = get_leaf(model, "layers/mlp/w_gate")
    rows = gate.numel() // gate.shape[-1]
    n_rows = max(1, int(rows * CHANGED_ROW_FRACTION))
    r0 = rows // 3
    for t in (wk, ref["layers/attn/wk"]):
        t.view(torch.int16).bitwise_xor_(pattern)
    for t in (gate, ref["layers/mlp/w_gate"]):
        t.view(-1, t.shape[-1])[r0 : r0 + n_rows].view(torch.int16).bitwise_xor_(pattern)
    return wk.numel() * 2 + n_rows * gate.shape[-1] * 2, 2


def restore_check(torch, ts, path, app_state, ref, phase_stats, restore_fn=None):
    """Zero the model, restore ``path`` in place (or call
    ``restore_fn(app_state)``): (seconds, mismatched paths, moved paths,
    phase stats)."""
    model = app_state["model"].state_dict()
    ptrs = {p: get_leaf(model, p).data_ptr() for p in ref}
    for p in ref:
        get_leaf(model, p).zero_()
    device_sync(torch)
    phase_stats.reset()
    begin = time.monotonic()
    (restore_fn or ts.Snapshot(path).restore)(app_state)
    device_sync(torch)
    seconds = time.monotonic() - begin
    model = app_state["model"].state_dict()
    mismatched = [p for p in ref if not bit_equal(torch, get_leaf(model, p), ref[p])]
    moved = [p for p in ref if get_leaf(model, p).data_ptr() != ptrs[p]]
    return seconds, mismatched, moved, phase_stats.snapshot()


def compress_phases(torch, ts, knobs, phase_stats, app_state, ref, nbytes, workdir):
    """compress_take / compress_restore: zstd (native libzstd) framing of
    every payload above the size floor, then an in-place restore."""
    from torchsnapshot_tpu_torch import compression, serialization
    from torchsnapshot_tpu_torch.manifest import iter_payload_entries

    codec, why = "zstd", "asked for zstd"
    if compression.resolve("zstd") != "zstd":
        codec, why = "zlib", "this machine has no libzstd.so.1, so the phase asks for zlib"
    path = os.path.join(workdir, "compress", "snap")
    device_sync(torch)
    phase_stats.reset()
    with knobs.override_compression(codec):
        begin = time.monotonic()
        snapshot = ts.Snapshot.take(path, app_state)
        take_s = time.monotonic() - begin
    stats = phase_stats.snapshot()
    floor = knobs.get_compression_min_bytes()
    above = [e for k, e in iter_payload_entries(snapshot.get_manifest())
             if "/model/" in k and e.serializer == "buffer_protocol" and
             serialization.array_nbytes(e.shape, e.dtype) >= floor]
    codecs = sorted({str(e.codec) for e in above})
    on_disk = dir_bytes(path)
    take_ok = bool(above) and codecs == [codec] and snapshot.metadata.version == "0.2.0"
    emit({"phase": "compress_take", "ok": take_ok, "codec_asked": codec, "why": why, "codecs_found": codecs,
          "entries_above_floor": len(above), "floor_bytes": floor, "seconds": round(take_s, 3),
          "gbps": round(nbytes / GB / take_s, 3), "state_bytes": nbytes, "bytes_on_disk": on_disk,
          "disk_over_state": round(on_disk / nbytes, 4), "version": snapshot.metadata.version,
          "phases": phase_summary(stats)})
    if not take_ok:
        raise RuntimeError(f"compress_take: entries above the floor are framed {codecs}, not [{codec!r}]")
    seconds, mismatched, moved, stats = restore_check(torch, ts, path, app_state, ref, phase_stats)
    h2d = int(stats.get("h2d_land", {}).get("bytes", 0))
    ok = not mismatched and not moved and (h2d == nbytes or DEV != "cuda")
    emit({"phase": "compress_restore", "ok": ok, "seconds": round(seconds, 3), "gbps": round(nbytes / GB / seconds, 3),
          "bit_exact": not mismatched, "data_ptr_unchanged": not moved, "h2d_land_bytes": h2d,
          "mismatched": mismatched[:5], "phases": phase_summary(stats)})
    shutil.rmtree(os.path.dirname(path))
    if not ok:
        raise RuntimeError("compress_restore: not bit-exact in place, or h2d bytes differ")


def whole_chunk_bound(snap1, model, ref):
    """The bytes a take after ``mutate_step`` must write when payloads are
    whole chunks: all of wk, and the chunks of w_gate the changed rows touch."""
    entry = snap1.get_manifest()["0/model/layers/mlp/w_gate"]
    gate = model["layers"]["mlp"]["w_gate"]
    row_bytes = gate.numel() * 2 // gate.shape[0]
    rows = gate.numel() // gate.shape[-1]
    r0, n_rows = rows // 3, max(1, int(rows * CHANGED_ROW_FRACTION))
    lo = r0 * gate.shape[-1] * 2
    hi = (r0 + n_rows) * gate.shape[-1] * 2
    touched = sum(c.sizes[0] * row_bytes for c in entry.chunks
                  if c.offsets[0] * row_bytes < hi and (c.offsets[0] + c.sizes[0]) * row_bytes > lo)
    return ref["layers/attn/wk"].numel() * 2 + touched


def cas_take_phase(torch, ts, knobs, phase_stats, app_state, ref, nbytes, events, workdir, label, cdc):
    """Two CAS takes into <root>/step_0 and <root>/step_1 with the step
    change between them; the chunks step 1 added must be what it wrote,
    within the bound; step 1 restores bit-exact in place, and an unchanged
    tensor reads from step 0's chunks.  Returns the root, the state left
    at step 1."""
    from torchsnapshot_tpu_torch import cas

    root = os.path.join(workdir, label)
    model = app_state["model"].state_dict()
    max_chunk = knobs.get_cdc_params()[2]
    with knobs.override_cas(True), knobs.override_cdc(cdc):
        device_sync(torch)
        phase_stats.reset()
        begin = time.monotonic()
        ts.Snapshot.take(os.path.join(root, "step_0"), app_state)
        step0_s = time.monotonic() - begin
        step0_stats = phase_stats.snapshot()
        changed_bytes, regions = mutate_step(torch, model, ref)
        device_sync(torch)
        n_events = len(events)
        phase_stats.reset()
        begin = time.monotonic()
        snap1 = ts.Snapshot.take(os.path.join(root, "step_1"), app_state)
        step1_s = time.monotonic() - begin
        step1_stats = phase_stats.snapshot()
    end = [e.metadata for e in events[n_events:] if e.name == "take.end"][-1]
    stats = end["cas"]
    refs = {s: cas.referenced_chunk_relpaths(ts.Snapshot(os.path.join(root, s)).metadata.manifest)
            for s in ("step_0", "step_1")}
    new_chunks = refs["step_1"] - refs["step_0"]
    new_bytes = sum(os.path.getsize(os.path.join(root, rel)) for rel in new_chunks)
    if cdc:
        bound = changed_bytes + regions * 2 * max_chunk
    else:
        bound = whole_chunk_bound(snap1, model, ref)
    seconds, mismatched, moved, rstats = restore_check(torch, ts, os.path.join(root, "step_1"), app_state, ref,
                                                       phase_stats)
    unchanged = "layers/attn/wq"

    def locations(snap):
        entry = snap.get_manifest()[f"0/model/{unchanged}"]
        return [c.tensor.location for c in entry.chunks] if hasattr(entry, "chunks") else [entry.location]

    same_chunks = locations(ts.Snapshot(os.path.join(root, "step_0"))) == locations(snap1)
    read = ts.Snapshot(os.path.join(root, "step_1")).read_object(f"0/model/{unchanged}")
    device_sync(torch)
    read_ok = read.device.type == DEV and bit_equal(torch, read, ref[unchanged]) and same_chunks
    del read
    ok = (not mismatched and not moved and read_ok and stats["physical_bytes_written"] == new_bytes
          and 0 < new_bytes <= bound)
    emit({"phase": label, "ok": ok, "cdc": cdc, "version": snap1.metadata.version,
          "step0_s": round(step0_s, 3), "step0_gbps": round(nbytes / GB / step0_s, 3),
          "step1_s": round(step1_s, 3), "changed_bytes": changed_bytes, "step1_bytes_written":
          stats["physical_bytes_written"], "step1_new_chunk_bytes": new_bytes, "step1_new_chunks": len(new_chunks),
          "bound_bytes": bound, "prestage": {k: stats[f"prestage_{k}"] for k in ("probed", "hits", "bytes")},
          "dedup_hits": stats["dedup_hits"], "cdc_chunks": stats["cdc_chunks"],
          "chunks_in_root": len(refs["step_0"] | refs["step_1"]),
          "restore_s": round(seconds, 3), "bit_exact": not mismatched, "data_ptr_unchanged": not moved,
          "read_object_unchanged_from_step0_chunks": read_ok, "mismatched": mismatched[:5],
          "step0_phases": phase_summary(step0_stats), "step1_phases": phase_summary(step1_stats),
          "restore_phases": phase_summary(rstats)})
    if not ok:
        raise RuntimeError(f"{label}: step 1 wrote other bytes than its new chunks, past the bound, "
                           "or did not restore bit-exact")
    return root


def compare_model_entries(sync_m, other_m):
    """(model keys compared, keys aliasing equal bytes, keys that differ)
    between a sync take's manifest and another of the same state.  Leaves
    with identical bytes (the norms are all ones) share one digest, so the
    sync take's prestage may point one at the other's equal bytes: such
    entries must agree in everything but location and byte range."""
    from torchsnapshot_tpu_torch.manifest import _entry_to_dict

    def strip(d):
        return {f: v for f, v in d.items() if f not in ("location", "byte_range")}

    model_keys = sorted(k for k in sync_m if "/model/" in k)
    aliased, differ = [], []
    for k in model_keys:
        a, b = (_entry_to_dict(other_m[k]) if k in other_m else None), _entry_to_dict(sync_m[k])
        if a == b:
            continue
        if a is not None and a.get("checksum") and strip(a) == strip(b):
            aliased.append(k)
        else:
            differ.append(k)
    return model_keys, aliased, differ


def async_cas_phase(torch, ts, knobs, phase_stats, app_state, ref, nbytes, root):
    """async_take in pinned_host mode with CAS into <root>/step_2 (the state
    of step_1): its manifest equals the sync take's entry by entry."""
    device_sync(torch)
    phase_stats.reset()
    with knobs.override_cas(True), knobs.override_async_staging("pinned_host"):
        begin = time.monotonic()
        pending = ts.Snapshot.async_take(os.path.join(root, "step_2"), app_state)
        stall_s = time.monotonic() - begin
        pending.wait()
        total_s = time.monotonic() - begin
    stats = phase_stats.snapshot()
    sync_m = ts.Snapshot(os.path.join(root, "step_1")).get_manifest()
    async_m = ts.Snapshot(os.path.join(root, "step_2")).get_manifest()
    model_keys, aliased, differ = compare_model_entries(sync_m, async_m)
    seconds, mismatched, moved, _ = restore_check(torch, ts, os.path.join(root, "step_2"), app_state, ref,
                                                  phase_stats)
    ok = pending.staging_mode == "pinned_host" and not differ and not mismatched and not moved
    emit({"phase": "async_cas", "ok": ok, "staging_mode": pending.staging_mode, "stall_s": round(stall_s, 4),
          "total_s": round(total_s, 3), "model_entries_compared": len(model_keys), "entries_differ": differ[:5],
          "entries_aliasing_equal_bytes": aliased,
          "restore_s": round(seconds, 3), "bit_exact": not mismatched, "data_ptr_unchanged": not moved,
          "phases": phase_summary(stats)})
    if not ok:
        raise RuntimeError("async_cas: manifest differs from the sync take's, wrong mode, or not bit-exact")


def incremental_phase(torch, ts, knobs, phase_stats, app_state, ref, nbytes, events, workdir):
    """incremental_take: step 1 with incremental_from=step_0 and CAS off;
    every payload whose checksum did not change is a hard link, and the
    bytes written are within the whole-chunk bound of the change."""
    from torchsnapshot_tpu_torch import faults
    from torchsnapshot_tpu_torch.incremental import checksums_by_location

    root = os.path.join(workdir, "incremental")
    model = app_state["model"].state_dict()
    ts.Snapshot.take(os.path.join(root, "step_0"), app_state)
    changed_bytes, _ = mutate_step(torch, model, ref)
    device_sync(torch)
    n_events = len(events)
    phase_stats.reset()
    faults.reset_write_counters()
    with knobs.override_faults("none"):
        begin = time.monotonic()
        snap1 = ts.Snapshot.take(os.path.join(root, "step_1"), app_state,
                                 incremental_from=os.path.join(root, "step_0"))
        step1_s = time.monotonic() - begin
    stats = phase_stats.snapshot()
    written = sum(n for p, n in faults.write_counters().items() if payload_file(p))
    end = [e.metadata for e in events[n_events:] if e.name == "take.end"][-1]
    bound = whole_chunk_bound(snap1, model, ref)
    base = checksums_by_location(ts.Snapshot(os.path.join(root, "step_0")).metadata)
    unchanged = sum(1 for loc, c in checksums_by_location(snap1.metadata).items() if base.get(loc) == c)
    seconds, mismatched, moved, _ = restore_check(torch, ts, os.path.join(root, "step_1"), app_state, ref,
                                                  phase_stats)
    mutate_step(torch, app_state["model"].state_dict(), ref)  # back to step 0's state
    ok = (not mismatched and not moved and end["incremental_links"] == unchanged > 0
          and 0 < written <= bound)
    emit({"phase": "incremental_take", "ok": ok, "step1_s": round(step1_s, 3), "hard_links": end["incremental_links"],
          "unchanged_payloads": unchanged, "bytes_written": written, "bound_bytes": bound,
          "changed_bytes": changed_bytes, "state_bytes": nbytes,
          "restore_s": round(seconds, 3), "bit_exact": not mismatched, "data_ptr_unchanged": not moved,
          "phases": phase_summary(stats)})
    shutil.rmtree(root)
    if not ok:
        raise RuntimeError("incremental_take: an unchanged payload was not linked, bytes written past the "
                           "bound, or not bit-exact")


def storage_phases(torch, ts, knobs, phase_stats, app_state, ref, nbytes, events, workdir):
    compress_phases(torch, ts, knobs, phase_stats, app_state, ref, nbytes, workdir)
    root = cas_take_phase(torch, ts, knobs, phase_stats, app_state, ref, nbytes, events, workdir, "cas_take", False)
    async_cas_phase(torch, ts, knobs, phase_stats, app_state, ref, nbytes, root)
    mutate_step(torch, app_state["model"].state_dict(), ref)  # back to step 0's state
    shutil.rmtree(root)
    root = cas_take_phase(torch, ts, knobs, phase_stats, app_state, ref, nbytes, events, workdir, "cdc_take", True)
    mutate_step(torch, app_state["model"].state_dict(), ref)
    shutil.rmtree(root)
    incremental_phase(torch, ts, knobs, phase_stats, app_state, ref, nbytes, events, workdir)


# ---------------------------------------------------------- manager phases
#
# SnapshotManager in journal mode over the full state, in one root that the
# two phases share and the second removes: a base, segments of the step
# change, a fold, replayed restores, last-good fallback, gc, and an async
# segment.  Each step XORs the changed regions with its own pattern, so no
# two steps hold the same state.

JOURNAL_PATTERNS = (-1, 0x5555, 0x3333, 0x0F0F, 0x00FF)


def committed_refs(ts, root):
    """{root-relative marker: referenced chunk paths} of every committed
    step and segment under ``root``, and each chunk's size as the manifests
    state it (whole-chunk tensor entries and casx parts; slab members do not
    state their chunk's size)."""
    from torchsnapshot_tpu_torch import cas, journal
    from torchsnapshot_tpu_torch.manifest import SnapshotMetadata, iter_payload_entries
    from torchsnapshot_tpu_torch.storage_plugin import url_to_storage_plugin

    storage = url_to_storage_plugin(root)
    refs, sizes = {}, {}
    try:
        for marker in cas.committed_marker_relpaths(storage):
            with open(os.path.join(root, marker)) as f:
                manifest = SnapshotMetadata.from_json(f.read()).manifest
            refs[marker] = cas.referenced_chunk_relpaths(manifest)
            for _, entry in iter_payload_entries(manifest):
                if cas.is_casx_location(entry.location):
                    for algo, hexdigest, n in cas.parse_casx_location(entry.location):
                        sizes[cas.chunk_relpath(algo, hexdigest)] = n
                elif cas.is_cas_location(entry.location) and getattr(entry, "byte_range", None) is None:
                    sizes[cas.relpath_for_location(entry.location)] = journal.entry_logical_bytes(entry)
    finally:
        storage.sync_close()
    return refs, sizes


def chunks_on_disk(root):
    out = {}
    for dirpath, _, files in os.walk(os.path.join(root, "cas")):
        for name in files:
            full = os.path.join(dirpath, name)
            out[os.path.relpath(full, root)] = os.path.getsize(full)
    return out


def manager_journal_phase(torch, ts, knobs, phase_stats, app_state, ref, nbytes, events, workdir):
    """SnapshotManager(root, max_to_keep=1, journal=True) with
    TPUSNAP_JOURNAL_MAX_SEGMENTS=3: step 0 (the base), steps 1-3 (segments;
    the third trips the fold into step_3, and retention prunes step_0),
    step 4 (a segment over the folded base).  Checks: each segment wrote
    its new chunks within the whole-chunk bound; the fold wrote no payload
    byte; the fold and the prune reclaimed exactly the chunks step_3 does
    not reference; restore_latest (seg 4) and restore_at(3) are bit-exact
    in place; a corrupt seg 4 falls back to step 3 with the fallback
    events; with seg 4 removed, gc_detail reclaims exactly its own chunks.
    Returns the root, the state left at step 3."""
    from torchsnapshot_tpu_torch import faults
    from torchsnapshot_tpu_torch.manager import SnapshotManager

    root = os.path.join(workdir, "manager")
    model = app_state["model"].state_dict()
    saves, folds = [], []
    with knobs.override_journal_max_segments(3), knobs.override_faults("none"):
        mgr = SnapshotManager(root, max_to_keep=1, journal=True)
        compact = mgr._compact_journal_locked

        def timed_compact(st):
            # The fold's seconds and the files it wrote, from the byte meter.
            before = dict(faults.write_counters())
            begin = time.monotonic()
            try:
                return compact(st)
            finally:
                seconds = time.monotonic() - begin
                wrote = {p: n - before.get(p, 0) for p, n in faults.write_counters().items() if n != before.get(p)}
                folds.append({"seconds": seconds, "files_written": wrote,
                              "payload_bytes": sum(n for p, n in wrote.items() if payload_file(p))})

        mgr._compact_journal_locked = timed_compact
        for step in range(5):
            if step == 3:
                refs_before, sizes_before = committed_refs(ts, root)
                disk_before = chunks_on_disk(root)
            changed = mutate_step(torch, model, ref, JOURNAL_PATTERNS[step - 1]) if step else (0, 0)
            device_sync(torch)
            n_events = len(events)
            faults.reset_write_counters()
            phase_stats.reset()
            begin = time.monotonic()
            snap = mgr.save(step, app_state)
            wall = time.monotonic() - begin
            stats = phase_stats.snapshot()
            new_events = events[n_events:]
            cas_stats = [e.metadata for e in new_events if e.name == "take.end"][-1]["cas"]
            commit = [e.metadata for e in new_events if e.name == "journal.commit"]
            saves.append({
                "step": step, "kind": "seg" if step else "base", "wall_s": round(wall, 3),
                "bytes_written": cas_stats["physical_bytes_written"],
                "payload_bytes_metered": sum(n for p, n in faults.write_counters().items() if payload_file(p)),
                "changed_bytes": changed[0],
                "bound_bytes": whole_chunk_bound(snap, model, ref) if step else None,
                "prestage_delta_wall_s": round(stats.get("prestage_delta", {}).get("wall", 0.0), 4),
                "prestage": {k: cas_stats[f"prestage_{k}"] for k in ("probed", "hits", "bytes")},
                "entries_delta": commit[-1]["entries_delta"] if commit else None,
                "entries_total": commit[-1]["entries_total"] if commit else None,
                "delta_bytes": commit[-1]["delta_bytes"] if commit else None,
                "folded": any(e.name == "journal.compaction" for e in new_events),
                "phases": phase_summary(stats)})
            if step == 3:
                step3_files = sorted(os.listdir(os.path.join(root, "step_3")))
        points = mgr.restore_points()
    refs_after, _ = committed_refs(ts, root)
    disk_after = chunks_on_disk(root)
    fold_reclaimed = sorted(set(disk_before) - set(disk_after))
    fold_expected = sorted(set().union(*refs_before.values()) - refs_after["step_3/.snapshot_metadata"])
    fold_reclaimed_bytes = sum(disk_before[c] for c in fold_reclaimed)
    fold_manifest_bytes = sum(sizes_before.get(c, -1) for c in fold_expected)
    segs_ok = all(s["bytes_written"] == s["payload_bytes_metered"] and 0 < s["bytes_written"] <= s["bound_bytes"]
                  for s in saves[1:])
    fold_ok = (len(folds) == 1 and folds[0]["payload_bytes"] == 0 and saves[3]["folded"]
               and step3_files == [".snapshot_metadata"] and points == [(3, "full"), (4, "seg")]
               and fold_reclaimed == fold_expected and fold_reclaimed_bytes == fold_manifest_bytes)

    # Replayed restores: seg 4 (the newest point), then step 3.
    mgr = SnapshotManager(root, max_to_keep=1, journal=True)
    landed = []
    latest_s, latest_bad, latest_moved, latest_stats = restore_check(
        torch, ts, None, app_state, ref, phase_stats, restore_fn=lambda a: landed.append(mgr.restore_latest(a)))
    mutate_step(torch, model, ref, JOURNAL_PATTERNS[3])  # state and reference back to step 3
    at3_s, at3_bad, at3_moved, _ = restore_check(torch, ts, None, app_state, ref, phase_stats,
                                                 restore_fn=lambda a: landed.append(mgr.restore_at(3, a)))
    restores_ok = landed == [4, 3] and not (latest_bad or latest_moved or at3_bad or at3_moved)

    # A corrupt seg 4: restore_latest falls back to step 3.
    seg4_refs, seg4_sizes = committed_refs(ts, root)
    seg4_only = sorted(seg4_refs["seg_4/.snapshot_metadata"] - seg4_refs["step_3/.snapshot_metadata"])
    with open(os.path.join(root, "seg_4", ".snapshot_metadata"), "w") as f:
        f.write("{corrupt")
    n_events = len(events)
    fb_s, fb_bad, fb_moved, _ = restore_check(torch, ts, None, app_state, ref, phase_stats,
                                              restore_fn=lambda a: landed.append(mgr.restore_latest(a)))
    fb_step = landed[-1]
    fb_events = sorted({e.name for e in events[n_events:] if e.name.endswith(".fallback")})
    fallback_ok = (fb_step == 3 and not fb_bad and not fb_moved
                   and fb_events == ["journal.fallback", "restore_latest.fallback"])

    # gc: with the corrupt segment removed, gc_detail names and reclaims
    # exactly the chunks only seg 4 referenced.
    shutil.rmtree(os.path.join(root, "seg_4"))
    disk_before_gc = chunks_on_disk(root)
    dry = mgr.gc_detail(apply=False)
    begin = time.monotonic()
    applied = mgr.gc_detail(apply=True)
    gc_s = time.monotonic() - begin
    gc_bytes_disk = sum(disk_before_gc[c] for c in applied[1])
    gc_bytes_manifest = sum(seg4_sizes.get(c, -1) for c in seg4_only)
    gc_ok = (dry == applied == ([], seg4_only, []) and bool(seg4_only) and gc_bytes_disk == gc_bytes_manifest
             and set(chunks_on_disk(root)) == set(disk_before_gc) - set(seg4_only))
    ok = segs_ok and fold_ok and restores_ok and fallback_ok and gc_ok
    emit({"phase": "manager_journal", "ok": ok, "max_to_keep": 1, "journal_max_segments": 3, "saves": saves,
          "segments_ok": segs_ok, "fold_ok": fold_ok, "fold_s": round(folds[0]["seconds"], 4) if folds else None,
          "fold_files_written": folds[0]["files_written"] if folds else None,
          "fold_step3_files": step3_files, "restore_points_after_step4": points,
          "fold_and_prune_reclaimed_chunks": len(fold_reclaimed), "fold_and_prune_reclaimed_bytes": fold_reclaimed_bytes,
          "fold_and_prune_expected_bytes_from_manifests": fold_manifest_bytes,
          "restore_latest_step": landed[0], "restore_latest_s": round(latest_s, 3),
          "restore_latest_bit_exact": not latest_bad, "restore_latest_data_ptr_unchanged": not latest_moved,
          "restore_latest_phases": phase_summary(latest_stats),
          "restore_at_3_s": round(at3_s, 3), "restore_at_3_bit_exact": not at3_bad,
          "fallback_step": fb_step, "fallback_s": round(fb_s, 3), "fallback_events": fb_events,
          "fallback_bit_exact": not fb_bad,
          "gc_reclaimed_chunks": applied[1], "gc_expected_chunks": seg4_only, "gc_reclaimed_bytes": gc_bytes_disk,
          "gc_expected_bytes_from_manifest": gc_bytes_manifest, "gc_s": round(gc_s, 4)})
    if not ok:
        raise RuntimeError("manager_journal: a segment past its bound, a fold that wrote payload, reclamation "
                           "other than the unreferenced chunks, a restore not bit-exact, or no fallback to step 3")
    return root


def manager_async_journal_phase(torch, ts, knobs, phase_stats, app_state, ref, nbytes, root):
    """A fresh journal manager on the root (chain read back from storage,
    base step_3) saves step 5 with ``async_=True`` in pinned_host mode;
    every tensor changes in place right after the return.  Its segment
    manifest must equal, entry by entry, the sync segment of the same
    change: a sync CAS take of the same state filtered by the journal's
    delta against the same chain (an entry absent from one delta resolves
    to the base).  restore_latest replays it bit-exact.  Removes the root."""
    from torchsnapshot_tpu_torch import journal
    from torchsnapshot_tpu_torch.manager import SnapshotManager
    from torchsnapshot_tpu_torch.storage_plugin import url_to_storage_plugin

    model = app_state["model"].state_dict()
    mgr = SnapshotManager(root, journal=True)
    mutate_step(torch, model, ref, JOURNAL_PATTERNS[4])
    device_sync(torch)
    phase_stats.reset()
    with knobs.override_async_staging("pinned_host"):
        begin = time.monotonic()
        pending = mgr.save(5, app_state, async_=True)
        stall_s = time.monotonic() - begin
    for p in ref:
        get_leaf(model, p).view(torch.int16).bitwise_not_()
    pending.wait()
    total_s = time.monotonic() - begin
    stats = phase_stats.snapshot()
    for p in ref:
        get_leaf(model, p).view(torch.int16).bitwise_not_()  # back to step 5's state
    storage = url_to_storage_plugin(root)
    try:
        seg = journal.read_segment_metadata(storage, 5)
        base_view = journal.view_of(journal._read_metadata(storage, "step_3/.snapshot_metadata").manifest)
    finally:
        storage.sync_close()
    with knobs.override_cas(True):
        device_sync(torch)
        begin = time.monotonic()
        sync_md = ts.Snapshot.take(os.path.join(root, "sync_5"), app_state).metadata
        sync_s = time.monotonic() - begin
    sync_seg = journal.compute_delta(sync_md, base_view, 3, [])
    base = journal.manifest_of(base_view)
    keys = sorted(set(seg.manifest) | set(sync_seg.manifest))
    _, aliased, differ = compare_model_entries(
        {k: sync_seg.manifest.get(k, base.get(k)) for k in keys}, {k: seg.manifest.get(k, base.get(k)) for k in keys})
    differ += [k for k in keys if "/model/" not in k and (k in seg.manifest) != (k in sync_seg.manifest)]
    shutil.rmtree(os.path.join(root, "sync_5"))
    landed = []
    seconds, mismatched, moved, rstats = restore_check(torch, ts, None, app_state, ref, phase_stats,
                                                       restore_fn=lambda a: landed.append(mgr.restore_latest(a)))
    ok = (pending.staging_mode == "pinned_host" and seg.journal["base_step"] == 3 and not differ
          and landed == [5] and not mismatched and not moved)
    emit({"phase": "manager_async_journal", "ok": ok, "staging_mode": pending.staging_mode,
          "stall_s": round(stall_s, 4), "total_s": round(total_s, 3),
          "segment": journal.sidecar_summary(seg.journal), "sync_segment": journal.sidecar_summary(sync_seg.journal),
          "sync_take_s": round(sync_s, 3), "entries_compared": len(keys), "entries_differ": differ[:5],
          "entries_aliasing_equal_bytes": aliased, "restored_step": landed,
          "restore_s": round(seconds, 3), "bit_exact": not mismatched, "data_ptr_unchanged": not moved,
          "phases": phase_summary(stats), "restore_phases": phase_summary(rstats)})
    shutil.rmtree(root)
    if not ok:
        raise RuntimeError("manager_async_journal: wrong mode, the segment differs from the sync segment of the "
                           "same change, or the replayed restore is not bit-exact")


def manager_phases(torch, ts, knobs, phase_stats, app_state, ref, nbytes, events, workdir):
    root = manager_journal_phase(torch, ts, knobs, phase_stats, app_state, ref, nbytes, events, workdir)
    manager_async_journal_phase(torch, ts, knobs, phase_stats, app_state, ref, nbytes, root)


# ------------------------------------------------------ distributed phases
#
# Several ranks share the one card: spawned processes (CUDA cannot be
# forked), each on cuda:0, joined in a gloo group (NCCL refuses two ranks
# on one device; the library uses the group only to bootstrap its store).
# Every rank builds its boxes of the Llama-3-8B parameter set from a
# per-tensor seed and the global index (seeded_fill), never from a copy of
# the whole tensor, and checks restored boxes against the same function.

DEV = "cuda"
DIST_TIMEOUT_S = 600
FILL_BLOCK_ELEMS = 1 << 26


def device_sync(torch) -> None:
    if DEV == "cuda":
        torch.cuda.synchronize()


def seeded_fill(torch, out, seed: int, global_shape, offsets, check: bool = False) -> bool:
    """Write (or, with ``check``, compare against) the seeded bf16 values of
    the box at ``offsets`` of a tensor of ``global_shape``: a hash of the
    global linear index and the seed, with a fixed exponent, so every value
    is finite.  Computed on the card in blocks of rows."""
    ndim = len(global_shape)
    strides = [1] * ndim
    for d in range(ndim - 2, -1, -1):
        strides[d] = strides[d + 1] * global_shape[d + 1]
    sizes = list(out.shape)
    if not all(sizes):
        return True
    inner = 1
    for x in sizes[1:]:
        inner *= x
    rows = max(1, FILL_BLOCK_ELEMS // max(inner, 1))
    for r0 in range(0, sizes[0], rows):
        r1 = min(sizes[0], r0 + rows)
        lin = (torch.arange(r0, r1, device=DEV) + offsets[0]) * strides[0]
        lin = lin.reshape([-1] + [1] * (ndim - 1))
        for d in range(1, ndim):
            idx = (torch.arange(sizes[d], device=DEV) + offsets[d]) * strides[d]
            lin = lin + idx.reshape([1] * d + [-1] + [1] * (ndim - 1 - d))
        x = lin * 2654435761 + seed * 40503
        x = x ^ (x >> 13)
        x = x * 1274126177
        x = x ^ (x >> 16)
        bits = ((x & 0x80FF) | 0x3E00).to(torch.int16)
        block = out[r0:r1].view(torch.int16)
        if check:
            if not torch.equal(block, bits):
                return False
        else:
            block.copy_(bits)
    return True


def tensor_seed(seed: int, path) -> int:
    return seed * 1000 + [p for p, _, _ in llama_shapes(N_LAYERS)].index(path)


def make_mesh(torch, shape, names):
    """init_device_mesh, or a DeviceMesh built by hand where init_device_mesh
    refuses several ranks on one device."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    try:
        return init_device_mesh(DEV, tuple(shape), mesh_dim_names=tuple(names)), "init_device_mesh"
    except Exception as e:  # noqa: BLE001 — reported in the phase line
        n = 1
        for x in shape:
            n *= x
        mesh = DeviceMesh(DEV, torch.arange(n).reshape(tuple(shape)), mesh_dim_names=tuple(names))
        return mesh, f"DeviceMesh ({type(e).__name__}: {e})"


def dist_state(torch, ts, mesh, placements_of, seed: int, zero: bool = False):
    """The Llama-3-8B parameter set as DTensors on ``mesh``; each rank fills
    only its own box (zeros with ``zero``)."""
    from torch.distributed.tensor import DTensor

    from torchsnapshot_tpu_torch import staging

    params: dict = {}
    for path, shape, scale in llama_shapes(N_LAYERS):
        placements = placements_of(path, scale)
        offsets, sizes = staging.box_at(shape, mesh.shape, mesh.get_coordinate(), placements)
        local = torch.empty(sizes, dtype=torch.bfloat16, device=DEV)
        if zero:
            local.zero_()
        else:
            seeded_fill(torch, local, tensor_seed(seed, path), shape, offsets)
        dt = DTensor.from_local(local, mesh, placements, run_check=False, shape=torch.Size(shape),
                                stride=torch.empty(shape, device="meta").stride())
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = dt
    return params


def dist_check(torch, params, seed: int, seeds=None):
    """Paths whose local box differs from the seeded values (``seeds``:
    per-path seeds that replace the default)."""
    from torchsnapshot_tpu_torch import staging

    bad = []
    for path, shape, _ in llama_shapes(N_LAYERS):
        node = params
        for key in path:
            node = node[key]
        offsets, _ = staging.local_box(node)
        path_seed = (seeds or {}).get(path, tensor_seed(seed, path))
        if not seeded_fill(torch, node.to_local(), path_seed, shape, offsets, check=True):
            bad.append("/".join(path))
    return bad


def dist_locals(params):
    return [dt.to_local() for _, dt in leaves(params)]


def host_memory(torch):
    free, total = torch.cuda.mem_get_info() if DEV == "cuda" else (0, 0)
    with open("/proc/meminfo") as f:
        avail = next(int(line.split()[1]) * 1024 for line in f if line.startswith("MemAvailable:"))
    return {"mem_available_bytes": avail, "cuda_free_bytes": int(free), "cuda_total_bytes": int(total)}


def dist_job_hsdp(torch, ts, rank, world, seed, workdir):
    """Four ranks, a 2x2 ("replicate", "shard") mesh: weights HSDP
    [Replicate(), Shard(0)], the norms fully Replicate.  dist_take,
    dist_restore (zero, restore in place), dist_cas_take (two CAS takes
    with wk changed between them, restore), dist_async_take (mutate after
    return, wait, restore)."""
    from torch.distributed.tensor import Replicate, Shard

    from torchsnapshot_tpu_torch import event_handlers, faults, knobs, phase_stats, staging
    from torchsnapshot_tpu_torch.pg_wrapper import PGWrapper
    from torchsnapshot_tpu_torch.scheduler import get_process_memory_budget_bytes

    out = {}
    mesh, mesh_ctor = make_mesh(torch, (2, 2), ("replicate", "shard"))
    params = dist_state(torch, ts, mesh, lambda path, scale: [Replicate(), Replicate()] if scale is None
                        else [Replicate(), Shard(0)], seed)
    app_state = {"model": ts.StateDict(params), "train": ts.StateDict({"step": 1000}), "rng": ts.RNGState()}
    local_bytes = sum(t.numel() * t.element_size() for t in dist_locals(params))
    pg = PGWrapper.from_torch()
    budget = get_process_memory_budget_bytes(pg)
    events: list = []
    event_handlers.register_event_handler(events.append)

    # dist_take
    mem = host_memory(torch)
    device_sync(torch)
    pg.barrier()
    phase_stats.reset()
    begin = time.monotonic()
    ts.Snapshot.take(os.path.join(workdir, "dist_snap"), app_state, pg=pg, replicated=["train/step"])
    take_s = time.monotonic() - begin
    ends = [e.metadata for e in events if e.name == "take.end"]
    out["dist_take"] = {"seconds": take_s, "bytes_written": ends[-1]["bytes"], "local_bytes": local_bytes,
                        "memory_budget_bytes": budget, "mesh": mesh_ctor, "mem_at_start": mem,
                        "phases": phase_summary(phase_stats.snapshot())}

    # dist_restore: zero every local tensor, restore in place.
    for t in dist_locals(params):
        t.zero_()
    ptrs = [t.data_ptr() for t in dist_locals(params)]
    mem = host_memory(torch)
    device_sync(torch)
    pg.barrier()
    phase_stats.reset()
    begin = time.monotonic()
    ts.Snapshot(os.path.join(workdir, "dist_snap"), pg=pg).restore(app_state)
    device_sync(torch)
    restore_s = time.monotonic() - begin
    stats = phase_stats.snapshot()
    moved = sum(a != t.data_ptr() for a, t in zip(ptrs, dist_locals(params)))
    out["dist_restore"] = {"seconds": restore_s, "mismatched": dist_check(torch, params, seed),
                           "data_ptr_moved": moved, "step": app_state["train"]["step"],
                           "h2d_bytes": int(stats.get("h2d_dispatch", {}).get("bytes", 0)),
                           "local_bytes": local_bytes, "mem_at_start": mem, "phases": phase_summary(stats)}

    # dist_cas_take: two CAS takes into <root>/step_0 and step_1, with every
    # box of wk refilled from another seed between them; then step 1
    # restores in place, and wk is refilled with its own values again.
    # Rank 0 removes the root before the async take: the machine's disk
    # holds about two copies of the state at a time.
    root = os.path.join(workdir, "dist_cas")
    wk_path = ("layers", "attn", "wk")
    wk = params["layers"]["attn"]["wk"]
    wk_seed = tensor_seed(seed, wk_path) + 7
    with knobs.override_cas(True):
        device_sync(torch)
        pg.barrier()
        begin = time.monotonic()
        ts.Snapshot.take(os.path.join(root, "step_0"), app_state, pg=pg, replicated=["train/step"])
        step0_s = time.monotonic() - begin
        offsets, _ = staging.local_box(wk)
        seeded_fill(torch, wk.to_local(), wk_seed, tuple(wk.shape), offsets)
        device_sync(torch)
        pg.barrier()
        n_events = len(events)
        phase_stats.reset()
        begin = time.monotonic()
        ts.Snapshot.take(os.path.join(root, "step_1"), app_state, pg=pg, replicated=["train/step"])
        step1_s = time.monotonic() - begin
        stats = phase_stats.snapshot()
    cas_stats = [e.metadata for e in events[n_events:] if e.name == "take.end"][-1]["cas"]
    for t in dist_locals(params):
        t.zero_()
    ptrs = [t.data_ptr() for t in dist_locals(params)]
    device_sync(torch)
    ts.Snapshot(os.path.join(root, "step_1"), pg=pg).restore(app_state)
    device_sync(torch)
    out["dist_cas_take"] = {"step0_s": step0_s, "step1_s": step1_s, "bytes_written": cas_stats["physical_bytes_written"],
                            "prestage": {k: cas_stats[f"prestage_{k}"] for k in ("probed", "hits", "bytes")},
                            "mismatched": dist_check(torch, params, seed, {wk_path: wk_seed}),
                            "data_ptr_moved": sum(a != t.data_ptr() for a, t in zip(ptrs, dist_locals(params))),
                            "phases": phase_summary(stats)}
    seeded_fill(torch, wk.to_local(), tensor_seed(seed, wk_path), tuple(wk.shape), offsets)
    device_sync(torch)
    pg.barrier()
    if rank == 0:
        shutil.rmtree(root)
    pg.barrier()

    # dist_manager_journal: a journal manager saves step 0 (the base), then,
    # with every box of wk refilled from another seed, step 1 (a segment);
    # restore_latest replays it in place on every rank, and wk gets its own
    # values back.  Rank 0 removes the root.
    from torchsnapshot_tpu_torch.manager import SnapshotManager

    root = os.path.join(workdir, "dist_manager")
    mgr = SnapshotManager(root, pg=pg, journal=True)
    device_sync(torch)
    pg.barrier()
    begin = time.monotonic()
    mgr.save(0, app_state, replicated=["train/step"])
    base_s = time.monotonic() - begin
    seeded_fill(torch, wk.to_local(), wk_seed, tuple(wk.shape), offsets)
    device_sync(torch)
    pg.barrier()
    n_events = len(events)
    phase_stats.reset()
    begin = time.monotonic()
    mgr.save(1, app_state, replicated=["train/step"])
    seg_s = time.monotonic() - begin
    stats = phase_stats.snapshot()
    cas_stats = [e.metadata for e in events[n_events:] if e.name == "take.end"][-1]["cas"]
    for t in dist_locals(params):
        t.zero_()
    ptrs = [t.data_ptr() for t in dist_locals(params)]
    device_sync(torch)
    pg.barrier()
    begin = time.monotonic()
    restored = mgr.restore_latest(app_state)
    device_sync(torch)
    restore_s = time.monotonic() - begin
    out["dist_manager_journal"] = {
        "base_s": base_s, "seg_s": seg_s, "restore_s": restore_s, "restored_step": restored,
        "bytes_written": cas_stats["physical_bytes_written"],
        "prestage": {k: cas_stats[f"prestage_{k}"] for k in ("probed", "hits", "bytes")},
        "mismatched": dist_check(torch, params, seed, {wk_path: wk_seed}),
        "data_ptr_moved": sum(a != t.data_ptr() for a, t in zip(ptrs, dist_locals(params))),
        "phases": phase_summary(stats)}
    seeded_fill(torch, wk.to_local(), tensor_seed(seed, wk_path), tuple(wk.shape), offsets)
    device_sync(torch)
    pg.barrier()
    if rank == 0:
        shutil.rmtree(root)
    pg.barrier()

    # dist_async_take (auto → pinned_host); the fault wrapper's byte meter
    # (a spec of "none") counts the commits.
    faults.reset_write_counters()
    mem = host_memory(torch)
    device_sync(torch)
    pg.barrier()
    phase_stats.reset()
    n_events = len(events)
    begin = time.monotonic()
    with knobs.override_faults("none"):
        pending = ts.Snapshot.async_take(os.path.join(workdir, "dist_async_snap"), app_state, pg=pg,
                                         replicated=["train/step"])
    stall_s = time.monotonic() - begin
    for t in dist_locals(params):
        t.view(torch.int16).bitwise_not_()
    pending.wait()
    total_s = time.monotonic() - begin
    stats = phase_stats.snapshot()
    ends = [e.metadata for e in events[n_events:] if e.name == "async_take.end"]
    commit_bytes = faults.write_counters().get(".snapshot_metadata", 0)
    for t in dist_locals(params):
        t.zero_()
    device_sync(torch)
    ts.Snapshot(os.path.join(workdir, "dist_async_snap"), pg=pg).restore(app_state)
    device_sync(torch)
    out["dist_async_take"] = {"stall_s": stall_s, "total_s": total_s, "staging_mode": pending.staging_mode,
                              "bytes_written": ends[-1]["bytes"], "commit_bytes_written": commit_bytes,
                              "mismatched": dist_check(torch, params, seed), "mem_at_start": mem,
                              "phases": phase_summary(stats)}

    event_handlers.unregister_event_handler(events.append)
    pg.barrier()
    return out


def dist_job_elastic(torch, ts, rank, world, seed, workdir):
    """A fresh world of two ranks on a 1-D mesh restores the four-rank
    snapshot with every tensor Shard on its last dim."""
    from torch.distributed.tensor import Shard

    from torchsnapshot_tpu_torch import phase_stats
    from torchsnapshot_tpu_torch.pg_wrapper import PGWrapper

    mesh, mesh_ctor = make_mesh(torch, (world,), ("shard",))
    params = dist_state(torch, ts, mesh, lambda path, scale: [Shard(-1)], seed, zero=True)
    app_state = {"model": ts.StateDict(params), "train": ts.StateDict({"step": -1})}
    pg = PGWrapper.from_torch()
    ptrs = [t.data_ptr() for t in dist_locals(params)]
    mem = host_memory(torch)
    device_sync(torch)
    pg.barrier()
    phase_stats.reset()
    begin = time.monotonic()
    ts.Snapshot(os.path.join(workdir, "dist_snap"), pg=pg).restore(app_state)
    device_sync(torch)
    seconds = time.monotonic() - begin
    stats = phase_stats.snapshot()
    moved = sum(a != t.data_ptr() for a, t in zip(ptrs, dist_locals(params)))
    pg.barrier()
    return {"dist_elastic_restore": {
        "seconds": seconds, "mismatched": dist_check(torch, params, seed), "data_ptr_moved": moved,
        "step": app_state["train"]["step"], "mesh": mesh_ctor, "mem_at_start": mem,
        "local_bytes": sum(t.numel() * t.element_size() for t in dist_locals(params)),
        "phases": phase_summary(stats)}}


DIST_JOBS = {"hsdp": dist_job_hsdp, "elastic": dist_job_elastic}


def dist_entry(job, rank, world, port, seed, workdir, conn) -> None:
    """A spawned rank: join the gloo group, run the job, send its results
    (or its traceback) to the parent."""
    import datetime
    import traceback

    try:
        import torch

        if DEV == "cuda":
            torch.cuda.set_device(0)
        sys.path.insert(0, HERE)
        import torchsnapshot_tpu_torch as ts

        torch.distributed.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S),
        )
        try:
            result = DIST_JOBS[job](torch, ts, rank, world, seed, workdir)
        finally:
            torch.distributed.destroy_process_group()
        conn.send({"ok": True, "result": result})
    except BaseException:  # noqa: BLE001 — the parent fails the phase
        conn.send({"ok": False, "error": traceback.format_exc()})


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def dist_launch(torch, job: str, world: int, args):
    """Run ``job`` on ``world`` spawned ranks; every rank's result, by rank.
    A rank that fails, dies or times out fails the phase, and every rank
    still running is stopped."""
    import torch.multiprocessing as tmp

    ctx = tmp.get_context("spawn")
    port = free_port()
    procs, conns = [], []
    for rank in range(world):
        parent, child = ctx.Pipe()
        p = ctx.Process(target=dist_entry, args=(job, rank, world, port, args.seed, args.workdir, child))
        p.start()
        procs.append(p)
        conns.append(parent)
    deadline = time.monotonic() + DIST_TIMEOUT_S
    results, errors = {}, {}
    try:
        while len(results) + len(errors) < world and time.monotonic() < deadline and not errors:
            for rank, (p, conn) in enumerate(zip(procs, conns)):
                if rank in results or rank in errors:
                    continue
                if conn.poll(0.05):
                    msg = conn.recv()
                    if msg["ok"]:
                        results[rank] = msg["result"]
                    else:
                        errors[rank] = msg["error"]
                elif not p.is_alive():
                    errors[rank] = f"exited with code {p.exitcode} before reporting"
    finally:
        for p in procs:
            p.join(timeout=30 if not errors else 5)
            if p.is_alive():
                p.kill()
                p.join()
    for rank in range(world):
        if rank not in results and rank not in errors:
            errors[rank] = "timed out" if time.monotonic() >= deadline else "stopped after a peer failed"
    if errors:
        raise RuntimeError(f"{job}: " + "; ".join(f"rank {r}: {e}" for r, e in sorted(errors.items())))
    return [results[r] for r in range(world)]


def snapshot_payload(ts, path: str):
    """(bytes of payload files on disk, bytes of the model tensors the
    manifest describes, each distinct stored piece counted once)."""
    from torchsnapshot_tpu_torch import serialization
    from torchsnapshot_tpu_torch.manifest import iter_payload_entries

    on_disk = dir_bytes(path)
    seen = set()
    tensor_bytes = 0
    for key, entry in iter_payload_entries(ts.Snapshot(path).get_manifest()):
        if "/model/" not in key or entry.serializer != "buffer_protocol":
            continue
        location = (entry.location, tuple(entry.byte_range or ()))
        if location not in seen:
            seen.add(location)
            tensor_bytes += serialization.array_nbytes(entry.shape, entry.dtype)
    return on_disk, tensor_bytes


def dist_phases(torch, ts, args) -> None:
    """dist_take, dist_restore, dist_async_take (four ranks),
    dist_elastic_restore (two ranks), dist_read_object (this process)."""
    global_bytes = state_bytes(N_LAYERS)
    emit({"phase": "dist_start", "ok": True, **host_memory(torch)})
    ranks = dist_launch(torch, "hsdp", 4, args)

    take = [r["dist_take"] for r in ranks]
    snap = os.path.join(args.workdir, "dist_snap")
    on_disk, tensor_bytes = snapshot_payload(ts, snap)
    written = sum(r["bytes_written"] for r in take)
    seconds = max(r["seconds"] for r in take)
    take_ok = written == on_disk and tensor_bytes == global_bytes and on_disk < global_bytes + (64 << 20)
    emit({"phase": "dist_take", "ok": take_ok, "ranks": 4, "mesh": "2x2 (replicate, shard)",
          "placements": "weights [Replicate(), Shard(0)], norms [Replicate(), Replicate()]",
          "mesh_ctor": take[0]["mesh"], "seconds": round(seconds, 3), "gbps": round(global_bytes / GB / seconds, 3),
          "state_bytes": global_bytes, "bytes_written_sum": written, "payload_bytes_on_disk": on_disk,
          "manifest_tensor_bytes": tensor_bytes,
          "per_rank": [{k: r[k] for k in ("seconds", "bytes_written", "local_bytes", "memory_budget_bytes",
                                          "mem_at_start", "phases")} for r in take]})
    if not take_ok:
        raise RuntimeError("dist_take: bytes written differ from the payload, or a replicated box was written twice")

    restore = [r["dist_restore"] for r in ranks]
    seconds = max(r["seconds"] for r in restore)
    restore_ok = all(not r["mismatched"] and r["data_ptr_moved"] == 0 and r["step"] == 1000 for r in restore)
    emit({"phase": "dist_restore", "ok": restore_ok, "ranks": 4, "seconds": round(seconds, 3),
          "gbps": round(sum(r["local_bytes"] for r in restore) / GB / seconds, 3),
          "per_rank": [{k: r[k] for k in ("seconds", "mismatched", "data_ptr_moved", "h2d_bytes", "local_bytes",
                                          "mem_at_start", "phases")} for r in restore]})
    if not restore_ok:
        raise RuntimeError("dist_restore: a rank is not bit-exact in place")

    async_ = [r["dist_async_take"] for r in ranks]
    async_snap = os.path.join(args.workdir, "dist_async_snap")
    on_disk_async, tensor_bytes_async = snapshot_payload(ts, async_snap)
    written_async = sum(r["bytes_written"] for r in async_)
    commit_size = os.path.getsize(os.path.join(async_snap, ".snapshot_metadata"))
    commits = sum(r["commit_bytes_written"] for r in async_)
    leftovers = [n for n in os.listdir(async_snap) if n.startswith(".manifest_rank_")]
    async_ok = (all(not r["mismatched"] and r["staging_mode"] == "pinned_host" for r in async_)
                and commits == commit_size and not leftovers and written_async == on_disk_async
                and tensor_bytes_async == global_bytes)
    emit({"phase": "dist_async_take", "ok": async_ok, "ranks": 4, "mode": "auto",
          "commit_bytes_written_sum": commits, "commit_file_bytes": commit_size, "sidecars_left": leftovers,
          "bytes_written_sum": written_async, "payload_bytes_on_disk": on_disk_async,
          "max_stall_s": round(max(r["stall_s"] for r in async_), 4),
          "max_total_s": round(max(r["total_s"] for r in async_), 3),
          "per_rank": [{k: r[k] for k in ("stall_s", "total_s", "staging_mode", "bytes_written", "mismatched",
                                          "mem_at_start", "phases")} for r in async_]})
    if not async_ok:
        raise RuntimeError("dist_async_take: not bit-exact, wrong mode, not one commit, or bytes differ")
    shutil.rmtree(async_snap)

    cas_ = [r["dist_cas_take"] for r in ranks]
    wk_shape = next(s for p, s, _ in llama_shapes(N_LAYERS) if p == ("layers", "attn", "wk"))
    changed = 2
    for x in wk_shape:
        changed *= x
    written = [r["bytes_written"] for r in cas_]
    cas_ok = all(not r["mismatched"] and r["data_ptr_moved"] == 0 for r in cas_) and sum(written) == changed
    emit({"phase": "dist_cas_take", "ok": cas_ok, "ranks": 4, "changed": "layers/attn/wk, every box",
          "changed_bytes": changed, "step1_bytes_written_sum": sum(written), "step1_bytes_written_per_rank": written,
          "max_step0_s": round(max(r["step0_s"] for r in cas_), 3),
          "max_step1_s": round(max(r["step1_s"] for r in cas_), 3),
          "per_rank": [{k: r[k] for k in ("step0_s", "step1_s", "bytes_written", "prestage", "mismatched",
                                          "data_ptr_moved", "phases")} for r in cas_]})
    if not cas_ok:
        raise RuntimeError("dist_cas_take: step 1 wrote other bytes than the changed boxes, or not bit-exact")

    mgr_ = [r["dist_manager_journal"] for r in ranks]
    written = [r["bytes_written"] for r in mgr_]
    mgr_ok = (all(not r["mismatched"] and r["data_ptr_moved"] == 0 and r["restored_step"] == 1 for r in mgr_)
              and sum(written) == changed)
    emit({"phase": "dist_manager_journal", "ok": mgr_ok, "ranks": 4, "changed": "layers/attn/wk, every box",
          "changed_bytes": changed, "seg_bytes_written_sum": sum(written), "seg_bytes_written_per_rank": written,
          "max_base_s": round(max(r["base_s"] for r in mgr_), 3), "max_seg_s": round(max(r["seg_s"] for r in mgr_), 3),
          "max_restore_s": round(max(r["restore_s"] for r in mgr_), 3),
          "per_rank": [{k: r[k] for k in ("base_s", "seg_s", "restore_s", "restored_step", "bytes_written", "prestage",
                                          "mismatched", "data_ptr_moved", "phases")} for r in mgr_]})
    if not mgr_ok:
        raise RuntimeError("dist_manager_journal: the segment wrote other bytes than wk's boxes, or the replayed "
                           "restore is not bit-exact in place on every rank")

    elastic = [r["dist_elastic_restore"] for r in dist_launch(torch, "elastic", 2, args)]
    seconds = max(r["seconds"] for r in elastic)
    elastic_ok = all(not r["mismatched"] and r["data_ptr_moved"] == 0 and r["step"] == 1000 for r in elastic)
    emit({"phase": "dist_elastic_restore", "ok": elastic_ok, "ranks": 2, "mesh": "1-D (shard,)",
          "placements": "every tensor [Shard(-1)]", "mesh_ctor": elastic[0]["mesh"],
          "seconds": round(seconds, 3), "gbps": round(global_bytes / GB / seconds, 3),
          "per_rank": [{k: r[k] for k in ("seconds", "mismatched", "data_ptr_moved", "local_bytes",
                                          "mem_at_start", "phases")} for r in elastic]})
    if not elastic_ok:
        raise RuntimeError("dist_elastic_restore: a rank is not bit-exact")

    # dist_read_object: the largest sharded entry, whole, onto the card.
    path = ("layers", "mlp", "w_gate")
    shape = next(s for p, s, _ in llama_shapes(N_LAYERS) if p == path)
    mem = host_memory(torch)
    device_sync(torch)
    begin = time.monotonic()
    w = ts.Snapshot(snap).read_object("0/model/" + "/".join(path), device=DEV)
    device_sync(torch)
    seconds = time.monotonic() - begin
    nbytes = w.numel() * w.element_size()
    read_ok = (w.device.type == DEV and list(w.shape) == list(shape)
               and seeded_fill(torch, w, tensor_seed(args.seed, path), shape, [0] * len(shape), check=True))
    emit({"phase": "dist_read_object", "ok": read_ok, "path": "0/model/" + "/".join(path), "device": str(w.device),
          "bytes": nbytes, "seconds": round(seconds, 3), "gbps": round(nbytes / GB / seconds, 3),
          "mem_at_start": mem})
    del w
    if not read_ok:
        raise RuntimeError("dist_read_object: wrong bytes")
    shutil.rmtree(snap)


def run(args) -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; needs a CUDA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    try:
        import numpy as np

        import torchsnapshot_tpu_torch as ts
        from torchsnapshot_tpu_torch import event_handlers, knobs, phase_stats
        from torchsnapshot_tpu_torch.rss_profiler import RSSWatermark
        from torchsnapshot_tpu_torch.manifest import (
            ChunkedTensorEntry,
            ObjectEntry,
            PrimitiveEntry,
            TensorEntry,
        )
        from torchsnapshot_tpu_torch.native_io import NativeFileIO
        from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin
    except ImportError as e:
        print(f"chip_smoke: torchsnapshot_tpu_torch is not importable here: {e}", file=sys.stderr)
        return 1

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    emit({"phase": "device", "ok": True, "name": name, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda})

    # 2. build: from the checkout's source, fused write+hash required.
    begin = time.monotonic()
    native = NativeFileIO.get()
    build_s = time.monotonic() - begin
    probe = os.path.join(args.workdir, "probe.bin")
    payload = np.arange(1 << 20, dtype=np.uint8)
    fused = native.write_parts_hash(probe, [payload]) == [native.xxhash64(payload)]
    with open(probe, "rb") as f:
        fused = fused and f.read() == payload.tobytes()
    os.unlink(probe)
    emit({"phase": "build", "ok": fused, "build_s": round(build_s, 3), "library": os.path.relpath(native.path, HERE),
          "fused_write_hash": fused, "supports_write_hash": FSStoragePlugin.supports_write_hash,
          "native_pool_threads": native.pool_size()})
    if not fused:
        raise RuntimeError("the fused write+hash entry point did not load")

    # dist_*: several ranks on this card, before this process builds state.
    dist_phases(torch, ts, args)

    # 3. state: full width; cut only the depth, and only if it does not fit.
    free_dev, total_dev = torch.cuda.mem_get_info()
    free_disk = shutil.disk_usage(args.workdir).free
    n_layers = args.n_layers
    reserve_disk = (1 << 30) + (4 << 30)  # yardstick file + slack
    reserve_dev = 4 << 30  # read_object copy of embed.tokens, step matmuls + slack
    # state + reference copy + the async device-mode copy
    while n_layers > 1 and (
        3 * state_bytes(n_layers) + reserve_dev > free_dev
        or state_bytes(n_layers) + reserve_disk > free_disk
    ):
        n_layers -= 1
    params = build_params(torch, n_layers, args.seed)
    ref = {p: t.clone() for p, t in leaves(params)}
    nbytes = sum(t.numel() * t.element_size() for t in ref.values())
    app_state = {
        "model": ts.StateDict(params),
        "train": ts.StateDict({"step": 1000, "seen_shards": set(range(64))}),
        "rng": ts.RNGState(),
    }
    torch.cuda.synchronize()
    emit({"phase": "state", "ok": True, "n_layers": n_layers, "depth_cut": n_layers != N_LAYERS,
          "tensors": len(ref), "bytes": nbytes, "gb": round(nbytes / GB, 3), "seed": args.seed,
          "free_device_bytes": free_dev, "total_device_bytes": total_dev, "free_disk_bytes": free_disk})

    # 4. take
    snap_path = os.path.join(args.workdir, "snap")
    phase_stats.reset()
    begin = time.monotonic()
    snapshot = ts.Snapshot.take(snap_path, app_state)
    take_s = time.monotonic() - begin
    stats = phase_stats.snapshot()
    manifest = snapshot.get_manifest()
    kinds = {
        "chunked": any(isinstance(e, ChunkedTensorEntry) for e in manifest.values()),
        "dense": any(isinstance(e, TensorEntry) and not e.location.startswith("batched/") for e in manifest.values()),
        "slab": any(isinstance(e, TensorEntry) and e.location.startswith("batched/") for e in manifest.values()),
        "object": any(isinstance(e, ObjectEntry) for e in manifest.values()),
        "primitive": any(isinstance(e, PrimitiveEntry) for e in manifest.values()),
    }
    d2h_bytes = int(stats.get("d2h", {}).get("bytes", 0))
    take_ok = d2h_bytes == nbytes and all(kinds.values())
    emit({"phase": "take", "ok": take_ok, "seconds": round(take_s, 3), "gbps": round(nbytes / GB / take_s, 3),
          "d2h_bytes": d2h_bytes, "state_bytes": nbytes, "manifest_kinds": kinds,
          "manifest_entries": len(manifest), "phases": phase_summary(stats)})
    if not take_ok:
        raise RuntimeError("take: d2h bytes or manifest entry kinds are wrong")

    # 5. restore into overwritten targets, in place.
    for t in params_leaves(params):
        t.zero_()
    ptrs = {p: t.data_ptr() for p, t in leaves(params)}
    torch.cuda.synchronize()
    phase_stats.reset()
    begin = time.monotonic()
    ts.Snapshot(snap_path).restore(app_state)
    torch.cuda.synchronize()
    restore_s = time.monotonic() - begin
    stats = phase_stats.snapshot()
    mismatched = [p for p, t in leaves(params) if not bit_equal(torch, t, ref[p])]
    moved = [p for p, t in leaves(params) if t.data_ptr() != ptrs[p]]
    h2d_bytes = int(stats.get("h2d_dispatch", {}).get("bytes", 0))
    h2d_land_bytes = int(stats.get("h2d_land", {}).get("bytes", 0))
    restore_ok = not mismatched and not moved and h2d_bytes == nbytes and h2d_land_bytes == nbytes
    emit({"phase": "restore", "ok": restore_ok, "seconds": round(restore_s, 3),
          "gbps": round(nbytes / GB / restore_s, 3), "h2d_bytes": h2d_bytes, "h2d_land_bytes": h2d_land_bytes,
          "state_bytes": nbytes, "bit_exact": not mismatched, "data_ptr_unchanged": not moved,
          "mismatched": mismatched[:5], "moved": moved[:5], "step": app_state["train"]["step"],
          "phases": phase_summary(stats)})
    if not restore_ok:
        raise RuntimeError("restore: not bit-exact in place, or h2d bytes differ")

    # 6. read_object of a chunked entry onto the card (the default device).
    entry = manifest["0/model/embed/tokens"]
    begin = time.monotonic()
    tokens = snapshot.read_object("0/model/embed/tokens")
    torch.cuda.synchronize()
    read_s = time.monotonic() - begin
    read_ok = isinstance(entry, ChunkedTensorEntry) and tokens.is_cuda and bit_equal(torch, tokens, ref["embed/tokens"])
    emit({"phase": "read_object", "ok": read_ok, "path": "0/model/embed/tokens", "chunks": len(entry.chunks),
          "device": str(tokens.device), "seconds": round(read_s, 3), "bytes": tokens.numel() * 2})
    del tokens
    if not read_ok:
        raise RuntimeError("read_object returned wrong bytes")

    # 7. integrity: a flipped payload byte must raise ChecksumError.
    small_path = os.path.join(args.workdir, "small")
    w = torch.randn(1024, 1024, generator=torch.Generator(device="cuda").manual_seed(args.seed + 1), device="cuda")
    small = ts.Snapshot.take(small_path, {"m": ts.StateDict({"w": w})})
    w_entry = small.get_manifest()["0/m/w"]
    if isinstance(w_entry, ChunkedTensorEntry):
        w_entry = w_entry.chunks[0].tensor
    with open(os.path.join(small_path, w_entry.location), "r+b") as f:
        f.seek((w_entry.byte_range or [0])[0] + 12345)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0x40]))
    try:
        ts.Snapshot(small_path).restore({"m": ts.StateDict({"w": torch.zeros_like(w)})})
        raised = None
    except ts.ChecksumError as e:
        raised = str(e)
    emit({"phase": "integrity", "ok": raised is not None, "checksum_error": raised})
    if raised is None:
        raise RuntimeError("a flipped payload byte was not detected")
    shutil.rmtree(snap_path)

    # async phases: async_take in each staging mode at full size.  The
    # state is reached through app_state from here on, so that freeing a
    # tensor there really frees it.
    del params, w, small
    events: list = []
    event_handlers.register_event_handler(events.append)
    g = torch.Generator(device="cuda").manual_seed(args.seed + 2)
    mats = [torch.randn(STEP_DIM, STEP_DIM, generator=g, dtype=torch.bfloat16, device="cuda") * STEP_DIM ** -0.5
            for _ in range(2)]
    training_steps(torch, mats, 2, device_sync=True)  # warm-up
    common = (torch, ts, knobs, phase_stats, RSSWatermark, app_state, ref, nbytes, mats, events, args.workdir)
    stalls = [async_phase(*common, "async_pinned_host", "auto", "pinned_host", run=1),
              async_phase(*common, "async_pinned_host", "pinned_host", "pinned_host", run=2)]
    emit({"phase": "async_pinned_host_stalls", "ok": True, "first_stall_s": round(stalls[0], 4),
          "second_stall_s": round(stalls[1], 4)})
    async_phase(*common, "async_device", "device", "device")
    async_phase(*common, "async_host", "host", "host")
    del mats
    storage_phases(torch, ts, knobs, phase_stats, app_state, ref, nbytes, events, args.workdir)
    manager_phases(torch, ts, knobs, phase_stats, app_state, ref, nbytes, events, args.workdir)
    event_handlers.unregister_event_handler(events.append)

    # 8. yardsticks for the take/restore rates.
    n = 1 << 30
    host = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(n, dtype=torch.uint8, device="cuda")
    d2h = copy_gbps(torch, host, dev)
    h2d = copy_gbps(torch, dev, host)
    disk = fsync_write_gbps(np, os.path.join(args.workdir, "disk.bin"), n)
    emit({"phase": "yardsticks", "ok": True, "pinned_d2h_gbps": round(d2h, 3), "pinned_h2d_gbps": round(h2d, 3),
          "fsync_disk_write_gbps": round(disk, 3), "bytes": n,
          "take_vs_disk": round(nbytes / GB / take_s / disk, 3),
          "restore_vs_h2d": round(nbytes / GB / restore_s / h2d, 3)})

    emit({"kernels": [], "reason": "torchsnapshot_tpu has no Pallas kernel (no pallas_call in the tree; "
          "docs/design.md:102-112): its device work is slicing plus a bitcast repack, which the port "
          "does as copy-engine D2H/H2D/D2D copies and view(torch.uint8)"})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}})
    return 0


def params_leaves(params):
    return [t for _, t in leaves(params)]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--n-layers", type=int, default=N_LAYERS)
    args = parser.parse_args()
    args.workdir = os.path.join(HERE, ".chip_smoke_tmp")
    shutil.rmtree(args.workdir, ignore_errors=True)
    os.makedirs(args.workdir)
    try:
        return run(args)
    except Exception as e:  # noqa: BLE001 — report the failed phase, exit non-zero
        emit({"phase": "error", "ok": False, "error": f"{type(e).__name__}: {e}"})
        return 1
    finally:
        shutil.rmtree(args.workdir, ignore_errors=True)
        stop_resource_tracker()


def stop_resource_tracker() -> None:
    """Stop the resource-tracker process that spawning the ranks started,
    so that the script leaves no process behind."""
    from multiprocessing import resource_tracker

    tracker = resource_tracker._resource_tracker
    stop = getattr(tracker, "_stop", None)
    if stop is not None and getattr(tracker, "_pid", None) is not None:
        stop()


if __name__ == "__main__":
    sys.exit(main())
