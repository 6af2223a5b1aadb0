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
                the restore equals the state before the mutation; the
                CLI's ``analyze --barrier --json`` over its four sidecars
                prints ``barrier_blame``'s report),
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
   cli_take   — the port's CLI (``torchsnapshot_tpu_torch.__main__.main``,
                in this process) over the take's snapshot before it goes:
                ``info`` states its array bytes, ``ls`` prints one line per
                manifest entry, ``cat`` of the 8 KiB ``final_norm`` reads it
                onto the default device (the card) and prints its values
   trace_take_restore — the take and the in-place restore again with
                ``TPUSNAP_TRACE_DIR`` and ``TPUSNAP_METRICS`` set (through
                ``knobs.override_*``): both walls beside the untraced ones,
                the calibrated span cost, the span count, the spans with the
                most total time; every trace file valid, the take's ``d2h``
                span bytes equal to the state's, the metrics' written bytes
                equal to the payload on disk and the read bytes to what the
                restore's read requests consumed, bit-exact
                Then the port's CLI over the same files (``analyze_traces``
                line): ``trace --out`` prints the merge of the two files with
                the span count read from them (the merged file holds that
                many), ``analyze --snapshot --json`` prints the library's
                report, and ``analyze``'s text names both ops
   scheduler_waits — two traced takes of 8 float32 tensors of 64 MiB made on
                the card: at an I/O concurrency of 1, and with the memory
                budget at one request's staging cost; the CLI's ``analyze
                --json`` must show an ``io_concurrency`` group wall above 0
                in the first and a ``memory_budget`` one in the second, the
                second restores bit-exact; both groups' walls beside each
                take's wall
   profile_take_restore — the take and the in-place restore again with
                ``TPUSNAP_PROFILE`` set at the default 99 Hz (through
                ``knobs.override_profile_dir``): both walls beside the
                unprofiled ones; per op the ticks, samples, on-CPU samples and
                the five phases with the most on-CPU seconds; the calibrated
                per-tick cost and its share of each wall, and one pass of
                the port's CPU time reader beside the JAX package's
                ``/proc`` reader; every profile file
                valid under the port's ``validate_profile``, every collapsed
                line ``phase;state;frames count``, each op's untagged on-CPU
                share under 5% (the reference's bar), bit-exact; the CLI's
                ``analyze --profile --json`` prints the library's profiles,
                ``profile diff`` of the take's file against the restore's
                prints ``diff_profiles`` of their metas, and the directory
                diffed with itself names no frame
   host data plane — each phase removes its directories before the next:
   direct_io_take — ``Snapshot.take`` with ``TPUSNAP_DIRECT_IO=1``: the
                resolved mode (1 io_uring, 2 O_DIRECT pwrite, 3 the
                buffered fallback, which must come with one
                ``native.degraded`` event), every payload digest equal to
                the ``take`` phase's; ``direct_io_restore`` bit-exact in
                place
   adaptive_restore — that snapshot restored with ``TPUSNAP_CHECKSUM=0``
                (unhashed reads, so large ones take the adaptive path)
                under ``TPUSNAP_PARALLEL_READ_WAYS`` 1, 8 and unset, each
                after evicting its files from the page cache (no warm
                repeat: on the card's 9p mount a cold restore ran within
                12% of a warm one): sequential and parallel read counts,
                the measured rates and the pick; bit-exact in place
   torch_layout_take — the same weights as an ``nn.Module.state_dict()`` of
                Llama-3-8B holds them (291 per-layer views), taken with
                ``TPUSNAP_NATIVE_BATCH=0`` and then 8: native write+hash,
                batched call and member counts; equal digests;
                ``torch_layout_restore`` bit-exact in place
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
   monitor_async_take — the health monitor and the flight recorder: an
                ``async_take`` (pinned_host) with ``TPUSNAP_STALL_TIMEOUT_S=60``,
                ``TPUSNAP_PROGRESS_INTERVAL_S=1``, ``TPUSNAP_HEARTBEAT_FILE``,
                ``TPUSNAP_BLACKBOX`` and ``TPUSNAP_METRICS`` set, ``progress()``
                polled every 0.25 s until the commit: staged and written bytes
                never fall and end at ``async_take.end``'s bytes, done and
                successful, the heartbeat parsed at least twice mid-drain and
                ending ``done``, no ``watchdog.stall``, the ring holding the
                op's start and end and a progress record, the sidecar's RSS
                high water above 0; its wall beside ``async_pinned_host`` run 2
                and the recorder's calibrated cost per record.  Fleet
                telemetry on too (``TPUSNAP_FLEET_TELEMETRY`` under the work
                directory, a 1 s interval, a 2 s stale bound whose half is
                the monitor's liveness floor), the spool collected (at the
                default 30 s bound) and aggregated beside each poll: at
                least two live ``async_take`` entries with bytes that never
                fall, the terminal entry done and successful at
                ``async_take.end``'s bytes, the take and the restore each
                counted once in the process totals, the calibrated publish
                bill (measured once ``os.sync()`` flushed the take's dirty
                pages) under 1% of the take's wall; the publishes, the raw
                and calibrated overhead and the entry's bytes printed; after
                the restore the CLI's ``top --json`` lists the take's and
                the restore's entries as the library reads them
   monitor_restore — the in-place restore under the same knobs: bit-exact,
                no stall, the ring holding its start and end, its terminal
                fleet entry done and successful
   monitor_stall — a take of one 256 MiB tensor on the card with
                ``TPUSNAP_FAULTS=write:1:latency:3`` and a 0.5 s stall
                timeout: a ``watchdog.stall`` with ``idle_s`` >= 0.5, a bundle
                with its five sections (the last a sampled profile of at least
                one sample), ``tpusnap_stalls_total`` >= 1; the take commits
                and restores bit-exact
   monitor_crash — a spawned process builds the 8-layer cut of the same
                widths on the card and saves it as step 0 of a manager root
                (``SnapshotManager(root).save``) with
                ``TPUSNAP_FAULTS=write:3:crash@0/*`` (the third payload
                write) and ``TPUSNAP_BLACKBOX``: it exits 1, and its ring
                (read with the port's ``blackbox.read_all``) names
                ``take.start``, the ``crash`` fault (op ``write``, its path,
                a phase) and no ``take.end``
   postmortem_crash — before that root goes, ``postmortem.analyze_root``
                over it and the ring: ``killed_mid_take``, the child's pid
                (not this one's), verdict ``crash_fault``, op ``take``, the
                ring's fault op and path, a phase group that is the
                analyzer's group of the phase (printed, not required to be
                a write's: on the card the crash has come in ``d2h``), an
                in-flight marker of the child's pid, a forced ``gc`` action,
                no committed point, a timeline sorted by time with one
                Perfetto event for each entry, and ``format_report`` naming
                the classification and the pid; ``postmortem --json``
                through the port's CLI in this process names the same
                classification and pid; then the report's own ``gc``
                command (``python -m torchsnapshot_tpu_torch gc <root>
                --apply --force``, ``python`` this interpreter) runs in a
                subprocess from the checkout: exit 0, a ``removed step_N``
                line for each step the report said it reclaims (command,
                exit code, wall and last line printed), and a second report
                with no orphan step, chunk, segment or marker and no ``gc``
                action; both reports' walls printed
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
   replicate_cas_chain — ``copy_snapshot(verify=True)`` of that root's
                step 0, then step 1, into a new fs root: step 0 copies its
                chunks, step 1 exactly the chunks it references and step 0
                does not (their bytes as cas_take's new-chunk bytes), the
                rest skipped; each audit clean and timed apart; step 1's
                replica restores bit-exact in place
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
                reclaims exactly its chunks, bytes as its manifest states.
                The port's CLI over the root as it goes: ``diff`` of step 0
                and seg 1 (exit 1; changed exactly ``wk`` and ``w_gate``,
                nothing added or unverified, removed the leaves the delta
                does not carry), ``stats`` of seg 1, ``steps`` against
                ``restore_point_times``, ``history --json`` against
                ``history.read`` and the dry-run ``gc`` against
                ``gc_detail(apply=False)``
   manager_async_journal — a segment saved with ``async_=True`` in
                pinned_host mode (every tensor mutated after the return):
                stall and total; its manifest equals the sync segment of
                the same change entry by entry; bit-exact replayed restore
   cloud_cut  — the object-store phases' state: the manager phases'
                changes undone, then the first ``CLOUD_LAYERS`` (8) layers
                at full width, as views of the state (5.59 GB); its fs
                incremental take (``cloud_cut_incremental_take``, checked
                as ``incremental_take``) gives the step 0 digests and the
                step 1 bytes the S3 and GCS phases are held to
   S3 — tests/fake_s3.py's FakeS3Server in a child process on 127.0.0.1,
                its MD5 ETags memoized per stored object (the numbers are
                a loopback fake's in Python, not S3's), on
                ``cloud_cut``'s state;
                each phase deletes its root through the plugin:
   s3_take    — ``Snapshot.take("s3://smoke/take")`` at default knobs:
                seconds, GB/s, objects and bytes stored, every model
                digest equal to ``cloud_cut``'s step 0
   s3_restore — zeroed targets restored from it: bit-exact, ``data_ptr()``
                unchanged, ``h2d`` bytes equal to the state's; the fan-out
                reads (ranged GETs pinned to the ETag) are counted; then
                again with ``TPUSNAP_PARALLEL_READ_WAYS=1`` (one GET per
                read), bit-exact
   s3_read_object — ``embed.tokens`` onto the card
   s3_incremental_take — step 0 with the multipart threshold at 128 MiB
                and 32 MiB parts (uploads and parts counted); step 1 after
                ``mutate_step`` with ``incremental_from=step_0``: the bytes
                PUT at most ``wk`` plus the ``w_gate`` chunks the rows
                touch, every unchanged payload a server-side copy
                (counted); step 1 restores bit-exact in place
   GCS — tests/fake_gcs.py's FakeGCSServer in a child process on 127.0.0.1,
                its MD5 generations memoized per stored object, finished
                upload sessions dropped between takes and Nagle's algorithm
                off on its sockets (the numbers are a loopback fake's in
                Python, not GCS's), on ``cloud_cut``'s state:
   gcs_take   — ``Snapshot.take("gs://smoke/take")`` at default knobs
                (resumable uploads in 100 MiB chunks): seconds, GB/s,
                objects and bytes stored, chunk PUTs, no session left open,
                every model digest equal to ``cloud_cut``'s step 0
   gcs_restore — zeroed targets restored from it: bit-exact,
                ``data_ptr()`` unchanged, ``h2d`` bytes equal to the
                state's; the fan-out reads (ranged GETs pinned to the
                generation) are counted; then again with
                ``TPUSNAP_PARALLEL_READ_WAYS=1`` (one stream of 100 MiB
                ranged GETs per read), bit-exact
   gcs_read_object — ``embed.tokens`` onto the card
   gcs_incremental_take — step 1 after ``mutate_step``, with
                ``incremental_from`` the ``gcs_take`` snapshot: the bytes
                uploaded equal to ``cloud_cut``'s fs step 1's, every
                unchanged payload one ``rewriteTo`` copy (counted); step 1
                restores bit-exact in place, one stream per read; both
                roots are then deleted through the plugin
   Each object-store phase prints its counts: uploads and chunk PUTs (or
   PUTs and parts), GETs, fan-outs, copies and, for GCS, retries.
   replication — ``copy_snapshot`` of a fresh fs take of the state, each
                copy's audit (``verify=True``) timed apart from it:
   replicate_fs_link — fs to fs: every payload a hard link to its source
                inode, the marker byte-equal, the audit's ``ok`` equal to
                the checksummed payload items; bit-exact in-place restore
   replicate_fs_stream — ``force_stream=True``: no inode shared, the RSS
                high-water growth over the copy at most the 2 GiB byte
                budget plus one 512 MiB payload; bit-exact restore; one
                flipped byte of the replica is exactly one corrupt item in
                the audit of ``verify`` through the port's CLI (exit 1,
                ``verified <items-1> payloads, 1 corrupt, 0 unreadable``,
                one problem line naming it) and ``ChecksumError`` from
                ``restore``; the replica is then removed
   replicate_s3 — an fs take of the 8-layer cut (``CLOUD_LAYERS``, as
                the S3 phases) copied to ``s3://smoke/replica`` (the fake S3
                child; its audit one GET per read), then within the bucket
                to ``replica2``: one server-side copy per payload, only the
                marker PUT, bit-exact in-place restore (one GET per read);
                needs host RAM for three times the cut
   shared store — two tenant roots A and B, each
                ``SnapshotManager(root, store=S, max_to_keep=1)``, on one
                store S; S, A and B are removed at the end:
   store_tenants — A.save(0) writes the state's chunks into S; B.save(0)
                of the same state writes no chunk byte (it adopts A's);
                after ``mutate_step`` B.save(1) writes exactly the chunks
                step 1 adds, A.save(1) none; both prune step 0.  Per save:
                wall, the ``take.end`` chunk bytes and the byte meter's
                bytes under ``S/cas/``; the ledger files; ``tenant_usage``'s
                logical and physical bytes
   store_sweep — once the journals naming step-0 chunks are past the
                liveness grace, ``gc`` of A at
                ``TPUSNAP_STORE_QUARANTINE_S=0`` condemns, then deletes,
                exactly the step-0 versions of the changed chunks (chunks
                and bytes); ``store.chunk_classification`` accounts for
                every chunk left; a fresh ``Snapshot(...).restore`` of each
                tenant's step 1, no knob set, resolves through the root's
                ``.store`` pointer, bit-exact in place; then the port's CLI:
                ``info`` of A's step 1 names the store, ``stats`` prints the
                tenant lines of ``store.tenant_usage``, and the dry-run
                ``gc`` of A the counts of ``store.chunk_classification``
   host cache — ``TPUSNAP_CACHE_DIR`` on ``<workdir>/cache``, origin metered
                by ``TPUSNAP_FAULTS=none`` (payload files only); free disk
                checked first, every directory removed after:
   cache_cold — the state taken anew (the take phase's snapshot is gone),
                then a fresh ``Snapshot(...).restore`` in place: origin
                payload bytes equal to the payload on disk, to the miss
                bytes and to the bytes cached; the ``cache_populate`` phase;
                bit-exact
   cache_warm — the same restore again: 0 origin payload bytes, hit bytes
                equal to cache_cold's miss bytes, the ``cache_read`` phase
                (from the page cache: the files were just written),
                bit-exact; ``read_object`` of ``embed.tokens`` onto the card
                all from the cache
   cache_corrupt — 4 bytes flipped in the largest cache data file, its size
                kept: the next restore re-fetches exactly that entry's bytes
                from origin and stays bit-exact
   cache_two_workers — two spawned processes (the port, no JAX) restore one
                snapshot onto the card at once through one fresh cache:
                full width, ``CACHE_WORKER_LAYERS`` layers (n_layers and
                depth_cut printed), seeded values checked in each; summed
                origin bytes at most 1.25x the logical bytes, hit + miss
                twice them.  Both publish into one fleet spool (the
                snapshot's ``telemetry/live``, a 0.1 s interval): its
                aggregate holds the two processes, done, with cache hit and
                miss bytes equal to the workers' own sums and origin bytes
                at most 1.25x the logical bytes; the CLI's ``top --json`` is
                that view (ages aside), ``top --prometheus`` carries both
                workers' registries (the workers run with
                ``TPUSNAP_METRICS=1``), ``top --once`` names both pids; a
                1 ms stale bound then reads no entry
   peer tier — port ``PeerDaemon``s, each in a spawned process advertising
                127.0.0.1 on a FileStore registry under the work
                directory, serving an 8-layer cut of the same widths taken
                with ``TPUSNAP_CAS=1`` to spawned workers on the card
                (``TPUSNAP_PEER_FETCH=1``, each with a fresh cache, a 60 s
                peer timeout); each phase removes its directories:
   peer_restore — daemon A serves a cache warmed by ``cache.warm_snapshot``,
                daemon B an empty one: the worker's restore reads 0 origin
                payload bytes, its peer hit bytes equal the chunk bytes on
                disk, no reject, bit-exact against the seeded values, no
                ``jax`` imported; wall s and GB/s.  Traced: the worker and
                both daemons write to one ``TPUSNAP_TRACE_DIR`` (the
                daemons with their access logs and ``TPUSNAP_METRICS``);
                ``merge_fleet_traces`` stitches the worker's trace id with
                daemon A's ``peerd_handle`` spans, each parented on a
                worker ``peer_fetch`` span; per GET the time to first byte
                and the transfer; daemon A's ``/metrics`` count of 200
                chunk answers must equal the worker's peer hits; over a
                copy of its trace files the CLI's ``analyze --peer --json``
                prints ``peer_report`` and ``trace --fleet`` the worker's
                trace id with the count of events that carry it
   peer_fault — B stopped, ``TPUSNAP_FAULTS=peer:2:peer_truncated``:
                exactly one reject, peer hit bytes > 0, peer hit plus origin
                bytes equal to the chunk bytes, bit-exact
   peer_rollout — a CAS ``SnapshotManager`` root saves step 1, then step 2
                with ``wk`` refilled; two daemons serve it;
                ``peerd.rollout_fleet(root, step, canary=1)`` for step 1
                (all of it the delta) and step 2: each ``ok``, the canary's
                delta from origin once, the fleet host's peer hit bytes
                equal to the delta and its cache miss bytes 0; a worker
                restores step 2 from the fleet host's cache with 0 origin
                payload bytes, bit-exact.  The daemons and the rollouts
                publish into one fleet spool (a 0.2 s interval): after each
                rollout its terminal entry's wave document reads ``fleet``
                with every host completed and the fleet host's peer hit
                bytes, and each daemon's ``serve`` entry is live and fresh
                at the default stale bound; after the daemons close, their
                ``serve`` entries are done
   cli        — every CLI command the phases ran (in this process, or the
                postmortem's gc line in a subprocess): its arguments, exit
                code (each the one its phase requires) and wall
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
import contextlib
import json
import os
import re
import shlex
import shutil
import statistics
import subprocess
import sys
import threading
import time
import traceback

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


# The command line (``python -m torchsnapshot_tpu_torch``): the phases run its
# commands over the files they already wrote, before they remove them; each
# run lands here, and the ``cli`` line prints them all.
CLI_RUNS: list = []


def record_cli(phase, argv, rc, expect, seconds, how="in-process") -> None:
    CLI_RUNS.append({"phase": phase, "argv": [os.path.relpath(a, HERE) if os.path.isabs(a) else a for a in argv],
                     "rc": rc, "expect": expect, "s": round(seconds, 4), "how": how})


def run_cli(argv, phase, expect=0):
    """``main(argv)`` of the port's CLI in this process with its stdout
    captured: (exit code, stdout).  ``expect`` is the exit code the phase
    requires."""
    import io

    from torchsnapshot_tpu_torch.__main__ import main as cli_main

    out = io.StringIO()
    begin = time.monotonic()
    with contextlib.redirect_stdout(out):
        rc = cli_main(list(argv))
    record_cli(phase, argv, rc, expect, time.monotonic() - begin)
    return rc, out.getvalue()


def array_bytes(obj) -> int:
    """Bytes of every tensor and numpy array in a nested state."""
    import numpy as np

    if hasattr(obj, "element_size"):
        return obj.numel() * obj.element_size()
    if isinstance(obj, np.ndarray):
        return obj.nbytes
    if isinstance(obj, dict):
        return sum(array_bytes(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(array_bytes(v) for v in obj)
    return 0


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
    return stall_s, total_s


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
    whole chunks: the payload file holding wk (all of wk, or its whole slab
    when wk is small enough to be batched, as at a cut depth), and the
    chunks of w_gate the changed rows touch."""
    from torchsnapshot_tpu_torch.manifest import iter_payload_entries

    manifest = snap1.get_manifest()
    wk = manifest["0/model/layers/attn/wk"]
    wk_bytes = ref["layers/attn/wk"].numel() * 2
    if getattr(wk, "location", "").startswith("batched/"):
        wk_bytes = max(e.byte_range[1] for _, e in iter_payload_entries(manifest) if e.location == wk.location)
    entry = manifest["0/model/layers/mlp/w_gate"]
    gate = model["layers"]["mlp"]["w_gate"]
    row_bytes = gate.numel() * 2 // gate.shape[0]
    rows = gate.numel() // gate.shape[-1]
    r0, n_rows = rows // 3, max(1, int(rows * CHANGED_ROW_FRACTION))
    lo = r0 * gate.shape[-1] * 2
    hi = (r0 + n_rows) * gate.shape[-1] * 2
    touched = sum(c.sizes[0] * row_bytes for c in entry.chunks
                  if c.offsets[0] * row_bytes < hi and (c.offsets[0] + c.sizes[0]) * row_bytes > lo)
    return wk_bytes + touched


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


def incremental_phase(torch, ts, knobs, phase_stats, app_state, ref, nbytes, events, workdir,
                      label="incremental_take"):
    """incremental_take: step 1 with incremental_from=step_0 and CAS off;
    every payload whose checksum did not change is a hard link, and the
    bytes written are within the whole-chunk bound of the change.  Returns
    (step 1's payload bytes written, step 0's manifest)."""
    from torchsnapshot_tpu_torch import faults
    from torchsnapshot_tpu_torch.incremental import checksums_by_location

    root = os.path.join(workdir, "incremental")
    model = app_state["model"].state_dict()
    base_manifest = ts.Snapshot.take(os.path.join(root, "step_0"), app_state).get_manifest()
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
    emit({"phase": label, "ok": ok, "step1_s": round(step1_s, 3), "hard_links": end["incremental_links"],
          "unchanged_payloads": unchanged, "bytes_written": written, "bound_bytes": bound,
          "changed_bytes": changed_bytes, "state_bytes": nbytes,
          "restore_s": round(seconds, 3), "bit_exact": not mismatched, "data_ptr_unchanged": not moved,
          "phases": phase_summary(stats)})
    shutil.rmtree(root)
    if not ok:
        raise RuntimeError(f"{label}: an unchanged payload was not linked, bytes written past the "
                           "bound, or not bit-exact")
    return written, base_manifest


def storage_phases(torch, ts, knobs, phase_stats, app_state, ref, nbytes, events, workdir):
    """The storage-depth phases."""
    compress_phases(torch, ts, knobs, phase_stats, app_state, ref, nbytes, workdir)
    root = cas_take_phase(torch, ts, knobs, phase_stats, app_state, ref, nbytes, events, workdir, "cas_take", False)
    async_cas_phase(torch, ts, knobs, phase_stats, app_state, ref, nbytes, root)
    replicate_cas_chain_phase(torch, ts, phase_stats, app_state, ref, root, workdir)
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


MUTATED_PATHS = ("0/model/layers/attn/wk", "0/model/layers/mlp/w_gate")  # what mutate_step changes


def cli_segment_checks(ts, root, step):
    """The command line over a journal root's ``step_0`` and segment
    ``step``: ``diff`` reads the two manifests as they are, so it exits 1
    with exactly the mutated paths changed, nothing added or unverified,
    and as removed exactly the step-0 leaves the segment's delta does not
    carry (it holds the entries whose records changed); ``stats`` of the
    segment reports its take."""
    from torchsnapshot_tpu_torch.manifest_utils import is_container_entry

    base, seg = os.path.join(root, "step_0"), os.path.join(root, f"seg_{step}")
    leaves = [{p for p, e in ts.Snapshot(path).metadata.manifest.items() if not is_container_entry(e)}
              for path in (base, seg)]
    rc, out = run_cli(["diff", base, seg, "--limit", str(len(leaves[0]) + len(leaves[1]))], "manager_journal",
                      expect=1)
    buckets = {}
    for line in out.splitlines()[:-1]:
        label, _, path = line.strip().partition("  ")
        buckets.setdefault(label, []).append(path)
    removed = sorted(leaves[0] - leaves[1])
    diff_ok = (rc == 1 and sorted(buckets.get("changed", [])) == sorted(MUTATED_PATHS)
               and buckets.get("removed", []) == removed and not buckets.get("added") and not buckets.get("unverified")
               and out.splitlines()[-1] == f"0 added, {len(removed)} removed, {len(MUTATED_PATHS)} changed, "
               f"{len(leaves[0] & leaves[1]) - len(MUTATED_PATHS)} identical")
    stats_rc, stats = run_cli(["stats", seg], "manager_journal")
    ops = re.fullmatch(r"(\d+) operation\(s\) recorded", stats.splitlines()[-1] if stats else "")
    stats_ok = stats_rc == 0 and ops is not None and int(ops.group(1)) >= 1
    return diff_ok and stats_ok, {"diff_exit_code": rc, "diff_summary": out.splitlines()[-1] if out else None,
                                  "diff_changed": buckets.get("changed", []), "diff_removed": len(removed),
                                  "stats_operations": int(ops.group(1)) if ops else None}


def cli_root_checks(root, mgr):
    """``steps`` of a manager root prints ``restore_point_times`` (each
    point, its committed instant, the latest), and ``history --json`` is
    ``history.read`` of the root."""
    from datetime import datetime

    from torchsnapshot_tpu_torch.storage_plugin import url_to_storage_plugin
    from torchsnapshot_tpu_torch.telemetry import history

    points = mgr.restore_point_times()
    want = [(f"step_{s}" if kind == "full" else f"seg_{s} (journal delta)")
            + (f"  committed {datetime.fromtimestamp(t).isoformat(timespec='seconds')}" if t is not None else "")
            for s, kind, t in points] + [f"latest: {points[-1][0]}"]
    steps_rc, steps = run_cli(["steps", root], "manager_journal")
    storage = url_to_storage_plugin(root)
    try:
        entries = history.read(storage)
    finally:
        storage.sync_close()
    history_rc, history_out = run_cli(["history", root, "--json"], "manager_journal")
    ok = steps_rc == history_rc == 0 and steps.splitlines() == want and json.loads(history_out) == entries
    return ok, {"steps": steps.splitlines(), "history_entries": len(entries)}


def cli_gc_dry_run_check(root, dry):
    """The dry-run ``gc`` of a root names what ``gc_detail(apply=False)``
    returned: its orphan steps, segments and chunks."""
    rc, out = run_cli(["gc", root], "manager_journal")
    lines = out.splitlines()
    named = ([int(m.group(1)) for m in map(re.compile(r"orphan step_(\d+) \(").match, lines) if m],
             [m.group(1) for m in map(re.compile(r"orphan chunk (\S+) \(").match, lines) if m],
             [int(m.group(1)) for m in map(re.compile(r"orphan/stale journal segment seg_(\d+)$").match, lines) if m])
    return rc == 0 and named == tuple(dry), {"gc_dry_run_lines": len(lines), "gc_dry_run_named_chunks": len(named[1])}


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
            if step == 1:
                seg_cli_ok, seg_cli = cli_segment_checks(ts, root, 1)
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
    root_cli_ok, root_cli = cli_root_checks(root, mgr)

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
    gc_cli_ok, gc_cli = cli_gc_dry_run_check(root, dry)
    begin = time.monotonic()
    applied = mgr.gc_detail(apply=True)
    gc_s = time.monotonic() - begin
    gc_bytes_disk = sum(disk_before_gc[c] for c in applied[1])
    gc_bytes_manifest = sum(seg4_sizes.get(c, -1) for c in seg4_only)
    gc_ok = (dry == applied == ([], seg4_only, []) and bool(seg4_only) and gc_bytes_disk == gc_bytes_manifest
             and set(chunks_on_disk(root)) == set(disk_before_gc) - set(seg4_only))
    cli_ok = seg_cli_ok and root_cli_ok and gc_cli_ok
    ok = segs_ok and fold_ok and restores_ok and fallback_ok and gc_ok and cli_ok
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
          "gc_expected_bytes_from_manifest": gc_bytes_manifest, "gc_s": round(gc_s, 4),
          "cli": {"ok": cli_ok, "segment_1": seg_cli, **root_cli, **gc_cli}})
    if not ok:
        raise RuntimeError("manager_journal: a segment past its bound, a fold that wrote payload, reclamation "
                           "other than the unreferenced chunks, a restore not bit-exact, no fallback to step 3, or "
                           "a CLI command that printed other than the library returned")
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
        base_view = journal.view_of(journal.read_metadata(storage, "step_3/.snapshot_metadata").manifest)
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


# --------------------------------------------------------------- S3 phases
#
# The object-store backend at full size against tests/fake_s3.py's
# FakeS3Server, run in a child process (its GIL and its RAM are not this
# process's; it holds every object whole in a dict), with each object's
# ETag computed once instead of on every request.  The numbers are those
# of a loopback fake in Python, not of S3.  Each phase deletes its root
# through the plugin before the next starts.

S3_BUCKET = "smoke"
# The S3 and GCS phases take the first CLOUD_LAYERS layers at full width:
# against loopback fakes in Python their rates are the fakes', not the
# port's, and at the full depth they took a tenth of the script's limit.
CLOUD_LAYERS = 8
# s3_incremental_take's step 0 goes up as multipart uploads.
S3_MULTIPART_THRESHOLD = 128 << 20
S3_MULTIPART_PART = 32 << 20
S3_CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import fake_s3
from fake_s3 import FakeS3Server

# The fake's ETag is the MD5 of the whole object, recomputed on every HEAD
# and every If-Match GET: a fanned-out 512 MB read would hash 4 GB.  S3
# stores an object's ETag with it, so the child memoizes it per stored
# bytes object (same values); entries of objects no longer stored go at
# the next stats call.
etags = {}
md5_etag = fake_s3._etag


def stored_etag(data):
    hit = etags.get(id(data))
    if hit is None or hit[0] is not data:
        hit = etags[id(data)] = (data, md5_etag(data))
    return hit[1]


fake_s3._etag = stored_etag
srv = FakeS3Server()
print(srv.endpoint, flush=True)


def rss():
    with open("/proc/self/status") as f:
        return next(int(line.split()[1]) * 1024 for line in f if line.startswith("VmRSS:"))


for line in sys.stdin:  # "<prefix>": the server's counters and the objects under it
    prefix = line.rstrip("\n")
    with srv._lock:
        live = {id(v) for v in srv.objects.values()}
        for key in [k for k in etags if k not in live]:
            etags.pop(key, None)
        keys = [k for k in srv.objects if k.startswith(prefix)]
        out = {"objects": len(keys), "bytes": sum(len(srv.objects[k]) for k in keys), "put_bytes": srv.put_bytes,
               "copies": srv.copies, "gets": srv.gets, "requests": srv.request_count,
               "multipart_completed": srv.multipart_completed, "uploads_open": len(srv.uploads)}
    out["rss_bytes"] = rss()
    print(json.dumps(out), flush=True)
srv.stop()
"""


class FakeServerChild:
    """A fake object store (``script``: S3_CHILD or GCS_CHILD) in a child
    process on 127.0.0.1; ``stats(prefix)`` reads its counters over a pipe,
    ``stop()`` ends it."""

    def __init__(self, script: str, name: str) -> None:
        self.proc = subprocess.Popen([sys.executable, "-c", script, os.path.join(HERE, "tests")],
                                     stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        self.endpoint = self.proc.stdout.readline().strip()
        if not self.endpoint.startswith("http://127.0.0.1:"):
            self.stop()
            raise RuntimeError(f"the fake {name} server did not start: {self.endpoint!r}")

    def stats(self, prefix: str = "") -> dict:
        self.proc.stdin.write(prefix + "\n")
        self.proc.stdin.flush()
        return json.loads(self.proc.stdout.readline())

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.stdin.close()
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()


def model_digests(manifest):
    """payload_digests of the model's entries (the state's bytes)."""
    return {k: v for k, v in payload_digests(manifest).items() if "/model/" in k[0]}


def delete_root(server, url: str) -> int:
    """Delete a snapshot root through the plugin; returns the objects left."""
    from torchsnapshot_tpu_torch.storage_plugin import url_to_storage_plugin

    storage = url_to_storage_plugin(url)
    try:
        storage.sync_delete_dir("")
    finally:
        storage.sync_close()
    return server.stats(url.split("://", 1)[1] + "/")["objects"]


def s3_counts(stats):
    return {k: phase_n(stats, k) for k in ("s3_put", "s3_multipart", "s3_multipart_part", "s3_get", "s3_fanout",
                                           "s3_copy")}


def s3_take_phases(torch, ts, knobs, phase_stats, app_state, ref, nbytes, server, buffered_manifest, n_layers):
    """s3_take, s3_restore (then again with one GET stream per read) and
    s3_read_object at default knobs."""
    url = f"s3://{S3_BUCKET}/take"
    before = server.stats()
    device_sync(torch)
    phase_stats.reset()
    begin = time.monotonic()
    snapshot = ts.Snapshot.take(url, app_state)
    take_s = time.monotonic() - begin
    stats = phase_stats.snapshot()
    stored = server.stats(f"{S3_BUCKET}/take/")
    want, got = model_digests(buffered_manifest), model_digests(snapshot.get_manifest())
    differ = sorted(str(k) for k in set(want) | set(got) if want.get(k) != got.get(k))
    d2h_bytes = int(stats.get("d2h", {}).get("bytes", 0))
    take_ok = (bool(want) and not differ and stored["uploads_open"] == 0
               and (d2h_bytes == nbytes or DEV != "cuda"))
    emit({"phase": "s3_take", "ok": take_ok, "server": "tests/fake_s3.py in a child process, loopback",
          "n_layers": n_layers, "depth_cut": n_layers != N_LAYERS, "seconds": round(take_s, 3),
          "gbps": round(nbytes / GB / take_s, 3), "objects_stored": stored["objects"], "bytes_stored": stored["bytes"],
          "bytes_put": stored["put_bytes"] - before["put_bytes"], "state_bytes": nbytes, "d2h_bytes": d2h_bytes,
          "digests_compared": len(want), "digests_differ": differ[:5], "server_rss_bytes": stored["rss_bytes"],
          "counts": s3_counts(stats), "phases": phase_summary(stats)})
    if not take_ok:
        raise RuntimeError(f"s3_take: d2h bytes {d2h_bytes}, digests differ from the take phase's: {differ[:5]}")

    before = server.stats()
    seconds, mismatched, moved, stats = restore_check(torch, ts, url, app_state, ref, phase_stats)
    after = server.stats()
    h2d_bytes = int(stats.get("h2d_dispatch", {}).get("bytes", 0))
    ok = (not mismatched and not moved and phase_n(stats, "s3_fanout") > 0
          and (h2d_bytes == nbytes or DEV != "cuda"))
    emit({"phase": "s3_restore", "ok": ok, "n_layers": n_layers, "seconds": round(seconds, 3),
          "gbps": round(nbytes / GB / seconds, 3), "h2d_bytes": h2d_bytes, "state_bytes": nbytes,
          "bit_exact": not mismatched, "data_ptr_unchanged": not moved, "mismatched": mismatched[:5],
          "fanout_reads": phase_n(stats, "s3_fanout"), "gets": after["gets"] - before["gets"],
          "counts": s3_counts(stats), "phases": phase_summary(stats)})
    if not ok:
        raise RuntimeError("s3_restore: not bit-exact in place, h2d bytes differ, or no read fanned out")
    # The same restore with one GET stream per read: the fake copies each
    # range it serves, which the single stream does not ask of it.
    with knobs.override_parallel_read_ways(1):
        seconds, mismatched, moved, stats = restore_check(torch, ts, url, app_state, ref, phase_stats)
    ok = not mismatched and not moved and phase_n(stats, "s3_fanout") == 0
    emit({"phase": "s3_restore", "ok": ok, "parallel_read_ways": 1, "seconds": round(seconds, 3),
          "gbps": round(nbytes / GB / seconds, 3), "bit_exact": not mismatched, "data_ptr_unchanged": not moved,
          "counts": s3_counts(stats), "phases": phase_summary(stats)})
    if not ok:
        raise RuntimeError("s3_restore with one stream per read: not bit-exact in place, or a read fanned out")

    entry = snapshot.get_manifest()["0/model/embed/tokens"]
    phase_stats.reset()
    begin = time.monotonic()
    tokens = snapshot.read_object("0/model/embed/tokens", device=DEV)
    device_sync(torch)
    read_s = time.monotonic() - begin
    stats = phase_stats.snapshot()
    ok = tokens.device.type == DEV and bit_equal(torch, tokens, ref["embed/tokens"])
    emit({"phase": "s3_read_object", "ok": ok, "path": "0/model/embed/tokens", "chunks": len(entry.chunks),
          "device": str(tokens.device), "seconds": round(read_s, 3), "bytes": tokens.numel() * 2,
          "counts": s3_counts(stats)})
    del tokens
    left = delete_root(server, url)
    if not ok or left:
        raise RuntimeError(f"s3_read_object: wrong bytes or not on the card; {left} objects left after delete_dir")


def s3_incremental_phase(torch, ts, knobs, phase_stats, app_state, ref, nbytes, events, server, n_layers):
    """s3_incremental_take: step 0 as multipart uploads (threshold 128 MiB,
    parts 32 MiB); after mutate_step, step 1 with incremental_from=step 0:
    every unchanged payload a server-side copy, the bytes PUT within the
    whole-chunk bound of the change; step 1 restores bit-exact."""
    from torchsnapshot_tpu_torch import faults
    from torchsnapshot_tpu_torch.incremental import checksums_by_location

    root = f"s3://{S3_BUCKET}/incremental"
    model = app_state["model"].state_dict()
    before = server.stats()
    with knobs.override_env(knobs.S3_MULTIPART_THRESHOLD_ENV_VAR, str(S3_MULTIPART_THRESHOLD)), \
            knobs.override_env(knobs.S3_MULTIPART_PART_ENV_VAR, str(S3_MULTIPART_PART)):
        device_sync(torch)
        phase_stats.reset()
        begin = time.monotonic()
        ts.Snapshot.take(f"{root}/step_0", app_state)
        step0_s = time.monotonic() - begin
    stats0 = phase_stats.snapshot()
    after0 = server.stats(f"{S3_BUCKET}/incremental/step_0/")
    changed_bytes, _ = mutate_step(torch, model, ref)
    device_sync(torch)
    n_events = len(events)
    phase_stats.reset()
    faults.reset_write_counters()
    with knobs.override_faults("none"):
        begin = time.monotonic()
        snap1 = ts.Snapshot.take(f"{root}/step_1", app_state, incremental_from=f"{root}/step_0")
        step1_s = time.monotonic() - begin
    stats1 = phase_stats.snapshot()
    after1 = server.stats(f"{S3_BUCKET}/incremental/step_1/")
    put = sum(n for p, n in faults.write_counters().items() if payload_file(p))
    end = [e.metadata for e in events[n_events:] if e.name == "take.end"][-1]
    bound = whole_chunk_bound(snap1, model, ref)
    base = checksums_by_location(ts.Snapshot(f"{root}/step_0").metadata)
    unchanged = sum(1 for loc, c in checksums_by_location(snap1.metadata).items() if base.get(loc) == c)
    copies = after1["copies"] - after0["copies"]
    seconds, mismatched, moved, rstats = restore_check(torch, ts, f"{root}/step_1", app_state, ref, phase_stats)
    mutate_step(torch, model, ref)  # back to step 0's state
    multipart = phase_n(stats0, "s3_multipart")
    ok = (multipart > 0 and after0["multipart_completed"] - before["multipart_completed"] == multipart
          and after0["uploads_open"] == 0 and end["incremental_links"] == unchanged == copies > 0
          and phase_n(stats1, "s3_copy") == copies and 0 < put <= bound and not mismatched and not moved)
    emit({"phase": "s3_incremental_take", "ok": ok, "n_layers": n_layers,
          "step0_s": round(step0_s, 3), "step0_gbps": round(nbytes / GB / step0_s, 3),
          "multipart_threshold_bytes": S3_MULTIPART_THRESHOLD, "multipart_part_bytes": S3_MULTIPART_PART,
          "multipart_uploads": multipart, "multipart_parts": phase_n(stats0, "s3_multipart_part"),
          "single_puts": phase_n(stats0, "s3_put"), "step0_phases": phase_summary(stats0),
          "step1_s": round(step1_s, 3), "server_side_copies": copies, "incremental_links": end["incremental_links"],
          "unchanged_payloads": unchanged, "bytes_put": put, "bound_bytes": bound, "changed_bytes": changed_bytes,
          "state_bytes": nbytes, "step1_counts": s3_counts(stats1), "step1_phases": phase_summary(stats1),
          "restore_s": round(seconds, 3), "restore_gbps": round(nbytes / GB / seconds, 3),
          "bit_exact": not mismatched, "data_ptr_unchanged": not moved, "restore_counts": s3_counts(rstats),
          "server_rss_bytes": after1["rss_bytes"]})
    left = delete_root(server, root)
    if not ok or left:
        raise RuntimeError("s3_incremental_take: no multipart upload, an unchanged payload not copied server-side, "
                           f"bytes PUT past the bound, or not bit-exact; {left} objects left after delete_dir")


def layer_cut(ts, app_state, ref, n_layers):
    """The state cut to its first ``n_layers`` at full width: views of the
    stacked tensors' leading layers (so a restore lands in the full state),
    the other leaves whole, the same ``train`` and ``rng`` statefuls; the
    reference cut alike.  Returns (app state, reference, model bytes)."""
    def cut(path, t):
        return t[:n_layers] if path.startswith("layers/") else t

    model: dict = {}
    for path, t in leaves(app_state["model"].state_dict()):
        node = model
        *parents, last = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = cut(path, t)
    cut_ref = {p: cut(p, t) for p, t in ref.items()}
    nbytes = sum(t.numel() * t.element_size() for t in cut_ref.values())
    return {"model": ts.StateDict(model), "train": app_state["train"], "rng": app_state["rng"]}, cut_ref, nbytes


def cloud_cut_phase(torch, ts, knobs, phase_stats, app_state, ref, events, workdir, n_layers):
    """cloud_cut: the state the S3 and GCS phases take, the first
    ``CLOUD_LAYERS`` layers at full width (their rates are a Python fake's,
    not the port's).  The manager phases left the full state at their step
    5 (the patterns of steps 1-3 and 5 applied; step 4's was undone for
    ``restore_at(3)``); each pattern is an XOR of the same regions, so
    applying them again restores the take phase's state.  Then the fs
    incremental take of the cut (``cloud_cut_incremental_take``): its step
    0's digests are what the object-store takes are held to, its step 1's
    bytes what ``gcs_incremental_take`` must upload.  Returns (state,
    reference, bytes, step 0 manifest, step 1 bytes)."""
    model = app_state["model"].state_dict()
    for pattern in JOURNAL_PATTERNS[:3] + JOURNAL_PATTERNS[4:]:
        mutate_step(torch, model, ref, pattern)
    device_sync(torch)
    cut_layers = min(CLOUD_LAYERS, n_layers)
    state, cut_ref, nbytes = layer_cut(ts, app_state, ref, cut_layers)
    written, manifest = incremental_phase(torch, ts, knobs, phase_stats, state, cut_ref, nbytes, events, workdir,
                                          label="cloud_cut_incremental_take")
    emit({"phase": "cloud_cut", "ok": True, "n_layers": cut_layers, "depth_cut": cut_layers != N_LAYERS,
          "state_bytes": nbytes, "full_state_bytes": sum(t.numel() * t.element_size() for t in ref.values()),
          "manifest_entries": len(manifest), "incremental_step1_bytes": written})
    return state, cut_ref, nbytes, manifest, written


def s3_phases(torch, ts, knobs, phase_stats, app_state, ref, nbytes, events, buffered_manifest, n_layers):
    """The S3 phases, on ``cloud_cut``'s state."""
    memory = host_memory(torch)
    if memory["mem_available_bytes"] < nbytes + (8 << 30):
        # The server holds one copy of the state whole, and a little more
        # while a step's changed objects arrive.
        raise RuntimeError(f"s3: {memory['mem_available_bytes']} bytes of host RAM available, the fake server "
                           f"needs the state's {nbytes} and 8 GiB of slack")
    server = FakeServerChild(S3_CHILD, "S3")
    try:
        emit({"phase": "s3_start", "ok": True, "endpoint": server.endpoint, "n_layers": n_layers,
              "state_bytes": nbytes, **memory})
        with knobs.override_env(knobs.S3_ENDPOINT_ENV_VAR, server.endpoint):
            s3_take_phases(torch, ts, knobs, phase_stats, app_state, ref, nbytes, server, buffered_manifest, n_layers)
            s3_incremental_phase(torch, ts, knobs, phase_stats, app_state, ref, nbytes, events, server, n_layers)
    finally:
        server.stop()


# -------------------------------------------------------------- GCS phases
#
# The GCS backend at full size against tests/fake_gcs.py's FakeGCSServer,
# run in a child process like the S3 fake, with each object's generation
# computed once instead of on every request.  The numbers are those of a
# loopback fake in Python, not of GCS.  The take's snapshot is the base of
# the incremental phase, which deletes both roots through the plugin.

GCS_BUCKET = "smoke"
GCS_CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import fake_gcs
from fake_gcs import FakeGCSServer

# The fake's generation is the MD5 of the whole object, recomputed on every
# metadata GET and every media GET: a fanned-out 512 MB read would hash
# 4 GB.  GCS stores an object's generation with it, so the child memoizes it
# per stored bytes object (same values); entries of objects no longer
# stored go at the next stats call.
generations = {}
md5_generation = fake_gcs._generation


def stored_generation(data):
    hit = generations.get(id(data))
    if hit is None or hit[0] is not data:
        hit = generations[id(data)] = (data, md5_generation(data))
    return hit[1]


fake_gcs._generation = stored_generation
srv = FakeGCSServer()
# The handler writes a response's headers and its body in two sends; with
# Nagle's algorithm on, the body waits for the client's delayed ACK (about
# 40 ms) on every response that has one.  A server sends them at once.
srv._server.RequestHandlerClass.disable_nagle_algorithm = True
print(srv.endpoint, flush=True)


def rss():
    with open("/proc/self/status") as f:
        return next(int(line.split()[1]) * 1024 for line in f if line.startswith("VmRSS:"))


for line in sys.stdin:  # "<prefix>": the server's counters and the objects under it
    prefix = line.rstrip("\n")
    with srv._lock:
        live = {id(v) for v in srv.objects.values()}
        for key in [k for k in generations if k not in live]:
            generations.pop(key, None)
        # The fake keeps every upload session, and its bytes, for good.
        # Stats are read between takes, when no upload is in flight: a
        # session whose object is stored whole is done and goes, any other
        # is counted as left open.
        open_sessions = 0
        for sid, session in list(srv.sessions.items()):
            stored = srv.objects.get(session["bucket"] + "/" + session["name"])
            if stored is None or len(stored) != len(session["data"]):
                open_sessions += 1
            del srv.sessions[sid]
        keys = [k for k in srv.objects if k.startswith(prefix)]
        out = {"objects": len(keys), "bytes": sum(len(srv.objects[k]) for k in keys),
               "chunk_puts": srv.chunk_puts, "copies": srv.copies, "downloads": srv.downloads,
               "sessions_open": open_sessions}
    out["rss_bytes"] = rss()
    print(json.dumps(out), flush=True)
srv.stop()
"""


def gcs_counts(stats):
    return {k: phase_n(stats, k) for k in ("gcs_upload", "gcs_chunk_put", "gcs_get", "gcs_fanout", "gcs_copy",
                                           "gcs_retry")}


def gcs_take_phases(torch, ts, knobs, phase_stats, app_state, ref, nbytes, server, buffered_manifest, n_layers):
    """gcs_take, gcs_restore (then again with one stream per read) and
    gcs_read_object at default knobs; returns the snapshot's URL, the step 0
    of gcs_incremental_take."""
    url = f"gs://{GCS_BUCKET}/take"
    before = server.stats()
    device_sync(torch)
    phase_stats.reset()
    begin = time.monotonic()
    snapshot = ts.Snapshot.take(url, app_state)
    take_s = time.monotonic() - begin
    stats = phase_stats.snapshot()
    stored = server.stats(f"{GCS_BUCKET}/take/")
    want, got = model_digests(buffered_manifest), model_digests(snapshot.get_manifest())
    differ = sorted(str(k) for k in set(want) | set(got) if want.get(k) != got.get(k))
    d2h_bytes = int(stats.get("d2h", {}).get("bytes", 0))
    take_ok = (bool(want) and not differ and stored["sessions_open"] == 0
               and phase_n(stats, "gcs_upload") == stored["objects"]
               and (d2h_bytes == nbytes or DEV != "cuda"))
    emit({"phase": "gcs_take", "ok": take_ok, "server": "tests/fake_gcs.py in a child process, loopback",
          "n_layers": n_layers, "depth_cut": n_layers != N_LAYERS, "seconds": round(take_s, 3),
          "gbps": round(nbytes / GB / take_s, 3), "objects_stored": stored["objects"], "bytes_stored": stored["bytes"],
          "chunk_puts": stored["chunk_puts"] - before["chunk_puts"], "state_bytes": nbytes, "d2h_bytes": d2h_bytes,
          "digests_compared": len(want), "digests_differ": differ[:5], "server_rss_bytes": stored["rss_bytes"],
          "counts": gcs_counts(stats), "phases": phase_summary(stats)})
    if not take_ok:
        raise RuntimeError(f"gcs_take: d2h bytes {d2h_bytes}, an upload left open, or digests differ from the take "
                           f"phase's: {differ[:5]}")

    before = server.stats()
    seconds, mismatched, moved, stats = restore_check(torch, ts, url, app_state, ref, phase_stats)
    after = server.stats()
    h2d_bytes = int(stats.get("h2d_dispatch", {}).get("bytes", 0))
    ok = (not mismatched and not moved and phase_n(stats, "gcs_fanout") > 0
          and (h2d_bytes == nbytes or DEV != "cuda"))
    emit({"phase": "gcs_restore", "ok": ok, "n_layers": n_layers, "seconds": round(seconds, 3),
          "gbps": round(nbytes / GB / seconds, 3), "h2d_bytes": h2d_bytes, "state_bytes": nbytes,
          "bit_exact": not mismatched, "data_ptr_unchanged": not moved, "mismatched": mismatched[:5],
          "fanout_reads": phase_n(stats, "gcs_fanout"), "downloads": after["downloads"] - before["downloads"],
          "counts": gcs_counts(stats), "phases": phase_summary(stats)})
    if not ok:
        raise RuntimeError("gcs_restore: not bit-exact in place, h2d bytes differ, or no read fanned out")
    # The same restore with one stream per read (ranged GETs of 100 MiB).
    before = server.stats()
    with knobs.override_parallel_read_ways(1):
        seconds, mismatched, moved, stats = restore_check(torch, ts, url, app_state, ref, phase_stats)
    after = server.stats()
    ok = not mismatched and not moved and phase_n(stats, "gcs_fanout") == 0
    emit({"phase": "gcs_restore", "ok": ok, "parallel_read_ways": 1, "seconds": round(seconds, 3),
          "gbps": round(nbytes / GB / seconds, 3), "bit_exact": not mismatched, "data_ptr_unchanged": not moved,
          "downloads": after["downloads"] - before["downloads"], "counts": gcs_counts(stats),
          "phases": phase_summary(stats)})
    if not ok:
        raise RuntimeError("gcs_restore with one stream per read: not bit-exact in place, or a read fanned out")

    entry = snapshot.get_manifest()["0/model/embed/tokens"]
    phase_stats.reset()
    begin = time.monotonic()
    tokens = snapshot.read_object("0/model/embed/tokens", device=DEV)
    device_sync(torch)
    read_s = time.monotonic() - begin
    stats = phase_stats.snapshot()
    ok = tokens.device.type == DEV and bit_equal(torch, tokens, ref["embed/tokens"])
    emit({"phase": "gcs_read_object", "ok": ok, "path": "0/model/embed/tokens", "chunks": len(entry.chunks),
          "device": str(tokens.device), "seconds": round(read_s, 3), "bytes": tokens.numel() * 2,
          "counts": gcs_counts(stats)})
    del tokens
    if not ok:
        raise RuntimeError("gcs_read_object: wrong bytes or not on the card")
    return url


def gcs_incremental_phase(torch, ts, knobs, phase_stats, app_state, ref, nbytes, events, server, n_layers,
                          fs_incremental_bytes, base_url):
    """gcs_incremental_take: after mutate_step, step 1 with
    incremental_from=``base_url`` (gcs_take's snapshot, the step 0): the
    bytes uploaded exactly the fs incremental_take's, every unchanged
    payload one rewriteTo copy; step 1 restores bit-exact (one stream per
    read: the fan-out is gcs_restore's)."""
    from torchsnapshot_tpu_torch import faults
    from torchsnapshot_tpu_torch.incremental import checksums_by_location

    root = f"gs://{GCS_BUCKET}/incremental"
    model = app_state["model"].state_dict()
    after0 = server.stats()
    changed_bytes, _ = mutate_step(torch, model, ref)
    device_sync(torch)
    n_events = len(events)
    phase_stats.reset()
    faults.reset_write_counters()
    with knobs.override_faults("none"):
        begin = time.monotonic()
        snap1 = ts.Snapshot.take(f"{root}/step_1", app_state, incremental_from=base_url)
        step1_s = time.monotonic() - begin
    stats1 = phase_stats.snapshot()
    after1 = server.stats(f"{GCS_BUCKET}/incremental/step_1/")
    uploaded = sum(n for p, n in faults.write_counters().items() if payload_file(p))
    end = [e.metadata for e in events[n_events:] if e.name == "take.end"][-1]
    bound = whole_chunk_bound(snap1, model, ref)
    base = checksums_by_location(ts.Snapshot(base_url).metadata)
    unchanged = sum(1 for loc, c in checksums_by_location(snap1.metadata).items() if base.get(loc) == c)
    copies = after1["copies"] - after0["copies"]
    with knobs.override_parallel_read_ways(1):
        seconds, mismatched, moved, rstats = restore_check(torch, ts, f"{root}/step_1", app_state, ref, phase_stats)
    mutate_step(torch, model, ref)  # back to step 0's state
    ok = (after1["sessions_open"] == 0
          and end["incremental_links"] == unchanged == copies > 0 and phase_n(stats1, "gcs_copy") == copies
          and uploaded == fs_incremental_bytes and 0 < uploaded <= bound and not mismatched and not moved)
    emit({"phase": "gcs_incremental_take", "ok": ok, "n_layers": n_layers, "base": base_url,
          "step1_s": round(step1_s, 3), "step1_chunk_puts": after1["chunk_puts"] - after0["chunk_puts"],
          "rewrite_copies": copies,
          "incremental_links": end["incremental_links"], "unchanged_payloads": unchanged, "bytes_uploaded": uploaded,
          "fs_incremental_bytes": fs_incremental_bytes, "bound_bytes": bound, "changed_bytes": changed_bytes,
          "state_bytes": nbytes, "step1_counts": gcs_counts(stats1), "step1_phases": phase_summary(stats1),
          "restore_parallel_read_ways": 1, "restore_s": round(seconds, 3),
          "restore_gbps": round(nbytes / GB / seconds, 3), "bit_exact": not mismatched, "data_ptr_unchanged": not moved,
          "restore_counts": gcs_counts(rstats), "server_rss_bytes": after1["rss_bytes"]})
    left = delete_root(server, root) + delete_root(server, base_url)
    if not ok or left:
        raise RuntimeError("gcs_incremental_take: an upload left open, an unchanged payload not copied by rewriteTo, "
                           f"bytes uploaded other than the fs incremental take's {fs_incremental_bytes}, or not "
                           f"bit-exact; {left} objects left after delete_dir")


def gcs_phases(torch, ts, knobs, phase_stats, app_state, ref, nbytes, events, buffered_manifest, n_layers,
               fs_incremental_bytes):
    """The GCS phases, on ``cloud_cut``'s state (the S3 phases leave it
    so); ``fs_incremental_bytes`` is ``cloud_cut``'s step 1."""
    memory = host_memory(torch)
    if memory["mem_available_bytes"] < 2 * nbytes + (8 << 30):
        # The server holds the state whole, and its upload sessions hold it
        # once more until the take's stats call drops them.
        raise RuntimeError(f"gcs: {memory['mem_available_bytes']} bytes of host RAM available, the fake server "
                           f"needs twice the state's {nbytes} and 8 GiB of slack")
    server = FakeServerChild(GCS_CHILD, "GCS")
    try:
        emit({"phase": "gcs_start", "ok": True, "endpoint": server.endpoint, "n_layers": n_layers,
              "state_bytes": nbytes, **memory})
        with knobs.override_env(knobs.GCS_ENDPOINT_ENV_VAR, server.endpoint):
            base_url = gcs_take_phases(torch, ts, knobs, phase_stats, app_state, ref, nbytes, server,
                                       buffered_manifest, n_layers)
            gcs_incremental_phase(torch, ts, knobs, phase_stats, app_state, ref, nbytes, events, server, n_layers,
                                  fs_incremental_bytes, base_url)
    finally:
        server.stop()


# ------------------------------------------------------ replication phases
#
# copy_snapshot at full size: a fresh fs take replicated by hard links and
# streamed, then to the fake S3 and within its bucket; a CAS root chunk by
# chunk runs inside the storage phases, on cas_take's root.  Each copy's
# audit (verify=True) is timed apart from the copy by wrapping
# integrity.audit, which copy_snapshot calls through its module.

REPLICATE_COUNTED = ("native_read", "checksum", "native_write_hash", "s3_put", "s3_copy", "s3_get")
STREAM_RSS_SLACK = 512 << 20  # over the copy's 2 GiB budget: one payload (chunks are at most 512 MB)


def timed_copy(ts, phase_stats, src, dst, audit_env=None, **kwargs):
    """``copy_snapshot(src, dst, **kwargs)``, with every audit it runs timed
    apart (under ``audit_env()`` when given): (copy seconds less the audits,
    audit seconds, audit results, phase stats)."""
    import contextlib

    from torchsnapshot_tpu_torch import integrity

    real = integrity.audit
    audits = []

    def audit(storage, metadata, io_concurrency=4):
        begin = time.monotonic()
        with (audit_env or contextlib.nullcontext)():
            result = real(storage, metadata, io_concurrency=io_concurrency)
        audits.append((time.monotonic() - begin, result))
        return result

    integrity.audit = audit
    phase_stats.reset()
    try:
        begin = time.monotonic()
        ts.copy_snapshot(src, dst, **kwargs)
        total_s = time.monotonic() - begin
    finally:
        integrity.audit = real
    audit_s = sum(a for a, _ in audits)
    return total_s - audit_s, audit_s, [r for _, r in audits], phase_stats.snapshot()


def replicate_counts(stats):
    return {k: {"n": phase_n(stats, k), "bytes": int(stats.get(k, {}).get("bytes", 0))} for k in REPLICATE_COUNTED}


def checksummed_items(metadata) -> int:
    from torchsnapshot_tpu_torch import integrity

    return sum(1 for c in integrity.payload_checksums(metadata).values() if c)


def payload_locations(metadata):
    from torchsnapshot_tpu_torch.manifest import iter_payload_entries

    return sorted({e.location for _, e in iter_payload_entries(metadata.manifest)})


def same_inode(a: str, b: str) -> bool:
    return os.stat(a).st_ino == os.stat(b).st_ino


def read_file(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def replicate_fs_phases(torch, ts, phase_stats, RSSWatermark, app_state, ref, nbytes, workdir):
    """replicate_fs_link and replicate_fs_stream from a fresh fs take of the
    state; returns the take's path (the S3 phase's source)."""
    src = os.path.join(workdir, "replicate_src")
    device_sync(torch)
    begin = time.monotonic()
    metadata = ts.Snapshot.take(src, app_state).metadata
    take_s = time.monotonic() - begin
    items = checksummed_items(metadata)
    locations = payload_locations(metadata)
    payload_bytes = dir_bytes(src)
    marker = read_file(os.path.join(src, ".snapshot_metadata"))

    dst = os.path.join(workdir, "replicate_link")
    copy_s, audit_s, audits, stats = timed_copy(ts, phase_stats, src, dst, verify=True)
    linked = sum(same_inode(os.path.join(src, loc), os.path.join(dst, loc)) for loc in locations)
    marker_equal = read_file(os.path.join(dst, ".snapshot_metadata")) == marker
    seconds, mismatched, moved, rstats = restore_check(torch, ts, dst, app_state, ref, phase_stats)
    ok = (linked == len(locations) > 0 and marker_equal and audits == [(items, 0, 0, [])]
          and not mismatched and not moved)
    emit({"phase": "replicate_fs_link", "ok": ok, "source_take_s": round(take_s, 3), "state_bytes": nbytes,
          "payload_bytes": payload_bytes, "payloads": len(locations), "linked": linked,
          "marker_byte_equal": marker_equal, "copy_s": round(copy_s, 3), "audit_s": round(audit_s, 3),
          "audit_gbps": round(payload_bytes / GB / audit_s, 3) if audit_s else None,
          "audit_ok": audits[0][0] if audits else None, "checksummed_items": items,
          "counts": replicate_counts(stats), "restore_s": round(seconds, 3), "bit_exact": not mismatched,
          "data_ptr_unchanged": not moved, "phases": phase_summary(stats)})
    shutil.rmtree(dst)
    if not ok:
        raise RuntimeError("replicate_fs_link: a payload not linked, the marker differs, the audit was not "
                           "clean over every checksummed item, or the replica did not restore bit-exact")

    dst = os.path.join(workdir, "replicate_stream")
    watermark = RSSWatermark()
    with RSSSampler(watermark):
        copy_s, audit_s, audits, stats = timed_copy(ts, phase_stats, src, dst, verify=True, force_stream=True)
    rss_bound = (2 << 30) + STREAM_RSS_SLACK
    linked = sum(same_inode(os.path.join(src, loc), os.path.join(dst, loc)) for loc in locations)
    seconds, mismatched, moved, rstats = restore_check(torch, ts, dst, app_state, ref, phase_stats)
    # One flipped byte in the replica's largest payload file.
    victim = max(locations, key=lambda loc: os.path.getsize(os.path.join(dst, loc)))
    with open(os.path.join(dst, victim), "r+b") as f:
        f.seek(os.path.getsize(os.path.join(dst, victim)) // 2)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0x40]))
    # The audit through the command line: its problem lines come before
    # the compression line, its counts on the last.
    begin = time.monotonic()
    verify_rc, verify_out = run_cli(["verify", dst], "replicate_fs_stream", expect=1)
    flipped_audit_s = time.monotonic() - begin
    lines = verify_out.splitlines()
    problems = lines[: next((i for i, line in enumerate(lines) if line.startswith("compression:")), 0)]
    counts = re.fullmatch(r"verified (\d+) payloads, (\d+) corrupt, (\d+) unreadable", lines[-1] if lines else "")
    flipped_ok, corrupt, unreadable = (int(n) for n in counts.groups()) if counts else (None, None, None)
    try:
        ts.Snapshot(dst).restore(app_state)
        raised = None
    except ts.ChecksumError as e:
        raised = str(e)
    model = app_state["model"].state_dict()
    damaged = [p for p in ref if not bit_equal(torch, get_leaf(model, p), ref[p])]
    recovered = True
    if damaged:  # the failed restore overwrote part of the state: put it back from the source
        _, bad, _, _ = restore_check(torch, ts, src, app_state, ref, phase_stats)
        recovered = not bad
    ok = (linked == 0 and watermark.delta <= rss_bound and audits == [(items, 0, 0, [])] and not mismatched
          and not moved and verify_rc == 1 and (flipped_ok, corrupt, unreadable) == (items - 1, 1, 0)
          and len(problems) == 1 and victim in problems[0] and raised is not None and recovered)
    emit({"phase": "replicate_fs_stream", "ok": ok, "force_stream": True, "payload_bytes": payload_bytes,
          "payloads": len(locations), "linked": linked, "copy_s": round(copy_s, 3),
          "copy_gbps": round(payload_bytes / GB / copy_s, 3), "audit_s": round(audit_s, 3),
          "audit_ok": audits[0][0] if audits else None, "checksummed_items": items,
          "rss_growth_bytes": watermark.delta, "rss_bound_bytes": rss_bound, "counts": replicate_counts(stats),
          "restore_s": round(seconds, 3), "bit_exact": not mismatched, "data_ptr_unchanged": not moved,
          "flipped": victim, "verify_exit_code": verify_rc, "verify_last_line": lines[-1] if lines else None,
          "flipped_audit": [flipped_ok, corrupt, unreadable], "flipped_audit_s": round(flipped_audit_s, 3),
          "problems": problems[:2], "checksum_error": raised,
          "leaves_overwritten_by_failed_restore": len(damaged), "recovered_from_source": recovered,
          "phases": phase_summary(stats)})
    shutil.rmtree(dst)
    if not ok:
        raise RuntimeError("replicate_fs_stream: a payload linked, RSS past the byte budget, an unclean audit, "
                           "no bit-exact restore, or the flipped byte not caught as one corrupt item")
    return src


def replicate_s3_phase(torch, ts, knobs, phase_stats, app_state, ref, nbytes, src, n_layers):
    """replicate_s3: the fs take copied to the fake S3 (verify=True, the
    audit one GET per read), then within the bucket to another prefix: one
    server-side copy per payload and no payload byte PUT; the second
    replica restores bit-exact in place."""
    memory = host_memory(torch)
    if memory["mem_available_bytes"] < 3 * nbytes:
        raise RuntimeError(f"replicate_s3: {memory['mem_available_bytes']} bytes of host RAM available, "
                           f"less than three times the state's {nbytes}")
    metadata = ts.Snapshot(src).metadata
    items = checksummed_items(metadata)
    locations = payload_locations(metadata)
    payload_bytes = dir_bytes(src)
    marker_bytes = os.path.getsize(os.path.join(src, ".snapshot_metadata"))
    server = FakeServerChild(S3_CHILD, "S3")
    try:
        with knobs.override_env(knobs.S3_ENDPOINT_ENV_VAR, server.endpoint):
            url = f"s3://{S3_BUCKET}/replica"
            before = server.stats()
            copy_s, audit_s, audits, stats = timed_copy(
                ts, phase_stats, src, url, verify=True, audit_env=lambda: knobs.override_parallel_read_ways(1))
            stored = server.stats(f"{S3_BUCKET}/replica/")
            put = stored["put_bytes"] - before["put_bytes"]
            ok = (stored["objects"] == len(locations) + 1 and stored["bytes"] == payload_bytes + marker_bytes
                  and put == stored["bytes"] and audits == [(items, 0, 0, [])] and phase_n(stats, "s3_fanout") == 0)
            emit({"phase": "replicate_s3", "ok": ok, "route": "fs_to_s3", "n_layers": n_layers,
                  "server": "tests/fake_s3.py in a child process, loopback", "payload_bytes": payload_bytes,
                  "objects_stored": stored["objects"], "bytes_stored": stored["bytes"], "bytes_put": put,
                  "copy_s": round(copy_s, 3), "copy_gbps": round(payload_bytes / GB / copy_s, 3),
                  "audit_s": round(audit_s, 3), "audit_ok": audits[0][0] if audits else None,
                  "checksummed_items": items, "counts": replicate_counts(stats), "server_rss_bytes":
                  stored["rss_bytes"], **memory, "phases": phase_summary(stats)})
            if not ok:
                raise RuntimeError("replicate_s3 (fs to s3): objects or bytes stored differ from the source's, "
                                   "or the audit was not clean")
            url2 = f"s3://{S3_BUCKET}/replica2"
            before = server.stats()
            copy_s, _, _, stats = timed_copy(ts, phase_stats, url, url2)
            after = server.stats(f"{S3_BUCKET}/replica2/")
            copies, put = after["copies"] - before["copies"], after["put_bytes"] - before["put_bytes"]
            # One GET per read, as s3_restore's second form: the fan-out was
            # timed there, and against this fake it only costs.
            with knobs.override_parallel_read_ways(1):
                seconds, mismatched, moved, rstats = restore_check(torch, ts, url2, app_state, ref, phase_stats)
            ok = (copies == len(locations) == phase_n(stats, "s3_copy") and put == marker_bytes
                  and after["bytes"] == payload_bytes + marker_bytes and not mismatched and not moved)
            emit({"phase": "replicate_s3", "ok": ok, "route": "s3_to_s3_same_bucket", "copy_s": round(copy_s, 3),
                  "restore_parallel_read_ways": 1,
                  "server_side_copies": copies, "payloads": len(locations), "bytes_put": put,
                  "marker_bytes": marker_bytes, "counts": replicate_counts(stats), "restore_s": round(seconds, 3),
                  "restore_gbps": round(nbytes / GB / seconds, 3), "bit_exact": not mismatched,
                  "data_ptr_unchanged": not moved, "restore_counts": s3_counts(rstats),
                  "phases": phase_summary(stats)})
            left = delete_root(server, url) + delete_root(server, url2)
            if not ok or left:
                raise RuntimeError("replicate_s3 (s3 to s3): a payload not copied server-side, payload bytes "
                                   f"PUT, or not bit-exact; {left} objects left after delete_dir")
    finally:
        server.stop()


def replicate_cas_chain_phase(torch, ts, phase_stats, app_state, ref, root, workdir):
    """replicate_cas_chain: cas_take's step 0, then step 1, copied to a new
    fs root with verify=True; step 1's copy adds exactly the chunks step 1
    references and step 0 does not, and restores bit-exact in place (the
    state is at step 1)."""
    from torchsnapshot_tpu_torch import cas

    refs = {s: cas.referenced_chunk_relpaths(ts.Snapshot(os.path.join(root, s)).metadata.manifest)
            for s in ("step_0", "step_1")}
    new_chunks = refs["step_1"] - refs["step_0"]
    new_bytes = sum(os.path.getsize(os.path.join(root, rel)) for rel in new_chunks)
    dst_root = os.path.join(workdir, "replicate_cas")
    copy0_s, audit0_s, audits0, stats0 = timed_copy(ts, phase_stats, os.path.join(root, "step_0"),
                                                    os.path.join(dst_root, "step_0"), verify=True)
    chunks0 = chunks_on_disk(dst_root)
    copy1_s, audit1_s, audits1, stats1 = timed_copy(ts, phase_stats, os.path.join(root, "step_1"),
                                                    os.path.join(dst_root, "step_1"), verify=True)
    chunks1 = chunks_on_disk(dst_root)
    added = set(chunks1) - set(chunks0)
    added_bytes = sum(chunks1[rel] for rel in added)
    seconds, mismatched, moved, rstats = restore_check(torch, ts, os.path.join(dst_root, "step_1"), app_state, ref,
                                                       phase_stats)
    clean = all(a[1:] == (0, 0, []) and a[0] > 0 for a in audits0 + audits1)
    ok = (set(chunks0) == refs["step_0"] and added == new_chunks and added_bytes == new_bytes and clean
          and len(audits0) == len(audits1) == 1 and not mismatched and not moved)
    emit({"phase": "replicate_cas_chain", "ok": ok, "step0_chunks": len(refs["step_0"]),
          "step0_chunks_copied": len(chunks0), "step0_copy_s": round(copy0_s, 3), "step0_audit_s":
          round(audit0_s, 3), "step0_audit_ok": audits0[0][0] if audits0 else None,
          "step1_chunks_copied": len(added), "step1_chunks_skipped": len(refs["step_1"]) - len(added),
          "step1_new_chunks": len(new_chunks), "step1_copied_bytes": added_bytes, "step1_new_chunk_bytes": new_bytes,
          "step1_copy_s": round(copy1_s, 3), "step1_audit_s": round(audit1_s, 3),
          "step1_audit_ok": audits1[0][0] if audits1 else None, "step0_counts": replicate_counts(stats0),
          "step1_counts": replicate_counts(stats1), "restore_s": round(seconds, 3), "bit_exact": not mismatched,
          "data_ptr_unchanged": not moved})
    shutil.rmtree(dst_root)
    if not ok:
        raise RuntimeError("replicate_cas_chain: step 1's copy added other chunks than step 1's new ones, an "
                           "audit was not clean, or the replica did not restore bit-exact")


def replicate_phases(torch, ts, knobs, phase_stats, RSSWatermark, app_state, ref, nbytes, workdir, n_layers):
    src = replicate_fs_phases(torch, ts, phase_stats, RSSWatermark, app_state, ref, nbytes, workdir)
    shutil.rmtree(src)
    # replicate_s3 on the 8-layer cut, as the other S3 phases: its rates are
    # the Python fake's, not the port's.
    cut_layers = min(CLOUD_LAYERS, n_layers)
    cut_state, cut_ref, cut_nbytes = layer_cut(ts, app_state, ref, cut_layers)
    cut_src = os.path.join(workdir, "replicate_cut_src")
    ts.Snapshot.take(cut_src, cut_state)
    try:
        replicate_s3_phase(torch, ts, knobs, phase_stats, cut_state, cut_ref, cut_nbytes, cut_src, cut_layers)
    finally:
        shutil.rmtree(cut_src)


# ------------------------------------------------------ shared store phases
#
# Two tenant roots A and B share one store S: SnapshotManager(root, store=S,
# max_to_keep=1), the configuration of many fine-tunes of one frozen
# backbone.  The state is the full one; S, A and B are removed at the end.


def store_refs(ts, root, step):
    from torchsnapshot_tpu_torch import cas

    return cas.referenced_chunk_relpaths(ts.Snapshot(os.path.join(root, f"step_{step}")).metadata.manifest)


def store_save(torch, mgr, step, app_state, events, phase_stats):
    """One manager save, metered: its wall, the chunk bytes its CAS writer
    wrote (``take.end``), the bytes the byte meter saw land under the
    store's ``cas/``, and the ``store.sweep`` events of its prune."""
    from torchsnapshot_tpu_torch import faults

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
    return snap, {
        "step": step, "wall_s": round(wall, 3), "chunk_bytes_written": cas_stats["physical_bytes_written"],
        "chunk_bytes_metered": sum(n for p, n in faults.write_counters().items() if p.startswith("cas/")),
        "chunks_written": cas_stats["chunks_written"], "adopted_bytes": cas_stats["adopted_bytes"],
        "dedup_hits": cas_stats["dedup_hits"], "prestage_hits": cas_stats["prestage_hits"],
        "prune_sweeps": [e.metadata for e in new_events if e.name == "store.sweep"],
        "phases": phase_summary(stats)}


def store_tenants_phase(torch, ts, knobs, phase_stats, app_state, ref, events, workdir):
    """store_tenants: A.save(0) writes the state's chunks into S; B.save(0)
    of the same state writes no chunk byte; after the step change B.save(1)
    writes exactly the chunks step 1 adds, and A.save(1) none; both prune
    step 0.  Returns (store, roots, step-0 chunks, step-1 chunks, the end of
    the last take whose journal names step-0 chunks)."""
    from torchsnapshot_tpu_torch import store
    from torchsnapshot_tpu_torch.manager import SnapshotManager

    S, A, B = (os.path.join(workdir, name) for name in ("store_S", "tenant_A", "tenant_B"))
    model = app_state["model"].state_dict()
    saves = []
    with knobs.override_faults("none"):
        ma = SnapshotManager(A, max_to_keep=1, store=S)
        mb = SnapshotManager(B, max_to_keep=1, store=S)
        _, rec = store_save(torch, ma, 0, app_state, events, phase_stats)
        saves.append(dict(rec, tenant="A"))
        refs0 = store_refs(ts, A, 0)
        sizes = {rel: os.path.getsize(os.path.join(S, rel)) for rel in refs0}
        _, rec = store_save(torch, mb, 0, app_state, events, phase_stats)
        saves.append(dict(rec, tenant="B"))
        step0_journaled_at = time.time()
        changed, _ = mutate_step(torch, model, ref)
        snap1, rec = store_save(torch, mb, 1, app_state, events, phase_stats)
        saves.append(dict(rec, tenant="B"))
        refs1 = store_refs(ts, B, 1)
        new_chunks = refs1 - refs0
        new_bytes = sum(os.path.getsize(os.path.join(S, rel)) for rel in new_chunks)
        bound = whole_chunk_bound(snap1, model, ref)
        _, rec = store_save(torch, ma, 1, app_state, events, phase_stats)
        saves.append(dict(rec, tenant="A"))
    usage = store.tenant_usage(S)
    ledger = sorted(os.path.relpath(os.path.join(d, f), S) for d, _, fs in os.walk(os.path.join(S, "ledger"))
                    for f in fs)
    points = [sorted(os.listdir(r)) for r in (A, B)]
    state_bytes = sum(sizes.values())
    ok = (saves[0]["chunk_bytes_written"] == saves[0]["chunk_bytes_metered"] == state_bytes > 0
          and saves[1]["chunk_bytes_written"] == saves[1]["chunk_bytes_metered"] == 0
          and saves[2]["chunk_bytes_written"] == saves[2]["chunk_bytes_metered"] == new_bytes
          and 0 < new_bytes <= bound
          and saves[3]["chunk_bytes_written"] == saves[3]["chunk_bytes_metered"] == 0
          and store_refs(ts, A, 1) == refs1 and len(ledger) == 4
          and usage["physical_bytes"] == state_bytes + new_bytes
          and all(t["logical_bytes"] == sum(sizes.get(c, 0) for c in refs1 - new_chunks) + new_bytes
                  for t in usage["tenants"].values())
          and all("step_0" not in names and "step_1" in names for names in points))
    emit({"phase": "store_tenants", "ok": ok, "max_to_keep": 1, "saves": saves, "changed_bytes": changed,
          "step0_chunks": len(refs0), "step0_chunk_bytes": state_bytes, "step1_new_chunks": len(new_chunks),
          "step1_new_chunk_bytes": new_bytes, "bound_bytes": bound, "ledger_files": ledger,
          "tenant_usage": {"logical_bytes": usage["logical_bytes"], "physical_bytes": usage["physical_bytes"],
                           "chunks": usage["chunks"], "dedup_ratio": usage["dedup_ratio"],
                           "tenants": {t["root"]: {k: t[k] for k in ("logical_bytes", "exclusive_bytes", "chunks")}
                                       for t in usage["tenants"].values()}},
          "root_files": points})
    if not ok:
        raise RuntimeError("store_tenants: a save wrote other chunk bytes than its new chunks (B's step 0 and A's "
                           "step 1 must write none), or the ledger, usage or retention is wrong")
    return S, (A, B), refs0, refs1, sizes, step0_journaled_at


def store_sweep_phase(torch, ts, knobs, phase_stats, app_state, ref, S, roots, refs0, refs1, sizes,
                      step0_journaled_at):
    """store_sweep: once the journals naming step-0 chunks are past the
    liveness grace, A.gc() at TPUSNAP_STORE_QUARANTINE_S=0 condemns, then
    deletes, exactly the step-0 versions of the changed chunks; every chunk
    left is classified referenced; a fresh Snapshot(...).restore of each
    tenant's step 1, with no knob set, resolves through the root's .store
    pointer and is bit-exact in place.  Removes S and the roots."""
    from torchsnapshot_tpu_torch import cas, store
    from torchsnapshot_tpu_torch.manager import SnapshotManager
    from torchsnapshot_tpu_torch.storage_plugin import url_to_storage_plugin

    A, B = roots
    stale = sorted(refs0 - refs1)
    stale_bytes = sum(sizes[c] for c in stale)
    # A reference journal protects its chunks for the liveness grace after
    # its take; gc waits it out, as a user's later gc would find it.
    wait_s = max(0.0, step0_journaled_at + store._liveness_grace() + 0.5 - time.time())
    time.sleep(wait_s)
    with knobs.override_store_quarantine_s(0.0):
        begin = time.monotonic()
        removed_steps, swept, _ = SnapshotManager(A, max_to_keep=1, store=S).gc_detail(apply=True)
        gc_s = time.monotonic() - begin
    storage = url_to_storage_plugin(S)
    try:
        present = cas.list_chunk_relpaths(storage)
        quarantined = store.quarantined_chunk_relpaths(storage)
    finally:
        storage.sync_close()
    cls = store.chunk_classification(S)
    restores = []
    for root in roots:
        seconds, mismatched, moved, rstats = restore_check(torch, ts, os.path.join(root, "step_1"), app_state, ref,
                                                           phase_stats)
        restores.append({"root": os.path.basename(root), "restore_s": round(seconds, 3), "bit_exact": not mismatched,
                         "data_ptr_unchanged": not moved, "mismatched": mismatched[:5],
                         "phases": phase_summary(rstats)})
    cli_ok, cli = cli_store_checks(S, A, cls)
    ok = (removed_steps == [] and swept == stale and len(stale) > 0 and quarantined == []
          and set(present) == refs1 and cls["referenced"] == sorted(refs1) and cls["orphan"] == []
          and cls["condemned"] == [] and knobs.get_store_url() is None
          and all(r["bit_exact"] and r["data_ptr_unchanged"] for r in restores) and cli_ok)
    emit({"phase": "store_sweep", "ok": ok, "quarantine_s": 0.0, "ledger_wait_s": round(wait_s, 3),
          "gc_s": round(gc_s, 4), "condemned_and_deleted": swept, "expected_chunks": stale,
          "condemned_and_deleted_bytes": sum(sizes[c] for c in swept if c in sizes),
          "expected_bytes": stale_bytes, "chunks_left": len(present), "classification":
          {k: len(v) for k, v in cls.items()}, "restores": restores, "cli": cli})
    for path in (S, *roots):
        shutil.rmtree(path)
    if not ok:
        raise RuntimeError("store_sweep: gc reclaimed other chunks than the unreferenced step-0 versions, a chunk "
                           "is unclassified, a tenant's restore through .store was not bit-exact in place, or a "
                           "CLI command printed other store lines than the library returned")


def cli_store_checks(S, A, cls):
    """The command line over tenant A of store S: ``info`` of its step 1
    names the store; ``stats`` prints one line per tenant of
    ``store.tenant_usage(S)``; the dry-run ``gc`` of A prints the counts of
    ``store.chunk_classification(S)`` (``cls``)."""
    from torchsnapshot_tpu_torch import store
    from torchsnapshot_tpu_torch.__main__ import _human

    step = os.path.join(A, "step_1")
    info_rc, info = run_cli(["info", step], "store_sweep")
    usage = store.tenant_usage(S)
    stats_rc, stats = run_cli(["stats", step], "store_sweep")
    tenants = [f"  tenant {tid} ({t['root']}): {_human(t['logical_bytes'])} logical, "
               f"{_human(t['exclusive_bytes'])} exclusive, {t['chunks']} chunk(s)"
               for tid, t in sorted(usage["tenants"].items())]
    gc_rc, gc = run_cli(["gc", A], "store_sweep")
    counts = (f"shared store {S}: {len(cls['referenced'])} referenced, {len(cls['orphan'])} orphan, "
              f"{len(cls['condemned'])} condemned chunk(s) store-wide")
    ok = (info_rc == stats_rc == gc_rc == 0 and info.splitlines()[-1] == f"store:       shared CAS at {S}"
          and len(tenants) == 2 and stats.splitlines()[-2:] == tenants and gc.splitlines()[-1] == counts)
    return ok, {"ok": ok, "info_store_line": info.splitlines()[-1] if info else None,
                "stats_tenant_lines": stats.splitlines()[-2:], "gc_store_line": gc.splitlines()[-1] if gc else None}


def store_phases(torch, ts, knobs, phase_stats, app_state, ref, events, workdir):
    S, roots, refs0, refs1, sizes, journaled_at = store_tenants_phase(torch, ts, knobs, phase_stats, app_state, ref,
                                                                      events, workdir)
    store_sweep_phase(torch, ts, knobs, phase_stats, app_state, ref, S, roots, refs0, refs1, sizes, journaled_at)


# ---------------------------------------------------- host cache phases
#
# The serving tier: TPUSNAP_CACHE_DIR=<workdir>/cache, origin metered by the
# fault wrapper (TPUSNAP_FAULTS=none; dot-files and telemetry/ left out).
# The take phase's snapshot is gone by now (each phase keeps the disk under
# two copies of the state), so cache_cold takes the same state anew.

CACHE_WORKERS = 2
CACHE_WORKER_LAYERS = 8  # full width; the parent holds state, reference and their takes on the card
SERVE_FLEET_INTERVAL_S = "0.1"  # the workers' fleet-telemetry interval (a knob's string value)


def origin_payload_bytes(faults) -> int:
    return sum(n for p, n in faults.read_counters().items() if payload_file(p))


def cached_restore(torch, ts, knobs, phase_stats, path, app_state, ref, cache_dir):
    """restore_check through the cache at ``cache_dir``, metered: (seconds,
    mismatched, moved, phase stats, origin payload bytes, cache totals)."""
    from torchsnapshot_tpu_torch import cache, faults

    with knobs.override_cache_dir(cache_dir), knobs.override_faults("none"):
        faults.reset_read_counters()
        cache.reset_process_stats()
        seconds, mismatched, moved, stats = restore_check(torch, ts, path, app_state, ref, phase_stats)
        return seconds, mismatched, moved, stats, origin_payload_bytes(faults), cache.process_stats()


def cache_data_files(cache_dir):
    """{data file: size} of the cache's complete entries."""
    out = {}
    for dirpath, _, files in os.walk(os.path.join(cache_dir, "objects")):
        for name in files:
            if not name.endswith((".meta", ".lock")) and ".tmp." not in name:
                out[os.path.join(dirpath, name)] = os.path.getsize(os.path.join(dirpath, name))
    return out


def cache_main_phases(torch, ts, knobs, phase_stats, app_state, ref, nbytes, workdir):
    """cache_cold, cache_warm and cache_corrupt on the full state."""
    from torchsnapshot_tpu_torch import cache, faults

    snap_path, cache_dir = os.path.join(workdir, "cache_snap"), os.path.join(workdir, "cache")
    free_disk = shutil.disk_usage(workdir).free
    if free_disk < 2 * nbytes + (4 << 30):
        raise RuntimeError(f"cache phases: {free_disk} B of free disk cannot hold the snapshot and its cache")
    device_sync(torch)
    begin = time.monotonic()
    ts.Snapshot.take(snap_path, app_state)
    take_s = time.monotonic() - begin
    on_disk = dir_bytes(snap_path)

    seconds, bad, moved, stats, origin, totals = cached_restore(torch, ts, knobs, phase_stats, snap_path, app_state,
                                                                ref, cache_dir)
    cached = cache_data_files(cache_dir)
    cold_ok = (not bad and not moved and origin == on_disk == totals["miss_bytes"] and totals["hit_bytes"] == 0
               and sum(cached.values()) == on_disk)
    emit({"phase": "cache_cold", "ok": cold_ok, "take_s": round(take_s, 3), "restore_s": round(seconds, 3),
          "gbps": round(nbytes / GB / seconds, 3), "state_bytes": nbytes, "payload_bytes_on_disk": on_disk,
          "origin_payload_bytes": origin, "miss_bytes": totals["miss_bytes"], "misses": totals["misses"],
          "hit_bytes": totals["hit_bytes"], "cache_entries": len(cached), "cache_bytes": sum(cached.values()),
          "cache_populate": stats.get("cache_populate"), "bit_exact": not bad, "data_ptr_unchanged": not moved,
          "mismatched": bad[:5], "free_disk_bytes": free_disk, "phases": phase_summary(stats)})
    if not cold_ok:
        raise RuntimeError("cache_cold: not bit-exact in place, or origin bytes, miss bytes and cached bytes differ "
                           "from the snapshot's payload")
    cold_miss = totals["miss_bytes"]

    seconds, bad, moved, stats, origin, totals = cached_restore(torch, ts, knobs, phase_stats, snap_path, app_state,
                                                                ref, cache_dir)
    with knobs.override_cache_dir(cache_dir), knobs.override_faults("none"):
        faults.reset_read_counters()
        cache.reset_process_stats()
        begin = time.monotonic()
        tokens = ts.Snapshot(snap_path).read_object("0/model/embed/tokens", device=DEV)
        device_sync(torch)
        read_s = time.monotonic() - begin
        read = {"path": "0/model/embed/tokens", "seconds": round(read_s, 3), "origin_payload_bytes":
                origin_payload_bytes(faults), "hit_bytes": cache.process_stats()["hit_bytes"],
                "bit_exact": bit_equal(torch, tokens, ref["embed/tokens"]), "device": str(tokens.device)}
    del tokens
    warm_ok = (not bad and not moved and origin == 0 and totals["miss_bytes"] == 0 and totals["hit_bytes"] == cold_miss
               and read["bit_exact"] and read["origin_payload_bytes"] == 0
               and read["hit_bytes"] == 2 * get_leaf(app_state["model"].state_dict(), "embed/tokens").numel())
    emit({"phase": "cache_warm", "ok": warm_ok, "restore_s": round(seconds, 3), "gbps": round(nbytes / GB / seconds, 3),
          "origin_payload_bytes": origin, "hit_bytes": totals["hit_bytes"], "hits": totals["hits"],
          "miss_bytes": totals["miss_bytes"], "cold_miss_bytes": cold_miss, "cache_read": stats.get("cache_read"),
          "page_cache": "warm: cache_cold wrote these files just before, so the hits read from the page cache",
          "bit_exact": not bad, "data_ptr_unchanged": not moved, "mismatched": bad[:5], "read_object": read,
          "phases": phase_summary(stats)})
    if not warm_ok:
        raise RuntimeError("cache_warm: origin was read, hit bytes differ from cache_cold's miss bytes, or a "
                           "result is not bit-exact")

    victim, victim_bytes = max(cache_data_files(cache_dir).items(), key=lambda kv: kv[1])
    with open(victim, "r+b") as f:  # 4 bytes flipped, the size kept
        f.seek(victim_bytes // 2)
        flipped = bytes(b ^ 0xFF for b in f.read(4))
        f.seek(victim_bytes // 2)
        f.write(flipped)
    seconds, bad, moved, stats, origin, totals = cached_restore(torch, ts, knobs, phase_stats, snap_path, app_state,
                                                                ref, cache_dir)
    corrupt_ok = (not bad and not moved and origin == victim_bytes == totals["miss_bytes"]
                  and totals["hit_bytes"] == cold_miss - victim_bytes and os.path.getsize(victim) == victim_bytes)
    emit({"phase": "cache_corrupt", "ok": corrupt_ok, "restore_s": round(seconds, 3), "corrupted_entry_bytes": victim_bytes,
          "flipped_bytes": 4, "origin_payload_bytes": origin, "miss_bytes": totals["miss_bytes"],
          "hit_bytes": totals["hit_bytes"], "bit_exact": not bad, "data_ptr_unchanged": not moved,
          "mismatched": bad[:5], "phases": phase_summary(stats)})
    for path in (snap_path, cache_dir):
        shutil.rmtree(path)
    if not corrupt_ok:
        raise RuntimeError("cache_corrupt: the corrupted entry was not re-fetched alone, or the restore is not "
                           "bit-exact")


def seeded_params(torch, n_layers: int, seed: int, zero: bool = False):
    """The parameter set at ``n_layers`` on the card, each tensor filled by
    ``seeded_fill`` (zeros with ``zero``)."""
    params: dict = {}
    for path, shape, _ in llama_shapes(n_layers):
        t = torch.zeros(shape, dtype=torch.bfloat16, device=DEV)
        if not zero:
            seeded_fill(torch, t, tensor_seed(seed, path), shape, [0] * len(shape))
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t
    return params


def restore_worker_entry(snap, knob_env, seed, n_layers, refilled, conn) -> None:
    """A spawned worker on the card: with the knobs of ``knob_env`` set,
    restore ``snap`` into zeroed tensors, check them against the seeded
    values (the paths in ``refilled`` at ``seed + 1``), send its numbers
    (or its traceback) to the parent."""
    import traceback

    try:
        os.environ.update(knob_env)
        import torch

        if DEV == "cuda":
            torch.cuda.set_device(0)
        sys.path.insert(0, HERE)
        import torchsnapshot_tpu_torch as ts
        from torchsnapshot_tpu_torch import cache, faults, peer, phase_stats

        params = seeded_params(torch, n_layers, seed, zero=True)
        device_sync(torch)
        begin = time.monotonic()
        ts.Snapshot(snap).restore({"model": ts.StateDict(params)})
        device_sync(torch)
        seconds = time.monotonic() - begin
        origin = origin_payload_bytes(faults)
        bad = []
        for path, shape, _ in llama_shapes(n_layers):
            node = params
            for key in path:
                node = node[key]
            path_seed = seed + 1 if "/".join(path) in refilled else seed
            if not seeded_fill(torch, node, tensor_seed(path_seed, path), shape, [0] * len(shape), check=True):
                bad.append("/".join(path))
        conn.send({"ok": True, "result": {"restore_s": seconds, "origin_payload_bytes": origin, "mismatched": bad,
                                          "jax_imported": "jax" in sys.modules, **cache.process_stats(),
                                          "peer": peer.process_stats(),
                                          "phases": phase_summary(phase_stats.snapshot())}})
    except BaseException:  # noqa: BLE001 — the parent fails the phase
        conn.send({"ok": False, "error": traceback.format_exc()})


def cache_two_workers_phase(torch, ts, knobs, args):
    """cache_two_workers: CACHE_WORKERS processes restore one snapshot onto
    the card at once through one fresh cache directory, publishing into one
    fleet spool (0.1 s interval), which the parent aggregates."""
    from torchsnapshot_tpu_torch.telemetry import fleet

    n_layers = min(CACHE_WORKER_LAYERS, args.n_layers)
    snap_path, cache_dir = os.path.join(args.workdir, "serve_snap"), os.path.join(args.workdir, "serve_cache")
    spool = os.path.join(snap_path, fleet.SPOOL_DIRNAME)
    logical = state_bytes(n_layers)
    ts.Snapshot.take(snap_path, {"model": ts.StateDict(seeded_params(torch, n_layers, args.seed))})
    if DEV == "cuda":
        torch.cuda.empty_cache()  # the workers' restores get the freed memory
    begin = time.monotonic()
    # With the metrics on, each worker's entries carry its registry, which
    # ``top --prometheus`` merges.
    knob_env = {"TPUSNAP_CACHE_DIR": cache_dir, "TPUSNAP_FAULTS": "none", "TPUSNAP_FLEET_TELEMETRY": spool,
                "TPUSNAP_FLEET_TELEMETRY_INTERVAL_S": SERVE_FLEET_INTERVAL_S, "TPUSNAP_METRICS": "1"}
    workers = spawn_collect(restore_worker_entry, [(snap_path, knob_env, args.seed, n_layers, ())] * CACHE_WORKERS,
                            "cache_two_workers", "worker")
    wall = time.monotonic() - begin
    origin = sum(w["origin_payload_bytes"] for w in workers)
    miss = sum(w["miss_bytes"] for w in workers)
    hit = sum(w["hit_bytes"] for w in workers)
    view = fleet.aggregate(fleet.collect(spool, stale_s=600, sweep=False))
    cli = cli_top_checks(fleet, spool, view)
    time.sleep(0.05)
    aged_out = len(fleet.collect(spool, stale_s=0.001))
    fleet_ok = (view["n_processes"] == CACHE_WORKERS and view["n_entries"] == CACHE_WORKERS
                and all(w["kind"] == "restore" and w["state"] == "done" for w in view["workers"])
                and view["cache"]["hit_bytes"] == hit and view["cache"]["miss_bytes"] == miss
                and view["cache"]["origin_bytes"] <= 1.25 * logical and aged_out == 0 and cli["ok"])
    ok = (miss <= 1.25 * logical and hit + miss == CACHE_WORKERS * logical and origin == miss
          and all(not w["mismatched"] and not w["jax_imported"] for w in workers) and fleet_ok)
    emit({"phase": "cache_two_workers", "ok": ok, "workers": CACHE_WORKERS, "n_layers": n_layers,
          "depth_cut": n_layers != N_LAYERS, "logical_bytes": logical, "wall_s": round(wall, 3),
          "origin_payload_bytes": origin, "miss_bytes": miss, "hit_bytes": hit,
          "origin_over_logical": round(miss / logical, 4), "bound": "miss <= 1.25 x logical, hit + miss = 2 x logical",
          "per_worker": [{k: (round(v, 3) if isinstance(v, float) else v) for k, v in w.items()
                          if k not in ("peer", "phases")} for w in workers],
          "fleet": {"ok": fleet_ok, "interval_s": float(SERVE_FLEET_INTERVAL_S), "n_processes": view["n_processes"],
                    "n_entries": view["n_entries"], "states": [w["state"] for w in view["workers"]],
                    "cache": view["cache"], "publishes": [w["proc"].get("publishes") for w in view["workers"]],
                    "overhead_s": [w["proc"].get("overhead_s") for w in view["workers"]],
                    "entries_after_stale_0.001": aged_out, "cli": cli}})
    for path in (snap_path, cache_dir):
        shutil.rmtree(path)
    if not ok:
        raise RuntimeError("cache_two_workers: origin bytes over 1.25x the logical bytes, hit + miss not twice "
                           "them, a worker's tensors differ from the seeded values, the fleet view is not both "
                           "workers done with the workers' own cache totals, or the CLI's top differs from it")


# Read at call time, so left out where ``top --json`` is held against the
# library's view: an entry's age, the view's time, a suspect's last beacon.
CALL_TIME_KEYS = ("age_s", "time", "last_seen_s")


def without_call_time(obj):
    if isinstance(obj, dict):
        return {k: without_call_time(v) for k, v in obj.items() if k not in CALL_TIME_KEYS}
    if isinstance(obj, list):
        return [without_call_time(v) for v in obj]
    return obj


def cli_top_json(fleet, spool, stale_s, phase):
    """``top <spool> --json --stale S`` against ``aggregate(collect(spool,
    stale_s=S, sweep=False))`` read just before it, apart from ages: (exit
    code, equal, the CLI's view)."""
    want = without_call_time(json.loads(json.dumps(fleet.aggregate(fleet.collect(spool, stale_s=stale_s,
                                                                                  sweep=False)))))
    rc, out = run_cli(["top", spool, "--json", "--stale", str(stale_s)], phase)
    try:
        got = json.loads(out)
    except ValueError:
        got = {}
    return rc, without_call_time(got) == want, got


def cli_top_checks(fleet, spool, view):
    """The CLI over cache_two_workers' spool: ``top --json`` is the
    library's view; ``top --prometheus`` carries each worker's registry
    (its ``worker`` label) and two fleet workers; ``top --once``, last
    (its table sweeps stale entries), names both workers' pids."""
    workers = [w["worker"] for w in view["workers"]]
    rc, same, _ = cli_top_json(fleet, spool, 600, "cache_two_workers")
    rc_prom, prom = run_cli(["top", spool, "--prometheus", "--stale", "600"], "cache_two_workers")
    prom_ok = (rc_prom == 0 and "tpusnap_fleet_workers 2" in prom.splitlines()
               and all(f'worker="{w}"' in prom for w in workers))
    rc_once, table = run_cli(["top", spool, "--once", "--stale", "600"], "cache_two_workers")
    pids = [w.rsplit(":", 1)[1] for w in workers]
    once_ok = rc_once == 0 and len(pids) == 2 and all(re.search(rf":{pid}\b", table) for pid in pids)
    return {"ok": rc == 0 and same and prom_ok and once_ok, "json_equal": same,
            "prometheus_lines": len(prom.splitlines()), "prometheus_workers": prom_ok, "once_names_pids": once_ok,
            "pids": pids}


def cache_phases(torch, ts, knobs, phase_stats, app_state, ref, nbytes, args):
    cache_main_phases(torch, ts, knobs, phase_stats, app_state, ref, nbytes, args.workdir)
    cache_two_workers_phase(torch, ts, knobs, args)


# ------------------------------------------------------------ peer phases
#
# The peer tier on an 8-layer cut of the Llama-3-8B widths taken with
# TPUSNAP_CAS=1 (peers serve only digest-addressed chunks): port daemons,
# each in a spawned process advertising 127.0.0.1 on a FileStore registry
# under the work directory, serve their caches to spawned workers that
# restore onto the card.  A peer fetch reads a whole chunk (up to 512 MiB)
# before the first byte is checked, and 16 run at once against one daemon
# on 8 cores, hence a 60 s peer timeout.

PEER_LAYERS = 8
PEER_TIMEOUT_S = "60"
ROLLOUT_FLEET_INTERVAL_S = "0.2"  # the daemons' and the rollout's fleet-telemetry interval
PEER_TRACE_FLUSH_S = 0.5
DAEMON_TIMEOUT_S = 120


def peer_daemon_entry(cache_dir, root, knob_env, conn) -> None:
    """A spawned port PeerDaemon: sends its address, serves until the
    parent sends ``stop``, closes (tombstone, shutdown, joined thread) and
    acknowledges."""
    import traceback

    try:
        os.environ.update(knob_env)
        sys.path.insert(0, HERE)
        from torchsnapshot_tpu_torch import peerd

        daemon = peerd.PeerDaemon(root=root, cache_dir=cache_dir, advertise="127.0.0.1")
        conn.send({"ok": True, "addr": daemon.start(), "ident": daemon.ident, "jax_imported": "jax" in sys.modules})
        try:
            conn.recv()
        finally:
            daemon.close()
        conn.send({"ok": True})
    except BaseException:  # noqa: BLE001 — the parent fails the phase
        conn.send({"ok": False, "error": traceback.format_exc()})


class PeerDaemons:
    """Port daemons in spawned processes, one per cache directory:
    ``addrs[i]`` serves ``cache_dirs[i]``.  ``stop(i)`` closes one and
    waits for it; leaving the block stops the rest.  A daemon that fails,
    dies or does not answer in time raises."""

    def __init__(self, cache_dirs, root, knob_env):
        import torch.multiprocessing as tmp

        ctx = tmp.get_context("spawn")
        self.procs, self.conns, self.addrs, self.idents = [], [], [], []
        for cache_dir in cache_dirs:
            parent, child = ctx.Pipe()
            proc = ctx.Process(target=peer_daemon_entry, args=(cache_dir, root, knob_env, child))
            proc.start()
            self.procs.append(proc)
            self.conns.append(parent)

    def _answer(self, i):
        if not self.conns[i].poll(DAEMON_TIMEOUT_S):
            raise RuntimeError(f"peer daemon {i}: no answer in {DAEMON_TIMEOUT_S} s (exit code {self.procs[i].exitcode})")
        msg = self.conns[i].recv()
        if not msg["ok"]:
            raise RuntimeError(f"peer daemon {i}: {msg['error']}")
        return msg

    def __enter__(self):
        try:
            for i in range(len(self.procs)):
                msg = self._answer(i)
                if msg["jax_imported"]:
                    raise RuntimeError(f"peer daemon {i} imported jax")
                self.addrs.append(msg["addr"])
                self.idents.append(msg["ident"])
        except BaseException:
            self.__exit__(None, None, None)
            raise
        return self

    def stop(self, i):
        proc = self.procs[i]
        if proc.is_alive():
            self.conns[i].send("stop")
            self._answer(i)
        proc.join(30)
        if proc.is_alive():
            proc.kill()
            proc.join()
            raise RuntimeError(f"peer daemon {i} did not exit")

    def __exit__(self, exc_type, exc, tb):
        errors = []
        for i, proc in enumerate(self.procs):
            try:
                self.stop(i)
            except Exception as e:  # noqa: BLE001 — every daemon is stopped, then the first error raised
                if proc.is_alive():
                    proc.kill()
                    proc.join()
                errors.append(e)
        if errors and exc_type is None:
            raise errors[0]


def peer_restore_worker(snap, cache_dir, kv, faults_spec, seed, label, refilled=(), trace_dir=None):
    """One spawned worker on the card restoring ``snap`` peer-first through
    the fresh cache ``cache_dir`` (traced into ``trace_dir``): its numbers."""
    knob_env = {"TPUSNAP_CACHE_DIR": cache_dir, "TPUSNAP_STORE_PATH": kv, "TPUSNAP_PEER_FETCH": "1",
                "TPUSNAP_FAULTS": faults_spec, "TPUSNAP_PEER_TIMEOUT_S": PEER_TIMEOUT_S}
    if trace_dir is not None:
        knob_env["TPUSNAP_TRACE_DIR"] = trace_dir
    return spawn_collect(restore_worker_entry, [(snap, knob_env, seed, PEER_LAYERS, tuple(refilled))], label,
                         "worker")[0]


def peer_trace_split(trace_dir, daemons):
    """peer_restore's traces: the worker's restore file and the daemons'
    files stitched by ``merge_fleet_traces``; per GET the client's time to
    first byte and transfer (sums and medians); daemon A's ``peerd_handle``
    total; the spans of A that joined the worker's trace id, with their
    parents among the worker's ``peer_fetch`` spans; daemon A's /metrics
    count of 200 chunk answers; every file and access log validated.  With
    them, the loaded documents by file name."""
    import urllib.request

    from torchsnapshot_tpu_torch.telemetry import trace

    paths = sorted(os.path.join(trace_dir, p) for p in os.listdir(trace_dir) if p.endswith(trace.TRACE_FILE_SUFFIX))
    docs = {}
    for path in paths:
        with open(path, encoding="utf-8") as f:
            docs[os.path.basename(path)] = json.load(f)
    invalid = {name: trace.validate_trace(doc) for name, doc in docs.items() if trace.validate_trace(doc)}
    for name in os.listdir(trace_dir):
        if name.endswith(trace.ACCESS_LOG_SUFFIX) and trace.validate_access_log(os.path.join(trace_dir, name)):
            invalid[name] = trace.validate_access_log(os.path.join(trace_dir, name))
    worker = next(doc for name, doc in docs.items() if name.startswith("restore-"))
    trace_id = worker["otherData"]["trace_id"]
    fetches = [ev for ev in worker["traceEvents"] if ev.get("name") == "peer_fetch" and ev["args"]["status"] == "hit"]
    fetch_ids = {f"{ev['args']['span_id']:016x}" for ev in worker["traceEvents"] if ev.get("name") == "peer_fetch"}
    daemon_a = docs[f"peerd-{daemons.idents[0][:8]}-rank0{trace.TRACE_FILE_SUFFIX}"]
    handles = [ev for ev in daemon_a["traceEvents"] if ev.get("name") == "peerd_handle"
               and ev["args"].get("trace") == trace_id]
    merged = trace.merge_fleet_traces(paths)
    body = urllib.request.urlopen(f"http://{daemons.addrs[0]}/metrics", timeout=30).read().decode("utf-8")
    key = 'tpusnap_peerd_requests_total{kind="chunk",status="200"} '
    chunk_200s = next((int(float(line[len(key):])) for line in body.splitlines() if line.startswith(key)), 0)
    ttfb = [ev["args"]["ttfb_s"] for ev in fetches] or [0.0]
    transfer = [ev["args"]["transfer_s"] for ev in fetches] or [0.0]
    return {"files": sorted(docs), "trace_id": trace_id, "trace_id_in_merge": trace_id in merged["otherData"]["trace_ids"],
            "gets": len(fetches), "ttfb_s_sum": round(sum(ttfb), 3), "ttfb_s_median": round(statistics.median(ttfb), 3),
            "transfer_s_sum": round(sum(transfer), 3), "transfer_s_median": round(statistics.median(transfer), 3),
            "peer_fetch_s_sum": round(sum(ev["dur"] for ev in fetches) / 1e6, 3),
            "daemon_a_handle_s_sum": round(sum(ev["dur"] for ev in handles) / 1e6, 3),
            "daemon_a_handle_200_s_median": round(statistics.median(
                [ev["dur"] / 1e6 for ev in handles if ev["args"]["status"] == 200] or [0.0]), 3),
            "stitched_spans": len(handles),
            "unparented_spans": sum(1 for ev in handles if ev["args"].get("parent") not in fetch_ids),
            "daemon_a_chunk_200s": chunk_200s, "invalid": invalid}, docs


def peer_worker_line(w):
    return {"restore_s": round(w["restore_s"], 3), "origin_payload_bytes": w["origin_payload_bytes"],
            "peer": w["peer"], "cache_hit_bytes": w["hit_bytes"], "cache_miss_bytes": w["miss_bytes"],
            "bit_exact": not w["mismatched"], "mismatched": w["mismatched"][:5], "jax_imported": w["jax_imported"],
            "phases": w["phases"]}


def peer_fetch_phases(torch, ts, knobs, args):
    """peer_restore, then peer_fault, on one CAS snapshot: daemon A serves
    a cache warmed through ``cache.warm_snapshot``, daemon B an empty one.
    B is stopped before peer_fault, so that the fault's 2nd peer fetch is
    A's (a fetch from B is a 404, which a truncation cannot touch)."""
    from torchsnapshot_tpu_torch import cache, peerd

    work = os.path.join(args.workdir, "peer")
    root, kv = os.path.join(work, "root"), os.path.join(work, "kv")
    snap_path = os.path.join(root, "step_1")
    logical = state_bytes(PEER_LAYERS)
    params = seeded_params(torch, PEER_LAYERS, args.seed)
    device_sync(torch)
    begin = time.monotonic()
    with knobs.override_cas(True):
        ts.Snapshot.take(snap_path, {"model": ts.StateDict(params)})
    take_s = time.monotonic() - begin
    del params
    if DEV == "cuda":
        torch.cuda.empty_cache()  # the workers' restores get the freed memory
    chunk_bytes = dir_bytes(os.path.join(root, "cas"))
    md = ts.Snapshot(snap_path).metadata
    cache_a = os.path.join(work, "cache_a")
    begin = time.monotonic()
    with knobs.override_cache_dir(cache_a):
        storage = peerd._rollout_storage(snap_path, md)
        try:
            warmed = cache.warm_snapshot(storage, md)
        finally:
            storage.sync_close()
    warm_s = time.monotonic() - begin
    trace_dir = os.path.join(work, "traces")
    daemon_env = {"TPUSNAP_STORE_PATH": kv, "TPUSNAP_TRACE_DIR": trace_dir, "TPUSNAP_METRICS": "1",
                  "TPUSNAP_PEER_TRACE_FLUSH_S": str(PEER_TRACE_FLUSH_S)}
    with PeerDaemons([cache_a, os.path.join(work, "cache_b")], None, daemon_env) as daemons:
        begin = time.monotonic()
        w = peer_restore_worker(snap_path, os.path.join(work, "cache_restore"), kv, "none", args.seed, "peer_restore",
                                trace_dir=trace_dir)
        wall = time.monotonic() - begin
        shutil.rmtree(os.path.join(work, "cache_restore"))
        time.sleep(3 * PEER_TRACE_FLUSH_S)  # the daemons' flushers rewrite their files
        traced, trace_docs = peer_trace_split(trace_dir, daemons)
        ok = (w["origin_payload_bytes"] == 0 and w["peer"]["hit_bytes"] == chunk_bytes and w["peer"]["rejects"] == 0
              and w["peer"]["misses"] == 0 and not w["mismatched"] and not w["jax_imported"]
              and traced["stitched_spans"] > 0 and traced["unparented_spans"] == 0 and not traced["invalid"]
              and traced["trace_id_in_merge"]
              and traced["daemon_a_chunk_200s"] == w["peer"]["hits"])
        emit({"phase": "peer_restore", "ok": ok, "n_layers": PEER_LAYERS, "depth_cut": PEER_LAYERS != N_LAYERS,
              "logical_bytes": logical, "payload_chunk_bytes": chunk_bytes, "take_s": round(take_s, 3),
              "warm_a_s": round(warm_s, 3), "warm_a_bytes": warmed["bytes"], "worker_wall_s": round(wall, 3),
              "gbps": round(logical / GB / w["restore_s"], 3), "daemons": daemons.addrs,
              "registered": ["a: warmed", "b: empty"], "trace": traced, **peer_worker_line(w)})
        analyzed = analyze_peer_phase(trace_docs, daemons, trace_dir, traced["trace_id"])
        if not ok:
            raise RuntimeError("peer_restore: origin was read, peer hit bytes differ from the chunk bytes, a reject, "
                               "the worker's tensors differ from the seeded values, a trace file or access log is "
                               "invalid, no daemon span joined the worker's trace, or daemon A's /metrics counts "
                               "other 200 chunk answers than the worker's peer hits")
        if not analyzed:
            raise RuntimeError("analyze_peer: the per-peer fetch counts or daemon A's request count differ from the "
                               "spans in the trace files, the slowest peer is not one of the two daemons, or the "
                               "CLI's analyze --peer or trace --fleet differs from the library over the files")

        daemons.stop(1)
        w = peer_restore_worker(snap_path, os.path.join(work, "cache_fault"), kv, "peer:2:peer_truncated", args.seed,
                                "peer_fault")
        shutil.rmtree(os.path.join(work, "cache_fault"))
        hit = w["peer"]["hit_bytes"]
        ok = (w["peer"]["rejects"] == 1 and hit > 0 and hit + w["origin_payload_bytes"] == chunk_bytes
              and not w["mismatched"] and not w["jax_imported"])
        emit({"phase": "peer_fault", "ok": ok, "faults": "peer:2:peer_truncated", "registered": ["a: warmed"],
              "payload_chunk_bytes": chunk_bytes, "gbps": round(logical / GB / w["restore_s"], 3),
              **peer_worker_line(w)})
        if not ok:
            raise RuntimeError("peer_fault: not exactly one reject, no peer hit, peer and origin bytes do not add up "
                               "to the chunk bytes, or the worker's tensors differ from the seeded values")
    shutil.rmtree(work)


def serve_entry_line(fleet, doc):
    """A daemon's serve entry as read: its age, its process's publishes and
    their mean wall, and the spacing a budget charged with that wall (as
    the JAX package's is) would give its beacons."""
    publishes, overhead_s = doc["proc"].get("publishes") or 0, doc["proc"].get("overhead_s") or 0.0
    mean_s = overhead_s / publishes if publishes else None
    return {"stale": bool(doc.get("_stale")), "age_s": doc["_age_s"], "elapsed_s": doc["op"]["elapsed_s"],
            "publishes": publishes, "mean_publish_wall_s": round(mean_s, 6) if mean_s is not None else None,
            "wall_budget_spacing_s": round(mean_s / fleet.OVERHEAD_BUDGET_FRAC, 3) if mean_s is not None else None}


def peer_rollout_phase(torch, ts, knobs, args):
    """peer_rollout: a CAS SnapshotManager root saves step 1 and step 2
    (``wk`` refilled); two daemons serve it; ``rollout_fleet`` rolls out
    step 1 (all of it the delta), then step 2 (the delta: ``wk``'s
    chunk); a worker restores step 2 from the fleet host's cache.  The
    daemons and the rollout publish into one fleet spool (0.2 s interval):
    after each rollout its terminal entry's wave document and the daemons'
    live ``serve`` entries are read, after the daemons close their terminal
    ones."""
    from torchsnapshot_tpu_torch import peerd
    from torchsnapshot_tpu_torch.telemetry import fleet

    work = os.path.join(args.workdir, "peer")
    root, kv = os.path.join(work, "root"), os.path.join(work, "kv")
    spool = os.path.join(work, "spool")
    cache_dirs = [os.path.join(work, "cache_a"), os.path.join(work, "cache_b")]
    wk = ("layers", "attn", "wk")
    params = seeded_params(torch, PEER_LAYERS, args.seed)
    knob_env = {"TPUSNAP_STORE_PATH": kv, "TPUSNAP_PEER_FETCH": "1", "TPUSNAP_PEER_TIMEOUT_S": PEER_TIMEOUT_S,
                "TPUSNAP_FLEET_TELEMETRY": spool, "TPUSNAP_FLEET_TELEMETRY_INTERVAL_S": ROLLOUT_FLEET_INTERVAL_S}
    saves, rollouts = [], []
    with PeerDaemons(cache_dirs, root, knob_env) as daemons, knobs.override_store_path(kv), knobs.override_cas(True):
        daemon_pids = [proc.pid for proc in daemons.procs]
        mgr = ts.SnapshotManager(root)
        for step in (1, 2):
            if step == 2:
                t = get_leaf(params, "/".join(wk))
                seeded_fill(torch, t, tensor_seed(args.seed + 1, wk), t.shape, [0] * t.dim())
            device_sync(torch)
            begin = time.monotonic()
            mgr.save(step, {"model": ts.StateDict(params)})
            saves.append(round(time.monotonic() - begin, 3))
            _, _, md, prev_md = peerd.resolve_rollout_target(root, step)
            delta_bytes = sum(n for _, n in peerd.delta_locations(md, prev_md))
            begin = time.monotonic()
            with knobs.override_fleet_telemetry(spool), knobs.override_fleet_telemetry_interval_s(
                float(ROLLOUT_FLEET_INTERVAL_S)
            ):
                out = peerd.rollout_fleet(root, step, canary=1)
            wall = time.monotonic() - begin
            canary = out["canary_results"][0].get("warm") or {}
            fleet_warm = (out.get("fleet_results") or [{}])[0].get("warm") or {}
            ok = (out["ok"] and out["step"] == step and canary.get("delta_bytes") == delta_bytes > 0
                  and canary["cache"]["miss_bytes"] == delta_bytes and canary["peer"]["hit_bytes"] == 0
                  and fleet_warm.get("delta_bytes") == delta_bytes and fleet_warm["peer"]["hit_bytes"] == delta_bytes
                  and fleet_warm["cache"]["miss_bytes"] == 0)
            terminal = [d for d in fleet_entries(fleet, spool, "rollout", pid=os.getpid())
                        if (d.get("extra") or {}).get("rollout")]
            wave = terminal[-1]["extra"]["rollout"] if len(terminal) == 1 else {}
            serve = {d["pid"]: d for d in fleet_entries(fleet, spool, "serve")}
            fleet_ok = (len(terminal) == 1 and terminal[0]["op"]["done"] is True
                        and terminal[0]["op"]["success"] is True and wave.get("wave") == "fleet"
                        and wave.get("step") == step and wave.get("completed") == wave.get("total") == 1
                        and wave.get("peer_bytes") == (fleet_warm.get("peer") or {}).get("hit_bytes") == delta_bytes
                        and sorted(serve) == sorted(daemon_pids)
                        and all(not d.get("_stale") and d["op"]["done"] is False for d in serve.values()))
            ok = ok and fleet_ok
            rollouts.append({"step": step, "ok": ok, "wall_s": round(wall, 3), "delta_bytes": delta_bytes,
                             "canary": out["canaries"], "fleet": out["fleet"], "canary_warm": canary,
                             "fleet_warm": fleet_warm, "canary_verify": out.get("canary_verify"),
                             "fleet_telemetry": {"ok": fleet_ok, "wave": wave, "serve_entries_fresh": {
                                 pid: serve_entry_line(fleet, d) for pid, d in serve.items()}},
                             "aborted": out.get("aborted"), "errors": [r.get("error") for r in
                                                                     out["canary_results"] + out.get("fleet_results", [])
                                                                     if not r.get("ok")]})
        del params
        if DEV == "cuda":
            torch.cuda.empty_cache()
        fleet_cache = cache_dirs[daemons.addrs.index(rollouts[-1]["fleet"][0])] if rollouts[-1]["fleet"] else None
    serve_done = {d["pid"]: d["op"]["done"] is True and d["op"]["success"] is True
                  for d in fleet_entries(fleet, spool, "serve", stale_s=1e9)}
    if fleet_cache is None:
        raise RuntimeError(f"peer_rollout: no fleet host: {rollouts[-1]}")
    w = spawn_collect(restore_worker_entry, [(os.path.join(root, "step_2"), {"TPUSNAP_CACHE_DIR": fleet_cache,
                                                                            "TPUSNAP_FAULTS": "none"},
                                              args.seed, PEER_LAYERS, ("/".join(wk),))], "peer_rollout", "worker")[0]
    ok = all(r["ok"] for r in rollouts) and w["origin_payload_bytes"] == 0 and not w["mismatched"] \
        and not w["jax_imported"] and sorted(serve_done) == sorted(daemon_pids) and all(serve_done.values())
    emit({"phase": "peer_rollout", "ok": ok, "n_layers": PEER_LAYERS, "save_s": saves, "rollouts": rollouts,
          "serve_entries_done_after_close": serve_done,
          "restore_from_fleet_cache": {"restore_s": round(w["restore_s"], 3), "gbps":
                                       round(state_bytes(PEER_LAYERS) / GB / w["restore_s"], 3),
                                       "origin_payload_bytes": w["origin_payload_bytes"],
                                       "cache_hit_bytes": w["hit_bytes"], "cache_miss_bytes": w["miss_bytes"],
                                       "bit_exact": not w["mismatched"], "mismatched": w["mismatched"][:5],
                                       "jax_imported": w["jax_imported"]}})
    shutil.rmtree(work)
    if not ok:
        raise RuntimeError("peer_rollout: a rollout failed or moved other bytes than its delta (canary from origin "
                           "once, fleet host from the canary), the restore from the fleet host's cache read "
                           "origin or differs from the seeded values, or the fleet spool lacks the rollout's "
                           "terminal wave document, a daemon's fresh serve entry or its terminal one")


def peer_phases(torch, ts, knobs, args):
    peer_fetch_phases(torch, ts, knobs, args)
    peer_rollout_phase(torch, ts, knobs, args)


# -------------------------------------------------------- telemetry phase
#
# The take and the restore of the full state again with tracing and metrics
# on (telemetry/trace.py, telemetry/metrics.py), set through knobs.override_*
# as a user sets TPUSNAP_TRACE_DIR and TPUSNAP_METRICS.

TOP_SPANS = 8


def read_pipeline_bytes(manifest) -> int:
    """What ``tpusnap_storage_bytes_read_total`` counts for a full restore
    of ``manifest`` (both packages count each read request's consuming
    cost): a payload read alone counts its bytes; two or more members of
    one slab that one app-state key restores, read as one request (those
    below the into-place read size), count their span of the slab and their
    own bytes again; an object counts 4096."""
    from torchsnapshot_tpu_torch.io_preparers.array import _INTO_PLACE_MIN_BYTES
    from torchsnapshot_tpu_torch.manifest import ObjectEntry, iter_payload_entries
    from torchsnapshot_tpu_torch.serialization import array_nbytes

    total, spans = 0, {}
    for key, entry in iter_payload_entries(manifest):
        if isinstance(entry, ObjectEntry):
            total += 4096
            continue
        rng = entry.byte_range
        total += rng[1] - rng[0] if rng else array_nbytes(entry.shape, entry.dtype)
        if entry.location.startswith("batched/") and rng[1] - rng[0] < _INTO_PLACE_MIN_BYTES:
            group = (entry.location, key.split("/")[1])  # "<rank>/<app-state key>/..."
            lo, hi, n = spans.get(group, (rng[0], rng[1], 0))
            spans[group] = (min(lo, rng[0]), max(hi, rng[1]), n + 1)
    return total + sum(hi - lo for lo, hi, n in spans.values() if n > 1)


def trace_take_restore_phase(torch, ts, knobs, phase_stats, app_state, ref, nbytes, events, workdir, take_s,
                             restore_s):
    """trace_take_restore: the state taken and restored in place again with
    ``TPUSNAP_TRACE_DIR`` and ``TPUSNAP_METRICS`` set.  Each trace file
    must validate; the take's ``d2h`` spans must carry the state's bytes;
    ``tpusnap_storage_bytes_written_total`` must equal the payload bytes on
    disk and the take's ``take.end`` bytes, ``..._read_total`` what the
    restore's read requests consumed (``read_pipeline_bytes``); the restore
    must be bit-exact.  Prints both walls beside the untraced ``take`` and
    ``restore``, the calibrated span cost, the span count and the spans
    with the most total time."""
    from torchsnapshot_tpu_torch.telemetry import metrics, trace

    snap_path, trace_dir = os.path.join(workdir, "trace_snap"), os.path.join(workdir, "traces")
    metrics.reset()
    spans_before = trace.spans_recorded()
    n_events = len(events)
    with knobs.override_trace_dir(trace_dir), knobs.override_metrics(True):
        device_sync(torch)
        begin = time.monotonic()
        snapshot = ts.Snapshot.take(snap_path, app_state)
        traced_take_s = time.monotonic() - begin
        written = int(metrics.counter("tpusnap_storage_bytes_written_total").get())
        seconds, mismatched, moved, _ = restore_check(torch, ts, snap_path, app_state, ref, phase_stats)
        read = int(metrics.counter("tpusnap_storage_bytes_read_total").get())
        ops = {a: int(metrics.counter("tpusnap_operations_total").get(action=a, outcome="success"))
               for a in ("take", "restore")}
    spans = trace.spans_recorded() - spans_before
    cost = trace.calibrated_span_cost_s()
    take_end = [e.metadata for e in events[n_events:] if e.name == "take.end"][-1]
    payload = dir_bytes(snap_path)
    want_read = read_pipeline_bytes(snapshot.get_manifest())
    problems, totals, d2h_bytes, files, span_events = {}, {}, 0, [], 0
    for path in sorted(os.listdir(trace_dir)):
        with open(os.path.join(trace_dir, path), encoding="utf-8") as f:
            doc = json.load(f)
        problems[path] = trace.validate_trace(doc)
        files.append(path)
        for ev in doc["traceEvents"]:
            if ev["ph"] != "X":
                continue
            span_events += 1
            totals[ev["name"]] = totals.get(ev["name"], 0.0) + ev["dur"] / 1e6
            if ev["name"] == "d2h" and path.startswith("take-"):
                d2h_bytes += int(ev["args"].get("bytes", 0))
    top = sorted(totals.items(), key=lambda kv: -kv[1])[:TOP_SPANS]
    ok = (len(files) == 2 and not any(problems.values()) and (d2h_bytes == nbytes or DEV != "cuda")
          and written == payload == take_end["bytes"] and read == want_read and ops == {"take": 1, "restore": 1}
          and not mismatched and not moved)
    emit({"phase": "trace_take_restore", "ok": ok, "take_s": round(traced_take_s, 3), "untraced_take_s": round(take_s, 3),
          "restore_s": round(seconds, 3), "untraced_restore_s": round(restore_s, 3), "state_bytes": nbytes,
          "trace_files": files, "validate_trace": problems, "spans": spans, "span_events_in_files": span_events,
          "calibrated_span_cost": {"per_span_s": cost["per_span_s"], "estimated_s": round(cost["estimated_s"], 6)},
          "top_spans_s": [[name, round(t, 3)] for name, t in top], "d2h_span_bytes": d2h_bytes,
          "metrics_written_bytes": written, "payload_bytes_on_disk": payload, "take_end_bytes": take_end["bytes"],
          "metrics_read_bytes": read, "read_pipeline_bytes": want_read, "operations": ops,
          "bit_exact": not mismatched, "data_ptr_unchanged": not moved, "mismatched": mismatched[:5]})
    metrics.reset()
    analyzed = analyze_traces_phase(trace_dir, snap_path, span_events)
    for path in (snap_path, trace_dir):
        shutil.rmtree(path)
    if not ok:
        raise RuntimeError("trace_take_restore: a trace file is invalid, the d2h spans miss state bytes, the metrics' "
                           "byte counters differ from the bytes written and read, or the restore is not bit-exact")
    if not analyzed:
        raise RuntimeError("analyze_traces: the report lacks the take or the restore of rank 0, an op's scheduler "
                           "idle lies outside 0 and its wall, the take has no d2h wall or the restore no h2d wall, "
                           "a limiting resource names no group, a phase is classified other, the rendering "
                           "misses an op, or the CLI's trace or analyze differs from the library over the files")


# ---------------------------------------------------- the scheduler's waits
#
# The two wait phases the analyzer names a throttled op by: ``io_slot_wait``
# (a request's wait for its I/O slot, over 1 ms) and ``budget_wait`` (a
# pipeline turn in which the memory budget binds), each provoked in a take
# of its own and read back through the CLI's ``analyze --json``.

WAIT_TENSORS = 8
WAIT_ELEMS = 16 << 20  # float32: 64 MiB a tensor, one write request each


def scheduler_waits_phase(torch, ts, knobs, workdir, seed):
    """scheduler_waits: two traced takes of WAIT_TENSORS float32 tensors of
    64 MiB made on the card: the first at an I/O concurrency of 1, which must
    record ``io_slot_wait``, the second with the memory budget at one
    request's staging cost (its pinned buffer) and the default I/O cap,
    which must record ``budget_wait``.  For each, ``analyze <traces>
    --json`` through the CLI must show the matching group (``io_concurrency``,
    then ``memory_budget``) with a wall above 0; both groups' walls are
    printed beside the take's wall.  The second take restores bit-exact."""
    g = torch.Generator(device=DEV).manual_seed(seed + 3)
    tensors = {f"w{i}": torch.randn(WAIT_ELEMS, generator=g, device=DEV) for i in range(WAIT_TENSORS)}
    request_bytes = WAIT_ELEMS * 4
    cases = [("io_cap_1", "io_slot_wait", "io_concurrency", lambda: knobs.override_max_per_rank_io_concurrency(1)),
             ("budget_one_request", "budget_wait", "memory_budget",
              lambda: knobs.override_per_rank_memory_budget_bytes(request_bytes))]
    takes, ok = [], True
    for name, phase, group, knob in cases:
        root, trace_dir = os.path.join(workdir, f"waits_{name}"), os.path.join(workdir, f"waits_{name}_traces")
        with knob(), knobs.override_trace_dir(trace_dir):
            device_sync(torch)
            begin = time.monotonic()
            snap = ts.Snapshot.take(root, {"m": ts.StateDict(tensors)})
            take_s = time.monotonic() - begin
        rc, out = run_cli(["analyze", trace_dir, "--json"], "scheduler_waits")
        ops = [op for op in (json.loads(out)["ops"] if rc == 0 else []) if op["kind"] == "take"]
        op = ops[0] if len(ops) == 1 else {"groups": {}, "phases": {}}
        row = {"case": name, "take_s": round(take_s, 3), "gbps": round(WAIT_TENSORS * request_bytes / GB / take_s, 3),
               "io_concurrency_wall_s": op["groups"].get("io_concurrency", 0.0),
               "memory_budget_wall_s": op["groups"].get("memory_budget", 0.0),
               "limiting_resource": op.get("limiting_resource"), "dominant_phase": op.get("dominant_phase"),
               "wait_phase": phase, "wait_phase_wall_s": op["phases"].get(phase, {}).get("wall_s")}
        case_ok = rc == 0 and len(ops) == 1 and op["groups"].get(group, 0.0) > 0
        if name == "budget_one_request":
            dst = {k: torch.zeros_like(t) for k, t in tensors.items()}
            device_sync(torch)
            begin = time.monotonic()
            snap.restore({"m": ts.StateDict(dst)})
            device_sync(torch)
            row["restore_s"] = round(time.monotonic() - begin, 3)
            row["bit_exact"] = all(torch.equal(dst[k], t) for k, t in tensors.items())
            case_ok = case_ok and row["bit_exact"]
            del dst
        row["ok"] = case_ok
        ok = ok and case_ok
        takes.append(row)
        for path in (root, trace_dir):
            shutil.rmtree(path)
    emit({"phase": "scheduler_waits", "ok": ok, "tensors": WAIT_TENSORS, "request_bytes": request_bytes,
          "takes": takes})
    if not ok:
        raise RuntimeError("scheduler_waits: a take at an I/O concurrency of 1 shows no io_concurrency wall, or one "
                           "under a budget of one request no memory_budget wall, in the CLI's analyze, or that take "
                           "does not restore bit-exact")


# ------------------------------------------------------------ the analyses
#
# The bottleneck analyzer (telemetry/analyze.py) over files the phases above
# already write, each run inside the phase that writes its input, before
# that phase removes it: the traced take and restore, their profiles, the
# four ranks' async take's sidecars and the peer restore's traces.  No
# check reads a clock: each holds the report against the files' own
# counts, against what the writing phase computed from the same files, or
# against the shape the analyzer promises.


def analyze_traces_phase(trace_dir, snap_path, span_events) -> bool:
    """analyze_traces: ``analyze_traces`` over trace_take_restore's trace
    files and its snapshot's sidecars: exactly the take and the restore,
    rank 0 each; per op a scheduler idle between 0 and the op's wall; a
    ``d2h`` group wall above 0 in the take and an ``h2d`` one in the
    restore; a limiting resource that is one of the groups; no phase in
    ``other`` (the line lists any); ``render`` naming both ops.  Then the
    CLI over the same files (``cli_trace_checks``)."""
    from torchsnapshot_tpu_torch.telemetry import analyze

    begin = time.monotonic()
    report = analyze.analyze_traces(analyze.load_trace_dir(trace_dir), analyze.load_sidecars(snap_path))
    text = analyze.render(report)
    read_s = time.monotonic() - begin
    ops = {op["kind"]: op for op in report["ops"]}
    other = {op["kind"]: sorted(n for n, i in op["phases"].items() if i["group"] == "other") for op in report["ops"]}
    ok = (len(report["ops"]) == 2 and set(ops) == {"take", "restore"}
          and all(op["ranks"] == [0] for op in ops.values())
          and all(0 <= op["idle"]["by_rank"]["0"] <= op["duration_s"]["by_rank"]["0"] for op in ops.values())
          and (ops["take"]["groups"].get("d2h", 0) > 0 or DEV != "cuda")
          and (ops["restore"]["groups"].get("h2d", 0) > 0 or DEV != "cuda")
          and all(op["limiting_resource"] in analyze.PHASE_GROUPS for op in ops.values())
          and not any(other.values())
          and all(f"{op['kind']} {op['op'][:8]} " in text for op in ops.values()))
    cli = cli_trace_checks(trace_dir, snap_path, span_events, report)
    ok = ok and cli["ok"]
    emit({"phase": "analyze_traces", "ok": ok, "trace_dir_files": len(os.listdir(trace_dir)),
          "ops": [{"kind": op["kind"], "op": op["op"][:8], "ranks": op["ranks"], "duration_s": op["duration_s"]["p50"],
                   "idle_s": op["idle"]["mean_s"], "limiting_resource": op["limiting_resource"],
                   "dominant_phase": op["dominant_phase"], "groups": op["groups"],
                   "sidecar_joined": bool(op.get("sidecars")), "phases_in_other": other[op["kind"]]}
                  for op in report["ops"]],
          "rendered_lines": len(text.splitlines()), "analysis_s": round(read_s, 3), "cli": cli})
    return ok


def cli_json(argv, phase, want):
    """(exit code, whether ``argv``'s stdout parses to ``want`` as JSON
    carries it) of the port's CLI in this process."""
    rc, out = run_cli(argv, phase)
    try:
        same = json.loads(out) == json.loads(json.dumps(want))
    except ValueError:
        same = False
    return rc, same


def cli_trace_checks(trace_dir, snap_path, span_events, report):
    """The CLI over trace_take_restore's files: ``trace --out`` prints the
    merge of the take's and the restore's files with the span count the
    phase read from them, and the merged file holds that many spans;
    ``analyze --snapshot --json`` prints ``report`` (the library's over
    the same files); ``analyze``'s text names both ops."""
    merged_path = trace_dir + ".merged.json"
    rc, out = run_cli(["trace", trace_dir, "--out", merged_path], "trace_take_restore")
    merged_spans = None
    if rc == 0:
        with open(merged_path, encoding="utf-8") as f:
            merged_spans = sum(1 for ev in json.load(f)["traceEvents"] if ev.get("ph") == "X")
        os.unlink(merged_path)
    summary = f"merged 2 trace file(s): 1x restore, 1x take, {span_events} spans"
    trace_ok = rc == 0 and summary in out.splitlines() and merged_spans == span_events
    rc, json_same = cli_json(["analyze", trace_dir, "--snapshot", snap_path, "--json"], "trace_take_restore", report)
    rc_text, text = run_cli(["analyze", trace_dir], "trace_take_restore")
    names = rc_text == 0 and all(f"{op['kind']} {op['op'][:8]} " in text for op in report["ops"])
    return {"ok": trace_ok and rc == 0 and json_same and names, "trace_summary": summary if trace_ok else out[-300:],
            "merged_spans": merged_spans, "analyze_json_equal": json_same, "analyze_text_names_ops": names}


def analyze_profile_phase(prof_dir, ops) -> bool:
    """analyze_profile: ``profile_report`` over profile_take_restore's
    profile files: two ops; each op's untagged on-CPU share equal to the one
    the phase computed from the same metas (``ops``, from
    ``profile_summary``); a dominant CPU sink naming one of the op's tagged
    phases."""
    from torchsnapshot_tpu_torch.telemetry import analyze

    begin = time.monotonic()
    report = analyze.profile_report(analyze.load_profile_dir(prof_dir))
    text = analyze.render_profile(report)
    read_s = time.monotonic() - begin
    profs = {p["kind"]: p for p in report["profiles"]}
    sinks = {k: p["dominant_cpu_sink"] for k, p in profs.items()}
    ok = (len(report["profiles"]) == 2 and set(profs) == set(ops) == {"take", "restore"}
          and all(profs[k]["untagged_oncpu_share"] == ops[k]["untagged_oncpu_share"] for k in ops)
          and all(sink is not None and sink["phase"] in profs[k]["phases"] and sink["phase"] != "<untagged>"
                  for k, sink in sinks.items()))
    cli = cli_profile_checks(prof_dir, report)
    ok = ok and cli["ok"]
    emit({"phase": "analyze_profile", "ok": ok,
          "profiles": [{"kind": p["kind"], "op": p["op"][:8], "samples_total": p["samples_total"],
                        "oncpu_s": p["oncpu_s"], "untagged_oncpu_share": p["untagged_oncpu_share"],
                        "phase_untagged_oncpu_share": ops.get(p["kind"], {}).get("untagged_oncpu_share"),
                        "dominant_cpu_sink": p["dominant_cpu_sink"], "groups_cpu_s": p["groups_cpu_s"]}
                       for p in report["profiles"]],
          "rendered_lines": len(text.splitlines()), "analysis_s": round(read_s, 3), "cli": cli})
    return ok


def cli_profile_checks(prof_dir, report):
    """The CLI over profile_take_restore's files: ``analyze --profile
    --json`` prints ``report``'s profiles (and no op: the directory holds no
    trace); ``profile diff`` of the take's file against the restore's prints
    ``diff_profiles`` of their metas at the default 10 rows;
    ``profile diff`` of the directory against itself names no frame."""
    from torchsnapshot_tpu_torch.telemetry import profiler

    rc, same = cli_json(["analyze", prof_dir, "--profile", "--json"], "profile_take_restore",
                        {"ops": [], "profiles": report["profiles"]})
    files = {name.split("-", 1)[0]: os.path.join(prof_dir, name) for name in os.listdir(prof_dir)
             if name.endswith(profiler.PROFILE_FILE_SUFFIX)}
    metas = {kind: profiler.load_profile_file(path)["tpusnap"] for kind, path in files.items()}
    want = profiler.diff_profiles(metas["take"], metas["restore"], top=10)
    rc_diff, diff_same = cli_json(["profile", "diff", files["take"], files["restore"], "--json"],
                                  "profile_take_restore", want)
    rc_self, out = run_cli(["profile", "diff", prof_dir, prof_dir], "profile_take_restore")
    unmoved = rc_self == 0 and out.count("\n    (none)") == 2 and not re.search(r"^ +[+-]\d", out, re.M)
    return {"ok": rc == 0 and same and rc_diff == 0 and diff_same and unmoved, "analyze_profile_json_equal": same,
            "diff_json_equal": diff_same,
            "top_regressed": [[r["frame"], r["delta_s"]] for r in want["top_regressed"][:3]],
            "top_improved": [[r["frame"], r["delta_s"]] for r in want["top_improved"][:3]],
            "self_diff_names_no_frame": unmoved}


def analyze_barrier_phase(snap_path, world) -> bool:
    """analyze_barrier: ``barrier_blame`` over the sidecars of the ``world``
    ranks' async take: one report, the async take's, with ``world`` ranks
    in its arrival table, a skew of 0 or more, a blamed rank among them and
    a phase named."""
    from torchsnapshot_tpu_torch.telemetry import analyze

    sidecars = analyze.load_sidecars(snap_path)
    reports = analyze.barrier_blame(sidecars)
    rep = reports[0] if len(reports) == 1 else {}
    # The CLI over the same sidecars prints the same reports.
    rc, cli_same = cli_json(["analyze", snap_path, "--barrier", "--json"], "dist_async_take", reports)
    ok = (rep.get("kind") == "async_take" and rep.get("world") == world and len(rep["arrivals_rel_s"]) == world
          and rep["skew_s"] >= 0 and rep["blamed_rank"] in range(world) and rep["blamed_phase"] is not None
          and rc == 0 and cli_same)
    emit({"phase": "analyze_barrier", "ok": ok, "ranks": world, "cli_barrier_json_equal": cli_same,
          "sidecars": sorted(f"{d.get('action')}/rank{d.get('rank')}" for d in sidecars), "reports": len(reports),
          **{k: rep.get(k) for k in ("kind", "world", "skew_s", "first_rank", "blamed_rank", "blamed_phase",
                                     "blamed_phase_wall_s", "arrivals_rel_s", "barrier_wait_s")}})
    return ok


def analyze_peer_phase(docs, daemons, trace_dir, trace_id) -> bool:
    """analyze_peer: ``peer_report`` over the peer restore's trace files, as
    ``peer_trace_split`` loaded them: the worker's ``peer_fetch`` spans per
    peer and daemon A's ``peerd_handle`` spans counted as in the files, and
    a slowest peer that is one of the two daemons.  Then the CLI over a
    copy of the directory's trace files (the daemons still flush theirs):
    ``analyze --peer --json`` prints ``peer_report`` of the copy, and
    ``trace --fleet`` a ``trace <id>`` line for the worker's restore with
    the count of the copy's events that carry that id."""
    from torchsnapshot_tpu_torch.telemetry import analyze, trace

    # The trace files only: a daemon's flush writes a temporary beside its
    # file and renames it over the file, so the file is always whole.
    frozen = trace_dir + ".copy"
    os.makedirs(frozen)
    for name in os.listdir(trace_dir):
        if name.endswith(trace.TRACE_FILE_SUFFIX):
            shutil.copy(os.path.join(trace_dir, name), frozen)
    try:
        rc, peer_same = cli_json(["analyze", frozen, "--peer", "--json"], "peer_restore",
                                 analyze.peer_report(analyze.load_trace_dir(frozen)))
        carried = 0
        for doc in analyze.load_trace_dir(frozen):
            for ev in doc["traceEvents"]:
                if ev.get("ph") != "M" and ((ev.get("args") or {}).get("trace")
                                            or doc["otherData"].get("trace_id")) == trace_id:
                    carried += 1
        rc_fleet, out = run_cli(["trace", frozen, "--fleet"], "peer_restore")
        line = f"  trace {trace_id}: {carried} span(s)"
        cli = {"ok": rc == 0 and peer_same and rc_fleet == 0 and line in out.splitlines() and carried > 0,
               "peer_json_equal": peer_same, "fleet_trace_line": line if line in out.splitlines() else None,
               "events_carrying_trace_id": carried}
    finally:
        shutil.rmtree(frozen)

    report = analyze.peer_report(list(docs.values()))
    text = analyze.render_peer(report)
    worker = next(doc for name, doc in docs.items() if name.startswith("restore-"))
    fetches: dict = {}
    for ev in worker["traceEvents"]:
        if ev.get("ph") == "X" and ev.get("name") == "peer_fetch":
            fetches[ev["args"]["peer"]] = fetches.get(ev["args"]["peer"], 0) + 1
    daemon_a = docs[f"peerd-{daemons.idents[0][:8]}-rank0{trace.TRACE_FILE_SUFFIX}"]
    handles_a = sum(1 for ev in daemon_a["traceEvents"] if ev.get("ph") == "X" and ev.get("name") == "peerd_handle")
    ident_a = f"{daemon_a['otherData'].get('host', '?')}/{str(daemon_a['otherData'].get('op', '?'))[:8]}"
    ok = ({a: row["fetches"] for a, row in report["peers"].items()} == fetches and bool(fetches)
          and report["daemons"].get(ident_a, {}).get("requests") == handles_a > 0
          and report["slowest_peer"] in daemons.addrs and report["slowest_peer"] in text and cli["ok"])
    emit({"phase": "analyze_peer", "ok": ok, "fetches_in_files": fetches, "daemon_a_handles_in_file": handles_a,
          "cli": cli,
          "peers": {a: {k: row[k] for k in ("fetches", "hit_rate", "fallback_rate", "p50_s", "p99_s", "bytes")}
                    for a, row in report["peers"].items()},
          "daemons": report["daemons"], "daemon_a": ident_a, "slowest_peer": report["slowest_peer"],
          "daemon_addrs": daemons.addrs})
    return ok


# ---------------------------------------------------------- profiled phase
#
# The sampling profiler (telemetry/profiler.py): the full state's take and
# in-place restore with TPUSNAP_PROFILE set at the default 99 Hz.  The bar
# is the reference's own (tests/test_profiler.py:325-340): fewer than 5% of
# on-CPU samples untagged, over at least 20 on-CPU samples.

PROFILE_UNTAGGED_MAX_SHARE = 0.05
PROFILE_MIN_ONCPU_SAMPLES = 20
TOP_PROFILE_PHASES = 5
# One folded stack: "<phase>;<on|off>cpu;<frame>;...;<frame> <count>" (a
# frame may hold a space, as "<frozen importlib._bootstrap>.<name>" does).
COLLAPSED_LINE = re.compile(r"^[^;\n]+;(?:on|off)cpu;.+ [1-9]\d*$")


def profile_summary(meta, wall_s):
    """The printed numbers of one op's profile meta, with the leaf frames of
    its most frequent untagged on-CPU stacks."""
    weight = meta["weight_s"]
    oncpu_s = {phase: sum(states.get("on", {}).values()) * weight for phase, states in meta["stacks"].items()}
    top = sorted(((p, s) for p, s in oncpu_s.items() if s > 0), key=lambda kv: -kv[1])[:TOP_PROFILE_PHASES]
    untagged = sorted(meta["stacks"].get("<untagged>", {}).get("on", {}).items(), key=lambda kv: -kv[1])[:3]
    on = meta["oncpu_samples"]
    return {"ticks": meta["ticks"], "ticks_per_s": round(meta["ticks"] / wall_s, 1),
            "samples_total": meta["samples_total"], "oncpu_samples": on, "untagged_oncpu": meta["untagged_oncpu"],
            "untagged_oncpu_share": round(meta["untagged_oncpu"] / on, 4) if on else None,
            "top_oncpu_phases_s": [[p, round(s, 3)] for p, s in top],
            "untagged_oncpu_stacks": [[";".join(st.split(";")[-3:]), n] for st, n in untagged], "hz": meta["hz"],
            "overhead_estimated_s": meta["calibration"]["estimated_s"],
            "overhead_share_of_wall": round(meta["calibration"]["estimated_s"] / wall_s, 5)}


def cpu_time_reader_pass_s(profiler, reps: int = 20):
    """Mean seconds of one pass of the port's per-thread CPU time reader (one
    clock read per Python thread) and of the JAX package's (one
    ``/proc/self/task/<tid>/stat`` read per native thread), taken here with
    no op running, beside the two thread counts and the smallest and
    largest step of this thread's CPU clock while it spins."""
    tids = os.listdir("/proc/self/task")
    begin = time.perf_counter()
    for _ in range(reps):
        profiler._thread_cpu_times()
    clocks_s = (time.perf_counter() - begin) / reps
    begin = time.perf_counter()
    for _ in range(reps):
        for tid in tids:
            try:
                with open(f"/proc/self/task/{tid}/stat", "rb") as f:
                    f.read()
            except OSError:
                pass
    proc_s = (time.perf_counter() - begin) / reps
    # The step of this thread's CPU clock over a 0.1 s spin: how finely the
    # kernel counts a thread's CPU time.
    clock = ((~threading.get_native_id()) << 3) | 6  # MAKE_THREAD_CPUCLOCK(tid, CPUCLOCK_SCHED)
    readings, end = [], time.monotonic() + 0.1
    while time.monotonic() < end:
        readings.append(time.clock_gettime(clock))
    steps = [b - a for a, b in zip(readings, readings[1:]) if b > a]
    return {"python_threads": threading.active_count(), "native_threads": len(tids),
            "clock_pass_s": round(clocks_s, 7), "proc_stat_pass_s": round(proc_s, 7),
            "cpu_clock_steps_s": [round(min(steps, default=0.0), 9), round(max(steps, default=0.0), 6)]}


def profile_take_restore_phase(torch, ts, knobs, phase_stats, app_state, ref, nbytes, workdir, take_s, restore_s):
    """profile_take_restore: the state taken and restored in place again with
    ``TPUSNAP_PROFILE`` set (``knobs.override_profile_dir``) at the default
    99 Hz.  Every profile file must validate under the port's
    ``validate_profile``, every collapsed line must parse as
    ``phase;state;frames count``, each op's untagged on-CPU share must be
    under 5% of at least 20 on-CPU samples, and the restore bit-exact.
    Prints both walls beside the unprofiled ``take`` and ``restore``, per op
    the ticks, samples, on-CPU samples and the phases with the most on-CPU
    seconds, the calibrated per-tick cost with its share of each wall, and
    one pass of the port's CPU time reader beside one of the JAX
    package's."""
    from torchsnapshot_tpu_torch.telemetry import profiler

    snap_path, prof_dir = os.path.join(workdir, "profile_snap"), os.path.join(workdir, "profiles")
    with knobs.override_profile_dir(prof_dir):
        hz = knobs.get_profile_hz()
        device_sync(torch)
        begin = time.monotonic()
        ts.Snapshot.take(snap_path, app_state)
        profiled_take_s = time.monotonic() - begin
        seconds, mismatched, moved, _ = restore_check(torch, ts, snap_path, app_state, ref, phase_stats)
    cost = profiler.calibrated_overhead_s()
    readers = cpu_time_reader_pass_s(profiler)
    problems, metas, bad_lines, files = {}, {}, [], sorted(os.listdir(prof_dir))
    for name in files:
        path = os.path.join(prof_dir, name)
        if name.endswith(profiler.PROFILE_FILE_SUFFIX):
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)
            problems[name] = profiler.validate_profile(doc)
            metas[doc["tpusnap"]["kind"]] = doc["tpusnap"]
        elif name.endswith(profiler.COLLAPSED_FILE_SUFFIX):
            with open(path, encoding="utf-8") as f:
                bad_lines += [line for line in f.read().splitlines() if not COLLAPSED_LINE.match(line)]
    walls = {"take": profiled_take_s, "restore": seconds}
    ops = {kind: profile_summary(metas[kind], walls[kind]) for kind in walls if kind in metas}
    shares_ok = len(ops) == 2 and all(
        o["oncpu_samples"] >= PROFILE_MIN_ONCPU_SAMPLES and o["untagged_oncpu_share"] < PROFILE_UNTAGGED_MAX_SHARE
        for o in ops.values())
    ok = (hz == 99.0 and len(files) == 4 and not any(problems.values()) and not bad_lines and shares_ok
          and not mismatched and not moved)
    emit({"phase": "profile_take_restore", "ok": ok, "hz": hz, "take_s": round(profiled_take_s, 3),
          "unprofiled_take_s": round(take_s, 3), "restore_s": round(seconds, 3),
          "unprofiled_restore_s": round(restore_s, 3), "state_bytes": nbytes, "profile_files": files,
          "validate_profile": problems, "unparsed_collapsed_lines": bad_lines[:5], "ops": ops,
          "calibrated_overhead": {"per_tick_s": cost["per_tick_s"], "process_ticks": cost["ticks"],
                                  "estimated_s": round(cost["estimated_s"], 6)},
          "cpu_time_readers": readers, "bit_exact": not mismatched, "data_ptr_unchanged": not moved,
          "mismatched": mismatched[:5]})
    analyzed = analyze_profile_phase(prof_dir, ops)
    for path in (snap_path, prof_dir):
        shutil.rmtree(path)
    if not ok:
        raise RuntimeError("profile_take_restore: a profile file is invalid or missing, a collapsed line does not "
                           "parse, an op's untagged on-CPU share is 5% or more (or it has under 20 on-CPU samples), "
                           "or the restore is not bit-exact")
    if not analyzed:
        raise RuntimeError("analyze_profile: the report lacks the take or the restore, an op's untagged on-CPU share "
                           "differs from the one the profile phase computed, or an op has no dominant CPU sink in "
                           "a tagged phase")


# ---------------------------------------------------------- monitor phases
#
# The health monitor and the flight recorder (telemetry/monitor.py,
# telemetry/blackbox.py): the full state's async take and restore under
# the watchdog, the heartbeat, the recorder and the metrics; a stall
# injected into a small take; a crash injected into a spawned process's
# take.  Each phase removes its directories.

MONITOR_STALL_TIMEOUT_S = 60  # above the async commit's 5.4-8.9 s fsync (PERF.md §7)
MONITOR_PROGRESS_INTERVAL_S = 1
MONITOR_POLL_S = 0.25
# Fleet telemetry (telemetry/fleet.py) in the monitored take: its interval;
# the publishers' stale bound, whose half is the monitor's liveness floor,
# so the beacons keep the interval while the overhead budget would pause
# them (one publish queued behind the drain took 24-537 ms on the card's
# guest: tools/fleet_publish_probe.py); the bound the poll reads with (the
# default); and the share of the take's wall the calibrated publish bill
# must stay under (the JAX module's own bar).
MONITOR_FLEET_INTERVAL_S = 1
MONITOR_FLEET_STALE_S = 2
FLEET_READ_STALE_S = 30.0
FLEET_OVERHEAD_BAR = 0.01
STALL_ELEMS = 64 << 20  # one float32 tensor of 256 MiB
STALL_TIMEOUT_S = 0.5
STALL_LATENCY_S = 3
CRASH_LAYERS = 8
# The third payload write of the take (payload paths start with the rank):
# the glob keeps the crash off the manager's in-flight marker, which has a
# plugin (and so a fault counter) of its own.
CRASH_FAULT = "write:3:crash@0/*"
CRASH_TIMEOUT_S = 300
BUNDLE_SECTIONS = ("progress", "pipeline states", "pending asyncio tasks", "thread stacks (faulthandler)",
                   "sampled profile")
# The sampled profile's heading: "sampled profile (<s>s @ <hz> Hz, <n> samples, <m> on-CPU; ...)".
SAMPLED_PROFILE_HEADING = re.compile(r"^sampled profile \(([\d.]+)s @ ([\d.]+) Hz, (\d+) samples, (\d+) on-CPU;")


def monitor_knobs(knobs, stack, heartbeat, blackbox_dir, stall_timeout_s=MONITOR_STALL_TIMEOUT_S):
    """Enter the monitored phases' knobs on ``stack``."""
    for cm in (knobs.override_stall_timeout_s(stall_timeout_s),
               knobs.override_progress_interval_s(MONITOR_PROGRESS_INTERVAL_S),
               knobs.override_heartbeat_file(heartbeat), knobs.override_blackbox_dir(blackbox_dir),
               knobs.override_metrics(True)):
        stack.enter_context(cm)


def read_heartbeat(path):
    """The heartbeat document, or None before its first write (it is
    replaced atomically, so a read sees one whole version)."""
    try:
        with open(path, encoding="utf-8") as f:
            return json.load(f)
    except FileNotFoundError:
        return None


def ring_records(blackbox, directory):
    """{pid: records} of the rings under ``directory``."""
    return {recs[0]["pid"]: recs for recs in blackbox.read_all(directory).values() if recs}


def op_names(records):
    return [r["name"] for r in records if r["kind"] == "op"]


def bundle_sections(path):
    """The bundle's section headings, and its sampled profile: the heading's
    numbers and the folded-stack lines under it."""
    with open(path, encoding="utf-8") as f:
        lines = f.read().splitlines()
    heads = [(i, line[4:-4]) for i, line in enumerate(lines) if line.startswith("--- ") and line.endswith(" ---")]
    sampled = {}
    for i, head in heads:
        m = SAMPLED_PROFILE_HEADING.match(head)
        if m:
            body = [line for line in lines[i + 1:] if line and not line.startswith("(+")]
            sampled = {"duration_s": float(m.group(1)), "hz": float(m.group(2)), "samples": int(m.group(3)),
                       "oncpu_samples": int(m.group(4)), "stacks": len(body),
                       "unparsed": [line for line in body if not COLLAPSED_LINE.match(line)][:3]}
    return [re.sub(r" \(\d.*\)$", "", head) for _, head in heads], sampled


def fleet_entries(fleet, spool, kind, pid=None, stale_s=None):
    """The spool's entries of op ``kind`` (of process ``pid``), collected
    without sweeping, oldest published first."""
    return [d for d in fleet.collect(spool, stale_s=stale_s, sweep=False)
            if d["kind"] == kind and (pid is None or d["pid"] == pid)]


def monitor_async_take_phase(torch, ts, knobs, phase_stats, app_state, ref, nbytes, events, workdir,
                             unmonitored_total_s):
    """monitor_async_take / monitor_restore: the state's pinned_host async
    take with the watchdog (60 s), a 1 s progress interval, the heartbeat,
    the recorder, the metrics and the fleet spool (1 s interval) on,
    ``progress()`` polled every 0.25 s until the commit, each poll beside a
    ``collect`` and ``aggregate`` of the spool; then the in-place restore
    under the same knobs.

    The heartbeats and the live entries are counted as they were written:
    each heartbeat and each spool entry of the take is read back on the
    monitor thread right after its write, as a supervisor reading the file
    then would find it.  A poll from this process waits for the
    interpreter lock and the file system behind the drain (three to four
    polls in a 3 s drain on the card), so it can miss a version; what the
    polls saw is printed beside."""
    from torchsnapshot_tpu_torch.telemetry import blackbox, fleet, metrics
    from torchsnapshot_tpu_torch.telemetry import monitor as tmonitor

    snap_path = os.path.join(workdir, "monitor_snap")
    heartbeat = os.path.join(workdir, "monitor_heartbeat.json")
    bb_dir = os.path.join(workdir, "monitor_blackbox")
    spool = os.path.join(workdir, "fleet_spool")
    metrics.reset()
    fleet.reset_process_totals()
    n_events = len(events)
    samples, mid_drain, live = [], set(), {}
    written_beats, written_entries = [], []
    write_heartbeat, publish = tmonitor.OpMonitor._write_heartbeat, fleet.publish

    def read_back_heartbeat(mon):
        write_heartbeat(mon)
        if mon.kind == "async_take":
            written_beats.append(read_heartbeat(heartbeat))

    def read_back_publish(mon, final=False):
        path = publish(mon, final=final)
        if path and mon.kind == "async_take":
            with open(path, encoding="utf-8") as f:
                written_entries.append(json.load(f))
        return path

    tmonitor.OpMonitor._write_heartbeat, fleet.publish = read_back_heartbeat, read_back_publish
    with contextlib.ExitStack() as stack:
        stack.callback(setattr, tmonitor.OpMonitor, "_write_heartbeat", write_heartbeat)
        stack.callback(setattr, fleet, "publish", publish)
        monitor_knobs(knobs, stack, heartbeat, bb_dir)
        stack.enter_context(knobs.override_fleet_telemetry(spool))
        stack.enter_context(knobs.override_fleet_telemetry_interval_s(MONITOR_FLEET_INTERVAL_S))
        stack.enter_context(knobs.override_fleet_telemetry_stale_s(MONITOR_FLEET_STALE_S))
        device_sync(torch)
        begin, begin_wall = time.monotonic(), time.time()
        with knobs.override_async_staging("pinned_host"):
            pending = ts.Snapshot.async_take(snap_path, app_state)
        stall_s = time.monotonic() - begin
        while not pending.done():
            doc = pending.progress()
            samples.append((doc["bytes"]["staged"], doc["bytes"]["written"]))
            hb = read_heartbeat(heartbeat)
            if hb is not None and not hb["done"]:
                mid_drain.add(hb["heartbeat_time"])
            entries = fleet_entries(fleet, spool, "async_take", stale_s=FLEET_READ_STALE_S)
            view = fleet.aggregate(entries)
            for d, w in zip(entries, view["workers"]):
                if w["state"] not in ("done", "failed", "suspected-dead"):
                    live[d["publish_time"]] = (w["bytes_staged"], w["bytes_written"])
            time.sleep(MONITOR_POLL_S)
        pending.wait()
        total_s = time.monotonic() - begin
        final = pending.progress()
        samples.append((final["bytes"]["staged"], final["bytes"]["written"]))
        terminal = read_heartbeat(heartbeat)
        take_entries = fleet_entries(fleet, spool, "async_take", stale_s=FLEET_READ_STALE_S)
        # The take's bill: its publishes times the per-publish cost measured
        # at rest, once the take's dirty pages are flushed (right after
        # wait() their writeback still queues every file call).
        fleet_cost_at_wait = fleet.calibrated_overhead_s()
        begin = time.monotonic()
        os.sync()
        sync_s = time.monotonic() - begin
        fleet_cost = fleet.calibrated_overhead_s()
        take_publish_wall_s = round(pending._monitor.fleet_overhead_s, 6)
        take_events = events[n_events:]
        n_events = len(events)
        seconds, mismatched, moved, _ = restore_check(torch, ts, snap_path, app_state, ref, phase_stats)
        restore_events = events[n_events:]
        stalls_total = int(metrics.counter("tpusnap_stalls_total").get(action="async_take")
                           + metrics.counter("tpusnap_stalls_total").get(action="restore"))
        cost = blackbox.calibrated_overhead_s()
        fleet_totals = fleet.process_totals()
        restore_entries = fleet_entries(fleet, spool, "restore", stale_s=FLEET_READ_STALE_S)
        entry_bytes = os.path.getsize(os.path.join(spool, fleet.entry_name("async_take", 0)))
        # After wait() and the restore: a read during the drain would be
        # one more file call behind it.
        rc, top_same, top_view = cli_top_json(fleet, spool, FLEET_READ_STALE_S, "monitor_async_take")
        top_kinds = sorted(w["kind"] for w in top_view.get("workers", []))
        top_ok = rc == 0 and top_same and top_kinds == sorted(d["kind"] for d in take_entries + restore_entries)
    rings = ring_records(blackbox, bb_dir)
    records = rings.get(os.getpid(), [])
    progress_records = [r for r in records if r["kind"] == "progress"]
    take_end = [e.metadata for e in take_events if e.name == "async_take.end"][-1]
    sidecars = [json.load(open(p)) for p in sorted(
        os.path.join(snap_path, "telemetry", n) for n in os.listdir(os.path.join(snap_path, "telemetry"))
        if n.startswith("async_take-"))]
    monotone = all(a[0] <= b[0] and a[1] <= b[1] for a, b in zip(samples, samples[1:]))
    take_stalls = [e.metadata for e in take_events if e.name == "watchdog.stall"]
    beats = {hb["heartbeat_time"]: hb for hb in written_beats if hb is not None and not hb["done"]}
    written_live = {}
    for entry in written_entries:
        (worker,) = fleet.aggregate([entry])["workers"]
        if worker["state"] not in ("done", "failed", "suspected-dead"):
            written_live[entry["publish_time"]] = (worker["bytes_staged"], worker["bytes_written"])
    polled = {"heartbeats_mid_drain": len(mid_drain), "live_entries": len(live)}
    mid_drain, live = beats, written_live
    live_bytes = [live[t] for t in sorted(live)]
    fleet_monotone = all(a[0] <= b[0] and a[1] <= b[1] for a, b in zip(live_bytes, live_bytes[1:]))
    beat_times = [round(t - begin_wall, 3) for t in sorted(beats)]
    take_entry = take_entries[-1]["op"] if len(take_entries) == 1 else {}
    fleet_ok = (len(live) >= 2 and fleet_monotone and take_entry.get("done") is True
                and take_entry.get("success") is True and take_entry["bytes"]["written"] == take_end["bytes"]
                and take_entries[0]["proc"]["ops_done"] == 1 and len(restore_entries) == 1
                and restore_entries[0]["op"]["done"] is True and restore_entries[0]["op"]["success"] is True
                and restore_entries[0]["proc"]["ops_done"] == 2
                and fleet_totals["ops_done"] == 2 and fleet_totals["ops_failed"] == 0
                and fleet_cost["estimated_s"] < FLEET_OVERHEAD_BAR * total_s and top_ok)
    ok = (monotone and final["bytes"]["written"] == take_end["bytes"] and final["done"] is True
          and final["success"] is True and len(mid_drain) >= 2 and terminal is not None and terminal["done"] is True
          and not take_stalls and final["stalls"] == 0
          and {"async_take.start", "async_take.end"} <= set(op_names(records)) and progress_records
          and len(sidecars) == 1 and sidecars[0]["rss_high_water_bytes"] > 0 and fleet_ok)
    emit({"phase": "monitor_async_take", "ok": ok, "stall_s": round(stall_s, 4), "total_s": round(total_s, 3),
          "unmonitored_total_s": round(unmonitored_total_s, 3), "state_bytes": nbytes,
          "polls": len(samples), "monotone": monotone, "bytes_staged": final["bytes"]["staged"],
          "bytes_written": final["bytes"]["written"], "take_end_bytes": take_end["bytes"],
          "requests": final["requests"], "heartbeats_mid_drain": len(mid_drain), "heartbeat_at_s": beat_times,
          "polled": polled,
          "terminal_heartbeat_done": terminal is not None and terminal["done"], "watchdog_stalls": len(take_stalls),
          "ring_records": len(records), "ring_progress_records": len(progress_records),
          "ring_op_records": op_names(records), "rings": len(rings),
          "blackbox_per_record_s": cost["per_record_s"],
          "rss_high_water_bytes": sidecars[0]["rss_high_water_bytes"] if sidecars else None,
          "fleet": {"ok": fleet_ok, "interval_s": MONITOR_FLEET_INTERVAL_S, "live_entries_seen": len(live),
                    "live_bytes": live_bytes, "monotone": fleet_monotone,
                    "terminal": {k: take_entry.get(k) for k in ("done", "success", "requests", "bytes")},
                    "ops_done": [take_entries[0]["proc"]["ops_done"] if take_entries else None,
                                 restore_entries[0]["proc"]["ops_done"] if restore_entries else None],
                    "publisher_stale_s": MONITOR_FLEET_STALE_S, "take_publishes": fleet_cost["publishes"],
                    "take_publish_wall_s": take_publish_wall_s, "publishes_with_restore": fleet_totals["publishes"],
                    "raw_overhead_s_with_restore": round(fleet_totals["overhead_s"], 6),
                    "calibrated_at_wait": fleet_cost_at_wait, "sync_s": round(sync_s, 3), "calibrated": fleet_cost,
                    "calibrated_share_of_total": round(fleet_cost["estimated_s"] / total_s, 6),
                    "bar": f"calibrated estimate < {FLEET_OVERHEAD_BAR} x total_s", "entry_bytes": entry_bytes,
                    "cli_top": {"ok": top_ok, "json_equal": top_same, "kinds": top_kinds}}})
    if not ok:
        raise RuntimeError("monitor_async_take: progress not monotone or not ending at async_take.end's bytes, fewer "
                           "than two heartbeats written mid-drain, a stall, a ring without the op or progress records, no "
                           "RSS high water in the sidecar, or the fleet spool short of two live entries written with "
                           "monotone bytes, a terminal entry at async_take.end's bytes, each op counted once, "
                           "a calibrated publish bill under 1% of the take's wall, and the CLI's top --json "
                           "listing the take's and the restore's entries")
    restore_stalls = [e.metadata for e in restore_events if e.name == "watchdog.stall"]
    ok = (not mismatched and not moved and not restore_stalls and stalls_total == 0
          and {"restore.start", "restore.end"} <= set(op_names(records)))
    emit({"phase": "monitor_restore", "ok": ok, "restore_s": round(seconds, 3), "state_bytes": nbytes,
          "bit_exact": not mismatched, "data_ptr_unchanged": not moved, "mismatched": mismatched[:5],
          "watchdog_stalls": len(restore_stalls), "stalls_total": stalls_total,
          "ring_op_records": op_names(records),
          "fleet_terminal": {k: restore_entries[0]["op"].get(k) for k in ("done", "success", "requests", "bytes")}
          if restore_entries else None})
    metrics.reset()
    for path in (snap_path, bb_dir, heartbeat, spool):
        (shutil.rmtree if os.path.isdir(path) else os.unlink)(path)
    if not ok:
        raise RuntimeError("monitor_restore: not bit-exact in place, a false stall, or no restore op records")


def monitor_stall_phase(torch, ts, knobs, events, workdir, seed):
    """monitor_stall: a take of one 256 MiB tensor on the card whose first
    write is held 3 s (``TPUSNAP_FAULTS=write:1:latency:3``) under a 0.5 s
    stall timeout: a ``watchdog.stall`` with ``idle_s`` >= the timeout, a
    bundle with its five sections, the last a sampled profile of at least
    one sample whose folded stacks parse, ``tpusnap_stalls_total`` >= 1; the
    take commits and restores bit-exact."""
    from torchsnapshot_tpu_torch.telemetry import metrics

    snap_path = os.path.join(workdir, "stall_snap")
    trace_dir = os.path.join(workdir, "stall_traces")
    w = torch.randn(STALL_ELEMS, generator=torch.Generator(device=DEV).manual_seed(seed + 3), device=DEV)
    metrics.reset()
    n_events = len(events)
    with knobs.override_stall_timeout_s(STALL_TIMEOUT_S), knobs.override_metrics(True), knobs.override_trace_dir(
        trace_dir
    ), knobs.override_faults(f"write:1:latency:{STALL_LATENCY_S}"):
        device_sync(torch)
        begin = time.monotonic()
        ts.Snapshot.take(snap_path, {"m": ts.StateDict({"w": w})})
        take_s = time.monotonic() - begin
        stalls_total = int(metrics.counter("tpusnap_stalls_total").get(action="take"))
    stalls = [e.metadata for e in events[n_events:] if e.name == "watchdog.stall"]
    sections, sampled = bundle_sections(stalls[0]["bundle"]) if stalls and stalls[0]["bundle"] else ([], {})
    dst = torch.zeros_like(w)
    ts.Snapshot(snap_path).restore({"m": ts.StateDict({"w": dst})})
    device_sync(torch)
    exact = bit_equal(torch, dst, w)
    ok = (bool(stalls) and stalls[0]["idle_s"] >= STALL_TIMEOUT_S and list(BUNDLE_SECTIONS) == sections
          and sampled.get("samples", 0) >= 1 and sampled["stacks"] >= 1 and not sampled["unparsed"]
          and stalls_total >= 1 and exact)
    emit({"phase": "monitor_stall", "ok": ok, "bytes": STALL_ELEMS * 4, "take_s": round(take_s, 3),
          "stall_timeout_s": STALL_TIMEOUT_S, "latency_s": STALL_LATENCY_S,
          "idle_s": [s["idle_s"] for s in stalls], "detection_latency_s": (
              round(stalls[0]["idle_s"] - STALL_TIMEOUT_S, 3) if stalls else None),
          "bundle_sections": sections, "sampled_profile": sampled, "stalls_total": stalls_total,
          "bit_exact": exact})
    metrics.reset()
    for path in (snap_path, trace_dir):
        shutil.rmtree(path)
    if not ok:
        raise RuntimeError("monitor_stall: the injected stall was not detected with its bundle (its five sections, "
                           "a sampled profile of at least one sample) and counter, or the take did not restore "
                           "bit-exact")


def crash_worker_entry(root, knob_env, seed, n_layers) -> None:
    """A spawned process on the card: with ``knob_env`` set, save the seeded
    parameter set at ``n_layers`` as step 0 of the manager root ``root``;
    the crash fault ends the process with exit code 1 mid-take (a save that
    completes exits 0)."""
    os.environ.update(knob_env)
    import torch

    if DEV == "cuda":
        torch.cuda.set_device(0)
    sys.path.insert(0, HERE)
    import torchsnapshot_tpu_torch as ts

    params = seeded_params(torch, n_layers, seed)
    device_sync(torch)
    ts.SnapshotManager(root).save(0, {"model": ts.StateDict(params)})


def monitor_crash_phase(workdir, seed, n_layers):
    """monitor_crash: a spawned process saves the 8-layer cut of the same
    widths as step 0 of a manager root with ``TPUSNAP_FAULTS=CRASH_FAULT``
    and ``TPUSNAP_BLACKBOX``: it exits 1, and its ring, read here with the
    port's ``blackbox.read_all``, names ``take.start``, the ``crash`` fault
    (op ``write``, its path, a phase) and no ``take.end``.  Then
    postmortem_crash reads the root and the ring before they go."""
    import torch.multiprocessing as tmp

    from torchsnapshot_tpu_torch.telemetry import blackbox

    crash_root = os.path.join(workdir, "crash_root")
    bb_dir = os.path.join(workdir, "crash_blackbox")
    knob_env = {"TPUSNAP_FAULTS": CRASH_FAULT, "TPUSNAP_BLACKBOX": bb_dir}
    ctx = tmp.get_context("spawn")
    begin = time.monotonic()
    proc = ctx.Process(target=crash_worker_entry, args=(crash_root, knob_env, seed, n_layers))
    proc.start()
    proc.join(CRASH_TIMEOUT_S)
    if proc.is_alive():
        proc.kill()
        proc.join()
    wall = time.monotonic() - begin
    records = ring_records(blackbox, bb_dir).get(proc.pid, [])
    ops = op_names(records)
    faults = [r for r in records if r["kind"] == "fault"]
    crash = faults[0]["data"] if faults and faults[0]["name"] == "crash" else {}
    ok = (proc.exitcode == 1 and "take.start" in ops and "take.end" not in ops and crash.get("op") == "write"
          and bool(crash.get("path")) and bool(crash.get("phase")))
    emit({"phase": "monitor_crash", "ok": ok, "n_layers": n_layers, "depth_cut": n_layers != N_LAYERS,
          "fault": CRASH_FAULT, "exit_code": proc.exitcode, "wall_s": round(wall, 3), "ring_pid": proc.pid,
          "ring_records": len(records), "ring_op_records": ops, "crash": crash,
          "last_records": [[r["kind"], r["name"]] for r in records[-6:]]})
    pm_ok = ok and postmortem_crash_phase(crash_root, bb_dir, proc.pid, crash)
    for path in (crash_root, bb_dir):
        shutil.rmtree(path, ignore_errors=True)
    if not ok:
        raise RuntimeError("monitor_crash: the child did not die on the crash fault, or its ring does not name the "
                           "open take and the fault")
    if not pm_ok:
        raise RuntimeError("postmortem_crash: the postmortem did not name the killed child's take, or its gc "
                           "prescription did not converge")


def postmortem_crash_phase(crash_root, bb_dir, child_pid, crash) -> bool:
    """postmortem_crash: ``analyze_root`` over monitor_crash's killed root
    and ring, its checks, the same report through ``postmortem --json``,
    the report's gc command run as a subprocess, and a second report that
    must find the debris gone.  Prints its line, then returns whether it
    held."""
    from torchsnapshot_tpu_torch.telemetry import analyze, postmortem

    begin = time.monotonic()
    report = postmortem.analyze_root(crash_root, blackbox_dir=bb_dir)
    first_s = time.monotonic() - begin
    fd = report["first_dead"] or {}
    fault = fd.get("fault") or {}
    markers = report["debris"]["inflight_markers"]
    gc = [a for a in report["remediation"]["actions"] if a["action"] == "gc"]
    stamps = [e["t"] for e in report["timeline"]]
    events = postmortem.to_perfetto(report)["traceEvents"]
    text = postmortem.format_report(report)
    ok = (report["classification"] == "killed_mid_take" and fd.get("pid") == child_pid != os.getpid()
          and fd.get("verdict") == "crash_fault" and fd.get("op") == "take"
          and (fault.get("op"), fault.get("path")) == (crash.get("op"), crash.get("path"))
          and bool(fd.get("phase")) and fd.get("phase_group") == analyze.classify_phase(fd["phase"])
          and any(m.get("pid") == child_pid for m in markers) and len(gc) == 1 and gc[0]["force"] is True
          and report["remediation"]["restore"]["committed_points"] == 0
          and stamps == sorted(stamps) and len(events) == len(stamps) and all("ts" in e for e in events)
          and "classification: killed_mid_take" in text and f"pid {child_pid}" in text)

    # The command line's report of the same root says the same.
    cli_rc, cli_out = run_cli(["postmortem", crash_root, "--blackbox", bb_dir, "--json"], "postmortem_crash")
    cli_doc = json.loads(cli_out) if cli_rc == 0 else {}
    cli_same = (cli_doc.get("classification") == report["classification"]
                and (cli_doc.get("first_dead") or {}).get("pid") == fd.get("pid"))
    # The report's own gc line, run as printed (``python`` is this
    # interpreter) from the checkout's root.
    argv = shlex.split(gc[0]["command"] if gc else f"python -m torchsnapshot_tpu_torch gc {crash_root} --apply --force")
    argv = [sys.executable if argv[0] == "python" else argv[0]] + argv[1:]
    begin = time.monotonic()
    proc = subprocess.run(argv, cwd=HERE, capture_output=True, text=True, timeout=CRASH_TIMEOUT_S)
    gc_s = time.monotonic() - begin
    record_cli("postmortem_crash", argv[1:], proc.returncode, 0, gc_s, how="subprocess")
    gc_lines = proc.stdout.splitlines()
    # The CLI names each orphan step it removes (the JAX CLI's lines: no
    # line for a marker, which the second report must find gone).
    reclaims = gc[0]["reclaims"]["steps"] if gc else []
    gc_named = (all(f"removed step_{step} (uncommitted)" in gc_lines for step in reclaims)
                and f"{len(reclaims)} orphaned snapshot dir(s) removed" in gc_lines)
    begin = time.monotonic()
    after = postmortem.analyze_root(crash_root, blackbox_dir=bb_dir)
    second_s = time.monotonic() - begin
    left = {k: after["debris"][k] for k in ("orphan_steps", "orphan_chunks", "orphan_segments", "inflight_markers")}
    converged = (proc.returncode == 0 and gc_named and not any(left.values())
                 and not any(a["action"] == "gc" for a in after["remediation"]["actions"]))
    ok = ok and cli_same
    emit({"phase": "postmortem_crash", "ok": ok and converged, "fault_spec": CRASH_FAULT,
          "classification": report["classification"], "first_dead_pid": fd.get("pid"), "child_pid": child_pid,
          "verdict": fd.get("verdict"), "op": fd.get("op"), "fault": fault, "phase_at_death": fd.get("phase"),
          "phase_group": fd.get("phase_group"),
          "bytes_at_death": report["bytes"] if report["bytes"]["staged"] is not None else None,
          "markers": [[m.get("name"), m.get("pid")] for m in markers],
          "gc": gc[0] if gc else None, "committed_points": report["remediation"]["restore"]["committed_points"],
          "processes": len(report["processes"]), "timeline_entries": len(stamps), "perfetto_events": len(events),
          "report_lines": len(text.splitlines()), "analyze_s": round(first_s, 4),
          "cli_json": {"exit_code": cli_rc, "classification": cli_doc.get("classification"),
                       "first_dead_pid": (cli_doc.get("first_dead") or {}).get("pid"), "same": cli_same},
          "gc_command": " ".join(shlex.quote(a) for a in argv), "gc_exit_code": proc.returncode,
          "gc_wall_s": round(gc_s, 3), "gc_last_line": gc_lines[-1] if gc_lines else None,
          "gc_named_reclaimed_steps": gc_named, "gc_stderr_tail": proc.stderr[-400:] if proc.returncode else None,
          "after": {"classification": after["classification"], "debris_left": left, "converged": converged,
                    "actions": [a["action"] for a in after["remediation"]["actions"]], "analyze_s": round(second_s, 4)}})
    return ok and converged


def monitor_phases(torch, ts, knobs, phase_stats, app_state, ref, nbytes, events, args, unmonitored_total_s):
    monitor_async_take_phase(torch, ts, knobs, phase_stats, app_state, ref, nbytes, events, args.workdir,
                             unmonitored_total_s)
    monitor_stall_phase(torch, ts, knobs, events, args.workdir, args.seed)
    monitor_crash_phase(args.workdir, args.seed, min(CRASH_LAYERS, args.n_layers))


# --------------------------------------------------- host data plane phases
#
# Direct I/O, the adaptive read strategy and micro-batched fused writes, at
# full size.  Each phase removes its directories before the next starts.

READ_WAYS = ("1", "8", None)  # pinned sequential, pinned parallel, measured


def payload_digests(manifest):
    """{(key, location, byte range): checksum} of every payload entry."""
    from torchsnapshot_tpu_torch.manifest import iter_payload_entries

    return {(k, e.location, tuple(getattr(e, "byte_range", None) or ())): e.checksum
            for k, e in iter_payload_entries(manifest)}


def evict_page_cache(root: str) -> int:
    """Drop the page-cache pages of every file under ``root`` (flushed first,
    so the pages are clean and droppable); returns the bytes evicted."""
    total = 0
    for dirpath, _, files in os.walk(root):
        for name in files:
            fd = os.open(os.path.join(dirpath, name), os.O_RDONLY)
            try:
                os.fsync(fd)
                os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
                total += os.fstat(fd).st_size
            finally:
                os.close(fd)
    return total


def phase_n(stats, phase: str) -> int:
    return int(stats.get(phase, {}).get("n", 0))


def direct_io_take_phase(torch, ts, knobs, phase_stats, app_state, ref, nbytes, events, workdir, buffered_manifest):
    """A sync take with TPUSNAP_DIRECT_IO=1: the resolved rung, whether the
    writes fell back to buffered I/O, the same digests as the buffered
    take of the same state, then a restore (a cold one: the page cache
    never held the payload)."""
    from torchsnapshot_tpu_torch.native_io import NativeFileIO

    path = os.path.join(workdir, "direct", "snap")
    first_event = len(events)
    device_sync(torch)
    with knobs.override_direct_io(True):
        phase_stats.reset()
        begin = time.monotonic()
        snapshot = ts.Snapshot.take(path, app_state)
        take_s = time.monotonic() - begin
        stats = phase_stats.snapshot()
        mode = NativeFileIO.get().direct_io_mode()
    degraded = [e.metadata for e in events[first_event:] if e.name == "native.degraded"]
    want, got = payload_digests(buffered_manifest), payload_digests(snapshot.get_manifest())
    differ = sorted(str(k) for k in set(want) | set(got) if want.get(k) != got.get(k))
    take_ok = mode in (1, 2, 3) and bool(want) and not differ and (mode == 3) == bool(degraded)
    emit({"phase": "direct_io_take", "ok": take_ok, "mode": mode,
          "mode_name": {1: "io_uring", 2: "O_DIRECT pwrite", 3: "buffered fallback"}.get(mode),
          "degraded_event": bool(degraded), "seconds": round(take_s, 3), "gbps": round(nbytes / GB / take_s, 3),
          "native_write_hash_wall_s": round(stats.get("native_write_hash", {}).get("wall", 0.0), 4),
          "commit_fs_write_s": round(stats.get("fs_write", {}).get("wall", 0.0), 4),
          "digests_compared": len(want), "digests_differ": differ[:5], "phases": phase_summary(stats)})
    if not take_ok:
        raise RuntimeError(f"direct_io_take: mode {mode}, degraded {degraded}, digests differ: {differ[:5]}")
    seconds, mismatched, moved, stats = restore_check(torch, ts, path, app_state, ref, phase_stats)
    ok = not mismatched and not moved
    emit({"phase": "direct_io_restore", "ok": ok, "cache": "cold (written with O_DIRECT)" if mode in (1, 2) else "warm",
          "seconds": round(seconds, 3), "gbps": round(nbytes / GB / seconds, 3), "bit_exact": not mismatched,
          "data_ptr_unchanged": not moved, "mismatched": mismatched[:5], "phases": phase_summary(stats)})
    if not ok:
        raise RuntimeError("direct_io_restore: not bit-exact in place")
    return path


def adaptive_restore_phase(torch, ts, knobs, phase_stats, app_state, ref, nbytes, path):
    """Unhashed restores (TPUSNAP_CHECKSUM=0) of the direct-I/O snapshot,
    so that the large reads take the adaptive path: pinned sequential
    (ways 1), pinned parallel (ways 8) and measured (unset), each from a
    cold page cache (evicted)."""
    from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin

    measured = []
    close = FSStoragePlugin.close

    async def close_recording(self):
        measured.append((self._seq_gbps, self._par_gbps))
        await close(self)

    FSStoragePlugin.close = close_recording
    try:
        with knobs.override_env("TPUSNAP_CHECKSUM", "0"):
            for ways in READ_WAYS:
                evicted = evict_page_cache(path)
                del measured[:]
                with knobs.override_env("TPUSNAP_PARALLEL_READ_WAYS", ways):
                    seconds, mismatched, moved, stats = restore_check(torch, ts, path, app_state, ref, phase_stats)
                seq, par = next(((s, p) for s, p in measured if s or p), (None, None))
                pick = None if seq is None or par is None else ("parallel" if par > seq else "sequential")
                ok = not mismatched and not moved and "checksum" not in stats
                emit({"phase": "adaptive_restore", "ok": ok, "ways": ways or "auto", "cache": "cold",
                      "evicted_bytes": evicted, "seconds": round(seconds, 3), "gbps": round(nbytes / GB / seconds, 3),
                      "sequential_reads": phase_n(stats, "fs_read"), "parallel_reads": phase_n(stats, "native_read"),
                      "measured_seq_gbps": seq and round(seq, 3), "measured_par_gbps": par and round(par, 3),
                      "adaptive_pick": pick, "bit_exact": not mismatched, "data_ptr_unchanged": not moved,
                      "phases": phase_summary(stats)})
                if not ok:
                    raise RuntimeError(f"adaptive_restore ways={ways}: not bit-exact in place, or hashed")
    finally:
        FSStoragePlugin.close = close


def module_layout(model):
    """The stacked parameters as an ``nn.Module.state_dict()`` of Llama-3-8B
    holds them: one tensor per layer and role (the Meta reference names),
    each a view of its stacked tensor, plus the embedding, final norm and
    output."""
    attn, mlp, layers = model["layers"]["attn"], model["layers"]["mlp"], model["layers"]
    flat = {"tok_embeddings.weight": model["embed"]["tokens"], "norm.weight": model["final_norm"],
            "output.weight": model["output"]["kernel"]}
    roles = (("attention.wq", attn["wq"]), ("attention.wk", attn["wk"]), ("attention.wv", attn["wv"]),
             ("attention.wo", attn["wo"]), ("feed_forward.w1", mlp["w_gate"]), ("feed_forward.w3", mlp["w_up"]),
             ("feed_forward.w2", mlp["w_down"]), ("attention_norm", layers["attn_norm"]),
             ("ffn_norm", layers["mlp_norm"]))
    for i in range(attn["wq"].shape[0]):
        for name, stacked in roles:
            flat[f"layers.{i}.{name}.weight"] = stacked[i]
    return flat


def torch_layout_take_phase(torch, ts, knobs, phase_stats, app_state, ref, nbytes, workdir):
    """The same weights as 291 per-layer tensors: a take with micro-batching
    off, then on (the default 8); equal digests; a bit-exact restore."""
    flat = module_layout(app_state["model"].state_dict())
    small = sum(1 for t in flat.values() if t.numel() * 2 <= 8 << 10)
    digests = {}
    for batch in (0, 8):
        path = os.path.join(workdir, "layout", f"batch_{batch}")
        device_sync(torch)
        phase_stats.reset()
        with knobs.override_env("TPUSNAP_NATIVE_BATCH", str(batch)):
            begin = time.monotonic()
            snapshot = ts.Snapshot.take(path, {"model": ts.StateDict(flat)})
            seconds = time.monotonic() - begin
        stats = phase_stats.snapshot()
        manifest = snapshot.get_manifest()
        digests[batch] = payload_digests(manifest)
        slabbed = sum(1 for k, e in manifest.items() if getattr(e, "location", "").startswith("batched/"))
        members = phase_n(stats, "native_write_batched")
        emit({"phase": "torch_layout_take", "ok": True, "native_batch": batch, "tensors": len(flat),
              "tensors_8kib_or_less": small, "slab_members": slabbed, "seconds": round(seconds, 3),
              "gbps": round(nbytes / GB / seconds, 3), "native_write_hash_calls": phase_n(stats, "native_write_hash"),
              "batched_calls": phase_n(stats, "native_write_batch"), "batched_members": members,
              "fused_batcher_saw_no_member": members == 0, "phases": phase_summary(stats)})
        if batch == 0:
            shutil.rmtree(path)
    model = app_state["model"].state_dict()
    ptrs = {k: t.data_ptr() for k, t in flat.items()}
    for p in ref:
        get_leaf(model, p).zero_()
    device_sync(torch)
    phase_stats.reset()
    begin = time.monotonic()
    ts.Snapshot(path).restore({"model": ts.StateDict(flat)})
    device_sync(torch)
    seconds = time.monotonic() - begin
    stats = phase_stats.snapshot()
    mismatched = [p for p in ref if not bit_equal(torch, get_leaf(model, p), ref[p])]
    moved = [k for k, t in flat.items() if t.data_ptr() != ptrs[k]]
    differ = sorted(str(k) for k in set(digests[0]) | set(digests[8]) if digests[0].get(k) != digests[8].get(k))
    ok = not mismatched and not moved and bool(digests[0]) and not differ
    emit({"phase": "torch_layout_restore", "ok": ok, "seconds": round(seconds, 3), "gbps": round(nbytes / GB / seconds, 3),
          "digests_compared": len(digests[0]), "digests_differ": differ[:5], "bit_exact": not mismatched,
          "data_ptr_unchanged": not moved, "mismatched": mismatched[:5], "phases": phase_summary(stats)})
    shutil.rmtree(os.path.dirname(path))
    if not ok:
        raise RuntimeError(f"torch_layout: digests differ {differ[:5]} or not bit-exact in place")


def data_plane_phases(torch, ts, knobs, phase_stats, app_state, ref, nbytes, events, workdir, buffered_manifest):
    path = direct_io_take_phase(torch, ts, knobs, phase_stats, app_state, ref, nbytes, events, workdir,
                                buffered_manifest)
    adaptive_restore_phase(torch, ts, knobs, phase_stats, app_state, ref, nbytes, path)
    shutil.rmtree(os.path.dirname(path))
    torch_layout_take_phase(torch, ts, knobs, phase_stats, app_state, ref, nbytes, workdir)


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
    port = free_port()
    return spawn_collect(dist_entry, [(job, rank, world, port, args.seed, args.workdir) for rank in range(world)],
                         job, "rank")


def spawn_collect(target, arg_tuples, label: str, who: str):
    """Run ``target(*args, conn)`` in one spawned process per tuple; each
    sends one message on ``conn``.  Every process's result, in order.  One
    that fails, dies or times out fails the phase, and every process still
    running is stopped."""
    import torch.multiprocessing as tmp

    ctx = tmp.get_context("spawn")
    world = len(arg_tuples)
    procs, conns = [], []
    for proc_args in arg_tuples:
        parent, child = ctx.Pipe()
        p = ctx.Process(target=target, args=(*proc_args, child))
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
        raise RuntimeError(f"{label}: " + "; ".join(f"{who} {r}: {e}" for r, e in sorted(errors.items())))
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
    analyzed = analyze_barrier_phase(async_snap, 4)
    if not async_ok:
        raise RuntimeError("dist_async_take: not bit-exact, wrong mode, not one commit, or bytes differ")
    if not analyzed:
        raise RuntimeError("analyze_barrier: not one report for the async take with the four ranks' arrivals, a "
                           "skew below 0, no blamed rank and phase, or the CLI's --barrier report differs")
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


def cli_take_phase(snap_path, manifest, array_nbytes):
    """cli_take: the command line over the take phase's snapshot, before it
    goes: ``info`` states its array bytes (the state's, the RNG states'
    arrays included) in the CLI's units, ``ls`` prints one line per manifest
    entry, and ``cat`` of the 8 KiB ``final_norm`` reads it onto the default
    device, the card, and prints its values (ones; bfloat16, which numpy
    lacks, prints through torch)."""
    from torchsnapshot_tpu_torch.__main__ import _human

    info_rc, info = run_cli(["info", snap_path], "cli_take")
    array_line = next((line for line in info.splitlines() if line.startswith("array bytes:")), None)
    ls_rc, ls = run_cli(["ls", snap_path], "cli_take")
    cat_argv = ["cat", snap_path, "0/model/final_norm"] + ([] if DEV == "cuda" else ["--device", DEV])
    cat_rc, cat = run_cli(cat_argv, "cli_take")
    ok = (info_rc == ls_rc == cat_rc == 0 and array_line == f"array bytes: {_human(array_nbytes)}"
          and len(ls.splitlines()) == len(manifest) and cat.startswith("tensor([1., 1., 1., 1.,  ..., 1., 1., 1., 1.]")
          and "dtype=torch.bfloat16" in cat and (DEV != "cuda" or "device='cuda:0'" in cat))
    emit({"phase": "cli_take", "ok": ok, "info_array_bytes": array_line, "expected_array_bytes": array_nbytes,
          "ls_lines": len(ls.splitlines()), "manifest_entries": len(manifest), "cat": " ".join(cat.split()),
          "exit_codes": [info_rc, ls_rc, cat_rc]})
    if not ok:
        raise RuntimeError("cli_take: info, ls or cat of the take's snapshot printed other than the state holds")


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
    cli_take_phase(snap_path, manifest, nbytes + array_bytes(app_state["rng"].state_dict()))
    shutil.rmtree(snap_path)

    # async phases: async_take in each staging mode at full size.  The
    # state is reached through app_state from here on, so that freeing a
    # tensor there really frees it.
    del params, w, small
    events: list = []
    event_handlers.register_event_handler(events.append)
    trace_take_restore_phase(torch, ts, knobs, phase_stats, app_state, ref, nbytes, events, args.workdir, take_s,
                             restore_s)
    scheduler_waits_phase(torch, ts, knobs, args.workdir, args.seed)
    profile_take_restore_phase(torch, ts, knobs, phase_stats, app_state, ref, nbytes, args.workdir, take_s, restore_s)
    # host data plane phases, held against the take phase's manifest.
    data_plane_phases(torch, ts, knobs, phase_stats, app_state, ref, nbytes, events, args.workdir, manifest)
    g = torch.Generator(device="cuda").manual_seed(args.seed + 2)
    mats = [torch.randn(STEP_DIM, STEP_DIM, generator=g, dtype=torch.bfloat16, device="cuda") * STEP_DIM ** -0.5
            for _ in range(2)]
    training_steps(torch, mats, 2, device_sync=True)  # warm-up
    common = (torch, ts, knobs, phase_stats, RSSWatermark, app_state, ref, nbytes, mats, events, args.workdir)
    runs = [async_phase(*common, "async_pinned_host", "auto", "pinned_host", run=1),
            async_phase(*common, "async_pinned_host", "pinned_host", "pinned_host", run=2)]
    emit({"phase": "async_pinned_host_stalls", "ok": True, "first_stall_s": round(runs[0][0], 4),
          "second_stall_s": round(runs[1][0], 4)})
    async_phase(*common, "async_device", "device", "device")
    async_phase(*common, "async_host", "host", "host")
    del mats
    # The health monitor and the flight recorder; the monitored async take
    # beside the unmonitored pinned_host run 2.
    monitor_phases(torch, ts, knobs, phase_stats, app_state, ref, nbytes, events, args, runs[1][1])
    storage_phases(torch, ts, knobs, phase_stats, app_state, ref, nbytes, events, args.workdir)
    manager_phases(torch, ts, knobs, phase_stats, app_state, ref, nbytes, events, args.workdir)
    cut = cloud_cut_phase(torch, ts, knobs, phase_stats, app_state, ref, events, args.workdir, n_layers)
    cut_state, cut_ref, cut_nbytes, cut_manifest, cut_incremental_bytes = cut
    cut_layers = min(CLOUD_LAYERS, n_layers)
    s3_phases(torch, ts, knobs, phase_stats, cut_state, cut_ref, cut_nbytes, events, cut_manifest, cut_layers)
    gcs_phases(torch, ts, knobs, phase_stats, cut_state, cut_ref, cut_nbytes, events, cut_manifest, cut_layers,
               cut_incremental_bytes)
    del cut, cut_state, cut_ref
    replicate_phases(torch, ts, knobs, phase_stats, RSSWatermark, app_state, ref, nbytes, args.workdir, n_layers)
    store_phases(torch, ts, knobs, phase_stats, app_state, ref, events, args.workdir)
    cache_phases(torch, ts, knobs, phase_stats, app_state, ref, nbytes, args)
    peer_phases(torch, ts, knobs, args)
    event_handlers.unregister_event_handler(events.append)
    cli_ok = bool(CLI_RUNS) and all(r["rc"] == r["expect"] for r in CLI_RUNS)
    emit({"phase": "cli", "ok": cli_ok, "commands": len(CLI_RUNS), "seconds": round(sum(r["s"] for r in CLI_RUNS), 3),
          "runs": CLI_RUNS})
    if not cli_ok:
        raise RuntimeError("cli: a command returned another exit code than its phase expected")

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
        print(traceback.format_exc(), file=sys.stderr, flush=True)
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
