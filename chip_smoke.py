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
                the restore equals the state before the mutation); then
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


def dist_check(torch, params, seed: int):
    """Paths whose local box differs from the seeded values."""
    from torchsnapshot_tpu_torch import staging

    bad = []
    for path, shape, _ in llama_shapes(N_LAYERS):
        node = params
        for key in path:
            node = node[key]
        offsets, _ = staging.local_box(node)
        if not seeded_fill(torch, node.to_local(), tensor_seed(seed, path), shape, offsets, check=True):
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
    dist_restore (zero, restore in place), dist_async_take (mutate after
    return, wait, restore)."""
    from torch.distributed.tensor import Replicate, Shard

    from torchsnapshot_tpu_torch import event_handlers, faults, knobs, phase_stats
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

    on_disk = 0
    for dirpath, _, files in os.walk(path):
        for name in files:
            if name != ".snapshot_metadata":
                on_disk += os.path.getsize(os.path.join(dirpath, name))
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
    event_handlers.unregister_event_handler(events.append)
    del mats

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


if __name__ == "__main__":
    sys.exit(main())
