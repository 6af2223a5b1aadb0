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
import subprocess
import sys
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
        from torchsnapshot_tpu_torch import phase_stats
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

    # 3. state: full width; cut only the depth, and only if it does not fit.
    free_dev, total_dev = torch.cuda.mem_get_info()
    free_disk = shutil.disk_usage(args.workdir).free
    n_layers = args.n_layers
    reserve_disk = (1 << 30) + (4 << 30)  # yardstick file + slack
    reserve_dev = 4 << 30  # read_object copy of embed.tokens + slack
    while n_layers > 1 and (
        2 * state_bytes(n_layers) + reserve_dev > free_dev
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
          "does as copy-engine D2H/H2D copies and view(torch.uint8)"})
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
