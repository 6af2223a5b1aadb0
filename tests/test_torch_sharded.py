"""Sharded (DTensor) planning, resharding reads, the partitioner and the
manifest transforms of torchsnapshot_tpu_torch.

Mirrors of tests/test_sharded_array_resharding.py, tests/test_partitioner.py
and tests/test_manifest_ops.py.  The pure functions (box arithmetic,
manifest views and merges, replicated consolidation) are held against the
JAX package's on the same inputs with exact equality; the resharding
matrix saves DTensors on 4 gloo ranks under one layout and restores them
under every other, uneven and empty shards included, bit for bit.
"""

import itertools
import os

import numpy as np
import pytest
import torch

from torchsnapshot_tpu_torch import knobs
from torchsnapshot_tpu_torch.test_utils import make_test_pg, run_with_procs

from torch_env import default_knob_env  # noqa: F401  autouse fixture

# ------------------------------------------------ box arithmetic vs JAX


def test_box_arithmetic_matches_the_jax_package():
    from torchsnapshot_tpu.io_preparers import sharded_array as jsa
    from torchsnapshot_tpu_torch.io_preparers import sharded_array as tsa

    rng = np.random.RandomState(0)
    for _ in range(200):
        ndim = int(rng.randint(1, 4))
        sizes = [int(rng.randint(1, 40)) for _ in range(ndim)]
        offsets = [int(rng.randint(0, 40)) for _ in range(ndim)]
        cap = int(rng.randint(4, 4096))
        dtype = ["float32", "bfloat16", "int8"][int(rng.randint(3))]
        assert tsa._subdivide(offsets, sizes, dtype, cap) == jsa._subdivide(offsets, sizes, dtype, cap)
        other_off = [int(rng.randint(0, 60)) for _ in range(ndim)]
        other_sz = [int(rng.randint(1, 40)) for _ in range(ndim)]
        assert tsa._overlap(offsets, sizes, other_off, other_sz) == jsa._overlap(
            offsets, sizes, other_off, other_sz
        )
        assert tsa._box_slices(offsets, sizes, [0] * ndim) == jsa._box_slices(offsets, sizes, [0] * ndim)


def test_storage_paths_match_the_jax_package():
    from torchsnapshot_tpu.io_preparers.sharded_array import ShardedArrayIOPreparer as J
    from torchsnapshot_tpu_torch.io_preparers.sharded_array import ShardedArrayIOPreparer as T

    for offsets in ([0, 0], [4, 0, 16], [7]):
        assert T.storage_path_for_piece("sharded/m/w", offsets) == J.storage_path_for_piece("sharded/m/w", offsets)


@pytest.mark.parametrize(
    "size,n", [(7, 4), (3, 4), (8, 4), (1, 2), (0, 2), (10, 3), (5, 5)], ids=str
)
def test_chunk_boxes_follow_torch_chunk(size, n):
    """Boxes follow torch.chunk: 7 rows over 4 ranks give 2, 2, 2, 1; three
    rows over four give an empty shard."""
    from torchsnapshot_tpu_torch import staging

    chunks = torch.arange(size).chunk(n) if size else []
    lengths = [len(c) for c in chunks] + [0] * (n - len(chunks))
    starts = [int(c[0]) for c in chunks]
    got = [staging._chunk(size, n, i) for i in range(n)]
    assert [length for _, length in got] == lengths
    assert [start for start, length in got if length] == starts


# ------------------------------------------------------ resharding matrix

SHAPE = (7, 10)  # uneven over every mesh below
LAYOUTS = {
    "1d_dim0": ((4,), ("x",), "S0"),
    "1d_dim1": ((4,), ("x",), "S1"),
    "2d": ((2, 2), ("x", "y"), "S0 S1"),
    "hsdp": ((2, 2), ("r", "s"), "R S0"),
    "two_axes_one_dim": ((2, 2), ("x", "y"), "S0 S0"),
    "replicated": ((4,), ("x",), "R"),
}


def _placements(spec):
    from torch.distributed.tensor import Replicate, Shard

    return [Replicate() if p == "R" else Shard(int(p[1:])) for p in spec.split()]


def _dt(full, name):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from torchsnapshot_tpu_torch import staging

    shape, names, spec = LAYOUTS[name]
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
    placements = _placements(spec)
    offsets, sizes = staging.box_at(full.shape, mesh.shape, mesh.get_coordinate(), placements)
    local = full[tuple(slice(o, o + s) for o, s in zip(offsets, sizes))].clone()
    return DTensor.from_local(local, mesh, placements, run_check=False, shape=full.shape, stride=full.stride())


def _box_bits_equal(dt, full):
    from torchsnapshot_tpu_torch import staging

    offsets, sizes = staging.local_box(dt)
    box = full[tuple(slice(o, o + s) for o, s in zip(offsets, sizes))]
    return torch.equal(dt.to_local(), box)


def _save(full, src, root, pg):
    """Plan, dedup and write this rank's pieces; returns the merged entry
    every rank reads."""
    from torchsnapshot_tpu_torch import io_preparer, staging
    from torchsnapshot_tpu_torch.io_preparers.sharded_array import as_sharded_entry
    from torchsnapshot_tpu_torch.manifest_ops import _get_merged_sharded_entries
    from torchsnapshot_tpu_torch.partitioner import partition_write_reqs
    from torchsnapshot_tpu_torch.scheduler import sync_execute_write_reqs
    from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin

    dt = _dt(full, src)
    entry, write_reqs = io_preparer.prepare_write(
        dt, logical_path="w", rank=pg.get_rank(), replicated=staging.is_fully_replicated(dt)
    )
    entries, write_reqs = partition_write_reqs({"w": entry}, write_reqs, pg)
    storage = FSStoragePlugin(root=root)
    sync_execute_write_reqs(write_reqs, storage, 1 << 30, pg.get_rank()).sync_complete()
    storage.sync_close()
    gathered = pg.all_gather_object(entries)
    merged = _get_merged_sharded_entries(gathered)
    if "w" in merged:
        return merged["w"]
    # A replicated tensor: one plain entry, on the rank that wrote it.
    (written,) = [m["w"] for m in gathered if "w" in m]
    return as_sharded_entry(written)


def _restore(entry, target, root):
    from torchsnapshot_tpu_torch import io_preparer
    from torchsnapshot_tpu_torch.scheduler import sync_execute_read_reqs
    from torchsnapshot_tpu_torch.storage_plugins.fs import FSStoragePlugin

    storage = FSStoragePlugin(root=root)
    read_reqs, fut = io_preparer.prepare_read(entry, target, device=torch.device("cpu"))
    sync_execute_read_reqs(read_reqs, storage, 1 << 30, 0)
    storage.sync_close()
    return fut.obj


@run_with_procs(nproc=4, gloo=True)
def _resharding_matrix_body():
    src = os.environ["TPUSNAP_TEST_SRC_LAYOUT"]
    pg = make_test_pg()
    root = os.path.join(os.path.dirname(knobs.get_store_path()), "snap")
    full = torch.randn(SHAPE, generator=torch.Generator().manual_seed(0))
    with knobs.override_max_shard_size_bytes(int(os.environ["TPUSNAP_TEST_SHARD_BYTES"])):
        entry = _save(full, src, root, pg)
    # Every box of the tensor is saved exactly once.
    covered = torch.zeros(SHAPE, dtype=torch.int32)
    for shard in entry.shards:
        covered[tuple(slice(o, o + s) for o, s in zip(shard.offsets, shard.sizes))] += 1
    assert torch.equal(covered, torch.ones(SHAPE, dtype=torch.int32))
    for dst in LAYOUTS:
        target = _dt(torch.zeros(SHAPE), dst)
        ptr = target.to_local().data_ptr()
        assert _restore(entry, target, root) is target
        assert target.to_local().data_ptr() == ptr
        assert _box_bits_equal(target, full), (src, dst)
    # Whole-tensor targets: none (a fresh tensor), a tensor, a numpy array,
    # and a tensor of another dtype (converted like copy_).
    assert torch.equal(_restore(entry, None, root), full)
    into = torch.zeros(SHAPE)
    assert _restore(entry, into, root) is into and torch.equal(into, full)
    into_np = np.zeros(SHAPE, np.float32)
    assert _restore(entry, into_np, root) is into_np
    assert np.array_equal(into_np, full.numpy())
    into64 = torch.zeros(SHAPE, dtype=torch.float64)
    _restore(entry, into64, root)
    assert torch.equal(into64, full.double())
    pg.barrier()


@pytest.mark.parametrize("shard_bytes", [1 << 20, 24], ids=["whole", "subdivided"])
@pytest.mark.parametrize("src", list(LAYOUTS))
def test_resharding_matrix(src, shard_bytes, monkeypatch):
    """Save under ``src`` on 4 ranks, restore under every layout: uneven
    boxes (7 x 10 over 2 and 4 ranks), two mesh axes on one dim, HSDP
    replicas, fully replicated, pieces subdivided below a box."""
    monkeypatch.setenv("TPUSNAP_TEST_SRC_LAYOUT", src)
    monkeypatch.setenv("TPUSNAP_TEST_SHARD_BYTES", str(shard_bytes))
    _resharding_matrix_body()


@run_with_procs(nproc=4, gloo=True)
def _layout_metadata_body():
    """Empty boxes are skipped, partition specs name the mesh axes, and the
    local box agrees with torch's layout function and the global layout."""
    from torch.distributed.tensor import Shard

    from torchsnapshot_tpu_torch import io_preparer, staging

    pg = make_test_pg()
    rank = pg.get_rank()
    empty = _dt(torch.ones(3, 4), "1d_dim0")  # 1, 1, 1, 0 rows
    entry, write_reqs = io_preparer.prepare_write(empty, logical_path="e", rank=rank)
    assert len(entry.shards) == (0 if rank == 3 else 1) == len(write_reqs)
    layout = staging.global_shard_layout(empty)
    assert sorted(layout) == [((0, 0), (1, 4), 0), ((1, 0), (1, 4), 1), ((2, 0), (1, 4), 2)]

    for name, (shape, names, spec) in LAYOUTS.items():
        dt = _dt(torch.zeros(SHAPE), name)
        assert staging.box_at(SHAPE, shape, dt.device_mesh.get_coordinate(), dt.placements) == staging.local_box(dt)
        mesh_shape, axis_names, partition_spec = staging.partition_spec_of(dt)
        assert mesh_shape == list(shape) and axis_names == list(names)
        expected = [[], []]
        for axis, p in zip(names, spec.split()):
            if p != "R":
                expected[int(p[1:])].append(axis)
        assert partition_spec == expected
        assert staging.is_sharded(dt) == (name != "replicated")
        assert staging.is_fully_replicated(dt) == (name == "replicated")
        boxes = staging.global_shard_layout(dt)
        cover = torch.zeros(SHAPE, dtype=torch.int32)
        for offsets, sizes, owner in boxes:
            cover[tuple(slice(o, o + s) for o, s in zip(offsets, sizes))] += 1
            assert 0 <= owner < 4
        assert torch.equal(cover, torch.ones(SHAPE, dtype=torch.int32))

    # Unnamed mesh dims are dim0, dim1, ...
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    mesh = init_device_mesh("cpu", (4,))
    dt = DTensor.from_local(torch.zeros(2, 3), mesh, [Shard(0)], run_check=False)
    assert staging.partition_spec_of(dt) == ([4], ["dim0"], [["dim0"], []])


def test_layout_metadata():
    _layout_metadata_body()


@run_with_procs(nproc=4, gloo=True)
def _partial_read_body():
    """A target that needs a row span of a saved piece reads only those
    rows (without the whole-piece digest); with partial reads off it reads
    the whole piece and verifies it."""
    from torchsnapshot_tpu_torch import faults

    pg = make_test_pg()
    root = os.path.join(os.path.dirname(knobs.get_store_path()), "snap")
    full = torch.randn(64, 256, generator=torch.Generator().manual_seed(1))
    with knobs.override_max_shard_size_bytes(1 << 30):
        entry = _save(full, "replicated", root, pg)  # one 64 KiB piece
    with knobs.override_faults("none"), knobs.override_partial_read_min_saved_bytes(1024):
        for partial in (True, False):
            faults.reset_read_counters()
            with knobs.override_partial_reads(partial):
                target = _dt(torch.zeros(64, 256), "1d_dim0")
                from torchsnapshot_tpu_torch.storage_plugin import url_to_storage_plugin
                from torchsnapshot_tpu_torch import io_preparer
                from torchsnapshot_tpu_torch.scheduler import sync_execute_read_reqs

                storage = url_to_storage_plugin(root)
                read_reqs, _ = io_preparer.prepare_read(entry, target)
                sync_execute_read_reqs(read_reqs, storage, 1 << 30, 0)
                storage.sync_close()
            assert _box_bits_equal(target, full)
            assert faults.total_read_bytes() == (16 * 256 * 4 if partial else 64 * 256 * 4)
    pg.barrier()


def test_partial_reads_fetch_only_needed_rows():
    _partial_read_body()


@run_with_procs(nproc=4, gloo=True)
def _random_resharding_body():
    seed = int(os.environ["TPUSNAP_TEST_SEED"])
    rng = np.random.RandomState(seed)
    pg = make_test_pg()
    root = os.path.join(os.path.dirname(knobs.get_store_path()), "snap")
    shape = (int(rng.randint(1, 13)), int(rng.randint(1, 9)))
    full = torch.from_numpy(rng.rand(*shape).astype(np.float32))
    names = sorted(LAYOUTS)
    src, dst = names[rng.randint(len(names))], names[rng.randint(len(names))]
    with knobs.override_max_shard_size_bytes(int(rng.randint(4, 256))):
        entry = _save(full, src, root, pg)
    target = _dt(torch.zeros(shape), dst)
    _restore(entry, target, root)
    assert _box_bits_equal(target, full), (shape, src, dst)
    pg.barrier()


@pytest.mark.parametrize("seed", range(4))
def test_resharding_property_random(seed, monkeypatch):
    """Random shapes (uneven and empty boxes), layouts and piece sizes."""
    monkeypatch.setenv("TPUSNAP_TEST_SEED", str(seed))
    _random_resharding_body()


def test_sharded_entry_dropped_when_unrequested(tmp_path):
    """A sharded entry restores only into a target; without one it is
    dropped and the other leaves restore."""
    from torchsnapshot_tpu_torch.manifest import (
        DictEntry,
        Shard,
        ShardedArrayEntry,
        TensorEntry,
    )
    from torchsnapshot_tpu_torch.manifest_ops import handle_sharded_array_elasticity

    sharded = ShardedArrayEntry(
        dtype="float32",
        shape=[4],
        shards=[Shard(offsets=[0], sizes=[4], tensor=TensorEntry("sharded/m/w.0", "buffer_protocol", "float32", [4], False))],
    )
    manifest = {"m": DictEntry(keys=["w", "plain"]), "m/w": sharded, "m/plain": TensorEntry("0/m/plain", "buffer_protocol", "float32", [4], False)}
    handle_sharded_array_elasticity(manifest, {"m/w": sharded}, ["m/plain"])
    assert "m/w" not in manifest and "m/plain" in manifest


# -------------------------------------------------------------- partitioner


@run_with_procs(nproc=4)
def _dedup_and_balance_body():
    from torchsnapshot_tpu_torch.io_preparer import prepare_write
    from torchsnapshot_tpu_torch.manifest import TensorEntry
    from torchsnapshot_tpu_torch.partitioner import (
        consolidate_replicated_entries,
        partition_write_reqs,
    )

    pg = make_test_pg()
    rank = pg.get_rank()
    entries = {}
    write_reqs = []
    for i in range(8):
        entry, reqs = prepare_write(torch.zeros(128 * (i + 1)), f"m/w{i}", rank=rank, replicated=True)
        entries[f"m/w{i}"] = entry
        write_reqs += reqs
    priv, priv_reqs = prepare_write(torch.zeros(64), "m/priv", rank=rank, replicated=False)
    entries["m/priv"] = priv
    write_reqs += priv_reqs

    pruned, kept = partition_write_reqs(entries, write_reqs, pg)

    kept_shared = [wr.path for wr in kept if wr.path.startswith("replicated/")]
    gathered = pg.all_gather_object(kept_shared)
    all_paths = [p for paths in gathered for p in paths]
    assert sorted(all_paths) == sorted(f"replicated/m/w{i}" for i in range(8))
    assert max(len(paths) for paths in gathered) <= 4
    assert any(wr.path == f"{rank}/m/priv" for wr in kept)
    for i in range(8):
        assert (f"m/w{i}" in pruned) == (f"replicated/m/w{i}" in kept_shared)

    gathered_entries = pg.all_gather_object(pruned)
    consolidated = consolidate_replicated_entries(gathered_entries)
    for i in range(8):
        assert f"m/w{i}" in consolidated[0]
    for r in (1, 2, 3):
        assert not any(isinstance(e, TensorEntry) and e.replicated for e in consolidated[r].values())


def test_partitioner_dedup_and_balance():
    _dedup_and_balance_body()


def test_single_process_identity():
    from torchsnapshot_tpu_torch.io_preparer import prepare_write
    from torchsnapshot_tpu_torch.partitioner import partition_write_reqs
    from torchsnapshot_tpu_torch.pg_wrapper import PGWrapper

    entry, reqs = prepare_write(torch.zeros(64), "m/w", rank=0, replicated=True)
    entries = {"m/w": entry}
    out_entries, out_reqs = partition_write_reqs(entries, reqs, PGWrapper())
    assert out_entries is entries
    assert out_reqs is reqs


def _to_port(jax_manifest):
    """The same manifest through the JSON both packages read and write."""
    from torchsnapshot_tpu.manifest import SnapshotMetadata as JMD
    from torchsnapshot_tpu_torch.manifest import SnapshotMetadata as TMD

    return TMD.from_json(JMD(version="0.1.0", world_size=1, manifest=jax_manifest).to_json()).manifest


def _json_of(manifest, package="torch"):
    if package == "torch":
        from torchsnapshot_tpu_torch.manifest import SnapshotMetadata as MD
    else:
        from torchsnapshot_tpu.manifest import SnapshotMetadata as MD
    return MD(version="0.1.0", world_size=1, manifest=manifest).to_json()


def test_consolidation_matches_the_jax_package():
    """Replicated entries (plain and chunk-partitioned) collect into rank
    0's manifest exactly as the JAX package collects them."""
    from torchsnapshot_tpu import manifest as jm
    from torchsnapshot_tpu.partitioner import consolidate_replicated_entries as jconsolidate
    from torchsnapshot_tpu_torch.partitioner import consolidate_replicated_entries as tconsolidate

    def chunk(off, loc):
        return jm.Shard(offsets=[off, 0], sizes=[2, 4], tensor=jm.TensorEntry(loc, "buffer_protocol", "float32", [2, 4], True))

    per_rank = [
        {
            "m/r": jm.TensorEntry("replicated/m/r", "buffer_protocol", "float32", [4], True),
            "m/c": jm.ChunkedTensorEntry("float32", [6, 4], [chunk(4, "replicated/m/c_4_0")], True),
            "m/p": jm.TensorEntry("0/m/p", "buffer_protocol", "float32", [4], False),
        },
        {
            "m/c": jm.ChunkedTensorEntry("float32", [6, 4], [chunk(0, "replicated/m/c_0_0"), chunk(2, "replicated/m/c_2_0")], True),
            "m/p": jm.TensorEntry("1/m/p", "buffer_protocol", "float32", [4], False),
        },
    ]
    expected = jconsolidate([dict(m) for m in per_rank])
    got = tconsolidate([_to_port(m) for m in per_rank])
    assert [_json_of(m) for m in got] == [_json_of(m, "jax") for m in expected]


# ------------------------------------------------------- manifest transforms


def _jax_metadata():
    from torchsnapshot_tpu.manifest import (
        DictEntry,
        PrimitiveEntry,
        Shard,
        ShardedArrayEntry,
        SnapshotMetadata,
        TensorEntry,
    )

    def tensor(loc, replicated=False):
        return TensorEntry(location=loc, serializer="buffer_protocol", dtype="float32", shape=[4, 4], replicated=replicated)

    def shard(offsets, sizes, loc):
        return Shard(offsets=offsets, sizes=sizes, tensor=TensorEntry(loc, "buffer_protocol", "float32", sizes, False))

    manifest = {
        "0/m": DictEntry(keys=["w", "s", "p", "r"]),
        "1/m": DictEntry(keys=["w", "s"]),
        "0/m/w": tensor("0/m/w"),
        "1/m/w": tensor("1/m/w"),
        "0/m/s": ShardedArrayEntry(
            dtype="float32", shape=[8, 4], shards=[shard([0, 0], [4, 4], "sharded/m/s.0_0")],
            mesh_shape=[2], axis_names=["x"], partition_spec=[["x"], []],
        ),
        "1/m/s": ShardedArrayEntry(
            dtype="float32", shape=[8, 4], shards=[shard([4, 0], [4, 4], "sharded/m/s.4_0")],
            mesh_shape=[2], axis_names=["x"], partition_spec=[["x"], []],
        ),
        "0/m/p": PrimitiveEntry.from_object(17),
        "0/m/r": tensor("replicated/m/r", replicated=True),
    }
    return SnapshotMetadata(version="0.1.0", world_size=2, manifest=manifest)


def _port_metadata():
    from torchsnapshot_tpu_torch.manifest import SnapshotMetadata

    return SnapshotMetadata.from_json(_jax_metadata().to_json())


@pytest.mark.parametrize("rank", [0, 1, 5])
@pytest.mark.parametrize("requests", [None, [], ["m/s", "m/w"]], ids=["no_elasticity", "none_requested", "requested"])
def test_rank_views_match_the_jax_package(rank, requests):
    """get_manifest_for_rank and handle_sharded_array_elasticity give the
    port and the JAX package the same view, entry for entry."""
    from torchsnapshot_tpu import manifest_ops as jops
    from torchsnapshot_tpu_torch import manifest_ops as tops

    j_local, j_merged = jops.get_manifest_for_rank(_jax_metadata(), rank)
    t_local, t_merged = tops.get_manifest_for_rank(_port_metadata(), rank)
    if requests is not None:
        jops.handle_sharded_array_elasticity(j_local, j_merged, requests)
        tops.handle_sharded_array_elasticity(t_local, t_merged, requests)
    assert _json_of(t_local) == _json_of(j_local, "jax")
    assert _json_of(t_merged) == _json_of(j_merged, "jax")


def test_existing_rank_gets_merged_shards_and_replicated():
    from torchsnapshot_tpu_torch.manifest_ops import get_manifest_for_rank

    local, merged = get_manifest_for_rank(_port_metadata(), rank=1)
    assert sorted(tuple(s.offsets) for s in local["m/s"].shards) == [(0, 0), (4, 0)]
    assert local["m/s"].partition_spec == [["x"], []]
    assert "m/r" in local and local["m/r"].replicated
    assert local["m/w"].location == "1/m/w"
    assert "m/s" in merged


def test_new_rank_gets_only_replicated_and_containers():
    from torchsnapshot_tpu_torch.manifest_ops import get_manifest_for_rank

    local, _ = get_manifest_for_rank(_port_metadata(), rank=5)
    assert "m/r" in local and "m/w" not in local and "m/s" not in local
    assert "w" not in local["m"].keys and "r" in local["m"].keys


def test_shard_dedup_on_merge():
    from torchsnapshot_tpu_torch.manifest import Shard, TensorEntry
    from torchsnapshot_tpu_torch.manifest_ops import get_manifest_for_rank

    md = _port_metadata()
    md.manifest["1/m/s"].shards.append(
        Shard(offsets=[0, 0], sizes=[4, 4], tensor=TensorEntry("sharded/m/s.0_0", "buffer_protocol", "float32", [4, 4], False))
    )
    local, _ = get_manifest_for_rank(md, rank=0)
    assert len(local["m/s"].shards) == 2


def test_elasticity_adds_requested_missing_entry():
    from torchsnapshot_tpu_torch.manifest_ops import (
        get_manifest_for_rank,
        handle_sharded_array_elasticity,
    )

    local, merged = get_manifest_for_rank(_port_metadata(), rank=5)
    handle_sharded_array_elasticity(local, merged, ["m/s", "m/w"])
    assert "m/s" in local and "s" in local["m"].keys


def test_elasticity_removes_unrequested_entry():
    from torchsnapshot_tpu_torch.manifest_ops import (
        get_manifest_for_rank,
        handle_sharded_array_elasticity,
    )

    local, merged = get_manifest_for_rank(_port_metadata(), rank=0)
    handle_sharded_array_elasticity(local, merged, [])
    assert "m/s" not in local


def test_replica_predicates_and_rank_sets():
    """HSDP predicates and replica rank sets on the manifest's layout
    fields, equal to the JAX package's where its helper runs."""
    from torchsnapshot_tpu_torch import manifest_utils as tmu
    from torchsnapshot_tpu_torch.manifest import ShardedArrayEntry, TensorEntry

    hsdp = ShardedArrayEntry("float32", [8, 4], [], mesh_shape=[2, 2], axis_names=["r", "s"], partition_spec=[["s"], []])
    sharded = ShardedArrayEntry("float32", [8, 4], [], mesh_shape=[2, 2], axis_names=["r", "s"], partition_spec=[["r"], ["s"]])
    assert tmu.is_partially_replicated_entry(hsdp)
    assert not tmu.is_partially_replicated_entry(sharded)
    assert tmu.is_sharded_entry(hsdp) and not tmu.is_fully_replicated_entry(hsdp)
    assert tmu.is_fully_replicated_entry(TensorEntry("replicated/x", "buffer_protocol", "float32", [2], True))
    # Mesh (r=2, s=2) over 4 ranks: ranks {0, 2} hold s=0, {1, 3} hold s=1.
    assert tmu.get_replicated_rank_sets(hsdp, 4) == [{0, 2}, {1, 3}]
    assert tmu.get_replicated_rank_sets(sharded, 4) == [{0}, {1}, {2}, {3}]
    assert tmu.get_replicated_rank_sets(hsdp, 3) == []
    # The JAX package's helper names _sharded_axes without defining it, so
    # it cannot run (torchsnapshot_tpu/manifest_utils.py:96); its replica
    # math is held here by the rank sets above, drawn by hand.
    assert list(itertools.chain.from_iterable(tmu.get_replicated_rank_sets(hsdp, 4))) == [0, 2, 1, 3]


# ------------------------------------- cross-package parity (rank bodies)
#
# The rank bodies of tests/test_torch_parity.py's multi-rank cases live
# here, in a module that imports no JAX, so the forkserver children never
# load it.  The parent names the snapshot directory and the layout in the
# environment; values are made from a seed with numpy on both sides.

PARITY_SHAPES = {"w_f32": ((16, 12), "float32"), "w_bf16": ((8, 16), "bfloat16"), "w_i32": ((8, 6), "int32")}


def parity_value(name):
    """The seeded global value of a parity tensor, as a torch CPU tensor."""
    shape, dtype = PARITY_SHAPES[name]
    rng = np.random.RandomState(sum(map(ord, name)))
    n = int(np.prod(shape))
    if dtype == "bfloat16":
        bits = rng.randint(0, 1 << 16, size=n).astype(np.uint16)
        return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16).reshape(shape)
    if dtype == "int32":
        return torch.from_numpy(rng.randint(-(1 << 30), 1 << 30, size=shape).astype(np.int32))
    return torch.from_numpy(rng.rand(*shape).astype(np.float32))


PARITY_TARGETS = {
    # world size -> [(mesh shape, names, placements per tensor)]
    2: ((2,), ("x",), {"w_f32": "S1", "w_bf16": "S0", "w_i32": "R"}),
    4: ((2, 2), ("r", "s"), {"w_f32": "R S0", "w_bf16": "S1 S0", "w_i32": "S0 S1"}),
}


def _parity_targets(world):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from torchsnapshot_tpu_torch import staging

    mesh_shape, names, specs = PARITY_TARGETS[world]
    mesh = init_device_mesh("cpu", mesh_shape, mesh_dim_names=names)
    out = {}
    for name, spec in specs.items():
        full = parity_value(name)
        placements = _placements(spec)
        offsets, sizes = staging.box_at(full.shape, mesh.shape, mesh.get_coordinate(), placements)
        local = torch.zeros(sizes, dtype=full.dtype)
        out[name] = DTensor.from_local(local, mesh, placements, run_check=False, shape=full.shape, stride=full.stride())
    return out


def _parity_restore_jax_snapshot(world):
    _restore_parity_into_dtensors(os.environ["TPUSNAP_TEST_SNAPSHOT"], make_test_pg(), world)


def _restore_parity_into_dtensors(path, pg, world):
    """Restore the parity tensors at ``path`` in place into DTensors of the
    world's target layouts; every rank's box must be bit-exact."""
    from torchsnapshot_tpu_torch import Snapshot, StateDict

    targets = _parity_targets(world)
    ptrs = {k: v.to_local().data_ptr() for k, v in targets.items()}
    dst = {"m": StateDict(targets)}
    Snapshot(path, pg=pg).restore(dst)
    for name in PARITY_SHAPES:
        got = dst["m"][name]
        assert got.to_local().data_ptr() == ptrs[name]
        offsets, sizes = staging_box(got)
        box = parity_value(name)[tuple(slice(o, o + s) for o, s in zip(offsets, sizes))]
        assert torch.equal(got.to_local().view(torch.uint8), box.contiguous().view(torch.uint8)), name


def staging_box(dt):
    from torchsnapshot_tpu_torch import staging

    return staging.local_box(dt)


@run_with_procs(nproc=2, gloo=True)
def parity_restore_jax_snapshot_2():
    _parity_restore_jax_snapshot(2)


@run_with_procs(nproc=4, gloo=True)
def parity_restore_jax_snapshot_4():
    _parity_restore_jax_snapshot(4)


@run_with_procs(nproc=2, gloo=True)
def parity_take_2():
    """2 ranks take the parity tensors as DTensors of the 2-rank target
    layouts (Shard(1), Shard(0), Replicate())."""
    from torchsnapshot_tpu_torch import Snapshot, StateDict

    targets = _parity_targets(2)
    for name, dt in targets.items():
        offsets, sizes = staging_box(dt)
        dt.to_local().copy_(parity_value(name)[tuple(slice(o, o + s) for o, s in zip(offsets, sizes))])
    Snapshot.take(os.environ["TPUSNAP_TEST_SNAPSHOT"], {"m": StateDict(targets)}, pg=make_test_pg())


@run_with_procs(nproc=4, gloo=True)
def parity_take_for_jax():
    """4 ranks take the parity tensors as DTensors: HSDP, a two-axis
    layout, and an uneven Shard(1) with an empty box (6 columns over 4)."""
    from torchsnapshot_tpu_torch import Snapshot, StateDict

    pg = make_test_pg()
    layouts = {"w_f32": "hsdp", "w_bf16": "2d", "w_i32": "1d_dim1"}
    state = {name: _dt(parity_value(name), layout) for name, layout in layouts.items()}
    Snapshot.take(os.environ["TPUSNAP_TEST_SNAPSHOT"], {"m": StateDict(state)}, pg=pg)


@run_with_procs(nproc=4, gloo=True)
def parity_take_hsdp_layout():
    """The layout both packages can express: a (2, 2) mesh
    ("replicate", "shard"), dim 0 sharded over "shard"."""
    from torchsnapshot_tpu_torch import Snapshot, StateDict

    pg = make_test_pg()
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from torchsnapshot_tpu_torch import staging

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("replicate", "shard"))
    full = parity_value("w_f32")
    placements = _placements("R S0")
    offsets, sizes = staging.box_at(full.shape, mesh.shape, mesh.get_coordinate(), placements)
    local = full[tuple(slice(o, o + s) for o, s in zip(offsets, sizes))].clone()
    dt = DTensor.from_local(local, mesh, placements, run_check=False, shape=full.shape, stride=full.stride())
    Snapshot.take(os.environ["TPUSNAP_TEST_SNAPSHOT"], {"m": StateDict({"w_f32": dt})}, pg=pg)


@run_with_procs(nproc=2, gloo=True)
def parity_restore_raises_checksum_error():
    from torchsnapshot_tpu_torch import ChecksumError, Snapshot, StateDict

    pg = make_test_pg()
    dst = {"m": StateDict(_parity_targets(2))}
    with knobs.override_partial_reads(False):
        with pytest.raises(ChecksumError):
            Snapshot(os.environ["TPUSNAP_TEST_SNAPSHOT"], pg=pg).restore(dst)


ASYNC_PARITY_LAYOUTS = {
    # name -> (mesh shape, mesh names, placements)
    "w_f32": ((2, 2), ("replicate", "shard"), "R S0"),  # HSDP
    "w_bf16": ((4,), ("x",), "R"),  # fully replicated
    "w_i32": ((4,), ("x",), "S1"),  # 6 columns over 4: 2, 2, 2, 0
}


def _parity_dt(name, mesh_shape, names, spec):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from torchsnapshot_tpu_torch import staging

    mesh = init_device_mesh("cpu", mesh_shape, mesh_dim_names=names)
    full = parity_value(name)
    placements = _placements(spec)
    offsets, sizes = staging.box_at(full.shape, mesh.shape, mesh.get_coordinate(), placements)
    local = full[tuple(slice(o, o + s) for o, s in zip(offsets, sizes))].clone()
    return DTensor.from_local(local, mesh, placements, run_check=False, shape=full.shape, stride=full.stride())


@run_with_procs(nproc=4, gloo=True)
def parity_async_take_for_jax():
    """4 ranks take HSDP, fully Replicate and uneven Shard(1) DTensors and
    a ``replicated=`` step twice: into ``sync`` with take, and into
    ``async`` with async_take in the environment's staging mode, mutating
    every local tensor and the step right after it returns."""
    from torchsnapshot_tpu_torch import Snapshot, StateDict, device_staging

    if os.environ.get("TPUSNAP_TEST_CPU_AS_DEVICE"):
        # The device modes on CPU tensors, as tests/test_torch_async.py's
        # cpu_as_device fixture drives them.
        from torchsnapshot_tpu_torch import staging

        device_staging._is_device_resident = lambda obj: isinstance(obj, torch.Tensor)
        staging.pinned_empty = lambda n: torch.empty(n, dtype=torch.uint8)
    pg = make_test_pg()
    root = os.environ["TPUSNAP_TEST_SNAPSHOT"]

    def state():
        values = {name: _parity_dt(name, *layout) for name, layout in ASYNC_PARITY_LAYOUTS.items()}
        return {"m": StateDict(dict(values, step=7))}

    Snapshot.take(os.path.join(root, "sync"), state(), pg=pg, replicated=["m/step"])
    app = state()
    pending = Snapshot.async_take(os.path.join(root, "async"), app, pg=pg, replicated=["m/step"])
    for name in ASYNC_PARITY_LAYOUTS:
        app["m"][name].to_local().view(torch.uint8).fill_(0x55)
    app["m"]["step"] = -1
    assert pending.staging_mode == device_staging.configured_mode()
    pending.wait()


# Storage-depth variants of the multi-rank parity case (knob environment of
# each); the CDC sizes are small enough to split the KB-sized slabs.
STORAGE_DEPTH_VARIANTS = {
    "zstd": {"TPUSNAP_COMPRESSION": "zstd", "TPUSNAP_COMPRESSION_MIN_BYTES": "0"},
    "cas": {"TPUSNAP_CAS": "1"},
    "cdc": {
        "TPUSNAP_CAS": "1",
        "TPUSNAP_CDC": "1",
        "TPUSNAP_CDC_MIN_BYTES": "64",
        "TPUSNAP_CDC_AVG_BYTES": "128",
        "TPUSNAP_CDC_MAX_BYTES": "256",
    },
}


def changed_parity_value(name):
    """The value a second CAS take writes for ``name``: every byte + 1."""
    value = parity_value(name).clone()
    value.view(torch.uint8).add_(1)
    return value


@run_with_procs(nproc=4, gloo=True)
def parity_storage_depth_4():
    """Under each storage-depth variant, 4 ranks restore the JAX package's
    ``<root>/jax_<variant>/step_0`` in place into DTensors, then take the
    HSDP, fully Replicate and uneven Shard(1) layouts into
    ``<root>/port_<variant>/step_0``; the CAS variants take again into
    ``step_1`` with only ``w_bf16`` changed."""
    import contextlib

    from torchsnapshot_tpu_torch import Snapshot, StateDict

    pg = make_test_pg()
    root = os.environ["TPUSNAP_TEST_SNAPSHOT"]
    for variant, env in STORAGE_DEPTH_VARIANTS.items():
        with contextlib.ExitStack() as stack:
            for key, value in env.items():
                stack.enter_context(knobs.override_env(key, value))
            _restore_parity_into_dtensors(os.path.join(root, f"jax_{variant}", "step_0"), pg, 4)
            state = {name: _parity_dt(name, *layout) for name, layout in ASYNC_PARITY_LAYOUTS.items()}
            Snapshot.take(os.path.join(root, f"port_{variant}", "step_0"), {"m": StateDict(state)}, pg=pg)
            if variant == "zstd":
                continue
            state["w_bf16"].to_local().view(torch.uint8).add_(1)
            Snapshot.take(os.path.join(root, f"port_{variant}", "step_1"), {"m": StateDict(state)}, pg=pg)


# The manager's journal over DTensors on 2 ranks: an HSDP layout on a
# (2, 1) ("replicate", "shard") mesh and an uneven Shard(0) (7 rows over 2:
# 4, 3).  The parent restores the root through the JAX package's manager.

MANAGER_PARITY_LAYOUTS = {
    "w_f32": ((2, 1), ("replicate", "shard"), "R S0"),
    "w_bf16": ((2,), ("x",), "S1"),
    "uneven": ((2,), ("x",), "S0"),
}


def manager_parity_value(name, step):
    """The seeded value of ``name`` at journal step ``step``: ``w_bf16``
    changes at step 2 (every byte + 1), the rest never."""
    if name == "uneven":
        value = torch.from_numpy(np.random.RandomState(5).rand(7, 5).astype(np.float32))
    else:
        value = parity_value(name)
    if name == "w_bf16" and step >= 2:
        value = changed_parity_value(name)
    return value


def _manager_dt(name, step, zero=False):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from torchsnapshot_tpu_torch import staging

    mesh_shape, names, spec = MANAGER_PARITY_LAYOUTS[name]
    mesh = init_device_mesh("cpu", mesh_shape, mesh_dim_names=names)
    full = manager_parity_value(name, step)
    placements = _placements(spec)
    offsets, sizes = staging.box_at(full.shape, mesh.shape, mesh.get_coordinate(), placements)
    local = full[tuple(slice(o, o + s) for o, s in zip(offsets, sizes))].clone()
    if zero:
        local.zero_()
    return DTensor.from_local(local, mesh, placements, run_check=False, shape=full.shape, stride=full.stride())


@run_with_procs(nproc=2, gloo=True)
def parity_manager_journal_2():
    """2 ranks: a journal manager saves step 1 (the base) and step 2 (a
    segment with ``w_bf16`` changed), then restore_latest replays it in
    place on both ranks.  The segment holds only the changed entry."""
    from torchsnapshot_tpu_torch import StateDict, journal
    from torchsnapshot_tpu_torch.manager import SnapshotManager
    from torchsnapshot_tpu_torch.storage_plugin import url_to_storage_plugin

    pg = make_test_pg()
    root = os.environ["TPUSNAP_TEST_SNAPSHOT"]
    mgr = SnapshotManager(root, pg=pg, journal=True)
    for step in (1, 2):
        state = {name: _manager_dt(name, step) for name in MANAGER_PARITY_LAYOUTS}
        mgr.save(step, {"m": StateDict(dict(state, step=step))}, replicated=["m/step"])
    assert mgr.restore_points() == [(1, "full"), (2, "seg")]
    storage = url_to_storage_plugin(root)
    try:
        seg = journal.read_segment_metadata(storage, 2)
    finally:
        storage.sync_close()
    assert {k.split("/", 1)[1] for k in seg.manifest} == {"m/w_bf16", "m/step"}
    targets = {name: _manager_dt(name, 2, zero=True) for name in MANAGER_PARITY_LAYOUTS}
    ptrs = {k: v.to_local().data_ptr() for k, v in targets.items()}
    dst = {"m": StateDict(dict(targets, step=-1))}
    assert mgr.restore_latest(dst) == 2
    assert dst["m"]["step"] == 2
    for name in MANAGER_PARITY_LAYOUTS:
        got = dst["m"][name]
        assert got.to_local().data_ptr() == ptrs[name]
        offsets, sizes = staging_box(got)
        box = manager_parity_value(name, 2)[tuple(slice(o, o + s) for o, s in zip(offsets, sizes))]
        assert torch.equal(got.to_local().view(torch.uint8), box.contiguous().view(torch.uint8)), name
