"""Multi-rank snapshots of torchsnapshot_tpu_torch on gloo ranks on the CPU.

Mirrors of tests/test_distributed.py (take and restore, elastic up- and
downscale, successive snapshots on one group, the async two-phase commit
and its failure, rank death without commit, the C++ store, the scale
protocol, ``get_state_dict_for_key`` and divergent keys), each with DTensor
state beside the plain values: FSDP-style ``Shard(0)``, HSDP-style
``[Replicate(), Shard(0)]``, fully ``Replicate``, uneven and empty shards,
and an FSDP2-style local tensor that is a view into a flat buffer.  Every
restore is compared bit for bit with the values the take saw.  Bodies run
in forkserver children (test_utils.run_with_procs) and touch no JAX.
"""

import os

import pytest
import torch

from torchsnapshot_tpu_torch import knobs
from torchsnapshot_tpu_torch.test_utils import (
    assert_state_dict_eq,
    make_test_pg,
    run_with_procs,
)


def _run_dir(name: str) -> str:
    """A directory beside the run's FileStore (removed with the run)."""
    return os.path.join(os.path.dirname(knobs.get_store_path()), name)


def _shared_dir(name: str) -> str:
    """A directory the parent test named, shared by several runs."""
    return os.path.join(os.environ["TPUSNAP_TEST_DIR"], name)


def _mesh(shape, names):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))


def _box_of(full: torch.Tensor, mesh, placements):
    from torchsnapshot_tpu_torch import staging

    offsets, sizes = staging.box_at(full.shape, mesh.shape, mesh.get_coordinate(), placements)
    return tuple(slice(o, o + s) for o, s in zip(offsets, sizes))


def _dtensor(full: torch.Tensor, mesh, placements, local=None):
    """This rank's DTensor of ``full`` (its box cut from ``full``, or copied
    into ``local`` when given)."""
    from torch.distributed.tensor import DTensor

    box = full[_box_of(full, mesh, placements)]
    if local is None:
        local = box.clone()
    else:
        local.copy_(box)
    return DTensor.from_local(
        local, mesh, placements, run_check=False, shape=full.shape, stride=full.stride()
    )


def _full(seed: int, shape, dtype=torch.float32) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype)


def _local_bits_equal(dt, full) -> bool:
    box = full[_box_of(full, dt.device_mesh, dt.placements)]
    if not box.numel():
        return dt.to_local().numel() == 0
    return torch.equal(dt.to_local().contiguous().view(torch.uint8), box.contiguous().view(torch.uint8))


@run_with_procs(nproc=4, gloo=True)
def _distributed_take_restore_body():
    from torch.distributed.tensor import Replicate, Shard

    from torchsnapshot_tpu_torch import Snapshot, StateDict
    from torchsnapshot_tpu_torch.manifest import ShardedArrayEntry
    from torchsnapshot_tpu_torch.pg_wrapper import PGWrapper

    pg = PGWrapper.from_torch()
    rank = pg.get_rank()
    path = _run_dir("take_restore")
    mesh2d = _mesh((2, 2), ("replicate", "shard"))
    mesh1d = _mesh((4,), ("fsdp",))
    fulls = {
        "hsdp": _full(1, (8, 6)),
        "fsdp": _full(2, (7, 5)),  # 2, 2, 2, 1 rows
        "empty_shard": _full(3, (3, 4)),  # 1, 1, 1, 0 rows
        "norm": _full(4, (6,)),
        "bf16": _full(5, (4, 8), torch.bfloat16),
    }
    # FSDP2-style: the local shard is a view into a flat parameter buffer.
    flat = torch.zeros(64)
    fsdp_local_box = _box_of(fulls["fsdp"], mesh1d, [Shard(0)])
    n = fulls["fsdp"][fsdp_local_box].numel()
    flat_view = flat[8 : 8 + n].view(fulls["fsdp"][fsdp_local_box].shape)
    # ... and a strided (non-contiguous) view into another buffer.
    fulls["strided"] = _full(6, (8, 5))  # 2 rows a rank
    strided_buf = torch.zeros(5, 2, 2)
    strided_view = strided_buf[:, :, 0].t()
    assert not strided_view.is_contiguous()

    def _state(zero: bool):
        def make(full, mesh, placements, local=None):
            return _dtensor(torch.zeros_like(full) if zero else full, mesh, placements, local)

        return {
            "hsdp": make(fulls["hsdp"], mesh2d, [Replicate(), Shard(0)]),
            "fsdp": make(fulls["fsdp"], mesh1d, [Shard(0)], local=flat_view),
            "strided": make(fulls["strided"], mesh1d, [Shard(0)], local=strided_view if zero else None),
            "empty_shard": make(fulls["empty_shard"], mesh1d, [Shard(0)]),
            "norm": make(fulls["norm"], mesh2d, [Replicate(), Replicate()]),
            "bf16": make(fulls["bf16"], mesh2d, [Shard(1), Shard(0)]),
            "shared": torch.arange(64, dtype=torch.float32).reshape(8, 8) * (0 if zero else 1),
            "private": torch.full((4,), -1.0 if zero else float(rank)),
            "step": -1 if zero else 100,
        }

    app_state = {"m": StateDict(_state(zero=False))}
    snapshot = Snapshot.take(path, app_state, replicated=["m/shared", "m/step"])

    manifest = snapshot.get_manifest()
    assert manifest["0/m/shared"].replicated and "1/m/shared" not in manifest
    assert manifest["0/m/norm"].replicated and "1/m/norm" not in manifest
    assert manifest["0/m/step"].replicated and "3/m/step" not in manifest
    for r in range(4):
        assert f"{r}/m/private" in manifest
    hsdp = [manifest[f"{r}/m/hsdp"] for r in range(4) if f"{r}/m/hsdp" in manifest]
    assert all(isinstance(e, ShardedArrayEntry) for e in hsdp)
    assert hsdp[0].mesh_shape == [2, 2]
    assert hsdp[0].axis_names == ["replicate", "shard"]
    assert hsdp[0].partition_spec == [["shard"], []]
    # Each HSDP box is written by one of its two holders.
    written = sorted(
        (tuple(s.offsets), s.tensor.location) for e in hsdp for s in e.shards
    )
    assert [w[0] for w in written] == [(0, 0), (4, 0)], written
    assert manifest["0/m/bf16"].partition_spec == [["shard"], ["replicate"]]
    empty_boxes = [
        s.sizes for r in range(4) for s in getattr(manifest.get(f"{r}/m/empty_shard"), "shards", [])
    ]
    assert sorted(empty_boxes) == [[1, 4], [1, 4], [1, 4]]

    dst_state = _state(zero=True)
    ptrs = {k: v.to_local().data_ptr() for k, v in dst_state.items() if hasattr(v, "to_local")}
    dst = {"m": StateDict(dst_state)}
    snapshot.restore(dst)
    restored = dst["m"].state_dict()
    for key, full in fulls.items():
        assert _local_bits_equal(restored[key], full), key
        assert restored[key].to_local().data_ptr() == ptrs[key], key
    assert torch.equal(flat[8 : 8 + n], fulls["fsdp"][fsdp_local_box].reshape(-1))
    assert torch.equal(strided_buf[:, :, 0].t(), fulls["strided"][_box_of(fulls["strided"], mesh1d, [Shard(0)])])
    assert torch.count_nonzero(strided_buf[:, :, 1]) == 0
    assert torch.equal(restored["shared"], torch.arange(64, dtype=torch.float32).reshape(8, 8))
    assert torch.equal(restored["private"], torch.full((4,), float(rank)))
    assert restored["step"] == 100


def test_distributed_take_restore():
    _distributed_take_restore_body()


def test_partial_and_strided_placements_are_refused():
    """Partial (pending reduction) and _StridedShard placements have no box
    layout: planning raises a TypeError naming the placement and path."""
    _refused_placements_body()


@run_with_procs(nproc=2, gloo=True)
def _refused_placements_body():
    from torch.distributed.tensor import DTensor, Partial, Shard
    from torch.distributed.tensor.placement_types import _StridedShard

    from torchsnapshot_tpu_torch import io_preparer

    mesh = _mesh((2,), ("x",))
    for placement, name in ((Partial(), "Partial"), (_StridedShard(0, split_factor=2), "_StridedShard")):
        dt = DTensor.from_local(torch.ones(2, 2), mesh, [placement], run_check=False)
        with pytest.raises(TypeError, match=name) as err:
            io_preparer.prepare_write(dt, logical_path="m/w", rank=0)
        assert "m/w" in str(err.value)
    # Shard itself is fine.
    io_preparer.prepare_write(
        DTensor.from_local(torch.ones(2, 2), mesh, [Shard(0)], run_check=False),
        logical_path="m/ok",
        rank=0,
    )


# ------------------------------------------------------------ elasticity


def _elastic_state(rank: int, mesh, zero: bool):
    from torch.distributed.tensor import Replicate, Shard

    from torchsnapshot_tpu_torch import StateDict

    placements = [Shard(0)] if mesh.ndim == 1 else [Replicate(), Shard(0)]
    w = _full(10, (9, 6))
    return {
        "m": StateDict(
            {
                "shared": torch.ones(4, 4) * (0 if zero else 7),
                "mine": torch.full((2,), -1.0 if zero else float(rank)),
                "w": _dtensor(torch.zeros_like(w) if zero else w, mesh, placements),
            }
        )
    }


@run_with_procs(nproc=2, gloo=True)
def _save2_body():
    from torchsnapshot_tpu_torch import Snapshot

    pg = make_test_pg()
    mesh = _mesh((2,), ("fsdp",))
    Snapshot.take(
        _shared_dir("elastic2"), _elastic_state(pg.get_rank(), mesh, zero=False),
        pg=pg, replicated=["m/shared"],
    )


@run_with_procs(nproc=4, gloo=True)
def _restore4_body():
    from torch.distributed.tensor import Shard

    from torchsnapshot_tpu_torch import Snapshot

    pg = make_test_pg()
    rank = pg.get_rank()
    mesh = _mesh((4,), ("fsdp",))
    snapshot = Snapshot(_shared_dir("elastic2"), pg=pg)
    w = _full(10, (9, 6))
    dst = _elastic_state(rank, mesh, zero=True)
    # Resharded on the other dim at twice the world size.
    dst["m"]["w"] = _dtensor(torch.zeros_like(w), mesh, [Shard(1)])
    snapshot.restore(dst)
    # Replicated state restores on every rank, ranks beyond the saved world
    # size included; sharded state from any saved box.
    assert torch.equal(dst["m"]["shared"], torch.ones(4, 4) * 7)
    assert _local_bits_equal(dst["m"]["w"], w)
    if rank < 2:
        assert torch.equal(dst["m"]["mine"], torch.full((2,), float(rank)))
    else:
        # No saved private state for these ranks: their view holds only the
        # replicated and sharded entries, and StateDict.load_state_dict
        # replaces its contents with that view.
        assert "mine" not in dst["m"].state_dict()


def test_elastic_upscale_restore(tmp_path, monkeypatch):
    """Save at world size 2 (Shard(0)), restore at world size 4 (Shard(1))."""
    monkeypatch.setenv("TPUSNAP_TEST_DIR", str(tmp_path))
    _save2_body()
    _restore4_body()


@run_with_procs(nproc=4, gloo=True)
def _save4_body():
    from torchsnapshot_tpu_torch import Snapshot

    pg = make_test_pg()
    mesh = _mesh((2, 2), ("replicate", "shard"))
    Snapshot.take(
        _shared_dir("elastic4"), _elastic_state(pg.get_rank(), mesh, zero=False),
        pg=pg, replicated=["m/shared"],
    )


@run_with_procs(nproc=2, gloo=True)
def _restore2_body():
    from torch.distributed.tensor import Shard

    from torchsnapshot_tpu_torch import Snapshot

    pg = make_test_pg()
    rank = pg.get_rank()
    mesh = _mesh((2,), ("fsdp",))
    snapshot = Snapshot(_shared_dir("elastic4"), pg=pg)
    assert snapshot.metadata.world_size == 4
    w = _full(10, (9, 6))
    dst = _elastic_state(rank, mesh, zero=True)
    dst["m"]["w"] = _dtensor(torch.zeros_like(w), mesh, [Shard(1)])
    snapshot.restore(dst)
    assert torch.equal(dst["m"]["shared"], torch.ones(4, 4) * 7)
    assert _local_bits_equal(dst["m"]["w"], w)
    # Each rank keeps its own saved private state; ranks 2 and 3's is not
    # loaded by anyone.
    assert torch.equal(dst["m"]["mine"], torch.full((2,), float(rank)))


def test_elastic_downscale_restore(tmp_path, monkeypatch):
    """Save at world size 4 (HSDP), restore at world size 2 (Shard(1))."""
    monkeypatch.setenv("TPUSNAP_TEST_DIR", str(tmp_path))
    _save4_body()
    _restore2_body()


@run_with_procs(nproc=2, gloo=True)
def _successive_snapshots_body():
    """Several takes and restores through one process group: collective
    key generations stay monotonic."""
    from torch.distributed.tensor import Shard

    from torchsnapshot_tpu_torch import Snapshot, StateDict
    from torchsnapshot_tpu_torch.pg_wrapper import PGWrapper

    pg = PGWrapper.from_torch()
    rank = pg.get_rank()
    root = _run_dir("successive")
    mesh = _mesh((2,), ("fsdp",))
    for step in (1, 2, 3):
        full = _full(step, (4, 4))
        app_state = {
            "m": StateDict(
                {
                    "w": torch.full((8,), float(step * 10 + rank)),
                    "shared": torch.full((4,), float(step)),
                    "dt": _dtensor(full, mesh, [Shard(0)]),
                }
            )
        }
        snapshot = Snapshot.take(os.path.join(root, f"step{step}"), app_state, replicated=["m/shared"])
        assert PGWrapper.from_torch() is pg
        dst = {"m": StateDict({"dt": _dtensor(torch.zeros(4, 4), mesh, [Shard(0)])})}
        snapshot.restore(dst)
        assert_state_dict_eq(dst["m"].state_dict(), app_state["m"].state_dict())

    early = Snapshot(os.path.join(root, "step1"))
    dst = {"m": StateDict({})}
    early.restore(dst)
    assert torch.equal(dst["m"]["shared"], torch.full((4,), 1.0))


def test_successive_snapshots_one_pg():
    _successive_snapshots_body()


# ----------------------------------------------------------------- async


@run_with_procs(nproc=2, gloo=True)
def _async_take_body():
    from torch.distributed.tensor import Replicate, Shard

    from torchsnapshot_tpu_torch import Snapshot, StateDict

    if os.environ.get("TPUSNAP_TEST_CPU_AS_DEVICE"):
        # The device modes on CPU tensors: the residency predicate widened
        # as tests/test_torch_async.py's cpu_as_device fixture does.
        from torchsnapshot_tpu_torch import device_staging, staging

        device_staging._is_device_resident = lambda obj: isinstance(obj, torch.Tensor)
        staging.pinned_empty = lambda n: torch.empty(n, dtype=torch.uint8)
    pg = make_test_pg()
    rank = pg.get_rank()
    path = _run_dir("async")
    mesh = _mesh((2,), ("fsdp",))
    full = _full(7, (6, 4))
    app_state = {
        "m": StateDict(
            {
                "w": torch.full((16,), float(rank)),
                "k": rank,
                "dt": _dtensor(full, mesh, [Shard(0)]),
                "rep": _dtensor(full, mesh, [Replicate()]),
            }
        )
    }
    expected = {k: (v.to_local().clone() if hasattr(v, "to_local") else v) for k, v in app_state["m"].state_dict().items()}
    expected["w"] = expected["w"].clone()
    pending = Snapshot.async_take(path, app_state, pg=pg)
    # The caller owns the state again: mutate every tensor in place.
    for key in ("w", "dt", "rep"):
        value = app_state["m"][key]
        (value.to_local() if hasattr(value, "to_local") else value).add_(1000)
    snapshot = pending.wait()
    assert pending.done()
    from torchsnapshot_tpu_torch import device_staging

    assert pending.staging_mode == device_staging.configured_mode()
    assert os.path.exists(os.path.join(path, ".snapshot_metadata"))
    assert not [n for n in os.listdir(path) if n.startswith(".manifest_rank_")]

    dst = {
        "m": StateDict(
            {
                "w": torch.zeros(16),
                "k": -1,
                "dt": _dtensor(torch.zeros(6, 4), mesh, [Shard(0)]),
                "rep": _dtensor(torch.zeros(6, 4), mesh, [Replicate()]),
            }
        )
    }
    snapshot.restore(dst)
    got = dst["m"].state_dict()
    assert torch.equal(got["w"], expected["w"]) and got["k"] == rank
    assert torch.equal(got["dt"].to_local(), expected["dt"])
    assert torch.equal(got["rep"].to_local(), expected["rep"])
    # The commit barrier's keys are swept at a later barrier.
    pg.barrier()
    pg.barrier()
    if rank == 0:
        assert pg.store.delete_prefix("linear_barrier/") == 0


@pytest.mark.parametrize("mode", ["host", "device", "pinned_host"])
def test_async_take_two_phase_commit(mode, monkeypatch):
    """Both ranks commit once through the LinearBarrier, in every staging
    mode (the device modes on CPU tensors through the widened residency
    predicate of tests/test_torch_async.py)."""
    monkeypatch.setenv(knobs.ASYNC_STAGING_ENV_VAR, mode)
    monkeypatch.setenv("TPUSNAP_TEST_CPU_AS_DEVICE", "1")
    _async_take_body()


@run_with_procs(nproc=2, gloo=True)
def _async_take_failure_body():
    from unittest import mock

    from torchsnapshot_tpu_torch import Snapshot, StateDict
    from torchsnapshot_tpu_torch.storage_plugins import fs as fs_mod

    pg = make_test_pg()
    rank = pg.get_rank()
    path = _run_dir("async_fail")

    class FaultyFSStoragePlugin(fs_mod.FSStoragePlugin):
        async def write(self, write_io):
            if rank == 1:
                raise RuntimeError("injected storage failure")
            await super().write(write_io)

    app_state = {"m": StateDict({"w": torch.ones(8)})}
    with mock.patch.object(fs_mod, "FSStoragePlugin", FaultyFSStoragePlugin):
        pending = Snapshot.async_take(path, app_state, pg=pg)
        with pytest.raises(Exception) as err:
            pending.wait()
        assert "injected" in repr(err.value) or type(err.value).__name__ == "StorePeerError"
    pg.barrier()
    assert not os.path.exists(os.path.join(path, ".snapshot_metadata"))


def test_async_take_failure_no_commit():
    _async_take_failure_body()


def test_rank_death_mid_take_times_out_without_commit(tmp_path):
    """A peer that never joins surfaces as TimeoutError on the survivor and
    nothing commits."""
    from torchsnapshot_tpu_torch import Snapshot, StateDict
    from torchsnapshot_tpu_torch.dist_store import FileStore
    from torchsnapshot_tpu_torch.pg_wrapper import PGWrapper

    snap_path = str(tmp_path / "snap")
    pg = PGWrapper(store=FileStore(str(tmp_path / "store")), rank=0, world_size=2, timeout_s=2.0)
    app = {"m": StateDict({"w": torch.ones(64)})}
    with pytest.raises(TimeoutError):
        Snapshot.take(snap_path, app, pg=pg)
    assert not os.path.exists(os.path.join(snap_path, ".snapshot_metadata"))


@run_with_procs(nproc=2)
def _killed_rank_body():
    """Rank 1 dies (SIGKILL) in the middle of the take; rank 0 must raise
    StorePeerError in about the lease grace, far inside the barrier
    timeout, and nothing commits."""
    import signal
    import time

    from torchsnapshot_tpu_torch import Snapshot, StateDict
    from torchsnapshot_tpu_torch.dist_store import StorePeerError

    pg = make_test_pg()
    rank = pg.get_rank()
    path = _run_dir("killed")
    app = {"m": StateDict({"w": torch.ones(1024)})}
    if rank == 1:
        import threading

        threading.Timer(1.0, lambda: os.kill(os.getpid(), signal.SIGKILL)).start()
        with knobs.override_faults("write:1:latency:30"):
            Snapshot.take(path, app, pg=pg)
        return
    begin = time.monotonic()
    with pytest.raises(StorePeerError, match="presumed dead"):
        Snapshot.take(path, app, pg=pg)
    assert time.monotonic() - begin < 20.0
    assert not os.path.exists(os.path.join(path, ".snapshot_metadata"))


def test_killed_rank_aborts_peers_within_lease_grace(monkeypatch):
    monkeypatch.setenv(knobs.LEASE_INTERVAL_S_ENV_VAR, "0.2")
    monkeypatch.setenv(knobs.LEASE_GRACE_S_ENV_VAR, "2.0")
    monkeypatch.setenv(knobs.BARRIER_TIMEOUT_S_ENV_VAR, "60")
    with pytest.raises(AssertionError) as err:
        _killed_rank_body()
    # Only the victim fails, and by its own SIGKILL.
    report = str(err.value)
    assert "rank 1:\nexit code -9" in report and "rank 0" not in report, report


# ----------------------------------------------------------- C++ store


@run_with_procs(nproc=4, gloo=True)
def _cpp_store_snapshot_body():
    from torch.distributed.tensor import Replicate, Shard

    from torchsnapshot_tpu_torch import Snapshot, StateDict
    from torchsnapshot_tpu_torch.tpustore import TCPStore

    pg = make_test_pg()
    assert isinstance(pg.store, TCPStore)
    rank = pg.get_rank()
    snap_path = _shared_dir("cpp_store_snap")
    mesh = _mesh((2, 2), ("replicate", "shard"))
    full = _full(3, (8, 4))

    def _app(zero):
        return {
            "shared": StateDict({"w": torch.full((64,), 0.0 if zero else 3.0)}),
            "local": StateDict(
                {
                    "x": torch.full((16,), 0.0 if zero else float(rank)),
                    "dt": _dtensor(torch.zeros_like(full) if zero else full, mesh, [Replicate(), Shard(0)]),
                }
            ),
        }

    app = _app(zero=False)
    Snapshot.take(snap_path, app, pg=pg, replicated=["shared/**"])
    pending = Snapshot.async_take(snap_path + "_async", app, pg=pg, replicated=["shared/**"])
    pending.wait()
    for path in (snap_path, snap_path + "_async"):
        dst = _app(zero=True)
        Snapshot(path, pg=pg).restore(dst)
        assert torch.equal(dst["shared"]["w"], torch.full((64,), 3.0))
        assert torch.equal(dst["local"]["x"], torch.full((16,), float(rank)))
        assert _local_bits_equal(dst["local"]["dt"], full)
    pg.barrier()


def test_distributed_snapshot_over_cpp_store(tmp_path, monkeypatch):
    """The whole protocol (sync, async, restore) over the C++ TCP store;
    the generation sweep keeps the server's key space bounded."""
    from torchsnapshot_tpu_torch.tpustore import TCPStore, TCPStoreServer

    server = TCPStoreServer()
    monkeypatch.setenv(knobs.STORE_ADDR_ENV_VAR, f"127.0.0.1:{server.port}")
    monkeypatch.setenv("TPUSNAP_TEST_KEEP_STORE_ADDR", "1")
    monkeypatch.setenv("TPUSNAP_TEST_DIR", str(tmp_path))
    try:
        _cpp_store_snapshot_body()
        probe = TCPStore("127.0.0.1", server.port)
        leftover = probe.delete_prefix("pg/")
        probe.close()
        assert leftover < 64, f"{leftover} unswept pg keys on the server"
    finally:
        server.stop()


# ------------------------------------------------------------ scale tests


@run_with_procs(nproc=16)
def _scale16_protocol_body():
    """The whole snapshot protocol at 16 ranks under real store contention:
    sync take, async take (LinearBarrier commit, storage sidecars),
    restore."""
    from torchsnapshot_tpu_torch import Snapshot, StateDict

    pg = make_test_pg()
    rank = pg.get_rank()
    assert pg.get_world_size() == 16
    snap_path = _shared_dir("snap16")
    app = {
        "shared": StateDict({"w": torch.arange(32, dtype=torch.float32)}),
        "local": StateDict({"x": torch.full((8,), float(rank)), "r": rank}),
    }
    Snapshot.take(snap_path, app, pg=pg, replicated=["shared/**"])
    pending = Snapshot.async_take(snap_path + "_async", app, pg=pg, replicated=["shared/**"])
    pending.wait()
    assert pending.done()
    for path in (snap_path, snap_path + "_async"):
        assert os.path.exists(os.path.join(path, ".snapshot_metadata"))
        dst = {
            "shared": StateDict({"w": torch.zeros(32)}),
            "local": StateDict({"x": torch.zeros(8), "r": -1}),
        }
        Snapshot(path, pg=pg).restore(dst)
        assert torch.equal(dst["shared"]["w"], torch.arange(32, dtype=torch.float32))
        assert torch.equal(dst["local"]["x"], torch.full((8,), float(rank)))
        assert dst["local"]["r"] == rank
    pg.barrier()


def test_snapshot_protocol_at_16_ranks_filestore(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUSNAP_TEST_DIR", str(tmp_path))
    _scale16_protocol_body()


def test_snapshot_protocol_at_16_ranks_cpp_store(tmp_path, monkeypatch):
    from torchsnapshot_tpu_torch.tpustore import TCPStore, TCPStoreServer

    server = TCPStoreServer()
    monkeypatch.setenv(knobs.STORE_ADDR_ENV_VAR, f"127.0.0.1:{server.port}")
    monkeypatch.setenv("TPUSNAP_TEST_KEEP_STORE_ADDR", "1")
    monkeypatch.setenv("TPUSNAP_TEST_DIR", str(tmp_path))
    try:
        _scale16_protocol_body()
        probe = TCPStore("127.0.0.1", server.port)
        leftover_pg = probe.delete_prefix("pg/")
        leftover_barrier = probe.delete_prefix("linear_barrier/")
        probe.close()
        assert leftover_pg < 256, f"{leftover_pg} unswept pg keys"
        assert leftover_barrier < 256, f"{leftover_barrier} unswept barrier keys"
    finally:
        server.stop()


@run_with_procs(nproc=16)
def _scale16_lock_storm_body():
    """16 ranks hammer one FileStore counter while a crashed holder's lock
    sits on it: every rank gets through and no increment is lost."""
    import time

    from torchsnapshot_tpu_torch.dist_store import FileStore

    rank = knobs.get_env_rank()
    store = FileStore(_shared_dir("storm"), lock_stale_s=1.0)
    if rank == 0:
        lock = store._key_path("storm") + ".lock"
        fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        os.write(fd, b"crashed-rank-token")
        os.close(fd)
        store.set("storm_ready", b"1")
    else:
        store.get("storm_ready", timeout_s=30)
    for _ in range(8):
        store.add("storm", 1)
    begin = time.monotonic()
    while store.add("storm", 0) != 128:
        if time.monotonic() - begin > 60:
            raise AssertionError(f"lost increments: {store.add('storm', 0)}/128")
        time.sleep(0.2)


def test_filestore_lock_storm_16_ranks(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUSNAP_TEST_DIR", str(tmp_path))
    _scale16_lock_storm_body()


# ------------------------------------------- per-rank views, divergence


@run_with_procs(nproc=2, gloo=True)
def _get_state_dict_for_key_rank_body():
    """get_state_dict_for_key sees the caller's rank view (its own private
    entries, every sharded entry whole); replicate_from_rank0 reads rank
    0's.  read_object reads a sharded entry whole from any rank."""
    from torch.distributed.tensor import Shard

    from torchsnapshot_tpu_torch import Snapshot, StateDict

    pg = make_test_pg()
    rank = pg.get_rank()
    mesh = _mesh((2,), ("fsdp",))
    full = _full(9, (5, 3))
    app = {"m": StateDict({"rank_value": torch.full((8,), float(rank)), "dt": _dtensor(full, mesh, [Shard(0)])})}
    snapshot = Snapshot.take(_run_dir("snap"), app, pg=pg)

    own = snapshot.get_state_dict_for_key("m", device="cpu")
    assert torch.equal(own["rank_value"], torch.full((8,), float(rank)))
    assert torch.equal(own["dt"], full)
    from_rank0 = snapshot.get_state_dict_for_key("m", device="cpu", replicate_from_rank0=True)
    assert torch.equal(from_rank0["rank_value"], torch.zeros(8))
    assert torch.equal(snapshot.read_object(f"{1 - rank}/m/dt", device="cpu"), full)
    into = torch.zeros(5, 3, dtype=torch.float64)
    assert snapshot.read_object("0/m/dt", obj_out=into) is into
    assert torch.equal(into, full.double())
    pg.barrier()


def test_get_state_dict_for_key_rank_semantics():
    _get_state_dict_for_key_rank_body()


@run_with_procs(nproc=2)
def _divergent_take_keys_body():
    import time

    from torchsnapshot_tpu_torch import Snapshot, StateDict

    pg = make_test_pg()
    rank = pg.get_rank()
    snap_dir = _run_dir("snap_divergent_take")
    app = {"m": StateDict({"w": torch.ones(8)})}
    if rank == 0:
        app["opt"] = StateDict({"lr": 0.1})
    begin = time.monotonic()
    with pytest.raises(RuntimeError) as err:
        Snapshot.take(snap_dir, app, pg=pg)
    assert "rank 1 is missing" in str(err.value), str(err.value)
    assert "opt" in str(err.value)
    assert time.monotonic() - begin < 60.0
    assert not os.path.exists(os.path.join(snap_dir, ".snapshot_metadata"))


def test_take_with_divergent_keys_fails_symmetrically():
    _divergent_take_keys_body()


@run_with_procs(nproc=2)
def _divergent_restore_keys_body():
    import time

    from torchsnapshot_tpu_torch import Snapshot, StateDict

    pg = make_test_pg()
    rank = pg.get_rank()
    snap_dir = _run_dir("snap_divergent_restore")
    Snapshot.take(snap_dir, {"m": StateDict({"w": torch.full((8,), float(rank))})}, pg=pg)
    snapshot = Snapshot(snap_dir, pg=pg)
    dst = {"m": StateDict({"w": torch.zeros(8)})}
    if rank == 0:
        dst["extra"] = StateDict({"x": 0})
    begin = time.monotonic()
    with pytest.raises(RuntimeError) as err:
        snapshot.restore(dst)
    assert "rank 1 is missing" in str(err.value), str(err.value)
    assert "extra" in str(err.value)
    assert time.monotonic() - begin < 60.0
    dst_ok = {"m": StateDict({"w": torch.zeros(8)})}
    snapshot.restore(dst_ok)
    assert torch.equal(dst_ok["m"]["w"], torch.full((8,), float(rank)))


def test_restore_with_divergent_keys_fails_symmetrically():
    _divergent_restore_keys_body()
