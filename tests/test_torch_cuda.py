"""CUDA paths of the port: D2H staging into pinned buffers, in-place H2D
restore, and async takes staged on the card (device mode) or into pinned
host memory (pinned_host mode).  Marked ``cuda``; each test skips without a CUDA device.  This
file imports neither JAX nor the JAX package, so it runs on a GPU host that
has neither:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Comparisons are exact (bitwise)."""

import pytest
import torch

from torchsnapshot_tpu_torch import ChecksumError, Snapshot, StateDict, knobs
from torchsnapshot_tpu_torch import device_staging, phase_stats
from torchsnapshot_tpu_torch.manifest import ChunkedTensorEntry

from torch_env import default_knob_env  # noqa: F401  autouse fixture


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def _state(device):
    g = torch.Generator(device=device).manual_seed(0)
    return {
        "w": torch.randn(256, 64, generator=g, device=device).to(torch.bfloat16),
        "nc": torch.randn(64, 32, generator=g, device=device).t(),
        "b": torch.arange(5, device=device),
        "s": torch.tensor(2.5, device=device),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("batching", [True, False], ids=["batching_on", "batching_off"])
@pytest.mark.parametrize("chunk_bytes", [1024, None], ids=["chunking_on", "chunking_off"])
def test_cuda_roundtrip_in_place(tmp_path, cuda_device, batching, chunk_bytes):
    state = _state(cuda_device)
    with knobs.override_batching_disabled(not batching), knobs.override_max_chunk_size_bytes(
        chunk_bytes or (512 << 20)
    ):
        phase_stats.reset()
        snapshot = Snapshot.take(str(tmp_path / "snap"), {"m": StateDict(state)})
        nbytes = sum(t.numel() * t.element_size() for t in state.values())
        assert phase_stats.snapshot()["d2h"]["bytes"] == nbytes
        assert isinstance(snapshot.get_manifest()["0/m/w"], ChunkedTensorEntry) == bool(chunk_bytes)
        dst = {k: torch.zeros_like(v) for k, v in state.items()}
        dst["nc"] = torch.zeros(64, 32, device=cuda_device).t()  # non-contiguous target
        ptrs = {k: v.data_ptr() for k, v in dst.items()}
        phase_stats.reset()
        snapshot.restore({"m": StateDict(dst)})
        torch.cuda.synchronize()
        assert phase_stats.snapshot()["h2d_land"]["bytes"] == nbytes
    for k, v in state.items():
        assert torch.equal(_bits(dst[k]), _bits(v)) and dst[k].data_ptr() == ptrs[k], k
    fresh = Snapshot(str(tmp_path / "snap")).read_object("0/m/w")
    assert fresh.is_cuda and torch.equal(_bits(fresh), _bits(state["w"]))


@pytest.mark.cuda
def test_cuda_dtype_conversion_and_parameters(tmp_path, cuda_device):
    src = torch.arange(1 << 20, dtype=torch.float32, device=cuda_device) / 3
    snapshot = Snapshot.take(str(tmp_path / "snap"), {"m": StateDict({"x": src})})
    dst = torch.nn.Parameter(torch.zeros(1 << 20, dtype=torch.float64, device=cuda_device))
    ptr = dst.data_ptr()
    snapshot.restore({"m": StateDict({"x": dst})})
    torch.cuda.synchronize()
    assert dst.data_ptr() == ptr and torch.equal(dst.detach(), src.double())


@pytest.mark.cuda
def test_cuda_cpu_cross_restore(tmp_path, cuda_device):
    """A CUDA take restores into CPU tensors and the reverse, bit-exact."""
    state = _state(cuda_device)
    Snapshot.take(str(tmp_path / "gpu"), {"m": StateDict(state)})
    cpu_dst = {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in state.items()}
    Snapshot(str(tmp_path / "gpu")).restore({"m": StateDict(cpu_dst)})
    for k, v in state.items():
        assert torch.equal(_bits(cpu_dst[k]), _bits(v.cpu())), k
    Snapshot.take(str(tmp_path / "cpu"), {"m": StateDict(cpu_dst)})
    gpu_dst = {k: torch.zeros_like(v) for k, v in state.items()}
    Snapshot(str(tmp_path / "cpu")).restore({"m": StateDict(gpu_dst)})
    torch.cuda.synchronize()
    for k, v in state.items():
        assert torch.equal(_bits(gpu_dst[k]), _bits(v)), k


@pytest.mark.cuda
def test_cuda_flipped_byte_raises(tmp_path, cuda_device):
    w = torch.randn(1024, 1024, device=cuda_device)
    path = tmp_path / "snap"
    entry = Snapshot.take(str(path), {"m": StateDict({"w": w})}).get_manifest()["0/m/w"]
    payload = path / entry.location
    data = bytearray(payload.read_bytes())
    data[(entry.byte_range or [0])[0] + 4321] ^= 0x08
    payload.write_bytes(bytes(data))
    with pytest.raises(ChecksumError):
        Snapshot(str(path)).restore({"m": StateDict({"w": torch.zeros_like(w)})})


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["device", "pinned_host"])
def test_cuda_async_take_mutation_after_return(tmp_path, cuda_device, mode):
    """Mutate every tensor in place, and free and refill one, right after
    async_take returns: the restore is bit-exact to the state of the take,
    and the D2H moved the state's bytes exactly once."""
    state = _state(cuda_device)
    expected = {k: _bits(v).clone() for k, v in state.items()}
    nbytes = sum(t.numel() * t.element_size() for t in state.values())
    app_state = {"m": StateDict(state)}
    device_staging.reset_pinned_host_health()
    phase_stats.reset()
    with knobs.override_async_staging(mode):
        pending = Snapshot.async_take(str(tmp_path / "snap"), app_state)
    for t in app_state["m"].values():
        t.fill_(-3)
    del state, t
    app_state["m"]["w"] = torch.full((256, 64), 9.0, dtype=torch.bfloat16, device=cuda_device)
    assert pending.staging_mode == mode
    snapshot = pending.wait()
    stats = phase_stats.snapshot()
    assert stats["device_stage"]["bytes"] == nbytes and stats["d2h"]["bytes"] == nbytes
    dst = {k: torch.zeros_like(v) for k, v in _state(cuda_device).items()}
    snapshot.restore({"m": StateDict(dst)})
    torch.cuda.synchronize()
    for k, v in expected.items():
        assert torch.equal(_bits(dst[k]), v), k


@pytest.mark.cuda
def test_cuda_device_mode_non_contiguous_and_parameter(tmp_path, cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    nc = torch.randn(64, 48, generator=g, device=cuda_device).t()
    p = torch.nn.Parameter(torch.randn(1000, generator=g, device=cuda_device))
    expected = {"nc": nc.clone(), "p": p.detach().clone()}
    with knobs.override_async_staging("device"):
        pending = Snapshot.async_take(str(tmp_path / "snap"), {"m": StateDict({"nc": nc, "p": p})})
    nc.zero_()
    with torch.no_grad():
        p.zero_()
    assert pending.staging_mode == "device"
    dst = {"nc": torch.zeros(48, 64, device=cuda_device), "p": torch.zeros(1000, device=cuda_device)}
    pending.wait().restore({"m": StateDict(dst)})
    torch.cuda.synchronize()
    for k, v in expected.items():
        assert torch.equal(_bits(dst[k]), _bits(v)), k


@pytest.mark.cuda
def test_cuda_auto_resolves_to_pinned_host(tmp_path, cuda_device):
    device_staging.reset_pinned_host_health()
    with knobs.override_async_staging("auto"):
        assert device_staging.resolve_mode({"m/w": torch.ones(4, device=cuda_device)}) == "pinned_host"
        pending = Snapshot.async_take(str(tmp_path / "snap"), {"m": StateDict({"w": torch.ones(4, device=cuda_device)})})
    pending.wait()
    assert pending.staging_mode == "pinned_host"


# ------------------------------------------------ DTensors on the card
#
# Two ranks share cuda:0 and join a gloo group (NCCL refuses two ranks on
# one device; the library uses the group only to bootstrap its store).
# Ranks are forks of the test_utils forkserver, which never touched CUDA.

from torchsnapshot_tpu_torch.test_utils import run_with_procs  # noqa: E402


def _card_mesh():
    from torch.distributed.device_mesh import init_device_mesh

    torch.cuda.set_device(0)
    return init_device_mesh("cuda", (2,), mesh_dim_names=("fsdp",))


def _card_dtensor(full, mesh, placements, local=None):
    from torch.distributed.tensor import DTensor

    from torchsnapshot_tpu_torch import staging

    offsets, sizes = staging.box_at(full.shape, mesh.shape, mesh.get_coordinate(), placements)
    box = full[tuple(slice(o, o + s) for o, s in zip(offsets, sizes))]
    if local is None:
        local = box.clone()
    else:
        local.copy_(box)
    return DTensor.from_local(local, mesh, placements, run_check=False, shape=full.shape, stride=full.stride())


def _card_box(dt, full):
    from torchsnapshot_tpu_torch import staging

    offsets, sizes = staging.local_box(dt)
    return full[tuple(slice(o, o + s) for o, s in zip(offsets, sizes))]


@run_with_procs(nproc=2, gloo=True)
def _cuda_dtensor_take_restore_body():
    import os

    from torch.distributed.tensor import Replicate, Shard

    from torchsnapshot_tpu_torch.pg_wrapper import PGWrapper

    mesh = _card_mesh()
    g = torch.Generator(device="cuda").manual_seed(0)
    fulls = {
        "fsdp": torch.randn(64, 48, generator=g, device="cuda"),
        "rep": torch.randn(33, generator=g, device="cuda"),
        "bf16": torch.randn(40, 24, generator=g, device="cuda").to(torch.bfloat16),
    }
    placements = {"fsdp": [Shard(0)], "rep": [Replicate()], "bf16": [Shard(1)]}
    state = {k: _card_dtensor(v, mesh, placements[k]) for k, v in fulls.items()}
    path = os.path.join(os.path.dirname(knobs.get_store_path()), "snap")
    snapshot = Snapshot.take(path, {"m": StateDict(state)}, pg=PGWrapper.from_torch())
    dst = {k: _card_dtensor(torch.zeros_like(v), mesh, placements[k]) for k, v in fulls.items()}
    ptrs = {k: v.to_local().data_ptr() for k, v in dst.items()}
    snapshot.restore({"m": StateDict(dst)})
    torch.cuda.synchronize()
    for k, full in fulls.items():
        assert dst[k].to_local().is_cuda and dst[k].to_local().data_ptr() == ptrs[k]
        assert torch.equal(_bits(dst[k].to_local()), _bits(_card_box(dst[k], full))), k
    # read_object of a sharded entry, whole, onto the card.
    whole = snapshot.read_object("0/m/fsdp")
    assert whole.is_cuda and torch.equal(_bits(whole), _bits(fulls["fsdp"]))


@pytest.mark.cuda
def test_cuda_dtensor_take_restore_two_ranks(cuda_device):
    _cuda_dtensor_take_restore_body()


@run_with_procs(nproc=2, gloo=True)
def _cuda_noncontiguous_local_body():
    import os

    from torch.distributed.tensor import Shard

    from torchsnapshot_tpu_torch.pg_wrapper import PGWrapper

    mesh = _card_mesh()
    full = torch.randn(64, 48, generator=torch.Generator(device="cuda").manual_seed(1), device="cuda")
    path = os.path.join(os.path.dirname(knobs.get_store_path()), "snap")
    snapshot = Snapshot.take(
        path, {"m": StateDict({"w": _card_dtensor(full, mesh, [Shard(0)])})}, pg=PGWrapper.from_torch()
    )
    # FSDP2-style: the local shard is a strided view into a flat buffer.
    flat = torch.zeros(64 + 48 * 32 * 2, device="cuda")
    grid = flat[64:].view(48, 32, 2)
    local = grid[:, :, 0].t()  # (32, 48), non-contiguous
    assert not local.is_contiguous()
    target = _card_dtensor(torch.zeros_like(full), mesh, [Shard(0)], local=local)
    ptr = target.to_local().data_ptr()
    snapshot.restore({"m": StateDict({"w": target})})
    torch.cuda.synchronize()
    assert target.to_local().data_ptr() == ptr
    assert torch.equal(local, _card_box(target, full))
    # Nothing outside the view was written.
    assert torch.count_nonzero(flat[:64]) == 0 and torch.count_nonzero(grid[:, :, 1]) == 0


@pytest.mark.cuda
def test_cuda_restore_into_noncontiguous_local_view(cuda_device):
    _cuda_noncontiguous_local_body()


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["zstd", "zlib"])
def test_cuda_framed_restore_in_place(tmp_path, cuda_device, codec):
    """Compressed payloads (dense and chunked) restore into CUDA targets in
    place: each frame is decoded into a pinned buffer and uploaded; the
    H2D bytes are the payload's, not the frame's."""
    state = _state(cuda_device)
    state["z"] = torch.zeros(512, 256, device=cuda_device)  # compresses well
    with knobs.override_compression(codec), knobs.override_compression_min_bytes(0), knobs.override_max_chunk_size_bytes(
        64 << 10
    ):
        snapshot = Snapshot.take(str(tmp_path / "snap"), {"m": StateDict(state)})
    man = snapshot.get_manifest()
    assert man["0/m/w"].codec == codec
    assert man["0/m/z"].chunks[0].tensor.compressed_nbytes < (64 << 10)
    dst = {k: torch.zeros_like(v) for k, v in state.items()}
    ptrs = {k: v.data_ptr() for k, v in dst.items()}
    phase_stats.reset()
    snapshot.restore({"m": StateDict(dst)})
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in state.values())
    assert phase_stats.snapshot()["h2d_land"]["bytes"] == nbytes
    for k, v in state.items():
        assert dst[k].data_ptr() == ptrs[k]
        assert torch.equal(_bits(dst[k]), _bits(v)), k


@pytest.mark.cuda
def test_cuda_casx_restore_in_place(tmp_path, cuda_device):
    """A payload split on content-defined edges (casx://) is assembled into
    the CUDA target's pinned read buffer, one read per chunk, and restores
    in place; an unchanged second take is all prestage hits, probed
    through the card."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    state = {"w": torch.randn(1024, 512, generator=g, device=cuda_device)}
    root = tmp_path / "root"
    with knobs.override_cas(True), knobs.override_cdc(True), knobs.override_cdc_params(
        64 << 10, 256 << 10, 1 << 20
    ):
        snapshot = Snapshot.take(str(root / "step_0"), {"m": StateDict(state)})
        assert snapshot.get_manifest()["0/m/w"].location.startswith("casx://")
        phase_stats.reset()
        Snapshot.take(str(root / "step_1"), {"m": StateDict(state)})
        assert phase_stats.snapshot()["d2h"]["bytes"] == state["w"].numel() * 4  # the probe only
    for step in ("step_0", "step_1"):
        dst = {"w": torch.zeros_like(state["w"])}
        ptr = dst["w"].data_ptr()
        Snapshot(str(root / step)).restore({"m": StateDict(dst)})
        torch.cuda.synchronize()
        assert dst["w"].data_ptr() == ptr
        assert torch.equal(_bits(dst["w"]), _bits(state["w"]))


@pytest.mark.cuda
@pytest.mark.parametrize("async_", [False, True], ids=["sync_segment", "async_segment"])
def test_cuda_replayed_journal_restore_in_place(tmp_path, cuda_device, async_):
    """A journal manager saves a base and two segments of CUDA state (the
    second async in pinned_host mode when ``async_``); restore_latest and
    restore_at replay the chains through cas:// reads into the CUDA
    targets in place."""
    from torchsnapshot_tpu_torch.manager import SnapshotManager

    state = _state(cuda_device)
    want = {}
    with knobs.override_slab_size_threshold_bytes(64), knobs.override_async_staging("pinned_host"):
        mgr = SnapshotManager(str(tmp_path / "ckpts"), journal=True)
        for step in (1, 2, 3):
            state["w"].view(torch.int16).add_(step)
            want[step] = {k: v.clone() for k, v in state.items()}
            if async_ and step == 3:
                pending = mgr.save(step, {"m": StateDict(state)}, async_=True)
                assert pending.staging_mode == "pinned_host"
                pending.wait()
            else:
                mgr.save(step, {"m": StateDict(state)})
    assert mgr.restore_points() == [(1, "full"), (2, "seg"), (3, "seg")]
    dst = {k: torch.zeros_like(v) for k, v in state.items()}
    dst["nc"] = torch.zeros(64, 32, device=cuda_device).t()
    ptrs = {k: v.data_ptr() for k, v in dst.items()}
    for step, restore in ((3, mgr.restore_latest), (2, lambda a: mgr.restore_at(2, a))):
        assert restore({"m": StateDict(dst)}) == step
        torch.cuda.synchronize()
        for k, v in want[step].items():
            assert dst[k].is_cuda and dst[k].data_ptr() == ptrs[k], k
            assert torch.equal(_bits(dst[k]), _bits(v)), (step, k)
