"""CUDA paths of the port: D2H staging into pinned buffers and in-place
H2D restore.  Marked ``cuda``; each test skips without a CUDA device.  This
file imports neither JAX nor the JAX package, so it runs on a GPU host that
has neither:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Comparisons are exact (bitwise)."""

import pytest
import torch

from torchsnapshot_tpu_torch import ChecksumError, Snapshot, StateDict, knobs
from torchsnapshot_tpu_torch import phase_stats
from torchsnapshot_tpu_torch.manifest import ChunkedTensorEntry


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
