"""The port's dtype registry against the JAX package's: the same strings,
the same itemsizes and the same bytes, dtype by dtype.  Every comparison
here is exact."""

import ml_dtypes
import numpy as np
import pytest
import torch

from torchsnapshot_tpu import serialization as jax_ser
from torchsnapshot_tpu_torch import serialization as ser
from torchsnapshot_tpu_torch.serialization import DtypeUnavailableError

from torch_env import default_knob_env  # noqa: F401  autouse fixture

ALL_DTYPES = sorted(jax_ser._STRING_TO_DTYPE)
SHARED_DTYPES = [s for s in ALL_DTYPES if s != "float8_e4m3b11fnuz"]


def _sample(dtype_str: str, n: int = 37) -> np.ndarray:
    """Deterministic bytes of ``n`` elements, reinterpreted as the dtype."""
    np_dtype = jax_ser.string_to_dtype(dtype_str)
    raw = np.random.RandomState(7).randint(0, 256, size=n * np_dtype.itemsize)
    arr = raw.astype(np.uint8).view(np_dtype)
    if dtype_str == "bool":
        arr = raw.astype(np.uint8)[:n].astype(bool)
    if dtype_str in ("int4", "uint4"):
        lo, hi = (-8, 8) if dtype_str == "int4" else (0, 16)
        arr = np.random.RandomState(7).randint(lo, hi, size=n).astype(np_dtype)
    return arr


def test_registry_strings_match():
    assert sorted(ser._ITEMSIZE) == ALL_DTYPES


@pytest.mark.parametrize("dtype_str", ALL_DTYPES)
def test_itemsize_matches_jax_registry(dtype_str):
    assert ser.per_element_nbytes(dtype_str) == jax_ser.per_element_nbytes(dtype_str)
    assert ser.array_nbytes([3, 5], dtype_str) == jax_ser.array_nbytes([3, 5], dtype_str)


@pytest.mark.parametrize("dtype_str", SHARED_DTYPES)
def test_same_bytes_as_jax_registry(dtype_str):
    arr = _sample(dtype_str)
    t = ser.tensor_from_numpy(arr)
    assert ser.dtype_to_string(t.dtype) == dtype_str
    assert ser.dtype_to_string(arr.dtype) == dtype_str
    jax_bytes = bytes(jax_ser.array_as_memoryview(arr))
    assert bytes(ser.array_as_memoryview(ser.host_bytes(t))) == jax_bytes
    # numpy extension arrays are recognised by their dtype string alone
    assert bytes(ser.array_as_memoryview(ser.host_bytes(arr))) == jax_bytes


@pytest.mark.parametrize("dtype_str", SHARED_DTYPES)
def test_zero_dim_and_empty_tensors(dtype_str):
    arr = _sample(dtype_str, n=1).reshape(())
    t = ser.tensor_from_numpy(arr)
    assert t.shape == ()
    assert bytes(ser.array_as_memoryview(ser.host_bytes(t))) == bytes(
        jax_ser.array_as_memoryview(arr)
    )
    empty = ser.tensor_from_numpy(_sample(dtype_str, n=0).reshape(0, 3))
    assert bytes(ser.array_as_memoryview(ser.host_bytes(empty))) == b""


def test_float8_e4m3b11fnuz_has_no_torch_dtype():
    """The decision for the one registry dtype torch lacks: restoring it
    into a tensor raises a named error; a fresh read is raw uint8."""
    with pytest.raises(DtypeUnavailableError, match="float8_e4m3b11fnuz"):
        ser.string_to_torch_dtype("float8_e4m3b11fnuz")
    assert ser.host_dtype("float8_e4m3b11fnuz") == torch.uint8
    with pytest.raises(DtypeUnavailableError):
        ser.tensor_from_numpy(np.zeros(2, ml_dtypes.float8_e4m3b11fnuz))
    with pytest.raises(ValueError, match="Unknown dtype string"):
        ser.string_to_torch_dtype("no_such_dtype")


def test_unsupported_torch_dtype_is_not_in_registry():
    assert not ser.is_supported_dtype(torch.complex32)
    with pytest.raises(ValueError):
        ser.dtype_to_string(torch.complex32)


def test_non_contiguous_host_bytes():
    t = torch.arange(12, dtype=torch.int32).reshape(3, 4).t()
    assert not t.is_contiguous()
    np.testing.assert_array_equal(
        ser.host_bytes(t).view(np.int32), t.contiguous().numpy().reshape(-1)
    )


def test_state_from_numpy_maps_nested_arrays():
    tree = {"a": np.arange(3, dtype=np.float32), "b": [np.ones(2, ml_dtypes.bfloat16), 4], "c": (1.5,)}
    out = ser.state_from_numpy(tree)
    assert out["a"].dtype == torch.float32 and out["b"][0].dtype == torch.bfloat16
    assert out["b"][1] == 4 and out["c"] == (1.5,)
