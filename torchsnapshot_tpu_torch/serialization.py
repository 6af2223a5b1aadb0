"""Zero-copy tensor <-> bytes codecs and the dtype string registry.

Counterpart of ``torchsnapshot_tpu/serialization.py``.  The registry keeps
the JAX package's dtype strings and maps them onto torch dtypes, so the two
packages read each other's manifests.  Host payloads are uint8 views
(``tensor.view(torch.uint8)``, then ``.numpy()`` or a memoryview); numpy
appears only for its native dtypes, and a numpy array carrying an extension
dtype (bfloat16, fp8, int4 from ``ml_dtypes`` on the JAX side) is recognised
by ``str(arr.dtype)`` — this module never imports ``ml_dtypes``.

``float8_e4m3b11fnuz`` is a registry dtype with no torch counterpart:
restoring it into a tensor raises :class:`DtypeUnavailableError`, and a
fresh read (``read_object`` with no target) returns its raw bytes as a
``uint8`` tensor of the entry's shape (one byte per element).
"""

from __future__ import annotations

import io
import pickle
from enum import Enum
from typing import Any, Dict, List, Optional

import numpy as np
import torch


class Serializer(Enum):
    BUFFER_PROTOCOL = "buffer_protocol"
    PICKLE = "pickle"


class DtypeUnavailableError(TypeError):
    """A registry dtype with no torch counterpart was restored into a
    tensor."""


# dtype string -> bytes per element.  int4/uint4 and the fp8 family store
# one element per byte, as ml_dtypes does.
_ITEMSIZE: Dict[str, int] = {
    "float64": 8,
    "float32": 4,
    "float16": 2,
    "bfloat16": 2,
    "float8_e4m3fn": 1,
    "float8_e5m2": 1,
    "float8_e4m3b11fnuz": 1,
    "complex64": 8,
    "complex128": 16,
    "int64": 8,
    "int32": 4,
    "int16": 2,
    "int8": 1,
    "uint8": 1,
    "uint16": 2,
    "uint32": 4,
    "uint64": 8,
    "bool": 1,
    "int4": 1,
    "uint4": 1,
}

# dtype string -> torch dtype (None: no torch counterpart in this build).
_STRING_TO_TORCH: Dict[str, Optional[torch.dtype]] = {
    name: getattr(torch, name, None) for name in _ITEMSIZE
}
_TORCH_TO_STRING: Dict[torch.dtype, str] = {
    dt: name for name, dt in _STRING_TO_TORCH.items() if dt is not None
}
# Registry dtypes numpy holds natively (the rest are ml_dtypes extensions).
_NUMPY_NATIVE = frozenset(
    name for name in _ITEMSIZE if name not in (
        "bfloat16", "float8_e4m3fn", "float8_e5m2", "float8_e4m3b11fnuz",
        "int4", "uint4",
    )
)


def dtype_to_string(dtype: Any) -> str:
    """Registry string of a torch or numpy dtype; raises ValueError for a
    dtype outside the registry."""
    if isinstance(dtype, torch.dtype):
        name = _TORCH_TO_STRING.get(dtype)
    else:
        name = str(np.dtype(dtype))
        name = name if name in _ITEMSIZE else None
    if name is None:
        raise ValueError(f"Unsupported dtype: {dtype}")
    return name


def is_supported_dtype(dtype: Any) -> bool:
    try:
        dtype_to_string(dtype)
        return True
    except (TypeError, ValueError):
        return False


def string_to_torch_dtype(s: str) -> torch.dtype:
    """The torch dtype of a registry string; raises DtypeUnavailableError
    for ``float8_e4m3b11fnuz`` and ValueError for an unknown string."""
    if s not in _ITEMSIZE:
        raise ValueError(f"Unknown dtype string: {s}")
    dt = _STRING_TO_TORCH[s]
    if dt is None:
        raise DtypeUnavailableError(
            f"dtype {s!r} has no torch counterpart; read_object() without a "
            "target returns its raw bytes as a uint8 tensor"
        )
    return dt


def host_dtype(s: str) -> torch.dtype:
    """The dtype a fresh host tensor for entry dtype ``s`` takes: the torch
    counterpart, or uint8 (raw bytes) where there is none."""
    if s not in _ITEMSIZE:
        raise ValueError(f"Unknown dtype string: {s}")
    return _STRING_TO_TORCH[s] or torch.uint8


def per_element_nbytes(dtype_str: str) -> int:
    try:
        return _ITEMSIZE[dtype_str]
    except KeyError:
        raise ValueError(f"Unknown dtype string: {dtype_str}") from None


def array_nbytes(shape: List[int], dtype_str: str) -> int:
    n = 1
    for dim in shape:
        n *= dim
    return n * per_element_nbytes(dtype_str)


def tensor_u8(t: torch.Tensor) -> torch.Tensor:
    """Flat uint8 view of a contiguous tensor's bytes (no copy; any device;
    0-d and zero-size tensors included)."""
    return t.detach().reshape(-1).view(torch.uint8)


def host_bytes(obj: Any) -> np.ndarray:
    """Flat uint8 numpy view of a CPU tensor's or numpy array's bytes.
    Zero-copy when the value is contiguous; otherwise one contiguous copy."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach().resolve_conj().resolve_neg().contiguous()
        return tensor_u8(t).numpy()
    arr = np.ascontiguousarray(obj)
    return arr.reshape(-1).view(np.uint8)


def array_as_memoryview(u8: np.ndarray) -> memoryview:
    """Byte memoryview of a flat uint8 host array (empty payloads included)."""
    if u8.size == 0:
        return memoryview(b"")
    return memoryview(u8).cast("B")


def tensor_from_numpy(arr: np.ndarray) -> torch.Tensor:
    """numpy → torch CPU tensor with identical bytes.  Extension dtypes
    (bfloat16, fp8, int4 from ml_dtypes) cross through a uint8 view,
    recognised by their dtype string."""
    name = dtype_to_string(arr.dtype)
    # (np.ascontiguousarray would turn a 0-d array into a 1-d one.)
    arr = np.require(arr, requirements="C")
    if name in _NUMPY_NATIVE:
        return torch.from_numpy(arr.copy())
    dtype = string_to_torch_dtype(name)
    if arr.size == 0:
        return torch.empty(arr.shape, dtype=dtype)
    u8 = torch.from_numpy(arr.reshape(-1).view(np.uint8).copy())
    return u8.view(dtype).reshape(arr.shape)


def state_from_numpy(tree: Any) -> Any:
    """Map every numpy array in a nested dict/list/tuple to a torch CPU
    tensor with identical bytes (:func:`tensor_from_numpy`); other leaves
    pass through."""
    if isinstance(tree, np.ndarray):
        return tensor_from_numpy(tree)
    if isinstance(tree, dict):
        return type(tree)((k, state_from_numpy(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(state_from_numpy(v) for v in tree)
    return tree


def pickle_save_as_bytes(obj: Any) -> bytes:
    buf = io.BytesIO()
    pickle.dump(obj, buf, protocol=pickle.HIGHEST_PROTOCOL)
    return buf.getvalue()


def pickle_load_from_bytes(data: bytes) -> Any:
    return pickle.loads(data)


class PrePickled:
    """An object whose pickle bytes were captured eagerly: device-staged
    async takes pickle on the caller's thread, so the background pipeline
    never races the caller's mutations (device_staging.py)."""

    __slots__ = ("data", "obj_type")

    def __init__(self, obj: Any) -> None:
        self.data = pickle_save_as_bytes(obj)
        self.obj_type = type(obj).__name__
