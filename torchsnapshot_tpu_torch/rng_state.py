"""RNG-state capture for deterministic resume (counterpart of
``torchsnapshot_tpu/rng_state.py``).

``RNGState`` holds Python's and numpy's global RNG state, torch's CPU
generator state (``torch.get_rng_state()``) and, where CUDA is present,
every CUDA generator's (``torch.cuda.get_rng_state_all()``).
``Snapshot.take`` saves it last and ``restore`` loads it last, so nothing
else perturbs it.

A snapshot taken by torchsnapshot_tpu may carry a JAX key as
``jax_key_data``; it comes back as its raw numpy array, on
:attr:`RNGState.jax_key_data`.
"""

from __future__ import annotations

import random
from typing import Any, Dict, Optional

import numpy as np
import torch


class RNGState:
    """Stateful capturing the python/numpy/torch global RNG states."""

    def __init__(self) -> None:
        self.jax_key_data: Optional[np.ndarray] = None

    def state_dict(self) -> Dict[str, Any]:
        state: Dict[str, Any] = {
            "python": random.getstate(),
            "numpy": np.random.get_state(),
            "torch": torch.get_rng_state(),
        }
        if torch.cuda.is_available():
            state["cuda"] = torch.cuda.get_rng_state_all()
        return state

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        # Containers may come back as lists; random.setstate needs the
        # exact nested tuple shape.
        random.setstate(_tuplify(state_dict["python"]))
        np_state = state_dict["numpy"]
        if isinstance(np_state, (list, tuple)):
            np_state = tuple(
                np.asarray(x) if isinstance(x, np.ndarray) else x for x in np_state
            )
        np.random.set_state(np_state)
        if "torch" in state_dict:
            torch.set_rng_state(_cpu_u8(state_dict["torch"]))
        if "cuda" in state_dict:
            torch.cuda.set_rng_state_all([_cpu_u8(s) for s in state_dict["cuda"]])
        if "jax_key_data" in state_dict:
            self.jax_key_data = np.asarray(state_dict["jax_key_data"])


def _cpu_u8(state: Any) -> torch.Tensor:
    """Generator states are CPU uint8 tensors; restored ones may arrive as
    tensors elsewhere or as numpy arrays (a snapshot read by another
    package's restore path)."""
    if isinstance(state, np.ndarray):
        state = torch.from_numpy(state)
    return state.to(device="cpu", dtype=torch.uint8)


def _tuplify(obj: Any) -> Any:
    if isinstance(obj, (list, tuple)):
        return tuple(_tuplify(x) for x in obj)
    return obj
