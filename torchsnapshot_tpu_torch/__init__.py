"""torchsnapshot_tpu_torch: the PyTorch/CUDA port of torchsnapshot_tpu.

Checkpoints torch state — modules, optimizers, CUDA and CPU tensors — in
the on-disk format torchsnapshot_tpu writes, so a snapshot taken by either
package restores bit-exact through the other.  This slice covers the
synchronous single-process ``Snapshot.take`` → ``Snapshot.restore`` /
``read_object`` path on local disk.
"""

from .integrity import ChecksumError
from .retry import StorageTransientError
from .rng_state import RNGState
from .serialization import DtypeUnavailableError, state_from_numpy
from .snapshot import Snapshot
from .state_dict import StateDict
from .stateful import AppState, Stateful

__all__ = [
    "Snapshot",
    "Stateful",
    "AppState",
    "StateDict",
    "RNGState",
    "ChecksumError",
    "DtypeUnavailableError",
    "StorageTransientError",
    "state_from_numpy",
]
