"""torchsnapshot_tpu_torch: the PyTorch/CUDA port of torchsnapshot_tpu.

Checkpoints torch state — modules, optimizers, CUDA and CPU tensors — in
the on-disk format torchsnapshot_tpu writes, so a snapshot taken by either
package restores bit-exact through the other: ``Snapshot.take`` /
``async_take`` / ``restore`` / ``read_object`` on one or many
torch.distributed ranks, with compression, content addressing and
incremental takes, and ``SnapshotManager`` (step-numbered saves,
retention, delta journals, last-good resume, gc) on ``fs`` and ``memory``
roots.
"""

from .integrity import ChecksumError
from .manager import SnapshotManager
from .retry import StorageTransientError
from .rng_state import RNGState
from .serialization import DtypeUnavailableError, state_from_numpy
from .snapshot import Snapshot
from .state_dict import StateDict
from .stateful import AppState, Stateful

__all__ = [
    "Snapshot",
    "SnapshotManager",
    "Stateful",
    "AppState",
    "StateDict",
    "RNGState",
    "ChecksumError",
    "DtypeUnavailableError",
    "StorageTransientError",
    "state_from_numpy",
]
