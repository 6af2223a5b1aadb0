"""Rank/world/collectives facade (counterpart of
``torchsnapshot_tpu/pg_wrapper.py``), single-process path only: rank 0 of a
world of 1, where every object collective is the identity.  The
torch.distributed-backed constructor arrives with the distributed slice."""

from __future__ import annotations

from typing import Any, Callable, List, Optional


class PGWrapper:
    def get_rank(self) -> int:
        return 0

    def get_world_size(self) -> int:
        return 1

    def barrier(self) -> None:
        pass

    def gather_object_root(self, obj: Any, root: int = 0) -> Optional[List[Any]]:
        return [obj]

    def all_reduce_object(self, obj: Any, reduce_fn: Callable[[List[Any]], Any]) -> Any:
        return reduce_fn([obj])
