"""Uniform facade over inter-rank *metadata* collectives.

Counterpart of ``torchsnapshot_tpu/pg_wrapper.py``.  Checkpoint coordination
only ever moves metadata-sized pickled objects (entry dicts, write loads,
hostnames), never tensor payloads, so the object collectives run host-side
over a KV store (the native TCP store, or a FileStore) and not through
``torch.distributed``: NCCL and gloo stay with the training program, and
several ranks may share one GPU.  ``torch.distributed`` is used once, to
bootstrap the store (coordination.py).

Per-instance generation counters make every collective's key set unique so
back-to-back collectives never collide; ``barrier`` sweeps the keys of
completed generations.
"""

from __future__ import annotations

import pickle
import time
from typing import Any, Dict, List, Optional, Tuple

from . import phase_stats
from .dist_store import KVStore, wait_with_liveness


class PGWrapper:
    """Rank/world/collectives facade.

    With ``store=None`` (single process) every collective degenerates to the
    identity.  ``timeout_s`` bounds each blocking wait (None: the
    ``TPUSNAP_BARRIER_TIMEOUT_S`` knob, read at each wait).
    """

    def __init__(
        self,
        store: Optional[KVStore] = None,
        rank: int = 0,
        world_size: int = 1,
        prefix: str = "pg",
        timeout_s: Optional[float] = None,
    ) -> None:
        if store is None and world_size != 1:
            raise ValueError("world_size > 1 requires a KV store")
        self._store = store
        self._rank = rank
        self._world_size = world_size
        self._prefix = prefix
        self._timeout_s = timeout_s
        self._generation = 0
        # Key prefixes issued since the last completed barrier (not yet safe
        # to sweep) and externally retired prefixes with optional guard
        # counters (swept by rank 0 at a barrier once the guard is met).
        # See barrier() for the safety argument.
        self._staged_keys: List[str] = []
        self._retired_keys: List[tuple] = []

    # prefix -> (default torch.distributed group it was built for, wrapper)
    _from_torch_cache: Dict[str, Tuple[Any, "PGWrapper"]] = {}

    @classmethod
    def from_torch(cls, prefix: str = "pg") -> "PGWrapper":
        """Process group of the current job: rank and world size from
        ``torch.distributed`` once it is initialized (else from
        ``TPUSNAP_RANK``/``TPUSNAP_WORLD_SIZE``), a world of 1 otherwise.
        The store comes from ``TPUSNAP_STORE_ADDR``, ``TPUSNAP_STORE_PATH``
        or the torch.distributed bootstrap (dist_store.get_or_create_store).

        Cached per prefix and per default group: successive snapshots share
        one wrapper, so generations stay monotonic, and a default group that
        was destroyed and made again gets a new wrapper.  The first call is
        collective when torch.distributed is initialized."""
        from .coordination import (
            broadcast_incarnation,
            torch_distributed_initialized,
            torch_process_info,
        )
        from .dist_store import get_or_create_store

        group = None
        if torch_distributed_initialized():
            import torch.distributed.distributed_c10d as c10d

            group = c10d._get_default_group()
        cached = cls._from_torch_cache.get(prefix)
        if cached is not None and cached[0] is group:
            return cached[1]
        info = torch_process_info()
        if info is None or info[1] == 1:
            return cls()
        rank, world_size = info
        store = get_or_create_store(rank, world_size)
        key_prefix = prefix
        if group is not None:
            key_prefix = f"{prefix}/{broadcast_incarnation(rank)}"
        pg = cls(store=store, rank=rank, world_size=world_size, prefix=key_prefix)
        cls._from_torch_cache[prefix] = (group, pg)
        return pg

    def get_rank(self) -> int:
        return self._rank

    def get_world_size(self) -> int:
        return self._world_size

    def _next_key(self, op: str) -> str:
        self._generation += 1
        key = f"{self._prefix}/{op}/{self._generation}"
        self._staged_keys.append(key)
        return key

    def _get(self, key: str) -> bytes:
        """Blocking store GET with peer-liveness detection: a collective
        wait on a peer whose op lease (dist_store.OpLease) expired raises
        :class:`~torchsnapshot_tpu_torch.dist_store.StorePeerError` in
        ~grace seconds instead of parking for the full timeout.  Every
        blocked rank reads the same expired lease, so the abort is
        symmetric without an error-broadcast channel.  The wait lands in
        the ``pg_wait`` phase: the wall a rank spends in barriers and
        object collectives."""
        begin = time.monotonic()
        try:
            return wait_with_liveness(
                self._store,
                key,
                self._timeout_s,
                rank=self._rank,
                world_size=self._world_size,
            )
        finally:
            phase_stats.add("pg_wait", time.monotonic() - begin)

    def retire_prefix(
        self,
        prefix: str,
        guard_key: Optional[str] = None,
        guard_target: int = 0,
    ) -> None:
        """Mark an external key namespace (e.g. a completed async snapshot's
        LinearBarrier) for deletion at a future barrier.  Our own barrier only
        proves *main* threads advanced; when the namespace is used by
        background threads (LinearBarrier), pass a ``(guard_key,
        guard_target)`` counter that reaches the target only once every rank's
        background participant is through — the sweep skips the prefix until
        then."""
        self._retired_keys.append((prefix, guard_key, guard_target))

    def barrier(self) -> None:
        """O(1) store ops per rank: counter arrive, the last arriver sets a
        sentinel, everyone issues one blocking GET on it (CV-blocking on the
        C++ store — no polling traffic).  Raises TimeoutError after
        ``timeout_s`` if a peer never arrives, instead of hanging forever.

        Doubles as the key-sweep point: observing the sentinel for generation
        g proves every rank has arrived, hence completed every collective
        issued before g — so rank 0 deletes those generations' keys.  The
        current barrier's own keys stay until the next barrier (peers may not
        have read the sentinel yet).
        """
        if self._store is None or self._world_size == 1:
            return
        key = self._next_key("barrier")
        if self._store.add(f"{key}/arrived", 1) >= self._world_size:
            self._store.set(f"{key}/go", b"1")
        self._get(f"{key}/go")
        if self._rank == 0:
            kept = []
            for stale, guard_key, guard_target in self._retired_keys:
                if guard_key is not None and self._store.add(guard_key, 0) < guard_target:
                    kept.append((stale, guard_key, guard_target))
                    continue
                self._store.delete_prefix(f"{stale}/")
            self._retired_keys = kept
            for stale in self._staged_keys:
                if stale != key:
                    self._store.delete_prefix(f"{stale}/")
        else:
            self._retired_keys = []
        self._staged_keys = [key]

    def all_gather_object(self, obj: Any) -> List[Any]:
        """Gather one pickled object per rank, ordered by rank."""
        if self._store is None or self._world_size == 1:
            return [obj]
        key = self._next_key("allgather")
        self._store.set(f"{key}/{self._rank}", pickle.dumps(obj))
        out: List[Any] = []
        for r in range(self._world_size):
            data = self._get(f"{key}/{r}")
            out.append(pickle.loads(data))
        return out

    def gather_object_root(self, obj: Any, root: int = 0) -> Optional[List[Any]]:
        """Gather to ``root`` only: O(world) store ops vs all_gather's
        O(world²): heavyweight payloads (manifests, write loads) use this
        and one broadcast instead of an all-gather.
        Returns the rank-ordered list on root, None elsewhere."""
        if self._store is None or self._world_size == 1:
            return [obj]
        key = self._next_key("gather")
        if self._rank == root:
            out: List[Any] = []
            for r in range(self._world_size):
                if r == root:
                    out.append(obj)
                    continue
                data = self._get(f"{key}/{r}")
                out.append(pickle.loads(data))
            return out
        self._store.set(f"{key}/{self._rank}", pickle.dumps(obj))
        return None

    def all_reduce_object(self, obj: Any, reduce_fn) -> Any:
        """Gather per-rank objects to rank 0, apply ``reduce_fn`` to the
        rank-ordered list there, broadcast the reduced value to everyone.

        O(world) store ops, and the wire carries each rank's contribution
        once plus the (typically much smaller) reduced value once per rank —
        where the all_gather_object + reduce-locally pattern costs O(world²)
        GETs with every rank pulling every other rank's value.  Use for any
        collective whose consumers only need a reduction (unions,
        intersections, counts), not the full per-rank list."""
        if self._store is None or self._world_size == 1:
            return reduce_fn([obj])
        gathered = self.gather_object_root(obj)
        obj_list: List[Any] = [reduce_fn(gathered) if gathered is not None else None]
        self.broadcast_object_list(obj_list, src=0)
        return obj_list[0]

    def broadcast_object_list(self, obj_list: List[Any], src: int = 0) -> None:
        """In-place broadcast of a list of objects from ``src``."""
        if self._store is None or self._world_size == 1:
            return
        key = self._next_key("broadcast")
        if self._rank == src:
            self._store.set(f"{key}/v", pickle.dumps(obj_list))
            received = obj_list
        else:
            received = pickle.loads(
                self._get(f"{key}/v")
            )
        obj_list[:] = received

    def scatter_object_list(
        self,
        output_list: List[Any],
        input_list: Optional[List[Any]],
        src: int = 0,
    ) -> None:
        """Scatter one object per rank from ``src``: one key per rank."""
        if self._store is None or self._world_size == 1:
            assert input_list is not None
            output_list[0] = input_list[0]
            return
        key = self._next_key("scatter")
        if self._rank == src:
            assert input_list is not None and len(input_list) == self._world_size
            for r in range(self._world_size):
                if r == src:
                    continue
                self._store.set(f"{key}/{r}", pickle.dumps(input_list[r]))
            output_list[0] = input_list[src]
        else:
            output_list[0] = pickle.loads(
                self._get(f"{key}/{self._rank}")
            )

    @property
    def store(self) -> Optional[KVStore]:
        return self._store
