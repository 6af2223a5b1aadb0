"""Shipped test utilities: tensor-aware equality and a multi-process launch.

Counterpart of ``torchsnapshot_tpu/test_utils.py``.  :func:`run_with_procs`
re-executes a test function in N local processes coordinated through a
FileStore, optionally joined in a gloo process group so the body can build
a ``DeviceMesh`` and DTensors on the CPU.

Start method: the JAX package forks its children from the test process.
Here the children run torch, and the test process has JAX and torch loaded
with live thread pools, where a forked torch child can hang in its
intra-op pool.  Spawning a fresh interpreter per rank is safe but pays
torch's import (about 4 s with ``torch.distributed.tensor``) per rank and
per test.  So the children come from a ``forkserver``: one clean server
process per test process, started on first use, that imports torch,
``torch.distributed.tensor`` and this package once and has never run a
torch op or loaded JAX; each rank is a fork of it.
"""

from __future__ import annotations

import datetime
import functools
import importlib
import os
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from . import knobs

_FAILED_PEER_GRACE_S = 30.0
_PRELOAD = ["numpy", "torch", "torch.distributed", "torch.distributed.tensor", "torchsnapshot_tpu_torch"]


def tensor_eq(a: Any, b: Any) -> bool:
    """Same type of value, shape, dtype and bytes (DTensors by their local
    tensors and placements)."""
    from . import staging

    if staging.is_dtensor(a) or staging.is_dtensor(b):
        if not (staging.is_dtensor(a) and staging.is_dtensor(b)):
            return False
        return tuple(a.placements) == tuple(b.placements) and tensor_eq(
            a.to_local(), b.to_local()
        )
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        if not (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)):
            return False
        if a.shape != b.shape or a.dtype != b.dtype:
            return False
        a, b = a.detach().cpu().contiguous(), b.detach().cpu().contiguous()
        return bool(torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a_np, b_np = np.asarray(a), np.asarray(b)
        return a_np.shape == b_np.shape and a_np.dtype == b_np.dtype and bool(np.array_equal(a_np, b_np))
    return bool(a == b)


def _state_dict_eq(a: Any, b: Any, path: str = "") -> tuple:
    if isinstance(a, dict) and isinstance(b, dict):
        if set(a.keys()) != set(b.keys()):
            return False, f"{path}: keys differ {set(a)} vs {set(b)}"
        for k in a:
            ok, why = _state_dict_eq(a[k], b[k], f"{path}/{k}")
            if not ok:
                return ok, why
        return True, ""
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if type(a) is not type(b) or len(a) != len(b):
            return False, f"{path}: sequence type/length differs"
        for i, (x, y) in enumerate(zip(a, b)):
            ok, why = _state_dict_eq(x, y, f"{path}[{i}]")
            if not ok:
                return ok, why
        return True, ""
    if not tensor_eq(a, b):
        return False, f"{path}: {a!r} != {b!r}"
    return True, ""


def assert_state_dict_eq(a: Dict[str, Any], b: Dict[str, Any]) -> None:
    ok, why = _state_dict_eq(a, b)
    assert ok, why


def _proc_entry(
    module: str,
    qualname: str,
    rank: int,
    world_size: int,
    store_path: str,
    gloo_init: Optional[str],
    timeout_s: float,
    env: Dict[str, str],
    conn: Any,
) -> None:
    # The forkserver's environment is the one it started with: take the
    # launching test's.
    os.environ.clear()
    os.environ.update(env)
    # A store address exported for a real job must not reroute the test's
    # coordination; tests that want the TCP store set
    # TPUSNAP_TEST_KEEP_STORE_ADDR.
    if not os.environ.get("TPUSNAP_TEST_KEEP_STORE_ADDR"):
        os.environ.pop(knobs.STORE_ADDR_ENV_VAR, None)
    os.environ[knobs.STORE_PATH_ENV_VAR] = store_path
    os.environ[knobs.RANK_ENV_VAR] = str(rank)
    os.environ[knobs.WORLD_SIZE_ENV_VAR] = str(world_size)
    # A rank that never arrives must not park its peers past the test's
    # own timeout (tests of timeouts set the knob themselves).
    os.environ.setdefault(knobs.BARRIER_TIMEOUT_S_ENV_VAR, str(timeout_s))
    torch.set_num_threads(1)
    try:
        target = getattr(importlib.import_module(module), qualname.split(".")[0])
        for part in qualname.split(".")[1:]:
            target = getattr(target, part)
        fn = getattr(target, "__wrapped__", target)
        if gloo_init is not None:
            torch.distributed.init_process_group(
                "gloo",
                init_method=gloo_init,
                rank=rank,
                world_size=world_size,
                timeout=datetime.timedelta(seconds=60),
            )
        try:
            fn()
        finally:
            if gloo_init is not None and torch.distributed.is_initialized():
                torch.distributed.destroy_process_group()
        conn.send(None)
    except BaseException:  # noqa: BLE001 — reported to the parent
        conn.send(traceback.format_exc())


def make_test_pg():
    """PGWrapper of the current test process, from the env run_with_procs
    set, through the production store resolution (get_or_create_store):
    a test that sets ``TPUSNAP_STORE_ADDR`` runs the whole protocol over
    the TCP store instead of the FileStore."""
    from .dist_store import get_or_create_store
    from .pg_wrapper import PGWrapper

    rank = knobs.get_env_rank()
    world_size = knobs.get_env_world_size()
    assert rank is not None and world_size is not None, (
        "make_test_pg() requires the run_with_procs bootstrap env"
    )
    store = get_or_create_store(rank, world_size)
    return PGWrapper(store=store, rank=rank, world_size=world_size)


def _context():
    import torch.multiprocessing as tmp

    ctx = tmp.get_context("forkserver")
    ctx.set_forkserver_preload(_PRELOAD)
    return ctx


def _join(procs: list, conns: list, timeout_s: float) -> list:
    """Wait for every rank; once one has failed, the others get a grace of
    ``_FAILED_PEER_GRACE_S`` to fail or finish on their own before they are
    killed.  Returns the error reports, by rank."""
    deadline = time.monotonic() + timeout_s
    results: Dict[int, Optional[str]] = {}
    while len(results) < len(procs):
        for rank, (p, conn) in enumerate(zip(procs, conns)):
            if rank in results:
                continue
            if conn.poll():
                try:
                    results[rank] = conn.recv()
                    p.join()
                except EOFError:  # died without a report: its pipe closed
                    p.join()
                    results[rank] = f"exit code {p.exitcode}"
                if results[rank] is not None:
                    deadline = min(deadline, time.monotonic() + _FAILED_PEER_GRACE_S)
            elif not p.is_alive():
                # (a report sent just before the exit is still in the pipe)
                results[rank] = conn.recv() if conn.poll() else f"exit code {p.exitcode}"
                deadline = min(deadline, time.monotonic() + _FAILED_PEER_GRACE_S)
        if len(results) < len(procs) and time.monotonic() > deadline:
            for rank, p in enumerate(procs):
                if rank not in results:
                    p.kill()
                    p.join()
                    results[rank] = "timed out"
        time.sleep(0.01)
    return [f"rank {rank}:\n{err}" for rank, err in sorted(results.items()) if err is not None]


def run_with_procs(nproc: int, gloo: bool = False, timeout_s: float = 120.0) -> Callable:
    """Decorator: re-execute the test body in ``nproc`` local processes.
    The body calls :func:`make_test_pg` (or ``PGWrapper.from_torch()``)
    for its process group; with ``gloo=True`` each rank has also joined a
    gloo default process group.  Any rank's failure or timeout fails the
    test with every rank's traceback."""

    def decorator(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(*args: Any, **kwargs: Any) -> None:
            ctx = _context()
            with tempfile.TemporaryDirectory() as tmp:
                store_path = os.path.join(tmp, "store")
                gloo_init = f"file://{os.path.join(tmp, 'gloo')}" if gloo else None
                procs = []
                conns = []
                for rank in range(nproc):
                    parent_conn, child_conn = ctx.Pipe()
                    p = ctx.Process(
                        target=_proc_entry,
                        args=(
                            fn.__module__,
                            fn.__qualname__,
                            rank,
                            nproc,
                            store_path,
                            gloo_init,
                            timeout_s,
                            dict(os.environ),
                            child_conn,
                        ),
                    )
                    p.start()
                    procs.append(p)
                    conns.append(parent_conn)
                errors = _join(procs, conns, timeout_s)
                if errors:
                    raise AssertionError("\n".join(errors))

        return wrapper

    return decorator
