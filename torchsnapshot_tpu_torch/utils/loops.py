"""Event-loop hygiene for the sync API surface (counterpart of
``torchsnapshot_tpu/utils/loops.py``).

The pipelines run on private event loops.  A thread can drive at most one
loop, so when the calling thread already runs a loop (Jupyter cells, async
trainers) the sync entry points delegate to a short-lived helper thread and
block on it.
"""

from __future__ import annotations

import asyncio
import threading
from typing import Any, Callable


def call_outside_loop(fn: Callable[..., Any], *args: Any, **kwargs: Any) -> Any:
    """Run ``fn`` (which drives an event loop internally) in this thread, or
    on a helper thread when this thread already runs a loop."""
    try:
        asyncio.get_running_loop()
    except RuntimeError:
        return fn(*args, **kwargs)
    result: dict = {}

    def _target() -> None:
        try:
            result["value"] = fn(*args, **kwargs)
        except BaseException as e:  # noqa: BLE001 — re-raised on the caller
            result["error"] = e

    thread = threading.Thread(target=_target, name="tpusnap-torch-sync-helper")
    thread.start()
    thread.join()
    if "error" in result:
        raise result["error"]
    return result["value"]


def run_coro(coro_factory: Callable[[], Any]) -> Any:
    """asyncio.run the coroutine produced by ``coro_factory``, from any
    context (the factory is invoked on the thread that runs the loop)."""
    return call_outside_loop(lambda: asyncio.run(coro_factory()))
