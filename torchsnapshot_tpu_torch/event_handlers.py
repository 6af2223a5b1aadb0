"""Pluggable event handlers (counterpart of
``torchsnapshot_tpu/event_handlers.py``).  Handlers register under the
``torchsnapshot_tpu_torch.event_handlers`` entry-point group or in process;
``log_event`` fans out to every handler, and a failing handler is logged,
never raised into the snapshot operation."""

from __future__ import annotations

import logging
from importlib.metadata import entry_points
from typing import Callable, List, Optional

from .event import Event

logger = logging.getLogger(__name__)

_HANDLERS_CACHE: Optional[List[Callable[[Event], None]]] = None
_INPROCESS_HANDLERS: List[Callable[[Event], None]] = []


def _get_handlers() -> List[Callable[[Event], None]]:
    global _HANDLERS_CACHE
    if _HANDLERS_CACHE is None:
        handlers: List[Callable[[Event], None]] = []
        for ep in entry_points(group="torchsnapshot_tpu_torch.event_handlers"):
            try:
                handlers.append(ep.load())
            except Exception:  # noqa: BLE001 — a broken plugin is logged
                logger.exception("Failed to load event handler %s", ep.name)
        _HANDLERS_CACHE = handlers
    return _HANDLERS_CACHE


def reset_handlers_cache() -> None:
    """Forget the loaded entry-point handlers: the next ``log_event``
    discovers them again (handlers installed after the first event)."""
    global _HANDLERS_CACHE
    _HANDLERS_CACHE = None


def register_event_handler(handler: Callable[[Event], None]) -> None:
    _INPROCESS_HANDLERS.append(handler)


def unregister_event_handler(handler: Callable[[Event], None]) -> None:
    _INPROCESS_HANDLERS.remove(handler)


def log_event(event: Event) -> None:
    for handler in _get_handlers() + _INPROCESS_HANDLERS:
        try:
            handler(event)
        except Exception:  # noqa: BLE001 — telemetry never fails the op
            logger.exception("Event handler failed for %s", event.name)
