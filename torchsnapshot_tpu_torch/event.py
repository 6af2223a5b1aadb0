"""Telemetry event model (counterpart of ``torchsnapshot_tpu/event.py``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict


@dataclass
class Event:
    name: str
    metadata: Dict[str, Any] = field(default_factory=dict)
