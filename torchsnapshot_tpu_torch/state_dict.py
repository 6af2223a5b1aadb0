"""Dict wrapper that satisfies the Stateful protocol (counterpart of
``torchsnapshot_tpu/state_dict.py``): lets plain values join app state."""

from __future__ import annotations

from collections import UserDict
from typing import Any, Dict


class StateDict(UserDict):
    def state_dict(self) -> Dict[str, Any]:
        return self.data

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        self.data = dict(state_dict)
