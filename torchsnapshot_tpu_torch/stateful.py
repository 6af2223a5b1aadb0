"""The app-state contract (counterpart of ``torchsnapshot_tpu/stateful.py``).

``AppState`` maps names to ``Stateful`` objects: anything with
``state_dict() -> dict`` and ``load_state_dict(dict)`` — ``nn.Module``,
``torch.optim.Optimizer``, or a plain dict wrapped in
:class:`torchsnapshot_tpu_torch.StateDict`.
"""

from __future__ import annotations

from typing import Any, Dict, Protocol, runtime_checkable


@runtime_checkable
class Stateful(Protocol):
    def state_dict(self) -> Dict[str, Any]:
        ...

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        ...


AppState = Dict[str, Stateful]
