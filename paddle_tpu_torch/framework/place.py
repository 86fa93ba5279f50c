"""Places: device identity over ``torch.device``.

``CPUPlace`` and ``CUDAPlace(device_id)`` each carry a ``.device``.  The
port runs on the card unless the caller asks for the CPU: ``default_place``
returns ``CUDAPlace(0)`` and raises when there is no CUDA device — it never
hands back a CPU place.
"""

from __future__ import annotations

import torch


class Place:
    device: torch.device

    def __eq__(self, other):
        return type(self) is type(other) and self.__dict__ == other.__dict__

    def __hash__(self):
        return hash((type(self).__name__, tuple(sorted(self.__dict__.items()))))


class CPUPlace(Place):
    @property
    def device(self) -> torch.device:
        return torch.device("cpu")

    def __repr__(self):
        return "CPUPlace()"


class CUDAPlace(Place):
    def __init__(self, device_id: int = 0):
        self.device_id = int(device_id)

    @property
    def device(self) -> torch.device:
        return torch.device("cuda", self.device_id)

    def __repr__(self):
        return f"CUDAPlace({self.device_id})"


def default_place() -> Place:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on a CUDA device by default and none is "
            "available; pass CPUPlace() explicitly to run on the CPU")
    return CUDAPlace(0)
