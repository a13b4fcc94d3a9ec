"""Device policy of the port's entry points.

``device=None`` means the card: ``torch.device("cuda")``. With no card
present that is an error, never a quiet move to the CPU. The CPU runs
only when the caller names it (``device="cpu"``), which is how the tests
hold the port against the JAX package on a host without a card.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; photon_tpu_torch runs on the "
                "card by default — pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           f"available")
    return dev
