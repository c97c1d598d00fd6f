"""Where the port's entry points run: on the card unless asked for the CPU."""

from __future__ import annotations

import torch


def pick_device(device, who: str) -> torch.device:
    """``device`` as a ``torch.device``, ``cuda`` when None; raises when that
    is CUDA and no card is present.  Only an explicit ``device="cpu"`` runs
    on the CPU, where the kernels' wrappers run their plain versions."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: no CUDA device is available; pass "
                           f"device='cpu' to run the plain versions")
    return device
