"""Device resolution: ``cuda`` by default, the CPU only when asked for."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means ``cuda`` and raises when no card is present: the port
    never carries on quietly on the CPU.  ``"cpu"`` (as the tests pass)
    runs every kernel's plain PyTorch version instead.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not "
                               "available")
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu' "
                         "('meta' builds shapes only: the dry-run)")
    return dev
