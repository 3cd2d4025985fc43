"""Device selection for the port's entry points.

Entry points take an explicit ``device`` and default to the card. Asking for
CUDA on a machine without a GPU raises: the port never carries on on the CPU
unless the caller asked for it (the CPU tests pass ``device="cpu"``).
"""

from __future__ import annotations

from typing import Union

import torch

__all__ = ("resolve_device",)


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        # "cuda" and "cuda:<current>" name one card: compare equal
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
