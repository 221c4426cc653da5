"""The device an entry point runs on.

Every entry point of the port takes ``device`` and defaults to ``"cuda"``.
Without a card that raises: the port never falls back to the CPU on its
own.  A caller that wants the plain CPU path (the tests) asks for it with
``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev
