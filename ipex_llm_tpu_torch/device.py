"""Device selection shared by every entry point of the port.

Entry points run on ``cuda`` unless the caller asks for the CPU.  A CUDA
request on a machine without CUDA raises: the port never carries on on the
CPU behind the caller's back.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``cuda``; ``"cpu"`` selects the plain PyTorch versions
    of the kernels (the tests' mode)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a CUDA device was requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run the plain versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise NotImplementedError(f"device type {dev.type!r} is not supported")
    return dev
