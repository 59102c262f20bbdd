"""Device selection shared by the port's entry points.

Every entry point takes ``device`` and defaults to ``"cuda"``. The default
never degrades to the CPU: with no CUDA device present it raises, so a
misconfigured deployment fails at construction instead of verifying
signatures on the host at a fraction of the expected rate. Callers that
want the CPU (the tests) ask for it with ``device="cpu"``."""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``device`` as a ``torch.device``; raises RuntimeError for a CUDA
    device when CUDA is unavailable and ValueError for other device types."""
    dev = torch.device(device if device is not None else DEFAULT_DEVICE)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run the plain PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r}: use cuda or cpu")
    return dev
