"""Device resolution for the port's entry points.

Every entry point takes ``device=None``, which means CUDA: the port exists to
run on the card, so a machine without one raises instead of quietly running
the plain PyTorch versions on the CPU. Tests and CPU users pass
``device="cpu"`` explicitly.

Resolving a device also turns TF32 off for matrix products and cuDNN, so
float32 work on the card stays float32 (the tone-mapping einsum of the
renderer is the one matrix product on the slice's path).
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda`` (raises without CUDA); anything else → as given."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch: device=None means CUDA, but no CUDA device is "
                "available (torch.cuda.is_available() is False); pass "
                "device='cpu' to run the plain PyTorch versions instead"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
