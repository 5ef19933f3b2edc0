"""The connection's device: resolved once, validated, and passed down.

``connect(path, device="cuda")`` resolves the device here. Every tensor the
package makes lives on it; the Executor, the ScanCache and the kernel
wrappers receive it explicitly. There is no global device and no quiet CPU
fallback: asking for CUDA without a usable card raises.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """A validated ``torch.device``: ``cpu`` or a CUDA card that exists."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}: expected 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions"
        )
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if index >= torch.cuda.device_count():
        raise RuntimeError(
            f"device {device!r} requested but only "
            f"{torch.cuda.device_count()} CUDA device(s) are visible"
        )
    return torch.device("cuda", index)


def device_name(device: torch.device) -> str:
    """The card's name (``torch.cuda.get_device_name``), or ``cpu``."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"
