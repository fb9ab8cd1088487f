"""Device resolution shared by the port's entry points, and the device
fence of its traced spans."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on.

    Entry points default to ``"cuda"``.  Without a GPU that raises: the
    port never carries on quietly on the CPU unless the caller asked for
    it with ``device="cpu"`` (as the CPU tests do).
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def device_fence(device: torch.device) -> None:
    """Wait for the device's queued work (a CPU device has none): the
    engines and the train step call it after each dispatch where
    ``obs.fence`` is set."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
