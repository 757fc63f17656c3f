"""The port's device policy: an entry point runs on the CUDA device
unless its caller names the CPU, and raises where there is no card."""

from __future__ import annotations

import torch


def default_device(device, who: str, arg: str = "device") -> torch.device:
    """`device` as a torch.device, where None is the card ("cuda").  A
    CUDA device raises where there is none: `who` runs on the CPU only
    for a caller who passes `arg`="cpu"."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who} runs on the CUDA device by default and "
            f"torch.cuda.is_available() is False; pass {arg}=\"cpu\" "
            "to run on the CPU")
    return device
