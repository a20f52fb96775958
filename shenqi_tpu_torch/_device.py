"""Device choice shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks
    for the CPU.  Asking for CUDA on a host without a card raises; the
    port never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "shenqi_tpu_torch: CUDA was asked for but no card is "
            "available; pass device='cpu' to run on the CPU")
    return dev
