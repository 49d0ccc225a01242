"""Device resolution and the memory budget of the port's entry points."""

from __future__ import annotations

import os

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the CUDA card, and raises
    where there is none. The CPU runs only when a caller names it."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain PyTorch versions on the CPU")
    return torch.device("cuda")


def memory_budget(device):
    """Free memory of ``device`` in bytes: the card's free memory, or the
    host's physical memory for the CPU."""
    if device.type == "cuda":
        return torch.cuda.mem_get_info(device)[0]
    return os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
