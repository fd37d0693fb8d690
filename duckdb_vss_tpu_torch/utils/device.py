"""Device selection: CUDA unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return ``torch.device(device)``, raising if CUDA is asked for and
    absent, or a CUDA index past the last card. There is no silent
    fallback to the CPU or to another card: only an explicit
    ``device="cpu"`` runs on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and (dev.index or 0) >= torch.cuda.device_count():
        raise ValueError(f"device {dev} requested but only "
                         f"{torch.cuda.device_count()} CUDA device(s) exist")
    return dev
