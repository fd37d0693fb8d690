"""Device selection: CUDA unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return ``torch.device(device)``, raising if CUDA is asked for and
    absent. There is no silent CPU fallback: only an explicit
    ``device="cpu"`` runs on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
