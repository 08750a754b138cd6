"""Device resolution: the port runs on CUDA unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """Return the device to run on; ``None`` means ``cuda``.

    Raises when a CUDA device is asked for and none is available: nothing
    falls back to the CPU unless ``device="cpu"`` was passed.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "cse_tpu_torch: CUDA was asked for (the default) but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"cse_tpu_torch runs on 'cuda' or 'cpu', not {dev}")
    return dev
