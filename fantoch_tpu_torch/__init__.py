"""PyTorch/CUDA port of the batched fantoch simulation engine.

The JAX package ``fantoch_tpu`` is the reference; this package imports
none of it (and no ``jax``). Device work runs on an NVIDIA GPU through
hand-written CUDA kernels (``kernels/``), each with a plain PyTorch twin
that is used only for tensors that lie on the CPU.

Every entry point takes an explicit ``device``. The default is
``"cuda"``; without a GPU the caller must ask for ``device="cpu"`` —
nothing falls back to the CPU on its own.
"""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """The device entry points run on when the caller names none: the
    first CUDA card. Raises when no GPU is present."""
    return resolve_device(None)


def resolve_device(device) -> torch.device:
    """``None`` → the CUDA card; anything else as given. A CUDA device
    without a GPU raises instead of degrading to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the host"
        )
    return dev
