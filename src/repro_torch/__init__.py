"""repro_torch — the TOFEC system in PyTorch, for NVIDIA Hopper (H100).

A port of the JAX package ``repro`` that mirrors its subpackage and module
names. It imports ``torch`` and numpy, never ``jax`` and nothing of
``repro``; the numpy-only host modules it needs are carried as copies.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
Without a card, a call that did not ask for the CPU raises: nothing falls
back to the CPU silently (:func:`resolve_device`).
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` (the current card, with
    its index) unless told otherwise.

    Raises ``RuntimeError`` for a CUDA device when no card is present.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() is "
                "false; pass device='cpu' to run the plain PyTorch path"
            )
        if dev.index is None:  # name the card, so tensors' devices compare equal
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
