"""Device policy of the port's entry points: they run on the card unless
the caller asks for the CPU, and they never move to the CPU on their own.
"""

import torch


def resolve_device(device, owner: str) -> torch.device:
    """``device`` as a ``torch.device``. Raises when it names CUDA and no
    CUDA device is present: the entry points default to ``"cuda"``, and a
    run that asked for the card is not quietly moved to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"[ {owner} error ] device={str(device)!r} needs a CUDA device and "
            f"none is available; pass device='cpu' to run on the CPU."
        )
    return device
