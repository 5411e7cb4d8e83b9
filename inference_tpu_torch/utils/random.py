"""Generator discipline for the samplers.

All randomness flows through an explicit ``torch.Generator`` that lives on
the device the chains run on. A fresh entropy-derived seed is used when
none is supplied, and any Python integer seed is folded into 32 bits, as
``inference_tpu.utils.random.make_key`` does. The two packages give
different random streams from the same seed by design.
"""

import os

import torch


def make_generator(seed=None, device="cpu") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed % 2**32``, or
    with 32 bits of OS entropy when ``seed`` is None."""
    if seed is None:
        seed = int.from_bytes(os.urandom(4), "little")
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(int(seed) % (2**32))
    return gen
