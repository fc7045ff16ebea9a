"""Device resolution for the port (the role of ``utils/platform.py``).

Entry points take ``device=None`` and run on the CUDA card; the CPU is
used only when the caller asks for it.  There is no silent fallback:
asking for ``cuda`` on a machine without a card raises, and so does
asking for a card index the machine does not have.

A process that ``torchrun`` started (``LOCAL_RANK`` in its environment)
takes its card from its local rank: ``cuda:LOCAL_RANK`` when the host has
a card for every local rank, else the ranks share the cards in order
(``LOCAL_WORLD_SIZE`` ranks over the cards there are; ``parallel/mesh.py``
then talks over gloo).
"""
from __future__ import annotations

import os

import torch


def ranks_per_card() -> int:
    """How many of this host's ranks share one card (1 outside torchrun,
    or when every local rank has a card of its own)."""
    lws = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
    n = torch.cuda.device_count()
    return 1 if n == 0 or lws <= n else -(-lws // n)


def resolve_device(device=None) -> torch.device:
    """None → cuda.  Raises RuntimeError when cuda is asked for and no
    card is present, or a card index beyond the cards there are.  Under
    torchrun a bare ``cuda`` is the rank's card, made current.  Turns
    TF32 off for matmuls and convolutions: the port's f32 arithmetic must
    round like the reference's."""
    dev = torch.device("cuda" if device is None else device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on "
            "the CPU")
    n = torch.cuda.device_count()
    if dev.index is None and "LOCAL_RANK" in os.environ:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"])
                           // ranks_per_card())
        torch.cuda.set_device(dev)
    if dev.index is not None and dev.index >= n:
        raise RuntimeError(f"{dev} asked for, but this machine has {n} "
                           f"CUDA device(s)")
    return dev
