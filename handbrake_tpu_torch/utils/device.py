"""Device resolution for the port (the role of ``utils/platform.py``).

Entry points take ``device=None`` and run on the CUDA card; the CPU is
used only when the caller asks for it.  There is no silent fallback:
asking for ``cuda`` on a machine without a card raises.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """None → cuda.  Raises RuntimeError when cuda is asked for and no
    card is present.  Turns TF32 off for matmuls and convolutions: the
    port's f32 arithmetic must round like the reference's."""
    dev = torch.device("cuda" if device is None else device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on "
            "the CPU")
    return dev
