"""Device resolution for the port's entry points.

Every entry point takes `device=` and defaults to "cuda".  Asking for the
card on a machine without one raises: nothing here drops to the CPU on its
own.  The CPU is reached only by asking for it (`device="cpu"`), which is
what the tests do, and there every kernel wrapper runs its plain version.
"""
from __future__ import annotations

from typing import Union

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Union[str, torch.device, None] = None
                   ) -> torch.device:
    """The torch.device an entry point runs on: `device`, or "cuda" when
    None.  Raises RuntimeError for a CUDA device when no card is
    visible."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' to run the plain versions on "
            f"the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}: cuda or cpu")
    return dev
