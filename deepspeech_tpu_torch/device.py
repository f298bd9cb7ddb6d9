"""Device selection for the port's entry points.

The JAX package picks its backend at import (``utils/impl.py``); here a
caller names the device. ``None`` means the card: without CUDA the
entry point raises instead of carrying on on the CPU, so a run can
never report CPU numbers as the card's. The CPU runs only when asked.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda`` (raises ``RuntimeError`` without CUDA);
    ``"cpu"`` / ``"cuda[:i]"`` as given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or "
                         "'cpu'")
    return dev
