"""Device selection for the port's entry points.

The JAX package picks its backend at import (``utils/impl.py``); here a
caller names the device. ``None`` means the card: without CUDA the
entry point raises instead of carrying on on the CPU, so a run can
never report CPU numbers as the card's. The CPU runs only when asked.

Inside a process group (``parallel/distributed.py``) ``None`` and a
bare ``"cuda"`` mean this rank's card, ``cuda:{LOCAL_RANK}``: the
kernels launch through ``ctypes`` on the current device and stream, and
``torch.device("cuda")`` is whatever device is current, so a rank that
named no index would run on card 0.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda`` (raises ``RuntimeError`` without CUDA),
    ``cuda:{LOCAL_RANK}`` inside a process group; ``"cpu"`` /
    ``"cuda[:i]"`` as given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        if dev.index is None and torch.distributed.is_available() \
                and torch.distributed.is_initialized():
            from .parallel.distributed import local_rank

            dev = torch.device("cuda", local_rank())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or "
                         "'cpu'")
    return dev
