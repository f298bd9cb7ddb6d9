"""Multi-process initialization on ``torch.distributed``.

The port's counterpart of the JAX package's ``parallel/distributed.py``.
JAX joins a job with ``jax.distributed.initialize()`` and then sees
every chip; here each process drives one card (or the CPU) and joins
one process group. No broadcast of the initial parameters is needed:
every rank seeds ``init_params`` the same way, as every JAX host does,
and ``Trainer`` checks once at init that the ranks agree.

``torchrun --nproc_per_node=N -m deepspeech_tpu_torch.train ...`` sets
``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and
``LOCAL_RANK``; :func:`initialize_distributed` with no arguments joins
that job and does nothing in a plain single process. ``LOCAL_RANK`` is
the index of the card this process drives.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def local_rank() -> int:
    """The index of this process's card on its host (``LOCAL_RANK``,
    0 when unset)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           device=None) -> bool:
    """Join the process group if this looks like a multi-process job.

    Returns True when a group is up. With no arguments it joins only
    when the environment says so (``WORLD_SIZE`` > 1 with
    ``MASTER_ADDR``, as torchrun sets them); ``coordinator_address``
    (an ``init_method`` URL: ``tcp://host:port`` or ``file:///path``),
    ``num_processes`` and ``process_id`` join explicitly. Safe to call
    twice.

    The backend is ``nccl`` for the card and ``gloo`` for
    ``device="cpu"``; an explicit ``backend`` is passed through. On the
    card, ``torch.cuda.set_device(LOCAL_RANK)`` runs first, before
    anything touches the card, so the kernels (launched through
    ``ctypes`` on the current device and stream) run on this rank's
    card.
    """
    if dist.is_initialized():
        return True
    explicit = coordinator_address is not None
    world = int(os.environ.get("WORLD_SIZE", "1"))
    auto = world > 1 and bool(os.environ.get("MASTER_ADDR"))
    if not (explicit or auto):
        return False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        torch.cuda.set_device(local_rank())
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    kwargs = {}
    if explicit:
        kwargs = {"init_method": coordinator_address,
                  "world_size": -1 if num_processes is None else num_processes,
                  "rank": -1 if process_id is None else process_id}
    dist.init_process_group(backend=backend, **kwargs)
    return True


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def is_primary() -> bool:
    return process_index() == 0
