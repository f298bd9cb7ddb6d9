"""Data-parallel training on ``torch.distributed``: the process group,
the ``(data, model)`` mesh and its sharding rules, and the collectives
of the step. ``batch_sharding``, ``replicated`` and ``shard_batchwise``
of the JAX package's ``__all__`` have no counterpart: a rank holds its
own rows and runs every kernel on them (``mesh.py``)."""

from .distributed import (initialize_distributed, is_primary, process_count,
                          process_index)
from .mesh import (DATA_AXIS, MODEL_AXIS, PIPE_AXIS, Mesh, make_mesh,
                   param_shardings, param_spec, process_local_rows,
                   process_local_span, shard_batch)

__all__ = [
    "initialize_distributed", "is_primary", "process_count",
    "process_index", "DATA_AXIS", "MODEL_AXIS", "PIPE_AXIS", "Mesh",
    "make_mesh", "param_shardings", "param_spec", "process_local_rows",
    "process_local_span", "shard_batch",
]
