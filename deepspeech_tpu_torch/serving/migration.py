"""Session snapshots: the portable state of one streaming session.

The port's copy of the JAX package's ``SnapshotIncompatible`` and
``StreamSnapshot`` (``serving/migration.py``). The session manager
(``serving/session.py``) makes one with ``snapshot_session`` /
``export_session`` and installs one with ``import_session``. Every
array in a snapshot is a host numpy array, so the JAX package's wire
codec (which encodes arrays through ``__array__``) can carry it; a CUDA
tensor could not be. The ``MigrationController`` that moves snapshots
between replicas comes with slice 4 of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

__all__ = ["SnapshotIncompatible", "StreamSnapshot"]


class SnapshotIncompatible(RuntimeError):
    """A snapshot cannot restore into this manager (fingerprint or
    geometry mismatch). The caller falls back to the drain path."""


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


@dataclasses.dataclass
class StreamSnapshot:
    """Portable mid-utterance state of ONE streaming session.

    ``acoustic`` holds host (numpy) copies of the slot rows:
    ``raw_hist [HIST, F]``, ``h`` tuple of per-layer ``[H]`` carries,
    ``la_buf [C-1, H]``. ``decoder`` is a beam decoder's rows (beam
    mode, slice 6 of the port) or ``None`` (greedy, which uses
    ``prev_ids`` + ``text``). ``fed``/``raw_len`` are session-relative —
    the import re-bases them onto the target manager's clock."""

    sid: str
    fingerprint: str
    fed: int
    raw_len: Optional[int]
    acoustic: Dict[str, Any]
    decoder: Optional[Any] = None
    prev_ids: Optional[int] = None
    text: Optional[str] = None

    def nbytes(self) -> int:
        """Transfer size: every array leaf, summed."""
        total = sum(int(leaf.nbytes)
                    for leaf in _leaves((self.acoustic, self.decoder))
                    if hasattr(leaf, "nbytes"))
        return total + len((self.text or "").encode())
