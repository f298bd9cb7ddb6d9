"""Live session migration: snapshot/handoff instead of drain waits.

The port's copy of the JAX package's ``serving/migration.py``
(``SnapshotIncompatible``, ``StreamSnapshot``, ``MigrationController``).
An event that moves a pinned streaming session — a breaker trip, a
brownout park, a live resize — would otherwise wait out a drain window:
the session detaches, its segment flushes through the conv/lookahead
lag on the OLD replica while a fresh segment starts on the new one, and
the final transcript is the space-join of the pieces. A handoff is an
O(state-size) transfer with no segment split and no drain wait:

- :class:`StreamSnapshot` is the portable unit: host copies of the
  session's slot rows of the streaming state (``raw_hist`` / per-layer
  ``h`` / ``la_buf``), the decoder's rows (the beam state's rows in
  beam mode, the greedy prev-id + partial text otherwise), the
  clock-relative bookkeeping (``fed``, session-relative ``raw_len``),
  and a config fingerprint so a snapshot never restores into an
  incompatible model. The session manager (``serving/session.py``)
  makes one with ``snapshot_session`` / ``export_session`` and installs
  one with ``import_session``. Every array in it is a host numpy
  array, so the JAX package's wire codec (which encodes arrays through
  ``__array__``) can carry it; a CUDA tensor could not be.
- :class:`MigrationController` performs the handoff: export from the
  source replica's manager (which frees the slot — the source is quiet
  instantly), import into a free slot on the target with ``raw_start``
  re-based against the target's clock, and the pool pin flipped. The
  re-based stream continues bit-identically; the router keeps the SAME
  segment, so ``final()`` equals the never-migrated transcript.
- Anything incompatible — version skew, snapshot wire-codec skew
  (``CODEC_VERSION``), fingerprint mismatch, a duck-typed manager
  without the export/import surface — falls back to the drain re-pin,
  counted and postmortemed but never dropped.

Observability: ``session_migrations`` / ``migration_latency`` families
(``reason`` + ``replica`` [+ ``model``] labels),
``session_migration_fallbacks``, a ``kind="migration"`` postmortem per
handoff or fallback, and ``migration.handoff`` trace spans.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

from .. import obs
from ..obs import timeline as _timeline
from ..resilience import postmortem as _postmortem

__all__ = ["CODEC_VERSION", "MigrationController", "SnapshotIncompatible",
           "StreamSnapshot"]

# The snapshot wire-codec version a replica advertises: the JAX
# package's ``serving/sessionstore.py`` value, kept here until the port
# has the codec itself (slice 4c).
CODEC_VERSION = 1


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
    ``la_buf [C-1, H]``. ``decoder`` is the slot's rows of the beam
    state in beam mode (``decode.beam.BeamState`` of host numpy arrays,
    ``[W, ...]`` each; an import whose rows do not fit the target's beam
    raises ``SnapshotIncompatible``) or ``None`` (greedy, which uses
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


class MigrationController:
    """Exports, transfers and restores live sessions across replicas.

    One controller serves a pool; the
    :class:`~.pool.PooledSessionRouter` calls :meth:`migrate` whenever
    a pinned session must move (breaker re-pin, autoscale/rollout
    victim with ``begin_drain(handoff=True)``, live resize). Returns
    True on handoff — the router keeps the same segment — or False,
    in which case the router takes the legacy detach/attach drain
    path. State is never lost: a failed import restores the snapshot
    into the source manager before reporting the fallback.
    """

    def __init__(self, *, telemetry=None, clock=time.monotonic,
                 postmortem_fn=_postmortem.record):
        self.telemetry = telemetry
        self.clock = clock
        self.postmortem_fn = postmortem_fn
        self.migrations = 0
        self.fallbacks = 0
        # Per-session handoff counts: at most one per topology
        # change.
        self.per_session: Dict[str, int] = {}
        self.events: List[dict] = []

    # -- compatibility gate ---------------------------------------------
    _SURFACE = ("export_session", "import_session", "snapshot_fingerprint")

    def _incompatibility(self, src, dst, src_mgr, dst_mgr
                         ) -> Optional[str]:
        if src_mgr is None:
            return "no_source_manager"
        for mgr in (src_mgr, dst_mgr):
            if not all(hasattr(mgr, m) for m in self._SURFACE):
                return "unsupported_manager"
        if getattr(src, "version", None) != getattr(dst, "version", None):
            return "version_mismatch"
        # Replicas advertise the snapshot wire-codec version they speak
        # (CODEC_VERSION unless overridden, e.g. a remote
        # peer running older code); skew means the bytes would not
        # decode on the other side, so take the drain path instead.
        if int(getattr(src, "codec_version", CODEC_VERSION)) != \
                int(getattr(dst, "codec_version", CODEC_VERSION)):
            return "codec_mismatch"
        if src_mgr.snapshot_fingerprint() != dst_mgr.snapshot_fingerprint():
            return "fingerprint_mismatch"
        return None

    # -- the handoff -----------------------------------------------------
    def migrate(self, pool, sid: str, src, dst, *,
                local: Optional[str] = None,
                reason: str = "repin", now: Optional[float] = None
                ) -> bool:
        """Move ``sid`` from replica ``src`` to ``dst``; True on
        handoff, False → caller must fall back to the drain re-pin.
        ``local`` is the session's name at the managers (the router's
        segment-scoped id) when it differs from the pool pin key."""
        local = sid if local is None else local
        t0 = self.clock()
        src_mgr = src.peek_session_manager()
        dst_mgr = dst.session_manager
        tel = self.telemetry if self.telemetry is not None \
            else pool.telemetry
        why = self._incompatibility(src, dst, src_mgr, dst_mgr)
        snap = None
        if why is None:
            try:
                with obs.span("migration.handoff", sid=sid,
                              src=src.rid, dst=dst.rid, reason=reason):
                    snap = src_mgr.export_session(local)
                    try:
                        dst_mgr.import_session(snap)
                    except Exception:
                        # Never strand a stream: the source fingerprint
                        # matches itself, so this restore cannot fail.
                        src_mgr.import_session(snap)
                        raise
            except SnapshotIncompatible as e:
                why = f"import_rejected: {e}"
        latency_s = self.clock() - t0
        # Causal parent on the fleet timeline: the newest event naming
        # the SOURCE replica — the breaker open / drain that forced
        # this session off it.
        cause = _timeline.last_for(src.rid)
        if why is not None:
            self.fallbacks += 1
            tel.count("session_migration_fallbacks",
                      labels={"reason": why.split(":")[0]})
            self.postmortem_fn(
                "migration", reason, outcome="fallback_drain",
                reason=why, sid=sid, src_replica=src.rid,
                dst_replica=dst.rid, latency_ms=latency_s * 1e3)
            _timeline.publish(
                "migration_fallback", "migration", replica=dst.rid,
                model=getattr(dst, "model", None), cause_seq=cause,
                sid=sid, src=src.rid, reason=why)
            self.events.append({"action": "fallback", "sid": sid,
                                "src": src.rid, "dst": dst.rid,
                                "reason": why})
            return False
        pool.pin_to(sid, dst.rid)
        self.migrations += 1
        self.per_session[sid] = self.per_session.get(sid, 0) + 1
        labels = {"replica": dst.rid, "reason": reason}
        if getattr(dst, "model", None):
            labels["model"] = dst.model
        tel.count("session_migrations", labels=labels)
        tel.observe("migration_latency", latency_s, labels=labels,
                    exemplar=f"sess:{sid}")
        self.postmortem_fn(
            "migration", reason, outcome="handoff", reason=reason,
            sid=sid, src_replica=src.rid, dst_replica=dst.rid,
            latency_ms=latency_s * 1e3,
            fed_frames=int(getattr(snap, "fed", 0) or 0),
            state_bytes=int(getattr(snap, "nbytes", lambda: 0)() or 0))
        _timeline.publish(
            "migration", "migration", replica=dst.rid,
            model=getattr(dst, "model", None), cause_seq=cause,
            sid=sid, src=src.rid, reason=reason,
            latency_ms=round(latency_s * 1e3, 3))
        self.events.append({"action": "handoff", "sid": sid,
                            "src": src.rid, "dst": dst.rid,
                            "reason": reason,
                            "latency_ms": latency_s * 1e3})
        return True

    def stats(self) -> dict:
        return {
            "migrations": self.migrations,
            "fallbacks": self.fallbacks,
            "max_per_session": max(self.per_session.values(), default=0),
        }
