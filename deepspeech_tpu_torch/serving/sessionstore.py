"""Crash-durable sessions: the snapshot wire codec and the write-ahead
session journal.

The port's copy of the JAX package's ``serving/sessionstore.py``. A live
streaming session is state the process cannot re-derive: the recurrent
rows of the streaming state, the carried beam rows, session-relative
clocks. ``serving/migration.py`` moves that state between replicas inside
one process; this module makes it survive the process:

- **Layer 1, the wire codec.** :func:`snapshot_to_bytes` /
  :func:`snapshot_from_bytes` encode a
  :class:`~.migration.StreamSnapshot` as one self-describing byte string:
  magic + ``CODEC_VERSION`` + a JSON structure header (the acoustic dict
  and the decoder pytree, numpy leaves replaced by blob references;
  namedtuple nodes carry ``module:qualname``) + raw array blobs + a
  CRC32 over everything after the magic. The version is checked before
  the CRC, and a skew raises :class:`~.migration.SnapshotIncompatible`.
  The bytes are the JAX codec's byte for byte: only a beam snapshot's
  ``module:qualname`` names the port's class.
- **Layer 2, the write-ahead journal.** :class:`SessionJournal` is an
  append-only, segment-rotated log of ``(sid, seq, snapshot_bytes)``
  records, each length-prefixed and CRC-framed, so a torn tail (a crash
  mid-write) truncates cleanly at scan time; a fresh segment opens per
  process. The :class:`~.session.StreamingSessionManager` feeds it every
  ``journal_every`` chunks, at ``leave`` and at ``import_session``, and
  writes a tombstone at finalize. :meth:`SessionJournal.compact` keeps
  only the newest live record per sid. The ``journal.append`` fault
  point with ``partial_write`` tears the in-flight frame as a crash
  would (and rotates the segment, as the restart would).
- **Recovery.** :class:`RecoveryController` replays a journal at boot:
  it keeps the newest valid record per live sid and re-imports it
  through ``import_session`` / ``PooledSessionRouter.adopt`` (the
  ``raw_start = clock - fed`` re-basing of live migration, so the
  continuation is bit-identical). Outcomes count as
  ``sessions_recovered{outcome=ok|torn|incompatible|stale}`` with a
  ``recovery_latency`` observation, ``kind="recovery"`` timeline events
  and one ``kind="crash_recovery"`` postmortem.

**The decoder's classes are an allow-list.** A namedtuple node names its
class as ``module:qualname``, and those bytes come from disk or from a
socket. The JAX codec imports whatever module the frame names; the port
resolves the name only among its own snapshot types
(:data:`SNAPSHOT_TYPES`) and treats any other name, a JAX-written
``deepspeech_tpu.decode.beam:BeamState`` among them, as a class it
cannot build: :class:`~.migration.SnapshotIncompatible`, with no import.

Stdlib and numpy at import time; the package modules load lazily.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
import time
import zlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "CODEC_VERSION", "JournalEntry", "JournalScan",
    "RecoveryController", "SNAPSHOT_TYPES", "SessionJournal",
    "SnapshotDecodeError", "peek_codec_version", "scan_segment_bytes",
    "snapshot_from_bytes", "snapshot_to_bytes",
]

# Bump when the byte layout below changes shape (the header is exact, so
# any layout change bumps). The migration gate refuses to move snapshots
# between replicas whose advertised codec_version differs. Equal to the
# JAX codec's: the two packages read each other's greedy frames.
CODEC_VERSION = 1

# The namedtuple classes a frame may name, ``module:qualname`` -> the
# port module and attribute that hold it. Nothing else is resolved.
SNAPSHOT_TYPES = {
    "deepspeech_tpu_torch.decode.beam:BeamState":
        ("..decode.beam", "BeamState"),
}

_S_MAGIC = b"DS2S"           # snapshot codec frames
_J_MAGIC = b"DS2J"           # journal segment files
_J_VERSION = 1
_REC_SNAPSHOT = 1
_REC_TOMBSTONE = 2

RECOVERY_OUTCOMES = ("ok", "torn", "incompatible", "stale")


class SnapshotDecodeError(ValueError):
    """The byte string is not a readable snapshot frame (bad magic,
    CRC mismatch, malformed header). Distinct from
    :class:`~.migration.SnapshotIncompatible`, which means the frame
    is readable but must not restore here (codec version skew)."""


# -- lazy package seams ---------------------------------------------------
# Lazy so that scanning a journal never drags the serving package in.

def _migration():
    from . import migration
    return migration


def _inject(point: str, **ctx):
    from ..resilience import faults
    return faults.inject(point, **ctx)


def _notify(event: str, **info) -> None:
    from ..resilience import faults
    faults.notify(event, **info)


def _publish(kind: str, **kw) -> Optional[int]:
    from ..obs import timeline
    return timeline.publish(kind, "recovery", **kw)


def _postmortem_record(kind: str, trigger: str = "", **kw) -> None:
    from ..resilience import postmortem
    postmortem.record(kind, trigger, **kw)


def _snapshot_type(name: str):
    """The allow-listed class a frame's ``module:qualname`` names, or
    :class:`~.migration.SnapshotIncompatible` without importing it."""
    where = SNAPSHOT_TYPES.get(name)
    if where is None:
        raise _migration().SnapshotIncompatible(
            f"decoder type {name!r} not reconstructable: not one of the "
            f"port's snapshot types {sorted(SNAPSHOT_TYPES)}")
    import importlib
    module = importlib.import_module(where[0], __package__)
    return getattr(module, where[1])


# -- layer 1: the wire codec ---------------------------------------------

def _enc(obj, arrays: List[np.ndarray]):
    """Structure-preserving JSON encoding of a snapshot pytree; array
    leaves land in ``arrays`` and encode as blob references."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return {"lit": obj}
    if isinstance(obj, np.integer):
        return {"lit": int(obj)}
    if isinstance(obj, np.floating):
        return {"lit": float(obj)}
    if not isinstance(obj, np.ndarray) and hasattr(obj, "__array__") \
            and not isinstance(obj, (list, tuple, dict)):
        obj = np.asarray(obj)    # device arrays ride as host copies
    if isinstance(obj, np.ndarray):
        if obj.dtype.hasobject:
            raise ValueError("object-dtype arrays are not wire-safe")
        arrays.append(np.ascontiguousarray(obj))
        return {"nd": len(arrays) - 1}
    if isinstance(obj, dict):
        return {"map": [[str(k), _enc(v, arrays)]
                        for k, v in obj.items()]}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        cls = type(obj)
        return {"ntup": f"{cls.__module__}:{cls.__qualname__}",
                "vals": [_enc(v, arrays) for v in obj]}
    if isinstance(obj, tuple):
        return {"tup": [_enc(v, arrays) for v in obj]}
    if isinstance(obj, list):
        return {"list": [_enc(v, arrays) for v in obj]}
    raise ValueError(
        f"snapshot leaf {type(obj).__name__} is not codec-encodable")


def _dec(node, arrays: List[np.ndarray]):
    if not isinstance(node, dict) or len(node) == 0:
        raise SnapshotDecodeError(f"malformed structure node {node!r}")
    if "lit" in node:
        return node["lit"]
    if "nd" in node:
        try:
            return arrays[int(node["nd"])]
        except (IndexError, ValueError, TypeError):
            raise SnapshotDecodeError("dangling array reference")
    if "map" in node:
        return {k: _dec(v, arrays) for k, v in node["map"]}
    if "tup" in node:
        return tuple(_dec(v, arrays) for v in node["tup"])
    if "list" in node:
        return [_dec(v, arrays) for v in node["list"]]
    if "ntup" in node:
        target = _snapshot_type(str(node["ntup"]))
        try:
            return target(*[_dec(v, arrays) for v in node["vals"]])
        except TypeError as e:
            # The class exists here with other fields: a codec peer
            # running different code, the compat gate's problem.
            raise _migration().SnapshotIncompatible(
                f"decoder type {node['ntup']!r} not reconstructable: "
                f"{e}")
    raise SnapshotDecodeError(f"unknown structure node {node!r}")


def snapshot_to_bytes(snap) -> bytes:
    """Versioned, CRC-checksummed wire encoding of a
    :class:`~.migration.StreamSnapshot`; see the module docstring."""
    arrays: List[np.ndarray] = []
    header = {
        "sid": str(snap.sid),
        "fingerprint": str(snap.fingerprint),
        "fed": int(snap.fed),
        "raw_len": None if snap.raw_len is None else int(snap.raw_len),
        "prev_ids": (None if snap.prev_ids is None
                     else int(snap.prev_ids)),
        "text": snap.text,
        "acoustic": _enc(snap.acoustic, arrays),
        "decoder": (None if snap.decoder is None
                    else _enc(snap.decoder, arrays)),
    }
    header["arrays"] = [[a.dtype.str, list(a.shape)] for a in arrays]
    hj = json.dumps(header, ensure_ascii=False).encode("utf-8")
    body = (struct.pack("<H", CODEC_VERSION)
            + struct.pack("<I", len(hj)) + hj
            + b"".join(a.tobytes() for a in arrays))
    return _S_MAGIC + body + struct.pack("<I", zlib.crc32(body))


def peek_codec_version(data: bytes) -> Optional[int]:
    """The frame's codec version without decoding it (None when the
    bytes are not even a snapshot frame)."""
    if len(data) < 6 or data[:4] != _S_MAGIC:
        return None
    return struct.unpack_from("<H", data, 4)[0]


def snapshot_from_bytes(data: bytes):
    """Decode :func:`snapshot_to_bytes` output back into a
    :class:`~.migration.StreamSnapshot`.

    Raises :class:`~.migration.SnapshotIncompatible` on codec version
    skew (checked BEFORE the CRC: a different version may frame
    differently past the version field) and
    :class:`SnapshotDecodeError` on any framing damage."""
    if len(data) < 14 or data[:4] != _S_MAGIC:
        raise SnapshotDecodeError("not a snapshot frame (bad magic)")
    version = struct.unpack_from("<H", data, 4)[0]
    if version != CODEC_VERSION:
        raise _migration().SnapshotIncompatible(
            f"snapshot codec version {version} != {CODEC_VERSION}")
    body, crc = data[4:-4], struct.unpack("<I", data[-4:])[0]
    if zlib.crc32(body) != crc:
        raise SnapshotDecodeError("snapshot CRC mismatch")
    hlen = struct.unpack_from("<I", data, 6)[0]
    if 10 + hlen + 4 > len(data):
        raise SnapshotDecodeError("snapshot header overruns frame")
    try:
        header = json.loads(data[10:10 + hlen].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise SnapshotDecodeError(f"snapshot header unreadable: {e}")
    arrays: List[np.ndarray] = []
    off = 10 + hlen
    for dtype_str, shape in header.get("arrays", []):
        dt = np.dtype(dtype_str)
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        end = off + n * dt.itemsize
        if end > len(data) - 4:
            raise SnapshotDecodeError("array blobs overrun frame")
        arrays.append(np.frombuffer(data[off:end], dtype=dt)
                      .reshape(shape).copy())
        off = end
    if off != len(data) - 4:
        raise SnapshotDecodeError("trailing bytes after array blobs")
    mig = _migration()
    return mig.StreamSnapshot(
        sid=header["sid"], fingerprint=header["fingerprint"],
        fed=int(header["fed"]),
        raw_len=(None if header["raw_len"] is None
                 else int(header["raw_len"])),
        acoustic=_dec(header["acoustic"], arrays),
        decoder=(None if header["decoder"] is None
                 else _dec(header["decoder"], arrays)),
        prev_ids=(None if header["prev_ids"] is None
                  else int(header["prev_ids"])),
        text=header["text"])


# -- layer 2: the write-ahead journal -------------------------------------

@dataclasses.dataclass
class JournalEntry:
    """One decoded journal record (payload bytes still encoded)."""

    segment: str
    offset: int
    sid: str
    seq: int
    kind: str                 # "snapshot" | "tombstone"
    nbytes: int               # whole frame, prefix + crc included
    data: bytes               # snapshot payload (b"" for tombstones)


@dataclasses.dataclass
class JournalScan:
    """Everything a scan learned: the raw entries, per-segment torn
    tails, and the derived live set (newest snapshot per sid whose
    newest record is not a tombstone)."""

    entries: List[JournalEntry]
    torn: List[Tuple[str, int]]           # (segment, byte offset)
    segment_bytes: Dict[str, int]
    live: Dict[str, JournalEntry]
    stale: int                            # superseded snapshot records
    tombstoned: List[str]


def scan_segment_bytes(data: bytes, segment: str = "<mem>"
                       ) -> Tuple[List[JournalEntry], Optional[int]]:
    """Parse one segment's bytes; returns (entries, torn_offset).

    NEVER raises on damaged input — any malformed region truncates the
    scan at its offset (torn-tail semantics). Empty bytes are a clean
    empty segment."""
    entries: List[JournalEntry] = []
    n = len(data)
    if n == 0:
        return entries, None
    if n < 6 or data[:4] != _J_MAGIC \
            or struct.unpack_from("<H", data, 4)[0] != _J_VERSION:
        return entries, 0
    pos = 6
    while pos + 8 <= n:
        body_len, crc = struct.unpack_from("<II", data, pos)
        if pos + 8 + body_len > n:
            return entries, pos
        body = data[pos + 8:pos + 8 + body_len]
        if zlib.crc32(body) != crc or body_len < 13:
            return entries, pos
        rtype, seq, sid_len = struct.unpack_from("<BQI", body, 0)
        if rtype not in (_REC_SNAPSHOT, _REC_TOMBSTONE) \
                or 13 + sid_len > body_len:
            return entries, pos
        try:
            sid = body[13:13 + sid_len].decode("utf-8")
        except UnicodeDecodeError:
            return entries, pos
        entries.append(JournalEntry(
            segment=segment, offset=pos, sid=sid, seq=seq,
            kind=("snapshot" if rtype == _REC_SNAPSHOT
                  else "tombstone"),
            nbytes=8 + body_len, data=bytes(body[13 + sid_len:])))
        pos += 8 + body_len
    return entries, (pos if pos < n else None)


def _derive(entries: List[JournalEntry]
            ) -> Tuple[Dict[str, JournalEntry], int, List[str]]:
    newest: Dict[str, JournalEntry] = {}
    snapshots_per_sid: Dict[str, int] = {}
    for e in entries:
        if e.kind == "snapshot":
            snapshots_per_sid[e.sid] = snapshots_per_sid.get(e.sid,
                                                             0) + 1
        cur = newest.get(e.sid)
        if cur is None or e.seq >= cur.seq:
            newest[e.sid] = e
    live = {sid: e for sid, e in newest.items()
            if e.kind == "snapshot"}
    tombstoned = sorted(sid for sid, e in newest.items()
                        if e.kind == "tombstone")
    stale = sum(n - (1 if sid in live else 0)
                for sid, n in snapshots_per_sid.items())
    return live, stale, tombstoned


class SessionJournal:
    """Append-only, segment-rotated write-ahead log of session
    snapshots; see the module docstring.

    ``path`` is a directory of ``wal-NNNNNNNN.seg`` files; every
    process opens a FRESH segment on first append (a predecessor's
    torn tail is never appended after — it stays where the crash left
    it, for the scanner to truncate). ``fsync=True`` trades append
    latency for hard durability; the default rides the OS page cache,
    which survives process death (the failure this plane is for) if
    not power loss."""

    def __init__(self, path: str, *, segment_bytes: int = 4 << 20,
                 fsync: bool = False, telemetry=None,
                 replica: Optional[str] = None):
        self.path = path
        self.segment_bytes = int(segment_bytes)
        self.fsync = fsync
        self.telemetry = telemetry
        self.replica = replica
        self.appends = 0
        self.bytes_written = 0
        self.torn_writes = 0
        self.rotations = 0
        os.makedirs(path, exist_ok=True)
        self._fh = None
        self._active: Optional[str] = None
        existing = self.segments()
        index = 0
        next_seq = 1
        if existing:
            index = max(int(os.path.basename(p)[4:12])
                        for p in existing) + 1
            for e in self.scan().entries:
                next_seq = max(next_seq, e.seq + 1)
        self._index = index
        self._next_seq = next_seq

    # -- segments -------------------------------------------------------
    def segments(self) -> List[str]:
        """Segment file paths, oldest first."""
        try:
            names = sorted(n for n in os.listdir(self.path)
                           if n.startswith("wal-")
                           and n.endswith(".seg"))
        except FileNotFoundError:
            return []
        return [os.path.join(self.path, n) for n in names]

    def _open_segment(self) -> None:
        self._active = os.path.join(self.path,
                                    f"wal-{self._index:08d}.seg")
        self._index += 1
        self._fh = open(self._active, "ab")
        if self._fh.tell() == 0:
            self._fh.write(_J_MAGIC + struct.pack("<H", _J_VERSION))
            self._fh.flush()

    def _rotate(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        self._active = None
        self.rotations += 1
        self._count("journal_rotations")

    def _count(self, name: str, labels=None, n: float = 1) -> None:
        if self.telemetry is not None:
            self.telemetry.count(name, n=n, labels=labels)

    # -- appends --------------------------------------------------------
    def append(self, sid: str, snapshot) -> int:
        """Journal one checkpoint: ``snapshot`` is a StreamSnapshot
        (encoded here) or ready-made codec bytes. Returns the record's
        seq (monotone across the journal's whole life)."""
        data = (snapshot if isinstance(snapshot, (bytes, bytearray))
                else snapshot_to_bytes(snapshot))
        return self._append_frame(_REC_SNAPSHOT, sid, bytes(data))

    def forget(self, sid: str) -> int:
        """Tombstone a finalized session so recovery skips it."""
        return self._append_frame(_REC_TOMBSTONE, sid, b"")

    def _append_frame(self, rtype: int, sid: str,
                      payload: bytes) -> int:
        seq = self._next_seq
        self._next_seq += 1
        sid_b = sid.encode("utf-8")
        body = (struct.pack("<BQI", rtype, seq, len(sid_b))
                + sid_b + payload)
        frame = struct.pack("<II", len(body), zlib.crc32(body)) + body
        spec = _inject("journal.append", replica=self.replica)
        torn = spec is not None and getattr(spec, "kind",
                                            "") == "partial_write"
        if torn:
            # Simulate the crash mid-write: a prefix of the frame
            # lands, then (like the restart after the real crash)
            # the segment ends — later appends open a fresh one.
            frame = frame[:max(1, len(frame) // 2)]
        if self._fh is None:
            self._open_segment()
        self._fh.write(frame)
        self._fh.flush()
        if self.fsync:
            os.fsync(self._fh.fileno())
        self.appends += 1
        self.bytes_written += len(frame)
        self._count("journal_appends")
        self._count("journal_bytes", n=len(frame))
        if rtype == _REC_TOMBSTONE:
            self._count("journal_tombstones")
        if torn:
            self.torn_writes += 1
            self._count("journal_torn_writes")
            self._rotate()
        elif self._fh.tell() >= self.segment_bytes:
            self._rotate()
        return seq

    # -- scans / compaction ---------------------------------------------
    def scan(self) -> JournalScan:
        """Read every segment, torn-tail tolerant (never raises)."""
        if self._fh is not None:
            self._fh.flush()
        entries: List[JournalEntry] = []
        torn: List[Tuple[str, int]] = []
        sizes: Dict[str, int] = {}
        for path in self.segments():
            name = os.path.basename(path)
            with open(path, "rb") as fh:
                data = fh.read()
            sizes[name] = len(data)
            segment_entries, torn_at = scan_segment_bytes(data, name)
            entries.extend(segment_entries)
            if torn_at is not None:
                torn.append((name, torn_at))
        live, stale, tombstoned = _derive(entries)
        return JournalScan(entries=entries, torn=torn,
                           segment_bytes=sizes, live=live,
                           stale=stale, tombstoned=tombstoned)

    def compact(self) -> int:
        """Rewrite the journal keeping only the newest live snapshot
        per sid (original seqs preserved); returns bytes reclaimed."""
        scan = self.scan()
        before = sum(scan.segment_bytes.values())
        old = self.segments()
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        self._active = None
        self._open_segment()
        for sid in sorted(scan.live,
                          key=lambda s: scan.live[s].seq):
            e = scan.live[sid]
            sid_b = sid.encode("utf-8")
            body = (struct.pack("<BQI", _REC_SNAPSHOT, e.seq,
                                len(sid_b)) + sid_b + e.data)
            self._fh.write(struct.pack("<II", len(body),
                                       zlib.crc32(body)) + body)
        self._fh.flush()
        kept = self._fh.tell()
        for path in old:
            os.unlink(path)
        reclaimed = max(0, before - kept)
        self._count("journal_compactions")
        self._count("journal_bytes_reclaimed", n=reclaimed)
        return reclaimed

    def stats(self) -> dict:
        return {"appends": self.appends,
                "bytes_written": self.bytes_written,
                "torn_writes": self.torn_writes,
                "rotations": self.rotations,
                "segments": len(self.segments())}

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


# -- boot-time recovery ---------------------------------------------------

class RecoveryController:
    """Replays a :class:`SessionJournal` into a session surface at
    boot; see the module docstring.

    ``target`` in :meth:`recover` is anything with ``import_session``
    (a :class:`~.session.StreamingSessionManager`) or ``adopt`` (a
    :class:`~.pool.PooledSessionRouter`, which routes each recovered
    sid like a fresh join and restores into the routed replica).
    Ended-but-undrained sessions (``raw_len`` known and fully fed)
    resume their drain via ``leave`` so they finalize on the next
    flush."""

    def __init__(self, journal: SessionJournal, *, telemetry=None,
                 clock: Callable[[], float] = time.monotonic,
                 postmortem_fn: Optional[Callable] = None,
                 replica: Optional[str] = None):
        self.journal = journal
        self.telemetry = telemetry
        self.clock = clock
        self.postmortem_fn = postmortem_fn
        self.replica = replica

    def _count_outcome(self, outcome: str, n: int = 1) -> None:
        if n and self.telemetry is not None:
            self.telemetry.count("sessions_recovered", n=n,
                                 labels={"outcome": outcome})

    def recover(self, target) -> dict:
        """One boot-time replay; returns the report dict (also the
        shape of the ``kind="crash_recovery"`` postmortem)."""
        t0 = self.clock()
        scan = self.journal.scan()
        begin_seq = _publish(
            "recovery", replica=self.replica, phase="begin",
            records=len(scan.entries), live=len(scan.live),
            torn_tails=len(scan.torn))
        _notify("recovery.begin", replica=self.replica,
                cause_seq=begin_seq)
        counts = {k: 0 for k in RECOVERY_OUTCOMES}
        counts["torn"] = len(scan.torn)
        counts["stale"] = scan.stale
        recovered: List[str] = []
        adopt = getattr(target, "adopt", None)
        mig = _migration()
        for sid in sorted(scan.live, key=lambda s: scan.live[s].seq):
            entry = scan.live[sid]
            outcome = "ok"
            try:
                _inject("journal.recover", replica=self.replica)
                snap = snapshot_from_bytes(entry.data)
                if adopt is not None:
                    adopt(sid, snap)
                else:
                    target.import_session(snap, sid=sid)
                if snap.raw_len is not None \
                        and snap.fed >= snap.raw_len:
                    # Ended before the crash: resume the drain so the
                    # next flush finalizes it.
                    target.leave(sid)
                recovered.append(sid)
            except mig.SnapshotIncompatible:
                outcome = "incompatible"
            except (SnapshotDecodeError, Exception) as e:
                # An unreadable record — framing damage the journal
                # CRC missed, or an injected recovery fault — is a
                # torn record for this boot; recovery never aborts.
                if isinstance(e, (KeyboardInterrupt, SystemExit)):
                    raise
                outcome = "torn"
            counts[outcome] += 1
            _publish("recovery", replica=self.replica,
                     cause_seq=begin_seq, phase="session", sid=sid,
                     seq=entry.seq, outcome=outcome)
        latency_s = self.clock() - t0
        for outcome in RECOVERY_OUTCOMES:
            self._count_outcome(outcome, counts[outcome])
        if self.telemetry is not None:
            self.telemetry.observe("recovery_latency", latency_s,
                                   exemplar="boot")
        _publish("recovery_done", replica=self.replica,
                 cause_seq=begin_seq, recovered=len(recovered),
                 latency_ms=round(latency_s * 1e3, 3))
        _notify("recovery.done", replica=self.replica,
                cause_seq=begin_seq)
        report = {
            "recovered": len(recovered),
            "torn": counts["torn"],
            "incompatible": counts["incompatible"],
            "stale": counts["stale"],
            "latency_ms": round(latency_s * 1e3, 3),
            "sids": recovered,
        }
        fn = (self.postmortem_fn if self.postmortem_fn is not None
              else _postmortem_record)
        fn("crash_recovery", "boot", **report)
        return report
