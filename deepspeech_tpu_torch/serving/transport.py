"""Cross-process session handoff: a fault-tolerant snapshot transport.

The port's copy of the JAX package's ``serving/transport.py``.
``serving/migration.py`` moves a live session between replicas inside
one process and ``serving/sessionstore.py`` makes a snapshot durable and
portable as bytes. This module moves those bytes between processes over
an unreliable channel, with every failure mode (timeout, torn frame,
peer death, version skew, crash mid-transfer) degrading to a
state-preserving fallback instead of a lost session.

Wire format (one message per frame, reusing the ``sessionstore``
framing discipline: magic + version, length-prefixed CRC body)::

    DS2T | <H version | <I body_len | <I crc32(body) | body
    body = <B mtype | <I header_len | header JSON | payload

Message types: HELLO / HELLO_OK / HELLO_REJECT (the handshake —
codec version, snapshot fingerprint, model version — runs BEFORE any
snapshot bytes ship, so incompatibility fails fast with the existing
fallback-reason taxonomy), XFER / ACK (the transfer itself), ERR
(retryable server-side trouble: damaged frame, damaged snapshot).

Transfers are two-phase and idempotent:

- the SOURCE journals the encoded snapshot and keeps the session
  owned until the remote import ACK arrives — a crash mid-transfer
  leaves a journal record the next boot's
  :class:`~.sessionstore.RecoveryController` replays, so no session
  is ever lost between processes;
- the RECEIVER keys imports by ``(sid, transfer_id)`` and caches the
  ACK, so a retried send (ACK lost in flight) returns the cached
  verdict instead of double-importing.

Sends run under :class:`~..resilience.retry.Retry` (per-transfer
timeout/backoff budget); a per-peer
:class:`~..resilience.retry.CircuitBreaker` stops a dead remote from
stalling every re-pin. The full degradation ladder of
:meth:`RemoteMigrationController.migrate_remote`:

1. **remote handoff** — snapshot ships, peer ACKs, source releases
   the session (journal tombstoned);
2. **local journal-recovery re-pin** — the journaled bytes decode
   back into a snapshot and restore onto another local replica
   (``reason="journal_repin"``);
3. **drain re-pin** — the detach/attach path;
4. **stay** — single-replica host, nowhere to go: the session keeps
   streaming at home, never dropped.

Each step down is counted in
``session_migration_fallbacks{reason=...}`` and threaded through the
fleet timeline (``remote_begin`` / ``remote_ack`` / ``remote_fail``
events with ``cause_seq``). Fault points ``transport.send`` /
``transport.recv`` / ``transport.ack`` (kinds ``latency`` /
``unavailable`` / ``partial_write`` tearing a frame mid-send) script
the failures. Every socket operation has a timeout (``timeout_s``), so
a dead peer costs a bounded wait, never a hang.
"""

from __future__ import annotations

import json
import socket
import struct
import threading
import time
import zlib
from typing import Callable, Dict, List, Optional, Tuple

from ..obs import timeline as _timeline
from ..resilience import faults as _faults
from ..resilience import postmortem as _postmortem
from ..resilience.retry import CircuitBreaker, CircuitOpen, Retry
from .migration import MigrationController, SnapshotIncompatible
from .sessionstore import (CODEC_VERSION, SnapshotDecodeError,
                           snapshot_from_bytes, snapshot_to_bytes)

__all__ = [
    "FrameError", "TransportError", "HandshakeRejected",
    "MSG_HELLO", "MSG_HELLO_OK", "MSG_HELLO_REJECT",
    "MSG_XFER", "MSG_ACK", "MSG_ERR",
    "encode_frame", "decode_frame",
    "HandoffReceiver", "LoopbackTransport", "SocketTransport",
    "HandoffListener", "RemoteMigrationController",
]

_T_MAGIC = b"DS2T"
_T_VERSION = 1
_PREAMBLE = 14                # magic(4) + version(2) + len(4) + crc(4)

MSG_HELLO = 1
MSG_HELLO_OK = 2
MSG_HELLO_REJECT = 3
MSG_XFER = 4
MSG_ACK = 5
MSG_ERR = 6


class FrameError(ValueError):
    """The bytes are not a valid transport frame (magic/version/CRC/
    structure damage). Receivers answer MSG_ERR; senders retry."""


class TransportError(RuntimeError):
    """A retryable transport failure: connection refused/reset, read
    timeout, torn frame on the wire, peer died mid-request. The retry
    policy treats exactly this type as retryable."""


class HandshakeRejected(RuntimeError):
    """The peer refused the transfer for a PERMANENT reason (version /
    codec / fingerprint skew, import rejection). Not retryable — the
    message starts with the fallback-taxonomy bucket
    (``"codec_mismatch: ..."``), so ``str(e).split(":")[0]`` labels
    ``session_migration_fallbacks`` exactly like the local path."""


# -- frame codec ----------------------------------------------------------

def encode_frame(mtype: int, header: dict, payload: bytes = b"") -> bytes:
    """One wire frame: length-prefixed, CRC-checksummed (see module
    docstring)."""
    hj = json.dumps(header, ensure_ascii=False).encode("utf-8")
    body = struct.pack("<BI", int(mtype), len(hj)) + hj + payload
    return (_T_MAGIC + struct.pack("<H", _T_VERSION)
            + struct.pack("<II", len(body), zlib.crc32(body)) + body)


def decode_frame(data: bytes) -> Tuple[int, dict, bytes]:
    """``(mtype, header, payload)`` or :class:`FrameError` on any
    damage — truncation, bit flips, wrong magic, short preamble."""
    if len(data) < _PREAMBLE or data[:4] != _T_MAGIC:
        raise FrameError("not a transport frame (bad magic)")
    version = struct.unpack_from("<H", data, 4)[0]
    if version != _T_VERSION:
        raise FrameError(f"transport frame version {version} != "
                         f"{_T_VERSION}")
    blen, crc = struct.unpack_from("<II", data, 6)
    if len(data) != _PREAMBLE + blen:
        raise FrameError("transport frame truncated")
    body = data[_PREAMBLE:]
    if zlib.crc32(body) != crc:
        raise FrameError("transport frame CRC mismatch")
    if len(body) < 5:
        raise FrameError("transport frame body too short")
    mtype, hlen = struct.unpack_from("<BI", body, 0)
    if 5 + hlen > len(body):
        raise FrameError("transport header overruns frame")
    try:
        header = json.loads(body[5:5 + hlen].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise FrameError(f"transport header unreadable: {e}")
    if not isinstance(header, dict):
        raise FrameError("transport header is not an object")
    return int(mtype), header, body[5 + hlen:]


# -- the receiving peer ---------------------------------------------------

class HandoffReceiver:
    """The peer side of a transfer: handshake gate + idempotent
    import. ``target`` is a :class:`~.pool.PooledSessionRouter`
    (``adopt``) or a bare :class:`~.session.StreamingSessionManager`
    (``import_session``).

    :meth:`handle_bytes` NEVER raises on damaged input — garbage in,
    ``MSG_ERR`` out — so a torn wire frame cannot crash the peer. The
    only exception that escapes is an injected ``transport.recv`` /
    ``transport.ack`` fault (the scripted "receiver died
    mid-request"), which the transports surface as
    :class:`TransportError` to the sender.
    """

    def __init__(self, target, *, name: str = "peer",
                 version: Optional[str] = None,
                 codec_version: int = CODEC_VERSION,
                 fingerprint: Optional[str] = None,
                 telemetry=None):
        self.target = target
        self.name = name
        self.version = version
        self.codec_version = int(codec_version)
        self._fingerprint = fingerprint
        self.telemetry = telemetry
        self.imports = 0
        self.rejects = 0
        self.bad_frames = 0
        self.imported_sids: List[str] = []
        # (sid, transfer_id) -> cached ACK header: a retried XFER
        # (its ACK was lost) replays the verdict, never the import.
        self.seen: Dict[Tuple[str, str], dict] = {}

    # -- target introspection ---------------------------------------
    def _a_manager(self):
        t = self.target
        if hasattr(t, "snapshot_fingerprint"):
            return t
        pools = t._pools() if hasattr(t, "_pools") else [t.pool]
        for pool in pools:
            for rep in pool:
                mgr = rep.session_manager
                if mgr is not None:
                    return mgr
        return None

    def target_fingerprint(self) -> Optional[str]:
        if self._fingerprint is None:
            mgr = self._a_manager()
            if mgr is not None:
                self._fingerprint = mgr.snapshot_fingerprint()
        return self._fingerprint

    def target_version(self) -> Optional[str]:
        if self.version is not None:
            return self.version
        t = self.target
        if hasattr(t, "_pools"):
            for pool in t._pools():
                for rep in pool:
                    if getattr(rep, "version", None) is not None:
                        return rep.version
        return None

    def _count(self, name: str) -> None:
        if self.telemetry is not None:
            self.telemetry.count(name, labels={"peer": self.name})

    # -- the request/reply surface ----------------------------------
    def handle_bytes(self, data: bytes) -> bytes:
        """One request frame in, one reply frame out."""
        _faults.inject("transport.recv", replica=self.name)
        try:
            mtype, header, payload = decode_frame(bytes(data))
        except FrameError as e:
            self.bad_frames += 1
            self._count("transport_bad_frames")
            return encode_frame(MSG_ERR, {"error": "bad_frame",
                                          "detail": str(e)})
        if mtype == MSG_HELLO:
            return self._handle_hello(header)
        if mtype == MSG_XFER:
            return self._handle_xfer(header, payload)
        return encode_frame(MSG_ERR, {"error": "unknown_message",
                                      "mtype": int(mtype)})

    def _handle_hello(self, header: dict) -> bytes:
        why = None
        theirs, mine = header.get("version"), self.target_version()
        if theirs != mine:
            why = f"version_mismatch: {theirs!r} != {mine!r}"
        elif int(header.get("codec_version", -1)) != self.codec_version:
            why = (f"codec_mismatch: codec v"
                   f"{header.get('codec_version')} != "
                   f"v{self.codec_version}")
        else:
            want = self.target_fingerprint()
            got = header.get("fingerprint")
            if want is not None and got != want:
                why = (f"fingerprint_mismatch: {got!r} does not "
                       f"match target")
        if why is not None:
            self.rejects += 1
            self._count("transport_handshake_rejects")
            return encode_frame(MSG_HELLO_REJECT, {"reason": why})
        return encode_frame(MSG_HELLO_OK, {
            "version": mine, "codec_version": self.codec_version,
            "fingerprint": self.target_fingerprint()})

    def _ack(self, hdr: dict) -> bytes:
        # The ack fault fires AFTER the verdict is cached: the sender
        # sees a dead connection, retries, and lands on the duplicate
        # path — exactly the lost-ACK scenario idempotency covers.
        _faults.inject("transport.ack", replica=self.name)
        return encode_frame(MSG_ACK, hdr)

    def _handle_xfer(self, header: dict, payload: bytes) -> bytes:
        sid = header.get("sid")
        tid = header.get("transfer_id")
        if not sid or not tid:
            return encode_frame(MSG_ERR, {"error": "bad_request",
                                          "detail": "sid/transfer_id "
                                                    "required"})
        key = (str(sid), str(tid))
        if key in self.seen:
            hdr = dict(self.seen[key])
            hdr["duplicate"] = True
            return self._ack(hdr)
        try:
            snap = snapshot_from_bytes(payload)
        except SnapshotDecodeError as e:
            # Damaged in flight: retryable, NOT cached — the retry
            # carries a clean copy.
            return encode_frame(MSG_ERR, {"error": "snapshot_damaged",
                                          "detail": str(e)})
        except SnapshotIncompatible as e:
            return self._verdict(key, sid, tid, "rejected",
                                 f"codec_mismatch: {e}")
        try:
            if hasattr(self.target, "adopt"):
                self.target.adopt(str(sid), snap)
            else:
                self.target.import_session(snap, sid=str(sid))
        except SnapshotIncompatible as e:
            return self._verdict(key, sid, tid, "rejected",
                                 f"fingerprint_mismatch: {e}")
        except Exception as e:
            return self._verdict(key, sid, tid, "rejected",
                                 f"import_failed: {e}")
        self.imports += 1
        self.imported_sids.append(str(sid))
        self._count("sessions_adopted_remote")
        return self._verdict(key, sid, tid, "imported", None)

    def _verdict(self, key, sid, tid, status, reason) -> bytes:
        hdr = {"status": status, "sid": str(sid),
               "transfer_id": str(tid)}
        if reason is not None:
            hdr["reason"] = reason
            self.rejects += 1
            self._count("transport_import_rejects")
        self.seen[key] = hdr
        return self._ack(hdr)


# -- transports -----------------------------------------------------------

class LoopbackTransport:
    """In-memory transport: the request frame goes straight to a
    :class:`HandoffReceiver`. Deterministic (no sockets, no threads)
    — the test default — yet it honors the same fault points as
    the wire: ``transport.send`` (``partial_write`` truncates the
    frame exactly like a torn TCP send) on the way in, and a receiver
    that dies mid-request surfaces as :class:`TransportError`."""

    def __init__(self, receiver: HandoffReceiver, *,
                 name: str = "loopback"):
        self.receiver = receiver
        self.name = name
        self.roundtrips = 0

    def roundtrip(self, data: bytes) -> bytes:
        try:
            spec = _faults.inject("transport.send", replica=self.name)
        except _faults.InjectedFault as e:
            raise TransportError(f"send failed: {e}") from e
        if spec is not None and spec.kind == "partial_write":
            data = data[:max(1, len(data) // 2)]
        try:
            reply = self.receiver.handle_bytes(data)
        except _faults.InjectedFault as e:
            raise TransportError(f"peer died mid-request: {e}") from e
        self.roundtrips += 1
        return reply


class SocketTransport:
    """Stdlib-TCP transport: one connection per request/reply
    roundtrip against a :class:`HandoffListener`. The frame is
    length-prefixed and CRC'd, so the reader needs no trust in the
    stream: a torn send (``partial_write`` truncates then closes the
    write side) reaches the peer as garbage it answers ``MSG_ERR``
    to. All socket trouble surfaces as :class:`TransportError`."""

    def __init__(self, host: str, port: int, *,
                 timeout_s: float = 5.0, name: Optional[str] = None):
        self.host = host
        self.port = int(port)
        self.timeout_s = timeout_s
        self.name = name if name is not None else f"{host}:{port}"
        self.roundtrips = 0

    def roundtrip(self, data: bytes) -> bytes:
        try:
            spec = _faults.inject("transport.send", replica=self.name)
        except _faults.InjectedFault as e:
            raise TransportError(f"send failed: {e}") from e
        torn = spec is not None and spec.kind == "partial_write"
        if torn:
            data = data[:max(1, len(data) // 2)]
        try:
            with socket.create_connection(
                    (self.host, self.port),
                    timeout=self.timeout_s) as sock:
                sock.settimeout(self.timeout_s)
                sock.sendall(data)
                sock.shutdown(socket.SHUT_WR)
                chunks = []
                while True:
                    b = sock.recv(65536)
                    if not b:
                        break
                    chunks.append(b)
        except OSError as e:
            raise TransportError(f"socket roundtrip failed: {e}") \
                from e
        reply = b"".join(chunks)
        if not reply:
            raise TransportError("peer closed without replying")
        self.roundtrips += 1
        return reply


class HandoffListener:
    """The serving side of :class:`SocketTransport`: a daemon accept
    loop feeding whole requests (read to write-shutdown/EOF) into a
    :class:`HandoffReceiver`. Damage never crashes it — short reads
    reach ``handle_bytes`` and come back ``MSG_ERR``; a receiver
    killed by an injected fault just drops that connection."""

    def __init__(self, receiver: HandoffReceiver, *,
                 host: str = "127.0.0.1", port: int = 0,
                 timeout_s: float = 5.0):
        self.receiver = receiver
        self.timeout_s = timeout_s
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET,
                             socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(16)
        # Accept with a short timeout instead of blocking forever: a
        # close() from another thread does NOT wake a blocked
        # accept() (the kernel keeps the port alive until the syscall
        # returns, so a closed listener could serve one more
        # connection). The timeout bounds that window and lets the
        # serve loop observe _closing.
        self._srv.settimeout(0.2)
        self.host, self.port = self._srv.getsockname()[:2]
        self._closing = False
        self._thread = threading.Thread(
            target=self._serve, name=f"handoff-listener:{self.port}",
            daemon=True)
        self._thread.start()

    def _serve(self) -> None:
        while not self._closing:
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            try:
                conn.settimeout(self.timeout_s)
                chunks = []
                while True:
                    b = conn.recv(65536)
                    if not b:
                        break
                    chunks.append(b)
                data = b"".join(chunks)
                if data:
                    conn.sendall(self.receiver.handle_bytes(data))
            except Exception:
                # Injected receiver death or socket trouble: the
                # sender sees the drop and retries; never take the
                # listener down with one connection.
                pass
            finally:
                try:
                    conn.close()
                except OSError:
                    pass

    def close(self) -> None:
        self._closing = True
        try:
            self._srv.close()
        except OSError:
            pass
        self._thread.join(timeout=2.0)


# -- the sending controller -----------------------------------------------

class RemoteMigrationController(MigrationController):
    """A :class:`~.migration.MigrationController` that can also hand
    sessions to another PROCESS over a transport — see the module
    docstring for the two-phase protocol and the degradation ladder.
    In-process :meth:`~.migration.MigrationController.migrate` re-pins
    keep working unchanged, so one controller serves both planes."""

    def __init__(self, *, journal=None, retry: Optional[Retry] = None,
                 breaker_factory: Optional[Callable[[str],
                                                    CircuitBreaker]] = None,
                 telemetry=None, clock=time.monotonic,
                 postmortem_fn=_postmortem.record):
        super().__init__(telemetry=telemetry, clock=clock,
                         postmortem_fn=postmortem_fn)
        self.journal = journal
        self.retry = retry if retry is not None else Retry(
            attempts=3, base_s=0.05, multiplier=2.0, max_s=0.5,
            jitter=0.0, budget_s=2.0, name="handoff")
        self.breaker_factory = breaker_factory if breaker_factory \
            is not None else (lambda peer: CircuitBreaker(
                failure_threshold=3, cooldown_s=1.0,
                clock=self.clock, name=f"peer:{peer}"))
        self.breakers: Dict[str, CircuitBreaker] = {}
        self._hello_ok: set = set()
        self._transfer_seq = 0
        self.remote_handoffs = 0
        self.remote_fallbacks = 0

    def breaker_for(self, peer: str) -> CircuitBreaker:
        if peer not in self.breakers:
            self.breakers[peer] = self.breaker_factory(peer)
        return self.breakers[peer]

    # -- reply handling ---------------------------------------------
    @staticmethod
    def _decode_reply(reply: bytes) -> Tuple[int, dict]:
        try:
            mtype, header, _ = decode_frame(reply)
        except FrameError as e:
            raise TransportError(f"damaged reply frame: {e}") from e
        if mtype == MSG_ERR:
            raise TransportError(
                f"peer error: {header.get('error')} "
                f"({header.get('detail', '')})")
        return mtype, header

    # -- the remote handoff -----------------------------------------
    def migrate_remote(self, router, sid: str, transport, *,
                       reason: str = "xhost",
                       now: Optional[float] = None) -> str:
        """Hand ``sid`` off ``router`` to the process behind
        ``transport``. Returns the rung the transfer landed on:
        ``"remote"`` (peer owns it now), ``"local"`` (journal-recovery
        re-pin onto another local replica), ``"drain"`` (legacy drain
        re-pin), or ``"stay"`` (nowhere to go — the session keeps
        streaming at home). Every outcome preserves the session."""
        local = router.local_of(sid)
        rid = router.home_of(sid)
        pool = router.pool_of(sid)
        src = pool.replica(rid)
        mgr = src.peek_session_manager()
        peer = transport.name
        tel = self.telemetry if self.telemetry is not None \
            else pool.telemetry
        t0 = self.clock()

        # Phase 1: snapshot (pure read — the source keeps owning the
        # session until the ACK) + write-ahead journal the encoded
        # bytes under the manager-local name, so a crash anywhere
        # past this line is recoverable.
        snap = mgr.snapshot_session(local)
        data = snapshot_to_bytes(snap)
        self._transfer_seq += 1
        tid = f"t{self._transfer_seq}"
        cause = _timeline.last_for(rid)
        begin_seq = _timeline.publish(
            "remote_begin", "migration", replica=rid, cause_seq=cause,
            sid=sid, transfer_id=tid, peer=peer, nbytes=len(data))
        _faults.notify("migration.remote_begin", replica=rid,
                       cause_seq=begin_seq)
        journal = self.journal if self.journal is not None \
            else getattr(mgr, "journal", None)
        if journal is not None:
            journal.append(local, data)

        # Phase 2: handshake-then-transfer under retry, behind the
        # per-peer breaker. A handshake rejection is the peer being
        # ALIVE and incompatible — breaker success, permanent error.
        breaker = self.breaker_for(peer)
        self.retry.replica = peer

        def _send_once():
            if peer not in self._hello_ok:
                reply = transport.roundtrip(encode_frame(MSG_HELLO, {
                    "version": getattr(src, "version", None),
                    "codec_version": int(getattr(
                        src, "codec_version", CODEC_VERSION)),
                    "fingerprint": snap.fingerprint}))
                mtype, header = self._decode_reply(reply)
                if mtype == MSG_HELLO_REJECT:
                    raise HandshakeRejected(
                        str(header.get("reason") or
                            "handshake_rejected"))
                if mtype != MSG_HELLO_OK:
                    raise TransportError(
                        f"unexpected handshake reply {mtype}")
                self._hello_ok.add(peer)
            reply = transport.roundtrip(encode_frame(
                MSG_XFER, {"sid": sid, "transfer_id": tid}, data))
            mtype, header = self._decode_reply(reply)
            if mtype != MSG_ACK:
                raise TransportError(f"unexpected transfer reply "
                                     f"{mtype}")
            if header.get("status") == "rejected":
                raise HandshakeRejected(
                    str(header.get("reason") or "rejected"))
            if header.get("status") != "imported":
                raise TransportError(
                    f"unexpected ack status "
                    f"{header.get('status')!r}")
            return header

        def _guarded():
            if not breaker.allow():
                raise CircuitOpen(
                    f"circuit {breaker.name!r} open "
                    f"(cooldown {breaker.cooldown_s}s)")
            try:
                out = _send_once()
            except TransportError:
                breaker.record_failure()
                raise
            except HandshakeRejected:
                breaker.record_success()
                raise
            breaker.record_success()
            return out

        why = None
        ack = None
        try:
            ack = self.retry.call(
                _guarded,
                retryable=lambda e: isinstance(e, TransportError))
        except HandshakeRejected as e:
            why = str(e)
        except CircuitOpen:
            why = "peer_circuit_open"
        except TransportError as e:
            why = f"peer_unavailable: {e}"
        latency_s = self.clock() - t0

        if why is None:
            status = ("duplicate" if ack.get("duplicate")
                      else "imported")
            router.release(sid)
            _timeline.publish(
                "remote_ack", "migration", replica=rid,
                cause_seq=begin_seq, sid=sid, transfer_id=tid,
                peer=peer, status=status)
            self.remote_handoffs += 1
            self.migrations += 1
            self.per_session[sid] = self.per_session.get(sid, 0) + 1
            labels = {"replica": f"peer:{peer}", "reason": reason}
            tel.count("session_migrations", labels=labels)
            tel.observe("migration_latency", latency_s, labels=labels,
                        exemplar=f"sess:{sid}")
            self.postmortem_fn(
                "migration", reason, outcome="remote_handoff",
                reason=reason, sid=sid, src_replica=rid,
                dst_replica=f"peer:{peer}",
                latency_ms=latency_s * 1e3,
                fed_frames=int(snap.fed or 0),
                state_bytes=len(data))
            self.events.append({"action": "remote_handoff",
                                "sid": sid, "src": rid, "dst": peer,
                                "transfer_id": tid, "reason": reason,
                                "latency_ms": latency_s * 1e3})
            return "remote"

        # Rung 1 failed: count it, then walk down the ladder.
        _timeline.publish(
            "remote_fail", "migration", replica=rid,
            cause_seq=begin_seq, sid=sid, transfer_id=tid, peer=peer,
            reason=why)
        self.remote_fallbacks += 1
        self.fallbacks += 1
        tel.count("session_migration_fallbacks",
                  labels={"reason": why.split(":")[0]})
        self.postmortem_fn(
            "migration", reason, outcome="fallback_local",
            reason=why, sid=sid, src_replica=rid,
            dst_replica=f"peer:{peer}", latency_ms=latency_s * 1e3)
        self.events.append({"action": "remote_fail", "sid": sid,
                            "src": rid, "dst": peer, "reason": why})
        return self._local_ladder(router, pool, sid, local, rid, src,
                                  mgr, data, begin_seq, tel, now)

    # -- rungs 2..4 --------------------------------------------------
    def _local_ladder(self, router, pool, sid, local, rid, src, mgr,
                      data, begin_seq, tel, now) -> str:
        """Remote failed: journal-recovery re-pin onto another local
        replica, else the legacy drain re-pin, else stay home."""
        now = pool.clock() if now is None else now
        t0 = self.clock()
        dst = None
        for rep in pool:
            if rep.rid != rid and rep.can_route(now) \
                    and rep.session_manager is not None:
                dst = rep
                break
        if dst is None:
            tel.count("session_migration_fallbacks",
                      labels={"reason": "no_local_destination"})
            self.events.append({"action": "stay", "sid": sid,
                                "src": rid})
            return "stay"
        try:
            # The journal-recovery flavor: restore from the journaled
            # BYTES (codec round-trip), exactly what a cold boot
            # would replay.
            snap = snapshot_from_bytes(data)
            exported = mgr.export_session(local)
            try:
                dst.session_manager.import_session(snap, sid=local)
            except Exception:
                # Never strand a stream: the source fingerprint
                # matches itself, so this restore cannot fail.
                mgr.import_session(exported, sid=local)
                raise
        except Exception as e:
            tel.count("session_migration_fallbacks",
                      labels={"reason": "local_repin_failed"})
            self.fallbacks += 1
            self.postmortem_fn(
                "migration", "journal_repin", outcome="fallback_drain",
                reason=f"local_repin_failed: {e}", sid=sid,
                src_replica=rid, dst_replica=dst.rid,
                latency_ms=(self.clock() - t0) * 1e3)
            _timeline.publish(
                "migration_fallback", "migration", replica=dst.rid,
                cause_seq=begin_seq, sid=sid, src=rid,
                reason=f"local_repin_failed: {e}")
            router.drain_repin(sid, dst)
            self.events.append({"action": "fallback", "sid": sid,
                                "src": rid, "dst": dst.rid,
                                "reason": f"local_repin_failed: {e}"})
            return "drain"
        pool.pin_to(sid, dst.rid)
        router.rehome(sid, dst.rid)
        latency_s = self.clock() - t0
        self.migrations += 1
        self.per_session[sid] = self.per_session.get(sid, 0) + 1
        labels = {"replica": dst.rid, "reason": "journal_repin"}
        tel.count("session_migrations", labels=labels)
        tel.observe("migration_latency", latency_s, labels=labels,
                    exemplar=f"sess:{sid}")
        self.postmortem_fn(
            "migration", "journal_repin", outcome="handoff",
            reason="journal_repin", sid=sid, src_replica=rid,
            dst_replica=dst.rid, latency_ms=latency_s * 1e3)
        _timeline.publish(
            "migration", "migration", replica=dst.rid,
            cause_seq=begin_seq, sid=sid, src=rid,
            reason="journal_repin",
            latency_ms=round(latency_s * 1e3, 3))
        self.events.append({"action": "handoff", "sid": sid,
                            "src": rid, "dst": dst.rid,
                            "reason": "journal_repin",
                            "latency_ms": latency_s * 1e3})
        return "local"

    def stats(self) -> dict:
        out = super().stats()
        out["remote_handoffs"] = self.remote_handoffs
        out["remote_fallbacks"] = self.remote_fallbacks
        out["breakers"] = {p: b.state
                          for p, b in self.breakers.items()}
        return out
