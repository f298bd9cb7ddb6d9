"""The port's cross-process session handoff (``serving/transport.py``),
held to the JAX package's.

The twelve cases of tests/test_transport.py on the port's classes: the
frame codec (every truncation and bit flip detected), the receiver's
handshake gate and idempotent transfers, the TCP listener (loopback
only), the ``migrate_remote`` ladder (remote, journal re-pin, stay) and
the router's adoption conflicts. Then the wire: ``encode_frame`` writes
the JAX codec's bytes for each message type, and a port sender hands a
session to a JAX receiver over the loopback. Everything is model-free:
duck-typed managers that speak the real snapshot codec, real routers,
pools and breakers, injected clocks. Each test that opens a socket or a
thread runs under a deadline of its own (``SIGALRM``), and every socket
has a timeout.
"""

import signal
import socket as socket_mod

import numpy as np
import pytest
import torch

from deepspeech_tpu.serving import transport as jax_transport
from deepspeech_tpu_torch.resilience import CircuitBreaker
from deepspeech_tpu_torch.resilience.retry import Retry
from deepspeech_tpu_torch.serving import (CODEC_VERSION, HandoffListener,
                                          HandoffReceiver, LoopbackTransport,
                                          PooledSessionRouter,
                                          RemoteMigrationController, Replica,
                                          ReplicaPool, ServingTelemetry,
                                          SocketTransport, StreamSnapshot,
                                          TransportError, snapshot_to_bytes)
from deepspeech_tpu_torch.serving.transport import (MSG_ACK, MSG_ERR,
                                                    MSG_HELLO, MSG_HELLO_OK,
                                                    MSG_HELLO_REJECT,
                                                    MSG_XFER, FrameError,
                                                    decode_frame,
                                                    encode_frame)

# One CPU thread for torch: parallel test workers share the machine's
# cores, and a thread pool in each worker oversubscribes them.
torch.set_num_threads(1)

DEADLINE_S = 30


@pytest.fixture
def deadline():
    """Fail the test (instead of hanging the run) past ``DEADLINE_S``."""
    def expire(signum, frame):
        raise TimeoutError(f"test exceeded its {DEADLINE_S} s deadline")

    prev = signal.signal(signal.SIGALRM, expire)
    signal.alarm(DEADLINE_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, prev)


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _snap(sid, text="", fingerprint="fake"):
    """A real StreamSnapshot (round-trips the real wire codec)."""
    return StreamSnapshot(
        sid=sid, fingerprint=fingerprint, fed=64, raw_len=None,
        acoustic={"h": np.zeros((2,), np.float32)}, prev_ids=0, text=text)


class WireMgr:
    """Duck-typed manager speaking the real snapshot surface: the session
    text rides the codec, so a transfer's continuation proves zero lost
    chunks without a model."""

    fingerprint = "fake"

    def __init__(self, log=None):
        self.active = {}
        self.done = {}
        self.log = log if log is not None else []

    def join(self, sid, raw_len=None):
        self.active[sid] = []

    def leave(self, sid, tail=None):
        self.done[sid] = " ".join(self.active.pop(sid))

    def step(self, chunks):
        for sid, c in chunks.items():
            self.active[sid].append(str(c))
            self.log.append((sid, str(c)))
        return {sid: " ".join(v) for sid, v in self.active.items()}

    def flush(self):
        pass

    def final(self, sid):
        return self.done[sid]

    def stats(self):
        return {"active": len(self.active), "draining": 0}

    def snapshot_fingerprint(self):
        return self.fingerprint

    def snapshot_session(self, sid):
        return _snap(sid, " ".join(self.active[sid]),
                     fingerprint=self.fingerprint)

    def export_session(self, sid, forget=False):
        return ("exported", sid, self.active.pop(sid))

    def import_session(self, snap, sid=None):
        if isinstance(snap, tuple):          # the ladder's undo path
            _, sid0, seen = snap
            self.active[sid if sid is not None else sid0] = list(seen)
        else:
            key = sid if sid is not None else snap.sid
            self.active[key] = snap.text.split() if snap.text else []


def _pool(clock, tel, n=2):
    reps = [Replica(f"r{k}", telemetry=tel, clock=clock,
                    breaker=CircuitBreaker(name=f"b{k}", failure_threshold=2,
                                           cooldown_s=1.0, clock=clock,
                                           registry=tel),
                    session_factory=WireMgr)
            for k in range(n)]
    return ReplicaPool(reps, clock=clock, telemetry=tel,
                       drain_window_s=0.25, handoff=True)


def _host(n=2):
    clock = Clock()
    tel = ServingTelemetry()
    pool = _pool(clock, tel, n=n)
    return clock, tel, pool, PooledSessionRouter(pool)


def _ctrl(tel, clock, **kw):
    kw.setdefault("retry", Retry(attempts=3, base_s=0.01, multiplier=2.0,
                                 max_s=0.05, jitter=0.0, budget_s=1.0,
                                 name="handoff", sleep=lambda s: None))
    kw.setdefault("postmortem_fn", lambda *a, **k: None)
    return RemoteMigrationController(telemetry=tel, clock=clock, **kw)


# -- frame codec --------------------------------------------------------------

def test_frame_roundtrip_all_message_types():
    payload = b"\x00\x01\xffdata" * 9
    for mtype in (MSG_HELLO, MSG_HELLO_OK, MSG_HELLO_REJECT, MSG_XFER,
                  MSG_ACK, MSG_ERR):
        hdr = {"sid": "sé0", "n": mtype}
        m, h, p = decode_frame(encode_frame(mtype, hdr, payload))
        assert (m, h, p) == (mtype, hdr, payload)


def test_frame_fuzz_every_truncation_and_bit_flip_detected():
    frame = encode_frame(MSG_XFER, {"sid": "x", "transfer_id": "t1"},
                         b"\x07" * 131)
    for cut in range(len(frame)):
        with pytest.raises(FrameError):
            decode_frame(frame[:cut])
    for i in range(len(frame)):
        damaged = bytearray(frame)
        damaged[i] ^= 0x5A
        with pytest.raises(FrameError):
            decode_frame(bytes(damaged))


# -- the receiving peer -------------------------------------------------------

class _Target:
    """Bare manager-shaped adoption target."""

    def __init__(self, fingerprint="fake"):
        self._fp = fingerprint
        self.imported = []

    def snapshot_fingerprint(self):
        return self._fp

    def import_session(self, snap, sid=None):
        self.imported.append((sid, snap))


def _hello(version=None, codec=CODEC_VERSION, fingerprint="fake"):
    return encode_frame(MSG_HELLO, {"version": version,
                                    "codec_version": codec,
                                    "fingerprint": fingerprint})


def test_handshake_accepts_match_and_rejects_skew_with_taxonomy():
    tel = ServingTelemetry()
    rx = HandoffReceiver(_Target(), name="p", telemetry=tel)
    m, h, _ = decode_frame(rx.handle_bytes(_hello()))
    assert m == MSG_HELLO_OK and h["codec_version"] == CODEC_VERSION
    for frame, bucket in (
            (_hello(version="v2"), "version_mismatch"),
            (_hello(codec=99), "codec_mismatch"),
            (_hello(fingerprint="other"), "fingerprint_mismatch")):
        m, h, _ = decode_frame(rx.handle_bytes(frame))
        assert m == MSG_HELLO_REJECT
        assert h["reason"].split(":")[0] == bucket
    assert rx.rejects == 3
    assert tel.counter("transport_handshake_rejects",
                       labels={"peer": "p"}) == 3


def test_xfer_idempotent_by_transfer_id_lost_ack_never_reimports():
    target = _Target()
    rx = HandoffReceiver(target, name="p")
    frame = encode_frame(MSG_XFER, {"sid": "a", "transfer_id": "t1"},
                         snapshot_to_bytes(_snap("a", "c0 c1")))
    m, h, _ = decode_frame(rx.handle_bytes(frame))
    assert m == MSG_ACK and h["status"] == "imported"
    assert rx.imports == 1 and rx.imported_sids == ["a"]
    m, h, _ = decode_frame(rx.handle_bytes(frame))
    assert m == MSG_ACK and h["status"] == "imported"
    assert h["duplicate"] is True
    assert rx.imports == 1 and len(target.imported) == 1
    m, h, _ = decode_frame(rx.handle_bytes(encode_frame(
        MSG_XFER, {"sid": "a", "transfer_id": "t2"},
        snapshot_to_bytes(_snap("a", "c0 c1 c2")))))
    assert h["status"] == "imported" and rx.imports == 2


def test_damaged_snapshot_err_not_cached_clean_retry_lands():
    rx = HandoffReceiver(_Target(), name="p")
    good = snapshot_to_bytes(_snap("a", "c0"))
    m, h, _ = decode_frame(rx.handle_bytes(encode_frame(
        MSG_XFER, {"sid": "a", "transfer_id": "t1"}, good[:len(good) // 2])))
    assert m == MSG_ERR and h["error"] == "snapshot_damaged"
    m, h, _ = decode_frame(rx.handle_bytes(encode_frame(
        MSG_XFER, {"sid": "a", "transfer_id": "t1"}, good)))
    assert m == MSG_ACK and h["status"] == "imported"


def test_receiver_never_raises_on_garbage():
    rx = HandoffReceiver(_Target(), name="p")
    frame = encode_frame(MSG_XFER, {"sid": "z", "transfer_id": "t"},
                         b"\x00" * 64)
    cases = [b"", b"\xffnot-a-frame" * 5, frame[:11], frame[:-3]]
    cases += [bytes(b ^ 0x5A if i == 9 else b for i, b in enumerate(frame))]
    for data in cases:
        m, h, _ = decode_frame(rx.handle_bytes(data))
        assert m == MSG_ERR, data[:16]
    assert rx.bad_frames == len(cases)
    assert rx.imports == 0


def test_socket_listener_serves_protocol_and_shrugs_off_garbage(deadline):
    """The TCP leg end to end on the loopback: handshake and transfer
    through a real listener, raw garbage answered (not fatal), the
    listener serving on; a closed port costs one bounded wait."""
    target = _Target()
    rx = HandoffReceiver(target, name="p")
    lsn = HandoffListener(rx, port=0, timeout_s=5.0)
    try:
        tx = SocketTransport(lsn.host, lsn.port, timeout_s=5.0)
        m, _, _ = decode_frame(tx.roundtrip(_hello()))
        assert m == MSG_HELLO_OK
        with socket_mod.create_connection((lsn.host, lsn.port),
                                          timeout=5.0) as s:
            s.settimeout(5.0)
            s.sendall(b"\xffgarbage-not-a-frame" * 7)
            s.shutdown(socket_mod.SHUT_WR)
            reply = b""
            while True:
                piece = s.recv(65536)
                if not piece:
                    break
                reply += piece
        m, h, _ = decode_frame(reply)
        assert m == MSG_ERR and h["error"] == "bad_frame"
        m, h, _ = decode_frame(tx.roundtrip(encode_frame(
            MSG_XFER, {"sid": "a", "transfer_id": "t1"},
            snapshot_to_bytes(_snap("a", "c0")))))
        assert m == MSG_ACK and h["status"] == "imported"
        assert target.imported
    finally:
        lsn.close()
    assert not lsn._thread.is_alive()
    with pytest.raises(TransportError):
        SocketTransport(lsn.host, lsn.port, timeout_s=0.5).roundtrip(
            _hello())


# -- migrate_remote: the degradation ladder -----------------------------------

def test_migrate_remote_success_releases_source_peer_owns_session():
    clock_a, tel, pool_a, router_a = _host()
    _, tel_b, _, router_b = _host()
    rx = HandoffReceiver(router_b, name="host-b", telemetry=tel_b)
    ctrl = _ctrl(tel, clock_a)
    router_a.join("a")
    router_a.step({"a": "c0"})
    router_a.step({"a": "c1"})
    out = ctrl.migrate_remote(router_a, "a",
                              LoopbackTransport(rx, name="host-b"))
    assert out == "remote"
    with pytest.raises(KeyError):
        router_a.home_of("a")
    assert sum(r.peek_session_manager().stats()["active"]
               if r.peek_session_manager() else 0 for r in pool_a) == 0
    assert ctrl.remote_handoffs == 1 and ctrl.remote_fallbacks == 0
    assert tel.counter("session_migrations",
                       labels={"replica": "peer:host-b",
                               "reason": "xhost"}) == 1
    assert rx.imports == 1 and rx.imported_sids == ["a"]
    router_b.step({"a": "c2"})
    router_b.leave("a")
    router_b.flush()
    assert router_b.final("a") == "c0 c1 c2"


def test_migrate_remote_handshake_reject_falls_back_local():
    clock, tel, pool, router = _host()
    rx = HandoffReceiver(None, name="skew", fingerprint="other-config")
    ctrl = _ctrl(tel, clock)
    home = router.join("a")
    router.step({"a": "c0"})
    out = ctrl.migrate_remote(router, "a", LoopbackTransport(rx, name="skew"))
    assert out == "local"
    assert rx.rejects == 1 and rx.imports == 0
    assert router.home_of("a") != home
    assert tel.counter("session_migration_fallbacks",
                       labels={"reason": "fingerprint_mismatch"}) == 1
    assert tel.counter("session_migrations",
                       labels={"replica": router.home_of("a"),
                               "reason": "journal_repin"}) == 1
    assert ctrl.breaker_for("skew").state == "closed"
    router.step({"a": "c1"})
    router.leave("a")
    router.flush()
    assert router.final("a") == "c0 c1"


def test_migrate_remote_unreachable_single_replica_stays_then_opens():
    class DeadTransport:
        name = "dead"

        def __init__(self):
            self.calls = 0

        def roundtrip(self, data):
            self.calls += 1
            raise TransportError("connection refused")

    clock, tel, pool, router = _host(n=1)
    ctrl = _ctrl(tel, clock)
    dead = DeadTransport()
    router.join("a")
    router.step({"a": "c0"})
    assert ctrl.migrate_remote(router, "a", dead) == "stay"
    assert dead.calls == 3
    assert tel.counter("session_migration_fallbacks",
                       labels={"reason": "peer_unavailable"}) == 1
    assert tel.counter("session_migration_fallbacks",
                       labels={"reason": "no_local_destination"}) == 1
    assert ctrl.breaker_for("dead").state == "open"
    assert ctrl.migrate_remote(router, "a", dead) == "stay"
    assert dead.calls == 3
    assert tel.counter("session_migration_fallbacks",
                       labels={"reason": "peer_circuit_open"}) == 1
    router.step({"a": "c1"})
    router.leave("a")
    router.flush()
    assert router.final("a") == "c0 c1"


# -- router adoption conflicts ------------------------------------------------

def test_adopt_rejects_sid_already_live_original_unharmed():
    clock, tel, pool, router = _host()
    router.join("a")
    router.step({"a": "c0"})
    with pytest.raises(ValueError, match="already attached"):
        router.adopt("a", _snap("a", "imposter"))
    assert router.local_of("a") == "a@0"
    router.step({"a": "c1"})
    router.leave("a")
    router.flush()
    assert router.final("a") == "c0 c1"
    router2 = _host()[3]
    router2.join("b")
    rx = HandoffReceiver(router2, name="p")
    m, h, _ = decode_frame(rx.handle_bytes(encode_frame(
        MSG_XFER, {"sid": "b", "transfer_id": "t1"},
        snapshot_to_bytes(_snap("b", "imposter")))))
    assert m == MSG_ACK and h["status"] == "rejected"
    assert h["reason"].startswith("import_failed")
    assert rx.imports == 0


def test_adopt_lands_on_prior_pin_one_owner_zero_lost_chunks():
    clock, tel, pool, router = _host()
    pool.pin_to("a", "r1")
    home = router.adopt("a", _snap("a", "c0 c1"))
    assert home == "r1" and router.home_of("a") == "r1"
    owners = [r.rid for r in pool if r.peek_session_manager() is not None
              and "a@0" in r.peek_session_manager().active]
    assert owners == ["r1"]
    router.step({"a": "c2"})
    router.leave("a")
    router.flush()
    assert router.final("a") == "c0 c1 c2"


# -- the wire against the JAX package -----------------------------------------

@pytest.mark.parametrize("mtype", [MSG_HELLO, MSG_HELLO_OK, MSG_HELLO_REJECT,
                                   MSG_XFER, MSG_ACK, MSG_ERR])
def test_encode_frame_bytes_equal_jax(mtype):
    hdr = {"sid": "sé0", "transfer_id": "t7", "status": "imported",
           "codec_version": CODEC_VERSION, "n": [1, 2.5, None]}
    payload = snapshot_to_bytes(_snap("sé0", "c0 c1")) \
        if mtype == MSG_XFER else b""
    got = encode_frame(mtype, hdr, payload)
    assert got == jax_transport.encode_frame(mtype, hdr, payload)
    assert jax_transport.decode_frame(got) == (mtype, hdr, payload)
    assert decode_frame(jax_transport.encode_frame(mtype, hdr, payload)) \
        == (mtype, hdr, payload)


def test_port_sender_hands_off_to_jax_receiver(deadline):
    """A port ``RemoteMigrationController`` hands a greedy session to a
    JAX ``HandoffReceiver`` behind a JAX ``HandoffListener`` on the
    loopback: the JAX side imports the same snapshot text, and the port
    side releases the session."""
    jax_target = _Target()
    jax_rx = jax_transport.HandoffReceiver(jax_target, name="jax")
    lsn = jax_transport.HandoffListener(jax_rx, port=0, timeout_s=5.0)
    try:
        clock, tel, pool, router = _host()
        ctrl = _ctrl(tel, clock)
        router.join("a")
        router.step({"a": "c0"})
        out = ctrl.migrate_remote(router, "a", SocketTransport(
            lsn.host, lsn.port, timeout_s=5.0, name="jax"))
    finally:
        lsn.close()
    assert out == "remote"
    assert jax_rx.imported_sids == ["a"]
    (sid, snap), = jax_target.imported
    assert sid == "a" and snap.text == "c0" and snap.fed == 64
    with pytest.raises(KeyError):
        router.home_of("a")
