"""The port's crash-durable sessions (``serving/sessionstore.py``): the
snapshot wire codec, the write-ahead ``SessionJournal`` and the
``RecoveryController``, held to the JAX package's.

The first fifteen cases mirror tests/test_sessionstore.py on the port's
classes (the JAX file's every-offset fuzz runs here on a two-record
segment). Then parity with the JAX codec: a greedy snapshot encodes to
the same bytes in both; a beam snapshot's bytes differ only in the
namedtuple's ``module:qualname``; a segment written by either journal
scans to the same entries in the other's ``scan_segment_bytes``; a
JAX-written beam frame is refused by the port as incompatible without
importing ``deepspeech_tpu``. Last, on a tiny f32 ds2_streaming with
bridged weights (the JAX side on its Pallas GRU kernel in interpret
mode): a journaled session recovered after a "crash" continues bit for
bit, and the recovery finals of one crash script equal the JAX
``RecoveryController``'s.
"""

import os
import struct
import subprocess
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeech_tpu.serving import migration as jax_migration
from deepspeech_tpu.serving import sessionstore as jax_store
from deepspeech_tpu_torch.resilience import FaultPlan, FaultSpec, faults
from deepspeech_tpu_torch.serving import (CODEC_VERSION, RecoveryController,
                                          ServingTelemetry, SessionJournal,
                                          SnapshotDecodeError,
                                          SnapshotIncompatible,
                                          StreamSnapshot,
                                          snapshot_from_bytes,
                                          snapshot_to_bytes)
from deepspeech_tpu_torch.serving.sessionstore import (SNAPSHOT_TYPES,
                                                       scan_segment_bytes)

# One CPU thread for torch: parallel test workers share the machine's
# cores, and a thread pool in each worker oversubscribes them.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The child's torch (OpenMP, MKL) holds to one thread, as this process does.
ONE_THREAD = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


def _arrays(seed=7):
    rng = np.random.default_rng(seed)
    return {
        "raw_hist": rng.standard_normal((12, 13)).astype(np.float32),
        "h": tuple(rng.standard_normal((2, 32)).astype(np.float32)
                   for _ in range(2)),
        "la_buf": rng.standard_normal((3, 32)).astype(np.float32),
    }


def _beam_fields():
    return dict(prefixes=np.arange(8 * 4, dtype=np.int32).reshape(8, 4),
                lens=np.ones((8,), np.int32),
                hashes=np.arange(8, dtype=np.uint32),
                p_b=np.zeros((8,), np.float32),
                p_nb=np.full((8,), -1.5, np.float32),
                ctx=np.zeros((8,), np.int32),
                bonus=np.zeros((8,), np.float32))


def _snap(sid="s0", fingerprint="fp", fed=128, raw_len=None, beam=False,
          seed=7, jax_side=False):
    """The JAX test's synthetic snapshot, as the port's StreamSnapshot
    (or, ``jax_side``, the JAX package's, on the same arrays)."""
    decoder = None
    if beam:
        if jax_side:
            from deepspeech_tpu.decode.beam import BeamState
        else:
            from deepspeech_tpu_torch.decode.beam import BeamState
        decoder = BeamState(**_beam_fields())
    cls = jax_migration.StreamSnapshot if jax_side else StreamSnapshot
    return cls(sid=sid, fingerprint=fingerprint, fed=fed, raw_len=raw_len,
               acoustic=_arrays(seed), decoder=decoder, prev_ids=3,
               text="hel")


def _trees_equal(a, b):
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and a.shape == b.shape and np.array_equal(a, b))
    if isinstance(a, dict):
        return (isinstance(b, dict) and set(a) == set(b)
                and all(_trees_equal(a[k], b[k]) for k in a))
    if isinstance(a, tuple):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_trees_equal(x, y) for x, y in zip(a, b)))
    return a == b


# -- the wire codec -----------------------------------------------------------

def test_codec_roundtrip_greedy():
    snap = _snap(raw_len=640)
    out = snapshot_from_bytes(snapshot_to_bytes(snap))
    assert (out.sid, out.fingerprint, out.fed, out.raw_len,
            out.prev_ids, out.text) == ("s0", "fp", 128, 640, 3, "hel")
    assert out.decoder is None
    assert _trees_equal(snap.acoustic, out.acoustic)


def test_codec_roundtrip_beam_namedtuple():
    """The port's BeamState survives the wire: same type, fields, dtypes
    and values (the ``ntup`` node, resolved through the allow-list)."""
    from deepspeech_tpu_torch.decode.beam import BeamState
    snap = _snap(beam=True)
    out = snapshot_from_bytes(snapshot_to_bytes(snap))
    assert type(out.decoder) is BeamState
    assert _trees_equal(tuple(snap.decoder), tuple(out.decoder))


def test_codec_version_skew_is_incompatible_not_decode_error():
    buf = bytearray(snapshot_to_bytes(_snap()))
    struct.pack_into("<H", buf, 4, CODEC_VERSION + 1)
    with pytest.raises(SnapshotIncompatible):
        snapshot_from_bytes(bytes(buf))


def test_codec_corruption_is_decode_error():
    raw = snapshot_to_bytes(_snap())
    flipped = bytearray(raw)
    flipped[len(raw) // 2] ^= 0xFF
    with pytest.raises(SnapshotDecodeError):
        snapshot_from_bytes(bytes(flipped))
    with pytest.raises(SnapshotDecodeError):
        snapshot_from_bytes(raw[:len(raw) - 3])
    with pytest.raises(SnapshotDecodeError):
        snapshot_from_bytes(b"XXXX" + raw[4:])
    assert issubclass(SnapshotDecodeError, ValueError)


def test_codec_rejects_object_dtype():
    snap = _snap()
    snap.acoustic["bad"] = np.array([object()], dtype=object)
    with pytest.raises(ValueError):
        snapshot_to_bytes(snap)


# -- the journal --------------------------------------------------------------

def test_journal_supersede_and_tombstone(tmp_path):
    j = SessionJournal(str(tmp_path / "wal"))
    s1 = j.append("a", snapshot_to_bytes(_snap(sid="a")))
    s2 = j.append("b", snapshot_to_bytes(_snap(sid="b")))
    s3 = j.append("a", snapshot_to_bytes(_snap(sid="a", fed=256)))
    s4 = j.forget("b")
    assert [s1, s2, s3, s4] == [1, 2, 3, 4]
    scan = j.scan()
    assert sorted(scan.live) == ["a"]
    assert scan.live["a"].seq == s3
    assert snapshot_from_bytes(scan.live["a"].data).fed == 256
    assert scan.stale == 2
    assert scan.tombstoned == ["b"]
    assert not scan.torn
    j.close()


def test_journal_seq_resumes_across_reopen(tmp_path):
    path = str(tmp_path / "wal")
    j = SessionJournal(path)
    for _ in range(3):
        j.append("a", snapshot_to_bytes(_snap()))
    j.close()
    j2 = SessionJournal(path)
    assert j2.append("a", snapshot_to_bytes(_snap())) == 4
    assert len(j2.segments()) == 2
    assert len(j2.scan().entries) == 4
    j2.close()


def test_journal_rotation_and_compaction(tmp_path):
    j = SessionJournal(str(tmp_path / "wal"), segment_bytes=256)
    blob = snapshot_to_bytes(_snap())
    for k in range(6):
        j.append(f"s{k % 2}", blob)
    assert len(j.segments()) > 1
    assert j.stats()["rotations"] >= 1
    scan = j.scan()
    assert len(scan.entries) == 6 and len(scan.live) == 2
    assert j.compact() > 0
    scan2 = j.scan()
    assert sorted(scan2.live) == ["s0", "s1"] and scan2.stale == 0
    assert scan2.live["s0"].seq == scan.live["s0"].seq
    j.close()


def test_journal_torn_tail_truncates_cleanly(tmp_path):
    path = str(tmp_path / "wal")
    j = SessionJournal(path)
    j.append("a", snapshot_to_bytes(_snap(sid="a")))
    j.append("b", snapshot_to_bytes(_snap(sid="b")))
    j.close()
    seg = j.segments()[-1]
    data = open(seg, "rb").read()
    open(seg, "wb").write(data[:-7])
    j2 = SessionJournal(path)
    scan = j2.scan()
    assert sorted(scan.live) == ["a"]
    assert len(scan.torn) == 1
    j2.append("c", snapshot_to_bytes(_snap(sid="c")))
    assert sorted(j2.scan().live) == ["a", "c"]
    j2.close()


def _fuzz(data, name, stride):
    starts, pos = [], 6
    while pos + 8 <= len(data):
        starts.append(pos)
        pos += 8 + struct.unpack_from("<I", data, pos)[0]
    ends = [starts[i + 1] if i + 1 < len(starts) else len(data)
            for i in range(len(starts))]
    for t in range(0, len(data) + 1, stride):
        entries, torn_at = scan_segment_bytes(data[:t], name)
        assert len(entries) == sum(1 for e in ends if e <= t), t
        boundary = t == 0 or t == 6 or t in ends
        assert (torn_at is None) == boundary, t


def _fuzz_segment(tmp_path, stride, records):
    j = SessionJournal(str(tmp_path / "wal"))
    for k in range(records):
        j.append(f"s{k}", snapshot_to_bytes(_snap(sid=f"s{k}")))
    j.close()
    _fuzz(open(j.segments()[-1], "rb").read(), "seg", stride)


def test_torn_tail_fuzz_strided(tmp_path):
    """Truncation at strided byte offsets never raises and yields exactly
    the records the prefix still contains."""
    _fuzz_segment(tmp_path, stride=17, records=4)


def test_torn_tail_fuzz_every_offset(tmp_path):
    """Every byte offset, on a segment of two records."""
    _fuzz_segment(tmp_path, stride=1, records=2)


def test_partial_write_fault_tears_then_rotates(tmp_path):
    tel = ServingTelemetry()
    j = SessionJournal(str(tmp_path / "wal"), telemetry=tel)
    j.append("a", snapshot_to_bytes(_snap(sid="a")))
    faults.install(FaultPlan([FaultSpec("journal.append", "partial_write",
                                        prob=1.0, count=1)], registry=tel))
    try:
        j.append("b", snapshot_to_bytes(_snap(sid="b")))
    finally:
        faults.clear()
    j.append("c", snapshot_to_bytes(_snap(sid="c")))
    assert j.torn_writes == 1
    scan = j.scan()
    assert sorted(scan.live) == ["a", "c"]
    assert len(scan.torn) == 1
    assert int(tel.counters.get("journal_torn_writes", 0)) == 1
    j.close()


# -- recovery -----------------------------------------------------------------

class DuckTarget:
    """Recovery target double: records imports and drain-resumes."""

    def __init__(self):
        self.imported = {}
        self.left = []

    def import_session(self, snap, sid=None):
        self.imported[sid or snap.sid] = snap

    def leave(self, sid, tail=None):
        self.left.append(sid)


def test_recovery_outcome_accounting(tmp_path):
    from deepspeech_tpu_torch.obs import timeline as tl_mod
    from deepspeech_tpu_torch.obs.timeline import EventLog

    j = SessionJournal(str(tmp_path / "wal"))
    j.append("ok", snapshot_to_bytes(_snap(sid="ok", fed=64)))
    j.append("ok", snapshot_to_bytes(_snap(sid="ok", fed=128)))
    j.append("garbled", b"not a snapshot frame at all")
    skew = bytearray(snapshot_to_bytes(_snap(sid="skew")))
    struct.pack_into("<H", skew, 4, CODEC_VERSION + 7)
    j.append("skew", bytes(skew))

    tel = ServingTelemetry()
    pm = []
    log = tl_mod.install(EventLog(registry=tel))
    try:
        target = DuckTarget()
        rc = RecoveryController(
            j, telemetry=tel,
            postmortem_fn=lambda kind, trigger="", **kw:
                pm.append((kind, trigger, kw)))
        report = rc.recover(target)
    finally:
        tl_mod.clear()
        j.close()

    assert report["recovered"] == 1 and report["sids"] == ["ok"]
    assert report["torn"] == 1 and report["incompatible"] == 1
    assert report["stale"] == 1
    assert target.imported["ok"].fed == 128
    assert target.left == []
    for outcome, n in (("ok", 1), ("torn", 1), ("incompatible", 1),
                       ("stale", 1)):
        key = f'sessions_recovered{{outcome="{outcome}"}}'
        assert int(tel.counters.get(key, 0)) == n, key
    events = log.recent()
    kinds = [e["kind"] for e in events]
    assert kinds[0] == "recovery" and kinds[-1] == "recovery_done"
    begin = events[0]
    assert begin["detail"]["phase"] == "begin"
    per_sid = [e for e in events if e["kind"] == "recovery"
               and e["detail"].get("phase") == "session"]
    assert {e["detail"]["sid"]: e["detail"]["outcome"]
            for e in per_sid} == {"ok": "ok", "garbled": "torn",
                                  "skew": "incompatible"}
    assert all(e["cause_seq"] == begin["seq"] for e in per_sid)
    assert events[-1]["cause_seq"] == begin["seq"]
    assert [p[0] for p in pm] == ["crash_recovery"]
    assert pm[0][1] == "boot" and pm[0][2]["recovered"] == 1


def test_recovery_resumes_drain_for_ended_sessions(tmp_path):
    j = SessionJournal(str(tmp_path / "wal"))
    j.append("done", snapshot_to_bytes(_snap(sid="done", fed=256,
                                             raw_len=256)))
    j.append("mid", snapshot_to_bytes(_snap(sid="mid", fed=128,
                                            raw_len=256)))
    target = DuckTarget()
    report = RecoveryController(j, postmortem_fn=lambda *a, **k: None
                                ).recover(target)
    j.close()
    assert report["recovered"] == 2
    assert target.left == ["done"]


def test_scan_segment_bytes_degenerate():
    assert scan_segment_bytes(b"", "s") == ([], None)
    entries, torn = scan_segment_bytes(b"XXXXXXXXXX", "s")
    assert entries == [] and torn == 0


# -- parity with the JAX codec ------------------------------------------------

def _frame_parts(data):
    """(header dict, blob bytes) of a snapshot frame."""
    hlen = struct.unpack_from("<I", data, 6)[0]
    import json
    return json.loads(data[10:10 + hlen]), data[10 + hlen:-4]


@pytest.mark.parametrize("raw_len", [None, 640])
def test_greedy_bytes_equal_jax_codec(raw_len):
    port = snapshot_to_bytes(_snap(raw_len=raw_len))
    ref = jax_store.snapshot_to_bytes(_snap(raw_len=raw_len, jax_side=True))
    assert port == ref
    assert jax_store.peek_codec_version(port) == CODEC_VERSION \
        == jax_store.CODEC_VERSION
    # Each side decodes the other's frame to the same snapshot.
    back = jax_store.snapshot_from_bytes(port)
    assert _trees_equal(back.acoustic, _snap().acoustic)
    assert (back.fed, back.raw_len, back.text) == (128, raw_len, "hel")


def test_beam_bytes_differ_only_in_ntup_name():
    """The same beam rows through both codecs: the frames are equal once
    the JAX frame's class name is replaced by the port's (its header
    length and CRC recomputed)."""
    port = snapshot_to_bytes(_snap(beam=True))
    ref = jax_store.snapshot_to_bytes(_snap(beam=True, jax_side=True))
    assert port != ref
    header, blobs = _frame_parts(ref)
    assert header["decoder"]["ntup"] == \
        "deepspeech_tpu.decode.beam:BeamState"
    header["decoder"]["ntup"] = "deepspeech_tpu_torch.decode.beam:BeamState"
    assert list(SNAPSHOT_TYPES) == [header["decoder"]["ntup"]]
    import json
    hj = json.dumps(header, ensure_ascii=False).encode("utf-8")
    body = struct.pack("<H", CODEC_VERSION) + struct.pack("<I", len(hj)) \
        + hj + blobs
    assert port == b"DS2S" + body + struct.pack("<I", zlib.crc32(body))
    assert _frame_parts(port)[1] == blobs


def _entries(entries):
    return [(e.offset, e.sid, e.seq, e.kind, e.nbytes, e.data)
            for e in entries]


def _write_journal(store, path, snap_fn):
    j = store.SessionJournal(path, segment_bytes=1 << 20)
    j.append("a", store.snapshot_to_bytes(snap_fn("a", 64)))
    j.append("b", store.snapshot_to_bytes(snap_fn("b", 64)))
    j.append("a", store.snapshot_to_bytes(snap_fn("a", 128)))
    j.forget("b")
    j.close()
    with open(j.segments()[-1], "rb") as fh:
        return fh.read()


def test_segments_scan_alike_in_both_packages(tmp_path):
    """A segment the port's journal writes scans in the JAX
    ``scan_segment_bytes`` to the same entries, and the reverse; the two
    journals write the same bytes for the same greedy records."""
    port = _write_journal(
        __import__("deepspeech_tpu_torch.serving.sessionstore",
                   fromlist=["x"]), str(tmp_path / "port"),
        lambda sid, fed: _snap(sid=sid, fed=fed))
    ref = _write_journal(jax_store, str(tmp_path / "jax"),
                         lambda sid, fed: _snap(sid=sid, fed=fed,
                                                jax_side=True))
    assert port == ref
    for data in (port, ref):
        got, torn = scan_segment_bytes(data, "seg")
        want, want_torn = jax_store.scan_segment_bytes(data, "seg")
        assert torn is None and want_torn is None
        assert _entries(got) == _entries(want) and len(got) == 4
    # Torn alike too.
    got, torn = scan_segment_bytes(port[:-9], "seg")
    want, want_torn = jax_store.scan_segment_bytes(port[:-9], "seg")
    assert _entries(got) == _entries(want) and torn == want_torn


def test_jax_beam_frame_incompatible_without_importing_jax_package(
        tmp_path):
    """A beam frame the JAX codec wrote names
    ``deepspeech_tpu.decode.beam:BeamState``: the port refuses it as
    incompatible (the recovery outcome ``incompatible``), and neither
    ``deepspeech_tpu`` nor ``jax`` is imported by the decode."""
    path = tmp_path / "beam.bin"
    path.write_bytes(jax_store.snapshot_to_bytes(
        _snap(beam=True, jax_side=True)))
    code = (
        "import sys\n"
        "from deepspeech_tpu_torch.serving import sessionstore as s\n"
        "from deepspeech_tpu_torch.serving.migration import "
        "SnapshotIncompatible\n"
        f"data = open({str(path)!r}, 'rb').read()\n"
        "try:\n"
        "    s.snapshot_from_bytes(data)\n"
        "    print('decoded')\n"
        "except SnapshotIncompatible as e:\n"
        "    print('incompatible', 'not one of' in str(e))\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'deepspeech_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=ONE_THREAD)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[:2] == ["incompatible True", "[]"]


def test_unlisted_namedtuple_refused_in_process(monkeypatch):
    """Any ``ntup`` name off the allow-list raises before an import."""
    import importlib
    frame = jax_store.snapshot_to_bytes(_snap(beam=True, jax_side=True))
    calls = []
    real = importlib.import_module
    monkeypatch.setattr(importlib, "import_module",
                        lambda name, *a: calls.append(name) or real(name, *a))
    with pytest.raises(SnapshotIncompatible, match="not reconstructable"):
        snapshot_from_bytes(frame)
    assert calls == []


# -- model-backed recovery ----------------------------------------------------

NF = 32
OVER = {"model.rnn_hidden": "32", "model.rnn_layers": "2",
        "model.conv_channels": "4,4", "model.lookahead_context": "4",
        "model.dtype": "float32", "model.rnn_impl": "pallas",
        "features.num_features": str(NF)}


@pytest.fixture(scope="module")
def tiny():
    from deepspeech_tpu.config import apply_overrides as jax_apply_overrides
    from deepspeech_tpu.config import get_config as jax_get_config
    from deepspeech_tpu.models import create_model as jax_create_model
    from deepspeech_tpu_torch.config import apply_overrides, get_config
    from test_torch_model import random_flax_variables

    jcfg = jax_apply_overrides(jax_get_config("ds2_streaming"), OVER)
    tcfg = apply_overrides(get_config("ds2_streaming"), OVER)
    params, stats = random_flax_variables(
        jax_create_model(jcfg.model), jnp.zeros((1, 64, NF), jnp.float32),
        jnp.full((1,), 64, jnp.int32), np.random.default_rng(7))
    params = jax.tree.map(np.asarray, params)
    params["head"]["kernel"] = params["head"]["kernel"] * 8.0
    return jcfg, tcfg, params, stats


def _feat(n, seed):
    return np.random.default_rng(seed).standard_normal((n, NF)).astype(
        np.float32)


def _port_mgr(tiny, **kw):
    from deepspeech_tpu_torch.data import CharTokenizer
    from deepspeech_tpu_torch.serving.session import StreamingSessionManager
    _, tcfg, params, stats = tiny
    return StreamingSessionManager(tcfg, params, stats,
                                   CharTokenizer.english(), chunk_frames=64,
                                   device="cpu", **kw)


def _jax_mgr(tiny, **kw):
    from deepspeech_tpu.data import CharTokenizer as JaxCharTokenizer
    from deepspeech_tpu.serving.session import \
        StreamingSessionManager as JaxSessionManager
    jcfg, _, params, stats = tiny
    return JaxSessionManager(jcfg, params, stats,
                             JaxCharTokenizer.english(), chunk_frames=64,
                             **kw)


FEEDS = {"a": _feat(64 * 5, 1), "b": _feat(64 * 3, 2), "c": _feat(64 * 4, 3)}


def _crash_script(make_mgr, journal, recover):
    """Three sessions journaled every chunk; "c" joins late and "b"
    ends (its drain starts) just before the process dies after three
    chunks. A fresh manager recovers the journal, the survivors drain,
    and their finals come back (with the recovery report)."""
    mgr = make_mgr(capacity=2, journal=journal, journal_every=1)
    mgr.join("a")
    mgr.join("b")
    mgr.step({"a": FEEDS["a"][:64], "b": FEEDS["b"][:64]})
    mgr.join("c")
    mgr.step({"a": FEEDS["a"][64:128], "b": FEEDS["b"][64:128],
              "c": FEEDS["c"][:64]})
    mgr.step({"a": FEEDS["a"][128:192], "b": FEEDS["b"][128:192],
              "c": FEEDS["c"][64:128]})
    mgr.leave("b")
    del mgr                                   # the crash
    rec = make_mgr(capacity=4, journal=journal, journal_every=1)
    report = recover(rec)
    for sid in report["sids"]:
        if not rec._sessions[sid].draining:
            rec.leave(sid)
    rec.flush()
    return report, {sid: rec.final(sid) for sid in report["sids"]}


def test_recovered_session_continues_bit_identically(tiny, tmp_path):
    """Crash after two chunks, recover into a cold manager, feed the
    rest: the final equals the never-crashed stream's, and the journal
    holds a tombstone for it afterwards."""
    journal = SessionJournal(str(tmp_path / "wal"))
    mgr = _port_mgr(tiny, capacity=1, journal=journal)
    mgr.join("x")
    f = FEEDS["a"]
    for i in range(2):
        mgr.step({"x": f[i * 64:(i + 1) * 64]})
    del mgr
    rec = _port_mgr(tiny, capacity=1, journal=journal)
    report = RecoveryController(journal, postmortem_fn=lambda *a, **k: None
                                ).recover(rec)
    assert report["sids"] == ["x"] and report["recovered"] == 1
    for i in range(2, 5):
        rec.step({"x": f[i * 64:(i + 1) * 64]})
    rec.leave("x")
    rec.flush()
    ref = _port_mgr(tiny, capacity=1)
    ref.join("x")
    for i in range(5):
        ref.step({"x": f[i * 64:(i + 1) * 64]})
    ref.leave("x")
    ref.flush()
    assert rec.final("x") == ref.final("x")
    assert journal.scan().live == {}
    journal.close()


def test_recovery_finals_match_jax_recovery_controller(tiny, tmp_path):
    """One crash script through both packages' managers, journals and
    recovery controllers on the same weights: the same sessions come
    back, with the same outcomes and identical transcripts."""
    pj = SessionJournal(str(tmp_path / "port"))
    port_report, port_finals = _crash_script(
        lambda **kw: _port_mgr(tiny, **kw), pj,
        lambda rec: RecoveryController(
            pj, postmortem_fn=lambda *a, **k: None).recover(rec))
    jj = jax_store.SessionJournal(str(tmp_path / "jax"))
    jax_report, jax_finals = _crash_script(
        lambda **kw: _jax_mgr(tiny, **kw), jj,
        lambda rec: jax_store.RecoveryController(
            jj, postmortem_fn=lambda *a, **k: None).recover(rec))
    for key in ("recovered", "torn", "incompatible", "stale", "sids"):
        assert port_report[key] == jax_report[key], key
    assert sorted(port_report["sids"]) == ["a", "b", "c"]
    assert port_finals == jax_finals and any(port_finals.values())
    pj.close()
    jj.close()
