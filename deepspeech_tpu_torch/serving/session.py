"""Streaming session manager: live streams join/leave a running batch.

The port of the JAX package's ``serving/session.py``. The manager owns
ONE batched :class:`~..streaming.StreamingTranscriber` state whose B
rows are *slots*; live sessions map onto slots and the
batch advances in lockstep chunks regardless of who is connected:

- **join mid-flight**: a new session takes a free slot — the slot's
  state rows are zeroed and its ``raw_start`` is set to the batch's
  current raw clock, which the chunk function masks like the pre-stream
  warmup, so the newcomer decodes as a stream that had the batch to
  itself. Only when NO slot is free does capacity grow to the next
  power-of-two rung (``batch_rung``, counted); churn at a stable
  connection count is slot reuse.
- **leave**: the session's true length is recorded (mask-held from then
  on) and the slot *drains* — later lockstep steps flush the
  conv/lookahead lag until the final frames have emerged, then the
  transcript is finalized and the slot frees. Capacity never shrinks.
- **export / import**: a live session's slot rows leave as a host-numpy
  :class:`~.migration.StreamSnapshot` and continue in another manager
  of the same fingerprint, re-based onto its clock.

Decode modes: ``greedy`` (the incremental CTC collapse on the host) or
``beam`` (a :class:`~..streaming.StreamingBeamDecoder` whose batched
state stays on the device, optionally LM-fused by ``lm_table``); the
beam rows of a slot are re-initialised on join and on a segment reset,
its partial is the plausible beams' common prefix, and a snapshot
carries them as host numpy.
Telemetry (slot reuse vs grow, occupancy, active sessions) lands in a
:class:`~.telemetry.ServingTelemetry`.

Crash durability: give the manager a
:class:`~.sessionstore.SessionJournal` and it checkpoints every attached
session every ``journal_every`` chunks, at ``leave()`` (drain start) and
at ``import_session`` (a handoff arrival is durable at its new home at
once), then tombstones it at finalize.
:class:`~.sessionstore.RecoveryController` replays the journal after a
crash through ``import_session``, the re-basing path live migration
uses, so the recovered continuation is bit-identical.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import obs
from ..data.infer_bucket import batch_rung
from ..decode.beam import set_rows, state_rows
from ..streaming import (_BIG, CONV_LAG, StreamingBeamDecoder,
                         StreamingTranscriber, StreamState)
from .migration import SnapshotIncompatible, StreamSnapshot
from .telemetry import ServingTelemetry


@dataclasses.dataclass
class _Session:
    sid: str
    slot: int
    raw_start: int          # global raw-frame index of the first frame
    fed: int = 0            # raw frames fed so far
    raw_len: Optional[int] = None  # session-relative length once known
    draining: bool = False
    # Raw clock at leave(): the drain latency (finalize - leave).
    left_clock: Optional[int] = None


def _host(t: torch.Tensor) -> np.ndarray:
    """A host numpy copy that shares no memory with the state."""
    return t.detach().cpu().numpy().copy()


class StreamingSessionManager:
    """See module docstring. Lockstep pump::

        mgr = StreamingSessionManager(cfg, params, stats, tok,
                                      chunk_frames=64)
        mgr.join("a")                       # before any step
        partials = mgr.step({"a": chunk})   # every active sid, every step
        mgr.join("b")                       # mid-flight: slot + raw_start
        partials = mgr.step({"a": c2, "b": c0})
        mgr.leave("a", tail=last_frames)    # starts the drain
        mgr.step({"b": c1}); ...            # "a" finalizes when flushed
        mgr.flush()                         # zero-feed the stragglers
        text = mgr.final("a")

    ``device`` and ``quantize`` as ``StreamingTranscriber`` takes them;
    ``decode="beam"`` searches with ``cfg.decode``'s beam width, top-P
    and merge and ``data.max_label_len``, fused with ``lm_table`` when
    one is given (``ngram.fusion_table_for``).
    """

    def __init__(self, cfg, params, batch_stats, tokenizer, *,
                 chunk_frames: int = 64, decode: str = "greedy",
                 lm_table=None, quantize: str = "", capacity: int = 1,
                 telemetry: Optional[ServingTelemetry] = None,
                 journal=None, journal_every: int = 1, device=None):
        if decode not in ("greedy", "beam"):
            raise ValueError(f"decode={decode!r}")
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.decode = decode
        self.st = StreamingTranscriber(cfg, params, batch_stats, tokenizer,
                                       chunk_frames=chunk_frames,
                                       quantize=quantize, device=device)
        self.chunk_frames = chunk_frames
        self.num_features = cfg.features.num_features
        # Raw-frame lag between audio in and final logits out: the
        # drain horizon for a leaving session.
        self.lag_raw = 2 * (CONV_LAG + max(cfg.model.lookahead_context - 1,
                                           0))
        self.capacity = batch_rung(max(capacity, 1))
        self.state = self.st.init_state(batch=self.capacity)
        # Free slots are dummy streams: raw_len 0 masks every frame.
        self.state.raw_len.zero_()
        self.bd = None
        self.bstate = None
        if decode == "beam":
            d = cfg.decode
            self.bd = StreamingBeamDecoder(
                beam_width=d.beam_width, max_len=cfg.data.max_label_len,
                prune_top_k=d.prune_top_k, lm_table=lm_table,
                merge_impl=d.merge_impl, device=self.st.device)
            self.bstate = self.bd.init(batch=self.capacity)
        self._prev_ids = np.zeros((self.capacity,), np.int64)
        self._texts = [""] * self.capacity
        self.clock = 0          # global raw frames advanced so far
        self._sessions: Dict[str, _Session] = {}
        self._by_slot: Dict[int, _Session] = {}
        self._tails: Dict[int, np.ndarray] = {}
        self._finals: Dict[str, str] = {}
        self._final_nbest: Dict[str, List[tuple]] = {}
        self.grows = 0
        # One record per capacity grow: when on the raw-frame clock, the
        # rung jump, and the live-session count that forced it.
        self.grow_events: List[dict] = []
        self.reuses = 0
        self.telemetry = telemetry if telemetry is not None \
            else ServingTelemetry()
        self.telemetry.gauge("capacity", self.capacity)
        # Write-ahead durability (see .sessionstore): _last_ckpt holds
        # each session's fed frames at its last checkpoint.
        self.journal = journal
        self.journal_every = max(int(journal_every), 1)
        self._last_ckpt: Dict[str, int] = {}

    # -- capacity -------------------------------------------------------
    def _grow(self, need: int) -> None:
        """Pad every batched row-axis to the next rung (counted)."""
        new_cap = batch_rung(need)
        add = new_cap - self.capacity
        if add <= 0:
            return
        s = self.state

        def zrow(a):
            return torch.cat([a, a.new_zeros((add,) + a.shape[1:])])

        self.state = StreamState(
            raw_hist=zrow(s.raw_hist), h=tuple(zrow(h) for h in s.h),
            la_buf=zrow(s.la_buf), emitted=s.emitted,
            raw_len=zrow(s.raw_len), raw_start=zrow(s.raw_start))
        if self.bd is not None:
            fresh = self.bd.init(batch=add)
            self.bstate = type(self.bstate)(*(
                torch.cat([old, ini]) for old, ini in zip(self.bstate,
                                                          fresh)))
        self._prev_ids = np.concatenate(
            [self._prev_ids, np.zeros((add,), np.int64)])
        self._texts.extend([""] * add)
        old_cap = self.capacity
        self.capacity = new_cap
        self.grows += 1
        self.grow_events.append({
            "clock_frames": self.clock,
            "from_capacity": old_cap,
            "to_capacity": new_cap,
            "active_sessions": len(self._by_slot) + 1,  # incl. joiner
        })
        self.telemetry.count("capacity_grows")
        self.telemetry.gauge("capacity", self.capacity)

    def _free_slot(self) -> Optional[int]:
        for slot in range(self.capacity):
            if slot not in self._by_slot:
                return slot
        return None

    def _take_slot(self) -> int:
        slot = self._free_slot()
        if slot is None:
            self._grow(len(self._by_slot) + 1)
            return self._free_slot()
        if self.clock:
            self.reuses += 1
            self.telemetry.count("slot_reuses")
        return slot

    def _set_rows(self, slot: int, raw_start: int, end: int,
                  raw_hist=0.0, h=None, la_buf=0.0) -> None:
        """Write one slot's state rows (zeros unless given) and stamp its
        two-sided validity window ``[raw_start, end)``."""
        s = self.state
        with torch.no_grad():
            s.raw_hist[slot] = torch.as_tensor(raw_hist)
            for i, row in enumerate(s.h):
                row[slot] = torch.as_tensor(0.0 if h is None else h[i])
            s.la_buf[slot] = torch.as_tensor(la_buf)
            s.raw_len[slot] = end
            s.raw_start[slot] = raw_start

    # -- session lifecycle ----------------------------------------------
    def join(self, sid: str, raw_len: Optional[int] = None) -> int:
        """Attach a session; returns its slot. ``raw_len`` may be given
        up front (file replay) so padding is masked immediately; a live
        feed leaves it None and supplies the length via ``leave``.
        Joins happen at chunk boundaries, so ``raw_start`` (the batch's
        raw clock) is chunk-aligned and even."""
        if sid in self._sessions:
            raise ValueError(f"session {sid!r} already attached")
        slot = self._take_slot()
        sess = _Session(sid=sid, slot=slot, raw_start=self.clock,
                        raw_len=raw_len)
        self._sessions[sid] = sess
        self._by_slot[slot] = sess
        # Zero the slot's acoustic state: everything before raw_start is
        # masked like pre-stream warmup, so a reused slot's stale
        # history is unreachable.
        end = _BIG if raw_len is None else self.clock + int(raw_len)
        self._set_rows(slot, self.clock, end)
        self._reset_decoder_slots([slot])
        self.telemetry.count("sessions_joined")
        self.telemetry.gauge("active_sessions", len(self._sessions))
        return slot

    def leave(self, sid: str, tail=None) -> None:
        """Close a session's input. ``tail`` is the final partial chunk
        ([< chunk_frames, F]), fed on the next step. The slot drains:
        it frees (and the transcript finalizes) once the lag flushes —
        run ``step``/``flush`` until then."""
        sess = self._sessions[sid]
        if sess.draining:
            raise ValueError(f"session {sid!r} already draining")
        n_tail = 0
        if tail is not None:
            tail = np.asarray(tail, np.float32)
            if tail.ndim != 2 or tail.shape[0] >= self.chunk_frames:
                raise ValueError(
                    f"tail must be [<{self.chunk_frames}, F], "
                    f"got {tail.shape}")
            n_tail = tail.shape[0]
            if n_tail:
                self._tails[sess.slot] = tail
        if sess.raw_len is None:
            sess.raw_len = sess.fed + n_tail
            self.state.raw_len[sess.slot] = sess.raw_start + sess.raw_len
        # Drain-start checkpoint: the record carries the now known
        # raw_len, so recovery resumes the drain. A pending tail is
        # frames the snapshot does not carry: the last in-stream
        # checkpoint stands instead.
        if n_tail == 0:
            self._checkpoint(sid)
        sess.draining = True
        sess.left_clock = self.clock
        self.telemetry.count("sessions_left")

    def _finalize(self, sess: _Session) -> None:
        nbest = self._slot_nbest(sess.slot)
        self._finals[sess.sid] = nbest[0][0]
        self._final_nbest[sess.sid] = nbest
        del self._sessions[sess.sid]
        del self._by_slot[sess.slot]
        self._tails.pop(sess.slot, None)
        self._last_ckpt.pop(sess.sid, None)
        if self.journal is not None:
            # Tombstone: recovery never replays a finished session.
            self.journal.forget(sess.sid)
        self.telemetry.count("sessions_finalized")
        # How many raw frames of lockstep flushing the transcript waited
        # on after leave(), and the session's fed frames, each with the
        # sid as exemplar so the histogram max names its worst session.
        if sess.left_clock is not None:
            self.telemetry.observe("session_drain_frames",
                                   self.clock - sess.left_clock,
                                   exemplar=f"sess:{sess.sid}")
        self.telemetry.observe("session_fed_frames", sess.fed,
                               exemplar=f"sess:{sess.sid}")
        self.telemetry.gauge("active_sessions", len(self._sessions))

    def final(self, sid: str) -> str:
        """Finalized transcript of a fully drained session."""
        if sid not in self._finals:
            raise KeyError(f"session {sid!r} not finalized "
                           "(still draining? call step()/flush())")
        return self._finals[sid]

    def _slot_nbest(self, slot: int) -> List[tuple]:
        """The slot's hypotheses ``[(text, score)]``, best first. Beam
        mode decodes the W carried beams, each text once at its best
        (first) occurrence (dead slots can carry a prefix twice), with
        the beam's combined score (the LM bonus in it when fusing);
        greedy has one hypothesis, scored 0.0."""
        if self.bd is None:
            return [(self._texts[slot], 0.0)]
        prefixes, lens, scores = (a[slot].cpu().numpy()
                                  for a in self.bd.result(self.bstate))
        out: List[tuple] = []
        seen = set()
        for w in range(prefixes.shape[0]):
            text = self.tokenizer.decode(prefixes[w, :lens[w]])
            if text in seen:
                continue
            seen.add(text)
            out.append((text, float(scores[w])))
        return out

    def final_nbest(self, sid: str) -> List[tuple]:
        """Hypothesis list ``[(text, score)]`` of a fully drained
        session, best first; ``final(sid)`` is entry 0's text. Greedy
        has exactly one, scored 0.0."""
        if sid not in self._final_nbest:
            raise KeyError(f"session {sid!r} not finalized "
                           "(still draining? call step()/flush())")
        return self._final_nbest[sid]

    # -- migration (snapshot/handoff plane) ------------------------------
    def snapshot_fingerprint(self) -> str:
        """Config fingerprint a snapshot must match to restore here: the
        decode mode, chunk geometry, feature width, recurrent stack,
        conv tower, lookahead and dtype, and in beam mode the beam's
        width and length. Weights are not in it."""
        m = self.cfg.model
        parts = [
            f"decode={self.decode}",
            f"chunk={self.chunk_frames}",
            f"feat={self.num_features}",
            f"rnn={m.rnn_type}x{m.rnn_layers}x{m.rnn_hidden}",
            f"conv={tuple(m.conv_channels)}",
            f"la={m.lookahead_context}",
            f"dtype={m.dtype}",
        ]
        if self.bd is not None:
            parts.append(f"beam={self.bd.beam_width}"
                         f"x{self.cfg.data.max_label_len}")
        return "|".join(parts)

    def snapshot_session(self, sid: str) -> StreamSnapshot:
        """Portable snapshot of an attached session WITHOUT detaching
        it (a pure read; the slot keeps streaming). Its arrays are host
        numpy copies: the acoustic rows, and the beam state's rows
        (beam) or the greedy prev-id and partial text."""
        sess = self._sessions[sid]
        slot = sess.slot
        s = self.state
        acoustic = {
            "raw_hist": _host(s.raw_hist[slot]),
            "h": tuple(_host(h[slot]) for h in s.h),
            "la_buf": _host(s.la_buf[slot]),
        }
        if self.bd is not None:
            return StreamSnapshot(
                sid=sid, fingerprint=self.snapshot_fingerprint(),
                fed=sess.fed, raw_len=sess.raw_len, acoustic=acoustic,
                decoder=state_rows(self.bstate, slot))
        return StreamSnapshot(
            sid=sid, fingerprint=self.snapshot_fingerprint(),
            fed=sess.fed, raw_len=sess.raw_len, acoustic=acoustic,
            prev_ids=int(self._prev_ids[slot]), text=self._texts[slot])

    def _checkpoint(self, sid: str) -> None:
        """Journal the session's current snapshot (journal mode only)."""
        if self.journal is None:
            return
        self.journal.append(sid, self.snapshot_session(sid))
        self._last_ckpt[sid] = self._sessions[sid].fed

    def export_session(self, sid: str, *,
                       forget: bool = False) -> StreamSnapshot:
        """Snapshot a LIVE session's slot and free the slot at once, with
        no conv/lookahead drain. Draining sessions are refused: their
        remaining work is a local flush, cheaper than any transfer.

        ``forget=True`` also tombstones the session's journal record:
        the export hands ownership out of this process (a remote
        handoff past its ACK), so a later recovery here must not
        resurrect it. The default keeps the record: an in-process
        handoff stays covered until its new home checkpoints."""
        sess = self._sessions[sid]
        if sess.draining:
            raise ValueError(f"session {sid!r} is draining; only live "
                             "sessions migrate")
        snap = self.snapshot_session(sid)
        self._last_ckpt.pop(sid, None)
        del self._sessions[sid]
        del self._by_slot[sess.slot]
        # raw_len 0 masks the stale rows exactly like a free slot.
        self.state.raw_len[sess.slot] = 0
        if forget and self.journal is not None:
            self.journal.forget(sid)
        self.telemetry.count("sessions_exported")
        self.telemetry.gauge("active_sessions", len(self._sessions))
        return snap

    def import_session(self, snap: StreamSnapshot,
                       sid: Optional[str] = None) -> int:
        """Install an exported session into a free slot; returns it.

        ``raw_start`` is re-based against THIS manager's clock:
        ``raw_start' = clock - fed`` keeps ``clock - raw_start = fed``,
        and every per-slot quantity of the chunk function is a function
        of that difference, so the continuation decodes as the
        never-migrated stream. A negative re-based start is fine: it
        stays even, and the validity clamps saturate alike."""
        sid = snap.sid if sid is None else sid
        if sid in self._sessions:
            raise ValueError(f"session {sid!r} already attached")
        want = self.snapshot_fingerprint()
        if snap.fingerprint != want:
            raise SnapshotIncompatible(
                f"snapshot fingerprint {snap.fingerprint!r} does not "
                f"match target {want!r}")
        if self.bd is not None:
            # The rows must fit the beam state as they are: a snapshot
            # whose decoder geometry differs is refused before any slot
            # is taken.
            want_shapes = [tuple(f.shape[1:]) for f in self.bstate]
            got = snap.decoder
            got_shapes = (None if got is None or len(got) != len(want_shapes)
                          else [tuple(np.shape(r)) for r in got])
            if got_shapes != want_shapes:
                raise SnapshotIncompatible(
                    f"snapshot beam rows {got_shapes} do not fit the "
                    f"beam state's {want_shapes}")
        slot = self._take_slot()
        raw_start = self.clock - snap.fed
        end = _BIG if snap.raw_len is None else raw_start + int(snap.raw_len)
        a = snap.acoustic
        self._set_rows(slot, raw_start, end, a["raw_hist"], a["h"],
                       a["la_buf"])
        if self.bd is not None:
            set_rows(self.bstate, slot, snap.decoder)
        else:
            self._prev_ids[slot] = snap.prev_ids
            self._texts[slot] = snap.text
        sess = _Session(sid=sid, slot=slot, raw_start=raw_start,
                        fed=snap.fed, raw_len=snap.raw_len)
        self._sessions[sid] = sess
        self._by_slot[slot] = sess
        self.telemetry.count("sessions_imported")
        self.telemetry.gauge("active_sessions", len(self._sessions))
        # Arrival checkpoint: a handed-off session is durable at its new
        # home the moment the import lands.
        self._checkpoint(sid)
        return slot

    # -- lockstep advance ------------------------------------------------
    def step(self, chunks: Optional[Dict[str, np.ndarray]] = None
             ) -> Dict[str, str]:
        """Advance every slot by one chunk. ``chunks`` maps sid ->
        [chunk_frames, F] features and must cover exactly the active
        (non-draining) sessions; draining slots are fed their stashed
        tail then zeros; free slots are zeros (masked). Returns partial
        transcripts for attached sessions."""
        chunks = chunks or {}
        active = {sid for sid, s in self._sessions.items()
                  if not s.draining}
        if set(chunks) != active:
            raise ValueError(
                f"step() needs exactly the active sessions "
                f"{sorted(active)}, got {sorted(chunks)}")
        k = self.chunk_frames
        batch = np.zeros((self.capacity, k, self.num_features), np.float32)
        for sid, chunk in chunks.items():
            chunk = np.asarray(chunk, np.float32)
            if chunk.shape != (k, self.num_features):
                raise ValueError(
                    f"chunk for {sid!r} must be [{k}, "
                    f"{self.num_features}], got {chunk.shape}")
            sess = self._sessions[sid]
            batch[sess.slot] = chunk
            sess.fed += k
        for slot, tail in list(self._tails.items()):
            batch[slot, :tail.shape[0]] = tail
            self._by_slot[slot].fed += tail.shape[0]
            del self._tails[slot]
        with obs.span("gateway.session_step", capacity=self.capacity,
                      active=len(self._by_slot)):
            self.state, logits, valid = self.st.process_chunk(self.state,
                                                              batch)
        self.clock += k
        if self.bd is not None:
            self.bstate = self.bd.advance(self.bstate, logits, valid)
        else:
            self._prev_ids, new = self.st.decode_incremental(
                self._prev_ids, logits, valid)
            self._texts = [a + n for a, n in zip(self._texts, new)]
        if self.journal is not None:
            for sid in chunks:
                sess = self._sessions.get(sid)
                if sess is not None and not sess.draining and \
                        sess.fed - self._last_ckpt.get(sid, 0) \
                        >= self.journal_every * k:
                    self._checkpoint(sid)
        # Drained sessions: every real frame's logits have emerged once
        # the clock passes the stream end by the conv+lookahead lag.
        for sess in list(self._by_slot.values()):
            if (sess.draining and sess.slot not in self._tails
                    and self.clock >= sess.raw_start + sess.raw_len
                    + self.lag_raw):
                self._finalize(sess)
        if self._by_slot:
            self.telemetry.observe(
                "slot_occupancy", len(self._by_slot) / self.capacity)
        return self.partials()

    def flush(self, max_steps: int = 1000) -> None:
        """Zero-feed until every draining session finalizes. Only legal
        when no session is still live (they would be fed silence)."""
        live = [s.sid for s in self._sessions.values() if not s.draining]
        if live:
            raise ValueError(f"flush() with live sessions {live}; "
                             "leave() them first")
        steps = 0
        while any(s.draining for s in self._sessions.values()):
            if steps >= max_steps:
                raise RuntimeError("flush() did not converge")
            self.step({})
            steps += 1

    # -- transcripts -----------------------------------------------------
    def current_texts(self) -> List[str]:
        """Per-slot best transcript of the in-flight segment (beam: the
        top beam, one host copy of it)."""
        if self.bd is None:
            return list(self._texts)
        prefixes, lens, _ = self.bd.result(self.bstate)
        prefixes, lens = prefixes[:, 0].cpu().numpy(), lens[:, 0].cpu().numpy()
        return [self.tokenizer.decode(prefixes[s, :lens[s]])
                for s in range(self.capacity)]

    def stable_texts(self) -> List[str]:
        """Per-slot STABLE partial transcript: beam mode commits only
        the plausible beams' common prefix; greedy's running collapse
        never retracts, so it is the current one."""
        if self.bd is None:
            return list(self._texts)
        ids, lens = self.bd.stable_prefix(self.bstate)
        return [self.tokenizer.decode(ids[s, :lens[s]])
                for s in range(self.capacity)]

    def partials(self) -> Dict[str, str]:
        """Stable partial transcript per attached session."""
        by_slot = self.stable_texts()
        return {sid: by_slot[s.slot] for sid, s in self._sessions.items()}

    def _reset_decoder_slots(self, slots: Sequence[int]) -> None:
        if self.bd is not None:
            mask = np.zeros((self.capacity,), bool)
            mask[list(slots)] = True
            self.bstate = self.bd.reset_streams(self.bstate, mask)
        else:
            for s in slots:
                self._texts[s] = ""
                self._prev_ids[s] = 0

    def reset_decoders(self, sids: Sequence[str]) -> None:
        """Restart the decoder of the given sessions (segment
        endpointing); acoustic state flows on untouched."""
        self._reset_decoder_slots([self._sessions[x].slot for x in sids])

    # -- observability ---------------------------------------------------
    def slot_of(self, sid: str) -> int:
        return self._sessions[sid].slot

    def stats(self) -> dict:
        return {
            "capacity": self.capacity,
            "active": len(self._sessions),
            "draining": sum(s.draining
                            for s in self._sessions.values()),
            "grows": self.grows,
            "slot_reuses": self.reuses,
            "clock_frames": self.clock,
        }
