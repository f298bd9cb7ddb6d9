"""Live-transcription entry point: stream WAV files as if live.

The port of the JAX package's ``serve.py`` single-model path: it feeds
audio chunk by chunk through a
:class:`~.serving.session.StreamingSessionManager` and prints one JSON
line per chunk with the current partial transcripts, then the finals:
``--decode=greedy`` through the incremental collapse, ``--decode=beam``
through the carried on-device beam state with stable-prefix partials,
LM-fused on the device when ``--decode.lm_path`` names an ARPA file
(the dense or hashed table of ``decode.device_lm_impl``).

CLI: ``python -m deepspeech_tpu_torch.serve --config=ds2_streaming
(--checkpoint-dir=DIR | --params=x.npz) wav1.wav [wav2.wav ...]
[--chunk-frames=64] [--vocab=V] [--decode=greedy|beam]
[--endpoint-silence-ms=N [--endpoint-silence-db=40]]
[--quantize-weights=int8 | --quant-tier=premium|bulk]
[--replicas=N [--migrate-sessions]] [--lm-rescore]
[--swap-checkpoint=DIR [--swap-at-chunk=K] [--swap-wer-guardrail=W]]
[--autoscale [--autoscale-min=1] [--autoscale-max=0]
[--autoscale-cooldown=1.0]] [--models=a=DIR,b=DIR
[--tenant-config=tenants.json]] [--status-port=P] [--timeline=PATH]
[--device=cpu] [--section.key=value ...]``

All streams advance together as one batch, padded to the power-of-two
rung of the shape ladder (``data/infer_bucket.batch_rung``) with masked
dummy streams.

Continuous audio: ``--endpoint-silence-ms=N`` (off by default) turns on
energy-based silence endpointing — when a stream has seen speech and
then at least N ms of audio below ``--endpoint-silence-db`` (dB under
that stream's running peak), the current segment is finalized (a
``"segment"`` JSONL record), the stream's decoder restarts, and
decoding continues into the next segment with the acoustic state (conv
history, RNN carries) flowing on.

Multi-replica serving: ``--replicas=N`` (N > 1) hosts the streams on a
:class:`~.serving.pool.ReplicaPool` of N replicas, each with its own
:class:`~.serving.session.StreamingSessionManager` — sessions pin to a
replica by consistent hash and re-pin behind a drain window if a
replica's breaker opens (``serving/pool.py``). Each stream feeds only
its own chunks (the tail chunk is zero-padded instead of
length-masked), and endpointing is single-replica-only, so
``--replicas`` composes with the plain streaming path, not with
``--endpoint-silence-ms``. ``--migrate-sessions`` moves a session off a
draining replica by snapshot (``serving/migration.py``) instead of
waiting out the drain: same segment, the same transcript.

Quality tiers: ``--quant-tier=premium`` serves full-precision (bf16)
weights with beam decoding, ``bulk`` int8 PTQ with greedy decoding;
each overrides ``--decode`` and ``--quantize-weights``.

Rolling model swap: ``--swap-checkpoint=DIR`` (requires
``--replicas >= 2``) upgrades the live pool to a second checkpoint's
weights mid-stream through :class:`~.serving.rollout.RolloutController`
— one replica at a time: drain behind the normal window, shadow-canary
the new weights against the old on the opening chunks of the first wav
(accepted bit-identical or within ``--swap-wer-guardrail`` WER), swap
the session backend, re-admit. Controller transitions print as
``{"rollout": {...}}`` lines; a canary regression or mid-swap fault
restores the old weights and halts the rollout while the streams keep
playing. ``--swap-at-chunk`` picks the trigger chunk (default: halfway
through the longest stream).

Autoscaling: ``--autoscale`` (requires ``--replicas >= 2``) ticks an
:class:`~.serving.autoscale.AutoscaleController` once a chunk, free to
resize the pool between ``--autoscale-min`` and ``--autoscale-max`` on
the worst ``slo_burn_rate`` gauge; its events print as
``{"autoscale": {...}}`` lines.

Multi-model multi-tenant: ``--models a=DIR1,b=DIR2`` serves N
checkpoints from one plane — each entry a
:class:`~.serving.registry.ModelGroup` with its own pool of
``--replicas`` replicas, streams assigned round-robin across models.
``--tenant-config tenants.json`` admits each stream as a tenant
(round-robin over the configured tenants) under per-tenant quotas
(``serving/tenancy.py``): an over-quota stream is shed at join with a
``{"shed": ...}`` line and an empty final. ``--swap-checkpoint`` and
``--autoscale`` compose with ``--models``: each group gets its own
controller, and each controller event carries its model id.

Async LM rescoring: ``--lm-rescore`` (needs ``decode.lm_path``) adds the
fast-path/slow-path split — first-pass finals print at their own
latency, then each stream's n-best is re-ranked on the host by a
:class:`~.serving.rescoring.RescoringPool` and every changed transcript
prints as a ``{"revision": {"rid", "old_text", "new_text",
"score_delta", "rescore_latency_ms"}}`` line, followed by one
``{"rescoring": ...}`` stats line.

Live ops surface: ``--status-port=P`` (``0`` = ephemeral) serves
``/metrics``, ``/healthz``, ``/slo``, ``/traces``, ``/timeline`` and
``/incidents`` on ``127.0.0.1`` for the run (``obs/status.py``).
``--timeline=PATH`` installs the process-wide
:class:`~.obs.timeline.EventLog`, appends one ``{"event": "timeline",
...}`` JSONL record per controller decision, and folds them into
incidents with an :class:`~.obs.timeline.IncidentCorrelator`; either
flag turns the ledger on.

``--models`` and ``--swap-checkpoint`` read checkpoints through
``infer.restore_params`` (the port's ``params.npz`` step directories,
or a JAX orbax directory where ``tensorstore`` is installed).

Crash-durable sessions: ``--session-journal=DIR`` attaches a write-ahead
:class:`~.serving.sessionstore.SessionJournal`: every live session
checkpoints its :class:`~.serving.migration.StreamSnapshot` (wire-encoded,
CRC-framed) every ``--journal-every`` chunks, at drain start and at
handoff arrival, and is tombstoned at finalize. At boot, sessions a
killed predecessor left mid-stream are replayed by a
:class:`~.serving.sessionstore.RecoveryController` into a throwaway
manager, drained to their finals and printed as one ``{"recovery":
{...}}`` line before serving starts. Composes with ``--replicas`` (one
journal shared by the pool's managers); not with ``--models``.

Cross-process handoff: ``--handoff-listen=PORT`` (``0`` = ephemeral)
adopts snapshots a peer ``serve`` sends (its port prints as one
``{"handoff_listen": ...}`` line; the adopted sessions drain to final
after this process's own streams and print as one ``{"handoff_adopted":
{...}}`` line); ``--handoff-peer=HOST:PORT`` hands each stream to that
peer at audio end (:class:`~.serving.transport.
RemoteMigrationController`), one ``{"handoff": {"sid", "outcome"}}``
line a transfer, down the ladder to a local journal re-pin, a drain
re-pin or staying home when the peer refuses or cannot be reached.
Either forces the pooled path.

Warm store: ``--warm-store=DIR`` makes ``DIR`` the process's default
executable warm store (``DS2_WARMSTORE_DIR``, serving/warmstore.py), as
the JAX ``serve``'s flag does: every ``Replica.from_inferencer`` the
process builds captures its stored ``(B, T)`` rungs as CUDA graphs
before it takes traffic and records the rungs it first uses.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import List, Optional

import numpy as np

from . import obs
from .data.features import frame_params

# Epoch counter for handoff sid prefixes: distinguishes pooled loops that
# share one process; the pid distinguishes processes.
_HANDOFF_EPOCH = iter(range(1 << 30))


def _frame_rms(audio: np.ndarray, feat_cfg, n_frames: int) -> np.ndarray:
    """Per-feature-frame waveform RMS, aligned with the featurizer's
    (window_ms, stride_ms) framing — the endpointing energy signal,
    vectorized through a cumulative sum of squares."""
    win, hop, _ = frame_params(feat_cfg)
    csq = np.concatenate([[0.0],
                          np.cumsum(audio.astype(np.float64) ** 2)])
    starts = np.minimum(np.arange(n_frames) * hop, len(audio))
    ends = np.minimum(starts + win, len(audio))
    n = np.maximum(ends - starts, 1)
    return np.sqrt((csq[ends] - csq[starts]) / n).astype(np.float32)


def _emit_revisions(rescorer, out) -> None:
    """Drain the rescoring pool and stream its revisions as
    ``{"revision": ...}`` JSONL lines, then one ``{"rescoring": ...}``
    stats line — the shared tail of all three serving loops."""
    for ev in rescorer.drain():
        print(json.dumps({"revision": ev.to_json()}), file=out,
              flush=True)
    print(json.dumps({"rescoring": rescorer.stats()}), file=out,
          flush=True)


def _chunk(feat: np.ndarray, i: int, chunk_frames: int) -> np.ndarray:
    """Chunk ``i`` of one stream's features, zero-padded to whole
    ``chunk_frames`` (a live feed has no known length)."""
    buf = np.zeros((chunk_frames, feat.shape[1]), np.float32)
    piece = feat[i * chunk_frames:(i + 1) * chunk_frames]
    buf[:piece.shape[0]] = piece
    return buf


def _shadow_decoder(feats, chunk_frames: int):
    """The rollout canary: ``shadow_decode(backend)`` streams the first
    wav's opening chunks (at most 4) through a throwaway capacity-1
    manager built from the backend's session factory — the shadow
    decode never touches a live session."""
    c_chunks = [_chunk(feats[0], c, chunk_frames)
                for c in range(min(4, -(-feats[0].shape[0]
                                        // chunk_frames)))]

    def shadow_decode(backend):
        mgr = backend["session_factory"]()
        mgr.join("canary")
        for buf in c_chunks:
            mgr.step({"canary": buf})
        mgr.leave("canary")
        mgr.flush()
        return [mgr.final("canary")]

    return shadow_decode


def serve_files(cfg, tokenizer, params, batch_stats, wav_paths: List[str],
                chunk_frames: int = 64, decode: str = "greedy",
                out=None, lm_table=None, endpoint_silence_ms: int = 0,
                endpoint_db: float = 40.0, quantize: str = "",
                rescorer=None, journal=None, journal_every: int = 1,
                device=None) -> List[str]:
    """Stream the given wavs as if live; returns final transcripts.

    Emits JSONL progress: {"chunk": i, "t_ms": audio ms consumed,
    "ms": wall-clock ms spent on the chunk, "partials": [...]} per
    chunk, then {"final": [...]}. With ``endpoint_silence_ms > 0``,
    additionally emits one
    {"segment": {"stream": s, "index": k, "text": ..., "end_ms": ...}}
    record per finalized segment, and each stream's final transcript
    joins its segments with spaces.

    Each wav is a session of one ``StreamingSessionManager`` (stream s
    is slot s, joined in order before the first chunk); this loop keeps
    only featurization, endpointing and the JSONL surface.
    ``decode="beam"`` fuses ``lm_table`` when given (``device_lm_table``).

    ``rescorer`` (``--lm-rescore``): after the finals, each stream's
    n-best is offered to the async LM second pass and its revisions
    print as ``{"revision": ...}`` lines (:mod:`~.serving.rescoring`).
    Endpointed streams offer the joined transcript as a 1-best:
    segments already consumed their decoder state.

    ``journal`` (``--session-journal``): the manager checkpoints every
    session into it every ``journal_every`` chunks (module docstring).
    """
    from .data import featurize_np, load_audio
    from .serving.session import StreamingSessionManager
    from .streaming import CONV_LAG

    out = out if out is not None else sys.stdout

    audios = [load_audio(p, cfg.features.sample_rate) for p in wav_paths]
    feats = [featurize_np(a, cfg.features) for a in audios]
    b_real = len(feats)
    t = max(f.shape[0] for f in feats)
    t += (-t) % chunk_frames  # pad the stream to whole chunks
    raw_lens = np.asarray([f.shape[0] for f in feats], np.int64)

    mgr = StreamingSessionManager(cfg, params, batch_stats, tokenizer,
                                  chunk_frames=chunk_frames, decode=decode,
                                  lm_table=lm_table, quantize=quantize,
                                  capacity=b_real, journal=journal,
                                  journal_every=journal_every,
                                  device=device)
    # File lengths are known up front (unlike a live feed): joining with
    # raw_len masks each stream's padding from the first chunk, as the
    # offline and transcribe paths do.
    sids = [str(s) for s in range(b_real)]
    for s in range(b_real):
        assert mgr.join(sids[s], raw_len=int(raw_lens[s])) == s
    b = mgr.capacity
    batch = np.zeros((b_real, t, cfg.features.num_features), np.float32)
    for i, f in enumerate(feats):
        batch[i, :f.shape[0]] = f

    ms_per_frame = cfg.features.stride_ms
    # Endpointing: per-frame silence flags from waveform energy, and
    # per-stream segment bookkeeping. The threshold is relative to each
    # stream's peak, so mic gain needs no calibration.
    ep_frames = 0
    if endpoint_silence_ms > 0:
        ep_frames = max(1, int(round(endpoint_silence_ms / ms_per_frame)))
        # Decoded text lags the audio by the conv+lookahead receptive
        # field; a cut inside that window would move the tail of one
        # utterance into the next segment.
        lag = 2 * (CONV_LAG + max(cfg.model.lookahead_context - 1, 0))
        if ep_frames <= lag:
            raise ValueError(
                f"endpoint_silence_ms={endpoint_silence_ms} is within "
                f"the model's decode lag (~{int(lag * ms_per_frame)} "
                f"ms for this config); segments would cut mid-word. "
                f"Use at least {int((lag + 1) * ms_per_frame)} ms")
        silent = np.ones((b, t), bool)
        for s, a in enumerate(audios):
            n = int(raw_lens[s])
            rms = _frame_rms(a, cfg.features, n)
            # Causal running peak (a live feed has no future), floored
            # so leading digital silence can't make noise look loud.
            peak = np.maximum.accumulate(rms) if n else rms
            thr = np.maximum(peak * 10.0 ** (-endpoint_db / 20.0), 1e-5)
            silent[s, :n] = rms <= thr
        segments: List[List[str]] = [[] for _ in range(b)]
        # Per-stream gap tracker: trailing silent-run length, speech
        # seen this segment, and the end of the latest qualifying gap
        # (-1 = none).
        ep_run = np.zeros((b,), np.int64)
        ep_speech = np.zeros((b,), bool)
        ep_q = np.full((b,), -1, np.int64)

        def ep_scan(s: int, start: int, end: int) -> None:
            for f in range(start, end):
                if silent[s, f]:
                    ep_run[s] += 1
                    if ep_run[s] >= ep_frames and ep_speech[s]:
                        ep_q[s] = f + 1
                else:
                    ep_run[s] = 0
                    ep_speech[s] = True

    n_chunks = t // chunk_frames
    for i in range(n_chunks + 1):
        t0 = time.perf_counter()
        with obs.span("serve.chunk", chunk=i):
            if i < n_chunks:
                mgr.step({sids[s]: batch[s, i * chunk_frames:
                                         (i + 1) * chunk_frames]
                          for s in range(b_real)})
            else:  # flush the conv/lookahead lag + apply true lengths
                for s in range(b_real):
                    mgr.leave(sids[s])
                mgr.flush()
            partials = mgr.stable_texts()
        print(json.dumps({
            "chunk": i,
            "t_ms": round(min((i + 1) * chunk_frames,
                          int(raw_lens.max())) * ms_per_frame, 1),
            # Wall-clock ms spent on this chunk (device step + decode
            # bookkeeping): per-chunk serving latency.
            "ms": round((time.perf_counter() - t0) * 1000.0, 3),
            "partials": partials[:b_real],
        }), file=out, flush=True)

        if ep_frames and i < n_chunks:
            cut = []
            finalized = None
            for s in range(b_real):
                prev_p = min(i * chunk_frames, int(raw_lens[s]))
                p = min((i + 1) * chunk_frames, int(raw_lens[s]))
                ep_scan(s, prev_p, p)
                q = int(ep_q[s])
                # Cut at the end of the latest qualifying gap, but only
                # while the decoded text cannot yet hold resumed speech:
                # logits so far cover audio up to ~p - lag. Past that
                # window, no cut (the segments merge).
                if q < 0 or p - q > lag:
                    continue
                if finalized is None:
                    finalized = mgr.current_texts()
                # An empty decode is cut and reset without a record, as
                # the tail path does.
                if finalized[s]:
                    print(json.dumps({"segment": {
                        "stream": s, "index": len(segments[s]),
                        "text": finalized[s],
                        "end_ms": round(q * ms_per_frame, 1),
                    }}), file=out, flush=True)
                    segments[s].append(finalized[s])
                cut.append(sids[s])
                # Restart the tracker for the new segment over the
                # already-seen frames [q, p) (bounded by the lag).
                ep_run[s] = 0
                ep_speech[s] = False
                ep_q[s] = -1
                ep_scan(s, q, p)
            if cut:
                # Decoder restarts for the cut streams; the acoustic
                # state inside the manager flows on untouched.
                mgr.reset_decoders(cut)

    tails = mgr.current_texts()
    if ep_frames:
        finals = []
        for s in range(b_real):
            if tails[s]:  # the post-cut tail is a segment of its own
                print(json.dumps({"segment": {
                    "stream": s, "index": len(segments[s]),
                    "text": tails[s],
                    "end_ms": round(int(raw_lens[s]) * ms_per_frame, 1),
                }}), file=out, flush=True)
                segments[s].append(tails[s])
            finals.append(" ".join(x for x in segments[s] if x))
    else:
        finals = tails[:b_real]
    print(json.dumps({"final": finals}), file=out, flush=True)
    if rescorer is not None:
        for s in range(b_real):
            nbest = ([(finals[s], 0.0)] if ep_frames
                     else mgr.final_nbest(sids[s]))
            rescorer.offer(sids[s], nbest, finals[s])
        _emit_revisions(rescorer, out)
    return finals


def serve_files_pooled(cfg, tokenizer, params, batch_stats,
                       wav_paths: List[str], replicas: int = 2,
                       chunk_frames: int = 64, decode: str = "greedy",
                       out=None, lm_table=None, quantize: str = "",
                       swap_params=None, swap_batch_stats=None,
                       swap_version: str = "v2",
                       swap_at_chunk: int = -1,
                       swap_wer_guardrail: float = 0.0,
                       autoscale: bool = False,
                       autoscale_min: int = 1,
                       autoscale_max: int = 0,
                       autoscale_cooldown: float = 1.0,
                       migrate_sessions: bool = False,
                       rescorer=None, journal=None,
                       journal_every: int = 1,
                       handoff_listen: int = -1,
                       handoff_peer: str = "",
                       device=None) -> List[str]:
    """``--replicas=N``: the streaming loop over a ReplicaPool.

    Each wav is a session routed by :class:`~.serving.pool.
    PooledSessionRouter` — consistent-hash pinned to one replica's
    manager, re-pinned behind a drain window if that replica stops
    being routable. JSONL surface as :func:`serve_files` (one
    ``{"chunk", "t_ms", "ms", "partials"}`` line per chunk, then
    ``{"final": [...]}``), plus a leading ``{"replica_map": ...}``
    line recording each stream's home replica. Streams feed only their
    own chunks and leave as their audio ends; the tail chunk is
    zero-padded rather than length-masked (a live feed has no known
    length), so tails can differ from :func:`serve_files` by up to one
    chunk of silence decoding.

    ``swap_params`` (``--swap-checkpoint``): a
    :class:`~.serving.rollout.RolloutController` upgrades the pool to
    the new weights mid-stream, one replica at a time — drain, shadow
    canary (the first wav's opening chunks decoded on both versions,
    accepted bit-identical or within ``swap_wer_guardrail`` WER), swap,
    re-admit — starting at ``swap_at_chunk`` (default: halfway through
    the longest stream). Every transition is one ``{"rollout": {...}}``
    line; a canary regression or mid-swap fault rolls the victim back
    and halts (the streams keep playing on the old version).

    ``autoscale``: an :class:`~.serving.autoscale.AutoscaleController`
    ticks once per chunk, free to resize the pool between
    ``autoscale_min`` and ``autoscale_max`` replicas on the worst
    ``slo_burn_rate`` gauge (file replay has no admission queue). Every
    controller event is one ``{"autoscale": {...}}`` line; the
    controller holds off while the rolling swap is mid-flight.

    ``migrate_sessions``: a re-pin (breaker trip, rollout victim,
    autoscale scale-down) moves the session by snapshot
    (:class:`~.serving.migration.MigrationController`) instead of
    waiting out a drain: the recurrent state, decoder rows and
    partials export from the old replica's manager and import into the
    new one with the stream's clock re-based, so the transcript
    continues in the SAME segment as if it had never moved.
    Incompatible moves fall back to the drain re-pin, counted, never
    dropped.

    ``rescorer``: each stream's final n-best is offered to the async LM
    second pass after the finals (:func:`serve_files`).

    ``journal``: one journal shared by every replica's manager (the
    managers' local names are unique across the pool).

    ``handoff_listen`` / ``handoff_peer``: the cross-process leg
    (:mod:`~.serving.transport`). The listening side binds a
    :class:`~.serving.transport.HandoffListener` (its port printed as
    ``{"handoff_listen": ...}``) and adopts inbound snapshots into this
    pool's router; what arrived by the time its own streams finish is
    drained to final and printed as one ``{"handoff_adopted": ...}``
    line. The sending side hands each stream to the peer at audio end
    through a :class:`~.serving.transport.RemoteMigrationController`,
    one ``{"handoff": {"sid", "outcome"}}`` line a transfer; a refused or
    unreachable peer walks the ladder (journal re-pin, drain re-pin,
    stay), so the transcript always lands somewhere. Remote-handed sids
    report ``null`` in this process's ``final`` list (the peer prints
    their text).
    """
    from .data import featurize_np, load_audio
    from .serving import (AutoscaleController, MigrationController,
                          PooledSessionRouter, Replica, ReplicaPool,
                          RolloutController)
    from .serving.session import StreamingSessionManager

    out = out if out is not None else sys.stdout
    audios = [load_audio(p, cfg.features.sample_rate) for p in wav_paths]
    feats = [featurize_np(a, cfg.features) for a in audios]

    def factory_for(p, bs):
        def factory():
            # capacity=1: each replica's manager grows to a
            # power-of-two rung sized to the sessions it hosts.
            return StreamingSessionManager(
                cfg, p, bs, tokenizer, chunk_frames=chunk_frames,
                decode=decode, lm_table=lm_table, quantize=quantize,
                capacity=1, journal=journal, journal_every=journal_every,
                device=device)
        return factory

    factory = factory_for(params, batch_stats)
    pool = ReplicaPool([Replica(f"r{k}", session_factory=factory)
                        for k in range(replicas)],
                       handoff=migrate_sessions)
    migrator = MigrationController(telemetry=pool.telemetry) \
        if migrate_sessions else None
    router = PooledSessionRouter(pool, migrator=migrator)
    if handoff_listen >= 0 or handoff_peer:
        # Handoff sids must be unique across peers: both ends number
        # their streams 0..N-1, and an inbound "0" would collide with the
        # receiver's own live "0". The pid and a process-local epoch
        # keep the name unique across processes and across pooled loops
        # in one process.
        hp = f"h{os.getpid():x}{next(_HANDOFF_EPOCH)}-"
        sids = [f"{hp}{s}" for s in range(len(feats))]
    else:
        sids = [str(s) for s in range(len(feats))]
    homes = {sid: router.join(sid) for sid in sids}
    print(json.dumps({"replica_map": homes}), file=out, flush=True)

    handoff_rx = handoff_lsn = handoff_lock = None
    if handoff_listen >= 0:
        import threading

        from .serving import HandoffListener, HandoffReceiver

        handoff_lock = threading.Lock()

        class _AdoptTarget:
            """The router as the listener thread sees it: an adoption
            is serialized against the chunk loop (``step`` demands
            chunks for every active session) and enters the drain at
            once, since the sender hands off at audio end."""

            def adopt(self, sid, snap, model=None):
                with handoff_lock:
                    router.adopt(sid, snap, model=model)
                    router.leave(sid)

            def _pools(self):
                return router._pools()

        handoff_rx = HandoffReceiver(_AdoptTarget(), name="serve",
                                     telemetry=pool.telemetry)
        handoff_lsn = HandoffListener(handoff_rx, port=handoff_listen)
        print(json.dumps({"handoff_listen": {
            "host": handoff_lsn.host, "port": handoff_lsn.port}}),
            file=out, flush=True)
    handoff_ctrl = handoff_tx = None
    handoff_out: "dict[str, str]" = {}
    if handoff_peer:
        from .serving import RemoteMigrationController, SocketTransport

        peer_host, _, peer_port = handoff_peer.rpartition(":")
        handoff_ctrl = RemoteMigrationController(
            telemetry=pool.telemetry, journal=journal)
        handoff_tx = SocketTransport(peer_host or "127.0.0.1",
                                     int(peer_port))

    ms_per_frame = cfg.features.stride_ms
    n_chunks_per = [-(-f.shape[0] // chunk_frames) for f in feats]

    rollout = None
    new_factory = None
    if swap_params is not None:
        for rep in pool:
            rep.version = "v1"
        new_factory = factory_for(swap_params, swap_batch_stats)
        shadow_decode = _shadow_decoder(feats, chunk_frames)
        rollout = RolloutController(
            pool,
            lambda rep: {"session_factory": new_factory},
            to_version=swap_version,
            canary_fn=lambda old, new: (shadow_decode(old),
                                        shadow_decode(new)),
            wer_guardrail=swap_wer_guardrail,
            handoff=migrate_sessions,
            on_event=lambda ev: print(json.dumps({"rollout": ev}),
                                      file=out, flush=True))
        if swap_at_chunk < 0:
            swap_at_chunk = max(1, max(n_chunks_per) // 2)

    autoctrl = None
    if autoscale:
        def _mk_replica(rid):
            # A newcomer serves what the fleet serves: after a
            # completed rolling swap, the NEW weights.
            fac = new_factory if (rollout is not None
                                  and rollout.state == "done") \
                else factory
            return Replica(rid, session_factory=fac)

        autoctrl = AutoscaleController(
            pool, _mk_replica, min_replicas=autoscale_min,
            max_replicas=(autoscale_max if autoscale_max > 0
                          else replicas + 2),
            cooldown_s=autoscale_cooldown,
            slo_burn_budget=1.0, rollout=rollout,
            handoff=migrate_sessions,
            telemetry=pool.telemetry,
            on_event=lambda ev: print(json.dumps({"autoscale": ev}),
                                      file=out, flush=True))

    last = {sid: "" for sid in sids}
    for i in range(max(n_chunks_per)):
        t0 = time.perf_counter()
        chunks = {sids[s]: _chunk(f, i, chunk_frames)
                  for s, f in enumerate(feats) if i < n_chunks_per[s]}
        with obs.span("serve.chunk", chunk=i):
            if handoff_lock is not None:
                # An adoption landing inside step() would change the
                # active set mid-call; the listener takes the same lock.
                with handoff_lock:
                    last.update(router.step(chunks))
            else:
                last.update(router.step(chunks))
            for s in range(len(feats)):
                if n_chunks_per[s] != i + 1:
                    continue
                # Audio just ended: hand the session to the peer when one
                # is configured, else start the local drain. Every rung
                # but "remote" leaves the session attached here, so it
                # still drains locally.
                if handoff_ctrl is not None:
                    outcome = handoff_ctrl.migrate_remote(
                        router, sids[s], handoff_tx)
                    handoff_out[sids[s]] = outcome
                    print(json.dumps({"handoff": {
                        "sid": sids[s], "outcome": outcome}}),
                        file=out, flush=True)
                    if outcome != "remote":
                        router.leave(sids[s])
                else:
                    router.leave(sids[s])
        if rollout is not None and i >= swap_at_chunk:
            if rollout.state == "idle":
                rollout.start()
            rollout.tick()
        if autoctrl is not None:
            autoctrl.tick()
        print(json.dumps({
            "chunk": i,
            "t_ms": round(min((i + 1) * chunk_frames,
                          max(f.shape[0] for f in feats))
                          * ms_per_frame, 1),
            "ms": round((time.perf_counter() - t0) * 1000.0, 3),
            "partials": [last[sid] for sid in sids],
        }), file=out, flush=True)
    if handoff_lsn is not None:
        # Stop accepting before finalizing: a transfer landing mid-flush
        # would race the drains below.
        handoff_lsn.close()
    adopted_sids = (list(dict.fromkeys(handoff_rx.imported_sids))
                    if handoff_rx is not None else [])
    router.flush()
    finals = [(None if handoff_out.get(sid) == "remote"
               else router.final(sid)) for sid in sids]
    if adopted_sids:
        print(json.dumps({"handoff_adopted": {
            sid: router.final(sid) for sid in adopted_sids}},
            ensure_ascii=False), file=out, flush=True)
    if rollout is not None and rollout.state in ("idle", "running",
                                                 "paused"):
        # Streams ended before the rollout finished — with no live
        # sessions left, the remaining drains complete in wall time.
        if rollout.state == "idle":
            rollout.start()
        rollout.run(sleep_s=min(pool.drain_window_s / 4, 0.05))
    if autoctrl is not None and autoctrl.status()["victim"] is not None:
        # A scale-down caught mid-drain by the end of the streams:
        # with every session finalized the drain completes in wall
        # time alone — finish it so the episode's postmortem lands.
        autoctrl.run_until_steady(
            sleep_s=min(pool.drain_window_s / 4, 0.05))
    print(json.dumps({"final": finals}), file=out, flush=True)
    if rescorer is not None:
        for sid, text in zip(sids, finals):
            if text is None:  # handed off: the peer owns the n-best
                continue
            rescorer.offer(sid, router.final_nbest(sid), text)
        _emit_revisions(rescorer, out)
    return finals


def parse_models_flag(spec: str) -> "dict[str, str]":
    """``--models a=ckpt1,b=ckpt2`` -> ``{"a": "ckpt1", ...}``
    (ordered; the first entry is the registry's default model)."""
    out: "dict[str, str]" = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"--models entry {part!r} must be model_id=ckpt_dir")
        mid, _, ckpt = part.partition("=")
        mid, ckpt = mid.strip(), ckpt.strip()
        if not mid or not ckpt:
            raise ValueError(
                f"--models entry {part!r} must be model_id=ckpt_dir")
        if mid in out:
            raise ValueError(f"--models: duplicate model id {mid!r}")
        out[mid] = ckpt
    if not out:
        raise ValueError("--models: no model_id=ckpt_dir entries")
    return out


def serve_files_multimodel(cfg, tokenizer, model_params,
                           wav_paths: List[str],
                           stream_models: List[str],
                           replicas: int = 1,
                           chunk_frames: int = 64,
                           decode: str = "greedy",
                           out=None, lm_table=None,
                           quantize: str = "",
                           tenancy=None,
                           stream_tenants: Optional[List[str]] = None,
                           swap_ckpts=None,
                           swap_at_chunk: int = -1,
                           swap_wer_guardrail: float = 0.0,
                           autoscale: bool = False,
                           autoscale_min: int = 1,
                           autoscale_max: int = 0,
                           autoscale_cooldown: float = 1.0,
                           rescorer=None, device=None) -> List[str]:
    """``--models``: the streaming loop over a :class:`ModelRegistry`.

    ``model_params`` is ``{model_id: (params, batch_stats)}``; each
    model group gets its own ReplicaPool of ``replicas`` replicas (so a
    chunk batch can never mix models — the pools are disjoint) and
    stream ``s`` joins model ``stream_models[s]``'s group through one
    shared :class:`~.serving.pool.PooledSessionRouter`. With a
    ``tenancy`` controller, stream ``s`` is admitted as tenant
    ``stream_tenants[s]`` — a stream over its tenant's quota is shed at
    join (one ``{"shed": ...}`` line, empty final) instead of degrading
    anyone else's session. JSONL surface as
    :func:`serve_files_pooled` plus leading ``{"model_map"}`` /
    ``{"tenant_map"}`` lines.

    Per-group controllers: ``swap_ckpts`` is ``{model_id: (params,
    batch_stats, version)}`` — each named group gets its own
    :class:`~.serving.rollout.RolloutController` (on
    ``group.rollout``; events carry the model id); with ``autoscale``
    every group gets its own
    :class:`~.serving.autoscale.AutoscaleController` (on
    ``group.autoscale``), so one model's burst never resizes another's
    fleet.

    ``rescorer``: each non-shed stream's final n-best is offered for the
    async LM second pass; revisions (each with the stream's model and
    tenant) print after the final, then one ``{"rescoring": ...}``
    stats line."""
    from .data import featurize_np, load_audio
    from .serving import (AutoscaleController, ModelRegistry,
                          PooledSessionRouter, Replica, ReplicaPool,
                          RolloutController, TenantQuotaExceeded)
    from .serving.session import StreamingSessionManager

    out = out if out is not None else sys.stdout
    audios = [load_audio(p, cfg.features.sample_rate) for p in wav_paths]
    feats = [featurize_np(a, cfg.features) for a in audios]

    def factory_for(p, bs):
        def factory():
            return StreamingSessionManager(
                cfg, p, bs, tokenizer, chunk_frames=chunk_frames,
                decode=decode, lm_table=lm_table, quantize=quantize,
                capacity=1, device=device)
        return factory

    registry = ModelRegistry()
    factories = {}
    for mid, (p, bs) in model_params.items():
        fac = factory_for(p, bs)
        factories[mid] = fac
        pool = ReplicaPool([Replica(f"{mid}-r{k}", session_factory=fac)
                            for k in range(replicas)])
        registry.add_group(mid, pool)

    router = PooledSessionRouter(registry=registry, tenancy=tenancy)
    sids = [str(s) for s in range(len(feats))]
    stream_tenants = stream_tenants or [None] * len(feats)
    homes = {}
    shed = set()
    for s, sid in enumerate(sids):
        try:
            homes[sid] = router.join(sid, model=stream_models[s],
                                     tenant=stream_tenants[s])
        except TenantQuotaExceeded as e:
            shed.add(sid)
            print(json.dumps({"shed": {
                "stream": s, "tenant": stream_tenants[s],
                "model": stream_models[s], "reason": str(e)}}),
                file=out, flush=True)
    print(json.dumps({"model_map": dict(zip(sids, stream_models))}),
          file=out, flush=True)
    if tenancy is not None:
        print(json.dumps({"tenant_map":
                          dict(zip(sids, stream_tenants))}),
              file=out, flush=True)
    print(json.dumps({"replica_map": homes}), file=out, flush=True)

    ms_per_frame = cfg.features.stride_ms
    n_chunks_per = [-(-f.shape[0] // chunk_frames) for f in feats]

    rollouts = {}
    if swap_ckpts:
        # One canary slice for every group; each group's controller
        # shadow-decodes it through its OWN old and new backends.
        shadow_decode = _shadow_decoder(feats, chunk_frames)
        for mid, (sp, sbs, ver) in swap_ckpts.items():
            group = registry.group(mid)
            for rep in group.pool:
                rep.version = "v1"
            new_fac = factory_for(sp, sbs)
            group.rollout = RolloutController(
                group.pool,
                lambda rep, fac=new_fac: {"session_factory": fac},
                to_version=ver,
                canary_fn=lambda old, new: (shadow_decode(old),
                                            shadow_decode(new)),
                wer_guardrail=swap_wer_guardrail,
                on_event=lambda ev, m=mid: print(
                    json.dumps({"rollout": {**ev, "model": m}}),
                    file=out, flush=True))
            rollouts[mid] = (group.rollout, new_fac)
        if swap_at_chunk < 0:
            swap_at_chunk = max(1, max(n_chunks_per) // 2)

    autoctrls = {}
    if autoscale:
        for mid in model_params:
            group = registry.group(mid)

            def _mk_replica(rid, m=mid):
                # Newcomers serve what their group serves: the new
                # weights once that group's swap completed.
                ro = rollouts.get(m)
                fac = (ro[1] if ro is not None
                       and ro[0].state == "done" else factories[m])
                return Replica(rid, session_factory=fac)

            group.autoscale = AutoscaleController(
                group.pool, _mk_replica, min_replicas=autoscale_min,
                max_replicas=(autoscale_max if autoscale_max > 0
                              else replicas + 2),
                cooldown_s=autoscale_cooldown,
                slo_burn_budget=1.0,
                rollout=(rollouts[mid][0] if mid in rollouts
                         else None),
                telemetry=group.pool.telemetry,
                on_event=lambda ev, m=mid: print(
                    json.dumps({"autoscale": {**ev, "model": m}}),
                    file=out, flush=True))
            autoctrls[mid] = group.autoscale

    last = {sid: "" for sid in sids}
    for i in range(max(n_chunks_per)):
        t0 = time.perf_counter()
        chunks = {sids[s]: _chunk(f, i, chunk_frames)
                  for s, f in enumerate(feats)
                  if i < n_chunks_per[s] and sids[s] not in shed}
        with obs.span("serve.chunk", chunk=i):
            last.update(router.step(chunks))
            for s in range(len(feats)):
                if n_chunks_per[s] == i + 1 and sids[s] not in shed:
                    router.leave(sids[s])
        if rollouts and i >= swap_at_chunk:
            for rollout, _ in rollouts.values():
                if rollout.state == "idle":
                    rollout.start()
                rollout.tick()
        for ctrl in autoctrls.values():
            ctrl.tick()
        print(json.dumps({
            "chunk": i,
            "t_ms": round(min((i + 1) * chunk_frames,
                          max(f.shape[0] for f in feats))
                          * ms_per_frame, 1),
            "ms": round((time.perf_counter() - t0) * 1000.0, 3),
            "partials": [last[sid] for sid in sids],
        }), file=out, flush=True)
    router.flush()
    finals = [("" if sid in shed else router.final(sid))
              for sid in sids]
    for mid, (rollout, _) in rollouts.items():
        if rollout.state in ("idle", "running", "paused"):
            if rollout.state == "idle":
                rollout.start()
            rollout.run(sleep_s=min(
                registry.group(mid).pool.drain_window_s / 4, 0.05))
    for mid, ctrl in autoctrls.items():
        if ctrl.status()["victim"] is not None:
            ctrl.run_until_steady(sleep_s=min(
                registry.group(mid).pool.drain_window_s / 4, 0.05))
    if tenancy is not None:
        print(json.dumps({"tenants": tenancy.stats()}), file=out,
              flush=True)
    print(json.dumps({"final": finals}), file=out, flush=True)
    if rescorer is not None:
        for s, sid in enumerate(sids):
            if sid in shed:
                continue
            rescorer.offer(sid, router.final_nbest(sid), finals[s],
                           model=stream_models[s],
                           tenant=stream_tenants[s])
        _emit_revisions(rescorer, out)
    return finals


def device_lm_table(cfg, tokenizer):
    """The on-device fusion table of ``--decode=beam`` when
    ``decode.lm_path`` is set (``ngram.fusion_table_for``, on the CPU;
    the beam decoder moves it to its device), else None."""
    if not cfg.decode.lm_path:
        return None
    from .decode.ngram import fusion_table_for

    d = cfg.decode
    return fusion_table_for(
        d.lm_path, lambda i: tokenizer.decode([i]), cfg.model.vocab_size,
        d.lm_alpha, d.lm_beta, context_size=d.device_lm_context,
        vocab_has_space=" " in getattr(tokenizer, "chars", []),
        impl=d.device_lm_impl)



def _recover_journal(args, cfg, tokenizer, params, batch_stats, table):
    """Open ``--session-journal``. Sessions a killed predecessor left
    mid-stream are recovered (the newest valid record a sid) into a
    throwaway manager, drained and printed as one ``{"recovery": ...}``
    line before this run's streams start: their audio feed died with
    the old process, so a drain to final is the best completion."""
    from .serving import RecoveryController, SessionJournal
    from .serving.session import StreamingSessionManager

    journal = SessionJournal(args.session_journal, telemetry=obs.registry())
    scan = journal.scan()
    if scan.live:
        rec_mgr = StreamingSessionManager(
            cfg, params, batch_stats, tokenizer,
            chunk_frames=args.chunk_frames, decode=args.decode,
            lm_table=table, quantize=args.quantize_weights,
            capacity=max(len(scan.live), 1), journal=journal,
            journal_every=args.journal_every, device=args.device)
        report = RecoveryController(
            journal, telemetry=obs.registry()).recover(rec_mgr)
        for sid in list(report["sids"]):
            if sid in rec_mgr._sessions \
                    and not rec_mgr._sessions[sid].draining:
                rec_mgr.leave(sid)
        rec_mgr.flush()
        report["finals"] = {sid: rec_mgr.final(sid)
                            for sid in report["sids"]
                            if sid in rec_mgr._finals}
        print(json.dumps({"recovery": report}, ensure_ascii=False),
              flush=True)
    return journal


def main(argv: Optional[List[str]] = None) -> None:
    from .bridge import load_npz
    from .config import apply_overrides, get_config, parse_cli_overrides
    from .data.tokenizer import resolve_tokenizer
    from .infer import restore_params

    parser = argparse.ArgumentParser(prog="deepspeech_tpu_torch.serve")
    parser.add_argument("wavs", nargs="+", help="wav files = live streams")
    parser.add_argument("--config", default="ds2_streaming")
    parser.add_argument("--checkpoint-dir", default="",
                        help="checkpoint to serve (or --params, or "
                             "--models)")
    parser.add_argument("--params", default="",
                        help=".npz from bridge.save_npz (or a checkpoint "
                             "step's params.npz); overrides the "
                             "checkpoint directory")
    parser.add_argument("--device", default=None,
                        help="'cuda' (default) or 'cpu'")
    parser.add_argument("--chunk-frames", type=int, default=64)
    parser.add_argument("--decode", choices=["greedy", "beam"],
                        default="greedy")
    parser.add_argument("--vocab", default="", help="tokenizer vocab file")
    parser.add_argument("--endpoint-silence-ms", type=int, default=0,
                        help="finalize a segment after this much silence "
                             "(0 = off; continuous-audio mode)")
    parser.add_argument("--endpoint-silence-db", type=float, default=40.0,
                        help="silence = frames this many dB under the "
                             "stream's peak RMS")
    parser.add_argument("--quantize-weights", default="",
                        choices=["", "int8"],
                        help="weight-only PTQ for serving ('int8'): the "
                             "recurrent matrices stay int8 into the "
                             "resident int8 GRU kernel where they fit")
    parser.add_argument("--quant-tier", choices=["premium", "bulk"],
                        default="",
                        help="'premium' = bf16 weights + beam decode, "
                             "'bulk' = int8 PTQ + greedy decode "
                             "(overrides --decode / --quantize-weights)")
    parser.add_argument("--replicas", type=int, default=1,
                        help="host the streams on a pool of N replicas "
                             "(consistent-hash pinned; re-pinned behind "
                             "a drain window on a breaker open); with "
                             "--models, N replicas a model")
    parser.add_argument("--migrate-sessions", action="store_true",
                        help="with --replicas > 1: move a re-pinned "
                             "session by snapshot instead of a drain "
                             "(same segment, same transcript)")
    parser.add_argument("--models", default="",
                        help="'a=DIR1,b=DIR2': one model group (its own "
                             "replica pool) an entry, streams assigned "
                             "round-robin; the first is the default")
    parser.add_argument("--tenant-config", default="",
                        help="JSON file of tenant quotas, priorities and "
                             "weights (serving/tenancy.py); streams are "
                             "assigned to tenants round-robin and shed "
                             "at join over quota (needs --models)")
    parser.add_argument("--swap-checkpoint", default="",
                        help="rolling-swap the pool to this checkpoint "
                             "mid-stream (shadow canary, automatic "
                             "rollback; needs --replicas >= 2). With "
                             "--models: 'model_id=DIR[,...]', or a bare "
                             "DIR for the default model")
    parser.add_argument("--swap-at-chunk", type=int, default=-1,
                        help="chunk that starts the swap (-1 = halfway "
                             "through the longest stream)")
    parser.add_argument("--swap-wer-guardrail", type=float, default=0.0,
                        help="largest canary WER the swap accepts "
                             "(0.0 = bit-identical transcripts only)")
    parser.add_argument("--autoscale", action="store_true",
                        help="closed-loop fleet sizing, one controller "
                             "tick a chunk (needs --replicas >= 2)")
    parser.add_argument("--autoscale-min", type=int, default=1,
                        help="fleet floor for --autoscale")
    parser.add_argument("--autoscale-max", type=int, default=0,
                        help="fleet ceiling for --autoscale "
                             "(0 = --replicas + 2)")
    parser.add_argument("--autoscale-cooldown", type=float, default=1.0,
                        help="seconds between autoscale episodes")
    parser.add_argument("--lm-rescore", action="store_true",
                        help="async LM second pass over each stream's "
                             "n-best after the finals (needs "
                             "decode.lm_path); revisions print as "
                             "{'revision': ...} lines")
    parser.add_argument("--status-port", type=int, default=-1,
                        help="serve /metrics /healthz /slo /traces "
                             "/timeline /incidents on 127.0.0.1 at this "
                             "port for the run (0 = ephemeral, -1 = off)")
    parser.add_argument("--timeline", default="",
                        help="append the fleet event ledger's records "
                             "(breaker edges, autoscale episodes, "
                             "rollout transitions, migrations, SLO "
                             "alerts) to this JSONL file")
    parser.add_argument("--session-journal", default="",
                        help="write-ahead journal directory "
                             "(serving/sessionstore.py): every live "
                             "session checkpoints there (every "
                             "--journal-every chunks, at drain start, at "
                             "handoff arrival; tombstoned at finalize); "
                             "at boot, sessions a killed predecessor left "
                             "mid-stream are recovered, drained and "
                             "printed as one {'recovery': ...} line")
    parser.add_argument("--journal-every", type=int, default=1,
                        help="checkpoint cadence for --session-journal, "
                             "in chunks a session (default 1)")
    parser.add_argument("--handoff-listen", type=int, default=-1,
                        help="accept session handoffs from a peer serve "
                             "on this TCP port (0 = ephemeral; printed as "
                             "{'handoff_listen': ...}); adopted sessions "
                             "print as {'handoff_adopted': ...}. Forces "
                             "the pooled path (-1 = off)")
    parser.add_argument("--handoff-peer", default="",
                        help="host:port of a peer serve started with "
                             "--handoff-listen: each stream is handed off "
                             "at audio end (one {'handoff': ...} line a "
                             "transfer), falling back to a journal "
                             "re-pin, a drain re-pin or staying home. "
                             "Forces the pooled path")
    parser.add_argument("--warm-store", default="",
                        help="executable warm-store directory "
                             "(serving/warmstore.py): makes it the "
                             "process default (DS2_WARMSTORE_DIR) so "
                             "every inferencer-backed replica captures "
                             "its stored (B,T) rungs as CUDA graphs at "
                             "init and records the rungs it first uses")
    args, extra = parser.parse_known_args(argv)
    if args.quant_tier == "bulk":
        args.quantize_weights, args.decode = "int8", "greedy"
    elif args.quant_tier == "premium":
        args.quantize_weights, args.decode = "", "beam"
    if args.replicas > 1 and args.endpoint_silence_ms > 0:
        raise ValueError("--replicas > 1 does not compose with "
                         "--endpoint-silence-ms (endpointing is "
                         "single-replica-only; see module docstring)")
    if args.tenant_config and not args.models:
        raise ValueError("--tenant-config needs --models: tenant-"
                         "scoped admission requires model-scoped "
                         "routing (a tenant-labeled SLO series must "
                         "also say which model earned it)")
    if args.models and args.endpoint_silence_ms > 0:
        raise ValueError("--models does not compose with "
                         "--endpoint-silence-ms: endpointing is "
                         "single-replica-only (disjoint per-model "
                         "pools are still pools)")
    if args.swap_checkpoint and args.replicas < 2:
        raise ValueError("--swap-checkpoint needs --replicas >= 2: a "
                         "rolling swap drains one replica at a time, "
                         "which requires somewhere else to route")
    if args.autoscale and args.replicas < 2:
        raise ValueError("--autoscale needs --replicas >= 2: fleet "
                         "sizing rides the pooled path (a scale-down "
                         "drains one replica behind the others)")
    if args.session_journal and args.models:
        raise ValueError("--session-journal does not compose with "
                         "--models: boot recovery restores into one "
                         "model's managers (a journaled snapshot does "
                         "not record which model group fed it)")
    handoff_on = args.handoff_listen >= 0 or bool(args.handoff_peer)
    if handoff_on and args.models:
        raise ValueError("--handoff-listen/--handoff-peer do not "
                         "compose with --models: the handshake "
                         "fingerprints ONE model config (a multi-"
                         "model gateway cannot say which group an "
                         "inbound snapshot belongs to)")
    if handoff_on and args.endpoint_silence_ms > 0:
        raise ValueError("--handoff-listen/--handoff-peer do not "
                         "compose with --endpoint-silence-ms: handoff "
                         "rides the pooled path (endpointing is "
                         "single-replica-only)")
    if args.handoff_peer:
        _h, _, _p = args.handoff_peer.rpartition(":")
        if not _p.isdigit():
            raise ValueError("--handoff-peer must be host:port (got "
                             f"{args.handoff_peer!r})")
    model_ckpts = parse_models_flag(args.models) if args.models else {}
    if not args.checkpoint_dir and not args.params and not model_ckpts:
        raise SystemExit("need --checkpoint-dir or --params (or "
                         "--models model_id=DIR,...)")
    cfg = apply_overrides(get_config(args.config),
                          parse_cli_overrides(extra))
    anchor_ckpt = args.checkpoint_dir or next(iter(model_ckpts.values()),
                                              "")
    if anchor_ckpt:
        # A training run's vocab.txt there names the tokenizer.
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, checkpoint_dir=anchor_ckpt))
    if args.warm_store:
        # The process-default warm store: Replica.from_inferencer (and
        # anything else that builds inferencer-backed replicas in this
        # process) preloads and exports through it with no further
        # wiring — serving/warmstore.default_store reads this.
        os.environ["DS2_WARMSTORE_DIR"] = args.warm_store
    tokenizer, cfg = resolve_tokenizer(cfg, vocab_override=args.vocab)
    params = batch_stats = None
    if not model_ckpts:
        if args.params:
            params, batch_stats = load_npz(args.params)
        else:
            params, batch_stats = restore_params(args.checkpoint_dir)
    table = (device_lm_table(cfg, tokenizer) if args.decode == "beam"
             else None)
    rescorer = None
    if args.lm_rescore:
        if not cfg.decode.lm_path:
            raise ValueError("--lm-rescore needs decode.lm_path: the "
                             "second pass re-ranks each n-best "
                             "against a host LM "
                             "(--decode.lm_path=lm.arpa)")
        from .decode.ngram import load_lm
        from .serving.rescoring import RescoringPool

        # Space-less vocabularies (e.g. Mandarin characters) score the
        # LM on space-joined characters — the mapping the on-device
        # table's vocab_has_space switch applies.
        rescorer = RescoringPool(
            lm=load_lm(cfg.decode.lm_path),
            alpha=cfg.decode.lm_alpha, beta=cfg.decode.lm_beta,
            to_lm_text=(None
                        if " " in getattr(tokenizer, "chars", [])
                        else lambda t: " ".join(t)))
    tl_fh = None
    correlator = None
    if args.timeline or args.status_port >= 0:
        # The fleet event ledger with live incident correlation;
        # anything still open at the end is flushed below so its
        # postmortem lands.
        from .obs import timeline as tl_mod
        from .obs.timeline import (EventLog, IncidentCorrelator,
                                   MetricSeries)

        # The file first: a path that cannot be opened raises before a
        # log is installed, so none is left behind for the process.
        if args.timeline:
            tl_fh = open(args.timeline, "a")
        log = tl_mod.install(EventLog(registry=obs.registry()))
        correlator = IncidentCorrelator(
            series=MetricSeries(registry=obs.registry()),
            registry=obs.registry()).attach(log)
        if tl_fh is not None:

            def _tl_write(ev, fh=tl_fh):
                fh.write(json.dumps(EventLog.to_record(ev),
                                    ensure_ascii=False, default=str)
                         + "\n")
                fh.flush()

            log.add_listener(_tl_write)
    status = None
    journal = None
    try:
        if args.status_port >= 0:
            # The live ops surface over the process-wide registry and
            # flight recorder; /slo computes burn rates on demand.
            from .obs.slo import SloBurnEngine

            engine = SloBurnEngine()

            def _slo_state():
                engine.update()
                return engine.status()

            status = obs.StatusServer(
                port=args.status_port,
                health_fn=lambda: {"status": "ok",
                                   "streams": len(args.wavs),
                                   "replicas": args.replicas},
                slo_fn=_slo_state,
                incidents_fn=correlator.status)
            status.start()
            print(json.dumps({"status_server": status.url("/")}),
                  file=sys.stderr, flush=True)
        if args.session_journal:
            journal = _recover_journal(args, cfg, tokenizer, params,
                                       batch_stats, table)
        if model_ckpts:
            model_params = {mid: restore_params(ckpt)
                            for mid, ckpt in model_ckpts.items()}
            models = list(model_ckpts)
            stream_models = [models[s % len(models)]
                             for s in range(len(args.wavs))]
            tenancy = None
            stream_tenants = None
            if args.tenant_config:
                from .serving import AdmissionController

                tenancy = AdmissionController.from_file(
                    args.tenant_config)
                names = tenancy.tenants()
                stream_tenants = [names[s % len(names)]
                                  for s in range(len(args.wavs))]
            swap_ckpts = None
            if args.swap_checkpoint:
                # 'model_id=DIR,...' targets named groups; a bare DIR
                # swaps the default (first) model.
                per = (parse_models_flag(args.swap_checkpoint)
                       if "=" in args.swap_checkpoint
                       else {models[0]: args.swap_checkpoint})
                unknown = sorted(set(per) - set(models))
                if unknown:
                    raise ValueError(
                        f"--swap-checkpoint names models {unknown} "
                        f"not registered by --models ({models})")
                swap_ckpts = {}
                for mid, ckpt in per.items():
                    sp, sbs = restore_params(ckpt)
                    swap_ckpts[mid] = (sp, sbs, os.path.basename(
                        os.path.normpath(ckpt)) or "v2")
            serve_files_multimodel(
                cfg, tokenizer, model_params, args.wavs,
                stream_models, replicas=args.replicas,
                chunk_frames=args.chunk_frames, decode=args.decode,
                lm_table=table, quantize=args.quantize_weights,
                tenancy=tenancy, stream_tenants=stream_tenants,
                swap_ckpts=swap_ckpts,
                swap_at_chunk=args.swap_at_chunk,
                swap_wer_guardrail=args.swap_wer_guardrail,
                autoscale=args.autoscale,
                autoscale_min=args.autoscale_min,
                autoscale_max=args.autoscale_max,
                autoscale_cooldown=args.autoscale_cooldown,
                rescorer=rescorer, device=args.device)
        elif args.replicas > 1 or handoff_on:
            swap_params = swap_bs = None
            swap_version = "v2"
            if args.swap_checkpoint:
                swap_params, swap_bs = restore_params(
                    args.swap_checkpoint)
                swap_version = os.path.basename(
                    os.path.normpath(args.swap_checkpoint)) or "v2"
            serve_files_pooled(cfg, tokenizer, params, batch_stats,
                               args.wavs, replicas=args.replicas,
                               chunk_frames=args.chunk_frames,
                               decode=args.decode, lm_table=table,
                               quantize=args.quantize_weights,
                               swap_params=swap_params,
                               swap_batch_stats=swap_bs,
                               swap_version=swap_version,
                               swap_at_chunk=args.swap_at_chunk,
                               swap_wer_guardrail=args.swap_wer_guardrail,
                               autoscale=args.autoscale,
                               autoscale_min=args.autoscale_min,
                               autoscale_max=args.autoscale_max,
                               autoscale_cooldown=args.autoscale_cooldown,
                               migrate_sessions=args.migrate_sessions,
                               rescorer=rescorer, journal=journal,
                               journal_every=args.journal_every,
                               handoff_listen=args.handoff_listen,
                               handoff_peer=args.handoff_peer,
                               device=args.device)
        else:
            serve_files(cfg, tokenizer, params, batch_stats, args.wavs,
                        chunk_frames=args.chunk_frames, decode=args.decode,
                        lm_table=table,
                        endpoint_silence_ms=args.endpoint_silence_ms,
                        endpoint_db=args.endpoint_silence_db,
                        quantize=args.quantize_weights, rescorer=rescorer,
                        journal=journal, journal_every=args.journal_every,
                        device=args.device)
    finally:
        if journal is not None:
            journal.close()
        if correlator is not None:
            # End-of-run close: open incidents finalize (unresolved if
            # nothing resolved them) so every story gets a postmortem.
            correlator.flush()
        if status is not None:
            status.stop()
        if tl_fh is not None:
            tl_fh.close()
        if correlator is not None:
            tl_mod.clear()


if __name__ == "__main__":
    main()
