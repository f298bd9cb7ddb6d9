"""Live-transcription entry point: stream WAV files as if live.

The port of the JAX package's ``serve.py`` single-model path: it feeds
audio chunk by chunk through a
:class:`~.serving.session.StreamingSessionManager` and prints one JSON
line per chunk with the current partial transcripts (greedy, through
the incremental collapse), then the finals.

CLI: ``python -m deepspeech_tpu_torch.serve --config=ds2_streaming
(--checkpoint-dir=DIR | --params=x.npz) wav1.wav [wav2.wav ...]
[--chunk-frames=64] [--vocab=V] [--endpoint-silence-ms=N
[--endpoint-silence-db=40]] [--quantize-weights=int8 | --quant-tier=bulk]
[--replicas=N [--migrate-sessions]] [--device=cpu]
[--section.key=value ...]``

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

What the JAX ``serve`` also offers comes with later slices of the port,
and its flags exit naming the slice: beam decoding and LM rescoring
(slice 6); multiple models and tenants, rolling swaps, autoscaling,
the status server and the timeline (slice 4b); the warm store (item
17); the session journal and cross-process handoff (slice 4c).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import List, Optional

import numpy as np

from . import obs
from .data.features import frame_params

# Flags of the JAX serve CLI that later slices of the port bring: the
# value each takes when it is off, and the slice.
_SLICE4B = "slice 4b (the serving plane's controllers)"
_SLICE4C = "slice 4c (the session store and handoff)"
_ITEM17 = "item 17 (the warm store)"
_SLICE6 = "slice 6 (beam search and LM)"
_LATER_FLAGS = {
    "models": ("", _SLICE4B), "tenant_config": ("", _SLICE4B),
    "swap_checkpoint": ("", _SLICE4B), "swap_at_chunk": (-1, _SLICE4B),
    "swap_wer_guardrail": (0.0, _SLICE4B), "autoscale": (False, _SLICE4B),
    "autoscale_min": (1, _SLICE4B), "autoscale_max": (0, _SLICE4B),
    "autoscale_cooldown": (1.0, _SLICE4B), "lm_rescore": (False, _SLICE6),
    "warm_store": ("", _ITEM17), "status_port": (-1, _SLICE4B),
    "session_journal": ("", _SLICE4C), "journal_every": (1, _SLICE4C),
    "timeline": ("", _SLICE4B), "handoff_listen": (-1, _SLICE4C),
    "handoff_peer": ("", _SLICE4C),
}


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


def serve_files(cfg, tokenizer, params, batch_stats, wav_paths: List[str],
                chunk_frames: int = 64, decode: str = "greedy",
                out=None, endpoint_silence_ms: int = 0,
                endpoint_db: float = 40.0, quantize: str = "",
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
                                  quantize=quantize, capacity=b_real,
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
    return finals


def serve_files_pooled(cfg, tokenizer, params, batch_stats,
                       wav_paths: List[str], replicas: int = 2,
                       chunk_frames: int = 64, decode: str = "greedy",
                       out=None, quantize: str = "",
                       migrate_sessions: bool = False,
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

    ``migrate_sessions``: a re-pin moves the session by snapshot
    (:class:`~.serving.migration.MigrationController`) instead of
    waiting out a drain: the recurrent state, decoder rows and
    partials export from the old replica's manager and import into the
    new one with the stream's clock re-based, so the transcript
    continues in the SAME segment as if it had never moved.
    Incompatible moves fall back to the drain re-pin, counted, never
    dropped.
    """
    from .data import featurize_np, load_audio
    from .serving import (MigrationController, PooledSessionRouter,
                          Replica, ReplicaPool)
    from .serving.session import StreamingSessionManager

    out = out if out is not None else sys.stdout
    audios = [load_audio(p, cfg.features.sample_rate) for p in wav_paths]
    feats = [featurize_np(a, cfg.features) for a in audios]

    def factory():
        # capacity=1: each replica's manager grows to a power-of-two
        # rung sized to the sessions it hosts.
        return StreamingSessionManager(
            cfg, params, batch_stats, tokenizer, chunk_frames=chunk_frames,
            decode=decode, quantize=quantize, capacity=1, device=device)

    pool = ReplicaPool([Replica(f"r{k}", session_factory=factory)
                        for k in range(replicas)],
                       handoff=migrate_sessions)
    migrator = MigrationController(telemetry=pool.telemetry) \
        if migrate_sessions else None
    router = PooledSessionRouter(pool, migrator=migrator)
    sids = [str(s) for s in range(len(feats))]
    homes = {sid: router.join(sid) for sid in sids}
    print(json.dumps({"replica_map": homes}), file=out, flush=True)

    nf = cfg.features.num_features
    ms_per_frame = cfg.features.stride_ms
    n_chunks_per = [-(-f.shape[0] // chunk_frames) for f in feats]
    last = {sid: "" for sid in sids}
    for i in range(max(n_chunks_per)):
        t0 = time.perf_counter()
        chunks = {}
        for s, f in enumerate(feats):
            if i >= n_chunks_per[s]:
                continue
            buf = np.zeros((chunk_frames, nf), np.float32)
            piece = f[i * chunk_frames:(i + 1) * chunk_frames]
            buf[:piece.shape[0]] = piece
            chunks[sids[s]] = buf
        with obs.span("serve.chunk", chunk=i):
            last.update(router.step(chunks))
            for s in range(len(feats)):
                if n_chunks_per[s] == i + 1:  # audio just ended
                    router.leave(sids[s])
        print(json.dumps({
            "chunk": i,
            "t_ms": round(min((i + 1) * chunk_frames,
                          max(f.shape[0] for f in feats))
                          * ms_per_frame, 1),
            "ms": round((time.perf_counter() - t0) * 1000.0, 3),
            "partials": [last[sid] for sid in sids],
        }), file=out, flush=True)
    router.flush()
    finals = [router.final(sid) for sid in sids]
    print(json.dumps({"final": finals}), file=out, flush=True)
    return finals


def _refuse_later_flags(args) -> None:
    """Exit naming the slice for any flag of a later slice that is on."""
    if args.decode == "beam":
        raise SystemExit(f"--decode=beam comes with {_SLICE6} of the port")
    if args.quant_tier == "premium":
        raise SystemExit("--quant-tier=premium (bf16 weights + beam "
                         f"decode) comes with {_SLICE6} of the port")
    for name, (off, where) in _LATER_FLAGS.items():
        if getattr(args, name) != off:
            raise SystemExit(f"--{name.replace('_', '-')} comes with "
                             f"{where} of the port")


def main(argv: Optional[List[str]] = None) -> None:
    from .bridge import load_npz
    from .config import apply_overrides, get_config, parse_cli_overrides
    from .data.tokenizer import resolve_tokenizer
    from .infer import restore_params

    parser = argparse.ArgumentParser(prog="deepspeech_tpu_torch.serve")
    parser.add_argument("wavs", nargs="+", help="wav files = live streams")
    parser.add_argument("--config", default="ds2_streaming")
    parser.add_argument("--checkpoint-dir", default="",
                        help="checkpoint to serve (or --params)")
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
                        help="'bulk' = int8 PTQ + greedy decode "
                             "(overrides --decode / --quantize-weights)")
    parser.add_argument("--replicas", type=int, default=1,
                        help="host the streams on a pool of N replicas "
                             "(consistent-hash pinned; re-pinned behind "
                             "a drain window on a breaker open)")
    parser.add_argument("--migrate-sessions", action="store_true",
                        help="with --replicas > 1: move a re-pinned "
                             "session by snapshot instead of a drain "
                             "(same segment, same transcript)")
    # The JAX serve's flags of later slices: parsed so that each exits
    # naming its slice.
    for name, (off, _) in _LATER_FLAGS.items():
        flag = "--" + name.replace("_", "-")
        if isinstance(off, bool):
            parser.add_argument(flag, action="store_true",
                                help=argparse.SUPPRESS)
        else:
            parser.add_argument(flag, type=type(off), default=off,
                                help=argparse.SUPPRESS)
    args, extra = parser.parse_known_args(argv)
    if args.quant_tier == "bulk":
        args.quantize_weights, args.decode = "int8", "greedy"
    _refuse_later_flags(args)
    if args.replicas > 1 and args.endpoint_silence_ms > 0:
        raise ValueError("--replicas > 1 does not compose with "
                         "--endpoint-silence-ms (endpointing is "
                         "single-replica-only; see module docstring)")
    if not args.checkpoint_dir and not args.params:
        raise SystemExit("need --checkpoint-dir or --params")
    cfg = apply_overrides(get_config(args.config),
                          parse_cli_overrides(extra))
    if args.checkpoint_dir:
        # A training run's vocab.txt there names the tokenizer.
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, checkpoint_dir=args.checkpoint_dir))
    tokenizer, cfg = resolve_tokenizer(cfg, vocab_override=args.vocab)
    if args.params:
        params, batch_stats = load_npz(args.params)
    else:
        params, batch_stats = restore_params(args.checkpoint_dir)
    if args.replicas > 1:
        serve_files_pooled(cfg, tokenizer, params, batch_stats, args.wavs,
                           replicas=args.replicas,
                           chunk_frames=args.chunk_frames,
                           decode=args.decode,
                           quantize=args.quantize_weights,
                           migrate_sessions=args.migrate_sessions,
                           device=args.device)
    else:
        serve_files(cfg, tokenizer, params, batch_stats, args.wavs,
                    chunk_frames=args.chunk_frames, decode=args.decode,
                    endpoint_silence_ms=args.endpoint_silence_ms,
                    endpoint_db=args.endpoint_silence_db,
                    quantize=args.quantize_weights, device=args.device)


if __name__ == "__main__":
    main()
