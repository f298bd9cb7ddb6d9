"""Chunked, state-carrying streaming inference for the lookahead variant.

The port of the JAX package's ``streaming.py``: the streaming model
(unidirectional GRU + lookahead convolution, ``ds2_streaming``) is
transcribed chunk by chunk, with an explicit carried state, and each
chunk's logits equal the offline ``DeepSpeech2`` forward on the whole
utterance (in eval mode; tests/test_torch_streaming.py).

Design (all lags in post-conv frames; the conv time stride is 2):

- **Conv frontend** (non-causal): overlap-recompute. The state carries
  the last ``HIST=32`` raw feature frames; each chunk runs the model's
  own ``ConvFrontend`` over ``hist ++ chunk`` and keeps only the ``K/2``
  interior outputs, whose receptive field lies inside the window. The
  conv stage emits with a constant lag of ``CONV_LAG=8`` frames.
- **GRU stack**: exact state. Each layer's carry crosses chunks as
  ``h0``/``hfin`` of ``ops/gru.py``'s ``gru_fwd`` (K6, D=1), or of
  ``gru_fwd_q`` (K10) when the int8 recurrent matrices stay int8.
  Frames before a stream's start or past its end are mask-held, as the
  offline model holds its padding, so the carry at a stream's first
  real frame is the offline h0 = 0.
- **Lookahead conv** (context C, future only): the state carries the
  last ``C-1`` RNN outputs; outputs emerge with lag ``C-1`` once their
  future context exists. The stream's tail is zero-padded as the
  offline right-pad is.
- **BN / head**: eval-mode batch norm is pointwise, so these stages
  carry nothing.

Total latency: ``CONV_LAG + C - 1`` conv frames, ``2*(8 + C - 1)`` raw
feature frames, on top of the chunk.

The engine is batched: B streams advance together, each with its own
start and length. The chunk's clock (``StreamState.emitted``) is a
Python int shared by the batch; the only device-to-host copy a chunk
makes is the frame ids ``decode_incremental`` reads.

``StreamingBeamDecoder`` carries the on-device prefix beam search
(decode/beam.py) across the chunks instead: its state stays on the
device, and chunks folded through it give the bits of one offline
``beam_search`` over the concatenated log-probs.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from .bridge import from_flax
from .config import Config, ModelConfig
from .data.infer_bucket import batch_rung
from .data.tokenizer import CharTokenizer
from .decode.beam import (NEG_INF, BeamState, beam_finalize, beam_init,
                          beam_search_chunk, reset_rows)
from .device import resolve_device
from .models.ds2 import DeepSpeech2
from .models.layers import clipped_relu, weight
from .ops import gru as gru_ops
from .ops.gru import card_limits
from .utils.quantize import keep_recurrent_q, quantize_params

HIST = 32  # raw-frame history for conv overlap-recompute (>= 2*lag)
CONV_LAG = 8  # conv-output frames withheld until their future context exists
_BIG = 2**30


@dataclasses.dataclass
class StreamState:
    """Carried across ``process_chunk`` calls. Tensors are batched
    ``[B, ...]`` on the engine's device; ``emitted`` is a host int."""

    raw_hist: torch.Tensor       # [B, HIST, F] f32, last raw feature frames
    h: Tuple[torch.Tensor, ...]  # per-layer GRU carries [B, H] f32
    la_buf: torch.Tensor         # [B, C-1, H] f32 lookahead context
    emitted: int                 # conv frames handed to the RNN so far
    raw_len: torch.Tensor        # [B] int64 true raw length (_BIG until known)
    # [B] int64 global raw-frame index where each stream STARTS (0 = the
    # batch's time origin). Frames before it are masked like the
    # pre-stream warmup, so a session that joins a running batch
    # mid-flight (serving/session.py) decodes as a stream that had the
    # batch to itself. Even (chunk-aligned), so the stride-2 grid stays
    # exact.
    raw_start: torch.Tensor


def _conv_halfwidth_raw(cfg: ModelConfig) -> int:
    """Conv-frontend receptive-field half-width, in raw feature frames:
    layer i's time kernel spans ±(k_i // 2) frames of its own input,
    scaled by the cumulative stride of the layers below."""
    r, stride = 0, 1
    for (tk, _, ts, _) in cfg.conv_layers:
        r += (tk // 2) * stride
        stride *= ts
    return r


def _check_streamable(cfg: ModelConfig) -> None:
    if cfg.bidirectional:
        raise ValueError("streaming needs a unidirectional model "
                         "(ds2_streaming preset)")
    if cfg.rnn_type != "gru":
        raise ValueError("streaming engine covers GRU stacks")
    if cfg.time_stride != 2:
        raise ValueError("streaming engine assumes conv time stride 2")
    # The overlap-recompute window must cover the conv receptive field,
    # or the logits near chunk seams would be silently wrong.
    r = _conv_halfwidth_raw(cfg)
    if 2 * CONV_LAG < r or HIST < 2 * CONV_LAG + r:
        raise ValueError(
            f"conv receptive field needs ±{r} raw frames, exceeding the "
            f"streaming window (CONV_LAG={CONV_LAG} -> {2 * CONV_LAG} "
            f"future, HIST={HIST} past; need 2*CONV_LAG >= {r} and "
            f"HIST >= {2 * CONV_LAG + r}); shrink conv time kernels or "
            "enlarge streaming.HIST/CONV_LAG")


class StreamingTranscriber:
    """Incremental transcription with exact offline equivalence.

    >>> st = StreamingTranscriber(cfg, params, batch_stats, tokenizer)
    >>> state = st.init_state(batch=1)
    >>> for chunk in feature_chunks:           # [B, chunk_frames, F]
    ...     state, logits, valid = st.process_chunk(state, chunk)
    >>> state, logits, valid = st.finish(state, raw_lens)

    ``params`` / ``batch_stats`` are flax-layout numpy trees, as
    ``Inferencer`` takes them. ``device`` None means the card (raises
    without CUDA); "cpu" runs the plain versions. ``quantize="int8"``
    quantizes ``params`` once here into a ``DeepSpeech2(quantized=True)``;
    its recurrent matrices stay int8 into ``gru_fwd_q`` where
    ``keep_recurrent_q(streaming=True)`` says the resident kernel holds
    them, else they are dequantized into ``gru_fwd``.
    """

    def __init__(self, cfg: Config, params, batch_stats,
                 tokenizer: Optional[CharTokenizer] = None,
                 chunk_frames: int = 64, quantize: str = "",
                 device=None):
        _check_streamable(cfg.model)
        if chunk_frames % 2 or chunk_frames < 4 * CONV_LAG:
            raise ValueError("chunk_frames must be even and >= "
                             f"{4 * CONV_LAG}")
        if quantize and quantize != "int8":
            raise ValueError(f"quantize={quantize!r}; only 'int8'")
        self.cfg = cfg
        self.mcfg = cfg.model
        self.tokenizer = tokenizer
        self.chunk_frames = chunk_frames
        self.num_features = cfg.features.num_features
        self.device = resolve_device(device)
        self.quantize_report = None
        if quantize:
            params, self.quantize_report = quantize_params(params)
        card = card_limits(self.device) if self.device.type == "cuda" else ()
        self._keep_q = (keep_recurrent_q(cfg.model, streaming=True,
                                         card=card)
                        if quantize else None)
        self.model = DeepSpeech2(cfg.model, self.num_features,
                                 quantized=bool(quantize))
        self.model.load_state_dict(from_flax(params, batch_stats or {}))
        self.model.to(self.device).eval()
        self._dtype = getattr(torch, cfg.model.dtype)
        # Each layer's recurrent operands as its kernel takes them, made
        # once: int8 Q and scales, or W in the dot dtype (dequantized
        # when the int8 kernel does not hold it), with D = 1.
        self._rec = []
        with torch.no_grad():
            for i in range(cfg.model.rnn_layers):
                layer = getattr(self.model.rnn, f"rnn{i}")
                b = layer.bh_fw.float()[None].contiguous()
                if self._keep_q is not None:
                    self._rec.append((layer.wh_fw.q[None].contiguous(),
                                      layer.wh_fw.scale[None].contiguous(),
                                      b))
                else:
                    w = weight(layer.wh_fw).to(self._dtype)
                    self._rec.append((w[None].contiguous(), b))

    # -- state ----------------------------------------------------------
    def init_state(self, batch: int) -> StreamState:
        m, dev = self.mcfg, self.device
        c = max(m.lookahead_context - 1, 0)
        return StreamState(
            raw_hist=torch.zeros((batch, HIST, self.num_features),
                                 device=dev),
            h=tuple(torch.zeros((batch, m.rnn_hidden), device=dev)
                    for _ in range(m.rnn_layers)),
            la_buf=torch.zeros((batch, c, m.rnn_hidden), device=dev),
            emitted=-CONV_LAG,
            raw_len=torch.full((batch,), _BIG, dtype=torch.long,
                               device=dev),
            raw_start=torch.zeros((batch,), dtype=torch.long, device=dev),
        )

    # -- the chunk function ---------------------------------------------
    @torch.no_grad()
    def _chunk(self, state: StreamState, chunk: torch.Tensor):
        """chunk [B, K, F] f32 -> (state', logits [B, K/2, V] f32,
        valid [B, K/2] bool).

        ``valid[b, i]`` marks the logits rows of real (in-stream)
        post-conv frames; the other rows are pre-stream warmup or
        post-stream flush, for the caller to drop.
        """
        m, model, dtype = self.mcfg, self.model, self._dtype
        k = chunk.shape[1]
        window = torch.cat([state.raw_hist, chunk], dim=1)
        # Window raw frame w sits at global raw index g0 + w.
        g0 = 2 * (state.emitted + CONV_LAG) - HIST
        # Two-sided validity in raw frames: frames before a stream's
        # start and past its length are zeroed between conv layers,
        # where the offline model sees padding zeros and its mask.
        wlen = torch.clamp(state.raw_len - g0, 0, HIST + k)
        vstart = torch.clamp(state.raw_start - g0, min=0)
        conv_out, _ = model.conv(window, wlen, valid_start=vstart)
        # Interior outputs only: [CONV_LAG, CONV_LAG + K/2) of the window.
        n_new = k // 2
        x = conv_out[:, CONV_LAG:CONV_LAG + n_new]

        # Global post-conv frame indices of these outputs, and their
        # validity: at or past each stream's start, before its end.
        out_len = -(-state.raw_len // 2)
        start_out = state.raw_start // 2
        gidx = state.emitted + torch.arange(n_new, device=self.device)
        valid = ((gidx[None, :] >= start_out[:, None])
                 & (gidx[None, :] < out_len[:, None]))
        vmask = valid.float()
        mask_t = vmask.t().contiguous()

        # The GRU stack with each layer's carry; invalid frames are
        # mask-held, as the offline padding is.
        new_h: List[torch.Tensor] = []
        for i, rec in enumerate(self._rec):
            layer = getattr(model.rnn, f"rnn{i}")
            if m.rnn_batch_norm:
                x = layer.bn(x, vmask)
            xp = layer.wx(x.transpose(0, 1), dtype).contiguous()  # [T,B,3H]
            h0 = state.h[i][None]
            if len(rec) == 3:
                ys, hf = gru_ops.gru_fwd_q(xp, mask_t, *rec, h0)
            else:
                ys, hf = gru_ops.gru_fwd(xp, mask_t, *rec, h0)
            new_h.append(hf[0])
            x = (ys[0].transpose(0, 1) * vmask[:, :, None]).to(dtype)

        # Lookahead conv over [la_buf ++ x]; emits with lag C-1.
        ctx = m.lookahead_context
        la_buf = state.la_buf
        out_gidx = gidx
        if ctx > 0:
            xin = torch.cat([la_buf.to(dtype), x], dim=1)
            y = model.lookahead(xin)[:, :n_new]
            la_buf = torch.cat([la_buf, x.float()], dim=1)[:, n_new:]
            out_gidx = gidx - (ctx - 1)
            x = clipped_relu(y, m.relu_clip)

        x = model.bn_out(x, None)
        logits = model.head(x, dtype).float()
        out_valid = ((out_gidx[None, :] >= start_out[:, None])
                     & (out_gidx[None, :] < out_len[:, None]))
        new_state = StreamState(
            raw_hist=window[:, -HIST:].contiguous(),
            h=tuple(new_h),
            la_buf=la_buf.contiguous(),
            emitted=state.emitted + n_new,
            raw_len=state.raw_len,
            raw_start=state.raw_start,
        )
        return new_state, logits, out_valid

    # -- public API -----------------------------------------------------
    def _feats(self, x) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float32).to(self.device)
        return x[None] if x.dim() == 2 else x

    def process_chunk(self, state: StreamState, chunk) -> Tuple[
            StreamState, torch.Tensor, torch.Tensor]:
        chunk = self._feats(chunk)
        if chunk.shape[1] != self.chunk_frames:
            raise ValueError(
                f"chunk must have {self.chunk_frames} frames, "
                f"got {chunk.shape[1]}; pad the final chunk and call "
                "finish() with the true lengths")
        return self._chunk(state, chunk)

    def finish(self, state: StreamState, raw_lens, tail=None) -> Tuple[
            StreamState, torch.Tensor, torch.Tensor]:
        """Close the streams. ``raw_lens`` [B] are the true total
        raw-frame counts per stream (including ``tail``). ``tail`` is
        the final partial chunk ([B, <chunk_frames, F]) not yet sent —
        it is zero-padded here AFTER the true lengths are recorded, so
        padding never reaches the recurrent state. Returns the tail's
        (logits, valid) from the remaining chunks and the flush."""
        state = dataclasses.replace(state, raw_len=torch.as_tensor(
            np.asarray(raw_lens), dtype=torch.long).to(self.device))
        b = state.raw_hist.shape[0]
        outs, valids = [], []
        if tail is not None:
            tail = self._feats(tail)
            pad = self.chunk_frames - tail.shape[1]
            if pad < 0:
                raise ValueError("tail longer than chunk_frames")
            tail = torch.nn.functional.pad(tail, (0, 0, 0, pad))
            state, lo, va = self._chunk(state, tail)
            outs.append(lo)
            valids.append(va)
        zeros = torch.zeros((b, self.chunk_frames, self.num_features),
                            device=self.device)
        for _ in range(self.flush_chunks()):
            state, lo, va = self._chunk(state, zeros)
            outs.append(lo)
            valids.append(va)
        return state, torch.cat(outs, 1), torch.cat(valids, 1)

    def flush_chunks(self) -> int:
        """Chunks ``finish`` runs after the tail: the lag, rounded up,
        plus one."""
        lag = CONV_LAG + max(self.mcfg.lookahead_context - 1, 0)
        return -(-(2 * lag) // self.chunk_frames) + 1

    # -- convenience: full-utterance streaming decode -------------------
    def transcribe(self, features, raw_lens=None
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """Stream [B, T, F] through chunking; return (logits [B, T', V],
        out_lens [B]) as numpy, equal to the offline forward (valid rows
        packed left). For tests and batch evaluation of the engine."""
        features = np.asarray(features, np.float32)
        if features.ndim == 2:
            features = features[None]
        b, t, f = features.shape
        raw_lens = (np.full((b,), t, np.int64) if raw_lens is None
                    else np.asarray(raw_lens).astype(np.int64))
        # Pad B to its power-of-two rung with raw_len-0 rows (masked from
        # the first chunk, stripped below), as the JAX engine does to
        # reuse one compiled shape.
        b_pad = batch_rung(b)
        if b_pad > b:
            features = np.concatenate(
                [features, np.zeros((b_pad - b, t, f), np.float32)])
            raw_lens = np.concatenate(
                [raw_lens, np.zeros((b_pad - b,), np.int64)])
        feats = self._feats(features)
        k = self.chunk_frames
        n_full = t // k
        state = self.init_state(b_pad)
        # Lengths are known up front here, so record them at once: each
        # stream's padding is masked out of the recurrence, as offline.
        state = dataclasses.replace(
            state, raw_len=torch.as_tensor(raw_lens).to(self.device))
        chunks_l, chunks_v = [], []
        for i in range(n_full):
            state, lo, va = self._chunk(state, feats[:, i * k:(i + 1) * k])
            chunks_l.append(lo)
            chunks_v.append(va)
        tail = feats[:, n_full * k:] if t % k else None
        state, lo, va = self.finish(state, raw_lens, tail=tail)
        lo = torch.cat(chunks_l + [lo], 1)[:b].cpu().numpy()
        va = torch.cat(chunks_v + [va], 1)[:b].cpu().numpy()
        out_lens = -(-raw_lens[:b] // 2)
        out = np.zeros((b, int(out_lens.max(initial=0)), lo.shape[-1]),
                       np.float32)
        for i in range(b):
            rows = lo[i][va[i]]
            out[i, :rows.shape[0]] = rows
        return out, out_lens

    def decode_incremental(self, state_prev_ids, logits, valid
                           ) -> Tuple[np.ndarray, List[str]]:
        """CTC greedy collapse across chunk boundaries.

        ``state_prev_ids`` [B] is the last emitted frame id per stream
        (init to blank=0). Returns (new prev_ids, list of new text per
        stream). One copy crosses to the host: the frame ids, -1 where
        a row is not valid."""
        if self.tokenizer is None:
            raise ValueError("decode_incremental needs a tokenizer")
        prev = np.asarray(state_prev_ids).copy()
        ids = torch.where(torch.as_tensor(valid),
                          torch.argmax(torch.as_tensor(logits), dim=-1),
                          -1).cpu().numpy()
        texts = []
        for b in range(ids.shape[0]):
            out = []
            for i in ids[b]:
                if i < 0:
                    continue
                if i != 0 and i != prev[b]:
                    out.append(i)
                prev[b] = i
            texts.append(self.tokenizer.decode(np.asarray(out, np.int64)))
        return prev, texts


class StreamingBeamDecoder:
    """CTC prefix beam search carried across streaming chunks.

    The port of the JAX package's ``StreamingBeamDecoder``. The search
    keeps its whole state as dense tensors on the device, so streaming
    it is carrying that state between chunks: chunks folded through
    ``advance`` give the same bits as one offline ``beam_search`` over
    the concatenated frames, on-device LM fusion included (the LM
    context rides in the state). Pair it with
    ``StreamingTranscriber.process_chunk``; ``finish`` flushes the
    conv/lookahead lag and applies each stream's length::

        st = StreamingTranscriber(cfg, params, stats, tok, chunk_frames=64)
        bd = StreamingBeamDecoder(beam_width=16, max_len=200,
                                  lm_table=table)          # table optional
        state, bstate = st.init_state(batch=B), bd.init(batch=B)
        for chunk in feature_chunks:
            state, logits, valid = st.process_chunk(state, chunk)
            bstate = bd.advance(bstate, logits, valid)
        state, logits, valid = st.finish(state, raw_lens, tail=tail)
        bstate = bd.advance(bstate, logits, valid)         # the lag flush
        prefixes, lens, scores = bd.result(bstate)         # best first

    ``device`` None means the card (raises without CUDA); "cpu" runs on
    the CPU. ``lm_table`` (a dense table as a numpy array or tensor, or
    a ``HashedFusionTable``) is moved to that device.
    """

    def __init__(self, beam_width: int = 16, max_len: int = 200,
                 prune_top_k: int = 40, blank_id: int = 0, lm_table=None,
                 merge_impl: str = "auto", device=None):
        self.beam_width = beam_width
        self.max_len = max_len
        self.prune_top_k = prune_top_k
        self.blank_id = blank_id
        self.merge_impl = merge_impl
        self.device = resolve_device(device)
        if isinstance(lm_table, np.ndarray):
            lm_table = torch.from_numpy(lm_table)
        self.lm_table = (lm_table.to(self.device) if lm_table is not None
                         else None)

    def init(self, batch: int) -> BeamState:
        return beam_init(batch, self.beam_width, self.max_len,
                         device=self.device)

    def advance(self, bstate: BeamState, logits, valid) -> BeamState:
        """Fold one chunk's (logits [B, Tc, V], valid [B, Tc]) into the
        beam state. Takes raw logits: the log-softmax is taken here, so
        ``process_chunk``'s output goes in as it is."""
        lp = torch.log_softmax(
            torch.as_tensor(logits).to(self.device, torch.float32), dim=-1)
        return beam_search_chunk(
            bstate, lp, torch.as_tensor(valid).to(self.device),
            prune_top_k=self.prune_top_k, blank_id=self.blank_id,
            lm_table=self.lm_table, merge_impl=self.merge_impl)

    def result(self, bstate: BeamState):
        """(prefixes [B, W, Lmax], lens [B, W], scores [B, W]) on the
        device, best first; the scores hold the LM bonus when fusing."""
        return beam_finalize(bstate)

    def stable_prefix(self, bstate: BeamState, margin: float = 10.0
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Longest common prefix of the *plausible* beams, per stream:
        the symbols every hypothesis within ``margin`` log-score of the
        best agrees on (the beam always carries W hypotheses however
        improbable, so an unweighted common prefix would rarely commit
        anything). Returns host (ids [B, Lmax] int32, lens [B] int32).
        It can shrink between chunks when beams diverge."""
        prefixes, lens, scores = (a.cpu().numpy()
                                  for a in beam_finalize(bstate))
        b, _, lmax = prefixes.shape
        out = np.zeros((b, lmax), np.int32)
        out_lens = np.zeros((b,), np.int32)
        for i in range(b):
            live = scores[i] > max(float(np.float32(NEG_INF)),
                                   scores[i, 0] - margin)
            if not live.any():
                continue
            ps = prefixes[i][live]
            ls = lens[i][live]
            n = int(ls.min())
            agree = (ps[:, :n] == ps[0:1, :n]).all(axis=0) if n else \
                np.zeros((0,), bool)
            stop = int(np.argmin(agree)) if not agree.all() else n
            out[i, :stop] = ps[0, :stop]
            out_lens[i] = stop
        return out, out_lens

    def reset_streams(self, bstate: BeamState, reset_mask) -> BeamState:
        """Re-initialise the beams of the streams where ``reset_mask``
        [B] is True, leaving the others as they are: segment
        endpointing restarts a stream's transcript while its acoustic
        state flows on."""
        return reset_rows(bstate, torch.as_tensor(np.asarray(reset_mask,
                                                             bool)))
