#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (deepspeech_tpu_torch) on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It

1. prints the card's name and power limit (nvidia-smi);
2. builds every kernel under deepspeech_tpu_torch/csrc with nvcc, one
   process per source, all started together;
3. kernel phases: holds each kernel against its plain PyTorch version on
   the card at the main paths' shapes, checks that two runs of each new
   kernel give the same bits, and times the kernel, the plain version
   and one PyTorch library call that computes the same function with
   CUDA events:
   - ``gru_fwd`` (the resident kernel) at B=32, T'=850 (the 1700-frame
     bucket over time stride 2), H=800, ragged lengths (library:
     cuDNN's GRU); also at T=37 with B=45 and h0 at both D, with B=8, at
     H=104, at D=2 H=536 (a partial group of 16), H=528 (132 groups of
     8) and H=1056 (132 of 16), and at D=1 H=1728 (the widest the rule
     admits), each check naming the device kernels that ran (in bf16
     with H % 8 == 0 the transpose of W and the tensor-core loop, else
     the CUDA-core kernel);
   - ``gru_bwd`` at the same shapes (library: cuDNN's GRU backward);
   - ``ctc_alpha`` (with and without its tape) and ``ctc_beta`` at B=32,
     T'=850, labels of about 15 characters a second, S <= 513
     (library: ``torch.nn.functional.ctc_loss``), and checked also at
     ``ctc_variants.CHECKS``' shapes (T=37 with B=45, B=8, S=1, S=1024,
     B=64 and B=128, V=4336), each printing the plan it launched with
     and whether ll, the tape, gamma, the loss and dlogits equal the
     plain version's bit for bit;
   - ``gru_fwd_stream`` and ``gru_bwd_stream`` (W streamed every step)
     at ds2_full's B=32, T'=850, H=1760 (library: cuDNN's GRU at
     H=1760, forward and backward timed apart); ``gru_fwd_stream`` also
     at T=37 with B=45 and h0 and with B=8, at H=104 and at H=2176 (more
     groups than SMs), each check naming the device kernels that ran (in
     bf16 with H % 8 == 0 the transpose of W and the tensor-core loop,
     else the CUDA-core kernel); ``gru_bwd_stream`` also at T=37 with
     B=45 (bf16 and f32) and B=8, at H=104 and at H=2176, each check
     naming the device kernels that ran (in bf16 with H % 8 == 0 the gate
     pre-pass GEMM and the tensor-core loop, else the two-phase kernel);
   - ``gru_fwd_q`` (int8 W resident) at ds2_full's H=1760, D=2 and at
     H=800, D=1 with h0 (the streaming path's shape; timed at both), and ``gru_fwd_q_stream`` (int8 W streamed) at
     H=1760, both also at T=37 with B=45 and h0 and with B=8 at full
     width and at H=104, ``gru_fwd_q`` at the residency rule's edges (D=2
     H=1920, D=1 H=2112: Q^T partly held) and ``gru_fwd_q_stream`` at
     H=2176 (more groups than SMs), each check naming the device kernels
     that ran (with bf16 dots and H % 8 == 0 the transpose of Q and the
     tensor-core loop, else the CUDA-core kernel) (library: cuDNN's GRU in
     bf16 on the dequantized W);
   - ``lstm_fwd`` (W resident) at H=800, D=2 and D=1, with and without
     its cell-state tape, and at T=37 with B=45 at both D, with B=8, at
     H=104, at D=2 H=808 (a partial group of 16) and H=1056 and at D=1
     H=1216 (the widest the rule admits at each D), and at H=804 and
     H=100 (off its H % 8 rule), each check naming the device kernels
     that ran (in bf16 with H % 8 == 0 the transpose of W and the
     tensor-core loop, else the CUDA-core kernel); ``lstm_fwd_stream``
     (W streamed) at ds2_full's H=1760, D=2, with and without the tape,
     and at T=37 with B=45 and B=8, at H=104 and at H=2176 (more groups
     than SMs), each check naming the device kernels that ran
     (in bf16 the transpose of W and the tensor-core loop);
     ``lstm_fwd_q`` (int8 W resident) at H=800, D=2 and D=1, and at
     T=37 with B=45 at both D, with B=8, at H=104, at D=2 H=808 and
     H=1056 and at D=1 H=1216 (the widest its bf16 rule admits), at
     H=804 (off its H % 8 rule) and at D=1 H=1280 (past its bf16 rule:
     the streamed kernel); ``lstm_fwd_q_stream`` (int8 W streamed) at
     H=1760, D=2, and at T=37 with B=45 (bf16 and f32) and B=8, at
     H=104 and H=108 (either side of its H % 8 rule) and at H=2176; each
     check naming the device kernels that ran (with bf16 dots and H % 8
     == 0 the transpose of Q, widened to bf16 for ``lstm_fwd_q``, and the
     tensor-core loop, else the CUDA-core kernel) (library: cuDNN's LSTM
     in bf16 at the same H, the forget gate's +1 folded into its
     ``bias_hh``, on the dequantized W for the int8 kernels);
   - ``lstm_bwd`` (W resident) at H=800, D=2 and D=1, and at T=37 with
     B=45 at both D and B=8, at H=104, 832, 1056 (D=2) and 1280 (D=1),
     and at H=804 and H=100 (off its H % 8 rule); and ``lstm_bwd_stream``
     (W streamed) at ds2_full's H=1760, D=2 (also timed at H=800), and
     at T=37 with B=45 and B=8 and at H=99; on the tape of
     ``lstm_fwd(..., tape=True)``, each check naming the device kernels
     that ran (in bf16 on the rule the gate pre-pass and the tensor-core
     loop, else the CUDA-core kernel) (library: cuDNN's bf16 LSTM
     backward alone, the +1 folded as above);
   each GRU kernel at D=2 and D=1 (the forward with h0), bf16 and f32,
   and at one ragged shape off its tiles, each checked to have run the
   kernel meant (resident or streamed) by the launch counts; each LSTM
   kernel the same at its D, without h0;
4. inference path phases: greedy inference through
   ``Inferencer.decode_batch_bucketed`` at the full width of ds2_small
   (3 BiGRU layers: 3 ``gru_fwd`` launches per forward), ds2_streaming
   (5 GRU layers + lookahead: 5 ``gru_fwd``) and ds2_full (7 BiGRU
   layers at H=1760: 7 ``gru_fwd_stream``, one per layer with both
   directions in it) from a seeded random init, on a request of mixed
   lengths and a full (32, 1700) rung; counts the launches and holds the
   RNN stack's output against the same forward with the plain GRU,
   beside a mis-directed GRU that the check must reject;
   int8 path phases: the same through ``Inferencer(quantize="int8")``
   on ds2_full (7 ``gru_fwd_q`` per forward, regime "resident-q"), on
   ds2_full with ``resident_fits`` patched in this script to refuse the
   int8 kernel (7 ``gru_fwd_q_stream``, "blocked-q"), ds2_small (3) and
   ds2_streaming (5); then, for information, the int8 engine against
   the bf16 one on ds2_full (log-probs, transcripts, bytes, peak device
   memory);
   LSTM path phases: the same with ``model.rnn_type=lstm`` on the same
   presets' widths: ds2_small (3 ``lstm_fwd`` per forward), ds2_streaming
   (5 ``lstm_fwd``, D=1), ds2_full (7 ``lstm_fwd_stream``), and through
   ``Inferencer(quantize="int8")`` ds2_small (3 ``lstm_fwd_q``,
   "resident-q"), ds2_streaming (5 ``lstm_fwd_q``, D=1) and ds2_full
   (7 ``lstm_fwd_q_stream``, "blocked-q"),
   no GRU kernel on an LSTM path and no LSTM kernel on a GRU path, each
   against the same forward with the LSTM kernel patched to its plain
   version, beside an LSTM with one direction reversed;
5. training path phases: ``Trainer`` steps at the full width of
   ds2_small, ds2_streaming and ds2_full (2 of its 7 layers,
   ``FULL_TRAIN_LAYERS``) on a (32, 1700) batch of ragged lengths, GRU
   and then LSTM (``model.rnn_type=lstm``); counts
   the launches per step (one recurrent forward and one backward per
   layer: ``gru_fwd``/``gru_bwd`` or the taped ``lstm_fwd`` and
   ``lstm_bwd`` for the first two, the streamed kernels for ds2_full;
   no kernel of the other cell), holds the whole model's gradient
   against the same step with every kernel patched to its plain
   version, in bf16 and f32 (and a mis-directed backward that the check
   must reject), and takes AdamW steps on the fixed batch whose loss,
   measured without a gradient (the loss-only kernel), must fall;
6. the manifest phase: ds2_small at full width (B=32) on 128 WAV files
   written from a seed (32 a bucket of 400, 800, 1200 and 1700 frames)
   trains 2 epochs (8 steps) through ``DataPipeline`` (augmented, with
   SpecAugment), ``device_prefetch`` and ``Trainer.fit``, checkpointing
   every 3 steps and at each epoch's end; with step 8 deleted a fresh
   Trainer restores step 6 and must end bit-identical to the first run
   (parameters and optimizer state), the prefetched batches equal to the
   host's; ``Inferencer(params=None)`` then decodes 40 eval WAVs through
   ``decode_batch_bucketed``, its log-probs on a (32, 1700) rung equal
   to the trained model's (3 ``gru_fwd`` a forward), and
   ``restore_params(average_last=2)`` must be the mean of steps 6 and
   8; the launches of K1-K5 on this path join the ``kernels`` line, and
   the step with and without ``device_prefetch``, the featurization, the
   checkpoint's bytes and seconds are printed;
7. the live streaming phases, on ds2_streaming at full width from the
   seeded init with the head scaled by 8 and every BN running mean
   moved by +0.3: ``StreamingTranscriber.transcribe`` of 32 streams of
   300..1700 frames in chunks of 64 against the offline forward on the
   same batch (f32: log-probs within 1e-4, identical transcripts; bf16
   and int8 within ``STREAM_LP_TOL``), exactly 5 ``gru_fwd`` (K6 with a
   carried h0; int8: ``gru_fwd_q``, K10, "resident-q") launches a chunk
   and no other recurrent kernel, and the same run through the plain
   GRU with each call's kernel held to it; ``StreamingSessionManager``
   with a mid-flight join, a tail and an export/import between two
   managers, each final and each session's logits equal to its solo
   run's at the same capacity, and the snapshot's bytes;
   ``serve.serve_files`` on 8 WAVs written from a seed, its finals equal
   to ``Inferencer(decode.mode="streaming")``'s, and once with
   endpointing; a chunk's ms (CUDA events, wall, the profiler's busy
   time by kernel and the W transpose's share) at capacity 1 and 32;
   ``Inferencer.run`` through ``device_prefetch`` and pageable, ms a
   batch, for information;
8. the serving plane: ``serve.serve_files_pooled`` on the same 8 WAVs
   over 2 replicas, then with ``migrate_sessions`` and r0's breaker
   forced open after chunk 3 (at least one migration, no drain
   fallback), the finals equal across the runs and to each stream's
   solo manager, 5 ``gru_fwd`` a manager step; and ds2_small behind the
   ``MicroBatchScheduler`` gateway over a ``ReplicaPool`` of
   ``Replica.from_inferencer`` replicas: 64 requests on two bf16
   replicas decoding at once on their own streams (a ``FaultPlan``
   fails r0's first dispatch), then a premium bf16 and a bulk int8
   replica; every request ok, every text equal to its replica's serial
   re-decode of the same micro-batch (the first one's log-probs bit for
   bit), exactly 3 ``gru_fwd`` or ``gru_fwd_q`` a decoded micro-batch,
   one compile a distinct rung, each round under a 120 s watchdog; one
   micro-batch decoded by both replicas at once under the profiler (and
   the watchdog)
   shows whether the two cooperative loops ran at the same time; utt/s,
   dispatch p50/p95 and the replicas' busy seconds over wall time;
9. beam search and the LM: ``ds2_beam_lm`` (bf16, head x8) at full
   width on a (32, 1700) batch with W=128, P=28 (V-1): 3 ``gru_fwd`` (K4) a
   forward; ``beam`` on the card against the CPU on the same log-probs
   (2 rows: top-1 identical, scores within ``BEAM_SCORE_RTOL``), the
   sort and match merges agreeing, one step the same bits twice; with a
   seeded character trigram ARPA written by the phase,
   ``beam_fused_device`` through the dense and the hashed table (the
   same n-best) and ``beam_fused`` through the C++ decoder (its call
   counted) equal to the Python host decoder; ``aishell`` (V=4336)
   through ``beam_fused_device`` with a hashed character trigram; ms a
   batch of the forward, each search and the table builds, the search's
   share of the decode's device time and its launches a frame; then
   ``ds2_streaming`` on 8 seeded WAVs, bf16 and int8:
   ``StreamingBeamDecoder`` over the chunks equal bit for bit to one
   offline search, a ``decode="beam"`` manager's finals equal to the
   decoder's and four sessions migrated mid-stream ending bit-identical,
   5 ``gru_fwd`` (K6; int8 ``gru_fwd_q``, K10) a manager step; ``serve
   --decode=beam`` equal to ``Inferencer(decode.mode="beam")`` in f32
   and ``--quant-tier=premium`` equal to ``--decode=beam``; the wall ms
   of a manager step in beam and greedy at capacities 1 and 32;
   ``rescore_phase``: ``ds2_beam_lm`` behind the gateway on 32 requests
   with ``Replica.from_inferencer(nbest=True)`` and a ``RescoringPool``
   over the phase's character trigram: texts equal to ``nbest=False``,
   each n-best equal to ``decode_batch_nbest``, each revision host
   ``rescore_nbest``'s pick, a replay's revision stream the same, a
   fired brownout rescore rung shedding 32 of 32, 3 K4 a micro-batch;
   dispatch p50/p95 with and without, the pump's ms a job;
10. the serving plane's controllers (``controllers_phase``, on the
   serve phase's WAVs through ``serve.serve_files_pooled`` with
   ``migrate_sessions``, a drain window of 0 on a counting clock): a
   rolling swap to the same weights from chunk 1, while the streams
   play (``done``, both replicas swapped, canaries identical; the
   sessions re-pinned by drain equal to their two segments decoded
   alone), one to other weights under guardrail 0 (rolled back),
   ``--autoscale`` from 1 replica on a forced ``slo_burn_rate`` (one
   scale-up, one scale-down, the removed replica's manager released),
   the other finals equal to a run without controllers and 5 K6 a
   manager step, the device memory back after each run; ds2_small's
   premium bf16 + bulk int8 gateway whose autoscaler engages the ladder
   and then the tier-mix rung under forced queue pressure, the shifted
   premium requests on the bulk replica (K10, 3 a micro-batch) equal to
   its serial decodes; a rolling swap of two ``Inferencer``-backed
   ds2_small replicas under traffic (K4), its memory back; the ms of a
   swap and of a scale-up; then ``serve.main --models`` on the 4
   shortest WAVs over two port checkpoints with ``--tenant-config``
   (one stream shed at join), ``--decode=beam --lm-rescore`` on a
   vocabulary without a space, ``--status-port=0`` (its routes answered
   over loopback during the run, its port closed after), ``--timeline``
   and a swap of one model after the streams: each model's finals equal
   to that checkpoint served alone, at least one revision, each host
   ``rescore_nbest``'s pick over ``final_nbest``;
11. prints each phase's seconds on a line of its own, a
   ``{"kernels": [...]}`` line, the card line, and as the last line
   ``{"ok": true, "device": {...}}``.

Any failed check raises and the script exits non-zero; without CUDA it
exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import weakref
from unittest import mock

import numpy as np
import torch

SEED = 0
B, T, H = 32, 850, 800          # main-path shapes of the recurrence
PEAK_BF16_FLOPS = 989e12        # H100 SXM dense bf16, NVIDIA data sheet
PEAK_F32_FLOPS = 67e12          # H100 SXM f32 outside the tensor cores
PEAK_BYTES = 3.35e12            # H100 SXM HBM3
TOL = {torch.bfloat16: 3e-2, torch.float32: 1e-4}
# The LSTM backward kernels in bf16 (lstm_bwd, lstm_bwd_stream), max
# |kernel - plain| of dgates with dy ~ 0.1 N(0, 1): on an H100 they read
# 5e-5 to 2.6e-4 at every case of their phase, with max |plain| 3.1 (D=1)
# and 4.7 (D=2) at T'=850, B=32, H=800; K13 with its loop's product
# taken out, or 11 of a warp's 12-13 chunks of it, reads 0.79 to 0.87
# there (deepspeech_tpu_torch/k13_variants.py --ablate requires them to
# miss this limit).
LSTM_BWD_TOL = {torch.bfloat16: 2e-3, torch.float32: TOL[torch.float32]}
# The resident GRU backward (gru_bwd: K5 at D=2, K7 at D=1) in bf16, max
# |kernel - plain| of dxp and dgates with dy ~ 0.1 N(0, 1): on an H100 the
# tensor-core loop reads 1.1e-4 to 4.2e-4 at every case of its phase,
# with max |plain| 3.6-3.9 (D=2) and 4.1-4.5 (D=1) at T'=850, B=32,
# H=800; with its product taken out, or all but one of a warp's chunks of
# it, it reads 1.43 to 1.47 there (deepspeech_tpu_torch/k7_variants.py
# --ablate requires them to miss this limit).
GRU_BWD_TOL = {torch.bfloat16: 2e-3, torch.float32: TOL[torch.float32]}
# The resident GRU forward (gru_fwd: K4 at D=2, K6 at D=1) in bf16, max
# |kernel - plain| of ys and hfin: on an H100 the tensor-core loop reads
# 7.8e-4 to 1.7e-3 at every case of its phase, with max |plain| 1.0
# (D=2) and 1.6 (D=1, with h0) at T'=850, B=32, H=800; with its product
# taken out, or all but one of a warp's chunks of it, it reads 0.99 to
# 1.19 there (deepspeech_tpu_torch/k4_variants.py --ablate requires them
# to miss this limit).
GRU_FWD_TOL = {torch.bfloat16: 1e-2, torch.float32: TOL[torch.float32]}
# The resident LSTM forward (lstm_fwd: K12 at D=2 and D=1) in bf16, max
# |kernel - plain| of ys and the cs tape: on an H100 the tensor-core loop
# reads 2.8e-4 to 1.4e-3 at every case of its phase in two runs, with
# max |plain| of ys 0.96 (D=2) and 0.94 (D=1) at T'=850, B=32, H=800;
# with its product taken out, or all but one of a warp's chunks of it, it
# reads 0.97 to 2.2 there (deepspeech_tpu_torch/k12_variants.py --ablate
# requires them to miss this limit).
LSTM_FWD_TOL = {torch.bfloat16: 1e-2, torch.float32: TOL[torch.float32]}
# The resident int8 LSTM forward (lstm_fwd_q: K16 at D=2 and D=1) with
# bf16 dots, max |kernel - plain| of ys: on an H100 K12's loop on
# bf16(Q^T), the scale on the finished sums, reads 3.6e-4 to 1.2e-3 at
# every case of its phase, with max |plain| 0.96 (D=2) and 0.94 (D=1) at
# T'=850, B=32, H=800; with its product, all but one of a warp's chunks
# of it, or the scale taken out it reads 0.97 to 1.9 there
# (deepspeech_tpu_torch/k16_variants.py --ablate requires them to miss
# this limit).
LSTM_FWD_Q_TOL = {torch.bfloat16: 1e-2, torch.float32: TOL[torch.float32]}
# End to end, bf16: ||rnn - rnn_plain|| / ||rnn_plain|| over valid frames
# of the RNN stack's output. On an H100 the kernel reads 1.6e-3
# (ds2_small) and 2.8e-3 (ds2_streaming); a zeroed GRU reads 1, and a
# mis-directed one (the control in path_phase, read on every run) 0.25
# and 0.38.
RNN_REL_TOL = 2e-2
ARGMAX_FLOOR = 0.98             # share of valid frames, kernel vs plain
V, L_MAX = 29, 256              # ds2_small vocab; config max_label_len
# CTC kernel against its plain version, f32: the same arithmetic in the
# same order, so only exp/log rounding may differ; relative to
# max(1, |value|) over the states a path can reach.
CTC_TOL = 1e-5
# Train path: per parameter group, ||g - g_plain|| / ||g_plain|| of the
# whole model's gradient against the same step with every kernel patched
# to its plain version. bf16: on an H100 the kernels read at most 8.0e-3
# (ds2_small) and 3.0e-2 (ds2_streaming: bf16 rounding flips, amplified
# through five recurrences of 850 steps), and a gru_bwd with one
# direction run backwards (the control, read on every run) at least
# 0.52 and 1.05 in its largest group. f32 (the same weights and batch
# with model.dtype=float32): the kernels read 1.8e-4 and 7.4e-4, at the
# gradient's own noise floor: the plain path moves by 1.6e-3 and 1.2e-3
# when the features are scaled by 1 + 2**-22 (read on every run).
GRAD_REL_TOL = 0.1
GRAD_REL_TOL_F32 = 5e-3
TRAIN_STEPS = 3                 # timed steps per train phase
DESCENT_STEPS = 10              # AdamW steps on the fixed batch
# ds2_full (7 BiGRU, H=1760): a step takes seconds, so fewer of them.
FULL_TRAIN_STEPS = 2
FULL_DESCENT_STEPS = 5
# The ds2_full train phases, GRU and LSTM, run 2 of the 7 layers at full
# width: with all 7 the whole script took 708 s, with 3 678 s, past its
# 675 s budget (NVIDIA H100 80GB HBM3, 700 W).
FULL_TRAIN_LAYERS = 2
# The TPU kernels the GRU kernels replace (deepspeech_tpu/ops/).
K4 = "deepspeech_tpu/ops/rnn_pallas.py:155"   # _bigru_kernel
K5 = "deepspeech_tpu/ops/rnn_pallas.py:211"   # _bigru_bwd_kernel
K6 = "deepspeech_tpu/ops/rnn_pallas.py:85"    # _gru_kernel
K7 = "deepspeech_tpu/ops/rnn_pallas.py:113"   # _gru_bwd_kernel
K8 = "deepspeech_tpu/ops/rnn_pallas.py:260"   # _gru_kernel_blocked
K9 = "deepspeech_tpu/ops/rnn_pallas.py:312"   # _gru_bwd_kernel_blocked
K10 = "deepspeech_tpu/ops/rnn_pallas.py:581"  # _gru_kernel_q
K11 = "deepspeech_tpu/ops/rnn_pallas.py:282"  # _gru_kernel_blocked_q
# The TPU kernels the LSTM kernels replace (deepspeech_tpu/ops/).
K12 = "deepspeech_tpu/ops/lstm_pallas.py:89"   # _lstm_kernel
K14 = "deepspeech_tpu/ops/lstm_pallas.py:116"  # _lstm_kernel_blocked
K16 = "deepspeech_tpu/ops/lstm_pallas.py:292"  # _lstm_kernel_q
K17 = "deepspeech_tpu/ops/lstm_pallas.py:315"  # _lstm_kernel_blocked_q
K13 = "deepspeech_tpu/ops/lstm_pallas.py:147"  # _lstm_bwd_kernel
K15 = "deepspeech_tpu/ops/lstm_pallas.py:174"  # _lstm_bwd_kernel_blocked


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def _phase(name: str, fn, *args):
    """Run one phase, print its seconds on a line of its own, and return
    what it returned."""
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    print(json.dumps({"phase": name, "seconds": time.perf_counter() - t0}),
          flush=True)
    return out


def _time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _gru_inputs(d: int, dtype: torch.dtype, with_h0: bool, gen,
                t: int = T, b: int = B, h: int = H):
    dev = "cuda"
    lens = torch.randint(t // 3, t + 1, (b,), generator=gen, device=dev)
    lens[0] = t
    mask = (torch.arange(t, device=dev)[:, None] < lens[None, :]).float()
    xp = torch.randn(t, b, 3 * h, generator=gen, device=dev).to(dtype)
    w = (torch.randn(d, h, 3 * h, generator=gen, device=dev)
         / math.sqrt(h)).to(dtype)
    bias = torch.randn(d, 3 * h, generator=gen, device=dev) * 0.1
    h0 = (torch.randn(d, b, h, generator=gen, device=dev) * 0.5
          if with_h0 else None)
    reverse = (False, True)[:d]
    return (xp, mask.contiguous(), w, bias, h0, reverse), int(lens.sum())


def _quantize_w(w):
    """``w [D,H,GH]`` -> int8 ``q`` and f32 ``scale [D,GH]``, absmax per
    output column, as utils/quantize.py quantizes ``wh_*``."""
    scale = w.float().abs().amax(1) / 127.0
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(w.float() / scale[:, None]), -127, 127)
    return q.to(torch.int8).contiguous(), scale.contiguous()


def _gru_q_inputs(d: int, dtype: torch.dtype, with_h0: bool, gen,
                  t: int = T, b: int = B, h: int = H):
    """``_gru_inputs`` with W as int8 and per-column scales:
    ``(xp, mask, q, scale, bias, h0, reverse)``."""
    (xp, mask, w, bias, h0, reverse), valid = _gru_inputs(
        d, torch.float32, with_h0, gen, t, b, h)
    return (xp.to(dtype), mask, *_quantize_w(w), bias, h0, reverse), valid


def _bound(args, valid_rows: int):
    """Least time for gru_fwd (``args`` = xp, mask, w, b, h0, reverse)
    or gru_fwd_q (xp, mask, q, scale, b, h0, reverse) on these inputs,
    at their own shape: the larger of its product FLOPs on valid frames
    over the peak for the dot dtype, and each input read once plus each
    output written once over HBM bandwidth."""
    xp, mask, *weights, h0, _ = args
    (t, bsz, _), (d, h) = xp.shape, weights[0].shape[:2]
    peak = PEAK_BF16_FLOPS if xp.dtype == torch.bfloat16 else PEAK_F32_FLOPS
    ys_hfin = (d * t * bsz * h + d * bsz * h) * 4
    return _roofline(_nbytes(xp, mask, *weights, h0) + ys_hfin,
                     2.0 * valid_rows * d * h * 3 * h, peak)


def _require_only(kernel: str, n: int, others=None) -> None:
    """Since the last ``_zero_counts()``, ``kernel`` launched ``n`` times
    and its resident or streamed twin not once (or as many times as
    ``others`` says, ``{name: launches}``): the wrapper under test ran
    the kernel meant. Resets the counts."""
    family = kernel[:len("gru_fwd")]
    counts = {k: v for k, v in _counts().items() if k.startswith(family)}
    want = {k: n if k == kernel else (others or {}).get(k, 0)
            for k in counts}
    _require(counts == want, f"{kernel} checks: launches {counts}, want "
             f"{want}")
    _zero_counts()


def _roofline(nbytes: float, ops: float, peak: float):
    """(bound ms, what bounds it): the larger of the bytes over HBM
    bandwidth and the operations over ``peak``."""
    t_ops, t_bytes = ops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def gru_fwd_kernel_phase(gen, kernel: str, h: int, timed, d1_h=None):
    """Hold ``ops.gru.<kernel>`` (``gru_fwd``, which launches the
    resident kernel at these sizes, or ``gru_fwd_stream``; with int8 W
    ``gru_fwd_q``, resident at these sizes, or ``gru_fwd_q_stream``)
    against its plain version at T'=850, B=32 and width ``h`` (D=1:
    ``d1_h``, default ``h``), D=2 and D=1 with h0, bf16 and f32, and at
    one ragged shape off the kernels' tiles (H not a multiple of 16 or
    64, B above one 32-row pass); two runs must give the same bits.
    Every kernel is also held at full width off the tiles and at
    H=104, ``gru_fwd`` at both D and at its rule's widths (D=2 H=536,
    528 and 1056, D=1 H=1728), ``gru_fwd_stream`` and
    ``gru_fwd_q_stream`` at H=2176 and ``gru_fwd_q`` at D=2 H=1920 and
    D=1 H=2112, each check naming the device kernels its dtype and H
    select. Then time it for
    each ``(d, replaces)`` of ``timed``, with its bound, its plain
    version and cuDNN's GRU (for int8 W, on the dequantized W)."""
    from deepspeech_tpu_torch.ops import gru

    fn = getattr(gru, kernel)
    quantized = kernel.startswith("gru_fwd_q")
    make = _gru_q_inputs if quantized else _gru_inputs
    plain = gru.gru_fwd_q_plain if quantized else gru.gru_fwd_plain
    d1_h = d1_h or h
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [("D2_bf16", 2, bf16, False, (T, B, h)),
             ("D2_f32", 2, f32, False, (T, B, h)),
             ("D1_bf16_h0", 1, bf16, True, (T, B, d1_h)),
             ("D1_f32_h0", 1, f32, True, (T, B, d1_h)),
             ("D2_bf16_ragged", 2, bf16, True, (37, 45, 100))]
    if kernel == "gru_fwd":
        # On the tensor-core loop with all of W^T resident: at full width
        # with h0 (step 0 runs the product) and B above the 32 rows of a
        # pass, at both D; B=8 in a partly filled m16 tile; H=104, a
        # partial last 32-deep chunk; at D=2 H=536, 68 groups of 16, the
        # last of each direction partial, H=528, 132 groups of 8 on 132 SMs,
        # and H=1056, 132 groups of 16; at D=1 H=1728, the widest the rule
        # admits (226 KB a block). H=100 (above: bf16 with H % 8 != 0)
        # and f32 run the CUDA-core kernel.
        cases += [("D2_bf16_h0_ragged_full", 2, bf16, True, (37, 45, h)),
                  ("D1_bf16_h0_ragged_full", 1, bf16, True, (37, 45, h)),
                  ("D2_bf16_b8_full", 2, bf16, False, (37, 8, h)),
                  ("D2_bf16_h0_h104", 2, bf16, True, (37, 45, 104)),
                  ("D2_bf16_h0_h536", 2, bf16, True, (37, 45, 536)),
                  ("D2_bf16_h0_h528", 2, bf16, True, (37, 8, 528)),
                  ("D2_bf16_h0_h1056", 2, bf16, True, (37, 8, 1056)),
                  ("D1_bf16_h0_h1728", 1, bf16, True, (37, 8, 1728))]
    elif kernel == "gru_fwd_stream":
        # On the tensor-core loop: at full width with h0 (step 0 runs the
        # product) and B above the 32 rows of a pass; B=8 in a partly
        # filled m16 tile; H=104, a multiple of 8 with a partial last
        # 32-unit group; H=2176, 136 groups on an H100's 132 SMs, so some
        # blocks take two groups a step and no W^T stays resident. H=100
        # (above: bf16 with H % 8 != 0) and f32 run the CUDA-core kernel.
        cases += [("D2_bf16_h0_ragged_full", 2, bf16, True, (37, 45, h)),
                  ("D2_bf16_b8_full", 2, bf16, False, (37, 8, h)),
                  ("D2_bf16_h0_h104", 2, bf16, True, (37, 45, 104)),
                  ("D2_bf16_h0_h2176", 2, bf16, True, (37, 8, 2176))]
    elif quantized:
        # The int8 kernels' tensor-core loop (bf16 dots, H % 8 == 0), as
        # for gru_fwd_stream above; gru_fwd_q also at the residency rule's
        # edges, where a block holds 6 of a warp's 8 or 9 chunks of Q^T and
        # streams the rest, and gru_fwd_q_stream at H=2176, where blocks
        # walk two groups and hold none. H=100 and f32 run the CUDA-core
        # kernels.
        cases += [("D2_bf16_h0_ragged_full", 2, bf16, True, (37, 45, h)),
                  ("D2_bf16_b8_full", 2, bf16, False, (37, 8, h)),
                  ("D2_bf16_h0_h104", 2, bf16, True, (37, 45, 104))]
        cases += ([("D2_bf16_h0_h1920", 2, bf16, True, (37, 8, 1920)),
                   ("D1_bf16_h0_h2112", 1, bf16, True, (37, 8, 2112))]
                  if kernel == "gru_fwd_q" else
                  [("D2_bf16_h0_h2176", 2, bf16, True, (37, 8, 2176))])
    tols = GRU_FWD_TOL if kernel == "gru_fwd" else TOL
    _zero_counts()
    checks, calls = {}, 0
    for name, d, dtype, with_h0, shape in cases:
        args, valid = make(d, dtype, with_h0, gen, *shape)
        if kernel in _STREAM_KERNELS:
            want = _STREAM_KERNELS[kernel](dtype, shape[2])
            outs, ran, runs = _device_kernels(
                lambda: [fn(*args) for _ in range(2)], want=frozenset(want))
            calls += 2 * runs
            _require(set(ran) == want, f"{kernel} {name}: ran {sorted(ran)}, "
                     f"want {sorted(want)}")
        else:
            outs = [fn(*args) for _ in range(2)]
            calls += 2
        (ys, hfin), (ys2, hfin2) = outs
        torch.cuda.synchronize()
        ys_p, hfin_p = plain(*args)
        err = max(float((ys - ys_p).abs().max()),
                  float((hfin - hfin_p).abs().max()))
        _require(bool(torch.isfinite(ys).all()), f"{name}: non-finite ys")
        _require(err <= tols[dtype],
                 f"{kernel} {name}: max |kernel - plain| {err} > "
                 f"{tols[dtype]}")
        _require(torch.equal(ys, ys2) and torch.equal(hfin, hfin2),
                 f"{kernel} {name}: two runs on one input differ")
        checks[name] = {"max_abs_err": err, "tol": tols[dtype],
                        "bit_identical": True}
        if kernel in _STREAM_KERNELS:
            checks[name]["kernels"] = sorted(ran)
        print(json.dumps({"check": f"{kernel} {name}", **checks[name]}),
              flush=True)
        del args, outs
    _require_only(kernel, calls)

    entries = []
    for d, replaces in timed:
        check = "D2_bf16" if d == 2 else "D1_bf16_h0"
        hd = d1_h if d == 1 else h
        args, valid = make(d, torch.bfloat16, False, gen, T, B, hd)
        ms = _time_ms(lambda: fn(*args), reps=5)
        plain_ms = _time_ms(lambda: plain(*args), reps=1)
        cudnn = torch.nn.GRU(hd, hd, bidirectional=d == 2)
        if quantized:
            # No PyTorch call computes an int8-weight GRU: the yardstick
            # is cuDNN's bf16 GRU on the dequantized W (gate order r, z,
            # n in both; cuDNN holds W^T per direction), set before the
            # move so that cuDNN packs it with the rest.
            q, scale = args[2], args[3]
            with torch.no_grad():
                for di, sfx in enumerate(("", "_reverse")[:d]):
                    getattr(cudnn, f"weight_hh_l0{sfx}").copy_(
                        (q[di].float() * scale[di]).t().cpu())
        cudnn = cudnn.to("cuda", torch.bfloat16)
        cudnn.flatten_parameters()
        x_lib = torch.randn(T, B, hd, generator=gen, device="cuda").to(
            torch.bfloat16)
        with torch.no_grad():
            library_ms = _time_ms(lambda: cudnn(x_lib), reps=5)
        bound_ms, bound_by = _bound(args, valid)
        # The same call at B=1. A block computes a 32-row batch tile
        # whatever B is, so this is the part of the time that does not
        # scale with B up to 32.
        args_b1 = tuple(a[:, :1].contiguous() if i < 2 else a
                        for i, a in enumerate(args))
        ms_b1 = _time_ms(lambda: fn(*args_b1), reps=5)
        extra = {}
        if kernel in _STREAM_KERNELS:
            # One call's device time by kernel (in bf16: the transpose of
            # W and the serial loop).
            _, extra["device_ms"], _ = _device_kernels(
                lambda: fn(*args), want=frozenset(
                    _STREAM_KERNELS[kernel](torch.bfloat16, hd)))
        if kernel.endswith("_stream") or quantized:
            # At H=800, where the resident kernel runs: for a streamed
            # kernel what the residency rule saves there; for the int8
            # kernels their time beside the bf16 resident kernel's.
            args_h, _ = make(d, torch.bfloat16, False, gen)
            extra["ms_at_h800"] = _time_ms(lambda: fn(*args_h), reps=3)
        if quantized:
            extra["library"] = "cuDNN GRU, bf16, dequantized W"
        entries.append({
            "name": f"{kernel}[D={d}]", "route": "cuda",
            "source": f"deepspeech_tpu_torch/csrc/{kernel}.cu",
            "replaces": replaces, "launches": 0,
            "max_abs_err": checks[check]["max_abs_err"],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "ms_at_b1": ms_b1, **extra,
            "shape": {"D": d, "T": T, "B": B, "H": hd, "dtype": "bfloat16",
                      "w_dtype": "int8" if quantized else "bfloat16",
                      "valid_rows": valid},
            "checks": {k: v for k, v in checks.items()
                       if k.startswith(f"D{d}_")}})
        print(json.dumps({"timed": entries[-1]["name"], "ms": ms,
                          "ms_at_b1": ms_b1, "plain_ms": plain_ms,
                          "library_ms": library_ms, "bound_ms": bound_ms,
                          **extra}), flush=True)
    return entries


def _lstm_inputs(d: int, dtype: torch.dtype, gen, t: int = T, b: int = B,
                 h: int = H, quantized: bool = False):
    """The arguments of ``lstm_fwd`` ``(xp [T,B,4H], mask, w [D,H,4H], b,
    reverse)``, or with ``quantized`` of ``lstm_fwd_q`` ``(xp, mask, q,
    scale, b, reverse)``, on ragged lengths; and the valid rows."""
    dev = "cuda"
    lens = torch.randint(t // 3, t + 1, (b,), generator=gen, device=dev)
    lens[0] = t
    mask = (torch.arange(t, device=dev)[:, None] < lens[None, :]).float()
    xp = torch.randn(t, b, 4 * h, generator=gen, device=dev).to(dtype)
    w = torch.randn(d, h, 4 * h, generator=gen, device=dev) / math.sqrt(h)
    bias = torch.randn(d, 4 * h, generator=gen, device=dev) * 0.1
    weights = _quantize_w(w) if quantized else (w.to(dtype).contiguous(),)
    return ((xp, mask.contiguous(), *weights, bias, (False, True)[:d]),
            int(lens.sum()))


def _cudnn_lstm(args, h: int):
    """cuDNN's LSTM in bf16 computing the function of ``lstm_fwd``'s (or,
    on the dequantized W, ``lstm_fwd_q``'s) ``args`` from its own input
    projection: the same gate order (i, f, g, o); cuDNN holds W^T per
    direction and has no +1 on the forget gate, so the +1 goes into its
    ``bias_hh``. Set before the move, so that cuDNN packs them."""
    xp, mask, *weights, bias, reverse = args
    w = (weights[0].float() * weights[1][:, None] if len(weights) == 2
         else weights[0].float())
    lib = torch.nn.LSTM(h, h, bidirectional=len(reverse) == 2)
    with torch.no_grad():
        for di, sfx in enumerate(("", "_reverse")[:len(reverse)]):
            getattr(lib, f"weight_hh_l0{sfx}").copy_(w[di].t().cpu())
            b_hh = bias[di].clone()
            b_hh[h:2 * h] += 1.0
            getattr(lib, f"bias_hh_l0{sfx}").copy_(b_hh.cpu())
    lib = lib.to("cuda", torch.bfloat16)
    lib.flatten_parameters()
    return lib


def _device_kernels(fn, tries: int = 5, want: frozenset = frozenset(),
                    every: bool = False):
    """Run ``fn()`` under ``torch.profiler`` (as profile_infer reads the
    card); returns its result, ``{name: device ms}`` of the port's
    kernels that ran (``every``: of every device kernel, by its full
    name, each name in ``want`` found inside one), and how many times
    ``fn`` ran. On an H100 the
    profiler now and then records no device event for a window, at times
    several windows in a row, or misses the first kernel a window
    launches (K9's pre-pass in one-call windows). So a window
    starts with a throw-away kernel and a pause, and one that saw none
    of the port's kernels or not all of ``want`` runs again after a
    longer pause, up to ``tries`` times."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for runs in range(1, tries + 1):
        with torch.profiler.profile(activities=acts) as prof:
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
            time.sleep(0.02)
            out = fn()
            torch.cuda.synchronize()
        ran = {}
        for e in prof.key_averages():
            m = re.search(r"::((?:lstm|gru|ctc)_\w+_kernel)\b", e.key)
            name = e.key if every else m and m.group(1)
            if (name and e.device_type == torch.autograd.DeviceType.CUDA
                    and (not every or e.self_device_time_total > 0)):
                ran[name] = (ran.get(name, 0.0)
                             + e.self_device_time_total / 1e3)
        found = (all(any(w in k for k in ran) for w in want) if every
                 else want <= set(ran))
        if ran and found:
            break
        time.sleep(0.5 * runs)
    return out, ran, runs


def _k14_kernels(dtype: torch.dtype, h: int) -> set:
    """The device kernels one ``lstm_fwd_stream`` call launches: in bf16
    with H a multiple of 8 the transpose of W and the tensor-core loop,
    else the CUDA-core kernel (csrc/lstm_fwd_stream.cu)."""
    if dtype == torch.bfloat16 and h % 8 == 0:
        return {"lstm_fwd_stream_transpose_kernel",
                "lstm_fwd_stream_mma_kernel"}
    return {"lstm_fwd_stream_kernel"}


def _k12_kernels(dtype: torch.dtype, h: int) -> set:
    """The device kernels one ``lstm_fwd`` call launches on the resident
    kernel's C entry point: in bf16 with H a multiple of 8 the transpose
    of W and the tensor-core loop with all of W^T resident (at either
    group width), else the CUDA-core kernel (csrc/lstm_fwd.cu)."""
    if dtype == torch.bfloat16 and h % 8 == 0:
        return {"lstm_fwd_transpose_kernel", "lstm_fwd_mma_kernel"}
    return {"lstm_fwd_kernel"}


def _k16_kernels(dtype: torch.dtype, h: int) -> set:
    """The device kernels one ``lstm_fwd_q`` call launches on the
    resident kernel's C entry point: with bf16 dots and H a multiple of 8
    the transpose of Q widened to bf16 and K12's tensor-core loop with
    all of it resident (at either group width), else the CUDA-core
    kernel (csrc/lstm_fwd_q.cu)."""
    if dtype == torch.bfloat16 and h % 8 == 0:
        return {"lstm_fwd_q_transpose_kernel", "lstm_fwd_q_mma_kernel"}
    return {"lstm_fwd_q_kernel"}


def _k17_kernels(dtype: torch.dtype, h: int) -> set:
    """The device kernels one ``lstm_fwd_q_stream`` call launches: with
    bf16 dots and H a multiple of 8 the transpose of Q and the
    tensor-core loop, else the CUDA-core kernel
    (csrc/lstm_fwd_q_stream.cu)."""
    if dtype == torch.bfloat16 and h % 8 == 0:
        return {"lstm_fwd_q_stream_transpose_kernel",
                "lstm_fwd_q_stream_mma_kernel"}
    return {"lstm_fwd_q_stream_kernel"}


def _k4_kernels(dtype: torch.dtype, h: int) -> set:
    """The device kernels one ``gru_fwd`` call launches on the resident
    kernel's C entry point: in bf16 with H a multiple of 8 the transpose
    of W and the tensor-core loop with all of W^T resident (at either
    group width), else the CUDA-core kernel (csrc/gru_fwd.cu)."""
    if dtype == torch.bfloat16 and h % 8 == 0:
        return {"gru_fwd_transpose_kernel", "gru_fwd_mma_kernel"}
    return {"gru_fwd_kernel"}


def _k8_kernels(dtype: torch.dtype, h: int) -> set:
    """The device kernels one ``gru_fwd_stream`` call launches: in bf16
    with H a multiple of 8 the transpose of W and the tensor-core loop,
    else the CUDA-core kernel (csrc/gru_fwd_stream.cu)."""
    if dtype == torch.bfloat16 and h % 8 == 0:
        return {"gru_fwd_stream_transpose_kernel",
                "gru_fwd_stream_mma_kernel"}
    return {"gru_fwd_stream_kernel"}


def _k10_kernels(dtype: torch.dtype, h: int) -> set:
    """The device kernels one ``gru_fwd_q`` call launches on the resident
    kernel's C entry point: with bf16 dots and H a multiple of 8 the
    transpose of Q and the tensor-core loop, else the CUDA-core kernel
    (csrc/gru_fwd_q.cu)."""
    if dtype == torch.bfloat16 and h % 8 == 0:
        return {"gru_fwd_q_transpose_kernel", "gru_fwd_q_mma_kernel"}
    return {"gru_fwd_q_kernel"}


def _k11_kernels(dtype: torch.dtype, h: int) -> set:
    """The device kernels one ``gru_fwd_q_stream`` call launches: with
    bf16 dots and H a multiple of 8 the transpose of Q and the
    tensor-core loop, else the CUDA-core kernel
    (csrc/gru_fwd_q_stream.cu)."""
    if dtype == torch.bfloat16 and h % 8 == 0:
        return {"gru_fwd_q_stream_transpose_kernel",
                "gru_fwd_q_stream_mma_kernel"}
    return {"gru_fwd_q_stream_kernel"}


def _k13_kernels(dtype: torch.dtype, h: int) -> set:
    """The device kernels one ``lstm_bwd`` call launches on the resident
    kernel's C entry point: in bf16 with H a multiple of 8 the gate
    pre-pass and the tensor-core loop with W resident (at either group
    width), else the CUDA-core kernel (csrc/lstm_bwd.cu)."""
    if dtype == torch.bfloat16 and h % 8 == 0:
        return {"lstm_bwd_gates_kernel", "lstm_bwd_mma_kernel"}
    return {"lstm_bwd_kernel"}


def _k15_kernels(dtype: torch.dtype, h: int) -> set:
    """The device kernels one ``lstm_bwd_stream`` call launches: in bf16
    with H a multiple of 4 the gate pre-pass and the tensor-core loop
    with W streamed, else the two-phase CUDA-core kernel
    (csrc/lstm_bwd_stream.cu)."""
    if dtype == torch.bfloat16 and h % 4 == 0:
        return {"lstm_bwd_stream_gates_kernel", "lstm_bwd_stream_mma_kernel"}
    return {"lstm_bwd_stream_kernel"}


# The kernels whose C call picks its device kernels by dtype and H: what
# each call must have launched.
_STREAM_KERNELS = {"gru_fwd": _k4_kernels,
                   "gru_fwd_stream": _k8_kernels,
                   "gru_fwd_q": _k10_kernels,
                   "gru_fwd_q_stream": _k11_kernels,
                   "lstm_fwd": _k12_kernels,
                   "lstm_fwd_stream": _k14_kernels,
                   "lstm_fwd_q": _k16_kernels,
                   "lstm_fwd_q_stream": _k17_kernels,
                   "lstm_bwd": _k13_kernels,
                   "lstm_bwd_stream": _k15_kernels}


def lstm_kernel_phase(gen, kernel: str, h: int, timed):
    """Hold ``ops.lstm.<kernel>`` (``lstm_fwd``, which launches the
    resident kernel at these sizes, or ``lstm_fwd_stream``; with int8 W
    ``lstm_fwd_q``, resident here, or ``lstm_fwd_q_stream``) against its
    plain version at T'=850, B=32 and width ``h`` for each D of ``timed``,
    bf16 and f32, with and without the cell-state tape (the fp kernels),
    and at one ragged shape off the tiles (``lstm_fwd_stream`` and
    ``lstm_fwd_q_stream`` also at width ``h``); two runs must give the
    same bits, the tape included; ``lstm_fwd`` also at full width off
    the tiles, at H=104, at its rule's widths (D=2 H=808, a partial group
    of 16, and 1056; D=1 H=1216) and at H=804 (off its H % 8 rule),
    within ``LSTM_FWD_TOL``; ``lstm_fwd_q`` at the same shapes within
    ``LSTM_FWD_Q_TOL``, and at D=1 H=1280, past its bf16 rule, where it
    calls ``lstm_fwd_q_stream``. Each check names the device kernels
    that ran (the ones their dtype, H and the rule select).
    Then time it for each ``(d, replaces)`` of ``timed`` without the
    tape, as serving calls it, beside its bound, its plain version and
    cuDNN's LSTM."""
    from deepspeech_tpu_torch.ops import gru, lstm

    fn = getattr(lstm, kernel)
    quantized = kernel.startswith("lstm_fwd_q")
    plain = lstm.lstm_fwd_q_plain if quantized else lstm.lstm_fwd_plain
    tapes = (False,) if quantized else (False, True)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(f"D{d}_{dn}{'_tape' if tape else ''}", d, dtype, tape,
              (T, B, h))
             for d, _ in timed
             for dn, dtype in (("bf16", bf16), ("f32", f32))
             for tape in tapes]
    cases.append((f"D2_bf16_ragged{'' if quantized else '_tape'}", 2,
                  bf16, not quantized, (37, 45, 100)))
    if kernel == "lstm_fwd":
        # On the tensor-core loop with all of W^T resident: at full width
        # with B above the 32 rows of a pass, at both D; B=8 in a partly
        # filled m16 tile; H=104, a partial last 32-deep chunk; at D=2
        # H=808, 51 groups of 16 a direction, the last half full, and
        # H=1056, 132 groups of 16; at D=1 H=1216, 76 groups of 16 (224 KB
        # a block), the widest the rule admits. H=804 and H=100 (above):
        # bf16 with H % 8 != 0, and f32, run the CUDA-core kernel.
        cases += [("D2_bf16_ragged_full_tape", 2, bf16, True, (37, 45, h)),
                  ("D1_bf16_ragged_full_tape", 1, bf16, True, (37, 45, h)),
                  ("D1_bf16_ragged_full", 1, bf16, False, (37, 45, h)),
                  ("D2_bf16_b8_full", 2, bf16, False, (37, 8, h)),
                  ("D2_bf16_h104_tape", 2, bf16, True, (37, 45, 104)),
                  ("D2_bf16_h808_tape", 2, bf16, True, (37, 45, 808)),
                  ("D2_bf16_h1056_tape", 2, bf16, True, (37, 8, 1056)),
                  ("D1_bf16_h1216_tape", 1, bf16, True, (37, 8, 1216)),
                  ("D2_bf16_h804_tape", 2, bf16, True, (37, 45, 804))]
    if kernel == "lstm_fwd_stream":
        # At full width: B above the 32 rows of a pass, and B=8 in a
        # partly filled m16 tile; H=104, a multiple of 8 but not of the
        # 32-unit groups; H=2176, 136 groups on an H100's 132 SMs, so
        # some blocks take two groups a step and no W^T stays resident.
        # H=100 (above) and f32 run the CUDA-core kernel.
        cases += [("D2_bf16_ragged_full", 2, bf16, False, (37, 45, h)),
                  ("D2_bf16_ragged_full_tape", 2, bf16, True, (37, 45, h)),
                  ("D2_f32_ragged_full_tape", 2, f32, True, (37, 45, h)),
                  ("D2_bf16_b8_full", 2, bf16, False, (37, 8, h)),
                  ("D2_bf16_h104_tape", 2, bf16, True, (37, 45, 104)),
                  ("D2_bf16_h2176_tape", 2, bf16, True, (37, 8, 2176))]
    if kernel == "lstm_fwd_q_stream":
        # At full width: B above the 32 rows of a pass, B=8 in a partly
        # filled m16 tile, f32 (the CUDA-core kernel); H=104, a multiple of
        # 8 (the tensor-core rule) but not of the 32-unit groups nor of the
        # 64-deep chunks, and H=108, off the rule (the CUDA-core kernel, as
        # H=100 above); H=2176, 136 groups on an H100's 132 SMs, so some
        # blocks take two groups a step and no Q^T stays resident.
        cases += [("D2_bf16_ragged_full", 2, bf16, False, (37, 45, h)),
                  ("D2_f32_ragged_full", 2, f32, False, (37, 45, h)),
                  ("D2_bf16_b8_full", 2, bf16, False, (37, 8, h)),
                  ("D2_bf16_h104", 2, bf16, False, (37, 45, 104)),
                  ("D2_bf16_h108", 2, bf16, False, (37, 45, 108)),
                  ("D2_bf16_h2176", 2, bf16, False, (37, 8, 2176))]
    if kernel == "lstm_fwd_q":
        # lstm_fwd's checks, without the tape: with bf16 dots and H % 8 ==
        # 0 the tensor-core loop on bf16(Q^T), all of it resident (H=804
        # and H=100 (above), and f32, run the CUDA-core kernel); and at
        # D=1 H=1280, past the bf16 rule, lstm_fwd_q_stream (K17).
        cases += [("D2_bf16_ragged_full", 2, bf16, False, (37, 45, h)),
                  ("D1_bf16_ragged_full", 1, bf16, False, (37, 45, h)),
                  ("D2_bf16_b8_full", 2, bf16, False, (37, 8, h)),
                  ("D2_bf16_h104", 2, bf16, False, (37, 45, 104)),
                  ("D2_bf16_h808", 2, bf16, False, (37, 45, 808)),
                  ("D2_bf16_h1056", 2, bf16, False, (37, 8, 1056)),
                  ("D1_bf16_h1216", 1, bf16, False, (37, 8, 1216)),
                  ("D2_bf16_h804", 2, bf16, False, (37, 45, 804)),
                  ("D1_bf16_h1280", 1, bf16, False, (37, 8, 1280))]
    tols = {"lstm_fwd": LSTM_FWD_TOL,
            "lstm_fwd_q": LSTM_FWD_Q_TOL}.get(kernel, TOL)
    _zero_counts()
    checks, calls, streamed = {}, 0, 0
    for name, d, dtype, tape, shape in cases:
        args, _ = _lstm_inputs(d, dtype, gen, *shape, quantized=quantized)
        kw = {"tape": True} if tape else {}
        want = (_STREAM_KERNELS[kernel](dtype, shape[2])
                if kernel in _STREAM_KERNELS else set())
        # lstm_fwd_q off its residency rule calls lstm_fwd_q_stream.
        streams = kernel == "lstm_fwd_q" and not gru.resident_fits(
            kernel, d, shape[2], shape[1], dtype,
            *gru.card_limits(args[0].device))
        if streams:
            want = _k17_kernels(dtype, shape[2])
        outs, ran, runs = _device_kernels(
            lambda: [fn(*args, **kw) for _ in range(2)],
            want=frozenset(want))
        if streams:
            streamed += 2 * runs
        else:
            calls += 2 * runs
        if kernel in _STREAM_KERNELS:
            _require(set(ran) == want, f"{kernel} {name}: ran {sorted(ran)}, "
                     f"want {sorted(want)}")
        ref = plain(*args, **kw)
        got, again, ref = [x if tape else (x,) for x in (*outs, ref)]
        err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        _require(all(bool(torch.isfinite(g).all()) for g in got),
                 f"{kernel} {name}: non-finite output")
        _require(err <= tols[dtype],
                 f"{kernel} {name}: max |kernel - plain| {err} > "
                 f"{tols[dtype]}")
        _require(all(torch.equal(g, a) for g, a in zip(got, again)),
                 f"{kernel} {name}: two runs on one input differ")
        checks[name] = {"max_abs_err": err, "tol": tols[dtype],
                        "bit_identical": True, "kernels": sorted(ran)}
        print(json.dumps({"check": f"{kernel} {name}", "max_abs_err": err,
                          "tol": tols[dtype], "bit_identical": True,
                          "kernels": sorted(ran)}), flush=True)
    _require_only(kernel, calls, {"lstm_fwd_q_stream": streamed})

    entries = []
    for d, replaces in timed:
        args, valid = _lstm_inputs(d, torch.bfloat16, gen, T, B, h,
                                   quantized)
        ms = _time_ms(lambda: fn(*args), reps=5)
        # One call's device time by kernel (for the streamed kernels: the
        # transpose of W or Q and the serial loop).
        _, device_ms, _ = _device_kernels(
            lambda: fn(*args), want=frozenset(
                _STREAM_KERNELS[kernel](torch.bfloat16, h)
                if kernel in _STREAM_KERNELS else ()))
        plain_ms = _time_ms(lambda: plain(*args), reps=1)
        lib = _cudnn_lstm(args, h)
        x_lib = torch.randn(T, B, h, generator=gen, device="cuda").to(
            torch.bfloat16)
        with torch.no_grad():
            library_ms = _time_ms(lambda: lib(x_lib), reps=5)
        del lib, x_lib
        # The product's FLOPs on valid frames, 2 * rows * D * H * 4H, over
        # the bf16 peak; the inputs read once and ys written once.
        xp, mask, *weights, bias, _ = args
        bound_ms, bound_by = _roofline(
            _nbytes(xp, mask, *weights, bias) + 4 * d * T * B * h,
            2.0 * valid * d * h * 4 * h, PEAK_BF16_FLOPS)
        args_b1 = tuple(a[:, :1].contiguous() if i < 2 else a
                        for i, a in enumerate(args))
        extra = {"ms_at_b1": _time_ms(lambda: fn(*args_b1), reps=5),
                 "device_ms": device_ms}
        if not quantized:
            extra["ms_tape"] = _time_ms(lambda: fn(*args, tape=True), reps=3)
        if kernel.endswith("_stream"):
            # At H=800, where the resident kernel runs: what the
            # residency rule saves there.
            args_h, _ = _lstm_inputs(d, torch.bfloat16, gen,
                                     quantized=quantized)
            extra["ms_at_h800"] = _time_ms(lambda: fn(*args_h), reps=3)
            del args_h
        if quantized:
            extra["library"] = "cuDNN LSTM, bf16, dequantized W"
        entries.append({
            "name": f"{kernel}[D={d}]", "route": "cuda",
            "source": f"deepspeech_tpu_torch/csrc/{kernel}.cu",
            "replaces": replaces, "launches": 0,
            "max_abs_err": checks[f"D{d}_bf16"]["max_abs_err"],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms, **extra,
            "shape": {"D": d, "T": T, "B": B, "H": h, "dtype": "bfloat16",
                      "w_dtype": "int8" if quantized else "bfloat16",
                      "valid_rows": valid},
            "checks": {k: v for k, v in checks.items()
                       if k.startswith(f"D{d}_")}})
        print(json.dumps({"timed": entries[-1]["name"], "ms": ms,
                          "plain_ms": plain_ms, "library_ms": library_ms,
                          "bound_ms": bound_ms, **extra}), flush=True)
    return entries


def lstm_bwd_kernel_phase(gen, kernel: str, h: int, timed):
    """Hold ``ops.lstm.<kernel>`` (``lstm_bwd``, the resident kernel at
    these sizes, or ``lstm_bwd_stream``) against ``lstm_bwd_plain`` on
    the ys and cs tape of ``lstm_fwd(..., tape=True)`` at T'=850, B=32
    and width ``h`` for each D of ``timed``, bf16 and f32, and at ragged
    shapes off the tiles, within ``LSTM_BWD_TOL``; two runs must give
    the same bits. Each check
    names the device kernels that ran, the ones the dtype and H select
    (``_k13_kernels``, ``_k15_kernels``). Then time it for each ``(d,
    replaces)`` of ``timed`` beside its bound, its plain version and
    cuDNN's LSTM backward, with one call's device time by kernel."""
    from deepspeech_tpu_torch.ops import lstm

    fn = getattr(lstm, kernel)
    bf16, f32 = torch.bfloat16, torch.float32

    def inputs(d, dtype, shape):
        args, valid = _lstm_inputs(d, dtype, gen, *shape)
        xp, mask, w, bias, reverse = args
        ys, cs = lstm.lstm_fwd(*args, tape=True)
        dy = torch.randn(ys.shape, generator=gen, device="cuda") * 0.1
        return (xp, mask, w, bias, ys, cs, dy, reverse), valid

    cases = [(f"D{d}_{dn}", d, dtype, (T, B, h)) for d, _ in timed
             for dn, dtype in (("bf16", bf16), ("f32", f32))]
    # H=100 is off K13's tensor-core rule (H % 8 == 0), which takes it to
    # the CUDA-core kernel, and on K15's (H % 4 == 0).
    cases += [("D2_bf16_ragged", 2, bf16, (37, 45, 100)),
              ("D1_f32_ragged", 1, f32, (37, 45, 100))]
    if kernel == "lstm_bwd":
        # At full width: B above the 32 rows of a pass at both D, and B=8
        # in a partly filled m16 tile; H=104, a multiple of 8 but not of
        # the groups; H=832, D=2 and the rule's edges in bf16, H=1056 at
        # D=2 (132 groups of 16 on an H100's 132 SMs) and H=1280 at D=1
        # (227 KB of shared memory a block); H=804, off the tensor-core
        # rule (H % 8 != 0), on the CUDA-core kernel.
        cases += [("D2_bf16_ragged_full", 2, bf16, (37, 45, h)),
                  ("D1_bf16_ragged_full", 1, bf16, (37, 45, h)),
                  ("D2_bf16_b8_full", 2, bf16, (37, 8, h)),
                  ("D2_bf16_h104", 2, bf16, (37, 45, 104)),
                  ("D2_bf16_h832", 2, bf16, (37, 45, 832)),
                  ("D2_bf16_h1056", 2, bf16, (37, 8, 1056)),
                  ("D1_bf16_h1280", 1, bf16, (37, 8, 1280)),
                  ("D1_bf16_h804", 1, bf16, (37, 45, 804))]
    if kernel.endswith("_stream"):
        # At full width: the product 4H = 7040 deep, B above the 32 rows
        # of a pass, and B=8 in a partly filled m16 tile; and H=99, which
        # bf16 runs on the two-phase kernel (H % 4 != 0).
        cases += [("D2_bf16_ragged_full", 2, bf16, (37, 45, h)),
                  ("D2_f32_ragged_full", 2, f32, (37, 45, h)),
                  ("D2_bf16_b8_full", 2, bf16, (37, 8, h)),
                  ("D1_bf16_odd_h", 1, bf16, (37, 45, 99))]
    _zero_counts()
    checks, calls = {}, 0
    for name, d, dtype, shape in cases:
        args, _ = inputs(d, dtype, shape)
        (dg, dg2), ran, runs = _device_kernels(
            lambda: [fn(*args) for _ in range(2)])
        calls += 2 * runs
        want = _STREAM_KERNELS[kernel](dtype, shape[2])
        _require(set(ran) == want, f"{kernel} {name}: ran {sorted(ran)}, "
                 f"want {sorted(want)}")
        err = float((dg - lstm.lstm_bwd_plain(*args)).abs().max())
        tol = LSTM_BWD_TOL[dtype]
        _require(bool(torch.isfinite(dg).all()), f"{kernel} {name}: "
                 "non-finite")
        _require(err <= tol,
                 f"{kernel} {name}: max |kernel - plain| {err} > {tol}")
        _require(torch.equal(dg, dg2),
                 f"{kernel} {name}: two runs on one input differ")
        checks[name] = {"max_abs_err": err, "tol": tol,
                        "bit_identical": True, "kernels": sorted(ran)}
        print(json.dumps({"check": f"{kernel} {name}", "max_abs_err": err,
                          "tol": tol, "bit_identical": True,
                          "kernels": sorted(ran)}), flush=True)
        del args, dg, dg2
    _require_only(kernel, calls)

    entries = []
    for d, replaces in timed:
        args, valid = inputs(d, bf16, (T, B, h))
        ms = _time_ms(lambda: fn(*args), reps=3)
        # One call's device time by kernel: the gate pre-pass and the loop.
        _, device_ms, _ = _device_kernels(
            lambda: fn(*args),
            want=frozenset(_STREAM_KERNELS[kernel](bf16, h)))
        plain_ms = _time_ms(lambda: lstm.lstm_bwd_plain(*args), reps=1)
        # Yardstick: the backward of cuDNN's bf16 LSTM (input and weight
        # gradients), timed apart from its forward.
        xp, mask, w, bias, ys, cs, dy, reverse = args
        lib = _cudnn_lstm((xp, mask, w, bias, reverse), h)
        x_lib = torch.randn(T, B, h, generator=gen, device="cuda").to(
            bf16).requires_grad_()
        out, _ = lib(x_lib)
        g_out = torch.randn_like(out)
        leaves = [x_lib, *lib.parameters()]
        library_ms = _time_ms(lambda: torch.autograd.grad(
            out, leaves, g_out, retain_graph=True), reps=3)
        del out, g_out, leaves, lib, x_lib
        extra = {"device_ms": device_ms}
        if kernel.endswith("_stream"):
            # The streamed kernel where the resident one runs (H=800).
            args_h, _ = inputs(d, bf16, (T, B, H))
            extra["ms_at_h800"] = _time_ms(lambda: fn(*args_h), reps=2)
            del args_h
        # Two [B,H]x[H,4H] products per valid step (gate recompute and
        # dgates @ W^T) over the bf16 peak; the inputs read once and
        # dgates written once.
        bound_ms, bound_by = _roofline(
            _nbytes(xp, mask, w, bias, ys, cs, dy) + 4 * d * T * B * 4 * h,
            2 * 2.0 * valid * d * h * 4 * h, PEAK_BF16_FLOPS)
        entries.append({
            "name": f"{kernel}[D={d}]", "route": "cuda",
            "source": f"deepspeech_tpu_torch/csrc/{kernel}.cu",
            "replaces": replaces, "launches": 0,
            "max_abs_err": checks[f"D{d}_bf16"]["max_abs_err"],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "library": "cuDNN LSTM backward, bf16", **extra,
            "shape": {"D": d, "T": T, "B": B, "H": h, "dtype": "bfloat16",
                      "valid_rows": valid},
            "checks": {k: v for k, v in checks.items()
                       if k.startswith(f"D{d}_")}})
        print(json.dumps({"timed": entries[-1]["name"], "ms": ms,
                          "plain_ms": plain_ms, "library_ms": library_ms,
                          "bound_ms": bound_ms, **extra}), flush=True)
        del args
    return entries


def _rel_max_err(a, b) -> float:
    """max |a - b| / max(1, |b|) over entries above NEG/2 in ``b``."""
    live = b > -5e29
    return float(((a - b).abs() / b.abs().clamp(min=1.0))[live].max())


def _ctc_check(gen, name: str, b: int, t: int, v: int, l_max: int,
               per_frame: float, pad: int):
    """The CTC kernels at one shape against their plain versions: ll,
    the tape and gamma (at S = 2 * l_max + 1 + pad, ext padded with
    blank columns that no path reaches), and the loss and dlogits
    through ``ctc_loss`` against the same with the plain versions
    patched in (at S = 2 * l_max + 1), each within CTC_TOL; the same
    bits twice, the loss-only ll equal to the taped one. Prints the
    errors, whether each output equals the plain one bit for bit, and
    the plan the kernels launched with. Returns the batch, the kernels'
    outputs and the errors."""
    from deepspeech_tpu_torch import ctc_variants
    from deepspeech_tpu_torch.ops import ctc

    logits, labels, lens, lab_lens = ctc_variants.batch(gen, b, t, v, l_max,
                                                        per_frame)
    prep = ctc_variants.operands(logits, labels, lens, lab_lens, pad)
    ll, tape = ctc.ctc_alpha(*prep, tape=True)
    ll2, tape2 = ctc.ctc_alpha(*prep, tape=True)
    ll_lo, _ = ctc.ctc_alpha(*prep, tape=False)
    gamma = ctc.ctc_beta(*prep, tape, ll)
    gamma2 = ctc.ctc_beta(*prep, tape, ll)
    torch.cuda.synchronize()
    ll_p, tape_p = ctc.ctc_alpha_plain(*prep, tape=True)
    gamma_p = ctc.ctc_beta_plain(*prep, tape_p, ll_p)
    errs = {"loglik": _rel_max_err(ll, ll_p),
            "tape": _rel_max_err(tape, tape_p),
            "gamma": float((gamma - gamma_p).abs().max())}
    equal = {"loglik": torch.equal(ll, ll_p),
             "tape": torch.equal(tape, tape_p),
             "gamma": torch.equal(gamma, gamma_p)}
    # The loss and dlogits through ctc_loss, kernels against plain.
    lg = logits.clone().requires_grad_()
    loss = ctc.ctc_loss(lg, labels, lens, lab_lens)
    loss.sum().backward()
    lg_p = logits.clone().requires_grad_()
    with mock.patch.object(ctc, "ctc_alpha", ctc.ctc_alpha_plain), \
            mock.patch.object(ctc, "ctc_beta", ctc.ctc_beta_plain):
        loss_p = ctc.ctc_loss(lg_p, labels, lens, lab_lens)
        loss_p.sum().backward()
    errs["loss"] = _rel_max_err(loss.detach(), loss_p.detach())
    errs["dlogits"] = float((lg.grad - lg_p.grad).abs().max())
    equal["loss"] = torch.equal(loss, loss_p)
    equal["dlogits"] = torch.equal(lg.grad, lg_p.grad)
    for key, err in errs.items():
        _require(err <= CTC_TOL, f"ctc[{name}] {key}: kernel - plain {err} "
                 f"> {CTC_TOL}")
    _require(torch.equal(ll, ll2) and torch.equal(tape, tape2)
             and torch.equal(gamma, gamma2),
             f"ctc[{name}] kernels: two runs on one input differ")
    _require(torch.equal(ll_lo, ll), f"ctc_alpha[{name}]: the loss-only "
             "log-likelihood differs from the taped one")
    s = prep[1].shape[1]
    print(json.dumps({"check": "ctc" if name == "main" else f"ctc[{name}]",
                      "shape": {"B": b, "T": t, "V": v, "S": s,
                                "max_s_last": int(prep[4].max())},
                      "plan": ctc.ctc_plan(b, s, logits.device),
                      "errs": errs, "tol": CTC_TOL, "bit_equal_plain": equal,
                      "same_bits_twice": True}), flush=True)
    return logits, labels, lens, lab_lens, prep, ll, tape, gamma, errs


def ctc_kernel_phase(gen):
    """The CTC kernels at the main shape (B=32, T'=850, V=29, S <= 513)
    and at each of ``ctc_variants.CHECKS``, each held by ``_ctc_check``,
    then timed at the main shape beside their plain versions and
    ``F.ctc_loss``."""
    from deepspeech_tpu_torch import ctc_variants
    from deepspeech_tpu_torch.ops import ctc

    logits, labels, lens, lab_lens, prep, ll, tape, gamma, errs = _ctc_check(
        gen, "main", B, T, V, L_MAX, 0.15, 0)
    lp, ext, skip, il, sl = prep
    _require(bool(torch.isfinite(ll).all()), "ctc: non-finite loss")
    # Their own generator, so that later phases draw what they drew before.
    gen_checks = torch.Generator(device="cuda").manual_seed(SEED + 1)
    for check in ctc_variants.CHECKS:
        _ctc_check(gen_checks, *check)

    # Bounds, from this input: band cells a path can reach are t < len
    # and s <= 2L; about 12 operations each for alpha (three exp, one
    # log, adds, max), 16 for beta (and the occupancy's add, exp, min).
    cells = float(((sl.double() + 1) * il.double()).sum())
    small = _nbytes(lp, ext, skip, il, sl, ll)
    bounds = {"alpha": _roofline(small + _nbytes(tape), 12 * cells,
                                 PEAK_F32_FLOPS),
              "loss_only": _roofline(small, 12 * cells, PEAK_F32_FLOPS),
              "beta": _roofline(small + _nbytes(tape, gamma), 16 * cells,
                                PEAK_F32_FLOPS)}
    times = {
        "alpha": _time_ms(lambda: ctc.ctc_alpha(*prep, tape=True), 10),
        "loss_only": _time_ms(lambda: ctc.ctc_alpha(*prep, tape=False), 10),
        "beta": _time_ms(lambda: ctc.ctc_beta(*prep, tape, ll), 10)}
    plain = {
        "alpha": _time_ms(lambda: ctc.ctc_alpha_plain(*prep, tape=True), 1),
        "loss_only": _time_ms(
            lambda: ctc.ctc_alpha_plain(*prep, tape=False), 1),
        "beta": _time_ms(lambda: ctc.ctc_beta_plain(*prep, tape, ll), 1)}
    # Yardstick: torch's CTC on the same log-probs, forward and backward
    # (the pair the taped alpha and the beta replace) and forward alone.
    lp_tbv = lp.transpose(0, 1).detach().requires_grad_()
    targets, in_l, tg_l = labels.long(), lens.long(), lab_lens.long()

    def torch_fwd_bwd():
        torch.nn.functional.ctc_loss(lp_tbv, targets, in_l, tg_l,
                                     reduction="sum").backward()

    with torch.no_grad():
        lib_fwd = _time_ms(lambda: torch.nn.functional.ctc_loss(
            lp_tbv, targets, in_l, tg_l, reduction="none"), 10)
    lib_fwd_bwd = _time_ms(torch_fwd_bwd, 10)
    src = "deepspeech_tpu_torch/csrc/ctc.cu"
    shape = {"B": B, "T": T, "V": V, "S": 2 * L_MAX + 1,
             "band_cells": cells}
    entries = []
    for key, name, replaces, err, lib in (
            ("alpha", "ctc_alpha", "deepspeech_tpu/ops/ctc_pallas.py:118",
             max(errs["loglik"], errs["tape"]), lib_fwd_bwd),
            ("loss_only", "ctc_alpha[loss_only]",
             "deepspeech_tpu/ops/ctc_pallas.py:124", errs["loglik"], lib_fwd),
            ("beta", "ctc_beta", "deepspeech_tpu/ops/ctc_pallas.py:132",
             errs["gamma"], lib_fwd_bwd)):
        entries.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": times[key], "plain_ms": plain[key],
            "bound_ms": bounds[key][0], "bound_by": bounds[key][1],
            "library_ms": lib, "shape": shape})
    print(json.dumps({"timed": "ctc", "ms": times,
                      "ns_per_step": {k: 1e6 * v / T
                                      for k, v in times.items()},
                      "plain_ms": plain, "library_fwd_ms": lib_fwd,
                      "library_fwd_bwd_ms": lib_fwd_bwd,
                      "bounds": bounds}), flush=True)
    return entries


def _k9_kernels(w: torch.Tensor, ys: torch.Tensor) -> set:
    """The device kernels one ``gru_bwd_stream`` call launches: where
    ``ops.gru._bwd_mma`` holds (bf16, H a multiple of 8, aligned)
    the gate pre-pass GEMM and the tensor-core loop, else the two-phase
    CUDA-core kernel (csrc/gru_bwd_stream.cu)."""
    from deepspeech_tpu_torch.ops import gru

    if gru._bwd_mma(w, ys):
        return {"gru_bwd_stream_gates_kernel", "gru_bwd_stream_mma_kernel"}
    return {"gru_bwd_stream_kernel"}


def _k7_kernels(w: torch.Tensor, ys: torch.Tensor) -> set:
    """The device kernels one ``gru_bwd`` call launches on the resident
    kernel's C entry point (K5 at D=2, K7 at D=1): where
    ``ops.gru._bwd_mma`` holds the gate pre-pass GEMM and the
    tensor-core loop with W resident (at either group width), else the
    CUDA-core kernel (csrc/gru_bwd.cu)."""
    from deepspeech_tpu_torch.ops import gru

    if gru._bwd_mma(w, ys):
        return {"gru_bwd_gates_kernel", "gru_bwd_mma_kernel"}
    return {"gru_bwd_kernel"}


def gru_bwd_kernel_phase(gen, kernel: str, h: int, timed):
    """Hold ``ops.gru.<kernel>`` (``gru_bwd``, the resident kernel at
    these sizes, or ``gru_bwd_stream``) against ``gru_bwd_plain`` as
    ``gru_fwd_kernel_phase`` holds the forward (``gru_bwd`` within
    ``GRU_BWD_TOL``), two runs the same bits, each check naming the
    device kernels the profiler saw (the ones its dtype, H and alignment
    select: ``_k7_kernels``, ``_k9_kernels``), and time it for each ``(d,
    replaces)`` of ``timed`` beside cuDNN's GRU backward, with one call's
    device time by kernel."""
    from deepspeech_tpu_torch.ops import gru

    fn = getattr(gru, kernel)
    streamed = kernel.endswith("_stream")
    kernels = _k9_kernels if streamed else _k7_kernels
    tols = TOL if streamed else GRU_BWD_TOL

    def inputs(d, dtype, shape):
        args, valid = _gru_inputs(d, dtype, False, gen, *shape)
        xp, mask, w, bias, _, reverse = args
        ys, _ = gru.gru_fwd(*args)
        dy = torch.randn(ys.shape, generator=gen, device="cuda") * 0.1
        return (xp, mask, w, bias, ys, dy, reverse), valid

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [("D2_bf16", 2, bf16, (T, B, h)), ("D2_f32", 2, f32, (T, B, h)),
             ("D1_bf16", 1, bf16, (T, B, h)), ("D1_f32", 1, f32, (T, B, h)),
             ("D2_bf16_ragged", 2, bf16, (37, 45, 100)),
             ("D1_f32_ragged", 1, f32, (37, 45, 100))]
    if streamed:
        # At full width: B above the 32 rows of a pass, and B=8 in a
        # partly filled m16 tile; H=104, a multiple of 8 but not of the
        # 32-unit groups; H=2176, 136 groups on an H100's 132 SMs, so
        # some blocks take two groups a step and all of W streams. H=100
        # (above: bf16 with H % 8 != 0) and f32 run the two-phase kernel.
        cases += [("D2_bf16_ragged_full", 2, bf16, (37, 45, h)),
                  ("D2_f32_ragged_full", 2, f32, (37, 45, h)),
                  ("D2_bf16_b8_full", 2, bf16, (37, 8, h)),
                  ("D2_bf16_h104", 2, bf16, (37, 45, 104)),
                  ("D2_bf16_h2176", 2, bf16, (37, 8, 2176))]
    else:
        # At full width: B above the 32 rows of a pass at both D, and B=8
        # in a partly filled m16 tile; H=104, a multiple of 8 but not of
        # the groups of 16; the rule's edges in bf16, H=1056 at D=2 (132
        # groups of 16 on an H100's 132 SMs) and H=1704 at D=1 (224 KB of
        # the 227 a block may have). H=100 (above: bf16 with H % 8 != 0)
        # and f32 run the CUDA-core kernel.
        cases += [("D2_bf16_ragged_full", 2, bf16, (37, 45, h)),
                  ("D1_bf16_ragged_full", 1, bf16, (37, 45, h)),
                  ("D2_bf16_b8_full", 2, bf16, (37, 8, h)),
                  ("D2_bf16_h104", 2, bf16, (37, 45, 104)),
                  ("D2_bf16_h1056", 2, bf16, (37, 8, 1056)),
                  ("D1_bf16_h1704", 1, bf16, (37, 8, 1704))]
    _zero_counts()
    checks, calls = {}, 0
    for name, d, dtype, shape in cases:
        args, _ = inputs(d, dtype, shape)
        want = kernels(args[2], args[4])
        outs, ran, runs = _device_kernels(
            lambda: [fn(*args) for _ in range(2)], want=frozenset(want))
        calls += 2 * runs
        _require(set(ran) == want, f"{kernel} {name}: ran "
                 f"{sorted(ran)}, want {sorted(want)}")
        if streamed:
            floats = gru._lib(kernel).gru_bwd_stream_scratch_floats(
                d, shape[1], shape[2])
            _require(floats == gru._bwd_stream_scratch_floats(
                d, shape[1], shape[2]), f"{kernel} {name}: the C scratch "
                f"size {floats} is not ops.gru's")
        (dxp, dg), (dxp2, dg2) = outs
        dxp_p, dg_p = gru.gru_bwd_plain(*args)
        err = max(float((dxp - dxp_p).abs().max()),
                  float((dg - dg_p).abs().max()))
        _require(bool(torch.isfinite(dxp).all() and torch.isfinite(dg).all()),
                 f"{kernel} {name}: non-finite")
        _require(err <= tols[dtype],
                 f"{kernel} {name}: max |kernel - plain| {err} > "
                 f"{tols[dtype]}")
        _require(torch.equal(dxp, dxp2) and torch.equal(dg, dg2),
                 f"{kernel} {name}: two runs on one input differ")
        checks[name] = {"max_abs_err": err, "tol": tols[dtype],
                        "bit_identical": True, "kernels": sorted(ran),
                        "max_abs_plain": float(dg_p.abs().max())}
        print(json.dumps({"check": f"{kernel} {name}", **checks[name]}),
              flush=True)
        del args, outs
    _require_only(kernel, calls)

    entries = []
    for d, replaces in timed:
        check = f"D{d}_bf16"
        args, valid = inputs(d, torch.bfloat16, (T, B, h))
        ms = _time_ms(lambda: fn(*args), reps=3)
        plain_ms = _time_ms(lambda: gru.gru_bwd_plain(*args), reps=1)
        # Yardstick: the backward of cuDNN's GRU in bf16 (input and
        # weight gradients), timed apart from its forward.
        cudnn = torch.nn.GRU(h, h, bidirectional=d == 2).to(
            "cuda", torch.bfloat16)
        cudnn.flatten_parameters()
        x_lib = torch.randn(T, B, h, generator=gen, device="cuda").to(
            torch.bfloat16).requires_grad_()
        out, _ = cudnn(x_lib)
        g_out = torch.randn_like(out)
        leaves = [x_lib, *cudnn.parameters()]
        library_ms = _time_ms(lambda: torch.autograd.grad(
            out, leaves, g_out, retain_graph=True), reps=3)
        del out, g_out, leaves, cudnn, x_lib
        # One call's device time by kernel (in bf16: the gate pre-pass and
        # the serial loop).
        extra = {}
        _, extra["device_ms"], _ = _device_kernels(
            lambda: fn(*args), want=frozenset(kernels(args[2], args[4])))
        if streamed:
            # One batch row, where W's bytes stay and most products go;
            # and H=800, where the resident kernel runs.
            args_b1 = tuple(a[:, :, :1].contiguous() if i in (4, 5) else
                            a[:, :1].contiguous() if i < 2 else a
                            for i, a in enumerate(args))
            extra["ms_at_b1"] = _time_ms(lambda: fn(*args_b1), reps=3)
            args_h, _ = inputs(d, torch.bfloat16, (T, B, H))
            extra["ms_at_h800"] = _time_ms(lambda: fn(*args_h), reps=2)
            del args_h, args_b1
        xp, mask, w, bias, ys, dy, _ = args
        # Two [B,H]x[H,3H] products per valid step (gate recompute and
        # dgates @ W^T); inputs read once, dxp and dgates written once.
        dxp_bytes = 2 * d * T * B * 3 * h * 4
        bound_ms, bound_by = _roofline(
            _nbytes(xp, mask, w, bias, ys, dy) + dxp_bytes,
            2 * 2.0 * valid * d * h * 3 * h, PEAK_BF16_FLOPS)
        entries.append({
            "name": f"{kernel}[D={d}]", "route": "cuda",
            "source": f"deepspeech_tpu_torch/csrc/{kernel}.cu",
            "replaces": replaces, "launches": 0,
            "max_abs_err": checks[check]["max_abs_err"],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms, **extra,
            "shape": {"D": d, "T": T, "B": B, "H": h, "dtype": "bfloat16",
                      "valid_rows": valid},
            "checks": {k: v for k, v in checks.items()
                       if k.startswith(f"D{d}_")}})
        print(json.dumps({"timed": entries[-1]["name"], "ms": ms,
                          "plain_ms": plain_ms, "library_ms": library_ms,
                          "bound_ms": bound_ms, **extra}), flush=True)
        del args
    return entries


def _request(cfg, n: int, rng):
    """A request of ``n`` utterances, 300..1700 frames, one of 1700."""
    lens = rng.integers(300, 1701, size=n).astype(np.int32)
    lens[0] = 1700
    f = cfg.features.num_features
    feats = np.zeros((n, int(lens.max()), f), np.float32)
    for i, t in enumerate(lens):
        feats[i, :t] = rng.normal(size=(t, f))
    return {"features": feats, "feat_lens": lens}


def _forward(inf, sub):
    """Log-probs, lengths and the RNN stack's output (f32) of one
    forward of ``inf`` on the request ``sub``, synchronised."""
    out = {}
    hook = inf.model.rnn.register_forward_hook(
        lambda mod, args, y: out.update(rnn=y))
    try:
        lp, lens = inf.forward(sub["features"], sub["feat_lens"])
    finally:
        hook.remove()
    torch.cuda.synchronize()
    return lp, lens, out["rnn"].float()


def _config(preset: str, rnn_type: str = "gru"):
    """``preset``'s config, with ``model.rnn_type`` set for an LSTM."""
    from deepspeech_tpu_torch.config import apply_overrides, get_config

    cfg = get_config(preset)
    if rnn_type != "gru":
        cfg = apply_overrides(cfg, {"model.rnn_type": rnn_type})
    return cfg


@functools.lru_cache(maxsize=1)
def _weights(preset: str, rnn_type: str = "gru"):
    """The seeded random init of ``preset`` with ``rnn_type`` cells
    (flax layout, numpy)."""
    from deepspeech_tpu_torch.bridge import init_params

    return init_params(_config(preset, rnn_type),
                       torch.Generator().manual_seed(SEED))


def _refusing_fwd_q(real):
    """``resident_fits`` that refuses the resident int8 kernel: patched
    in for one phase, it sends the int8 layers to the streamed kernel."""
    return lambda kind, *a, **kw: kind != "fwd_q" and real(kind, *a, **kw)


def path_phase(preset: str, layers_per_forward: int, kernel: str,
               quantize: str = "", rnn_type: str = "gru"):
    """Greedy inference on ``preset`` (its cells ``rnn_type``) through
    ``Inferencer.decode_batch_bucketed``; ``kernel`` is the recurrent
    forward kernel its layers must run, one launch per layer per forward
    (both directions in it), and no other recurrent kernel may launch:
    ``gru_fwd`` (resident) or ``gru_fwd_stream``, with
    ``quantize="int8"`` ``gru_fwd_q`` or ``gru_fwd_q_stream`` (for the
    last the caller patches ``resident_fits``); for an LSTM
    ``lstm_fwd``, ``lstm_fwd_stream``, ``lstm_fwd_q`` or
    ``lstm_fwd_q_stream``."""
    from deepspeech_tpu_torch.data import CharTokenizer, plan_infer_buckets
    from deepspeech_tpu_torch.data.infer_bucket import slice_to_plan
    from deepspeech_tpu_torch.infer import Inferencer
    from deepspeech_tpu_torch.ops import gru, lstm

    cfg = _config(preset, rnn_type)
    params, stats = _weights(preset, rnn_type)
    tok = CharTokenizer.english()
    inf = Inferencer(cfg, tok, params, stats, quantize=quantize)
    regime = {"gru_fwd_q": "resident-q", "gru_fwd_q_stream": "blocked-q",
              "lstm_fwd_q": "resident-q", "lstm_fwd_q_stream": "blocked-q"}
    path = preset if rnn_type == "gru" else f"{preset}-{rnn_type}"
    _require(inf.kernel_regime == regime.get(kernel, "fp"),
             f"{path}: kernel_regime {inf.kernel_regime!r} for {kernel}")
    rng = np.random.default_rng(SEED)
    batch = _request(cfg, 12, rng)
    plans = plan_infer_buckets(batch["feat_lens"], cfg.data.bucket_frames,
                               cfg.data.batch_size)
    inf.decode_batch_bucketed(batch)  # warm-up: cuBLAS/cuDNN handles
    torch.cuda.synchronize()

    _zero_counts()
    t0 = time.perf_counter()
    texts = inf.decode_batch_bucketed(batch)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _recurrent_counts()
    launches = counts[kernel]
    want = {k: layers_per_forward * len(plans) if k == kernel else 0
            for k in counts}
    _require(counts == want, f"{path}: recurrent launches {counts} for "
             f"{len(plans)} forwards, want {want}")
    _require(len(texts) == 12 and all(isinstance(s, str) for s in texts),
             f"{path}: bad transcripts {texts!r}")

    # The largest rung against the plain recurrence on the card, and
    # against one whose first direction runs the wrong way through time,
    # which the check must reject. (Swapping both directions of a
    # bidirectional layer would not do: the sum of two random directions
    # is nearly symmetric.)
    ops = gru if rnn_type == "gru" else lstm
    wrapper = f"{rnn_type}_fwd_q" if quantize else f"{rnn_type}_fwd"
    real = getattr(ops, wrapper)

    def misdirected(*args):
        *rest, reverse = args
        return real(*rest, [not reverse[0], *reverse[1:]])

    # The real wrapper counts through its module's name, which the
    # patch points here.
    misdirected.launches = 0

    sub = slice_to_plan(batch, plans[-1])
    lp, lens, rnn = _forward(inf, sub)
    with mock.patch.object(ops, wrapper, getattr(ops, wrapper + "_plain")):
        t1 = time.perf_counter()
        lp_p, lens_p, rnn_p = _forward(inf, sub)
        plain_s = time.perf_counter() - t1
    with mock.patch.object(ops, wrapper, misdirected):
        _, _, rnn_bad = _forward(inf, sub)
    t_out = -(-plans[-1].bucket_frames // cfg.model.time_stride)
    _require(tuple(lp.shape) == (plans[-1].batch_pad, t_out,
                                 cfg.model.vocab_size),
             f"{path}: log-probs shape {tuple(lp.shape)}")
    _require(bool(torch.isfinite(lp).all()), f"{path}: non-finite")
    _require(torch.equal(lens, lens_p), f"{path}: lengths differ")
    valid = (torch.arange(t_out, device=lp.device)[None] < lens[:, None])

    def rel(x):
        return float((x - rnn_p)[valid].norm() / rnn_p[valid].norm())

    rnn_err, bad_err = rel(rnn), rel(rnn_bad)
    lp_err = float((lp - lp_p).abs()[valid].max())
    agree = float((lp.argmax(-1) == lp_p.argmax(-1))[valid].float().mean())
    _require(rnn_err <= RNN_REL_TOL,
             f"{path}: RNN output differs from the plain path by "
             f"{rnn_err} > {RNN_REL_TOL} (relative)")
    _require(bad_err > RNN_REL_TOL,
             f"{path}: a mis-directed {rnn_type} reads {bad_err}, within "
             f"{RNN_REL_TOL}: the check cannot tell it from the kernel")
    _require(agree >= ARGMAX_FLOOR,
             f"{path}: argmax agrees with the plain path on {agree} "
             f"of valid frames < {ARGMAX_FLOOR}")

    # Throughput at the largest rung, full batch.
    full = _request(cfg, cfg.data.batch_size, rng)
    full["feat_lens"][:] = 1700
    full["features"] = np.broadcast_to(
        full["features"][:1, :1700], (cfg.data.batch_size, 1700,
                                      cfg.features.num_features)).copy()
    inf.decode_batch(full)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    inf.decode_batch(full)
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t2
    result = {"path": path, "quantize": quantize or None,
              "kernel_regime": inf.kernel_regime,
              "utts": 12, "forwards": len(plans),
              "rungs": [[p.batch_pad, p.bucket_frames] for p in plans],
              "seconds": seconds, "utt_per_s": 12 / seconds,
              "kernel": kernel, "launches": launches,
              "launches_per_forward": launches / len(plans),
              "launches_per_layer": launches / len(plans)
              / layers_per_forward,
              "full_rung": [cfg.data.batch_size, 1700],
              "full_rung_seconds": full_s,
              "full_rung_utt_per_s": cfg.data.batch_size / full_s,
              "plain_forward_seconds": plain_s,
              "rnn_rel_err": rnn_err, "rnn_rel_tol": RNN_REL_TOL,
              "misdirected_rnn_rel_err": bad_err,
              "logprob_max_abs_err": lp_err,
              "argmax_agreement": agree, "argmax_floor": ARGMAX_FLOOR}
    print(json.dumps(result), flush=True)
    return launches


def quant_effect_phase(preset: str):
    """For information, not a gate: what weight-only int8 quantization
    itself does to ``preset`` on the same weights. The bf16 and the int8
    engine in turn, each alone on the card: the bytes its model holds,
    its peak device memory over a full (32, 1700) rung, its log-probs on
    that rung and its transcripts of a mixed request."""
    from deepspeech_tpu_torch.config import get_config
    from deepspeech_tpu_torch.data import CharTokenizer
    from deepspeech_tpu_torch.infer import Inferencer
    from deepspeech_tpu_torch.metrics import cer

    cfg = get_config(preset)
    params, stats = _weights(preset)
    rng = np.random.default_rng(SEED + 1)
    batch = _request(cfg, 12, rng)
    n, f = cfg.data.batch_size, cfg.features.num_features
    full = _request(cfg, n, rng)
    full["feat_lens"][:] = 1700
    out = {}
    for quantize in ("", "int8"):
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        inf = Inferencer(cfg, CharTokenizer.english(), params, stats,
                         quantize=quantize)
        held = torch.cuda.memory_allocated() - base
        torch.cuda.reset_peak_memory_stats()
        lp, lens = inf.forward(full["features"][:, :1700], full["feat_lens"])
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        out[quantize or "bf16"] = {
            "lp": lp.cpu(), "lens": lens.cpu(),
            "texts": inf.decode_batch_bucketed(batch),
            "model_device_bytes": held, "peak_device_bytes": peak,
            "report": inf.quantize_report}
        del inf, lp, lens
    fp, q = out["bf16"], out["int8"]
    valid = torch.arange(fp["lp"].shape[1])[None] < fp["lens"][:, None]
    print(json.dumps({
        "quant_effect": preset, "gate": False,
        "quantize_report": q["report"],
        "model_device_bytes": {k: v["model_device_bytes"]
                               for k, v in out.items()},
        "peak_device_bytes_full_rung": {k: v["peak_device_bytes"]
                                        for k, v in out.items()},
        "logprob_max_abs_diff": float((q["lp"] - fp["lp"]).abs()[valid]
                                      .max()),
        "argmax_agreement": float((q["lp"].argmax(-1) == fp["lp"]
                                   .argmax(-1))[valid].float().mean()),
        "transcripts_identical": sum(a == b for a, b in zip(q["texts"],
                                                            fp["texts"])),
        "transcripts": len(q["texts"]),
        "cer_int8_vs_bf16": cer(fp["texts"], q["texts"])}), flush=True)


class _FixedBatch:
    """One host batch with the interface ``Trainer`` reads."""

    def __init__(self, batch):
        self.batch = batch

    def peek(self):
        return self.batch

    def epoch(self, epoch_idx: int):
        return iter([self.batch])

    def eval_epoch(self):
        return iter([(self.batch, len(self.batch["feat_lens"]))])

    def batches_per_epoch(self, epoch_idx: int) -> int:
        return 1


def _train_batch(cfg, rng):
    """A full (B, 1700) training batch: 300..1700 frames, one of 1700,
    0.15 characters per frame (random ids 1..28, at most L_MAX)."""
    from deepspeech_tpu_torch.data import pad_batch

    n, f = cfg.data.batch_size, cfg.features.num_features
    lens = rng.integers(300, 1701, size=n)
    lens[0] = 1700
    feats = [rng.normal(size=(t, f)).astype(np.float32) for t in lens]
    labels = [rng.integers(1, V, size=min(int(0.15 * t), L_MAX)).tolist()
              for t in lens]
    return pad_batch(feats, labels, 1700, cfg.data.max_label_len,
                     cfg.model.time_stride)


def _group(name: str) -> str:
    if ".wh_" in name or ".bh_" in name:
        return "recurrent"
    if ".wx." in name:
        return "wx"
    if name.startswith("conv."):
        return "conv"
    return "head"  # BN of the RNN layers, lookahead, bn_out, head


def _grads(model, dev):
    """The whole model's gradient of the mean CTC loss on ``dev``, in
    train mode (no optimizer step)."""
    from deepspeech_tpu_torch.ops.ctc import ctc_loss_mean

    model.train()
    model.zero_grad(set_to_none=True)
    logits, lens = model(dev["features"], dev["feat_lens"])
    ctc_loss_mean(logits, dev["labels"], lens, dev["label_lens"]).backward()
    torch.cuda.synchronize()
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def _group_rel(got, ref):
    """||got - ref|| / ||ref|| per parameter group."""
    out = {}
    for group in ("recurrent", "wx", "conv", "head"):
        names = [n for n in ref if _group(n) == group]
        num = sum(float((got[n] - ref[n]).float().square().sum())
                  for n in names)
        den = sum(float(ref[n].float().square().sum()) for n in names)
        out[group] = math.sqrt(num / den)
    return out


_LSTM_KERNELS = ("lstm_fwd", "lstm_fwd_stream", "lstm_fwd_q",
                 "lstm_fwd_q_stream", "lstm_bwd", "lstm_bwd_stream")


def _counts():
    from deepspeech_tpu_torch.ops import ctc, gru, lstm

    return {"gru_fwd": gru.gru_fwd.launches, "gru_bwd": gru.gru_bwd.launches,
            "gru_fwd_stream": gru.gru_fwd_stream.launches,
            "gru_bwd_stream": gru.gru_bwd_stream.launches,
            "gru_fwd_q": gru.gru_fwd_q.launches,
            "gru_fwd_q_stream": gru.gru_fwd_q_stream.launches,
            **{k: getattr(lstm, k).launches for k in _LSTM_KERNELS},
            "ctc_alpha": ctc.ctc_alpha.launches
            - ctc.ctc_alpha.loss_only_launches,
            "loss_only": ctc.ctc_alpha.loss_only_launches,
            "ctc_beta": ctc.ctc_beta.launches}


def _zero_counts() -> None:
    from deepspeech_tpu_torch.ops import ctc, gru, lstm

    gru.gru_fwd.launches = gru.gru_bwd.launches = 0
    gru.gru_fwd_stream.launches = gru.gru_bwd_stream.launches = 0
    gru.gru_fwd_q.launches = gru.gru_fwd_q_stream.launches = 0
    for k in _LSTM_KERNELS:
        getattr(lstm, k).launches = 0
    ctc.ctc_alpha.launches = ctc.ctc_alpha.loss_only_launches = 0
    ctc.ctc_beta.launches = 0


def train_phase(preset: str, layers: int, streamed: bool, steps: int,
                descent_steps: int, rnn_type: str = "gru"):
    """``Trainer`` steps on ``preset`` with ``rnn_type`` cells at full
    width and ``layers`` recurrent layers (the preset's depth, or fewer
    to cut the phase's time); its layers must run the streamed kernels
    of that cell when ``streamed``, else the resident ones
    (``gru_fwd``/``gru_bwd``, or ``lstm_fwd`` with its tape and
    ``lstm_bwd``), one forward and one backward launch per layer per
    step, and no kernel of the other cell. ``steps`` timed steps,
    ``descent_steps`` AdamW steps on the fixed batch."""
    from deepspeech_tpu_torch.bridge import init_params
    from deepspeech_tpu_torch.config import apply_overrides
    from deepspeech_tpu_torch.data import CharTokenizer
    from deepspeech_tpu_torch.ops import ctc, gru, lstm
    from deepspeech_tpu_torch.ops.ctc import ctc_loss_mean
    from deepspeech_tpu_torch.train import Trainer, to_device

    cfg = apply_overrides(_config(preset, rnn_type),
                          {"train.checkpoint_dir": "",
                           "model.rnn_layers": str(layers)})
    path = preset if rnn_type == "gru" else f"{preset}-{rnn_type}"
    params, stats = init_params(cfg, torch.Generator().manual_seed(SEED))
    batch = _train_batch(cfg, np.random.default_rng(SEED))
    pipe, tok = _FixedBatch(batch), CharTokenizer.english()
    trainer = Trainer(cfg, pipe, tok, params=params, batch_stats=stats)
    trainer.train_step(batch)  # warm-up: cuBLAS/cuDNN handles
    torch.cuda.synchronize()

    _zero_counts()
    t0 = time.perf_counter()
    metrics = [trainer.train_step(batch) for _ in range(steps)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _counts()
    fwd, bwd = (f"{rnn_type}_fwd", f"{rnn_type}_bwd")
    if streamed:
        fwd, bwd = f"{fwd}_stream", f"{bwd}_stream"
    want = {k: 0 for k in counts}
    want.update({fwd: layers * steps, bwd: layers * steps,
                 "ctc_alpha": steps, "ctc_beta": steps})
    _require(counts == want, f"{path} train: launches {counts} in "
             f"{steps} steps, want {want}")
    metrics = [{k: float(v) for k, v in m.items()} for m in metrics]
    _require(all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
                 for m in metrics), f"{path} train: non-finite {metrics}")

    # The whole model's gradient against the same step with every kernel
    # patched to its plain version, and against a backward whose first
    # direction runs the wrong way through time, which must fail. Each
    # layer calls its cell's wrappers through the module's names, with
    # ``reverse`` last.
    ops = gru if rnn_type == "gru" else lstm
    wrapper = f"{rnn_type}_bwd"
    plain = {f"{rnn_type}_fwd": getattr(ops, f"{rnn_type}_fwd_plain"),
             wrapper: getattr(ops, f"{wrapper}_plain")}
    real_bwd = getattr(ops, wrapper)

    def misdirected(*args):
        *rest, reverse = args
        return real_bwd(*rest, [not reverse[0], *reverse[1:]])

    misdirected.launches = 0  # as in path_phase's control

    dev = to_device(batch, trainer.device)
    g_kernel = _grads(trainer.model, dev)
    with mock.patch.multiple(ops, **plain), \
            mock.patch.multiple(ctc, ctc_alpha=ctc.ctc_alpha_plain,
                                ctc_beta=ctc.ctc_beta_plain):
        t1 = time.perf_counter()
        g_plain = _grads(trainer.model, dev)
        plain_s = time.perf_counter() - t1
    with mock.patch.object(ops, wrapper, misdirected):
        g_bad = _grads(trainer.model, dev)
    rel, rel_bad = _group_rel(g_kernel, g_plain), _group_rel(g_bad, g_plain)
    _require(max(rel.values()) <= GRAD_REL_TOL,
             f"{path}: gradient differs from the plain path by {rel} > "
             f"{GRAD_REL_TOL} (relative, per group)")
    _require(max(rel_bad.values()) > GRAD_REL_TOL,
             f"{path}: a mis-directed {wrapper} reads {rel_bad}, within "
             f"{GRAD_REL_TOL}: the check cannot tell it from the kernel")
    del trainer, g_kernel, g_plain, g_bad

    # The same in float32, where bf16 rounding cannot hide a fault.
    cfg32 = apply_overrides(cfg, {"model.dtype": "float32"})
    m32 = Trainer(cfg32, pipe, tok, params=params, batch_stats=stats).model
    g32 = _grads(m32, dev)
    with mock.patch.multiple(ops, **plain), \
            mock.patch.multiple(ctc, ctc_alpha=ctc.ctc_alpha_plain,
                                ctc_beta=ctc.ctc_beta_plain):
        g32_plain = _grads(m32, dev)
        nudged = dict(dev, features=dev["features"] * (1 + 2.0 ** -22))
        floor32 = _group_rel(_grads(m32, nudged), g32_plain)
    rel32 = _group_rel(g32, g32_plain)
    _require(max(rel32.values()) <= GRAD_REL_TOL_F32,
             f"{path}: f32 gradient differs from the plain path by "
             f"{rel32} > {GRAD_REL_TOL_F32} (relative, per group)")
    del m32, g32, g32_plain

    # AdamW on the fixed batch; its loss, measured without a gradient
    # (the loss-only kernel), must fall.
    cfg_a = apply_overrides(cfg, {"train.optimizer": "adamw",
                                  "train.learning_rate": "0.001",
                                  "train.warmup_steps": "1"})
    tr = Trainer(cfg_a, pipe, tok, params=params, batch_stats=stats)

    def eval_loss() -> float:
        with torch.no_grad():
            tr.model.train()
            logits, lens = tr.model(dev["features"], dev["feat_lens"])
            return float(ctc_loss_mean(logits, dev["labels"], lens,
                                       dev["label_lens"]))

    _zero_counts()
    loss0 = eval_loss()
    for _ in range(descent_steps):
        tr.train_step(batch)
    loss1 = eval_loss()
    descent = _counts()
    _require(descent["loss_only"] == 2 and descent["ctc_beta"]
             == descent_steps and descent[bwd] == layers * descent_steps,
             f"{path} descent: launches {descent}")
    _require(loss1 < loss0, f"{path}: loss on the fixed batch went "
             f"{loss0} -> {loss1} over {descent_steps} AdamW steps")
    n = cfg.data.batch_size
    print(json.dumps({
        "path": f"{path} train", "layers": layers, "batch": [n, 1700],
        "frames": [int(x) for x in batch["feat_lens"]][:4] + ["..."],
        "steps": steps, "seconds": seconds,
        "steps_per_s": steps / seconds,
        "utt_per_s": steps * n / seconds,
        "launches_per_step": {k: v / steps for k, v in counts.items()},
        "launches_per_layer_step": {
            k: counts[k] / steps / layers for k in (fwd, bwd)},
        "losses": [m["loss"] for m in metrics],
        "grad_norms": [m["grad_norm"] for m in metrics],
        "grad_rel_err": rel, "misdirected_grad_rel_err": rel_bad,
        "grad_rel_tol": GRAD_REL_TOL, "plain_grad_seconds": plain_s,
        "f32_grad_rel_err": rel32, "f32_grad_rel_tol": GRAD_REL_TOL_F32,
        "f32_plain_noise_floor": floor32,
        "descent": {"optimizer": "adamw", "lr": 1e-3,
                    "steps": descent_steps, "loss_before": loss0,
                    "loss_after": loss1,
                    "loss_only_launches": descent["loss_only"]}}),
          flush=True)
    return {"bwd": counts[bwd], "ctc_alpha": counts["ctc_alpha"],
            "ctc_beta": counts["ctc_beta"],
            "loss_only": descent["loss_only"]}


# The manifest phase: ds2_small at full width trains on WAV files
# through DataPipeline, device_prefetch and Trainer.fit with
# checkpoints, resumes in a fresh Trainer, and serves the newest step.
MANIFEST_BUCKETS = (400, 800, 1200, 1700)   # ds2_small's bucket_frames
MANIFEST_PER_BUCKET = 32                     # one batch a bucket an epoch
MANIFEST_EVAL = 40
MANIFEST_EVERY = 3                           # checkpoint_every_steps
MANIFEST_TIMED = 16                          # steps a turn of the timing
MANIFEST_LETTERS = "abcdefghijklmnopqrstuvwxyz '"


def _write_wav(path: str, audio: np.ndarray) -> None:
    import wave

    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.clip(audio, -1, 1) * 32767).astype(np.int16)
                      .tobytes())


def _write_corpus(root: str, name: str, durations, rng) -> str:
    """16 kHz 16-bit WAVs of ``durations`` seconds (tones in noise) with
    random English transcripts of about 0.15 characters a frame, and
    their manifest; returns the manifest's path."""
    from deepspeech_tpu_torch.data import Utterance, save_manifest

    utts = []
    for i, dur in enumerate(durations):
        dur = round(float(dur), 3)
        t = np.arange(int(dur * 16000), dtype=np.float32) / 16000.0
        audio = (0.3 * np.sin(2 * np.pi * rng.uniform(100, 3000) * t)
                 + 0.05 * rng.standard_normal(t.shape, dtype=np.float32))
        path = os.path.join(root, f"{name}{i}.wav")
        _write_wav(path, audio)
        n = max(int(0.15 * dur * 100), 1)
        text = "".join(rng.choice(list(MANIFEST_LETTERS), size=n)).strip()
        utts.append(Utterance(path, text or "a", dur))
    manifest = os.path.join(root, f"{name}.jsonl")
    save_manifest(manifest, utts)
    return manifest


class _Events:
    """A logger that keeps the trainer's events."""

    def __init__(self):
        self.events = []

    def log(self, event: str, **fields) -> None:
        self.events.append((event, fields))


def manifest_phase(root: str):
    """ds2_small (2 conv, 3 BiGRU H=800, bf16, B=32) at full width on a
    WAV manifest: 2 epochs (8 steps) of ``Trainer.fit`` with waveform
    augmentation and SpecAugment, a checkpoint every 3 steps and at each
    epoch's end (steps 3, 4, 6, 8); step 8 deleted, a fresh Trainer
    restores step 6 in epoch 1 and takes exactly the 2 steps left,
    ending with the first run's parameters and optimizer state bit for
    bit, the batches ``device_prefetch`` delivered equal to the host's;
    then ``Inferencer(params=None)`` serves the newest step through
    ``decode_batch_bucketed``, its log-probs on a (32, 1700) rung equal
    to the trained model's, and ``restore_params(average_last=2)`` the
    mean of steps 6 and 8. Returns the launches of the main path (both
    fits and the serving) by kernel."""
    from deepspeech_tpu_torch import train as train_mod
    from deepspeech_tpu_torch.checkpoint import CheckpointManager
    from deepspeech_tpu_torch.config import apply_overrides, get_config
    from deepspeech_tpu_torch.data import (CharTokenizer, DataPipeline,
                                           device_prefetch)
    from deepspeech_tpu_torch.data.infer_bucket import plan_infer_buckets
    from deepspeech_tpu_torch.infer import Inferencer, restore_params
    from deepspeech_tpu_torch.metrics import cer, wer
    from deepspeech_tpu_torch.ops import gru
    from deepspeech_tpu_torch.ops.ctc import ctc_loss_mean
    from deepspeech_tpu_torch.train import Trainer, to_device

    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    edges = (0.3,) + tuple(e / 100 for e in MANIFEST_BUCKETS)
    train_durs = np.concatenate([
        rng.uniform(lo + 0.05, min(hi, 16.5) - 0.05, MANIFEST_PER_BUCKET)
        for lo, hi in zip(edges[:-1], edges[1:])])
    train_m = _write_corpus(root, "train", train_durs, rng)
    eval_m = _write_corpus(root, "eval", rng.uniform(
        0.5, min(edges[-1], 16.5) - 0.1, MANIFEST_EVAL), rng)
    write_s = time.perf_counter() - t0
    ck = os.path.join(root, "ck")
    cfg = apply_overrides(get_config("ds2_small"), {
        "data.train_manifest": train_m, "data.eval_manifest": eval_m,
        "data.augment": "true", "data.spec_augment": "true",
        "train.checkpoint_dir": ck, "train.epochs": "2",
        "train.checkpoint_every_steps": str(MANIFEST_EVERY)})
    _require(cfg.data.bucket_frames == MANIFEST_BUCKETS
             and cfg.data.batch_size == B and cfg.model.rnn_hidden == H,
             f"ds2_small is not the configuration this phase was cut for: "
             f"{cfg.data}")
    tok = CharTokenizer.english()
    params, stats = _weights("ds2_small")

    def trainer():
        return Trainer(cfg, DataPipeline(cfg, tok, train_m), tok,
                       DataPipeline(cfg, tok, eval_m), _Events(),
                       params=params, batch_stats=stats)

    # Prefetched batches, copied back to the host as they are consumed,
    # beside the host batches they were made from.
    seen = {"host": [], "device": []}

    def recording_prefetch(batches, device, depth=2):
        def tee():
            for b in batches:
                seen["host"].append(b)
                yield b
        for dev in device_prefetch(tee(), device, depth):
            seen["device"].append({k: v.cpu() for k, v in dev.items()})
            yield dev

    _zero_counts()
    t0 = time.perf_counter()
    full = trainer()
    full.fit()
    fit_s = time.perf_counter() - t0
    steps_full = full.ckpt.all_steps()
    _require(full.step == 8 and steps_full == [4, 6, 8],
             f"uninterrupted run: step {full.step}, steps on disk "
             f"{steps_full} (keep 3 of 3, 4, 6, 8)")
    shutil.rmtree(os.path.join(ck, "8"))
    resumed = trainer()
    resumed.maybe_restore()
    _require((resumed.step, resumed.start_epoch) == (6, 1),
             f"restored step {resumed.step} in epoch {resumed.start_epoch}"
             ", want step 6 in epoch 1")
    t0 = time.perf_counter()
    with mock.patch.object(train_mod, "device_prefetch", recording_prefetch):
        resumed.fit()
    resume_s = time.perf_counter() - t0
    _require(resumed.step == 8 and len(seen["host"]) == 2,
             f"resumed run: step {resumed.step} after "
             f"{len(seen['host'])} batches, want 8 after 2")
    # Serving: the newest step through decode_batch_bucketed over the
    # eval manifest, and a loss without a gradient (the loss-only kernel)
    # on its (32, 1700) rung.
    t0 = time.perf_counter()
    inf = Inferencer(cfg, tok)
    eval_pipe = DataPipeline(cfg, tok, eval_m)
    refs, hyps, rung = [], [], None
    n_eval = n_served = 0
    for batch, n_valid in eval_pipe.eval_epoch():
        n_eval += 1
        n_served += len(plan_infer_buckets(batch["feat_lens"],
                                           cfg.data.bucket_frames, B))
        hyps += inf.decode_batch_bucketed(batch)[:n_valid]
        refs += [tok.decode(batch["labels"][g][:batch["label_lens"][g]])
                 for g in range(n_valid)]
        if batch["features"].shape[1] == MANIFEST_BUCKETS[-1]:
            rung = batch
    dev = to_device(rung, inf.device)
    with torch.no_grad():
        logits, lens = inf.model(dev["features"], dev["feat_lens"])
        eval_loss = ctc_loss_mean(logits, dev["labels"], lens,
                                  dev["label_lens"])
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    counts = _counts()
    # 3 BiGRU layers, so 3 gru_fwd a forward: 10 steps (8, then 2
    # resumed); 3 evaluations (2 epochs, then the resumed one) of the
    # n_eval eval batches; the serving's ladder plans; the loss without a
    # gradient (its one loss-only launch).
    want = {k: 0 for k in counts}
    want.update({"gru_bwd": 30, "ctc_alpha": 10, "ctc_beta": 10,
                 "loss_only": 1,
                 "gru_fwd": 3 * (10 + 3 * n_eval + n_served + 1)})
    _require(counts == want,
             f"manifest path: launches {counts}, want {want} ({n_eval} "
             f"eval batches, {n_served} served plans)")

    # Bit for bit: the resumed run against the uninterrupted one.
    got, ref = resumed.model.state_dict(), full.model.state_dict()
    bad = [k for k in ref if not torch.equal(got[k], ref[k])]
    gs, rs = resumed.optimizer.state_dict(), full.optimizer.state_dict()
    bad += [f"opt {i}.{k}" for i in rs["state"] for k, v in
            rs["state"][i].items() if not torch.equal(gs["state"][i][k], v)]
    _require(not bad and gs["param_groups"] == rs["param_groups"],
             f"the resumed run differs from the uninterrupted one in "
             f"{bad[:6]} ({len(bad)} tensors)")
    for h, d in zip(seen["host"], seen["device"]):
        for k, v in h.items():
            _require(torch.equal(d[k], torch.from_numpy(np.asarray(v))),
                     f"device_prefetch delivered a different {k}")
    # The restored Inferencer against the trained model, on the rung.
    _require(rung is not None and rung["features"].shape[0] == B,
             "no full (32, 1700) eval rung")
    _zero_counts()
    lp, _ = inf.forward(rung["features"], rung["feat_lens"])
    fwd_launches = gru.gru_fwd.launches
    resumed.model.eval()
    with torch.no_grad():
        ref_logits, _ = resumed.model(dev["features"], dev["feat_lens"])
        ref_loss = ctc_loss_mean(ref_logits, dev["labels"], lens,
                                 dev["label_lens"])
    _require(torch.equal(lp, torch.log_softmax(ref_logits, dim=-1))
             and fwd_launches == 3 and torch.equal(eval_loss, ref_loss),
             f"the restored Inferencer's log-probs differ from the trained "
             f"model's, or {fwd_launches} gru_fwd launches (want 3)")
    mgr = CheckpointManager(ck)
    avg, _ = restore_params(ck, average_last=2)
    s6, s8 = mgr.restore(6)["params"], mgr.restore(8)["params"]
    for path in (("head", "kernel"), ("rnn", "rnn1", "wh_fw"),
                 ("conv", "conv0", "kernel")):
        a, b, c = avg, s6, s8
        for key in path:
            a, b, c = a[key], b[key], c[key]
        _require(np.array_equal(a, ((b.astype(np.float64) + c) / 2)
                                .astype(b.dtype)),
                 f"average_last=2 at {'.'.join(path)} is not the mean of "
                 "steps 6 and 8")

    # Informational: featurization a batch (epoch 1, augmented), the
    # step with device_prefetch against the same steps with the pageable
    # to_device, in turns of MANIFEST_TIMED steps (epoch 1's 4 batches
    # over and over, so that the prefetch's start, two batches pinned
    # before the first step once an epoch, is not a quarter of a turn),
    # and the checkpoint's bytes and seconds.
    pipe = resumed.pipeline
    t0 = time.perf_counter()
    host = [pipe._materialize(plan, epoch=1) for plan in
            pipe.sampler.epoch(1)]
    feat_s = (time.perf_counter() - t0) / len(host)
    host = (host * MANIFEST_TIMED)[:MANIFEST_TIMED]

    def steps(prefetch: bool):
        """Seconds a step, and the seconds the consumer's thread spends
        getting each batch onto the card (the wait in device_prefetch,
        or the pageable to_device)."""
        torch.cuda.synchronize()
        t = time.perf_counter()
        batches = device_prefetch(iter(host), resumed.device) \
            if prefetch else iter(host)
        fed = []
        while True:
            t_feed = time.perf_counter()
            b = next(batches, None)
            if b is None:
                break
            if not prefetch:
                b = to_device(b, resumed.device)
            fed.append(time.perf_counter() - t_feed)
            resumed.train_step(b)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / len(host), fed

    turns = {"prefetch": [], "pageable": []}
    feed = {"prefetch": [], "pageable": []}
    for _ in range(2):
        for mode in ("prefetch", "pageable"):
            step_s, feed_s = steps(mode == "prefetch")
            turns[mode].append(step_s)
            feed[mode] += feed_s
    resumed.ckpt = CheckpointManager(os.path.join(root, "timing"))
    t0 = time.perf_counter()
    resumed.save(2)
    snap_s = time.perf_counter() - t0
    resumed.ckpt.wait()
    save_s = time.perf_counter() - t0
    step_dir = os.path.join(root, "timing", str(resumed.step))
    nbytes = {f: os.path.getsize(os.path.join(step_dir, f))
              for f in sorted(os.listdir(step_dir))}
    t0 = time.perf_counter()
    resumed.ckpt.restore()
    restore_s = time.perf_counter() - t0
    print(json.dumps({
        "path": "ds2_small manifest train/resume/serve", "batch": B,
        "utts": {"train": len(train_durs), "eval": MANIFEST_EVAL},
        "write_wavs_seconds": write_s, "fit_seconds": fit_s,
        "resume_fit_seconds": resume_s, "serve_seconds": serve_s,
        "steps_on_disk": steps_full, "resumed_from": [6, 1],
        "bit_identical": True, "prefetched_batches_equal": len(seen["host"]),
        "launches": counts, "quarantined": pipe.quarantined,
        "eval": [f for e, f in full.logger.events if e == "eval"],
        "served": {"wer": wer(refs, hyps), "cer": cer(refs, hyps),
                   "n_utts": len(refs), "eval_loss": float(eval_loss)},
        "featurize_seconds_per_batch": feat_s,
        "step_seconds": {k: float(np.mean(v)) for k, v in turns.items()},
        "step_seconds_turns": turns,
        "feed_seconds": {k: float(np.mean(v)) for k, v in feed.items()},
        "feed_seconds_median": {k: float(np.median(v))
                                for k, v in feed.items()},
        "feed_seconds_first": {k: v[::MANIFEST_TIMED]
                               for k, v in feed.items()},
        "checkpoint_bytes": nbytes, "checkpoint_snapshot_seconds": snap_s,
        "checkpoint_save_seconds": save_s,
        "checkpoint_restore_seconds": restore_s}), flush=True)
    return counts


STREAM_CHUNK = 64            # chunk_frames, ds2_streaming's decode default
STREAM_STREAMS = 32          # streams of the chunked-vs-offline check
# Log-probs, chunked against offline: f32 as the JAX tests hold it; bf16
# measured 0.031 (0.014 int8) on an H100, the window's conv and GEMMs
# rounding at other shapes than the whole utterance's.
STREAM_LP_TOL = {torch.float32: 1e-4, torch.bfloat16: 0.1}
STREAM_TIMED = 32            # chunks timed at each capacity
FEED_BATCHES = 8             # (32, 800) batches of the feed timing


def _stream_weights(cfg, seed: int = SEED):
    """The seeded random init of ``cfg`` for the streaming phases: the
    head scaled by 8, so that no frame's argmax is a near tie, and every
    BN running mean moved by +0.3 off its init, as the JAX package's
    tests/test_streaming.py does, so that a seam error shows."""
    from deepspeech_tpu_torch.bridge import init_params

    params, stats = init_params(cfg, torch.Generator().manual_seed(seed))
    params["head"]["kernel"] = params["head"]["kernel"] * 8.0

    def shift(tree):
        return {k: shift(v) if isinstance(v, dict)
                else v + 0.3 if k == "mean" else v for k, v in tree.items()}

    return params, shift(stats)


def _recurrent_counts():
    return {k: v for k, v in _counts().items()
            if k.startswith(("gru_", "lstm_"))}


def _checking_plain(real, plain, tol, errs):
    """A stand-in for ``real`` (``gru_fwd`` or ``gru_fwd_q``) that runs
    the kernel and its plain version on each call's inputs, records
    ``max |kernel - plain|`` over ys and hfin in ``errs`` and returns the
    plain result: the chunked run then goes through the plain GRU, and
    each of its calls holds the kernel within ``tol``."""
    def both(*args):
        ys, hfin = real(*args)
        ys_p, hfin_p = plain(*args)
        errs.append(max(float((ys - ys_p).abs().max()),
                        float((hfin - hfin_p).abs().max())))
        _require(errs[-1] <= tol, f"{real.__name__} in the chunked run: "
                 f"max |kernel - plain| {errs[-1]} > {tol}")
        return ys_p, hfin_p

    both.launches = 0
    return both


def streaming_phase():
    """ds2_streaming (5 GRU layers at H=800, lookahead 20) at full width
    through ``StreamingTranscriber.transcribe``: 32 streams of 300..1700
    frames in chunks of 64, against the offline forward of the same
    model on the same batch, in f32 (log-probs within 1e-4, identical
    transcripts) and bf16 (within ``STREAM_LP_TOL``); exactly 5 launches
    of ``gru_fwd`` (K6, D=1, carried h0) a chunk and no other recurrent
    kernel; the same run through the plain GRU, each call holding the
    kernel within K6's ``GRU_FWD_TOL``; then ``quantize="int8"``: 5
    ``gru_fwd_q`` (K10 with h0) a chunk, regime "resident-q", against the
    int8 model's offline forward and the plain int8 GRU. Returns the
    launches of K6 and K10 in the counted runs."""
    from deepspeech_tpu_torch.config import apply_overrides
    from deepspeech_tpu_torch.data import CharTokenizer
    from deepspeech_tpu_torch.decode.greedy import greedy_decode, ids_to_texts
    from deepspeech_tpu_torch.ops import gru
    from deepspeech_tpu_torch.ops.gru import card_limits
    from deepspeech_tpu_torch.streaming import StreamingTranscriber
    from deepspeech_tpu_torch.utils.quantize import kernel_regime

    tok = CharTokenizer.english()
    base = _config("ds2_streaming")
    layers = base.model.rnn_layers
    batch = _request(base, STREAM_STREAMS, np.random.default_rng(SEED))
    feats, lens = batch["features"], batch["feat_lens"]
    feats_t = torch.from_numpy(feats).cuda()
    lens_t = torch.from_numpy(lens).long().cuda()
    launches = {"gru_fwd": 0, "gru_fwd_q": 0}
    for dtype, quantize, kernel in (
            (torch.float32, "", "gru_fwd"), (torch.bfloat16, "", "gru_fwd"),
            (torch.bfloat16, "int8", "gru_fwd_q")):
        cfg = apply_overrides(base, {"model.dtype": str(dtype)[6:]})
        params, stats = _stream_weights(cfg)
        st = StreamingTranscriber(cfg, params, stats, tok,
                                  chunk_frames=STREAM_CHUNK,
                                  quantize=quantize)
        name = f"ds2_streaming {quantize or str(dtype)[6:]} chunked"
        if quantize:
            regime = kernel_regime(cfg.model, True, streaming=True,
                                   card=card_limits(torch.device("cuda")))
            _require(regime == "resident-q" and st._keep_q is not None,
                     f"{name}: regime {regime!r}")
        chunks = -(-feats.shape[1] // STREAM_CHUNK) + st.flush_chunks()
        st.transcribe(feats, lens)  # warm-up: cuBLAS/cuDNN handles
        torch.cuda.synchronize()
        _zero_counts()
        t0 = time.perf_counter()
        lo, out_lens = st.transcribe(feats, lens)
        seconds = time.perf_counter() - t0
        counts = _recurrent_counts()
        want = {k: layers * chunks if k == kernel else 0 for k in counts}
        _require(counts == want, f"{name}: recurrent launches {counts} for "
                 f"{chunks} chunks, want {want}")
        launches[kernel] += counts[kernel]
        with torch.no_grad():
            logits, off_lens = st.model(feats_t, lens_t)
        lp_off = torch.log_softmax(logits, -1)
        lp = torch.log_softmax(torch.from_numpy(lo).cuda(), -1)
        _require(np.array_equal(off_lens.cpu().numpy(), out_lens),
                 f"{name}: lengths differ from offline")
        valid = (torch.arange(lp.shape[1], device=lp.device)[None]
                 < off_lens[:, None])
        err = float((lp - lp_off[:, :lp.shape[1]]).abs()[valid].max())
        _require(bool(torch.isfinite(lp[valid]).all()), f"{name}: non-finite")
        texts = ids_to_texts(*greedy_decode(lp, off_lens), tok)
        texts_off = ids_to_texts(*greedy_decode(lp_off, off_lens), tok)
        same_texts = sum(a == b for a, b in zip(texts, texts_off))
        _require(err <= STREAM_LP_TOL[dtype],
                 f"{name}: log-probs differ from offline by {err} > "
                 f"{STREAM_LP_TOL[dtype]}")
        if dtype == torch.float32:
            _require(same_texts == STREAM_STREAMS,
                     f"{name}: {STREAM_STREAMS - same_texts} transcripts "
                     "differ from offline")
        _require(any(texts), f"{name}: every transcript is empty")
        # The same chunked run through the plain GRU on the card.
        errs = []
        real, plain = ((gru.gru_fwd_q, gru.gru_fwd_q_plain) if quantize
                       else (gru.gru_fwd, gru.gru_fwd_plain))
        tol = (TOL if quantize else GRU_FWD_TOL)[dtype]
        with mock.patch.object(gru, kernel,
                               _checking_plain(real, plain, tol, errs)):
            lo_p, _ = st.transcribe(feats, lens)
        _require(len(errs) == layers * chunks,
                 f"{name}: {len(errs)} plain checks, want {layers * chunks}")
        lp_p = torch.log_softmax(torch.from_numpy(lo_p).cuda(), -1)
        print(json.dumps({
            "stream_check": name, "streams": STREAM_STREAMS,
            "frames_max": int(lens.max()), "chunk_frames": STREAM_CHUNK,
            "chunks": chunks, "kernel": kernel, "launches": counts[kernel],
            "launches_per_chunk": counts[kernel] / chunks,
            "kernel_regime": "resident-q" if quantize else "fp",
            "logprob_max_abs_err_vs_offline": err,
            "logprob_tol": STREAM_LP_TOL[dtype],
            "transcripts_equal_offline": same_texts,
            "gru_max_abs_err_vs_plain": max(errs), "gru_tol": tol,
            "logprob_max_abs_err_vs_plain_run": float(
                (lp - lp_p).abs()[valid].max()),
            "seconds": seconds,
            "audio_s_per_s": float(lens.sum()) * 0.01 / seconds}),
            flush=True)
        del st
    return launches


class _Recorder:
    """Keeps, for each session, the valid logits rows of every chunk it
    took part in, across managers: ``attach`` wraps a manager's
    ``process_chunk``."""

    def __init__(self):
        self.rows = {}

    def attach(self, mgr):
        real = mgr.st.process_chunk

        def wrapped(state, chunk):
            state, lo, va = real(state, chunk)
            for sid, sess in mgr._sessions.items():
                self.rows.setdefault(sid, []).append(
                    lo[sess.slot][va[sess.slot]])
            return state, lo, va

        mgr.st.process_chunk = wrapped
        return mgr

    def logits(self, sid):
        return torch.cat(self.rows[sid])


def sessions_phase():
    """``StreamingSessionManager`` (greedy) on ds2_streaming in bf16 at
    full width, capacity 4: a session "b" joins a running manager at
    clock 128; "a" is exported after 3 chunks and imported into a second
    manager of the same capacity, where "c" has been streaming, and
    leaves there with a tail of 37 frames. Each final must equal its
    solo stream's (a fresh manager of the same capacity), and each
    session's logits rows must equal its solo run's bit for bit (equal
    shapes). Prints the snapshot's bytes."""
    from deepspeech_tpu_torch.data import CharTokenizer
    from deepspeech_tpu_torch.serving.session import StreamingSessionManager

    cfg = _config("ds2_streaming")
    params, stats = _stream_weights(cfg)
    tok = CharTokenizer.english()
    f = cfg.features.num_features
    rng = np.random.default_rng(SEED + 1)
    feats = {sid: rng.normal(size=(n, f)).astype(np.float32)
             for sid, n in (("a", 6 * 64 + 37), ("b", 5 * 64),
                            ("c", 7 * 64))}

    def chunk(sid, i):
        return feats[sid][i * 64:(i + 1) * 64]

    def make(rec):
        return rec.attach(StreamingSessionManager(
            cfg, params, stats, tok, chunk_frames=STREAM_CHUNK, capacity=4))

    rec = _Recorder()
    src, dst = make(rec), make(rec)
    src.join("a")
    dst.join("c")
    for i in range(2):
        src.step({"a": chunk("a", i)})
        dst.step({"c": chunk("c", i)})
    src.join("b")                                   # mid-flight, clock 128
    _require(src._sessions["b"].raw_start == 128, "b did not join at 128")
    src.step({"a": chunk("a", 2), "b": chunk("b", 0)})
    dst.step({"c": chunk("c", 2)})
    snap = src.export_session("a")
    _require(all(isinstance(x, np.ndarray) for x in
                 (snap.acoustic["raw_hist"], snap.acoustic["la_buf"],
                  *snap.acoustic["h"])), "snapshot leaves are not numpy")
    dst.import_session(snap)
    for i in range(3, 6):
        src.step({"b": chunk("b", i - 2)})
        dst.step({"a": chunk("a", i), "c": chunk("c", i)})
    dst.leave("a", tail=feats["a"][6 * 64:])
    src.step({"b": chunk("b", 4)})
    src.leave("b")
    dst.step({"c": chunk("c", 6)})
    dst.leave("c")
    src.flush()
    dst.flush()
    finals = {"a": dst.final("a"), "b": src.final("b"), "c": dst.final("c")}
    report = {"capacity": 4, "snapshot_nbytes": snap.nbytes(),
              "finals_nonempty": sum(bool(t) for t in finals.values())}
    for sid, x in feats.items():
        solo_rec = _Recorder()
        solo = make(solo_rec)
        solo.join(sid)
        n = x.shape[0] // 64
        for i in range(n):
            solo.step({sid: chunk(sid, i)})
        solo.leave(sid, tail=x[n * 64:] if x.shape[0] % 64 else None)
        solo.flush()
        _require(solo.final(sid) == finals[sid],
                 f"session {sid}: final {finals[sid]!r} != solo "
                 f"{solo.final(sid)!r}")
        got, want = rec.logits(sid), solo_rec.logits(sid)
        _require(got.shape == want.shape,
                 f"session {sid}: {got.shape} logits rows, solo "
                 f"{want.shape}")
        report[f"{sid}_logits_bit_identical"] = bool(torch.equal(got, want))
        report[f"{sid}_logits_max_abs_diff"] = float(
            (got - want).abs().max())
        _require(report[f"{sid}_logits_bit_identical"],
                 f"session {sid}: logits differ from solo by "
                 f"{report[f'{sid}_logits_max_abs_diff']}")
    _require(report["finals_nonempty"] > 0, "every final is empty")
    print(json.dumps({"sessions": report, "stats_src": src.stats(),
                      "stats_dst": dst.stats()}), flush=True)


def _write_speech(path: str, seconds, rng) -> None:
    """Bursts of tones in noise, standing in for speech, parted by 1 s of
    silence."""
    parts = []
    for sec in seconds:
        t = np.arange(int(sec * 16000)) / 16000.0
        parts += [0.3 * np.sin(2 * np.pi * rng.uniform(100, 2000) * t)
                  + 0.05 * rng.normal(size=t.shape), np.zeros(16000)]
    _write_wav(path, np.concatenate(parts[:-1]))


def serve_phase(root: str):
    """``serve.serve_files`` on 8 WAVs written from a seed (3.5..17 s,
    bursts parted by silence) on ds2_streaming in bf16: its finals must
    equal ``Inferencer(decode.mode="streaming")``'s transcripts on the
    same WAVs; again with endpointing (800 ms), which must cut segments.
    Returns the ``gru_fwd`` launches of the two serving runs."""
    import io

    from deepspeech_tpu_torch import serve
    from deepspeech_tpu_torch.config import apply_overrides
    from deepspeech_tpu_torch.data import (CharTokenizer, featurize_np,
                                           load_audio)
    from deepspeech_tpu_torch.infer import Inferencer

    cfg = _config("ds2_streaming")
    params, stats = _stream_weights(cfg)
    tok = CharTokenizer.english()
    rng = np.random.default_rng(SEED + 2)
    paths = []
    for i in range(8):
        n = int(rng.integers(2, 6))
        secs = rng.uniform(0.8, 2.2, size=n)
        secs *= min(1.0, (17.0 - (n - 1)) / secs.sum())
        paths.append(os.path.join(root, f"live{i}.wav"))
        _write_speech(paths[-1], secs, rng)
    _zero_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    finals = serve.serve_files(cfg, tok, params, stats, paths, out=out)
    seconds = time.perf_counter() - t0
    lines = [json.loads(x) for x in out.getvalue().splitlines()]
    chunk_ms = sorted(x["ms"] for x in lines if "chunk" in x)
    out_ep = io.StringIO()
    finals_ep = serve.serve_files(cfg, tok, params, stats, paths, out=out_ep,
                                  endpoint_silence_ms=800)
    counts = _recurrent_counts()
    launches = counts["gru_fwd"]
    _require(launches > 0 and sum(counts.values()) == launches,
             f"serve: recurrent launches {counts}")
    segments = [json.loads(x) for x in out_ep.getvalue().splitlines()
                if x.startswith('{"segment"')]
    feats = [featurize_np(load_audio(p, 16000), cfg.features) for p in paths]
    lens = np.asarray([len(x) for x in feats], np.int32)
    batch = np.zeros((8, lens.max(), cfg.features.num_features), np.float32)
    for i, x in enumerate(feats):
        batch[i, :len(x)] = x
    inf = Inferencer(apply_overrides(cfg, {"decode.mode": "streaming"}),
                     tok, params, stats)
    texts = inf.decode_batch({"features": batch, "feat_lens": lens})
    _require(finals == texts, f"serve finals {finals} != streaming "
             f"Inferencer {texts}")
    _require(any(finals), "every serve final is empty")
    _require(len(segments) > 0 and len(finals_ep) == 8,
             f"endpointing cut {len(segments)} segments")
    print(json.dumps({"serve": {
        "streams": 8, "frames": lens.tolist(), "chunks": len(chunk_ms),
        "seconds": seconds, "chunk_wall_ms_median":
        chunk_ms[len(chunk_ms) // 2], "chunk_wall_ms_max": chunk_ms[-1],
        "finals_equal_streaming_inferencer": True,
        "endpointing_segments": len(segments)}}), flush=True)
    return launches


def chunk_timing_phase(card: str):
    """A chunk of ds2_streaming (bf16, 64 frames) at capacity 1 and 32:
    ms a chunk by CUDA events around a run of ``process_chunk`` calls
    (the device's timeline, the gaps where it waits for the host
    included), wall ms a ``StreamingSessionManager.step`` (host clock,
    its greedy collapse included), and the device's busy ms a chunk by
    kernel from the profiler, with the share of the W transpose each
    ``gru_fwd`` call makes."""
    from deepspeech_tpu_torch.data import CharTokenizer
    from deepspeech_tpu_torch.serving.session import StreamingSessionManager

    cfg = _config("ds2_streaming")
    params, stats = _stream_weights(cfg)
    rng = np.random.default_rng(SEED + 3)
    f = cfg.features.num_features
    for cap in (1, 32):
        mgr = StreamingSessionManager(cfg, params, stats,
                                      CharTokenizer.english(),
                                      chunk_frames=STREAM_CHUNK,
                                      capacity=cap)
        sids = [str(i) for i in range(cap)]
        for sid in sids:
            mgr.join(sid)
        x = rng.normal(size=(cap, STREAM_CHUNK, f)).astype(np.float32)
        feed = {sid: x[i] for i, sid in enumerate(sids)}
        for _ in range(4):
            mgr.step(feed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STREAM_TIMED):
            mgr.step(feed)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / STREAM_TIMED
        chunk = torch.from_numpy(x).cuda()
        state = mgr.state

        def chunks(n):
            s = state
            for _ in range(n):
                s, _, _ = mgr.st.process_chunk(s, chunk)

        event_ms = _time_ms(lambda: chunks(STREAM_TIMED),
                            reps=1) / STREAM_TIMED
        _, ran, _ = _device_kernels(
            lambda: chunks(8), want=frozenset({"gru_fwd_mma_kernel"}),
            every=True)
        busy = sum(ran.values())
        transpose = sum(v for k, v in ran.items() if "transpose" in k)
        top = sorted(ran.items(), key=lambda kv: -kv[1])[:8]
        print(json.dumps({"chunk_timing": {
            "config": "ds2_streaming", "dtype": "bfloat16",
            "capacity": cap, "chunk_frames": STREAM_CHUNK,
            "event_ms_per_chunk": event_ms,
            "wall_ms_per_step": wall_ms,
            "device_busy_ms_per_chunk": busy / 8,
            "device_idle_share": 1 - busy / 8 / event_ms,
            "transpose_share": transpose / busy if busy else None,
            "top_kernels_ms_per_chunk": {k: v / 8 for k, v in top},
            "card": card}}), flush=True)
        del mgr


def feed_phase(card: str):
    """``Inferencer.run`` on ds2_small (bf16) over 8 (32, 800) batches,
    through ``device_prefetch`` and with the copy made pageable in the
    loop (``device_prefetch`` patched in this script only): wall ms a
    batch both ways, for information; transcripts and WER/CER must
    agree."""
    from deepspeech_tpu_torch import infer
    from deepspeech_tpu_torch.data import CharTokenizer, synthetic_batch

    cfg = _config("ds2_small")
    params, stats = _weights("ds2_small")
    inf = infer.Inferencer(cfg, CharTokenizer.english(), params, stats)
    batches = [(synthetic_batch(cfg, 32, 800, 60, seed=s)[0], 32)
               for s in range(FEED_BATCHES)]

    def pageable(it, device, depth=2):
        for b in it:
            yield {k: torch.as_tensor(np.asarray(v)).to(device)
                   for k, v in b.items()}

    class Hyps:
        def __init__(self):
            self.hyps = []

        def log(self, event, **f):
            if event == "utt":
                self.hyps.append(f["hyp"])

    inf.run(batches[:2])  # warm-up
    out = {}
    for way in ("prefetch", "pageable", "pageable", "prefetch"):
        log = Hyps()
        with (mock.patch.object(infer, "device_prefetch", pageable)
              if way == "pageable" else contextlib.nullcontext()):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            summary = inf.run(batches, log)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / FEED_BATCHES
        out.setdefault(way, []).append(ms)
        prev = out.setdefault("result", (summary, log.hyps))
        _require(prev == (summary, log.hyps),
                 f"Inferencer.run {way}: transcripts or WER differ")
    print(json.dumps({"feed": {
        "config": "ds2_small", "batches": FEED_BATCHES, "batch": [32, 800],
        "run_ms_per_batch_prefetch": out["prefetch"],
        "run_ms_per_batch_pageable": out["pageable"], "card": card}}),
        flush=True)


GATEWAY_REQUESTS = 64        # requests of round A (round B: 32 a tier)
GATEWAY_MAX_BATCH = 8        # the gateway's flush cap (rung-full at 8)
GATEWAY_WATCHDOG_S = 120.0   # a round that has not returned fails the run


@contextlib.contextmanager
def _watchdog(what: str, seconds: float):
    """Fail the whole run, at once, if the block has not returned in
    ``seconds``: a hung concurrent launch would otherwise hold the card
    until the caller's time limit."""
    def trip():
        print(f"chip_smoke: watchdog: {what} has not returned in "
              f"{seconds} s", file=sys.stderr, flush=True)
        os._exit(3)

    timer = threading.Timer(seconds, trip)
    timer.daemon = True
    timer.start()
    try:
        yield
    finally:
        timer.cancel()


def _recording_replica(rep, log):
    """Record each micro-batch ``rep`` decodes (its host batch, plan and
    texts) and the log-probs of its inferencer's first forward; the
    faulted dispatch never reaches the backend, so it records nothing."""
    decode = rep.decode_fn
    forward = rep.inferencer.forward
    log[rep.rid] = {"batches": [], "first_lp": None}

    def decode_fn(batch, plan):
        texts = decode(batch, plan)
        log[rep.rid]["batches"].append((batch, plan, texts))
        return texts

    rep.decode_log = log[rep.rid]["batches"]

    def first_forward(features, feat_lens):
        lp, lens = forward(features, feat_lens)
        if log[rep.rid]["first_lp"] is None:
            log[rep.rid]["first_lp"] = lp
        return lp, lens

    rep.decode_fn = decode_fn
    rep.inferencer.forward = first_forward
    return forward


def _gateway_round(name, reps, tiers, n, rng, plan=None):
    """``n`` requests (300..1700 frames; ``tiers`` cycled) through a
    ``MicroBatchScheduler`` over ``ReplicaPool(reps)``, pumped by
    ``dispatch_many`` (one worker thread per replica), under the
    watchdog; every result must be ok and every replica must have
    dispatched. Then each replica's micro-batches are decoded again,
    serially, by its own inferencer: the texts must be equal, the first
    micro-batch's log-probs bit-equal; its rung ledger must count one
    compile per distinct rung; and the recurrent launches of the round
    must be 3 a micro-batch, ``gru_fwd`` for bf16 and ``gru_fwd_q`` for
    int8. Returns the round's report and its launches."""
    from deepspeech_tpu_torch.data.infer_bucket import slice_to_plan
    from deepspeech_tpu_torch.obs.metrics import _labeled
    from deepspeech_tpu_torch.resilience import faults
    from deepspeech_tpu_torch.serving import (MicroBatchScheduler,
                                              ReplicaPool)

    cfg = reps[0].inferencer.cfg
    log, forwards = {}, {}
    for rep in reps:
        forwards[rep.rid] = _recording_replica(rep, log)
    pool = ReplicaPool(reps, telemetry=reps[0].telemetry)
    sched = MicroBatchScheduler(cfg.data.bucket_frames, GATEWAY_MAX_BATCH,
                                max_queue=4 * n, default_deadline=60.0,
                                default_timeout=None, pool=pool,
                                telemetry=reps[0].telemetry)
    f = cfg.features.num_features
    lens = rng.integers(300, 1701, size=n)
    reqs = [(rng.normal(size=(int(t), f)).astype(np.float32),
             tiers[k % len(tiers)]) for k, t in enumerate(lens)]
    torch.cuda.synchronize()
    _zero_counts()
    if plan is not None:
        faults.install(plan)
    t0 = time.perf_counter()
    try:
        with _watchdog(f"gateway round {name}", GATEWAY_WATCHDOG_S):
            for k, (x, tier) in enumerate(reqs):
                sched.submit(x, rid=f"{name}{k}", tier=tier)
            while sched.pending:
                sched.dispatch_many(sched.poll() or sched.flush_all())
            torch.cuda.synchronize()
    finally:
        faults.clear()
    wall = time.perf_counter() - t0
    counts = _recurrent_counts()
    results = sched.results
    _require(len(results) == n and all(r.status == "ok"
                                       for r in results.values()),
             f"gateway round {name}: results "
             f"{sorted({r.status for r in results.values()})}")
    report = {"requests": n, "frames": int(lens.sum()), "seconds": wall,
              "utt_per_s": n / wall, "replicas": {}}
    want = {"gru_fwd": 0, "gru_fwd_q": 0}
    for rep in reps:
        rec = log[rep.rid]
        kernel = "gru_fwd_q" if rep.inferencer.quantize_calls else "gru_fwd"
        want[kernel] += 3 * len(rec["batches"])
        _require(rec["batches"], f"gateway round {name}: {rep.rid} never "
                 "dispatched")
        rungs = {(p.batch_pad, p.bucket_frames) for _, p, _ in
                 rec["batches"]}
        stats = rep.inferencer.shape_cache.stats()
        _require(stats["compiles"] == len(rungs),
                 f"gateway round {name}: {rep.rid} compiles "
                 f"{stats['compiles']} != {len(rungs)} distinct rungs")
        rep.inferencer.forward = forwards[rep.rid]
        for batch, p, texts in rec["batches"]:
            again = rep.inferencer.decode_batch_bucketed(batch, plans=[p])
            _require(again == texts, f"gateway round {name}: {rep.rid}'s "
                     f"serial re-decode {again} != {texts}")
        batch, p, _ = rec["batches"][0]
        sub = slice_to_plan(batch, p)
        lp, _ = rep.inferencer.forward(sub["features"], sub["feat_lens"])
        torch.cuda.synchronize()
        _require(torch.equal(lp, rec["first_lp"]),
                 f"gateway round {name}: {rep.rid}'s first micro-batch "
                 "log-probs differ from its serial re-decode by "
                 f"{float((lp - rec['first_lp']).abs().max())}")
        hist = rep.telemetry.hists[_labeled("gateway.dispatch_s",
                                            rep.labels)]
        report["replicas"][rep.rid] = {
            "tier": rep.tier, "kernel": kernel,
            "micro_batches": len(rec["batches"]),
            "dispatches": rep.dispatches, "rows": rep.rows,
            "busy_s": rep.busy_s, "compiles": stats["compiles"],
            "dispatch_ms_p50": hist.percentile(50) * 1e3,
            "dispatch_ms_p95": hist.percentile(95) * 1e3}
    _require(counts == {**{k: 0 for k in counts}, **want},
             f"gateway round {name}: recurrent launches {counts}, want "
             f"{want} (3 a decoded micro-batch)")
    report["busy_over_wall"] = sum(r.busy_s for r in reps) / wall
    report["retries"] = int(sched.telemetry.counter("retries"))
    return report, want


def _concurrent_decode(reps, tries: int = 5):
    """Every replica of ``reps`` decodes the same micro-batch (the
    largest its first replica decoded in the round) at once, one thread
    each, each on its own stream, under ``torch.profiler``; each text
    must equal its replica's serial decode. From the trace's kernel
    events: the cooperative recurrent loops (``gru_fwd*_mma_kernel``) a
    stream ran, the µs two loops of different streams ran at the same
    time (0: the card ran the grids one after the other), and the µs a
    loop ran beside other kernels of another stream. A window that lost
    a stream's loops (the profiler drops some) runs again."""
    rec = max(reps[0].decode_log,
              key=lambda r: r[1].batch_pad * r[1].bucket_frames)
    batch, plan = rec[0], rec[1]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for runs in range(1, tries + 1):
        barrier = threading.Barrier(len(reps))
        texts = {}

        def work(rep):
            barrier.wait()
            texts[rep.rid] = rep._on_stream(rep.decode_fn, batch, plan)

        with torch.profiler.profile(activities=acts) as prof:
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
            time.sleep(0.02)
            threads = [threading.Thread(target=work, args=(r,))
                       for r in reps]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            torch.cuda.synchronize()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        kernels = [(e["args"].get("stream"), float(e["ts"]),
                    float(e["ts"]) + float(e["dur"]), e["name"])
                   for e in events if e.get("cat") == "kernel"]
        loops = [k for k in kernels
                 if re.search(r"gru_fwd(_q)?_mma_kernel", k[3])]
        if (len({k[0] for k in loops}) == len(reps)
                and len(loops) == 3 * len(reps)):
            break
        time.sleep(0.5 * runs)
    for rep in reps:
        want = rep.inferencer.decode_batch_bucketed(batch, plans=[plan])
        _require(texts[rep.rid] == want, f"{rep.rid}'s concurrent decode "
                 f"{texts[rep.rid]} != its serial decode {want}")

    def overlap(a, b):
        return max(0.0, min(a[2], b[2]) - max(a[1], b[1]))

    others = [k for k in kernels if k not in loops]
    return {"rung": [plan.batch_pad, plan.bucket_frames],
            "profiler_windows": runs,
            "loops_per_stream": sorted(
                sum(k[0] == s for k in loops) for s in {k[0] for k in loops}),
            "loop_us": sum(k[2] - k[1] for k in loops),
            "loops_overlap_us": sum(overlap(a, b) for a in loops
                                    for b in loops if a[0] != b[0]) / 2,
            "loop_beside_other_stream_us": sum(
                overlap(a, b) for a in loops for b in others
                if b[0] != a[0]),
            "texts_equal_serial": True}


def gateway_phase(card: str):
    """ds2_small (3 BiGRU layers, H=800) behind the gateway at full width,
    from the seeded init. Round A: two untiered bf16 replicas (each its
    own ``Inferencer`` on the same weights and its own CUDA stream) take
    64 requests, ``dispatch_many`` running them concurrently, with a
    ``FaultPlan`` failing r0's first ``gateway.dispatch`` (its batch is
    quarantined and retried). Round B: a premium bf16 replica and a bulk
    ``Inferencer(quantize="int8")`` replica take 32 requests each.
    Each round's checks are ``_gateway_round``'s; after each, the two
    replicas decode one micro-batch at once under the profiler
    (``_concurrent_decode``: equal to the serial texts, and whether the
    card ran the two cooperative recurrent loops at the same time).
    Prints utt/s, each replica's dispatch p50/p95 and the replicas' busy
    seconds over the round's wall time (above 1: they overlapped).
    Returns the
    ``gru_fwd`` and ``gru_fwd_q`` launches of the two rounds."""
    from deepspeech_tpu_torch.data import CharTokenizer
    from deepspeech_tpu_torch.infer import Inferencer
    from deepspeech_tpu_torch.resilience import FaultPlan, FaultSpec
    from deepspeech_tpu_torch.serving import Replica, ServingTelemetry

    cfg = _config("ds2_small")
    params, stats = _weights("ds2_small")
    tok = CharTokenizer.english()
    rng = np.random.default_rng(SEED + 5)

    def replica(rid, tel, quantize="", tier=None):
        inf = Inferencer(cfg, tok, params, stats, quantize=quantize)
        return Replica.from_inferencer(rid, inf, tier=tier, telemetry=tel)

    tel = ServingTelemetry()
    reps = [replica("r0", tel), replica("r1", tel)]
    _require(all(r.stream is not None for r in reps)
             and reps[0].stream != reps[1].stream,
             "gateway replicas do not have streams of their own")
    plan = FaultPlan([FaultSpec("gateway.dispatch", "error", target="r0",
                                count=1)], seed=SEED)
    round_a, launches_a = _gateway_round("A", reps, [None],
                                         GATEWAY_REQUESTS, rng, plan)
    with _watchdog("concurrent decode A", GATEWAY_WATCHDOG_S):
        round_a["concurrent"] = _concurrent_decode(reps)
    _require(plan.fired() == 1 and round_a["retries"] >= 1,
             f"the fault plan fired {plan.fired()} times, "
             f"{round_a['retries']} retries")
    tel = ServingTelemetry()
    reps = [replica("p0", tel, tier="premium"),
            replica("b0", tel, quantize="int8", tier="bulk")]
    _require(reps[1].inferencer.kernel_regime == "resident-q",
             f"bulk replica regime {reps[1].inferencer.kernel_regime}")
    round_b, launches_b = _gateway_round(
        "B", reps, ["premium", "bulk"], GATEWAY_REQUESTS, rng)
    with _watchdog("concurrent decode B", GATEWAY_WATCHDOG_S):
        round_b["concurrent"] = _concurrent_decode(reps)
    print(card, flush=True)
    print(json.dumps({"gateway": {"preset": "ds2_small",
                                  "max_batch": GATEWAY_MAX_BATCH,
                                  "round_a": round_a, "round_b": round_b},
                      "card": card}), flush=True)
    return {k: launches_a[k] + launches_b[k] for k in launches_a}


def pooled_stream_phase(root: str, card: str):
    """``serve.serve_files_pooled`` on ds2_streaming (5 GRU layers,
    H=800, bf16) at full width over ``serve_phase``'s 8 WAVs in
    ``root``, with 2 replicas, on ``_stream_weights``; then again with
    ``migrate_sessions=True`` and r0's breaker forced open after chunk
    3. The finals of the two runs must be equal, and equal to each
    stream's solo ``StreamingSessionManager`` (capacity 1) fed the same
    zero-padded chunks; the second run must migrate at least one session
    and fall back to no drain; each run's ``gru_fwd`` launches must be 5
    a manager step, summed over the replicas. Returns the launches."""
    import io

    from deepspeech_tpu_torch import serve
    from deepspeech_tpu_torch.data import (CharTokenizer, featurize_np,
                                           load_audio)
    from deepspeech_tpu_torch.serving import PooledSessionRouter
    from deepspeech_tpu_torch.serving.session import StreamingSessionManager

    cfg = _config("ds2_streaming")
    params, stats = _stream_weights(cfg)
    tok = CharTokenizer.english()
    paths = sorted(os.path.join(root, x) for x in os.listdir(root)
                   if x.startswith("live") and x.endswith(".wav"))
    _require(len(paths) == 8, f"pooled streaming: {len(paths)} WAVs")
    steps, routers = [0], []
    real_step = StreamingSessionManager.step
    real_route = PooledSessionRouter.step

    def counted_step(self, chunks=None):
        steps[0] += 1
        return real_step(self, chunks)

    def run(trip_after):
        def route(self, chunks):
            if not routers or routers[-1] is not self:
                routers.append(self)
            out = real_route(self, chunks)
            calls[0] += 1
            if calls[0] == trip_after:
                breaker = self.pool.replica("r0").breaker
                while breaker.state != "open":
                    breaker.record_failure()
            return out

        calls = [0]
        steps[0] = 0
        out = io.StringIO()
        torch.cuda.synchronize()
        _zero_counts()
        t0 = time.perf_counter()
        with mock.patch.object(StreamingSessionManager, "step",
                               counted_step), \
                mock.patch.object(PooledSessionRouter, "step", route):
            finals = serve.serve_files_pooled(
                cfg, tok, params, stats, paths, replicas=2, out=out,
                migrate_sessions=trip_after is not None)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = _recurrent_counts()
        _require(counts["gru_fwd"] == 5 * steps[0] and steps[0] > 0
                 and sum(counts.values()) == counts["gru_fwd"],
                 f"pooled streaming: recurrent launches {counts}, "
                 f"{steps[0]} manager steps (want 5 gru_fwd a step)")
        lines = [json.loads(x) for x in out.getvalue().splitlines()]
        chunk_ms = sorted(x["ms"] for x in lines if "chunk" in x)
        return finals, counts["gru_fwd"], {
            "seconds": seconds, "manager_steps": steps[0],
            "gru_fwd": counts["gru_fwd"], "chunks": len(chunk_ms),
            "chunk_wall_ms_median": chunk_ms[len(chunk_ms) // 2],
            "replica_map": lines[0]["replica_map"],
            "router": routers[-1].stats()}

    finals, launches, plain = run(None)
    finals_mig, launches_mig, migrated = run(3)
    stats_mig = migrated["router"]
    _require(stats_mig["migrations"] >= 1
             and stats_mig["migration_fallbacks"] == 0,
             f"pooled streaming: router {stats_mig}")
    _require(finals_mig == finals, f"pooled streaming: migrated finals "
             f"{finals_mig} != {finals}")
    _require(any(finals), "pooled streaming: every final is empty")
    nf, k = cfg.features.num_features, STREAM_CHUNK
    for path, final in zip(paths, finals):
        x = featurize_np(load_audio(path, 16000), cfg.features)
        mgr = StreamingSessionManager(cfg, params, stats, tok,
                                      chunk_frames=k, capacity=1)
        mgr.join("solo")
        for i in range(-(-x.shape[0] // k)):
            buf = np.zeros((k, nf), np.float32)
            piece = x[i * k:(i + 1) * k]
            buf[:piece.shape[0]] = piece
            mgr.step({"solo": buf})
        mgr.leave("solo")
        mgr.flush()
        _require(mgr.final("solo") == final,
                 f"pooled streaming {os.path.basename(path)}: final "
                 f"{final!r} != solo {mgr.final('solo')!r}")
    print(card, flush=True)
    print(json.dumps({"pooled_stream": {
        "streams": 8, "replicas": 2, "plain": plain, "migrated": migrated,
        "finals_equal_solo": True, "finals_equal_across_runs": True},
        "card": card}), flush=True)
    return launches + launches_mig


BEAM_ROWS_CPU = 2            # rows of the (32, 1700) batch searched on the CPU
BEAM_HOST_ROWS = 1           # rows of beam_fused run by the Python decoder
# Beam scores on the card against the CPU, sort against match, dense
# against hashed fusion: the same search in f32 with other exp/log
# roundings (and, between the tables, bonuses rounded apart), summed
# over up to 850 frames; relative to |score|.
BEAM_SCORE_RTOL = 1e-4
BEAM_PROFILE_FRAMES = 64     # frames of the search under the profiler


def _write_char_arpa(path: str, chars, rng, n2: int, n3: int) -> None:
    """A seeded character trigram ARPA over ``chars`` (with <s>, </s>
    and <unk>): random log10 probs and backoffs, ``n2`` bigrams and
    ``n3`` trigrams drawn from the characters."""
    uni = [f"{rng.uniform(-3, -0.5):.4f}\t{c}\t{rng.uniform(-0.6, 0):.4f}"
           for c in chars]
    grams = {2: set(), 3: set()}
    for n, want in ((2, n2), (3, n3)):
        while len(grams[n]) < want:
            grams[n].add(tuple(chars[int(i)] for i in
                               rng.integers(len(chars), size=n)))
    lines = ["\\data\\", f"ngram 1={len(chars) + 3}", f"ngram 2={n2}",
             f"ngram 3={n3}", "", "\\1-grams:", "-99.0\t<s>\t-0.4",
             "-1.5\t</s>", "-2.5\t<unk>\t-0.3", *uni, "", "\\2-grams:"]
    lines += [f"{rng.uniform(-2, -0.2):.4f}\t{' '.join(g)}\t"
              f"{rng.uniform(-0.5, 0):.4f}" for g in sorted(grams[2])]
    lines += ["", "\\3-grams:"]
    lines += [f"{rng.uniform(-1.5, -0.1):.4f}\t{' '.join(g)}"
              for g in sorted(grams[3])]
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines + ["", "\\end\\", ""]))


def _beam_weights(cfg):
    """The seeded random init of ``cfg`` with the head scaled by 8 (as
    ``_stream_weights``), so that the log-probs are peaked and a
    transcript is not decided by a near tie."""
    from deepspeech_tpu_torch.bridge import init_params

    params, stats = init_params(cfg, torch.Generator().manual_seed(SEED))
    params["head"]["kernel"] = params["head"]["kernel"] * 8.0
    return params, stats


def _beam_batch(cfg, rng, b: int = 32, t: int = 1700):
    """A (b, t) batch of ragged lengths (the first t) of random
    features, as the train phases make it."""
    lens = rng.integers(t // 3, t + 1, size=b).astype(np.int32)
    lens[0] = t
    f = cfg.features.num_features
    feats = np.zeros((b, t, f), np.float32)
    for i, n in enumerate(lens):
        feats[i, :n] = rng.normal(size=(n, f))
    return feats, lens


def _search_rel_err(a, b) -> float:
    """max |a - b| / max(1, |b|) over the live scores of b."""
    a, b = a.float().cpu(), b.float().cpu()
    live = b > -1e29
    return float(((a - b).abs() / b.abs().clamp(min=1.0))[live].max())


def _top1(prefixes, lens):
    p, n = prefixes[:, 0].cpu().numpy(), lens[:, 0].cpu().numpy()
    return [tuple(p[i, :n[i]].tolist()) for i in range(p.shape[0])]


class _Searches:
    """Stands in for ``infer.beam_search``: runs it and keeps each call's
    log-probs, lengths and result, so a phase reads what the
    ``Inferencer`` searched without searching again."""

    def __init__(self, real):
        self.real, self.calls = real, []

    def __call__(self, lp, lens, **kw):
        out = self.real(lp, lens, **kw)
        self.calls.append((lp, lens, kw, out))
        return out


def _search_profile(fn, frames: int):
    """``fn()`` under the profiler: (device busy ms, device kernel
    launches), the launches counted over every CUDA kernel event; the
    search's launches a frame are the launches over ``frames``."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for tries in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
            time.sleep(0.02)
            fn()
            torch.cuda.synchronize()
        busy = launches = 0
        for e in prof.key_averages():
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and e.self_device_time_total > 0):
                busy += e.self_device_time_total / 1e3
                launches += e.count
        if launches > frames:
            break
        time.sleep(0.5)
    return busy, launches


def beam_phase(root: str, card: str):
    """``ds2_beam_lm`` (ds2_small: 3 BiGRU H=800, bf16, head x8) at full
    width from the seeded init on one (32, 1700) batch with W=128 and
    the preset's P=40 capped at V-1 = 28 (the exact search): exactly 3
    ``gru_fwd`` (K4) a forward; ``beam`` on the card
    against the same ``beam_search`` on the CPU on the same log-probs
    (``BEAM_ROWS_CPU`` rows: top-1 identical, scores within
    ``BEAM_SCORE_RTOL``); the sort and match merges agreeing on the card;
    one ``_step`` run twice giving the same bits. With a seeded character
    trigram ARPA written here: ``beam_fused_device`` through the dense
    and the hashed table (the same n-best), and ``beam_fused`` through
    the C++ decoder (``host_impl="native"``, its call counted) equal to
    the Python host decoder on the same log-probs. Then ``aishell``
    (V=4336) at full width through ``beam_fused_device`` with a hashed
    character trigram. Prints ms a batch for the forward, each search
    and the table builds, the search's share of the decode's device
    time and its launches a frame. Returns the K4 launches of the
    counted forwards."""
    from deepspeech_tpu_torch import infer, native
    from deepspeech_tpu_torch.config import apply_overrides
    from deepspeech_tpu_torch.data import CharTokenizer
    from deepspeech_tpu_torch.decode import beam as beam_mod
    from deepspeech_tpu_torch.decode.ngram import NGramLM, fusion_table_for
    from deepspeech_tpu_torch.infer import Inferencer

    report = {"card": card}
    tok = CharTokenizer.english()
    cfg = _config("ds2_beam_lm")
    d = cfg.decode
    _require(cfg.model.rnn_layers == 3 and cfg.model.rnn_hidden == 800
             and d.beam_width == 128 and d.prune_top_k == 40
             and d.mode == "beam", f"ds2_beam_lm: {cfg.model}, {d}")
    params, stats = _beam_weights(cfg)
    feats, lens = _beam_batch(cfg, np.random.default_rng(SEED + 5))
    batch = {"features": feats, "feat_lens": lens}
    feats_t = torch.from_numpy(feats).cuda()
    lens_t = torch.from_numpy(lens).long().cuda()
    inf = Inferencer(cfg, tok, params, stats)
    inf.decode_batch({"features": feats[:2, :400],
                      "feat_lens": np.minimum(lens[:2], 400)})  # warm-up
    torch.cuda.synchronize()
    searches = _Searches(infer.beam_search)
    _zero_counts()
    t0 = time.perf_counter()
    with mock.patch.object(infer, "beam_search", searches):
        texts = inf.decode_batch(batch)
    torch.cuda.synchronize()
    report["beam_decode_ms"] = (time.perf_counter() - t0) * 1e3
    counts = _recurrent_counts()
    want = {k: 3 if k == "gru_fwd" else 0 for k in counts}
    _require(counts == want, f"ds2_beam_lm beam: recurrent launches "
             f"{counts}, want {want}")
    k4 = counts["gru_fwd"]
    _require(len(texts) == 32 and any(texts), f"beam texts {texts[:4]}")
    (lp, out_lens, kw, sort), = searches.calls
    # P is the preset's 40 capped at V-1 = 28: the exact search.
    _require(kw["merge_impl"] == "auto" and kw["beam_width"] == 128
             and kw["prune_top_k"] == cfg.model.vocab_size - 1,
             f"beam: searched with {kw}")
    _require(texts == [tok.decode(p) for p in _top1(*sort[:2])],
             "beam: the texts are not the search's top-1")
    with torch.inference_mode():
        report["forward_ms"] = _time_ms(lambda: inf.forward(feats_t, lens_t),
                                        reps=3)
        frames = lp.shape[1]
        kw = dict(beam_width=d.beam_width, prune_top_k=d.prune_top_k,
                  max_len=cfg.data.max_label_len)
        out = {"sort": sort}

        def search(merge, lm_table=None, rows=slice(None), dev="cuda"):
            return beam_mod.beam_search(
                lp[rows].to(dev), out_lens[rows].to(dev), lm_table=lm_table,
                merge_impl=merge, **kw)

        # The search on the CPU, on the same log-probs, for some rows.
        rows = slice(0, BEAM_ROWS_CPU)
        t0 = time.perf_counter()
        cpu = search("sort", rows=rows, dev="cpu")
        report["beam_cpu_ms_rows"] = (time.perf_counter() - t0) * 1e3
        _require(_top1(*out["sort"][:2])[rows] == _top1(*cpu[:2]),
                 "beam: top-1 on the card differs from the CPU's")
        report["beam_cpu_rel_err"] = _search_rel_err(out["sort"][2][rows],
                                                      cpu[2])
        report["beam_cpu_prefixes_equal"] = bool(
            torch.equal(out["sort"][0][rows].cpu(), cpu[0]))
        _require(report["beam_cpu_rel_err"] <= BEAM_SCORE_RTOL,
                 f"beam: scores on the card vs CPU "
                 f"{report['beam_cpu_rel_err']} > {BEAM_SCORE_RTOL}")
        t0 = time.perf_counter()
        out["match"] = search("match")
        torch.cuda.synchronize()
        report["beam_match_ms"] = (time.perf_counter() - t0) * 1e3
        _require(_top1(*out["match"][:2]) == _top1(*out["sort"][:2]),
                 "beam: the match merge's top-1 differs from the sort's")
        report["match_vs_sort_rel_err"] = _search_rel_err(
            out["match"][2], out["sort"][2])
        report["match_vs_sort_prefixes_equal"] = bool(
            torch.equal(out["match"][0], out["sort"][0]))
        _require(report["match_vs_sort_rel_err"] <= BEAM_SCORE_RTOL,
                 f"beam: match vs sort {report['match_vs_sort_rel_err']}")
        # One step twice on the card: the same bits.
        state = beam_mod.beam_search_chunk(
            beam_mod.beam_init(32, d.beam_width, kw["max_len"],
                               device="cuda"),
            lp[:, :100], torch.arange(100, device="cuda")[None]
            < out_lens[:, None], prune_top_k=d.prune_top_k)
        top_lp, top_v = beam_mod._top(
            lp[:, 100].masked_fill(
                torch.arange(lp.shape[-1], device="cuda") == 0,
                beam_mod.NEG_INF), d.prune_top_k)
        valid = out_lens > 100
        twice = [beam_mod._step(state, lp[:, 100], valid, top_lp, top_v,
                                blank_id=0, merge="sort") for _ in range(2)]
        report["step_same_bits_twice"] = all(
            torch.equal(a, b) for a, b in zip(*twice))
        _require(report["step_same_bits_twice"], "beam: a step's bits differ "
                 "between two runs on the card")
        # Device time and launches a frame of the search, the forward's.
        fwd_busy, _ = _search_profile(
            lambda: inf.forward(feats_t, lens_t), 0)
        sub = slice(0, BEAM_PROFILE_FRAMES)
        busy, launches = _search_profile(
            lambda: beam_mod.beam_search(lp[:, sub], out_lens.clamp(
                max=BEAM_PROFILE_FRAMES), **kw), BEAM_PROFILE_FRAMES)
        search_busy = busy / BEAM_PROFILE_FRAMES * frames
        report.update({
            "frames": frames, "forward_device_ms": fwd_busy,
            "beam_device_ms_est": search_busy,
            "beam_share_of_decode_device_time":
                search_busy / (search_busy + fwd_busy),
            "beam_launches_per_frame": launches / BEAM_PROFILE_FRAMES})

        # LM fusion with a seeded character trigram.
        arpa = os.path.join(root, "en_char.arpa")
        letters = [chr(c) for c in range(ord("a"), ord("z") + 1)]
        _write_char_arpa(arpa, letters, np.random.default_rng(SEED + 6),
                         300, 600)
        t0 = time.perf_counter()
        table = fusion_table_for(
            NGramLM.from_arpa(arpa), lambda i: tok.decode([i]),
            cfg.model.vocab_size, d.lm_alpha, d.lm_beta,
            vocab_has_space=True, impl="dense").to("cuda")
        report["dense_table_build_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        out["dense"] = search("auto", lm_table=table)
        torch.cuda.synchronize()
        report["beam_fused_device_dense_ms"] = (time.perf_counter()
                                                - t0) * 1e3
    # The hashed table through the Inferencer, on the same log-probs.
    fused_cfg = apply_overrides(cfg, {"decode.mode": "beam_fused_device",
                                      "decode.lm_path": arpa,
                                      "decode.device_lm_impl": "hashed"})
    fused = Inferencer(fused_cfg, tok, params, stats)
    t0 = time.perf_counter()
    fused._lm_table()
    report["hashed_table_build_ms"] = (time.perf_counter() - t0) * 1e3
    searches.calls.clear()
    t0 = time.perf_counter()
    with mock.patch.object(infer, "beam_search", searches):
        fused_texts = fused._decode_beam(lp, out_lens,
                                         lm_table=fused._lm_table())
    torch.cuda.synchronize()
    report["beam_fused_device_hashed_ms"] = (time.perf_counter() - t0) * 1e3
    out["hashed"] = searches.calls[0][3]
    _require(fused_texts == [tok.decode(p) for p in
                             _top1(*out["hashed"][:2])],
             "beam_fused_device: the texts are not the search's top-1")
    with torch.inference_mode():
        _require(_top1(*out["dense"][:2]) == _top1(*out["hashed"][:2]),
                 "beam_fused_device: the dense and hashed tables' top-1 "
                 "differ")
        report["dense_vs_hashed_rel_err"] = _search_rel_err(
            out["hashed"][2], out["dense"][2])
        report["dense_vs_hashed_prefixes_equal"] = bool(
            torch.equal(out["hashed"][0], out["dense"][0]))
        _require(report["dense_vs_hashed_rel_err"] <= BEAM_SCORE_RTOL,
                 f"dense vs hashed {report['dense_vs_hashed_rel_err']}")
        _require(_top1(*out["dense"][:2]) != _top1(*out["sort"][:2]),
                 "beam_fused_device: the LM moved no transcript")
    nb = fused._last_nbest
    # beam_fused on the C++ decoder against the Python one on the same
    # log-probs.
    host_cfg = apply_overrides(cfg, {"decode.mode": "beam_fused",
                                     "decode.lm_path": arpa,
                                     "decode.host_impl": "native"})
    host = Inferencer(host_cfg, tok, params, stats)
    _require(isinstance(host._native_lm, native.NativeNGram),
             "beam_fused: the C++ LM did not load")
    calls = native.beam_search_batch_native.calls
    t0 = time.perf_counter()
    native_texts = host._decode_beam_fused(lp, out_lens)
    report["beam_fused_native_ms"] = (time.perf_counter() - t0) * 1e3
    _require(native.beam_search_batch_native.calls == calls + 1,
             "beam_fused: the C++ search did not run")
    native_nb = host._last_nbest
    py_cfg = apply_overrides(host_cfg, {"decode.host_impl": "python"})
    py = Inferencer(py_cfg, tok, params, stats)
    rows = slice(0, BEAM_HOST_ROWS)
    t0 = time.perf_counter()
    py_texts = py._decode_beam_fused(lp[rows], out_lens[rows])
    report["beam_fused_python_ms_rows"] = (time.perf_counter() - t0) * 1e3
    _require(py_texts == native_texts[rows],
             f"beam_fused: C++ {native_texts[rows]} != Python {py_texts}")
    err = max(abs(a[1] - b[1]) for x, y in zip(native_nb, py._last_nbest)
              for a, b in zip(x, y))
    _require([[t for t, _ in x] for x in native_nb[rows]]
             == [[t for t, _ in x] for x in py._last_nbest] and err <= 1e-3,
             f"beam_fused: the C++ n-best differs from Python's ({err})")
    report["beam_fused_native_vs_python_max_abs_err"] = err
    report["nbest_deep"] = len(nb[0])

    # aishell (V=4336) at full width: a hashed character trigram.
    zh_cfg = _config("aishell")
    zh_tok = CharTokenizer.synthetic_zh(zh_cfg.model.vocab_size - 1)
    zh_arpa = os.path.join(root, "zh_char.arpa")
    t0 = time.perf_counter()
    _write_char_arpa(zh_arpa, zh_tok.chars[:2000],
                     np.random.default_rng(SEED + 7), 20000, 20000)
    zh_cfg = apply_overrides(zh_cfg, {"decode.mode": "beam_fused_device",
                                      "decode.lm_path": zh_arpa})
    zh_params, zh_stats = _beam_weights(zh_cfg)
    zh = Inferencer(zh_cfg, zh_tok, zh_params, zh_stats)
    table = zh._lm_table()
    report["aishell_table_build_ms"] = (time.perf_counter() - t0) * 1e3
    _require(type(table).__name__ == "HashedFusionTable" and table.k == 2,
             f"aishell: table {type(table).__name__}")
    report["aishell_table_bytes"] = table.nbytes()
    zh.decode_batch({"features": feats[:2, :400],
                     "feat_lens": np.minimum(lens[:2], 400)})  # warm-up
    torch.cuda.synchronize()
    searches.calls.clear()
    _zero_counts()
    t0 = time.perf_counter()
    with mock.patch.object(infer, "beam_search", searches):
        zh_texts = zh.decode_batch(batch)
    torch.cuda.synchronize()
    report["aishell_decode_ms"] = (time.perf_counter() - t0) * 1e3
    _require(_recurrent_counts()["gru_fwd"] == 3, "aishell: launches")
    k4 += 3
    (zlp, _, zkw, zout), = searches.calls
    _require(zkw["lm_table"] is table and zlp.shape[-1] == 4336
             and bool(torch.isfinite(zlp).all()), "aishell: the search")
    _require(len(zh_texts) == 32 and any(zh_texts)
             and zh_texts == [zh_tok.decode(p) for p in _top1(*zout[:2])],
             "aishell: the texts are not the search's top-1")
    report["aishell_beam_width"] = zh_cfg.decode.beam_width
    print(json.dumps({"beam": report}), flush=True)
    return k4


def beam_stream_phase(root: str, card: str):
    """``ds2_streaming`` (5 GRU layers H=800, ``_stream_weights``) on 8
    seeded WAVs, bf16 and int8: ``StreamingBeamDecoder`` over the
    chunks of ``StreamingTranscriber`` equal bit for bit to one offline
    ``beam_search`` over the log-softmax of the concatenated logits; a
    ``decode="beam"`` ``StreamingSessionManager`` whose finals equal
    that decoder's top-1 and whose four sessions exported after 5 chunks
    into a second manager (capacity 8 both) end with the never-migrated
    n-best, texts and scores, bit for bit (bf16); exactly 5 ``gru_fwd``
    (K6; int8: ``gru_fwd_q``, K10) a manager step. In f32, ``serve
    --decode=beam``'s finals must equal ``Inferencer(decode.mode=
    "beam")``'s offline transcripts of the same audio; in bf16 the
    count of equal ones is printed, and ``--quant-tier=premium``'s lines
    must equal ``--decode=beam``'s. Prints the wall ms of a manager step
    in beam and greedy at capacities 1 and 32. Returns the K6 and K10
    launches of the counted runs."""
    import io

    from deepspeech_tpu_torch import bridge, serve
    from deepspeech_tpu_torch.config import apply_overrides
    from deepspeech_tpu_torch.data import (CharTokenizer, featurize_np,
                                           load_audio)
    from deepspeech_tpu_torch.decode import beam as beam_mod
    from deepspeech_tpu_torch.infer import Inferencer
    from deepspeech_tpu_torch.serving.session import StreamingSessionManager
    from deepspeech_tpu_torch.streaming import (StreamingBeamDecoder,
                                                StreamingTranscriber)

    tok = CharTokenizer.english()
    base = _config("ds2_streaming")
    rng = np.random.default_rng(SEED + 4)
    paths = []
    for i in range(8):
        n = int(rng.integers(1, 4))
        secs = rng.uniform(0.8, 2.2, size=n)
        secs *= min(1.0, (8.0 - (n - 1)) / secs.sum())
        paths.append(os.path.join(root, f"beam{i}.wav"))
        _write_speech(paths[-1], secs, rng)
    feats = [featurize_np(load_audio(p, 16000), base.features) for p in paths]
    lens = np.asarray([len(x) for x in feats], np.int64)
    k = STREAM_CHUNK
    t = int(lens.max()) + (-int(lens.max())) % k
    nf = base.features.num_features
    batch = np.zeros((8, t, nf), np.float32)
    for i, x in enumerate(feats):
        batch[i, :len(x)] = x
    launches = {"gru_fwd": 0, "gru_fwd_q": 0}
    report = {"card": card, "streams": 8, "frames": lens.tolist()}
    steps = [0]
    real_step = StreamingSessionManager.step

    def counted_step(self, chunks=None):
        steps[0] += 1
        return real_step(self, chunks)

    for quantize, kernel in (("", "gru_fwd"), ("int8", "gru_fwd_q")):
        name = quantize or "bf16"
        cfg = base
        params, stats = _stream_weights(cfg)
        d = cfg.decode
        st = StreamingTranscriber(cfg, params, stats, tok, chunk_frames=k,
                                  quantize=quantize)
        bd = StreamingBeamDecoder(beam_width=d.beam_width,
                                  max_len=cfg.data.max_label_len,
                                  prune_top_k=d.prune_top_k,
                                  merge_impl=d.merge_impl)
        state = dataclasses.replace(st.init_state(8), raw_len=torch.as_tensor(
            lens, device="cuda"))
        bstate = bd.init(8)
        rows, valids = [], []
        with torch.inference_mode():
            for i in range(t // k):
                state, lo, va = st.process_chunk(state,
                                                 batch[:, i * k:(i + 1) * k])
                bstate = bd.advance(bstate, lo, va)
                rows.append(lo)
                valids.append(va)
            state, lo, va = st.finish(state, lens)
            bstate = bd.advance(bstate, lo, va)
            rows.append(lo)
            valids.append(va)
            lo, va = torch.cat(rows, 1), torch.cat(valids, 1)
            n = va.sum(1)
            packed = torch.zeros((8, int(n.max()), lo.shape[-1]),
                                 device="cuda")
            for i in range(8):
                packed[i, :n[i]] = lo[i][va[i]]
            off = beam_mod.beam_search(
                torch.log_softmax(packed, -1), n, beam_width=d.beam_width,
                prune_top_k=d.prune_top_k, max_len=cfg.data.max_label_len,
                merge_impl=d.merge_impl)
            got = bd.result(bstate)
        same = all(torch.equal(a, b) for a, b in zip(got, off))
        report[f"{name}_chunked_equals_offline_bits"] = same
        _require(same, f"beam stream {name}: chunked differs from offline")
        top1 = [tok.decode(p) for p in _top1(*got[:2])]
        _require(any(top1), f"beam stream {name}: every transcript empty")

        def manager(capacity=8):
            return StreamingSessionManager(
                cfg, params, stats, tok, chunk_frames=k, decode="beam",
                quantize=quantize, capacity=capacity)

        def run(migrate_at=None):
            src, dst = manager(), manager()
            homes = {str(s): src for s in range(8)}
            for s in range(8):
                src.join(str(s), raw_len=int(lens[s]))
            for i in range(t // k):
                if i == migrate_at:
                    for s in range(4):
                        dst.import_session(src.export_session(str(s)))
                        homes[str(s)] = dst
                for m in (src, dst):
                    feed = {sid: batch[int(sid), i * k:(i + 1) * k]
                            for sid, h in homes.items() if h is m}
                    if feed:
                        m.step(feed)
            for sid, m in homes.items():
                m.leave(sid)
            src.flush()
            dst.flush()
            return ([homes[str(s)].final(str(s)) for s in range(8)],
                    [homes[str(s)].final_nbest(str(s)) for s in range(8)])

        torch.cuda.synchronize()
        _zero_counts()
        steps[0] = 0
        with mock.patch.object(StreamingSessionManager, "step",
                               counted_step):
            finals, nbest = run()
            if not quantize:
                finals_mig, nbest_mig = run(migrate_at=5)
                _require(nbest_mig == nbest, f"beam stream {name}: "
                         "migrated sessions did not continue "
                         "bit-identically")
                report[f"{name}_migrated_nbest_bit_identical"] = True
        counts = _recurrent_counts()
        _require(counts[kernel] == 5 * steps[0] and steps[0] > 0
                 and sum(counts.values()) == counts[kernel],
                 f"beam stream {name}: launches {counts} for {steps[0]} "
                 "manager steps (want 5 a step)")
        launches[kernel] += counts[kernel]
        _require(finals == top1, f"beam stream {name}: the manager's finals "
                 f"{finals} differ from the decoder's {top1}")
        report[f"{name}_manager_steps"] = steps[0]
        report[f"{name}_launches"] = counts[kernel]
        report[f"{name}_finals_equal_decoder"] = True
        del st

    # serve --decode=beam against the offline beam of decode.mode: in
    # f32 through serve_files, in bf16 (the preset's) through the CLI,
    # --decode=beam and --quant-tier=premium.
    for dtype in ("float32", "bfloat16"):
        cfg = apply_overrides(base, {"model.dtype": dtype})
        params, stats = _stream_weights(cfg)
        if dtype == "float32":
            finals = serve.serve_files(cfg, tok, params, stats, paths,
                                       out=io.StringIO(), decode="beam")
        else:
            npz = os.path.join(root, "stream.npz")
            bridge.save_npz(npz, params, stats)
            lines = {}
            for flag in ("--decode=beam", "--quant-tier=premium"):
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    serve.main([flag, f"--params={npz}", *paths])
                lines[flag] = [{k2: v for k2, v in json.loads(x).items()
                                if k2 != "ms"}
                               for x in buf.getvalue().splitlines()]
            _require(lines["--decode=beam"] == lines["--quant-tier=premium"],
                     "serve --quant-tier=premium differs from --decode=beam")
            finals = lines["--decode=beam"][-1]["final"]
        inf = Inferencer(apply_overrides(cfg, {"decode.mode": "beam"}), tok,
                         params, stats)
        texts = inf.decode_batch({"features": batch, "feat_lens": lens})
        equal = sum(a == b for a, b in zip(finals, texts))
        report[f"serve_beam_{dtype}_finals_equal_offline"] = equal
        _require(dtype != "float32" or equal == 8,
                 f"serve --decode=beam f32 finals {finals} != offline beam "
                 f"{texts}")
        _require(any(finals), f"serve --decode=beam {dtype}: finals empty")

    # Wall ms a manager step, beam and greedy, at capacity 1 and 32.
    cfg = base
    params, stats = _stream_weights(cfg)
    x = np.random.default_rng(SEED + 8).normal(size=(32, k, nf)).astype(
        np.float32)
    for decode in ("beam", "greedy"):
        for cap in (1, 32):
            mgr = StreamingSessionManager(cfg, params, stats, tok,
                                          chunk_frames=k, decode=decode,
                                          capacity=cap)
            feed = {str(i): x[i] for i in range(cap)}
            for sid in feed:
                mgr.join(sid)
            for _ in range(3):
                mgr.step(feed)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(8):
                mgr.step(feed)
            torch.cuda.synchronize()
            report[f"step_wall_ms_{decode}_cap{cap}"] = (
                (time.perf_counter() - t0) * 1e3 / 8)
            del mgr
    print(json.dumps({"beam_stream": report}), flush=True)
    return launches


RESCORE_REQUESTS = 32        # requests of each n-best gateway run
RESCORE_FRAMES = (300, 900)  # their lengths: the beam is host-bound
CTRL_DRAIN_S = 0.0           # the controllers' drain window, clock s
CTRL_COOLDOWN_S = 0.0        # the autoscaler's cooldown between episodes
STATUS_TIMEOUT_S = 10.0      # one GET of the status server


class _CountClock:
    """The controllers' clock: each read advances it 0.01 s, so every
    hold, cooldown and drain window falls on the same read whatever the
    wall time of a chunk on the card."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        self.t += 0.01
        return self.t


def _live_bytes() -> int:
    """The card's allocated bytes once garbage is collected, the queues
    drained and cuBLAS's workspaces freed: PyTorch keeps one (32 MiB) a
    cuBLAS handle and stream, and the gateway's worker threads and the
    replicas' streams meet in new pairs as traffic goes on."""
    gc.collect()
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    return torch.cuda.memory_allocated()


def _lm_text(text: str) -> str:
    """A transcript as the character trigram's words."""
    return " ".join(text)


def _nbest_gateway(name, inf, reqs, nbest: bool, rescorer=None):
    """``reqs`` through a ``MicroBatchScheduler`` over one
    ``Replica.from_inferencer(inf, nbest=nbest)`` with ``rescorer``
    pumped after every ``dispatch_many``, under the watchdog. Returns
    the results, the revisions, the replica's decoded micro-batches
    (batch, plan, backend result), its recurrent launches, the dispatch
    p50/p95 ms, the pump's (ms, jobs) beats and the rids in the order
    they were offered."""
    from deepspeech_tpu_torch.obs.metrics import _labeled
    from deepspeech_tpu_torch.serving import (MicroBatchScheduler, Replica,
                                              ReplicaPool, ServingTelemetry)

    tel = ServingTelemetry()
    rep = Replica.from_inferencer("r0", inf, nbest=nbest, telemetry=tel)
    batches = []
    decode = rep.decode_fn

    def recording(batch, plan):
        out = decode(batch, plan)
        batches.append((batch, plan, out))
        return out

    rep.decode_fn = recording
    sched = MicroBatchScheduler(
        inf.cfg.data.bucket_frames, GATEWAY_MAX_BATCH,
        max_queue=4 * len(reqs), default_deadline=60.0,
        default_timeout=None, pool=ReplicaPool([rep], telemetry=tel),
        telemetry=tel, rescorer=rescorer)
    revisions, beats, offered = [], [], []
    if rescorer is not None:
        real_offer = rescorer.offer

        def offer(rid, *a, **kw):
            offered.append(rid)
            return real_offer(rid, *a, **kw)

        rescorer.offer = offer
    torch.cuda.synchronize()
    _zero_counts()
    with _watchdog(f"n-best gateway {name}", GATEWAY_WATCHDOG_S):
        for k, x in enumerate(reqs):
            sched.submit(x, rid=f"{name}{k}")
        while sched.pending:
            sched.dispatch_many(sched.poll() or sched.flush_all())
            if rescorer is not None and rescorer.depth:
                jobs = rescorer.depth
                t0 = time.perf_counter()
                revisions += rescorer.pump()
                beats.append(((time.perf_counter() - t0) * 1e3, jobs))
        torch.cuda.synchronize()
    counts = _recurrent_counts()
    _require(counts == {**{k: 0 for k in counts},
                        "gru_fwd": 3 * len(batches)} and batches,
             f"n-best gateway {name}: recurrent launches {counts} for "
             f"{len(batches)} micro-batches (want 3 gru_fwd each)")
    results = sched.results
    _require(len(results) == len(reqs)
             and all(r.status == "ok" for r in results.values()),
             f"n-best gateway {name}: results "
             f"{sorted({r.status for r in results.values()})}")
    hist = tel.hists[_labeled("gateway.dispatch_s", rep.labels)]
    return {"results": results, "revisions": revisions,
            "offered": offered, "batches": batches,
            "gru_fwd": counts["gru_fwd"],
            "dispatch_ms_p50": hist.percentile(50) * 1e3,
            "dispatch_ms_p95": hist.percentile(95) * 1e3, "beats": beats}


def rescore_phase(root: str, card: str):
    """``ds2_beam_lm`` (ds2_small: 3 BiGRU H=800, bf16, head x8, W=128,
    n-best 8) at full width behind the gateway with n-best, and the
    asynchronous LM second pass over the seeded character trigram of
    the beam phase. 32 requests of ``RESCORE_FRAMES`` go through a
    ``MicroBatchScheduler`` over ``Replica.from_inferencer`` twice:
    without n-best (the baseline), then with ``nbest=True`` and
    ``rescorer=RescoringPool(...)`` pumped after every dispatch. The
    texts must equal the baseline's; each micro-batch's n-best must equal
    ``decode_batch_nbest`` on the same batch (texts, scores within
    ``BEAM_SCORE_RTOL``); each request's revision, or none, must be host
    ``rescore_nbest``'s pick over its n-best; a replay of the same offers
    on the same beats into a fresh pool must give the same revision
    stream (every field but the wall-clock latency); with a
    ``BrownoutController`` whose rescore rung has fired, the same 32
    offers must all shed as ``brownout``, counted. Each run: exactly 3
    ``gru_fwd`` (K4) a micro-batch. Prints the dispatch p50/p95 with
    and without the n-best and the rescorer, and the pump's ms a job.
    Returns the K4 launches of the gateway runs."""
    from deepspeech_tpu_torch.data import CharTokenizer
    from deepspeech_tpu_torch.data.infer_bucket import slice_to_plan
    from deepspeech_tpu_torch.decode.ngram import load_lm, rescore_nbest
    from deepspeech_tpu_torch.infer import Inferencer
    from deepspeech_tpu_torch.resilience import BrownoutController
    from deepspeech_tpu_torch.serving import RescoringPool

    cfg = _config("ds2_beam_lm")
    d = cfg.decode
    _require(d.mode == "beam" and d.beam_width == 128 and d.nbest == 8,
             f"ds2_beam_lm decode: {d}")
    params, stats = _beam_weights(cfg)
    tok = CharTokenizer.english()
    arpa = os.path.join(root, "rescore_char.arpa")
    _write_char_arpa(arpa, tok.chars, np.random.default_rng(SEED + 6), 300,
                     600)
    lm = load_lm(arpa)
    rng = np.random.default_rng(SEED + 8)
    f = cfg.features.num_features
    reqs = [rng.normal(size=(int(t), f)).astype(np.float32)
            for t in rng.integers(RESCORE_FRAMES[0], RESCORE_FRAMES[1] + 1,
                                  size=RESCORE_REQUESTS)]
    inf = Inferencer(cfg, tok, params, stats)
    inf.decode_batch({"features": reqs[0][None, :400],
                      "feat_lens": np.asarray([400], np.int32)})  # warm-up

    def pool(**kw):
        return RescoringPool(lm=lm, alpha=d.lm_alpha, beta=d.lm_beta,
                             to_lm_text=_lm_text, **kw)

    plain = _nbest_gateway("p", inf, reqs, nbest=False)
    first_pool = pool()
    run = _nbest_gateway("p", inf, reqs, nbest=True, rescorer=first_pool)
    texts = {rid: r.text for rid, r in plain["results"].items()}
    _require({rid: r.text for rid, r in run["results"].items()} == texts,
             "n-best gateway: texts differ from the nbest=False gateway's")
    _require(any(texts.values()), "n-best gateway: every text is empty")
    worst = 0.0
    for batch, plan, (b_texts, b_nbest) in run["batches"]:
        # The plan's rows of the padded sub-batch, in request order.
        rows = inf.decode_batch_nbest(slice_to_plan(batch, plan))
        again = [None] * len(b_nbest)
        for i, idx in enumerate(plan.indices):
            again[int(idx)] = rows[i]
        _require([[t for t, _ in row] for row in again]
                 == [[t for t, _ in row] for row in b_nbest]
                 and [row[0][0] for row in b_nbest] == list(b_texts),
                 "n-best gateway: a micro-batch's n-best differs from "
                 "decode_batch_nbest on the same batch")
        for row, ref in zip(b_nbest, again):
            for (_, s), (_, r) in zip(row, ref):
                worst = max(worst, abs(s - r) / max(1.0, abs(r)))
    _require(worst <= BEAM_SCORE_RTOL, f"n-best gateway: n-best scores "
             f"off decode_batch_nbest's by {worst} (relative)")
    revised = {e.rid: e for e in run["revisions"]}
    _require(len(revised) == len(run["revisions"]),
             "n-best gateway: a request was revised twice")
    for rid, r in run["results"].items():
        _require(r.nbest and r.nbest[0][0] == r.text
                 and len(r.nbest) <= d.nbest,
                 f"n-best gateway: {rid}'s n-best {r.nbest}")
        pick = rescore_nbest(r.nbest, lm, d.lm_alpha, d.lm_beta,
                             to_lm_text=_lm_text)[0][0]
        if pick == r.text:
            _require(rid not in revised, f"{rid} revised to "
                     f"{revised.get(rid)} though the LM keeps its text")
        else:
            _require(rid in revised and revised[rid].new_text == pick
                     and revised[rid].old_text == r.text,
                     f"{rid}: revision {revised.get(rid)} != host pick "
                     f"{pick!r}")
    st = first_pool.stats()
    _require(st["submitted"] == st["completed"] == RESCORE_REQUESTS
             and st["revised"] == len(revised) and not st["shed"],
             f"rescoring pool: {st}")
    # The replay: the same offers, in the order the gateway made them,
    # on the same beats, into a fresh pool.
    offers = [(rid, run["results"][rid]) for rid in run["offered"]]
    replay, at = pool(), 0
    replayed = []
    for _, jobs in run["beats"]:
        for rid, r in offers[at:at + jobs]:
            replay.offer(rid, r.nbest, r.text)
        at += jobs
        replayed += replay.pump()

    def stream(evs):
        return [(e.rid, e.old_text, e.new_text, e.score_delta, e.worker)
                for e in evs]

    _require(at == len(offers) == RESCORE_REQUESTS
             and stream(replayed) == stream(run["revisions"]),
             "rescoring: the replay's revision stream differs")
    bro = BrownoutController(enter_pressure=0.75, exit_pressure=0.0,
                             shed_pressure=0.9, hold_s=0.0,
                             rescore_pressure=0.4)
    bro.update(0.5)
    _require(bro.level == 0 and not bro.should_rescore(),
             f"brownout: level {bro.level}, should_rescore "
             f"{bro.should_rescore()}")
    shed_pool = pool(brownout=bro)
    for rid, r in offers:
        shed_pool.offer(rid, r.nbest, r.text)
    counted = shed_pool.telemetry.counter("rescore_shed",
                                          {"reason": "brownout"})
    _require(shed_pool.shed == {"brownout": RESCORE_REQUESTS}
             and counted == RESCORE_REQUESTS and shed_pool.submitted == 0
             and not shed_pool.pump(),
             f"brownout rung: sheds {shed_pool.shed}, counted {counted}")
    jobs = sum(n for _, n in run["beats"])
    report = {
        "preset": "ds2_beam_lm", "requests": RESCORE_REQUESTS,
        "micro_batches": len(run["batches"]),
        "gru_fwd_per_micro_batch": run["gru_fwd"] / len(run["batches"]),
        "revised": len(revised), "nbest_depth_max": max(
            len(r.nbest) for r in run["results"].values()),
        "nbest_score_rel_err_max": worst,
        "dispatch_ms_p50_plain": plain["dispatch_ms_p50"],
        "dispatch_ms_p95_plain": plain["dispatch_ms_p95"],
        "dispatch_ms_p50_nbest_rescorer": run["dispatch_ms_p50"],
        "dispatch_ms_p95_nbest_rescorer": run["dispatch_ms_p95"],
        "pump_ms_per_job": sum(ms for ms, _ in run["beats"]) / jobs,
        "pump_beats": len(run["beats"]), "replay_identical": True,
        "brownout_sheds": RESCORE_REQUESTS}
    print(card, flush=True)
    print(json.dumps({"rescore": report, "card": card}), flush=True)
    return plain["gru_fwd"] + run["gru_fwd"]


def _forced_burn():
    """A pool registry whose ``slo_burn_rate`` reads 2 (over a budget
    of 1) until the first horizontal scale-up, 0 until the first
    scale-down, then 0.5 (inside the hysteresis band): one episode each
    way, whatever the wall time of a chunk."""
    from deepspeech_tpu_torch.serving import ServingTelemetry

    class ForcedBurn(ServingTelemetry):
        def __init__(self):
            super().__init__()
            self.episodes = []
            self.gauge("slo_burn_rate", 2.0, labels={"window": "5m"})

        def count(self, name, n=1, labels=None, **kw):
            super().count(name, n, labels=labels, **kw)
            if name == "autoscale_events" and labels \
                    and labels.get("actuator") == "horizontal":
                self.episodes.append(labels["direction"])
                self.gauge("slo_burn_rate",
                           0.0 if labels["direction"] == "up" else 0.5,
                           labels={"window": "5m"})

    return ForcedBurn()


def _tier_mix_gateway(card: str):
    """ds2_small behind a premium bf16 + bulk int8 gateway (as in
    ``gateway_phase``'s round B) with an ``AutoscaleController`` whose
    vertical rungs are engaged by forced queue pressure (16 premium requests queued against
    a capacity of 20): first the ladder, then the premium->bulk tier
    mix. The queued 16 decode on the premium replica (``gru_fwd``, K4);
    the 8 premium requests submitted after them must ride the bulk
    replica (``gru_fwd_q``, K10, 3 a micro-batch), their texts equal to
    the bulk inferencer's serial decode of the same micro-batches.
    Returns the report and the K4 and K10 launches."""
    from deepspeech_tpu_torch.data import CharTokenizer
    from deepspeech_tpu_torch.infer import Inferencer
    from deepspeech_tpu_torch.serving import (AutoscaleController,
                                              MicroBatchScheduler, Replica,
                                              ReplicaPool, ServingTelemetry)

    cfg = _config("ds2_small")
    params, stats = _weights("ds2_small")
    tok = CharTokenizer.english()
    clock = [0.0]
    tel = ServingTelemetry()
    reps = [Replica.from_inferencer(
        "p0", Inferencer(cfg, tok, params, stats), tier="premium",
        telemetry=tel, clock=lambda: clock[0]),
        Replica.from_inferencer(
            "b0", Inferencer(cfg, tok, params, stats, quantize="int8"),
            tier="bulk", telemetry=tel, clock=lambda: clock[0])]
    log = {}
    for rep in reps:
        _recording_replica(rep, log)
    pool = ReplicaPool(reps, telemetry=tel, clock=lambda: clock[0])
    sched = MicroBatchScheduler(
        cfg.data.bucket_frames, 4, max_queue=20, default_deadline=60.0,
        default_timeout=None, pool=pool, telemetry=tel,
        tier_max_batch={"bulk": 4}, clock=lambda: clock[0])
    ctrl = AutoscaleController(
        pool, lambda rid: None, scheduler=sched, min_replicas=2,
        max_replicas=2, vertical_max_batch=GATEWAY_MAX_BATCH,
        vertical_tier_max_batch={"bulk": GATEWAY_MAX_BATCH},
        tier_shift={"premium": "bulk"}, vertical_hold_s=0.0,
        vertical_cooldown_s=0.5, telemetry=tel, clock=lambda: clock[0],
        postmortem_fn=lambda *a, **kw: None)
    rng = np.random.default_rng(SEED + 9)
    f = cfg.features.num_features

    def submit(prefix, n):
        for k in range(n):
            x = rng.normal(size=(int(rng.integers(300, 1701)), f))
            sched.submit(x.astype(np.float32), rid=f"{prefix}{k}",
                         tier="premium")

    torch.cuda.synchronize()
    _zero_counts()
    with _watchdog("tier-mix gateway", GATEWAY_WATCHDOG_S):
        submit("q", 16)
        for t in (0.0, 1.0):
            clock[0] = t
            ctrl.tick()
        _require([e["actuator"] for e in ctrl.events
                  if e["action"] == "vertical_up"] == ["ladder", "tier_mix"]
                 and sched.max_batch == GATEWAY_MAX_BATCH
                 and sched.tier_shift == {"premium": "bulk"},
                 f"tier mix: controller events {ctrl.events}")
        for prefix in ("", "s"):
            if prefix:
                submit(prefix, 8)
            while sched.pending:
                sched.dispatch_many(sched.poll() or sched.flush_all())
        torch.cuda.synchronize()
    counts = _recurrent_counts()
    shifted = int(tel.counter("tier_shifted", {"tier": "premium"}))
    results = sched.results
    _require(shifted == 8 and len(results) == 24
             and all(r.status == "ok" for r in results.values()),
             f"tier mix: {shifted} shifted, results "
             f"{sorted({r.status for r in results.values()})}")
    bulk = log["b0"]["batches"]
    want = {"gru_fwd": 3 * len(log["p0"]["batches"]),
            "gru_fwd_q": 3 * len(bulk)}
    _require(bulk and counts == {**{k: 0 for k in counts}, **want},
             f"tier mix: recurrent launches {counts}, want {want}")
    b0 = reps[1]
    for batch, p, texts in bulk:
        again = b0.inferencer.decode_batch_bucketed(batch, plans=[p])
        _require(again == texts, f"tier mix: the bulk replica's serial "
                 f"re-decode {again} != {texts}")
    rows = sum(p.n_valid for _, p, _ in bulk)
    _require(rows == 8, f"tier mix: the bulk replica decoded {rows} rows "
             "(want the 8 shifted premium requests)")
    return {"shifted_premium": shifted, "bulk_micro_batches": len(bulk),
            "premium_micro_batches": len(log["p0"]["batches"]),
            "vertical": [e["actuator"] for e in ctrl.events
                         if e["action"] == "vertical_up"]}, want


ROLLOUT_WAVES = 6            # waves of the gateway rollout's traffic
ROLLOUT_WAVE = 8             # requests a wave: two micro-batches of 4


def _gateway_rollout(card: str):
    """ds2_small behind a gateway of two bf16 replicas bound to
    ``Inferencer``s (``Replica.from_inferencer``: each decodes on a CUDA
    stream of its own), rolled to new ``Inferencer``s of the same
    weights while traffic arrives: ``ROLLOUT_WAVES`` waves of
    ``ROLLOUT_WAVE`` requests, a ``RolloutController`` (drain window 0,
    the first micro-batch as its canary) ticked after each wave, so that
    each victim parks between waves, and its ``swap_backend``
    synchronizes the victim's stream and drops the old ``Inferencer``
    while the other replica serves. The rollout must reach ``done`` with
    both replicas on v2 and each canary identical; every request ok and
    each micro-batch's texts equal to a serial re-decode on a fresh
    ``Inferencer``; exactly 3 ``gru_fwd`` (K4) a forward; device memory
    after the rollout within one ``Inferencer``'s weights of where it was
    before it. Returns the report and the K4 launches."""
    from deepspeech_tpu_torch.data import CharTokenizer
    from deepspeech_tpu_torch.infer import Inferencer
    from deepspeech_tpu_torch.serving import (MicroBatchScheduler, Replica,
                                              ReplicaPool, RolloutController,
                                              ServingTelemetry)

    cfg = _config("ds2_small")
    params, stats = _weights("ds2_small")
    tok = CharTokenizer.english()
    m0 = _live_bytes()
    probe = Inferencer(cfg, tok, params, stats)
    version_bytes = _live_bytes() - m0
    del probe
    clock = [0.0]
    tel = ServingTelemetry()
    log = []

    def logged(decode):
        def fn(batch, plan):
            texts = decode(batch, plan)
            log.append((batch, plan, texts))
            return texts
        return fn

    def backend(rid, inf):
        rep = Replica.from_inferencer(rid, inf, telemetry=tel,
                                      clock=lambda: clock[0])
        rep.decode_fn = logged(rep.decode_fn)
        rep.version = "v1"
        return rep

    reps = [backend(f"g{i}", Inferencer(cfg, tok, params, stats))
            for i in range(2)]
    old_infs = [weakref.ref(r.inferencer) for r in reps]
    pool = ReplicaPool(reps, telemetry=tel, clock=lambda: clock[0],
                       drain_window_s=0.0)
    sched = MicroBatchScheduler(
        cfg.data.bucket_frames, 4, max_queue=4 * ROLLOUT_WAVE,
        default_deadline=60.0, default_timeout=None, pool=pool,
        telemetry=tel, clock=lambda: clock[0])
    swap_ms, backend_ms, forwards = [], [], [0]
    real_swap_backend = Replica.swap_backend
    real_decode = Inferencer.decode_batch_bucketed

    def factory(rep):
        t0 = time.perf_counter()
        new = Replica.from_inferencer(
            "candidate", Inferencer(cfg, tok, params, stats))
        torch.cuda.synchronize()
        swap_ms.append((time.perf_counter() - t0) * 1e3)
        return {"decode_fn": logged(new.decode_fn),
                "inferencer": new.inferencer}

    def timed_swap_backend(self, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real_swap_backend(self, **kw)
        torch.cuda.synchronize()
        backend_ms.append((time.perf_counter() - t0) * 1e3)

    def counted_decode(self, *a, **kw):
        forwards[0] += 1
        return real_decode(self, *a, **kw)

    rng = np.random.default_rng(SEED + 10)
    f = cfg.features.num_features
    ro = None
    torch.cuda.synchronize()
    _zero_counts()
    with _watchdog("gateway rollout", GATEWAY_WATCHDOG_S), \
            mock.patch.object(Replica, "swap_backend", timed_swap_backend), \
            mock.patch.object(Inferencer, "decode_batch_bucketed",
                              counted_decode):
        for wave in range(ROLLOUT_WAVES):
            clock[0] = float(wave)
            for k in range(ROLLOUT_WAVE):
                x = rng.normal(size=(int(rng.integers(300, 1001)), f))
                sched.submit(x.astype(np.float32), rid=f"w{wave}r{k}")
            while sched.pending:
                sched.dispatch_many(sched.poll() or sched.flush_all())
            if ro is None:
                before = _live_bytes()
                ro = RolloutController(
                    pool, factory, to_version="v2",
                    canary_set=[log[0][:2]], wer_guardrail=0.0,
                    telemetry=tel, clock=lambda: clock[0],
                    postmortem_fn=lambda *a, **kw: None)
                ro.start()
            ro.tick()
        torch.cuda.synchronize()
    counts = _recurrent_counts()
    acts = [e["action"] for e in ro.events]
    _require(ro.state == "done" and acts.count("swap") == 2
             and all(e["wer_delta"] == 0.0 for e in ro.events
                     if e["action"] == "swap")
             and [r.version for r in reps] == ["v2", "v2"],
             f"gateway rollout: {ro.events}")
    results = sched.results
    _require(len(results) == ROLLOUT_WAVES * ROLLOUT_WAVE
             and all(r.status == "ok" for r in results.values()),
             f"gateway rollout: results "
             f"{sorted({r.status for r in results.values()})}")
    _require(counts == {**{k: 0 for k in counts},
                        "gru_fwd": 3 * forwards[0]} and forwards[0],
             f"gateway rollout: recurrent launches {counts} for "
             f"{forwards[0]} forwards (want 3 gru_fwd each)")
    grown = _live_bytes() - before
    _require(grown <= version_bytes and not any(r() for r in old_infs),
             f"gateway rollout: {grown} bytes more than before it (one "
             f"Inferencer: {version_bytes}); old Inferencers alive: "
             f"{[r() is not None for r in old_infs]}")
    ref = Inferencer(cfg, tok, params, stats)
    for batch, plan, texts in log:
        again = ref.decode_batch_bucketed(batch, plans=[plan])
        _require(again == texts, f"gateway rollout: a serial re-decode "
                 f"{again} != {texts}")
    return {"actions": acts, "decodes": len(log),
            "forwards": forwards[0], "swap_build_ms": swap_ms,
            "swap_backend_ms": backend_ms, "version_bytes": version_bytes,
            "bytes_after_minus_before": grown}, counts["gru_fwd"]


def controllers_phase(root: str, card: str):
    """The serving plane's controllers on ds2_streaming (5 GRU layers,
    H=800, bf16, ``_stream_weights``) at full width over ``serve_phase``'s
    8 WAVs in ``root``, through ``serve.serve_files_pooled`` with 2
    replicas, ``migrate_sessions`` and a drain window of
    ``CTRL_DRAIN_S`` on ``_CountClock``: (a) a rolling swap to the same
    weights, started at chunk 1 while every stream plays, must reach
    ``done`` with both replicas swapped and each canary identical (WER
    0); a victim must have hosted live sessions as its drain began, and
    sessions must be live at each swap. A snapshot never crosses
    versions, so the sessions that leave the last v1 replica re-pin by
    drain and end as two segments: each final must equal capacity-1
    managers fed the same chunks before and after the re-pin, and a
    stream that never re-pinned the run without controllers; (b) one at
    chunk 1 to other seeded weights under guardrail 0 must roll back
    with the finals of the run without controllers; (c)
    ``--autoscale`` (1..3 replicas, starting at 1, so that the replica
    removed hosted sessions) on a forced ``slo_burn_rate`` must make
    exactly one scale-up and one scale-down with those finals too. Each
    run: exactly 5 ``gru_fwd`` (K6) a manager step, device memory after
    the run within one version's weights of where it was before, and in
    (c), at the first chunk after the removal, no manager alive but the
    pool's replicas' (the device bytes then and before the scale-up are
    printed). (d) ``_tier_mix_gateway`` and (e) ``_gateway_rollout`` on
    ds2_small (K4, K10). Prints the ms of a swap and of a scale-up (the
    newcomer's manager built with its weights uploaded, and its first
    step). Returns the K6, K4 and K10 launches."""
    import io

    from deepspeech_tpu_torch import serve, serving
    from deepspeech_tpu_torch.data import (CharTokenizer, featurize_np,
                                           load_audio)
    from deepspeech_tpu_torch.serving import (PooledSessionRouter,
                                              RolloutController)
    from deepspeech_tpu_torch.serving.session import StreamingSessionManager

    cfg = _config("ds2_streaming")
    params, stats = _stream_weights(cfg)
    other, other_stats = _stream_weights(cfg, seed=SEED + 1)
    tok = CharTokenizer.english()
    paths = sorted(os.path.join(root, x) for x in os.listdir(root)
                   if x.startswith("live") and x.endswith(".wav"))
    _require(len(paths) == 8, f"controllers: {len(paths)} WAVs")
    m0 = _live_bytes()
    probe = StreamingSessionManager(cfg, params, stats, tok, capacity=1)
    version_bytes = _live_bytes() - m0
    del probe
    steps, made = [0], []
    real_step = StreamingSessionManager.step
    real_init = StreamingSessionManager.__init__

    # Each manager's build and first step, by the autoscale episodes
    # seen when it was built (the records, not the managers: holding a
    # manager would hold its weights past its replica's removal).
    def counted_step(self, chunks=None):
        steps[0] += 1
        rec = self._smoke_rec
        if "first_step_ms" not in rec:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        out = real_step(self, chunks)
        if "first_step_ms" not in rec:
            torch.cuda.synchronize()
            rec["first_step_ms"] = (time.perf_counter() - t0) * 1e3
        return out

    def timed_init(self, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real_init(self, *a, **kw)
        torch.cuda.synchronize()
        self._smoke_rec = {"episodes": tuple(burn.episodes),
                           "init_ms": (time.perf_counter() - t0) * 1e3,
                           "ref": weakref.ref(self)}
        made.append(self._smoke_rec)

    def run(patches=(), replicas=2, telemetry=None, **kw):
        out = io.StringIO()
        before = _live_bytes()
        steps[0] = 0
        made.clear()
        _zero_counts()
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            stack.enter_context(mock.patch.object(
                StreamingSessionManager, "step", counted_step))
            stack.enter_context(mock.patch.object(
                StreamingSessionManager, "__init__", timed_init))
            for p in patches:
                stack.enter_context(p)
            # The loop's pool on the counting clock, with the short drain
            # window (and, for the autoscaler, the forced registry).
            pool_kw = {"clock": _CountClock(),
                       "drain_window_s": CTRL_DRAIN_S}
            if telemetry is not None:
                pool_kw["telemetry"] = telemetry
            stack.enter_context(mock.patch.object(
                serving, "ReplicaPool",
                functools.partial(serving.ReplicaPool, **pool_kw)))
            finals = serve.serve_files_pooled(
                cfg, tok, params, stats, paths, replicas=replicas, out=out,
                migrate_sessions=True, **kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = _recurrent_counts()
        _require(counts["gru_fwd"] == 5 * steps[0] and steps[0] > 0
                 and sum(counts.values()) == counts["gru_fwd"],
                 f"controllers: recurrent launches {counts}, {steps[0]} "
                 "manager steps (want 5 gru_fwd a step)")
        # A manager built after the scale-up and before the scale-down
        # is the newcomer's: its build (weights uploaded) and first step.
        up_ms = [r["init_ms"] + r["first_step_ms"] for r in made
                 if r["episodes"] == ("up",) and "first_step_ms" in r][:1]
        made.clear()
        grown = _live_bytes() - before
        _require(grown <= version_bytes, f"controllers: {grown} bytes "
                 f"still allocated after the run (one version's weights: "
                 f"{version_bytes})")
        lines = [json.loads(x) for x in out.getvalue().splitlines()]
        return finals, lines, {"seconds": seconds,
                               "chunks": sum("chunk" in x for x in lines),
                               "manager_steps": steps[0],
                               "gru_fwd": counts["gru_fwd"],
                               "bytes_after_minus_before": grown,
                               "scale_up_ms": up_ms}

    burn = _forced_burn()
    base, _, base_rep = run()
    _require(any(base), "controllers: every final is empty")
    report = {"base": base_rep, "version_bytes": version_bytes}
    launches = base_rep["gru_fwd"]

    swap_ms, live_at_swap, hosted, cuts, fed = [], [], [], {}, [0]
    holder = {}
    real_swap = RolloutController._swap
    real_pick = RolloutController._pick_victim
    real_attach = PooledSessionRouter._attach
    real_router_step = PooledSessionRouter.step

    def timed_swap(self, rep, now):
        live_at_swap.append(len(holder["router"]()._home))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real_swap(self, rep, now)
        torch.cuda.synchronize()
        swap_ms.append((time.perf_counter() - t0) * 1e3)

    def picked(self, now):
        # The live sessions homed on each victim as its drain begins.
        rep = real_pick(self, now)
        if rep is not None:
            hosted.append(sum(r == rep.rid
                              for r in holder["router"]()._home.values()))
        return rep

    def fed_step(self, chunks):
        # A weak reference: the router (its pool, its managers' weights)
        # must go with the run, as the memory check requires.
        holder["router"] = weakref.ref(self)
        out = real_router_step(self, chunks)
        fed[0] += 1
        return out

    def cut_attach(self, sid, pool, rep):
        # A re-pin by drain (not the join): the session's new segment
        # starts at the chunk this step feeds.
        if sid in self._seg_count:
            cuts[sid] = fed[0]
        return real_attach(self, sid, pool, rep)

    feats = [featurize_np(load_audio(p, 16000), cfg.features)
             for p in paths]
    k, nf = STREAM_CHUNK, cfg.features.num_features

    def solo(x, lo, hi):
        """Chunks ``lo..hi`` of ``x`` through a capacity-1 manager, then
        left and flushed: one segment, as a re-pin by drain ends it."""
        mgr = StreamingSessionManager(cfg, params, stats, tok,
                                      chunk_frames=k, capacity=1)
        mgr.join("solo")
        for i in range(lo, hi):
            buf = np.zeros((k, nf), np.float32)
            piece = x[i * k:(i + 1) * k]
            buf[:piece.shape[0]] = piece
            mgr.step({"solo": buf})
        mgr.leave("solo")
        mgr.flush()
        return mgr.final("solo")

    for case, swap, swap_stats in (("same", params, stats),
                                   ("other", other, other_stats)):
        for box in (swap_ms, live_at_swap, hosted):
            box.clear()
        cuts.clear()
        fed[0] = 0
        finals, lines, rep_ = run(
            (mock.patch.object(RolloutController, "_swap", timed_swap),
             mock.patch.object(RolloutController, "_pick_victim", picked),
             mock.patch.object(PooledSessionRouter, "step", fed_step),
             mock.patch.object(PooledSessionRouter, "_attach",
                               cut_attach)),
            swap_params=swap, swap_batch_stats=swap_stats,
            swap_at_chunk=1, swap_wer_guardrail=0.0)
        events = [x["rollout"] for x in lines if "rollout" in x]
        acts = [e["action"] for e in events]
        if case == "same":
            # Mid-stream: a victim that hosted live sessions drains them
            # onto the other replica and swaps while they play on. A
            # snapshot never crosses versions, so the sessions that
            # leave the last v1 replica re-pin by drain: two segments,
            # each held to capacity-1 managers fed the same chunks.
            _require(acts[-1] == "done" and acts.count("swap") == 2
                     and all(e["wer_delta"] == 0.0 for e in events
                             if e["action"] == "swap"),
                     f"swap to the same weights: {events}")
            _require(max(hosted, default=0) > 0 and all(live_at_swap),
                     f"swap to the same weights: sessions hosted by the "
                     f"victims {hosted}, live at the swaps {live_at_swap}")
            for s, x in enumerate(feats):
                n, c = -(-x.shape[0] // k), cuts.get(str(s))
                want = base[s] if c is None else " ".join(
                    t for t in (solo(x, 0, c), solo(x, c, n)) if t)
                _require(finals[s] == want, f"swap ({case}) stream {s} "
                         f"(re-pinned at chunk {c}): final {finals[s]!r} "
                         f"!= {want!r}")
        else:
            _require(acts[-1] == "rollback" and "swap" not in acts
                     and events[-1]["trigger"] == "canary_regression",
                     f"swap to other weights: {events}")
            _require(finals == base, f"swap ({case}): finals {finals} "
                     f"!= {base}")
        report[f"swap_{case}"] = {
            **rep_, "actions": acts, "swap_ms": list(swap_ms),
            "sessions_hosted_by_victims": list(hosted),
            "sessions_live_at_swaps": list(live_at_swap),
            "repinned_by_drain": dict(sorted(cuts.items()))}
        launches += rep_["gru_fwd"]

    burn = _forced_burn()
    marks = {}
    real_route = PooledSessionRouter.step

    def live_managers(pool):
        """(managers alive anywhere, managers of the pool's replicas)."""
        gc.collect()
        alive = {id(m) for m in (r["ref"]() for r in made) if m is not None}
        held = {id(r.peek_session_manager()) for r in pool
                if r.peek_session_manager() is not None}
        return alive, held

    def route(self, chunks):
        if "up" not in burn.episodes:
            marks["before_up"] = torch.cuda.memory_allocated()
        elif "down" in burn.episodes and "after_down" not in marks:
            # The first chunk after the removal: the removed replica's
            # manager (its weights, its state) must be gone.
            alive, held = live_managers(self.pool)
            torch.cuda.synchronize()
            marks["after_down"] = torch.cuda.memory_allocated()
            marks["leaked_managers"] = len(alive - held)
        return real_route(self, chunks)

    finals, lines, rep_ = run(
        (mock.patch.object(PooledSessionRouter, "step", route),),
        replicas=1, autoscale=True, autoscale_min=1, autoscale_max=3,
        autoscale_cooldown=CTRL_COOLDOWN_S, telemetry=burn)
    events = [x["autoscale"] for x in lines if "autoscale" in x]
    acts = [e["action"] for e in events]
    _require(burn.episodes == ["up", "down"] and acts.count("scale_up") == 1
             and acts.count("scale_down") == 1,
             f"autoscale: episodes {burn.episodes}, events {acts}")
    _require(finals == base, f"autoscale: finals {finals} != {base}")
    _require(marks.get("leaked_managers") == 0, f"autoscale: "
             f"{marks.get('leaked_managers')} managers outlived their "
             "replica's removal (or no chunk followed it)")
    newcomers = [e["replica"] for e in events if e["action"] == "scale_up"]
    report["autoscale"] = {
        **rep_, "actions": acts, "newcomer": newcomers,
        "bytes_after_removal_minus_before_up": (
            marks["after_down"] - marks["before_up"]
            if "after_down" in marks else None)}
    launches += rep_["gru_fwd"]
    tier_mix, tier_launches = _tier_mix_gateway(card)
    report["tier_mix"] = tier_mix
    report["gateway_rollout"], k4 = _gateway_rollout(card)
    tier_launches["gru_fwd"] += k4
    print(card, flush=True)
    print(json.dumps({"controllers": report, "card": card}), flush=True)
    return {"gru_fwd[D=1]": launches, **tier_launches}



class _StatusProbe:
    """The ``serve --status-port=0`` run's status server, from outside:
    a stderr stand-in that catches the ``{"status_server": url}`` line,
    and a thread that then GETs each route over loopback (one
    ``STATUS_TIMEOUT_S`` each) while the run is held open."""

    ROUTES = ("/healthz", "/metrics", "/slo", "/incidents")

    def __init__(self):
        self.url = None
        self.got = {}
        self.error = None
        self.ready = threading.Event()
        self.done = threading.Event()
        self._buf = ""
        self._thread = threading.Thread(target=self._poll, daemon=True)
        self._thread.start()

    def write(self, text):
        self._buf += text
        for line in self._buf.splitlines():
            if line.startswith('{"status_server"'):
                self.url = json.loads(line)["status_server"]
                self.ready.set()
        return len(text)

    def flush(self):
        pass

    def _poll(self):
        import urllib.request

        try:
            if not self.ready.wait(STATUS_TIMEOUT_S * 6):
                raise RuntimeError("no status_server line")
            base = self.url.rstrip("/")
            for route in self.ROUTES:
                with urllib.request.urlopen(base + route,
                                            timeout=STATUS_TIMEOUT_S) as r:
                    self.got[route] = (r.status, r.read().decode())
        except Exception as e:  # reported by the phase's check
            self.error = repr(e)
        finally:
            self.done.set()

    def join(self):
        self._thread.join(STATUS_TIMEOUT_S * 8)
        return not self._thread.is_alive()


def multimodel_phase(root: str, card: str):
    """``serve.main`` with ``--models`` over two port checkpoints of
    ds2_streaming (``_stream_weights`` from two seeds, written here with
    ``CheckpointManager``), 2 replicas a model, ``--tenant-config`` (two
    tenants, quotas 2 and 1, so the 4th stream is shed at join),
    ``--decode=beam --lm-rescore`` on a vocabulary without a space
    (``--vocab``: English's alphabet with "_" for the space, so that
    serve scores the LM on space-joined characters) with a seeded
    character trigram over it, ``--status-port=0``, ``--timeline`` and a
    rolling swap of model a to a copy of its weights after the streams
    (``--swap-at-chunk`` past the end; ``controllers_phase`` swaps
    mid-stream), on the 4 shortest of ``serve_phase``'s WAVs. The
    ``model_map`` and ``tenant_map`` lines must be there, one
    ``{"shed"}`` line with an empty final; each model's finals must
    equal ``serve_files_pooled`` of that checkpoint alone on its
    streams; at least one ``{"revision"}`` line, and each stream's
    revision (or none) host ``rescore_nbest``'s pick over the router's
    ``final_nbest``;
    ``/healthz``, ``/metrics``, ``/slo`` and ``/incidents`` must answer
    over loopback during the run and the port be closed after it; the
    timeline file must hold the run's events. Exactly 5 ``gru_fwd`` (K6)
    a manager step. Returns the K6 launches of the ``--models`` run."""
    import io

    from deepspeech_tpu_torch import serve
    from deepspeech_tpu_torch.checkpoint import CheckpointManager
    from deepspeech_tpu_torch.config import apply_overrides
    from deepspeech_tpu_torch.data import CharTokenizer
    from deepspeech_tpu_torch.decode.ngram import load_lm, rescore_nbest
    from deepspeech_tpu_torch.serving import PooledSessionRouter
    from deepspeech_tpu_torch.serving.session import StreamingSessionManager

    cfg = _config("ds2_streaming")
    # English's alphabet with "_" in place of the space: a vocabulary
    # without a space, on which serve scores the LM on space-joined
    # characters (to_lm_text), so that the character trigram's words
    # are the hypotheses' characters.
    vocab = os.path.join(root, "mm_vocab.txt")
    CharTokenizer([c if c != " " else "_" for c in
                   CharTokenizer.english().chars]).save_vocab(vocab)
    tok = CharTokenizer.from_vocab_file(vocab)
    _require(tok.vocab_size == cfg.model.vocab_size and " " not in tok.chars,
             f"multimodel: vocabulary {tok.chars}")
    paths = sorted(os.path.join(root, x) for x in os.listdir(root)
                   if x.startswith("live") and x.endswith(".wav"))
    _require(len(paths) == 8, f"multimodel: {len(paths)} WAVs")
    # The four shortest: the live beam is host-bound, a step a chunk
    # of the longest stream on each of four managers.
    paths = sorted(sorted(paths, key=os.path.getsize)[:4])
    weights = {"a": _stream_weights(cfg), "b": _stream_weights(
        cfg, seed=SEED + 1)}
    cks = {}
    for name, (p, s) in (("a", weights["a"]), ("b", weights["b"]),
                         ("a2", weights["a"])):
        cks[name] = os.path.join(root, f"mm_{name}")
        mgr = CheckpointManager(cks[name])
        mgr.save(1, {"params": p, "batch_stats": s})
        mgr.wait()
    arpa = os.path.join(root, "mm_char.arpa")
    _write_char_arpa(arpa, tok.chars, np.random.default_rng(SEED + 6), 300,
                     600)
    tenants = os.path.join(root, "tenants.json")
    with open(tenants, "w") as fh:
        json.dump({"tenants": [
            {"tenant": "gold", "quota": 1, "priority": "realtime",
             "weight": 2.0},
            {"tenant": "bulk", "quota": 2, "priority": "batch"}]}, fh)
    timeline = os.path.join(root, "timeline.jsonl")
    steps, nbests = [0], {}
    real_step = StreamingSessionManager.step
    real_nbest = PooledSessionRouter.final_nbest
    real_loop = serve.serve_files_multimodel
    probe = _StatusProbe()

    def counted_step(self, chunks=None):
        steps[0] += 1
        return real_step(self, chunks)

    def recorded_nbest(self, sid):
        nbests[sid] = real_nbest(self, sid)
        return nbests[sid]

    def held_loop(*a, **kw):
        # The run stays open (its status server up) until the probe
        # has made its GETs.
        finals = real_loop(*a, **kw)
        probe.done.wait(STATUS_TIMEOUT_S * 8)
        return finals

    out = io.StringIO()
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(probe), \
            mock.patch.object(StreamingSessionManager, "step",
                              counted_step), \
            mock.patch.object(PooledSessionRouter, "final_nbest",
                              recorded_nbest), \
            mock.patch.object(serve, "serve_files_multimodel", held_loop):
        serve.main([f"--models=a={cks['a']},b={cks['b']}", "--replicas=2",
                    f"--swap-checkpoint=a={cks['a2']}",
                    "--swap-at-chunk=100000", f"--tenant-config={tenants}",
                    "--status-port=0", f"--timeline={timeline}",
                    "--decode=beam", "--lm-rescore", f"--vocab={vocab}",
                    f"--decode.lm_path={arpa}", *paths])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    _require(probe.join() and probe.error is None,
             f"multimodel: status server probe {probe.error}")
    counts = _recurrent_counts()
    _require(counts["gru_fwd"] == 5 * steps[0] and steps[0] > 0
             and sum(counts.values()) == counts["gru_fwd"],
             f"multimodel: recurrent launches {counts}, {steps[0]} "
             "manager steps (want 5 gru_fwd a step)")
    lines = [json.loads(x) for x in out.getvalue().splitlines()]

    def only(key):
        found = [x[key] for x in lines if key in x]
        _require(len(found) == 1, f"multimodel: {len(found)} {key} lines")
        return found[0]

    models, tenant_map = only("model_map"), only("tenant_map")
    finals = only("final")
    sids = [str(s) for s in range(4)]
    _require([models[s] for s in sids] == ["a", "b"] * 2
             and [tenant_map[s] for s in sids] == ["bulk", "gold"] * 2,
             f"multimodel: maps {models} {tenant_map}")
    shed = [x["shed"] for x in lines if "shed" in x]
    _require([x["stream"] for x in shed] == [3] and finals[3] == ""
             and all(finals[:3]),
             f"multimodel: sheds {shed}, finals {finals}")
    table = serve.device_lm_table(
        apply_overrides(cfg, {"decode.lm_path": arpa}), tok)
    for mid in ("a", "b"):
        own = [s for s in range(3) if models[str(s)] == mid]
        alone = serve.serve_files_pooled(
            cfg, tok, *weights[mid], [paths[s] for s in own], replicas=2,
            decode="beam", lm_table=table, out=io.StringIO())
        _require(alone == [finals[s] for s in own],
                 f"multimodel {mid}: finals {[finals[s] for s in own]} != "
                 f"the checkpoint alone {alone}")
    lm, d = load_lm(arpa), cfg.decode
    revisions = {x["revision"]["rid"]: x["revision"] for x in lines
                 if "revision" in x}
    _require(set(nbests) == set(sids[:3]),
             f"multimodel: n-best of {sorted(nbests)}")
    _require(revisions, "multimodel: no {\"revision\"} line: the second "
             "pass changed no transcript")
    for s in range(3):
        pick = rescore_nbest(nbests[str(s)], lm, d.lm_alpha, d.lm_beta,
                             to_lm_text=_lm_text)[0][0]
        rev = revisions.get(str(s))
        _require((rev is None and pick == finals[s])
                 or (rev is not None and rev["new_text"] == pick
                     and rev["old_text"] == finals[s]),
                 f"multimodel stream {s}: revision {rev}, host pick "
                 f"{pick!r}, final {finals[s]!r}")
    rescoring = only("rescoring")
    _require(rescoring["submitted"] == rescoring["completed"] == 3,
             f"multimodel: rescoring {rescoring}")
    got = probe.got
    _require(set(got) == set(_StatusProbe.ROUTES)
             and all(code == 200 for code, _ in got.values())
             and json.loads(got["/healthz"][1])["status"] == "ok"
             and "burn" in json.loads(got["/slo"][1])
             and {"open", "closed"} <= set(json.loads(
                 got["/incidents"][1])),
             f"multimodel: status routes {got}")
    import urllib.error
    import urllib.request
    try:
        urllib.request.urlopen(probe.url + "healthz", timeout=2)
        closed = False
    except (urllib.error.URLError, OSError):
        closed = True
    _require(closed, "multimodel: the status server outlived the run")
    with open(timeline) as fh:
        records = [json.loads(x) for x in fh if x.strip()]
    kinds = sorted({r["kind"] for r in records})
    _require(records and all(r["event"] == "timeline" for r in records)
             and any(k.startswith("rollout_") for k in kinds),
             f"multimodel: timeline kinds {kinds}")
    roll = [x["rollout"] for x in lines if "rollout" in x]
    _require(roll and roll[-1]["action"] == "done"
             and all(e["model"] == "a" for e in roll),
             f"multimodel: rollout {roll}")
    print(card, flush=True)
    print(json.dumps({"multimodel": {
        "seconds": seconds, "manager_steps": steps[0],
        "gru_fwd": counts["gru_fwd"], "shed_streams": [3],
        "revised": len(revisions), "timeline_records": len(records),
        "timeline_kinds": kinds, "status_routes": sorted(got),
        "finals_equal_single_model": True}, "card": card}), flush=True)
    return counts["gru_fwd"]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from deepspeech_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    card = smi.splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    built = _build.build(_build.all_sources())
    print(json.dumps({"built": sorted(built),
                      "build_seconds": time.perf_counter() - t0}),
          flush=True)

    from deepspeech_tpu_torch.config import get_config
    from deepspeech_tpu_torch.ops import gru

    h_full = get_config("ds2_full").model.rnn_hidden
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    entries = {}
    for name, fn, *args in (
            ("gru_fwd", gru_fwd_kernel_phase, H, [(2, K4), (1, K6)]),
            ("gru_bwd", gru_bwd_kernel_phase, H, [(2, K5), (1, K7)]),
            ("ctc", ctc_kernel_phase),
            ("gru_fwd_stream", gru_fwd_kernel_phase, h_full, [(2, K8)]),
            ("gru_bwd_stream", gru_bwd_kernel_phase, h_full, [(2, K9)]),
            ("gru_fwd_q", functools.partial(gru_fwd_kernel_phase, d1_h=H),
             h_full, [(2, K10), (1, K10)]),
            ("gru_fwd_q_stream", gru_fwd_kernel_phase, h_full, [(2, K11)]),
            ("lstm_fwd", lstm_kernel_phase, H, [(2, K12), (1, K12)]),
            ("lstm_fwd_stream", lstm_kernel_phase, h_full, [(2, K14)]),
            ("lstm_fwd_q", lstm_kernel_phase, H, [(2, K16), (1, K16)]),
            ("lstm_fwd_q_stream", lstm_kernel_phase, h_full, [(2, K17)]),
            ("lstm_bwd", lstm_bwd_kernel_phase, H, [(2, K13), (1, K13)]),
            ("lstm_bwd_stream", lstm_bwd_kernel_phase, h_full, [(2, K15)])):
        kernel = () if name == "ctc" else (name,)
        for e in _phase(f"{name} kernel", fn, gen, *kernel, *args):
            entries[e["name"]] = e
    # Inference: one GRU forward launch per layer per forward, bf16 and
    # then int8 on the same weights. ds2_full int8 is this slice's main
    # path (K10); with the resident int8 kernel refused it streams (K11).
    for preset, layers, name in (("ds2_small", 3, "gru_fwd[D=2]"),
                                 ("ds2_streaming", 5, "gru_fwd[D=1]"),
                                 ("ds2_full", 7, "gru_fwd_stream[D=2]")):
        entries[name]["launches"] = _phase(
            f"{preset} decode", path_phase, preset, layers,
            name.split("[")[0])
        q_launches = _phase(f"{preset} int8 decode", path_phase, preset,
                            layers, "gru_fwd_q", "int8")
        if preset != "ds2_full":
            continue
        entries["gru_fwd_q[D=2]"]["launches"] = q_launches
        with mock.patch.object(gru, "resident_fits",
                               _refusing_fwd_q(gru.resident_fits)):
            entries["gru_fwd_q_stream[D=2]"]["launches"] = _phase(
                f"{preset} int8 blocked-q decode", path_phase, preset,
                layers, "gru_fwd_q_stream", "int8")
        _phase(f"{preset} quant_effect", quant_effect_phase, preset)
    # The LSTM variants of the same presets (model.rnn_type=lstm): one
    # LSTM forward launch per layer per forward, bf16 and then int8 on
    # the same weights. At ds2_full's H=1760 both stream (K14, K17).
    for preset, layers, name, quantize in (
            ("ds2_small", 3, "lstm_fwd[D=2]", ""),
            ("ds2_small", 3, "lstm_fwd_q[D=2]", "int8"),
            ("ds2_streaming", 5, "lstm_fwd[D=1]", ""),
            ("ds2_streaming", 5, "lstm_fwd_q[D=1]", "int8"),
            ("ds2_full", 7, "lstm_fwd_stream[D=2]", ""),
            ("ds2_full", 7, "lstm_fwd_q_stream[D=2]", "int8")):
        entries[name]["launches"] = _phase(
            f"{preset}-lstm {quantize or 'bf16'} decode", path_phase, preset,
            layers, name.split("[")[0], quantize, "lstm")
    _weights.cache_clear()
    # Training: one forward and one backward launch per layer per step,
    # GRU and then LSTM (the LSTM's forward with its tape).
    for preset, layers, name, streamed, steps, descent, rnn_type in (
            ("ds2_small", 3, "gru_bwd[D=2]", False, TRAIN_STEPS,
             DESCENT_STEPS, "gru"),
            ("ds2_streaming", 5, "gru_bwd[D=1]", False, TRAIN_STEPS,
             DESCENT_STEPS, "gru"),
            ("ds2_full", FULL_TRAIN_LAYERS, "gru_bwd_stream[D=2]", True,
             FULL_TRAIN_STEPS, FULL_DESCENT_STEPS, "gru"),
            ("ds2_small", 3, "lstm_bwd[D=2]", False, TRAIN_STEPS,
             DESCENT_STEPS, "lstm"),
            ("ds2_streaming", 5, "lstm_bwd[D=1]", False, TRAIN_STEPS,
             DESCENT_STEPS, "lstm"),
            ("ds2_full", FULL_TRAIN_LAYERS, "lstm_bwd_stream[D=2]", True,
             FULL_TRAIN_STEPS, FULL_DESCENT_STEPS, "lstm")):
        counts = _phase(f"{preset}-{rnn_type} train", train_phase, preset,
                        layers, streamed, steps, descent, rnn_type)
        entries[name]["launches"] = counts["bwd"]
        for ctc_name, key in (("ctc_alpha", "ctc_alpha"),
                              ("ctc_alpha[loss_only]", "loss_only"),
                              ("ctc_beta", "ctc_beta")):
            entries[ctc_name]["launches"] += counts[key]
    # ds2_small on a WAV manifest: train, checkpoint, resume, serve.
    root = tempfile.mkdtemp(prefix="chip_smoke_manifest_")
    try:
        counts = _phase("ds2_small manifest train/resume/serve",
                        manifest_phase, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for name, key in (("gru_fwd[D=2]", "gru_fwd"), ("gru_bwd[D=2]", "gru_bwd"),
                      ("ctc_alpha", "ctc_alpha"),
                      ("ctc_alpha[loss_only]", "loss_only"),
                      ("ctc_beta", "ctc_beta")):
        entries[name]["launches"] += counts[key]
    # ds2_streaming live: the chunked engine, sessions, serve (K6 and
    # K10 at D=1 with a carried h0), the chunk's times, the feed.
    stream = _phase("ds2_streaming chunked vs offline", streaming_phase)
    entries["gru_fwd[D=1]"]["launches"] += stream["gru_fwd"]
    entries["gru_fwd_q[D=1]"]["launches"] = stream["gru_fwd_q"]
    _phase("ds2_streaming sessions", sessions_phase)
    root = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    try:
        entries["gru_fwd[D=1]"]["launches"] += _phase(
            "ds2_streaming serve", serve_phase, root)
        # Pooled live streaming on the same WAVs (K6 over 2 replicas).
        entries["gru_fwd[D=1]"]["launches"] += _phase(
            "ds2_streaming pooled serve", pooled_stream_phase, root, card)
        # The controllers on the same WAVs: rolling swaps, autoscale
        # (K6), and the tier-mix rung on ds2_small (K4, K10); then
        # serve --models with tenants, the status server, the timeline
        # and the LM second pass (K6).
        ctrl = _phase("ds2_streaming controllers", controllers_phase, root,
                      card)
        entries["gru_fwd[D=1]"]["launches"] += ctrl["gru_fwd[D=1]"]
        entries["gru_fwd[D=2]"]["launches"] += ctrl["gru_fwd"]
        entries["gru_fwd_q[D=2]"]["launches"] += ctrl["gru_fwd_q"]
        entries["gru_fwd[D=1]"]["launches"] += _phase(
            "ds2_streaming multimodel serve", multimodel_phase, root, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    # The gateway: ds2_small requests on replicas (K4; int8 K10).
    gateway = _phase("ds2_small gateway", gateway_phase, card)
    entries["gru_fwd[D=2]"]["launches"] += gateway["gru_fwd"]
    entries["gru_fwd_q[D=2]"]["launches"] += gateway["gru_fwd_q"]
    _phase("ds2_streaming chunk timing", chunk_timing_phase, card)
    _phase("ds2_small run feed", feed_phase, card)
    # Beam search and the LM: offline (K4) and live (K6, K10).
    root = tempfile.mkdtemp(prefix="chip_smoke_beam_")
    try:
        entries["gru_fwd[D=2]"]["launches"] += _phase(
            "ds2_beam_lm / aishell beam", beam_phase, root, card)
        stream = _phase("ds2_streaming beam", beam_stream_phase, root, card)
        # The n-best gateway and the asynchronous LM second pass (K4).
        entries["gru_fwd[D=2]"]["launches"] += _phase(
            "ds2_beam_lm n-best gateway and rescoring", rescore_phase, root,
            card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    entries["gru_fwd[D=1]"]["launches"] += stream["gru_fwd"]
    entries["gru_fwd_q[D=1]"]["launches"] += stream["gru_fwd_q"]
    entries = [entries[n] for n in (
        "gru_fwd[D=2]", "gru_fwd[D=1]", "ctc_alpha", "ctc_alpha[loss_only]",
        "ctc_beta", "gru_bwd[D=2]", "gru_bwd[D=1]", "gru_fwd_stream[D=2]",
        "gru_bwd_stream[D=2]", "gru_fwd_q[D=2]", "gru_fwd_q[D=1]",
        "gru_fwd_q_stream[D=2]",
        "lstm_fwd[D=2]", "lstm_fwd[D=1]", "lstm_fwd_stream[D=2]",
        "lstm_fwd_q[D=2]", "lstm_fwd_q[D=1]", "lstm_fwd_q_stream[D=2]",
        "lstm_bwd[D=2]", "lstm_bwd[D=1]", "lstm_bwd_stream[D=2]")]
    for e in entries:
        _require(e["launches"] > 0, f"{e['name']} never launched")
    print(json.dumps({"kernels": entries, "card": card}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
