"""Where one greedy decode's, or one training step's, time goes on the
card.

Runs ``Inferencer.decode_batch`` on one full ``(B, T)`` rung (every row
``T`` frames long, random init from ``--seed``), or with ``--train`` one
``Trainer.train_step`` on such a batch (labels of 0.15 characters per
frame), under ``torch.profiler`` and prints one JSON line: wall time of
the call, device busy time (the sum of kernel times; the port runs on
one stream, so they do not overlap), the idle share, and the kernels
that took the most device time, with the card's name and power limit.
``--quantize-weights=int8`` decodes through the weight-only int8 engine
(``Inferencer(quantize="int8")``) and adds its kernel regime and peak
device memory to the line.

``python -m deepspeech_tpu_torch.profile_infer --config=ds2_small
[--train] [--quantize-weights=int8] [--batch=32] [--frames=1700]
[--seed=0] [--section.key=value ...]``; ``--model.rnn_type=lstm``
profiles the LSTM variant of a preset, a decode or with ``--train`` a
training step.
"""

from __future__ import annotations

import functools
import json
import subprocess
import time
from typing import List, Optional

import numpy as np
import torch

_PORT_KERNELS = ("gru_fwd_kernel", "gru_fwd_transpose_kernel",
                 "gru_fwd_mma_kernel", "gru_bwd_kernel",
                 "gru_fwd_stream_kernel", "gru_fwd_stream_transpose_kernel",
                 "gru_fwd_stream_mma_kernel",
                 "gru_bwd_gates_kernel", "gru_bwd_mma_kernel",
                 "gru_bwd_stream_kernel", "gru_bwd_stream_gates_kernel",
                 "gru_bwd_stream_mma_kernel", "gru_fwd_q_kernel",
                 "gru_fwd_q_transpose_kernel", "gru_fwd_q_mma_kernel",
                 "gru_fwd_q_stream_kernel",
                 "gru_fwd_q_stream_transpose_kernel",
                 "gru_fwd_q_stream_mma_kernel", "lstm_fwd_kernel",
                 "lstm_fwd_transpose_kernel", "lstm_fwd_mma_kernel",
                 "lstm_fwd_stream_kernel", "lstm_fwd_stream_transpose_kernel",
                 "lstm_fwd_stream_mma_kernel", "lstm_fwd_q_kernel",
                 "lstm_fwd_q_transpose_kernel", "lstm_fwd_q_mma_kernel",
                 "lstm_fwd_q_stream_kernel",
                 "lstm_fwd_q_stream_transpose_kernel",
                 "lstm_fwd_q_stream_mma_kernel", "lstm_bwd_kernel",
                 "lstm_bwd_gates_kernel", "lstm_bwd_mma_kernel",
                 "lstm_bwd_stream_kernel", "lstm_bwd_stream_gates_kernel",
                 "lstm_bwd_stream_mma_kernel", "ctc_alpha_kernel",
                 "ctc_beta_kernel")


def main(argv: Optional[List[str]] = None) -> None:
    import argparse

    from .bridge import init_params
    from .config import apply_overrides, get_config, parse_cli_overrides
    from .data.pipeline import pad_batch
    from .data.synthetic import SyntheticPipeline
    from .data.tokenizer import get_tokenizer
    from .infer import Inferencer
    from .train import Trainer

    parser = argparse.ArgumentParser(prog="deepspeech_tpu_torch.profile_infer")
    parser.add_argument("--config", default="ds2_small")
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--frames", type=int, default=1700)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--top", type=int, default=8)
    parser.add_argument("--train", action="store_true",
                        help="profile one training step instead")
    parser.add_argument("--quantize-weights", default="",
                        choices=["", "int8"],
                        help="decode through the weight-only int8 engine")
    args, extra = parser.parse_known_args(argv)
    if args.train and args.quantize_weights:
        parser.error("--quantize-weights is for decoding; the int8 "
                     "engine has no training step")
    cfg = apply_overrides(get_config(args.config),
                          parse_cli_overrides(extra))
    params, stats = init_params(cfg, torch.Generator().manual_seed(args.seed))
    rng = np.random.default_rng(args.seed)
    feats = rng.normal(size=(args.batch, args.frames,
                             cfg.features.num_features)).astype(np.float32)
    if args.train:
        labels = [rng.integers(1, cfg.model.vocab_size, size=min(
            int(0.15 * args.frames), cfg.data.max_label_len)).tolist()
            for _ in range(args.batch)]
        batch = pad_batch(list(feats), labels, args.frames,
                          cfg.data.max_label_len, cfg.model.time_stride)
        # One step, and no checkpoint: a profile writes no files.
        cfg = apply_overrides(cfg, {"train.checkpoint_dir": ""})
        run = functools.partial(
            Trainer(cfg, SyntheticPipeline(cfg, args.batch),
                    get_tokenizer(cfg.data.language), params=params,
                    batch_stats=stats).train_step, batch)
    else:
        batch = {"features": feats,
                 "feat_lens": np.full(args.batch, args.frames, np.int32)}
        inf = Inferencer(cfg, get_tokenizer(cfg.data.language), params,
                         stats, quantize=args.quantize_weights)
        run = functools.partial(inf.decode_batch, batch)
    torch.cuda.reset_peak_memory_stats()
    run()  # warm-up
    torch.cuda.synchronize()
    peak_bytes = torch.cuda.max_memory_allocated()

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.splitlines()[0]
    print(json.dumps({
        "config": cfg.name, "mode": "train_step" if args.train else "decode",
        "quantize": args.quantize_weights or None,
        "kernel_regime": None if args.train else inf.kernel_regime,
        "rung": [args.batch, args.frames],
        "peak_device_bytes": peak_bytes,
        "card": card, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / wall_ms,
        "top_kernels": [{"name": e.key[:80], "calls": e.count,
                         "device_ms": e.self_device_time_total / 1e3}
                        for e in kernels[:args.top]],
        # The port's own kernels, however small.
        "port_kernels": {name: {"calls": e.count,
                                "device_ms": e.self_device_time_total / 1e3}
                         for e in kernels for name in _PORT_KERNELS
                         if f"::{name}" in e.key}}))


if __name__ == "__main__":
    main()
