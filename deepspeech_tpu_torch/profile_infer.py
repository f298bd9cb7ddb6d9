"""Where one greedy decode's time goes on the card.

Runs ``Inferencer.decode_batch`` on one full ``(B, T)`` rung (every row
``T`` frames long, random init from ``--seed``) under ``torch.profiler``
and prints one JSON line: wall time of the decode, device busy time
(the sum of kernel times; the port runs on one stream, so they do not
overlap), the idle share, and the kernels that took the most device
time, with the card's name and power limit.

``python -m deepspeech_tpu_torch.profile_infer --config=ds2_small
[--batch=32] [--frames=1700] [--seed=0] [--section.key=value ...]``
"""

from __future__ import annotations

import json
import subprocess
import time
from typing import List, Optional

import numpy as np
import torch


def main(argv: Optional[List[str]] = None) -> None:
    import argparse

    from .bridge import init_params
    from .config import apply_overrides, get_config, parse_cli_overrides
    from .data.tokenizer import get_tokenizer
    from .infer import Inferencer

    parser = argparse.ArgumentParser(prog="deepspeech_tpu_torch.profile_infer")
    parser.add_argument("--config", default="ds2_small")
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--frames", type=int, default=1700)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--top", type=int, default=8)
    args, extra = parser.parse_known_args(argv)
    cfg = apply_overrides(get_config(args.config),
                          parse_cli_overrides(extra))
    params, stats = init_params(cfg, torch.Generator().manual_seed(args.seed))
    inf = Inferencer(cfg, get_tokenizer(cfg.data.language), params, stats)
    rng = np.random.default_rng(args.seed)
    batch = {"features": rng.normal(size=(
                 args.batch, args.frames,
                 cfg.features.num_features)).astype(np.float32),
             "feat_lens": np.full(args.batch, args.frames, np.int32)}
    inf.decode_batch(batch)  # warm-up
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        inf.decode_batch(batch)
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
        "config": cfg.name, "rung": [args.batch, args.frames],
        "card": card, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / wall_ms,
        "top_kernels": [{"name": e.key[:80], "calls": e.count,
                         "device_ms": e.self_device_time_total / 1e3}
                        for e in kernels[:args.top]]}))


if __name__ == "__main__":
    main()
