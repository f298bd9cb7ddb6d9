"""Where a step of the streamed LSTM backward (K15) spends its time on
the card.

Builds variants of ``csrc/lstm_bwd_stream.cu`` with
``csrc/lstm_bwd_mma.cuh`` pasted in place of its ``#include`` (the loop
lives in the header, which K13 shares), each made by a text
substitution that takes one part out of the serial loop (W's loads, the
dgates row's loads, both, the grid barrier; the copies into shared
memory; those and the products), times each with CUDA events
at ds2_full's shape (D=2, T'=850, B=32, H=1760, bf16; also D=1), two
turns each in the order full, variants, variants reversed, full, and
splits each call between the gate pre-pass and the serial kernel with
``torch.profiler``. A variant's output is wrong by design; only the full
kernel is checked against ``lstm_bwd_plain``. Prints one JSON line with
the card's name and power limit.

``python -m deepspeech_tpu_torch.k15_ablation [--reps=5]``
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import re
import subprocess
from typing import Dict, List, Tuple

import torch

from .ops import _build, lstm

_NO_W = ("const bool ok = k < N && u < H;  // N % 8 == 0: 8 k or none",
         "const bool ok = false;")
_NO_ROW = ("const bool ok = k_ok && b < B;", "const bool ok = false;")
_NO_ROW_COPY = (
    "                cp_async16(slot + p * 32 + lane,\n"
    "                           ok ? g_d + size_t(b) * N + k : g_d, ok);",
    "                (void)ok;")
_NO_W_COPY = (
    "    cp_async16(dst + nt * 32 + lane, ok ? w_d + size_t(u) * N + k : w_d, "
    "ok);",
    "    (void)ok;")
_NO_MMA = [(f"                mma_bf16(acc[mt][nt], a[2 * mt].{x}, "
            f"a[2 * mt + 1].{x},",
            f"                if (0) mma_bf16(acc[mt][nt], a[2 * mt].{x}, "
            f"a[2 * mt + 1].{x},") for x in "xz"]
_NO_SYNC = ("    }\n    grid.sync();\n  }\n}", "    }\n  }\n}")
VARIANTS: Dict[str, List[Tuple[str, str]]] = {
    "full": [],
    "no_w_loads": [_NO_W],
    "no_row_loads": [_NO_ROW],
    "no_loads": [_NO_W, _NO_ROW],
    "no_grid_barrier": [_NO_SYNC],
    # No copies at all: the product runs on whatever the rings hold.
    "no_copies": [_NO_ROW_COPY, _NO_W_COPY],
    "no_copies_no_mma": [_NO_ROW_COPY, _NO_W_COPY, *_NO_MMA],
}


HEADER = "lstm_bwd_mma.cuh"


def with_header(source: str) -> str:
    """The text of ``csrc/<source>.cu`` with ``csrc/lstm_bwd_mma.cuh``
    pasted in place of its ``#include``, so that a substitution reaches
    the loop."""
    with open(os.path.join(_build.CSRC_DIR, f"{source}.cu")) as f:
        text = f.read()
    with open(os.path.join(_build.CSRC_DIR, HEADER)) as f:
        head = f.read()
    include = f'#include "{HEADER}"\n'
    if text.count(include) != 1:
        raise RuntimeError(f"{source}.cu no longer includes {HEADER} once")
    return text.replace(include, head)


def _build_variants() -> Dict[str, ctypes.CDLL]:
    text = with_header("lstm_bwd_stream")
    out_dir = os.path.join(_build.BUILD_DIR, "k15_ablation")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS.items():
        src = text
        for old, new in subs:
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: the source no longer has {old!r}")
            src = src.replace(old, new)
        path = os.path.join(out_dir, f"{name}.cu")
        with open(path, "w") as f:
            f.write(src)
        lib = os.path.join(out_dir, f"lib{name}.so")
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name} failed:\n{log}")
        libs[name] = ctypes.CDLL(lib)
    return libs


def _inputs(gen, d: int, t: int = 850, b: int = 32, h: int = 1760):
    dev = "cuda"
    lens = torch.randint(t // 3, t + 1, (b,), generator=gen, device=dev)
    lens[0] = t
    mask = (torch.arange(t, device=dev)[:, None] < lens[None, :]).float()
    xp = torch.randn(t, b, 4 * h, generator=gen, device=dev).bfloat16()
    w = (torch.randn(d, h, 4 * h, generator=gen, device=dev)
         / math.sqrt(h)).bfloat16()
    bias = torch.randn(d, 4 * h, generator=gen, device=dev) * 0.1
    reverse = (False, True)[:d]
    ys, cs = lstm.lstm_fwd(xp, mask, w, bias, reverse, tape=True)
    dy = torch.randn(ys.shape, generator=gen, device=dev) * 0.1
    return xp, mask, w, bias, ys, cs, dy, reverse


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


def _split_ms(fn, source: str = "lstm_bwd_stream") -> Dict[str, float]:
    """Device ms of one ``fn()`` by kernel, for the kernels whose names
    start with ``source``."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    split: Dict[str, float] = {}
    for e in prof.key_averages():
        name = re.search(source + r"_\w+", e.key)
        if name and e.device_type == torch.autograd.DeviceType.CUDA:
            split[name.group(0)] = e.self_device_time_total / 1e3
    return split


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="deepspeech_tpu_torch.k15_ablation")
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k15_ablation measures the card: no CUDA device")
    libs = _build_variants()
    gen = torch.Generator(device="cuda").manual_seed(0)
    d2, d1 = _inputs(gen, 2), _inputs(gen, 1)
    runs: Dict[str, list] = {n: [] for n in VARIANTS}
    names = list(VARIANTS)
    for name in names + names[::-1]:
        _build._loaded["lstm_bwd_stream"] = libs[name]
        runs[name].append({
            "ms": _time_ms(lambda: lstm.lstm_bwd_stream(*d2), args.reps),
            "ms_d1": _time_ms(lambda: lstm.lstm_bwd_stream(*d1), args.reps),
            "kernels_ms": _split_ms(lambda: lstm.lstm_bwd_stream(*d2))})
    _build._loaded["lstm_bwd_stream"] = libs["full"]
    err = float((lstm.lstm_bwd_stream(*d2)
                 - lstm.lstm_bwd_plain(*d2)).abs().max())
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.splitlines()[0]
    print(json.dumps({"card": card, "shape": {"D": 2, "T": 850, "B": 32,
                                              "H": 1760, "dtype": "bfloat16"},
                      "full_max_abs_err": err, "variants": runs}))


if __name__ == "__main__":
    main()
