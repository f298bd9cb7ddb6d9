"""Variants of the streamed LSTM forward's tensor-core loop (K14), timed
in turns on the card.

Builds copies of ``csrc/lstm_fwd_stream.cu``, each made by a text
substitution of the loop's constants: the split of the 8 warps over the
group's 128 gate columns and the depth H (``NW_N``), the stages of a
warp's ring (``MS``), and how many of a warp's chunks of W^T stay
resident in shared memory for the whole call (``W_RES``): each
combination tried for the source as built. Each variant
computes the same function: it is held to ``lstm_fwd_plain`` at the
main shape (bf16 tolerance 3e-2, the same bits twice), then timed with
CUDA events at ds2_full's shape (D=2, T'=850, B=32, H=1760, bf16), two
turns each in the order of ``VARIANTS`` and then reversed, with one
call split by kernel (the transpose of W, the loop) by
``torch.profiler``. Prints ptxas's registers and spills of each loop and
one JSON line with the card's name and power limit.

``python -m deepspeech_tpu_torch.k14_variants [--reps=5]``
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
from typing import Dict, List, Optional, Tuple

import torch

from .k15_ablation import _split_ms, _time_ms
from .ops import _build, lstm

def _sub(name: str, built: int, value: int) -> Tuple[str, str]:
    return (f"constexpr int {name} = {built};",
            f"constexpr int {name} = {value};")


def _loop(cols: int, ms: int, res: int) -> List[Tuple[str, str]]:
    """The substitutions that give ``NW_N = cols`` warps over the
    columns, ``MS = ms`` stages and ``W_RES = res`` resident chunks."""
    return [_sub(n, built, v) for n, built, v in (
        ("NW_N", 2, cols), ("MS", 2, ms), ("W_RES", 4, res)) if v != built]


# The source as built: 2 column splits (64 columns a warp) x 4 depth
# splits, 2 stages, 4 chunks of W^T a warp resident. Beside it every
# combination tried: 4 column splits (one gate's 32 columns a warp) x 2
# depth splits, and 1 x 8 (128 accumulators a thread).
VARIANTS: Dict[str, List[Tuple[str, str]]] = {
    "as_built": [],
    "cols2_ms2_streamed": _loop(2, 2, 0),
    "cols2_ms3_res2": _loop(2, 3, 2),
    "cols2_ms3_streamed": _loop(2, 3, 0),
    "cols2_ms4_streamed": _loop(2, 4, 0),
    "cols4_ms4_streamed": _loop(4, 4, 0),
    "cols4_ms4_res4": _loop(4, 4, 4),
    "cols4_ms4_res6": _loop(4, 4, 6),
    "cols4_ms3_res8": _loop(4, 3, 8),
    "cols4_ms2_res10": _loop(4, 2, 10),
    "cols1_ms2_streamed": _loop(1, 2, 0),
}


def build_variants(source: str, variants: Dict[str, List[Tuple[str, str]]],
                   tag: str, copies: Optional[Dict[str, str]] = None,
                   entry: str = "mma_kernel"
                   ) -> Tuple[Dict[str, ctypes.CDLL], Dict[str, list]]:
    """Build each of ``variants`` (name -> text substitutions of
    ``csrc/<source>.cu``) and each of ``copies`` (name -> the path of
    another copy of that source, built as it is) into
    ``build/torch_kernels/<tag>/``, one ``nvcc -Xptxas -v`` each (headers
    from ``csrc/``), all started together. Returns the loaded libraries
    and, for each, ptxas's registers and spills of its tensor-core loops
    (the report after each entry whose name holds ``entry``, in ptxas's
    order; none where the source has no such kernel)."""
    with open(os.path.join(_build.CSRC_DIR, f"{source}.cu")) as f:
        text = f.read()
    out_dir = os.path.join(_build.BUILD_DIR, tag)
    os.makedirs(out_dir, exist_ok=True)
    sources = {}
    for name, subs in variants.items():
        src = text
        for old, new in subs:
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: the source no longer has {old!r}")
            src = src.replace(old, new)
        sources[name] = os.path.join(out_dir, f"{name}.cu")
        with open(sources[name], "w") as f:
            f.write(src)
    sources.update(copies or {})
    procs = {}
    for name, path in sources.items():
        lib = os.path.join(out_dir, f"lib{name}.so")
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
             "-I", _build.CSRC_DIR, "-o", lib, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs, ptxas = {}, {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name} failed:\n{log}")
        libs[name] = ctypes.CDLL(lib)
        lines = log.splitlines()
        ptxas[name] = [
            x.strip() for at, line in enumerate(lines)
            if "Compiling entry" in line and entry in line
            for x in lines[at + 1:at + 4] if "spill" in x or "Used" in x]
    return libs, ptxas


def _inputs(gen, t: int = 850, b: int = 32, h: int = 1760):
    dev = "cuda"
    lens = torch.randint(t // 3, t + 1, (b,), generator=gen, device=dev)
    lens[0] = t
    mask = (torch.arange(t, device=dev)[:, None] < lens[None, :]).float()
    xp = torch.randn(t, b, 4 * h, generator=gen, device=dev).bfloat16()
    w = (torch.randn(2, h, 4 * h, generator=gen, device=dev)
         / math.sqrt(h)).bfloat16()
    bias = torch.randn(2, 4 * h, generator=gen, device=dev) * 0.1
    return xp, mask, w, bias, (False, True)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="deepspeech_tpu_torch.k14_variants")
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k14_variants measures the card: no CUDA device")
    libs, ptxas = build_variants("lstm_fwd_stream", VARIANTS,
                                 "k14_variants")
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = _inputs(gen)
    ref = lstm.lstm_fwd_plain(*inputs)
    checks = {}
    for name, lib in libs.items():
        _build._loaded["lstm_fwd_stream"] = lib
        ys, again = lstm.lstm_fwd_stream(*inputs), lstm.lstm_fwd_stream(*inputs)
        err = float((ys - ref).abs().max())
        if err > 3e-2 or not torch.equal(ys, again):
            raise RuntimeError(f"variant {name}: max |kernel - plain| {err}, "
                               f"bit-identical {torch.equal(ys, again)}")
        checks[name] = err
    runs: Dict[str, list] = {n: [] for n in VARIANTS}
    names = list(VARIANTS)
    for name in names + names[::-1]:
        _build._loaded["lstm_fwd_stream"] = libs[name]
        runs[name].append({
            "ms": _time_ms(lambda: lstm.lstm_fwd_stream(*inputs), args.reps),
            "kernels_ms": _split_ms(lambda: lstm.lstm_fwd_stream(*inputs),
                                    "lstm_fwd_stream")})
    _build._loaded["lstm_fwd_stream"] = libs["as_built"]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.splitlines()[0]
    print(json.dumps({"card": card, "shape": {"D": 2, "T": 850, "B": 32,
                                              "H": 1760, "dtype": "bfloat16"},
                      "max_abs_err": checks, "ptxas": ptxas,
                      "variants": runs}))


if __name__ == "__main__":
    main()
