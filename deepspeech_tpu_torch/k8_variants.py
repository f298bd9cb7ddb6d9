"""Variants of the streamed GRU forward's tensor-core loop (K8), timed in
turns on the card, beside an earlier tree's kernel when its source is
given.

Builds copies of ``csrc/gru_fwd_stream.cu``, each made by a text
substitution of the loop's constants: the split of the 8 warps over the
group's 96 gate columns and the depth H (``NW_N``), the stages of a
warp's ring (``MS``), and how many of a warp's chunks of W^T stay
resident in shared memory for the whole call (``W_RES``, from 0 up to
the most that fits beside the rings). With ``--parent=PATH`` it also
builds that file (another tree's ``gru_fwd_stream.cu``) as it is; a
source without the tensor-core loop takes no scratch, and is called
with its own arguments. Each build is held to ``gru_fwd_plain`` at
ds2_full's shape (D=2, T'=850, B=32, H=1760, bf16, ragged lengths, with
an h0; tolerance 3e-2, the same bits twice, ``ys`` and ``hfin``), then
timed with CUDA events there without h0, as the model calls it, two
turns each in the order parent, as built, the others, and then
reversed, with one call split by kernel (the transpose of W, the loop)
by ``torch.profiler``. Prints ptxas's registers and spills of each loop
and one JSON line with the card's name and power limit.

``python -m deepspeech_tpu_torch.k8_variants [--reps=3] [--parent=PATH]``
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
from typing import Dict, List, Tuple

import torch

from .k14_variants import _sub, build_variants
from .k15_ablation import _split_ms, _time_ms
from .ops import _build, gru

SOURCE = "gru_fwd_stream"


def _loop(cols: int, ms: int, res: int) -> List[Tuple[str, str]]:
    """The substitutions that give ``NW_N = cols`` warps over the
    columns, ``MS = ms`` stages and ``W_RES = res`` resident chunks."""
    return [_sub(n, built, v) for n, built, v in (
        ("NW_N", 2, cols), ("MS", 3, ms), ("W_RES", 4, res)) if v != built]


# The source as built: 2 column splits (48 columns a warp) x 4 depth
# splits, 3 stages, 4 of a warp's 13 or 14 chunks of W^T resident (29%).
# A block's 227 KB hold the rings, MS x 80 KB with 2 splits (MS x 56 KB
# with 4, whose warps read the h row 4 times a step), beside resident
# chunks of 24 KB across the 8 warps (12 KB with 4 splits, whose warps
# take 27 or 28 chunks of 32 at H=1760 where 2 splits take 13 or 14).
# Beside it, each ring depth with none, some and the most that fits;
# cols2_ms3_res4 is the source as built once more, the spread of one
# build between turns.
VARIANTS: Dict[str, List[Tuple[str, str]]] = {
    "as_built": [],
    "cols2_ms2_res6": _loop(2, 2, 6),
    "cols2_ms2_res3": _loop(2, 2, 3),
    "cols2_ms2_streamed": _loop(2, 2, 0),
    "cols2_ms3_res4": _loop(2, 3, 4),
    "cols2_ms3_streamed": _loop(2, 3, 0),
    "cols2_ms4_res2": _loop(2, 4, 2),
    "cols2_ms4_streamed": _loop(2, 4, 0),
    "cols4_ms2_res14": _loop(4, 2, 14),
    "cols4_ms2_res7": _loop(4, 2, 7),
    "cols4_ms2_streamed": _loop(4, 2, 0),
    "cols4_ms3_res11": _loop(4, 3, 11),
}


def _inputs(gen, h0: bool, t: int = 850, b: int = 32, h: int = 1760):
    dev = "cuda"
    lens = torch.randint(t // 3, t + 1, (b,), generator=gen, device=dev)
    lens[0] = t
    mask = (torch.arange(t, device=dev)[:, None] < lens[None, :]).float()
    xp = torch.randn(t, b, 3 * h, generator=gen, device=dev).bfloat16()
    w = (torch.randn(2, h, 3 * h, generator=gen, device=dev)
         / math.sqrt(h)).bfloat16()
    bias = torch.randn(2, 3 * h, generator=gen, device=dev) * 0.1
    hh = torch.randn(2, b, h, generator=gen, device=dev) * 0.5 if h0 else None
    return xp, mask, w, bias, hh, (False, True)


def _parent_call(xp, mask, w, b, h0, reverse):
    """``gru_fwd_stream`` through a source whose C entry point takes no
    scratch (the CUDA-core kernel alone)."""
    ys, hfin = gru._fwd_outputs(xp, w, h0)
    gru._launch(SOURCE, xp, mask, w, (b, h0, ys, hfin), reverse)
    return ys, hfin


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="deepspeech_tpu_torch.k8_variants")
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--parent", default="",
                        help="another tree's csrc/gru_fwd_stream.cu, timed "
                        "in turns beside these")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k8_variants measures the card: no CUDA device")
    copies = {"parent": args.parent} if args.parent else {}
    libs, ptxas = build_variants(SOURCE, VARIANTS, "k8_variants", copies)
    calls = {name: gru.gru_fwd_stream for name in libs}
    if args.parent:
        with open(args.parent) as f:
            if "scratch" not in f.read():
                calls["parent"] = _parent_call
    gen = torch.Generator(device="cuda").manual_seed(0)
    check, timed = _inputs(gen, h0=True), _inputs(gen, h0=False)
    ref = gru.gru_fwd_plain(*check)
    checks = {}
    for name, lib in libs.items():
        _build._loaded[SOURCE] = lib
        got, again = calls[name](*check), calls[name](*check)
        err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        same = all(torch.equal(g, a) for g, a in zip(got, again))
        if err > 3e-2 or not same:
            raise RuntimeError(f"variant {name}: max |kernel - plain| {err}, "
                               f"bit-identical {same}")
        checks[name] = err
        del got, again
    names = [*copies, *VARIANTS]
    runs: Dict[str, list] = {n: [] for n in names}
    for name in names + names[::-1]:
        _build._loaded[SOURCE] = libs[name]
        call = calls[name]
        runs[name].append({
            "ms": _time_ms(lambda: call(*timed), args.reps),
            "kernels_ms": _split_ms(lambda: call(*timed), SOURCE)})
    _build._loaded[SOURCE] = libs["as_built"]
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
