"""Variants of the streamed int8 LSTM forward's tensor-core loop (K17),
timed in turns on the card, beside an earlier tree's kernel when its
source is given.

Builds copies of ``csrc/lstm_fwd_q_stream.cu``, each made by a text
substitution of the loop's constants: the split of the 8 warps over the
group's 128 gate columns (``NW_N``), the stages of a warp's ring
(``MS``), how many of a warp's chunks of Q^T stay resident in shared
memory for the whole call (``W_RES``) and whether those are held as s8
or already widened to bf16 (``RES_BF16``). With ``--parent=PATH`` it
also builds that file (another tree's ``lstm_fwd_q_stream.cu``, with the
same C entry point) as it is. Each build is held to ``lstm_fwd_q_plain``
at ds2_full's shape (D=2, T'=850, B=32, H=1760, bf16 dots, int8 W;
tolerance 3e-2, the same bits twice), then timed with CUDA events there,
two turns each in the order parent, as built, the others, and then
reversed, with one call split by kernel (the transpose of Q, the loop)
by ``torch.profiler``. One more build, ``no_widening``, passes the s8
bytes to the tensor cores as they lie: its output is wrong by design and
is not checked; its time beside the as-built one is what widening costs.
Prints ptxas's registers and spills of each loop and one JSON line with
the card's name and power limit.

``python -m deepspeech_tpu_torch.k17_variants [--reps=3] [--parent=PATH]``
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
from typing import Dict, List, Tuple

import torch

from .k14_variants import build_variants
from .k15_ablation import _split_ms, _time_ms
from .ops import _build, lstm

SOURCE = "lstm_fwd_q_stream"




def _loop(cols: int, ms: int, res: int, bf16: int = 0) -> Dict[str, int]:
    return dict(NW_N=cols, MS=ms, W_RES=res, RES_BF16=bf16)


# Loop constants of each variant, beside the source as built. Each fits a
# block's 227 KB: the rings take MS x 64 KB with 2 column splits (MS x 48
# KB with 4, whose warps read the h row 4 times a step); a resident chunk
# takes 32 KB across the 8 warps as s8 (16 KB with 4 splits, whose warps
# take 14 chunks of 64 at H=1760 where 2 splits take 7), twice that as
# bf16.
VARIANTS: Dict[str, Dict[str, int]] = {
    "as_built": {},
    "cols2_ms2_res3": _loop(2, 2, 3),
    "cols2_ms2_res1_bf16": _loop(2, 2, 1, bf16=1),
    "cols2_ms2_streamed": _loop(2, 2, 0),
    "cols2_ms3_res1": _loop(2, 3, 1),
    "cols4_ms2_res8": _loop(4, 2, 8),
    "cols4_ms2_res4_bf16": _loop(4, 2, 4, bf16=1),
    "cols4_ms3_res5": _loop(4, 3, 5),
    "cols4_ms4_res2": _loop(4, 4, 2),
}

_WIDEN = ("  widen4(q.x, b[0], b[1]);\n  widen4(q.y, b[2], b[3]);\n"
          "  widen4(q.z, b[4], b[5]);\n  widen4(q.w, b[6], b[7]);\n")
_RAW = ("  b[0] = q.x; b[1] = q.y; b[2] = q.z; b[3] = q.w;\n"
        "  b[4] = q.x; b[5] = q.y; b[6] = q.z; b[7] = q.w;\n")


def _source_text() -> str:
    with open(os.path.join(_build.CSRC_DIR, f"{SOURCE}.cu")) as f:
        return f.read()


def built_value(text: str, name: str) -> int:
    """The value of ``constexpr int <name> = v;``, which the source text
    must hold exactly once."""
    found = re.findall(rf"^constexpr int {name} = (\d+);", text, re.M)
    if len(found) != 1:
        raise RuntimeError(f"the source holds {name} {len(found)} times")
    return int(found[0])


def substitutions(text: str, values: Dict[str, int]
                  ) -> List[Tuple[str, str]]:
    """The text substitutions that set the named constants of ``text``."""
    subs = []
    for name, v in values.items():
        built = built_value(text, name)
        if v != built:
            subs.append((f"constexpr int {name} = {built};",
                         f"constexpr int {name} = {v};"))
    return subs


def _inputs(gen, t: int = 850, b: int = 32, h: int = 1760):
    """``lstm_fwd_q``'s arguments at ds2_full's shape: W quantized per
    output column by its absmax, as utils/quantize.py does."""
    dev = "cuda"
    lens = torch.randint(t // 3, t + 1, (b,), generator=gen, device=dev)
    lens[0] = t
    mask = (torch.arange(t, device=dev)[:, None] < lens[None, :]).float()
    xp = torch.randn(t, b, 4 * h, generator=gen, device=dev).bfloat16()
    w = torch.randn(2, h, 4 * h, generator=gen, device=dev) / math.sqrt(h)
    scale = w.abs().amax(1) / 127.0
    q = torch.clamp(torch.round(w / scale[:, None]), -127, 127)
    bias = torch.randn(2, 4 * h, generator=gen, device=dev) * 0.1
    return (xp, mask, q.to(torch.int8).contiguous(), scale.contiguous(),
            bias, (False, True))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="deepspeech_tpu_torch.k17_variants")
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--parent", default="",
                        help="another tree's csrc/lstm_fwd_q_stream.cu, "
                        "timed in turns beside these")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k17_variants measures the card: no CUDA device")
    text = _source_text()
    builds = {n: substitutions(text, v) for n, v in VARIANTS.items()}
    builds["no_widening"] = [(_WIDEN, _RAW)]
    copies = {"parent": args.parent} if args.parent else {}
    libs, ptxas = build_variants(SOURCE, builds, "k17_variants", copies)
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = _inputs(gen)
    ref = lstm.lstm_fwd_q_plain(*inputs)
    checks = {}
    for name, lib in libs.items():
        if name == "no_widening":
            continue
        _build._loaded[SOURCE] = lib
        ys = lstm.lstm_fwd_q_stream(*inputs)
        again = lstm.lstm_fwd_q_stream(*inputs)
        err = float((ys - ref).abs().max())
        if err > 3e-2 or not torch.equal(ys, again):
            raise RuntimeError(f"variant {name}: max |kernel - plain| {err}, "
                               f"bit-identical {torch.equal(ys, again)}")
        checks[name] = err
        del ys, again
    names = [*copies, *VARIANTS, "no_widening"]
    runs: Dict[str, list] = {n: [] for n in names}
    for name in names + names[::-1]:
        _build._loaded[SOURCE] = libs[name]
        runs[name].append({
            "ms": _time_ms(lambda: lstm.lstm_fwd_q_stream(*inputs),
                           args.reps),
            "kernels_ms": _split_ms(lambda: lstm.lstm_fwd_q_stream(*inputs),
                                    SOURCE)})
    _build._loaded[SOURCE] = libs["as_built"]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.splitlines()[0]
    print(json.dumps({"card": card, "shape": {"D": 2, "T": 850, "B": 32,
                                              "H": 1760, "dtype": "bfloat16",
                                              "w_dtype": "int8"},
                      "built": {n: built_value(text, n) for n in
                                ("NW_N", "MS", "W_RES", "RES_BF16")},
                      "max_abs_err": checks, "ptxas": ptxas,
                      "variants": runs}))


if __name__ == "__main__":
    main()
