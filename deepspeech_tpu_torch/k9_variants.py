"""Variants of the streamed GRU backward's tensor-core loop (K9), timed
in turns on the card, beside an earlier tree's kernel when its source is
given.

Builds copies of ``csrc/gru_bwd_stream.cu``, each made by a text
substitution of the loop's constants: the stages of a warp's ring
(``MS``) and how many of a warp's chunks of W stay resident in shared
memory for the whole call (``W_RES``). With ``--parent=PATH`` it also
builds that file (another tree's ``gru_bwd_stream.cu``, with the same C
entry points) as it is. Each build is held to ``gru_bwd_plain`` at
ds2_full's shape (D=2, T'=850, B=32, H=1760, bf16; tolerance 3e-2, the
same bits twice), then timed with CUDA events there, two turns each in
the order parent, as built, the others, and then reversed, with one call
split by kernel (the gate pre-pass, the loop) by ``torch.profiler``.
Prints ptxas's registers and spills of each loop and one JSON line with
the card's name and power limit.

``python -m deepspeech_tpu_torch.k9_variants [--reps=3] [--parent=PATH]``
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
from .k7_variants import parent_call
from .ops import _build, gru


def _loop(ms: int, res: int) -> List[Tuple[str, str]]:
    """The substitutions that give ``MS = ms`` stages and ``W_RES = res``
    resident chunks a warp."""
    return [_sub(n, built, v) for n, built, v in (
        ("MS", 2, ms), ("W_RES", 10, res)) if v != built]


# The source as built: 2 stages, 10 of a warp's 20 or 21 chunks of W
# resident (48%). Beside it every ring depth with the resident share the
# rest of the shared memory holds (3: 8 chunks, 39%; 4: 6, 29%), and all
# of W streamed (csrc/lstm_bwd_stream.cu's loop, 4 stages).
VARIANTS: Dict[str, List[Tuple[str, str]]] = {
    "as_built": [],
    "ms3_res8": _loop(3, 8),
    "ms4_res6": _loop(4, 6),
    "ms4_streamed": _loop(4, 0),
}


def _inputs(gen, t: int = 850, b: int = 32, h: int = 1760):
    dev = "cuda"
    lens = torch.randint(t // 3, t + 1, (b,), generator=gen, device=dev)
    lens[0] = t
    mask = (torch.arange(t, device=dev)[:, None] < lens[None, :]).float()
    xp = torch.randn(t, b, 3 * h, generator=gen, device=dev).bfloat16()
    w = (torch.randn(2, h, 3 * h, generator=gen, device=dev)
         / math.sqrt(h)).bfloat16()
    bias = torch.randn(2, 3 * h, generator=gen, device=dev) * 0.1
    reverse = (False, True)
    ys, _ = gru.gru_fwd(xp, mask, w, bias, None, reverse)
    dy = torch.randn(ys.shape, generator=gen, device=dev) * 0.1
    return xp, mask, w, bias, ys, dy, reverse


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="deepspeech_tpu_torch.k9_variants")
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--parent", default="",
                        help="another tree's csrc/gru_bwd_stream.cu, timed "
                        "in turns beside these")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k9_variants measures the card: no CUDA device")
    copies = {"parent": args.parent} if args.parent else {}
    libs, ptxas = build_variants("gru_bwd_stream", VARIANTS, "k9_variants",
                                 copies)
    calls = {name: gru.gru_bwd_stream for name in libs}
    if args.parent:
        calls["parent"] = parent_call("gru_bwd_stream", args.parent)
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = _inputs(gen)
    ref = gru.gru_bwd_plain(*inputs)
    checks = {}
    for name, lib in libs.items():
        _build._loaded["gru_bwd_stream"] = lib
        got, again = calls[name](*inputs), calls[name](*inputs)
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
        _build._loaded["gru_bwd_stream"] = libs[name]
        runs[name].append({
            "ms": _time_ms(lambda: calls[name](*inputs), args.reps),
            "kernels_ms": _split_ms(lambda: calls[name](*inputs),
                                    "gru_bwd_stream")})
    _build._loaded["gru_bwd_stream"] = libs["as_built"]
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
