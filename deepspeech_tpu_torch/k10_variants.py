"""Variants of the int8 GRU forward's tensor-core loop (K10 and K11),
timed in turns on the card, beside an earlier tree's kernel when its
source is given.

The loop is ``csrc/gru_fwd_q_mma.cuh``'s; ``csrc/gru_fwd_q.cu`` (K10)
and ``csrc/gru_fwd_q_stream.cu`` (K11) each set its constants: the split
of the 8 warps over a group's 96 gate columns (``NW_N``), the stages of
the rings (``MS``) and the most chunks of a warp's Q^T slice held
resident for the call (``Q_RES``; the launch holds fewer where they do
not fit a block's shared memory beside the rings, ``plan``). This script
builds copies of one of the two sources (``--source``), each made by a
text substitution of those constants, and with ``--parent=PATH`` that
file too (another tree's source of the same name) as it is; a source
without the tensor-core loop takes no scratch and is called with its own
arguments. Each build is held to ``gru_fwd_q_plain`` at ds2_full's shape
(D=2, T'=850, B=32, H=1760, bf16 dots, int8 W, ragged lengths, with an
h0; tolerance 3e-2, the same bits twice, ``ys`` and ``hfin``), then
timed with CUDA events there without h0, as the model calls it, two
turns each in the order parent, as built, the others, and then
reversed, with one call split by kernel (the transpose of Q, the loop)
by ``torch.profiler``. Prints ptxas's registers and spills of each loop,
the chunks each holds resident at that shape, and one JSON line with the
card's name and power limit.

With ``--ablate`` it also times the source with parts of its loop taken
out (``ABLATIONS``).

``python -m deepspeech_tpu_torch.k10_variants [--source=gru_fwd_q]
[--reps=3] [--parent=PATH] [--ablate]``
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
from typing import Dict, List, Tuple

import torch

from .k14_variants import build_variants
from .k15_ablation import _split_ms, _time_ms
from .k17_variants import built_value, substitutions
from .ops import _build, gru

SOURCES = ("gru_fwd_q", "gru_fwd_q_stream")
HEADER = "gru_fwd_q_mma.cuh"
CONSTANTS = ("NW_N", "MS", "Q_RES")
# An H100's shared memory a block may opt into, and its SMs.
SMEM_OPTIN = 232448
SMS = 132


def _loop(cols: int, ms: int, res: int) -> Dict[str, int]:
    return dict(NW_N=cols, MS=ms, Q_RES=res)


# Loop constants of each variant, beside the source as built. At
# ds2_full (28 chunks of 64 over the depth) 2 column splits give a warp 7
# chunks of 3 KB (24 KB a chunk across the 8 warps), 4 splits 14 of 1.5
# KB, 1 split 3-4 of 6 KB; the h rings take MS x 16 KB, the partial sums
# 52 KB (26 with 4 splits, 104 with 1), the rings of streamed chunks MS x
# 24 KB. ``plan`` gives what each holds.
VARIANTS: Dict[str, Dict[str, Dict[str, int]]] = {
    "gru_fwd_q": {
        "as_built": {},
        "cols2_ms3": _loop(2, 3, 16),
        "cols2_ms2_res4": _loop(2, 2, 4),
        "cols2_ms2_streamed": _loop(2, 2, 0),
        "cols4_ms2": _loop(4, 2, 16),
        "cols4_ms3": _loop(4, 3, 16),
        "cols4_ms4": _loop(4, 4, 16),
        "cols4_ms6": _loop(4, 6, 16),
        "cols1_ms2": _loop(1, 2, 16),
    },
    "gru_fwd_q_stream": {
        "as_built": {},
        "cols2_ms2_res4": _loop(2, 2, 4),
        "cols2_ms2_res2": _loop(2, 2, 2),
        "cols2_ms2_streamed": _loop(2, 2, 0),
        "cols2_ms3_res4": _loop(2, 3, 4),
        "cols2_ms3_streamed": _loop(2, 3, 0),
        "cols4_ms2_res8": _loop(4, 2, 8),
        "cols4_ms4_res8": _loop(4, 4, 8),
        "cols4_ms6_res6": _loop(4, 6, 6),
    },
}


# Ablations, each a text substitution of the header (pasted into a copy
# of the source in place of its #include), timed beside the source as
# built: what a part of the step costs is the time it saves when taken
# out. Their outputs are wrong by design and are not checked.
# no_widening passes the biased s8 bytes to the tensor cores as they lie;
# no_tensor_cores replaces each mma.sync by a few integer ops on its
# operands (so the loads and the widening stay); no_grid_barrier replaces
# the step's grid barrier by a block barrier; no_h_copies issues no copy
# of the h row (the ring keeps what it held); no_gate_math takes the
# update's sigmoid and tanh out; one_chunk gives each warp one chunk of
# the depth a step (the chain of its 7 at ds2_full cut to 1).
_WIDEN = ("  widen4(q.x, b[0], b[1]);\n  widen4(q.y, b[2], b[3]);\n"
          "  widen4(q.z, b[4], b[5]);\n  widen4(q.w, b[6], b[7]);\n")
_RAW = ("  b[0] = q.x; b[1] = q.y; b[2] = q.z; b[3] = q.w;\n"
        "  b[4] = q.x; b[5] = q.y; b[6] = q.z; b[7] = q.w;\n")
_MMA = ('  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "\n'
        '      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\\n"\n'
        '      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])\n'
        '      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));\n')
_NO_MMA = ("  c[0] += __uint_as_float((a0 ^ a1 ^ a2 ^ a3 ^ b0 ^ b1) & "
           "0xFFFFu);\n")
ABLATIONS: Dict[str, List[Tuple[str, str]]] = {
    "no_widening": [(_WIDEN, _RAW)],
    "no_tensor_cores": [(_MMA, _NO_MMA)],
    "no_grid_barrier": [("    grid.sync();\n  }\n}",
                         "    __syncthreads();\n  }\n}")],
    "no_h_copies": [("                cp_async16(hs + p * 32 + lane,",
                     "                if (0) cp_async16(hs + p * 32 + lane,")],
    "no_gate_math": [("  return 1.f / (1.f + expf(-x));",
                      "  return x;"),
                     ("const float n = tanhf(bf16_bits_f32",
                      "const float n = (bf16_bits_f32")],
    "one_chunk": [("  const int n_mine = (n_chunks - kw + NW_K - 1) / NW_K;",
                   "  const int n_mine = kw < n_chunks;")],
}


def ablation(text: str, header_subs: List[Tuple[str, str]]
             ) -> List[Tuple[str, str]]:
    """The substitution of ``text`` (a source) that pastes the header in
    place of its ``#include``, with ``header_subs`` made in it."""
    head = header_text()
    for old, new in header_subs:
        if head.count(old) != 1:
            raise RuntimeError(f"the header no longer has {old!r}")
        head = head.replace(old, new)
    return [(f'#include "{HEADER}"\n', head)]


def source_text(source: str) -> str:
    with open(os.path.join(_build.CSRC_DIR, f"{source}.cu")) as f:
        return f.read()


def header_text() -> str:
    with open(os.path.join(_build.CSRC_DIR, HEADER)) as f:
        return f.read()


def plan(values: Dict[str, int], d: int, h: int,
         smem_optin: int = SMEM_OPTIN, sms: int = SMS) -> Tuple[int, int]:
    """``(resident chunks a warp, shared memory bytes of a block)`` that
    ``gru_q_mma::plan_res`` chooses for a loop with these constants (NW_N,
    MS, Q_RES) at D directions of H units, on a card with these limits:
    as many chunks as ``Q_RES`` allows and fit beside the rings, none
    where the groups outnumber the SMs (the loop takes one block an SM
    whenever it holds a chunk). The header's sizes, read from it."""
    text = header_text()
    mu, mkc, warps, rows, hp = (built_value(text, n) for n in
                                ("MU", "MKC", "M_WARPS", "MROWS", "HP"))
    nw_n, ms, q_res = (values[n] for n in CONSTANTS)
    nw_k, nt = warps // nw_n, 3 * mu // nw_n // 8
    h_ring = nw_k * ms * hp * 32  # uint4
    q_ring = warps * ms * nt * 32
    red = -(-nw_k * rows * (3 * mu + 8) // 4)
    n_chunks = -(-h // mkc)
    most = -(-n_chunks // nw_k)

    def smem(r: int) -> int:
        rings = max(h_ring + (q_ring if r < most else 0), red)
        return 16 * (rings + r * warps * nt * 32)

    r = min(most, q_res)
    while r > 0 and smem(r) > smem_optin:
        r -= 1
    if d * -(-h // mu) > sms:
        r = 0
    return r, smem(r)


def _inputs(gen, h0: bool, t: int = 850, b: int = 32, h: int = 1760):
    """``gru_fwd_q``'s arguments at ds2_full's shape: W quantized per
    output column by its absmax, as utils/quantize.py does."""
    dev = "cuda"
    lens = torch.randint(t // 3, t + 1, (b,), generator=gen, device=dev)
    lens[0] = t
    mask = (torch.arange(t, device=dev)[:, None] < lens[None, :]).float()
    xp = torch.randn(t, b, 3 * h, generator=gen, device=dev).bfloat16()
    w = torch.randn(2, h, 3 * h, generator=gen, device=dev) / math.sqrt(h)
    scale = w.abs().amax(1) / 127.0
    q = torch.clamp(torch.round(w / scale[:, None]), -127, 127)
    bias = torch.randn(2, 3 * h, generator=gen, device=dev) * 0.1
    hh = torch.randn(2, b, h, generator=gen, device=dev) * 0.5 if h0 else None
    return (xp, mask, q.to(torch.int8).contiguous(), scale.contiguous(),
            bias, hh, (False, True))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="deepspeech_tpu_torch.k10_variants")
    parser.add_argument("--source", choices=SOURCES, default="gru_fwd_q")
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--parent", default="",
                        help="another tree's csrc/<source>.cu, timed in "
                        "turns beside these")
    parser.add_argument("--ablate", action="store_true",
                        help="also time the source with parts of its loop "
                        "taken out (ABLATIONS)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k10_variants measures the card: no CUDA device")
    source, variants = args.source, VARIANTS[args.source]
    text = source_text(source)
    built = {n: built_value(text, n) for n in CONSTANTS}
    builds = {n: substitutions(text, v) for n, v in variants.items()}
    ablations = ABLATIONS if args.ablate else {}
    builds.update({n: ablation(text, subs) for n, subs in ablations.items()})
    copies = {"parent": args.parent} if args.parent else {}
    libs, ptxas = build_variants(source, builds, f"k10_variants_{source}",
                                 copies)
    fn = getattr(gru, source)
    calls = {name: fn for name in libs}
    if args.parent:
        with open(args.parent) as f:
            if "scratch" not in f.read():
                def parent_call(xp, mask, wq, scale, b, h0, reverse):
                    ys, hfin = gru._fwd_outputs(xp, wq, h0)
                    gru._launch(source, xp, mask, wq, (scale, b, h0, ys, hfin),
                                reverse)
                    return ys, hfin
                calls["parent"] = parent_call
    gen = torch.Generator(device="cuda").manual_seed(0)
    check, timed = _inputs(gen, h0=True), _inputs(gen, h0=False)
    ref = gru.gru_fwd_q_plain(*check)
    checks = {}
    for name, lib in libs.items():
        if name in ablations:
            continue
        _build._loaded[source] = lib
        got, again = calls[name](*check), calls[name](*check)
        err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        same = all(torch.equal(g, a) for g, a in zip(got, again))
        if err > 3e-2 or not same:
            raise RuntimeError(f"variant {name}: max |kernel - plain| {err}, "
                               f"bit-identical {same}")
        checks[name] = err
        del got, again
    names = [*copies, *variants, *ablations]
    runs: Dict[str, list] = {n: [] for n in names}
    for name in names + names[::-1]:
        _build._loaded[source] = libs[name]
        call = calls[name]
        runs[name].append({
            "ms": _time_ms(lambda: call(*timed), args.reps),
            "kernels_ms": _split_ms(lambda: call(*timed), source)})
    _build._loaded[source] = libs["as_built"]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.splitlines()[0]
    resident = {n: plan({**built, **v}, 2, 1760) for n, v in variants.items()}
    print(json.dumps({"card": card, "source": source,
                      "shape": {"D": 2, "T": 850, "B": 32, "H": 1760,
                                "dtype": "bfloat16", "w_dtype": "int8"},
                      "built": built, "resident_chunks_smem": resident,
                      "max_abs_err": checks, "ptxas": ptxas,
                      "variants": runs}))


if __name__ == "__main__":
    main()
