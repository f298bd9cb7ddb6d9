"""Variants of the resident int8 LSTM forward's tensor-core loop (K16 at
D=2 and D=1), timed in turns on the card, beside an earlier tree's
kernels when given.

With bf16 dots and H % 8 == 0 ``csrc/lstm_fwd_q.cu`` runs
``csrc/lstm_fwd_mma.cuh``'s widening transpose (``bf16(Q^T)``, exact)
and K12's loop with all of it resident and the scale on the finished
sums (``SCALED``); it sets the loop's constants as ``csrc/lstm_fwd.cu``
does, ``MU_NARROW`` units and ``MS_NARROW`` stages where D x
ceil(H/MU_NARROW) groups get an SM each, else ``MU_WIDE`` and
``MS_WIDE`` (``k12_variants.plan``). This script builds copies of
``csrc/lstm_fwd_q.cu``, each made by a text substitution of those
constants (``VARIANTS``), and with ``--parent=PATH`` (another tree's
``deepspeech_tpu_torch/csrc`` directory) that tree's ``lstm_fwd_q.cu``
as it is (one without the tensor-core path takes no scratch and is
called with its own arguments). Each K16 build is held to
``lstm_fwd_q_plain`` at ds2_small-lstm's int8 shape (D=2, T'=850, B=32,
H=800, bf16 dots, ragged lengths, W quantized per output column) and at
ds2_streaming-lstm's (D=1), ``ys`` within ``TOL`` and the same bits
twice, then timed with CUDA events at both D, two turns each in the
order parent, as built, the others, cuDNN's LSTM, and then reversed,
with one call split by kernel (the transpose, the loop) by
``torch.profiler``.

With a parent, the header's other two users must give the parent's
bits, with and without the tape, and are timed in turns
(``k12_variants.held_to_parent``): K12 (``lstm_fwd.cu``) at H=800, D=2
and D=1, and K14 (``lstm_fwd_stream.cu``) at H=1760 and 800 (D=2), timed
at 1760. And at D=1, H=1280, which the bf16 rule now sends to the
streamed K17 (``lstm_fwd_q_stream.cu``) where the parent ran its
CUDA-core K16, the two are held to ``lstm_fwd_q_plain`` and timed in
turns.

With ``--ablate`` it also times the source with parts of its loop taken
out (``ABLATIONS``: k12_variants' four and the scale) and holds each to
the same comparison: those in ``MUST_FAIL`` must miss ``TOL``, which
shows that the comparison would see such a fault.

Prints ptxas's registers and spills of each loop, each variant's plan at
both D, and one JSON line with the card's name and power limit.

``python -m deepspeech_tpu_torch.k16_variants [--reps=3] [--parent=PATH]
[--ablate]``
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
from typing import Dict, List, Tuple

import torch

from . import k12_variants
from .k14_variants import build_variants
from .k15_ablation import _split_ms, _time_ms
from .k17_variants import built_value, substitutions
from .k7_variants import _err, _same
from .ops import _build, gru, lstm

SOURCE = "lstm_fwd_q"
CONSTANTS = k12_variants.CONSTANTS
# The limit of max |kernel - plain| of ys on these inputs, chip_smoke.py's
# LSTM_FWD_Q_TOL; the output prints max |plain| beside it.
TOL = 1e-2
# The shape off the bf16 rule that runs K17 here and ran K16 in the
# parent: (D, H).
MOVED = (1, 1280)

# Loop constants of each variant, beside the source as built:
# k12_variants' widths and ring depths.
VARIANTS: Dict[str, Dict[str, int]] = dict(k12_variants.VARIANTS)

# Ablations, each a text substitution of the header pasted into a copy of
# the source (k12_variants.ablation): k12_variants' (the loop K12 and K16
# share) and no_scale, which leaves the finished sums unscaled; those of
# MUST_FAIL must miss TOL.
ABLATIONS: Dict[str, List[Tuple[str, str]]] = {
    **k12_variants.ABLATIONS,
    "no_scale": [("sum[e] *= sc[e];", "sum[e] *= 1.f;")],
}
MUST_FAIL = (*k12_variants.MUST_FAIL, "no_scale")


def source_text() -> str:
    with open(os.path.join(_build.CSRC_DIR, f"{SOURCE}.cu")) as f:
        return f.read()


def _inputs(gen, d: int, t: int = 850, b: int = 32, h: int = 800):
    """``lstm_fwd_q``'s arguments: k12_variants' bf16 inputs with W
    quantized per output column by its absmax, as utils/quantize.py
    does."""
    xp, mask, w, bias, reverse = k12_variants._inputs(gen, d, t, b, h)
    scale = w.float().abs().amax(1) / 127.0
    q = torch.clamp(torch.round(w.float() / scale[:, None]), -127, 127)
    return (xp, mask, q.to(torch.int8).contiguous(), scale.contiguous(),
            bias, reverse)


def _parent_call(xp, mask, q, scale, b, reverse):
    """``lstm_fwd_q`` through a source whose C entry point takes no
    scratch (the CUDA-core kernel alone)."""
    ys, _ = lstm._outputs(xp, q, False)
    gru._launch(SOURCE, xp, mask, q, (scale, b, ys), reverse)
    return ys


def _moved(parent_lib, parent_call, reps: int, gen) -> dict:
    """At ``MOVED``: the parent's K16 (``parent_call`` on
    ``parent_lib``) and this tree's K17, each within ``TOL`` of
    ``lstm_fwd_q_plain``, and ms a call in turns (parent, this tree,
    this tree, parent)."""
    d, h = MOVED
    if gru.resident_fits(SOURCE, d, h, 32, torch.bfloat16):
        raise RuntimeError(f"D={d}, H={h} is inside the bf16 rule")
    args = _inputs(gen, d, h=h)
    ref = lstm.lstm_fwd_q_plain(*args)
    calls = {"parent": parent_call, "as_built": lstm.lstm_fwd_q_stream}
    out = {"D": d, "H": h, "max_abs_err": {}, "ms": {n: [] for n in calls}}
    _build._loaded[SOURCE] = parent_lib
    for name, call in calls.items():
        err = float((call(*args) - ref).abs().max())
        if err > TOL:
            raise RuntimeError(f"{name} at D={d}, H={h}: max |kernel - "
                               f"plain| {err} > {TOL}")
        out["max_abs_err"][name] = err
    for name in ("parent", "as_built", "as_built", "parent"):
        out["ms"][name].append(_time_ms(lambda: calls[name](*args), reps))
    out["ms_ratio"] = sum(out["ms"]["as_built"]) / sum(out["ms"]["parent"])
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="deepspeech_tpu_torch.k16_variants")
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--parent", default="",
                        help="another tree's deepspeech_tpu_torch/csrc "
                        "directory: its lstm_fwd_q.cu, lstm_fwd.cu and "
                        "lstm_fwd_stream.cu are held and timed beside "
                        "these")
    parser.add_argument("--ablate", action="store_true",
                        help="also time the source with parts of its loop "
                        "taken out (ABLATIONS)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k16_variants measures the card: no CUDA device")
    text = source_text()
    built = {n: built_value(text, n) for n in CONSTANTS}
    builds = {n: substitutions(text, v) for n, v in VARIANTS.items()}
    ablations = ABLATIONS if args.ablate else {}
    builds.update({n: k12_variants.ablation(subs)
                   for n, subs in ablations.items()})
    copies = ({"parent": os.path.join(args.parent, f"{SOURCE}.cu")}
              if args.parent else {})
    libs, ptxas = build_variants(SOURCE, builds, "k16_variants", copies)
    calls = {name: lstm.lstm_fwd_q for name in libs}
    if args.parent:
        with open(copies["parent"]) as f:
            if "scratch" not in f.read():
                calls["parent"] = _parent_call
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = {d: _inputs(gen, d) for d in (2, 1)}
    refs = {d: lstm.lstm_fwd_q_plain(*inputs[d]) for d in (2, 1)}
    plain_max = {f"D{d}": float(refs[d].abs().max()) for d in (2, 1)}
    checks = {}
    for name, lib in libs.items():
        _build._loaded[SOURCE] = lib
        for d, ref in refs.items():
            got, again = ((calls[name](*inputs[d]),) for _ in range(2))
            err = _err(got, (ref,))
            key = f"{name}[D={d}]"
            checks[key] = err
            if name in ablations:
                if name in MUST_FAIL and err <= TOL:
                    raise RuntimeError(
                        f"ablation {key}: max |kernel - plain| {err} <= "
                        f"{TOL}: the comparison cannot see it")
                continue
            same = _same(got, again)
            if err > TOL or not same:
                raise RuntimeError(f"variant {key}: max |kernel - plain| "
                                   f"{err}, bit-identical {same}")
            del got, again
    del refs
    names = [*copies, *VARIANTS, *ablations, "cudnn"]
    calls["cudnn"] = {d: k12_variants._cudnn_call(gen, d) for d in (2, 1)}
    runs: Dict[str, list] = {n: [] for n in names}
    for name in names + names[::-1]:
        turn = {}
        for d in (2, 1):
            if name == "cudnn":
                turn[f"D{d}"] = {"ms": _time_ms(calls[name][d], args.reps)}
                continue
            _build._loaded[SOURCE] = libs[name]
            call = calls[name]
            turn[f"D{d}"] = {
                "ms": _time_ms(lambda: call(*inputs[d]), args.reps),
                "kernels_ms": _split_ms(lambda: call(*inputs[d]), SOURCE)}
        runs[name].append(turn)
    parent_call = calls.get("parent")
    del inputs, calls
    parent = {}
    if args.parent:
        parent["moved"] = _moved(libs["parent"], parent_call, args.reps, gen)
        parent["k12"] = k12_variants.held_to_parent(
            "lstm_fwd", args.parent, [(2, 800), (1, 800)],
            [(2, 800), (1, 800)], args.reps, gen)
        parent["k14"] = k12_variants.held_to_parent(
            "lstm_fwd_stream", args.parent, [(2, 1760), (2, 800)],
            [(2, 1760)], args.reps, gen)
    _build._loaded[SOURCE] = libs["as_built"]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.splitlines()[0]
    plans = {n: {f"D{d}": k12_variants.plan({**built, **v}, d, 800)
                 for d in (2, 1)} for n, v in VARIANTS.items()}
    print(json.dumps({"card": card,
                      "shape": {"T": 850, "B": 32, "H": 800,
                                "dtype": "bfloat16", "w_dtype": "int8"},
                      "built": built, "plan": plans, "tol": TOL,
                      "max_abs_plain": plain_max, "max_abs_err": checks,
                      "ptxas": ptxas, "variants": runs, **parent}))


if __name__ == "__main__":
    main()
