"""Variants of the resident LSTM forward's tensor-core loop (K12 at D=2
and D=1), timed in turns on the card, beside an earlier tree's kernels
when given.

The loop is ``csrc/lstm_fwd_mma.cuh``'s with all of W^T resident;
``csrc/lstm_fwd.cu`` sets its constants: the group widths and the stages
of a warp's ring of h-row pieces, ``MU_NARROW`` units and ``MS_NARROW``
stages where D x ceil(H/MU_NARROW) groups get an SM each, else
``MU_WIDE`` and ``MS_WIDE`` (``plan``). This script builds copies of
``csrc/lstm_fwd.cu``, each made by a text substitution of those
constants (``VARIANTS``), and with ``--parent=PATH`` (another tree's
``deepspeech_tpu_torch/csrc`` directory) that tree's ``lstm_fwd.cu`` and
``lstm_fwd_stream.cu`` as they are (an older C entry, without the
carry or the scratch, is called with its own pointers: ``parent_call``).
Each K12 build is held to ``lstm_fwd_plain`` at
ds2_small-lstm's shape (D=2, T'=850, B=32, H=800, bf16, ragged lengths)
and at ds2_streaming-lstm's (D=1), with and without the cell-state tape,
``ys`` (and ``cs``) within ``TOL`` and the same bits twice, then timed
untaped with CUDA events at both D, two turns each in the order parent,
as built, the others, cuDNN's LSTM, and then reversed, with one call
split by kernel (the transpose of W, the loop) by ``torch.profiler``.
With a parent, K14 (this tree's ``lstm_fwd_stream.cu``, whose loop is
the header's with part of W^T streamed, and the parent's) must give the
parent's bits at ds2_full's H=1760 and at H=800 (D=2), with and without
the tape, and is timed in turns at H=1760. Prints ptxas's registers and
spills of each loop, each variant's plan at both D, and one JSON line
with the card's name and power limit.

With ``--ablate`` it also times the source with parts of its loop taken
out (``ABLATIONS``) and holds each to the same comparison: those in
``MUST_FAIL`` take out part of the product and must miss ``TOL``, which
shows that the comparison would see such a fault.

With ``--parent-only`` it runs only the parent's comparison, K12 and
K14 at the main path's shapes, each also timed with a carried ``(h0,
c0)``.

``python -m deepspeech_tpu_torch.k12_variants [--reps=3] [--parent=PATH]
[--ablate] [--parent-only]``
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
from .k4_variants import ABLATIONS, MUST_FAIL
from .k7_variants import _err, _same
from .ops import _build, gru, lstm

SOURCE = "lstm_fwd"
HEADER = "lstm_fwd_mma.cuh"
CONSTANTS = ("MU_NARROW", "MS_NARROW", "MU_WIDE", "MS_WIDE")
# The limit of max |kernel - plain| of ys and cs on these inputs,
# chip_smoke.py's LSTM_FWD_TOL; the output prints max |plain| beside it.
TOL = 1e-2
# An H100's shared memory a block may opt into, and its SMs.
SMEM_OPTIN = 232448
SMS = 132

# Loop constants of each variant, beside the source as built: the width
# at D=1 (16 units: 50 groups at H=800; at D=2 groups of 32 would need
# 268 KB a block at H=800, over what a block may have, and groups of 8
# 200 SMs) and the ring depths.
VARIANTS: Dict[str, Dict[str, int]] = {
    "as_built": {},
    "mu16": {"MU_NARROW": 16},
    "ms2": {"MS_NARROW": 2, "MS_WIDE": 2},
    "ms3": {"MS_NARROW": 3, "MS_WIDE": 3},
    "ms6": {"MS_NARROW": 6, "MS_WIDE": 6},
}

# Ablations, each a text substitution of the header (pasted into a copy
# of the source in place of its #include), timed beside the source as
# built, and those that must miss TOL: csrc/gru_fwd_mma.cuh's, whose loop
# this header's shares those lines with (see k4_variants).

def source_text() -> str:
    with open(os.path.join(_build.CSRC_DIR, f"{SOURCE}.cu")) as f:
        return f.read()


def header_text() -> str:
    with open(os.path.join(_build.CSRC_DIR, HEADER)) as f:
        return f.read()


def ablation(header_subs: List[Tuple[str, str]]) -> List[Tuple[str, str]]:
    """The substitution of ``csrc/lstm_fwd.cu`` that pastes the header in
    place of its ``#include``, with ``header_subs`` made in it."""
    head = header_text()
    for old, new in header_subs:
        if head.count(old) != 1:
            raise RuntimeError(f"the header no longer has {old!r}")
        head = head.replace(old, new)
    return [(f'#include "{HEADER}"\n', head)]


def plan(values: Dict[str, int], d: int, h: int,
         smem_optin: int = SMEM_OPTIN, sms: int = SMS
         ) -> Tuple[int, int, bool]:
    """``(group width, shared memory bytes of a block, whether it
    launches)`` of K12's tensor-core loop with these constants
    (``CONSTANTS``) at D directions of H units on a card with these
    limits, as ``launch_mma`` and ``lstm_fwd_mma::launch`` choose: the
    narrow width and its ring depth where D x ceil(H/MU_NARROW) groups fit
    one an SM, else the wide; it launches when the block's rings and W^T
    rows fit and every group has an SM. The header's sizes, read from it;
    a group of 32 units splits its columns over two warps, a narrower one
    gives them all to one (``Plan``'s ``NW_N``)."""
    head = header_text()
    warps, rows, kc, rowp = (built_value(head, n) for n in
                             ("M_WARPS", "MROWS", "MKC", "ROWP"))
    narrow, ms_narrow, wide, ms_wide = (values[n] for n in CONSTANTS)
    mu, ms = ((narrow, ms_narrow) if d * -(-h // narrow) <= sms
              else (wide, ms_wide))
    nw_n = 1 if mu < 32 else 2
    gcol = 4 * mu
    red_s = gcol + 8 + (8 if (gcol + 8) % 16 == 0 else 0)
    ring = warps * ms * rowp * 32                   # uint4
    red = warps // nw_n * rows * red_s // 4
    held = -(-h // kc) * (gcol // 8) * 32
    smem = 16 * (max(ring, red) + held)
    return mu, smem, smem <= smem_optin and d * -(-h // mu) <= sms


def _inputs(gen, d: int, t: int = 850, b: int = 32, h: int = 800):
    """``lstm_fwd``'s arguments: bf16, ragged lengths."""
    dev = "cuda"
    lens = torch.randint(t // 3, t + 1, (b,), generator=gen, device=dev)
    lens[0] = t
    mask = (torch.arange(t, device=dev)[:, None] < lens[None, :]).float()
    xp = torch.randn(t, b, 4 * h, generator=gen, device=dev).bfloat16()
    w = (torch.randn(d, h, 4 * h, generator=gen, device=dev)
         / math.sqrt(h)).bfloat16()
    bias = torch.randn(d, 4 * h, generator=gen, device=dev) * 0.1
    return xp, mask, w, bias, (False, True)[:d]


def _outputs(got, tape: bool):
    return got if tape else (got,)


def parent_call(source: str, path: str):
    """The call of another tree's ``csrc/<source>.cu`` (``path``) on the
    arguments ``lstm.<source>`` takes: that wrapper itself where the
    tree's ``<source>_launch`` takes a carry, as this tree's does, else a
    launch with the pointers its older C entry takes, ``(bias, ys, cs)``
    and a scratch where it has one (``lstm._fwd_scratch`` or
    ``lstm._fwd_stream_scratch``)."""
    with open(path) as f:
        text = f.read()
    entry = text[text.index(f"int {source}_launch("):]
    entry = entry[:entry.index(")")]
    if "h0" in entry:
        return getattr(lstm, source)
    scratch = (lstm._fwd_scratch if source == "lstm_fwd"
               else lstm._fwd_stream_scratch)

    def call(xp, mask, w, b, reverse, tape=False):
        ys, cs = lstm._outputs(xp, w, tape)
        ptrs = (b, ys, cs) + ((scratch(xp, w),) if "scratch" in entry
                              else ())
        gru._launch(source, xp, mask, w, ptrs, reverse)
        return (ys, cs) if tape else ys
    return call


def _cudnn_call(gen, d: int, h: int = 800, t: int = 850, b: int = 32):
    """cuDNN's bf16 LSTM at the same width and D, on its own input: the
    library's time for the same recurrence."""
    lib = torch.nn.LSTM(h, h, bidirectional=d == 2).to("cuda",
                                                       torch.bfloat16)
    lib.flatten_parameters()
    x = torch.randn(t, b, h, generator=gen, device="cuda").bfloat16()

    def call(*_):
        with torch.no_grad():
            return lib(x)
    return call


def held_to_parent(source: str, parent: str, shapes, timed, reps: int,
                   gen) -> dict:
    """``csrc/<source>.cu`` (``lstm_fwd``: K12, or ``lstm_fwd_stream``:
    K14) as built here and the parent tree's: the same bits at each
    ``(D, H)`` of ``shapes``, with and without the tape, and ms a call
    untaped at each ``(D, H)`` of ``timed`` in turns (parent, this tree,
    this tree, parent), and this tree's with a random carried ``(h0,
    c0)`` and the final state out (``carry``) in the same turns. Raises
    if any bit differs."""
    path = os.path.join(parent, f"{source}.cu")
    libs, ptxas = build_variants(source, {"as_built": []},
                                 f"parent_{source}", {"parent": path})
    calls = {"parent": parent_call(source, path),
             "as_built": getattr(lstm, source)}
    out = {"ptxas": ptxas, "same_bits": {}, "ms": {}, "ms_ratio": {},
           "carry_ms_ratio": {}}
    for d, h in shapes:
        args = _inputs(gen, d, h=h)
        for tape in (False, True):
            got = {}
            for name in ("parent", "as_built"):
                _build._loaded[source] = libs[name]
                got[name] = _outputs(calls[name](*args, tape=tape), tape)
            out["same_bits"][f"D{d}_H{h}{'_tape' if tape else ''}"] = _same(
                got["parent"], got["as_built"])
            del got
        del args
    for d, h in timed:
        args = _inputs(gen, d, h=h)
        hc0 = tuple(torch.randn(d, args[0].shape[1], h, generator=gen,
                                device="cuda") * 0.5 for _ in range(2))
        calls["carry"] = lambda *a: getattr(lstm, source)(
            *a, hc0=hc0, return_final=True)
        libs["carry"] = libs["as_built"]
        ms = {"parent": [], "as_built": [], "carry": []}
        for name in ("parent", "as_built", "carry", "carry", "as_built",
                     "parent"):
            _build._loaded[source] = libs[name]
            ms[name].append(_time_ms(lambda: calls[name](*args), reps))
        out["ms"][f"D{d}_H{h}"] = ms
        out["ms_ratio"][f"D{d}_H{h}"] = sum(ms["as_built"]) / sum(
            ms["parent"])
        out["carry_ms_ratio"][f"D{d}_H{h}"] = sum(ms["carry"]) / sum(
            ms["parent"])
        del args
    _build._loaded[source] = libs["as_built"]
    if not all(out["same_bits"].values()):
        raise RuntimeError(f"{source} differs from the parent's: {out}")
    return out


def _k14(parent: str, reps: int, gen) -> dict:
    """K14 held to the parent's at H=1760 and at H=800 (D=2), timed at
    H=1760."""
    return held_to_parent("lstm_fwd_stream", parent, [(2, 1760), (2, 800)],
                          [(2, 1760)], reps, gen)


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.splitlines()[0]


def _parent_only(parent: str, reps: int) -> None:
    """K12 at ds2_small-lstm's and ds2_streaming-lstm's shapes (H=800,
    D=2 and D=1) and K14 at ds2_full-lstm's (H=1760, D=2) and the
    sequence-parallel relay's (D=1), and at H=800, held to the parent's
    bits and timed in turns; one JSON line."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    k12 = held_to_parent("lstm_fwd", parent, [(2, 800), (1, 800)],
                         [(2, 800), (1, 800)], reps, gen)
    k14 = held_to_parent("lstm_fwd_stream", parent,
                         [(2, 1760), (1, 1760), (2, 800)],
                         [(2, 1760), (1, 1760)], reps, gen)
    print(json.dumps({"card": _card(), "shape": {"T": 850, "B": 32,
                                                 "dtype": "bfloat16"},
                      "k12": k12, "k14": k14}))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="deepspeech_tpu_torch.k12_variants")
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--parent", default="",
                        help="another tree's deepspeech_tpu_torch/csrc "
                        "directory: its lstm_fwd.cu and lstm_fwd_stream.cu "
                        "are timed in turns beside these")
    parser.add_argument("--ablate", action="store_true",
                        help="also time the source with parts of its loop "
                        "taken out (ABLATIONS)")
    parser.add_argument("--parent-only", action="store_true",
                        help="with --parent, only hold K12 and K14 to the "
                        "parent's at the main path's shapes and time them "
                        "in turns, with and without a carry")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k12_variants measures the card: no CUDA device")
    if args.parent_only:
        if not args.parent:
            raise SystemExit("--parent-only needs --parent")
        _parent_only(args.parent, args.reps)
        return
    text = source_text()
    built = {n: built_value(text, n) for n in CONSTANTS}
    builds = {n: substitutions(text, v) for n, v in VARIANTS.items()}
    ablations = ABLATIONS if args.ablate else {}
    builds.update({n: ablation(subs) for n, subs in ablations.items()})
    copies = ({"parent": os.path.join(args.parent, f"{SOURCE}.cu")}
              if args.parent else {})
    libs, ptxas = build_variants(SOURCE, builds, "k12_variants", copies)
    calls = {name: lstm.lstm_fwd for name in libs}
    if args.parent:
        calls["parent"] = parent_call(SOURCE, copies["parent"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = {d: _inputs(gen, d) for d in (2, 1)}
    refs = {(d, tape): _outputs(lstm.lstm_fwd_plain(*inputs[d], tape=tape),
                                tape)
            for d in (2, 1) for tape in (False, True)}
    plain_max = {f"D{d}": float(refs[d, False][0].abs().max())
                 for d in (2, 1)}
    checks = {}
    for name, lib in libs.items():
        _build._loaded[SOURCE] = lib
        for (d, tape), ref in refs.items():
            call = calls[name]
            got, again = (_outputs(call(*inputs[d], tape=tape), tape)
                          for _ in range(2))
            err = _err(got, ref)
            key = f"{name}[D={d}{',tape' if tape else ''}]"
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
    calls["cudnn"] = {d: _cudnn_call(gen, d) for d in (2, 1)}
    runs: Dict[str, list] = {n: [] for n in names}
    for name in names + names[::-1]:
        turn = {}
        for d in (2, 1):
            if name == "cudnn":
                call = calls[name][d]
                turn[f"D{d}"] = {"ms": _time_ms(call, args.reps)}
                continue
            _build._loaded[SOURCE] = libs[name]
            call = calls[name]
            turn[f"D{d}"] = {
                "ms": _time_ms(lambda: call(*inputs[d]), args.reps),
                "kernels_ms": _split_ms(lambda: call(*inputs[d]), SOURCE)}
        runs[name].append(turn)
    _build._loaded[SOURCE] = libs["as_built"]
    tape_ms = {f"D{d}": _time_ms(lambda: lstm.lstm_fwd(*inputs[d],
                                                       tape=True),
                                 args.reps) for d in (2, 1)}
    del inputs, calls
    k14 = _k14(args.parent, args.reps, gen) if args.parent else None
    card = _card()
    plans = {n: {f"D{d}": plan({**built, **v}, d, 800) for d in (2, 1)}
             for n, v in VARIANTS.items()}
    print(json.dumps({"card": card,
                      "shape": {"T": 850, "B": 32, "H": 800,
                                "dtype": "bfloat16"},
                      "built": built, "plan": plans, "tol": TOL,
                      "max_abs_plain": plain_max, "max_abs_err": checks,
                      "ptxas": ptxas, "variants": runs,
                      "as_built_tape_ms": tape_ms, "k14": k14}))


if __name__ == "__main__":
    main()
