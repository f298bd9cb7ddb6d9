"""Variants of the resident GRU forward's tensor-core loop (K4 at D=2, K6
at D=1), timed in turns on the card, beside an earlier tree's kernels
when given.

The loop is ``csrc/gru_fwd_mma.cuh``'s with all of W^T resident;
``csrc/gru_fwd.cu`` sets its constants: the group widths and the stages
of a warp's ring of h-row pieces, ``MU_NARROW`` units and ``MS_NARROW``
stages where D x ceil(H/MU_NARROW) groups get an SM each, else
``MU_WIDE`` and ``MS_WIDE`` (``plan``). This script builds copies of
``csrc/gru_fwd.cu``, each made by a text substitution of those constants
(``VARIANTS``), and with ``--parent=PATH`` (another tree's
``deepspeech_tpu_torch/csrc`` directory) that tree's ``gru_fwd.cu`` and
``gru_fwd_stream.cu`` as they are (a ``gru_fwd.cu`` without the
tensor-core path takes no scratch and is called with its own
arguments). Each K4/K6 build is held to ``gru_fwd_plain`` at
ds2_small's shape (D=2, T'=850, B=32, H=800, bf16, ragged lengths) and
at ds2_streaming's (D=1, with an h0), ``ys`` and ``hfin`` within
``TOL`` and the same bits twice, then timed with CUDA events at both D,
two turns each in the order parent, as built, the others, cuDNN's GRU,
and then reversed, with one call split by kernel (the transpose of W,
the loop) by ``torch.profiler``. With a parent, K8 (this tree's
``gru_fwd_stream.cu``, whose loop is the header's with part of W^T
streamed, and the parent's) must give the parent's bits at ds2_full's
H=1760 and at H=800 (D=2, with an h0), and is timed in turns at H=1760.
Prints ptxas's registers and spills of each loop, each variant's plan at
both D, and one JSON line with the card's name and power limit.

With ``--ablate`` it also times the source with parts of its loop taken
out (``ABLATIONS``) and holds each to the same comparison: those in
``MUST_FAIL`` take out part of the product and must miss ``TOL``, which
shows that the comparison would see such a fault.

``python -m deepspeech_tpu_torch.k4_variants [--reps=3] [--parent=PATH]
[--ablate]``
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
from .k7_variants import _err, _same
from .ops import _build, gru

SOURCE = "gru_fwd"
HEADER = "gru_fwd_mma.cuh"
CONSTANTS = ("MU_NARROW", "MS_NARROW", "MU_WIDE", "MS_WIDE")
# The limit of max |kernel - plain| of ys and hfin on these inputs,
# chip_smoke.py's GRU_FWD_TOL; the output prints max |plain| beside it.
TOL = 1e-2
# An H100's shared memory a block may opt into, and its SMs.
SMEM_OPTIN = 232448
SMS = 132

# Loop constants of each variant, beside the source as built: the widths
# (16 units at D=1: 50 groups at H=800; 32 at D=2: 50 groups, two column
# splits) and the ring depths.
VARIANTS: Dict[str, Dict[str, int]] = {
    "as_built": {},
    "mu16": {"MU_NARROW": 16},
    "mu32": {"MU_WIDE": 32},
    "ms2": {"MS_NARROW": 2, "MS_WIDE": 2},
    "ms3": {"MS_NARROW": 3, "MS_WIDE": 3},
    "ms6": {"MS_NARROW": 6, "MS_WIDE": 6},
}

# Ablations, each a text substitution of the header (pasted into a copy
# of the source in place of its #include), timed beside the source as
# built: what a part of the step costs is the time it saves when taken
# out. Their outputs are wrong by design; each is held to the comparison,
# and those of MUST_FAIL must miss TOL. no_row_copies issues no copy of
# the h row (the rings keep what they held); no_tensor_cores takes the
# loop's mma.sync out; no_grid_barrier replaces the step's grid barrier
# by a block barrier; one_chunk gives each warp one chunk of the depth a
# step (its 3-4 at H=800 cut to 1).
ABLATIONS: Dict[str, List[Tuple[str, str]]] = {
    "no_row_copies": [(
        "                cp_async16(slot + p * 32 + lane,\n"
        "                           ok ? h_d + size_t(b) * H + k : h_d, ok);",
        "                (void)ok;")],
    "no_tensor_cores": [
        (f"                mma_bf16(acc[mt][nt], a[2 * mt].{x}, "
         f"a[2 * mt + 1].{x},",
         f"                if (0) mma_bf16(acc[mt][nt], a[2 * mt].{x}, "
         f"a[2 * mt + 1].{x},") for x in "xz"],
    "no_grid_barrier": [("    grid.sync();\n  }\n}",
                         "    __syncthreads();\n  }\n}")],
    "one_chunk": [
        ("  const int n_mine = (n_chunks - kw + NW_K - 1) / NW_K;",
         "  const int n_mine = kw < n_chunks;")],
}
# The ablations that take out the recurrent product, all of it or 2-3 of
# a warp's 3-4 chunks at H=800.
MUST_FAIL = ("no_tensor_cores", "one_chunk")


def source_text() -> str:
    with open(os.path.join(_build.CSRC_DIR, f"{SOURCE}.cu")) as f:
        return f.read()


def header_text() -> str:
    with open(os.path.join(_build.CSRC_DIR, HEADER)) as f:
        return f.read()


def ablation(header_subs: List[Tuple[str, str]]) -> List[Tuple[str, str]]:
    """The substitution of ``csrc/gru_fwd.cu`` that pastes the header in
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
    launches)`` of K4/K6's tensor-core loop with these constants
    (``CONSTANTS``) at D directions of H units on a card with these
    limits, as ``launch_mma`` and ``gru_fwd_mma::launch`` choose: the
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
    gcol = 3 * mu
    red_s = gcol + 8 + (8 if (gcol + 8) % 16 == 0 else 0)
    ring = warps * ms * rowp * 32                   # uint4
    red = warps // nw_n * rows * red_s // 4
    held = -(-h // kc) * (gcol // 8) * 32
    smem = 16 * (max(ring, red) + held)
    return mu, smem, smem <= smem_optin and d * -(-h // mu) <= sms


def _inputs(gen, d: int, h0: bool, t: int = 850, b: int = 32,
            h: int = 800):
    """``gru_fwd``'s arguments: bf16, ragged lengths, with an h0 when
    asked."""
    dev = "cuda"
    lens = torch.randint(t // 3, t + 1, (b,), generator=gen, device=dev)
    lens[0] = t
    mask = (torch.arange(t, device=dev)[:, None] < lens[None, :]).float()
    xp = torch.randn(t, b, 3 * h, generator=gen, device=dev).bfloat16()
    w = (torch.randn(d, h, 3 * h, generator=gen, device=dev)
         / math.sqrt(h)).bfloat16()
    bias = torch.randn(d, 3 * h, generator=gen, device=dev) * 0.1
    hh = torch.randn(d, b, h, generator=gen, device=dev) * 0.5 if h0 else None
    return xp, mask, w, bias, hh, (False, True)[:d]


def _parent_call(xp, mask, w, b, h0, reverse):
    """``gru_fwd`` through a source whose C entry point takes no scratch
    (the CUDA-core kernel alone)."""
    ys, hfin = gru._fwd_outputs(xp, w, h0)
    gru._launch(SOURCE, xp, mask, w, (b, h0, ys, hfin), reverse)
    return ys, hfin


def _cudnn_call(gen, d: int, h: int = 800, t: int = 850, b: int = 32):
    """cuDNN's bf16 GRU at the same width and D, on its own input: the
    library's time for the same recurrence."""
    lib = torch.nn.GRU(h, h, bidirectional=d == 2).to("cuda", torch.bfloat16)
    lib.flatten_parameters()
    x = torch.randn(t, b, h, generator=gen, device="cuda").bfloat16()

    def call(*_):
        with torch.no_grad():
            return lib(x)
    return call


def _k8(parent: str, reps: int, gen) -> dict:
    """K8 as built here and the parent's: the same bits at H=1760 and at
    H=800 (D=2, with an h0), and ms a call at H=1760 without h0 in turns
    (parent, this tree, this tree, parent)."""
    libs, ptxas = build_variants(
        "gru_fwd_stream", {"as_built": []}, "k4_variants_k8",
        {"parent": os.path.join(parent, "gru_fwd_stream.cu")})
    fn = gru.gru_fwd_stream
    out = {"ptxas": ptxas, "same_bits": {}, "ms": {"parent": [],
                                                    "as_built": []}}
    for h in (1760, 800):
        args = _inputs(gen, 2, True, h=h)
        got = {}
        for name in ("parent", "as_built"):
            _build._loaded["gru_fwd_stream"] = libs[name]
            got[name] = fn(*args)
        out["same_bits"][h] = _same(got["parent"], got["as_built"])
        del args, got
    timed = _inputs(gen, 2, False, h=1760)
    for name in ("parent", "as_built", "as_built", "parent"):
        _build._loaded["gru_fwd_stream"] = libs[name]
        out["ms"][name].append(_time_ms(lambda: fn(*timed), reps))
    _build._loaded["gru_fwd_stream"] = libs["as_built"]
    out["ms_ratio"] = sum(out["ms"]["as_built"]) / sum(out["ms"]["parent"])
    if not all(out["same_bits"].values()):
        raise RuntimeError(f"K8 differs from the parent's: {out}")
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="deepspeech_tpu_torch.k4_variants")
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--parent", default="",
                        help="another tree's deepspeech_tpu_torch/csrc "
                        "directory: its gru_fwd.cu and gru_fwd_stream.cu "
                        "are timed in turns beside these")
    parser.add_argument("--ablate", action="store_true",
                        help="also time the source with parts of its loop "
                        "taken out (ABLATIONS)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k4_variants measures the card: no CUDA device")
    text = source_text()
    built = {n: built_value(text, n) for n in CONSTANTS}
    builds = {n: substitutions(text, v) for n, v in VARIANTS.items()}
    ablations = ABLATIONS if args.ablate else {}
    builds.update({n: ablation(subs) for n, subs in ablations.items()})
    copies = ({"parent": os.path.join(args.parent, f"{SOURCE}.cu")}
              if args.parent else {})
    libs, ptxas = build_variants(SOURCE, builds, "k4_variants", copies)
    calls = {name: gru.gru_fwd for name in libs}
    if args.parent:
        with open(copies["parent"]) as f:
            if "scratch" not in f.read():
                calls["parent"] = _parent_call
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = {2: _inputs(gen, 2, False), 1: _inputs(gen, 1, True)}
    refs = {d: gru.gru_fwd_plain(*inputs[d]) for d in (2, 1)}
    plain_max = {f"D{d}": float(refs[d][0].abs().max()) for d in refs}
    checks = {}
    for name, lib in libs.items():
        _build._loaded[SOURCE] = lib
        for d in (2, 1):
            got, again = calls[name](*inputs[d]), calls[name](*inputs[d])
            err = _err(got, refs[d])
            checks[f"{name}[D={d}]"] = err
            if name in ablations:
                if name in MUST_FAIL and err <= TOL:
                    raise RuntimeError(
                        f"ablation {name} D={d}: max |kernel - plain| "
                        f"{err} <= {TOL}: the comparison cannot see it")
                continue
            same = _same(got, again)
            if err > TOL or not same:
                raise RuntimeError(f"variant {name} D={d}: max |kernel - "
                                   f"plain| {err}, bit-identical {same}")
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
    del inputs, calls
    k8 = _k8(args.parent, args.reps, gen) if args.parent else None
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.splitlines()[0]
    plans = {n: {f"D{d}": plan({**built, **v}, d, 800) for d in (2, 1)}
             for n, v in VARIANTS.items()}
    print(json.dumps({"card": card,
                      "shape": {"T": 850, "B": 32, "H": 800,
                                "dtype": "bfloat16", "h0": "D=1 only"},
                      "built": built, "plan": plans, "tol": TOL,
                      "max_abs_plain": plain_max, "max_abs_err": checks,
                      "ptxas": ptxas, "variants": runs, "k8": k8}))


if __name__ == "__main__":
    main()
