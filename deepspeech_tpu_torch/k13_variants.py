"""Variants of the LSTM backward's tensor-core loop with W resident (K13),
timed in turns on the card, beside an earlier tree's kernels when given.

The loop is ``csrc/lstm_bwd_mma.cuh``'s; ``csrc/lstm_bwd.cu`` (K13) sets
its constants: the group widths and the stages of a warp's ring of
dgates-row pieces, ``MU_NARROW`` units and ``MS_NARROW`` stages where D x
ceil(H/MU_NARROW) groups get an SM each, else ``MU_WIDE`` and
``MS_WIDE`` (``plan``). This script
builds copies of ``csrc/lstm_bwd.cu``, each made by a text substitution
of those constants (``VARIANTS``), and with ``--parent=PATH`` (another
tree's ``deepspeech_tpu_torch/csrc`` directory) that tree's
``lstm_bwd.cu`` and ``lstm_bwd_stream.cu`` as they are. Each K13 build is
held to ``lstm_bwd_plain`` at ds2_small-lstm's shape (D=2, T'=850, B=32,
H=800, bf16, ragged lengths) and at ds2_streaming-lstm's (D=1), within
``TOL`` and the same bits twice, and with a parent the source as built
must give the parent's bits at both D (no carry: the C entry's NULL
``h0``, ``c0``, ``dcfin``, ``dh0`` and ``dc0``), then timed with CUDA
events at both D, two turns each in the order parent, as built, the
others, and then reversed, with one call split by kernel (the gate
pre-pass, the loop) by ``torch.profiler``. With a parent, K15 (this
tree's ``lstm_bwd_stream.cu``, whose loop is the header's with W
streamed, and the parent's) must give the parent's bits at ds2_full's
H=1760 and at H=800, and is timed in turns at H=1760 (D=2). A parent
whose C entries take no carry is called through a shim with the
pointers they take (``parent_call``). The source as built is also timed
with a carry (a random ``(h0, c0)`` and ``dcfin``, ``(dh0, dc0)`` out)
and without one in turns (``carry_turns``): K13 at both D, and with a
parent K15 at H=1760, D=1. Prints ptxas's registers
and spills of each loop, each variant's plan at both D, and one JSON
line with the card's name and power limit.

With ``--ablate`` it also times the source with parts of its loop taken
out (``ABLATIONS``) and holds each to the same comparison: those in
``MUST_FAIL`` take out part of the product and must miss ``TOL``, which
shows that the comparison would see such a fault.

``python -m deepspeech_tpu_torch.k13_variants [--reps=3] [--parent=PATH]
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
from .k15_ablation import _split_ms, _time_ms, with_header
from .k17_variants import built_value, substitutions
from .ops import _build, gru, lstm

SOURCE = "lstm_bwd"
HEADER = "lstm_bwd_mma.cuh"
CONSTANTS = ("MU_NARROW", "MS_NARROW", "MU_WIDE", "MS_WIDE")
# The limit of max |kernel - plain| on these inputs, chip_smoke.py's
# LSTM_BWD_TOL: on an H100 the kernel reads 1.6e-4 to 2.4e-4 there, and
# the output prints max |plain| (3.1 to 4.7) beside it.
TOL = 2e-3
# An H100's shared memory a block may opt into, and its SMs.
SMEM_OPTIN = 232448
SMS = 132

# Loop constants of each variant, beside the source as built: the widths
# (groups of 16 at both D: 50 groups at D=1, H=800) and the ring depths.
VARIANTS: Dict[str, Dict[str, int]] = {
    "as_built": {},
    "mu16": {"MU_NARROW": 16, "MS_NARROW": 4},
    "mu16_ms6": {"MU_NARROW": 16, "MS_NARROW": 6, "MS_WIDE": 6},
    "ms2": {"MS_NARROW": 2, "MS_WIDE": 2},
    "ms3": {"MS_NARROW": 3, "MS_WIDE": 3},
    "ms4": {"MS_NARROW": 4, "MS_WIDE": 4},
    "ms6": {"MS_NARROW": 6, "MS_WIDE": 6},
}

# Ablations, each a text substitution of the header (pasted into a copy
# of the source in place of its #include), timed beside the source as
# built: what a part of the step costs is the time it saves when taken
# out. Their outputs are wrong by design; each is held to the comparison,
# and those of MUST_FAIL must miss TOL. no_row_copies issues no copy of the
# dgates row (the rings keep what they held); no_tensor_cores takes the
# loop's mma.sync out (the pre-pass keeps its own); no_grid_barrier
# replaces the step's grid barrier by a block barrier; no_gate_math takes
# the elementwise step's sigmoid and tanh out; one_chunk gives each warp
# one chunk of the depth a step (the chain of its 12-13 at H=800 cut to
# 1).
ABLATIONS: Dict[str, List[Tuple[str, str]]] = {
    "no_row_copies": [(
        "                cp_async16(slot + p * 32 + lane,\n"
        "                           ok ? g_d + size_t(b) * N + k : g_d, ok);",
        "                (void)ok;")],
    "no_tensor_cores": [
        (f"                mma_bf16(acc[mt][nt], a[2 * mt].{x}, "
         f"a[2 * mt + 1].{x},",
         f"                if (0) mma_bf16(acc[mt][nt], a[2 * mt].{x}, "
         f"a[2 * mt + 1].{x},") for x in "xz"],
    "no_grid_barrier": [("    grid.sync();\n  }\n}",
                         "    __syncthreads();\n  }\n}")],
    "no_gate_math": [("  return 1.f / (1.f + expf(-x));", "  return x;"),
                     ("  a.gg = tanhf(", "  a.gg = ("),
                     ("  a.tc = tanhf(", "  a.tc = (")],
    "one_chunk": [
        ("  const int n_mine = (n_chunks - warp + M_WARPS - 1) / M_WARPS;",
         "  const int n_mine = warp < n_chunks;")],
}
# The ablations that take out the recurrent product, all of it or 11 of
# a warp's 12-13 chunks at H=800.
MUST_FAIL = ("no_tensor_cores", "one_chunk")


def ablation(header_subs: List[Tuple[str, str]]) -> List[Tuple[str, str]]:
    """The substitution of ``csrc/lstm_bwd.cu`` that pastes the header in
    place of its ``#include``, with ``header_subs`` made in it."""
    with open(os.path.join(_build.CSRC_DIR, HEADER)) as f:
        head = f.read()
    for old, new in header_subs:
        if head.count(old) != 1:
            raise RuntimeError(f"the header no longer has {old!r}")
        head = head.replace(old, new)
    return [(f'#include "{HEADER}"\n', head)]


def source_text() -> str:
    with open(os.path.join(_build.CSRC_DIR, f"{SOURCE}.cu")) as f:
        return f.read()


def header_text() -> str:
    with open(os.path.join(_build.CSRC_DIR, HEADER)) as f:
        return f.read()


def plan(values: Dict[str, int], d: int, h: int,
         smem_optin: int = SMEM_OPTIN, sms: int = SMS
         ) -> Tuple[int, int, bool]:
    """``(group width, shared memory bytes of a block, whether it
    launches)`` of K13's tensor-core loop with these constants
    (``CONSTANTS``) at D directions of H units on a card with these
    limits, as ``launch_mma`` and ``lstm_bwd_mma::launch`` choose: the
    narrow width and its ring depth where D x ceil(H/MU_NARROW) groups fit
    one an SM, else the wide; it launches when the block's rings and W
    rows fit and every group has an SM. The header's sizes, read from
    it."""
    head = header_text()
    warps, rows, kc, rowp = (built_value(head, n) for n in
                             ("M_WARPS", "MROWS", "MKC", "ROWP"))
    narrow, ms_narrow, wide, ms_wide = (values[n] for n in CONSTANTS)
    mu, ms = ((narrow, ms_narrow) if d * -(-h // narrow) <= sms
              else (wide, ms_wide))
    ring = warps * ms * rowp * 32                   # uint4
    red = warps * rows * (mu + 8) // 4
    chunks = -(-(-(-4 * h // kc)) // warps)
    smem = 16 * (max(ring, red) + warps * chunks * (mu // 8) * 32)
    return mu, smem, smem <= smem_optin and d * -(-h // mu) <= sms


def _inputs(gen, d: int, t: int = 850, b: int = 32, h: int = 800):
    """``lstm_bwd``'s arguments on the tape of ``lstm_fwd(tape=True)``:
    bf16, ragged lengths."""
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


def parent_call(source: str, path: str):
    """``lstm.<source>`` (``lstm_bwd``: K13, or ``lstm_bwd_stream``: K15)
    through another tree's ``csrc/<source>.cu`` (``path``), loaded into
    ``_build._loaded[source]`` when it is called: the wrapper itself where
    that tree's C entry takes the carry (``h0``), as this tree's does,
    else a launch with the pointers its older entry takes, ``(bias, ys,
    cs, dy, dgates, scratch)``, and the scratch its
    ``<source>_scratch_floats`` asks for (enough for either of its
    paths)."""
    with open(path) as f:
        text = f.read()
    entry = text[text.index(f"int {source}_launch("):]
    entry = entry[:entry.index(")")]
    if "h0" in entry:
        return getattr(lstm, source)

    def call(xp, mask, w, bias, ys, cs, dy, reverse):
        d, t, bsz, h = w.shape[0], xp.shape[0], xp.shape[1], w.shape[1]
        dgates = torch.empty((d, t, bsz, 4 * h), dtype=torch.float32,
                             device=xp.device)
        floats = getattr(gru._lib(source), f"{source}_scratch_floats")(
            d, bsz, h)
        scratch = torch.empty((floats,), dtype=torch.float32,
                              device=xp.device)
        gru._launch(source, xp, mask, w, (bias, ys, cs, dy, dgates, scratch),
                    reverse)
        return dgates
    return call


def carry_turns(fn, args, gen, reps: int) -> dict:
    """ms a call of ``fn`` (``lstm.lstm_bwd`` or ``lstm_bwd_stream``) on
    ``args`` without a carry and with a random ``(h0, c0)`` and
    ``dcfin``, returning ``(dh0, dc0)``, in turns (none, carry, carry,
    none), and the ratio of their sums."""
    xp, w = args[0], args[2]
    shape = (w.shape[0], xp.shape[1], w.shape[1])
    hc0 = tuple(torch.randn(shape, generator=gen, device="cuda") * 0.5
                for _ in range(2))
    carry = {"hc0": hc0, "return_dhc0": True,
             "dcfin": torch.randn(shape, generator=gen, device="cuda") * 0.1}
    out = {"none": [], "carry": []}
    for name in ("none", "carry", "carry", "none"):
        kw = carry if name == "carry" else {}
        out[name].append(_time_ms(lambda: fn(*args, **kw), reps))
    out["ratio"] = sum(out["carry"]) / sum(out["none"])
    return out


def _k15(parent: str, reps: int, gen) -> dict:
    """K15 as built here and the parent's: the same bits at H=1760 and at
    H=800 (D=2), and ms a call at H=1760 in turns (parent, this tree,
    this tree, parent)."""
    path = os.path.join(parent, "lstm_bwd_stream.cu")
    libs, ptxas = build_variants("lstm_bwd_stream", {"as_built": []},
                                 "k13_variants_k15", {"parent": path})
    calls = {"parent": parent_call("lstm_bwd_stream", path),
             "as_built": lstm.lstm_bwd_stream}
    out = {"ptxas": ptxas, "same_bits": {}, "ms": {"parent": [],
                                                    "as_built": []}}
    for h in (1760, 800):
        args = _inputs(gen, 2, h=h)
        got = {}
        for name in ("parent", "as_built"):
            _build._loaded["lstm_bwd_stream"] = libs[name]
            got[name] = calls[name](*args)
        out["same_bits"][h] = bool(torch.equal(got["parent"],
                                               got["as_built"]))
        if h == 1760:
            for name in ("parent", "as_built", "as_built", "parent"):
                _build._loaded["lstm_bwd_stream"] = libs[name]
                out["ms"][name].append(_time_ms(lambda: calls[name](*args),
                                                reps))
        del args, got
    _build._loaded["lstm_bwd_stream"] = libs["as_built"]
    out["ms_ratio"] = sum(out["ms"]["as_built"]) / sum(out["ms"]["parent"])
    out["carry_turns_d1"] = carry_turns(lstm.lstm_bwd_stream,
                                        _inputs(gen, 1, h=1760), gen, reps)
    if not all(out["same_bits"].values()):
        raise RuntimeError(f"K15 differs from the parent's: {out}")
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="deepspeech_tpu_torch.k13_variants")
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--parent", default="",
                        help="another tree's deepspeech_tpu_torch/csrc "
                        "directory: its lstm_bwd.cu and lstm_bwd_stream.cu "
                        "are timed in turns beside these")
    parser.add_argument("--ablate", action="store_true",
                        help="also time the source with parts of its loop "
                        "taken out (ABLATIONS)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k13_variants measures the card: no CUDA device")
    text = source_text()
    built = {n: built_value(text, n) for n in CONSTANTS}
    builds = {n: substitutions(text, v) for n, v in VARIANTS.items()}
    ablations = ABLATIONS if args.ablate else {}
    builds.update({n: ablation(subs) for n, subs in ablations.items()})
    copies = ({"parent": os.path.join(args.parent, f"{SOURCE}.cu")}
              if args.parent else {})
    libs, ptxas = build_variants(SOURCE, builds, "k13_variants", copies)
    calls = {name: lstm.lstm_bwd for name in libs}
    if args.parent:
        calls["parent"] = parent_call(SOURCE, copies["parent"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = {d: _inputs(gen, d) for d in (2, 1)}
    refs = {d: lstm.lstm_bwd_plain(*inputs[d]) for d in (2, 1)}
    plain_max = {f"D{d}": float(refs[d].abs().max()) for d in refs}
    checks, held = {}, {}
    for name, lib in libs.items():
        _build._loaded[SOURCE] = lib
        for d in (2, 1):
            got, again = calls[name](*inputs[d]), calls[name](*inputs[d])
            err = float((got - refs[d]).abs().max())
            checks[f"{name}[D={d}]"] = err
            if args.parent and name in ("parent", "as_built"):
                held[name, d] = got
            if name in ablations:
                if name in MUST_FAIL and err <= TOL:
                    raise RuntimeError(
                        f"ablation {name} D={d}: max |kernel - plain| "
                        f"{err} <= {TOL}: the comparison cannot see it")
                continue
            same = torch.equal(got, again)
            if err > TOL or not same:
                raise RuntimeError(f"variant {name} D={d}: max |kernel - "
                                   f"plain| {err}, bit-identical {same}")
            del got, again
    parent_bits = ({f"D{d}": bool(torch.equal(held["parent", d],
                                              held["as_built", d]))
                    for d in (2, 1)} if args.parent else {})
    del refs, held
    if not all(parent_bits.values()):
        raise RuntimeError(f"K13 differs from the parent's: {parent_bits}")
    names = [*copies, *VARIANTS, *ablations]
    runs: Dict[str, list] = {n: [] for n in names}
    for name in names + names[::-1]:
        _build._loaded[SOURCE] = libs[name]
        call = calls[name]
        runs[name].append({
            f"D{d}": {"ms": _time_ms(lambda: call(*inputs[d]), args.reps),
                      "kernels_ms": _split_ms(lambda: call(*inputs[d]),
                                              SOURCE)}
            for d in (2, 1)})
    _build._loaded[SOURCE] = libs["as_built"]
    turns = {f"D{d}": carry_turns(lstm.lstm_bwd, inputs[d], gen, args.reps)
             for d in (2, 1)}
    k15 = _k15(args.parent, args.reps, gen) if args.parent else None
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.splitlines()[0]
    plans = {n: {f"D{d}": plan({**built, **v}, d, 800) for d in (2, 1)}
             for n, v in VARIANTS.items()}
    print(json.dumps({"card": card,
                      "shape": {"T": 850, "B": 32, "H": 800,
                                "dtype": "bfloat16"},
                      "built": built, "plan": plans, "tol": TOL,
                      "max_abs_plain": plain_max, "max_abs_err": checks,
                      "parent_bits": parent_bits, "ptxas": ptxas,
                      "variants": runs, "carry_turns": turns,
                      "k15": k15}))


if __name__ == "__main__":
    main()
