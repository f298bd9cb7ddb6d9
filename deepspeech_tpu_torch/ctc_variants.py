"""Variants of the CTC kernels (K1 ``ctc_alpha`` with its tape, K3
without, K2 ``ctc_beta``), timed in turns on the card, beside an
earlier tree's ``csrc/ctc.cu`` when given.

``csrc/ctc.cu`` launches a cluster of C CTAs per utterance, W warps
each, one segment of the band a warp, KS states a lane, a ghost zone of
2h states refreshed every h steps through point-to-point mailboxes, and
a ring of loads PREFETCH steps ahead; ``plan`` mirrors its launch rule.
This script builds copies of the source, each made by a text
substitution of its constants (``VARIANTS``), and with ``--ablate``
those of ``ABLATIONS`` (C=1; KS=4, which gives each lane four chains
where the source has one; PREFETCH=1; an exchange and a cluster-wide
barrier every step; the band trim; KS=2 without its two-term blank sum)
and of ``TIMING_ONLY`` (the lse arithmetic, the exchanges, the loads or
the tape and gamma stores taken out: they change the results and are
timed only, to split a step's nanoseconds). With ``--parent=PATH``
(another tree's ``deepspeech_tpu_torch/csrc`` directory) that tree's
``ctc.cu`` is built as it is.

On chip_smoke's batch (B=32, T'=850, V=29, ragged lengths, labels of
0.15 characters a frame, S <= 513) every build but the timing-only ones
must give the first build's bits (the parent's when given: the
log-likelihood, the tape, gamma and the loss-only log-likelihood), the
same bits twice and ``TOL`` of ``ctc_alpha_plain``/``ctc_beta_plain``,
and its launch plan must be ``plan``'s; with a parent the source as
built must also give the parent's bits at every shape of ``CHECKS``.
Then each is timed with CUDA events, two turns each in the order parent,
as built, the others, ``F.ctc_loss``, and then reversed. Prints ptxas's
registers and spills of each kernel, each build's plan at the main
shape, ms and ns a step, the ratio to the parent, and one JSON line
with the card's name and power limit.

``--full-length`` times a batch whose utterances all take T' frames and
L_MAX - 1 labels (a training rung's shape) in place of the ragged one,
and ``--batch=N`` its first N utterances.

``python -m deepspeech_tpu_torch.ctc_variants [--reps=10] [--parent=PATH]
[--ablate] [--full-length] [--batch=N]``
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
from typing import Dict, List, Optional, Tuple

import torch

from .k14_variants import build_variants
from .k15_ablation import _time_ms
from .k17_variants import built_value, substitutions
from .ops import _build, ctc

SOURCE = "ctc"
CONSTANTS = ("KS", "PREFETCH", "GHOST_H", "MAX_C", "MAX_W", "STRIDED",
             "TRIM", "RING")
MAX_S = 1024
# chip_smoke.py's CTC_TOL: relative on the log-likelihood and the tape,
# absolute on gamma.
TOL = 1e-5
# chip_smoke.py's main CTC shape: ds2_small's vocab and max label length.
B, T, V, L_MAX = 32, 850, 29, 256
# The shapes chip_smoke's ctc phase checks beside the main one: (name,
# B, T', V, L_MAX, characters a frame, columns of ext padding). "s1":
# every label empty (S=1); "s1024": up to 511 labels (S=1023, past what
# 850 frames can align: ll is NEG there) padded to S=1024, the kernels'
# limit; "b64" and "b128" take other plans than B=32.
CHECKS = (("b45_t37", 45, 37, V, L_MAX, 0.15, 0),
          ("b8", 8, T, V, L_MAX, 0.15, 0),
          ("s1", 8, T, V, 0, 0.15, 0),
          ("s1024", B, T, V, 511, 0.6, 1),
          ("b64", 64, T, V, L_MAX, 0.15, 0),
          ("b128", 128, T, V, L_MAX, 0.15, 0),
          ("v4336", 4, T, 4336, L_MAX, 0.15, 0))

# Constants of each variant, beside the source as built.
VARIANTS: Dict[str, Dict[str, int]] = {
    "as_built": {},
    "h2": {"GHOST_H": 2},
    "h4": {"GHOST_H": 4},
    "h8": {"GHOST_H": 8},
    "d3": {"PREFETCH": 3},
    "d6": {"PREFETCH": 6},
    "d12": {"PREFETCH": 12},
    "c2": {"MAX_C": 2},
    "ring2": {"RING": 2},
    "k2": {"KS": 2, "GHOST_H": 8},
    "k2_strided": {"KS": 2, "GHOST_H": 8, "STRIDED": 1},
}

_EXCHANGE = ("  __device__ void exchange(float (&x)[KS], int n, int S) "
             "const {\n")

# Ablations that keep the bits (constants, and text substitutions).
ABLATIONS: Dict[str, Dict[str, int]] = {
    "c1": {"MAX_C": 1},
    "k4": {"KS": 4, "GHOST_H": 8},
    "d1": {"PREFETCH": 1},
    "barrier_every_step": {"GHOST_H": 1},
    "trim": {"TRIM": 1},
    "k2_no_blank_sum": {"KS": 2, "GHOST_H": 8},
}
ABLATION_TEXT: Dict[str, List[Tuple[str, str]]] = {
    "barrier_every_step": [(_EXCHANGE, _EXCHANGE + "    cluster_sync();\n")],
    "k2_no_blank_sum": [("constexpr bool PARITY = !STRIDED && KS % 2 == 0;",
                         "constexpr bool PARITY = false;")],
}
# Timing only: each takes a part of the step out and changes the bits.
TIMING_ONLY: Dict[str, List[Tuple[str, str]]] = {
    "no_lse": [
        ("  const float v = m + logf(expf(a - m) + expf(b - m) + "
         "expf(c - m));",
         "  const float v = m + ((a - m) + (b - m) + (c - m));"),
        ("  const float m = fmaxf(fmaxf(a, b), NEG);\n"
         "  const float v = m + logf(expf(a - m) + expf(b - m));",
         "  const float m = fmaxf(fmaxf(a, b), NEG);\n"
         "  const float v = m + ((a - m) + (b - m));")],
    "no_exchange": [
        ("if (exch && --until == 0) {\n        until = p.h;\n"
         "        g.exchange(a", "if (false) {\n        until = p.h;\n"
         "        g.exchange(a"),
        ("if (exch && --until == 0) {\n        until = p.h;\n"
         "        g.exchange(c", "if (false) {\n        until = p.h;\n"
         "        g.exchange(c")],
    "no_loads": [
        ("for (int r = 0; r < KS; ++r) next[r] = lpb[ahead + e[r]];",
         "for (int r = 0; r < KS; ++r) next[r] = lt[r];"),
        ("        ring_lp[j][r] = lpb[ahead * V + e[r]];\n"
         "        ring_a[j][r] = ab[ahead * S + sc[r]];",
         "        ring_lp[j][r] = lt[r];\n        ring_a[j][r] = at[r];")],
    "no_stores": [
        ("      if (TAPE && t > start && t - 1 < T) {", "      if (false) {"),
        ("      if (t + 1 >= 0 && t + 1 <= len - 2) gamma_row(",
         "      if (false) gamma_row(")],
}


def source_text() -> str:
    with open(os.path.join(_build.CSRC_DIR, f"{SOURCE}.cu")) as f:
        return f.read()


def built() -> Dict[str, int]:
    """The source's constants."""
    text = source_text()
    return {n: built_value(text, n) for n in CONSTANTS}


def builds(ablate: bool) -> Dict[str, List[Tuple[str, str]]]:
    """Each build's text substitutions of the source: the variants and,
    with ``ablate``, the ablations and the timing-only builds."""
    text = source_text()
    consts = {**VARIANTS, **(ABLATIONS if ablate else {})}
    out = {n: substitutions(text, v) + ABLATION_TEXT.get(n, [])
           for n, v in consts.items()}
    if ablate:
        out.update(TIMING_ONLY)
    return out


def plan(b: int, s: int, sm_count: int,
         values: Optional[Dict[str, int]] = None) -> Optional[dict]:
    """``make_plan`` of ``csrc/ctc.cu`` with its constants (or
    ``values`` over them): ``{C, W, own, h, k, d, nseg}`` (nseg =
    ceil(S / own) segments; a warp of the C * W past them idles), or
    None where the launch refuses (S out of range, or no C fits)."""
    v = {**built(), **(values or {})}
    k = v["KS"]
    h = min(v["GHOST_H"], 8 * k)
    cap = 32 * k - 2 * h
    w_max = min(-(-MAX_S // cap), 32)
    if not 1 <= s <= MAX_S or b < 1:
        return None
    found = None
    for wave in (True, False):
        c = 1
        while c <= v["MAX_C"] and not (found and wave is False):
            if wave and c > 1 and b * c > sm_count:
                break
            w = -(-(-(-s // cap)) // c)
            if w <= w_max:
                own = -(-s // (c * w))
                own += own & 1
                nseg = -(-s // own)
                found = {"C": c, "W": w, "own": own,
                         "h": own // 2 if nseg > 1 and own // 2 < h else h,
                         "k": k, "d": v["PREFETCH"], "nseg": nseg}
                if w <= v["MAX_W"] or not wave:
                    break
            c *= 2
        if found:
            break
    return found


def segments(p: dict, s: int) -> List[Tuple[int, int]]:
    """The owned ``[lo, hi)`` of each of a plan's segments at S=s."""
    return [(i * p["own"], min((i + 1) * p["own"], s))
            for i in range(p["nseg"])]


def batch(gen, b: int = B, t: int = T, v: int = V, l_max: int = L_MAX,
          per_frame: float = 0.15):
    """Logits and labels of a ragged (b, t) batch, chip_smoke's: 2t..2t/5.7
    feature frames (300..1700 at t=850) with one at the full length,
    labels of ``per_frame`` characters per feature frame (0.15: about 15
    a second at 100 frames a second), random ids 1..v-1 with repeats,
    padded to l_max."""
    dev = "cuda"
    lens = torch.randint(t * 300 // 850, t + 1, (b,), generator=gen,
                         device=dev)
    lens[0] = t
    lab_lens = (per_frame * 2 * lens.float()).long().clamp(max=l_max)
    labels = torch.randint(1, v, (b, l_max), generator=gen, device=dev)
    labels = labels * (torch.arange(l_max, device=dev)[None]
                       < lab_lens[:, None])
    logits = torch.randn(b, t, v, generator=gen, device=dev) * 2
    return logits, labels.int(), lens.int(), lab_lens.int()


def operands(logits, labels, lens, lab_lens, pad: int = 0):
    """``ctc.prepare``'s operands, ext and skip padded by ``pad`` blank
    columns that no path reaches."""
    lp, ext, skip, il, sl = ctc.prepare(logits, labels, lens, lab_lens)
    if pad:
        b = ext.shape[0]
        ext = torch.cat([ext, ext.new_zeros(b, pad)], 1)
        skip = torch.cat([skip, skip.new_zeros(b, pad)], 1)
    return lp, ext, skip, il, sl


def _wrappers():
    return ctc.ctc_alpha, ctc.ctc_beta


def parent_calls(path: str):
    """``(alpha, beta)`` calls of another tree's ``csrc/ctc.cu``
    (``path``), loaded into ``_build._loaded["ctc"]`` when they are
    called, with the arguments ``ctc.ctc_alpha(*prep, tape=...)`` and
    ``ctc.ctc_beta(*prep, tape, ll)`` take: those wrappers where that
    tree's entries take the carried band, as this tree's do, else
    launches with the arguments its older entries take (no ``alpha0``,
    ``c_in``, ``c_out`` or ``t_off``)."""
    with open(path) as f:
        text = f.read()
    entry = text[text.index("int ctc_alpha_launch("):]
    if "alpha0" in entry[:entry.index(")")]:
        return _wrappers()
    p, i = ctypes.c_void_p, ctypes.c_int

    def typed(name, n_ptrs):
        fn = _build.load(SOURCE)[name]  # a function object of its own
        fn.argtypes, fn.restype = [p] * n_ptrs + [i] * 5 + [p], i
        return fn

    def stream(x):
        return x.device.index, torch.cuda.current_stream(x.device).cuda_stream

    def alpha(lp, ext, skip, lens, s_last, tape: bool):
        b, t, _ = lp.shape
        ll = torch.empty((b,), dtype=torch.float32, device=lp.device)
        out = (torch.empty((b, t, ext.shape[1]), dtype=torch.float32,
                           device=lp.device) if tape else None)
        rc = typed("ctc_alpha_launch", 7)(
            *(x.data_ptr() for x in (lp, ext, skip, lens, s_last)),
            out.data_ptr() if tape else None, ll.data_ptr(), *lp.shape,
            ext.shape[1], *stream(lp))
        if rc:
            raise RuntimeError(f"parent ctc_alpha launch failed: {rc}")
        return ll, out

    def beta(lp, ext, skip, lens, s_last, tape, ll):
        gamma = torch.empty_like(tape)
        rc = typed("ctc_beta_launch", 8)(
            *(x.data_ptr() for x in (lp, ext, skip, lens, s_last, tape, ll,
                                     gamma)),
            *lp.shape, ext.shape[1], *stream(lp))
        if rc:
            raise RuntimeError(f"parent ctc_beta launch failed: {rc}")
        return gamma
    return alpha, beta


def outputs(prep, calls=None) -> Tuple[torch.Tensor, ...]:
    """(ll, tape, gamma, loss-only ll) through the loaded library, by
    ``calls`` (``parent_calls``' pair; the wrappers when None)."""
    alpha, beta = calls or _wrappers()
    ll, tape = alpha(*prep, tape=True)
    gamma = beta(*prep, tape, ll)
    ll_lo, _ = alpha(*prep, tape=False)
    return ll, tape, gamma, ll_lo


def _rel(a, b) -> float:
    live = b > -5e29
    return float(((a - b).abs() / b.abs().clamp(min=1.0))[live].max())


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _held(names, libs, prep, plain, consts, sm, calls=None
          ) -> Tuple[dict, dict]:
    """Each build's errors against the plain versions ``plain`` (ll,
    tape, gamma) and its plan; raises unless it gives the first build's
    bits, twice, within TOL, with the loss-only ll equal to the taped
    one and ``plan``'s launch plan."""
    ll_p, tape_p, gamma_p = plain
    b, s = prep[1].shape
    plans, errs, ref = {}, {}, None
    for name in names:
        _build._loaded[SOURCE] = libs[name]
        pair = (calls or {}).get(name)
        got, again = outputs(prep, pair), outputs(prep, pair)
        torch.cuda.synchronize()
        errs[name] = {"loglik": _rel(got[0], ll_p),
                      "tape": _rel(got[1], tape_p),
                      "gamma": float((got[2] - gamma_p).abs().max())}
        if name != "parent":
            plans[name] = ctc.ctc_plan(b, s, prep[0].device)
            mirror = plan(b, s, sm, consts.get(name, {}))
            if mirror is None or any(plans[name][k] != mirror[k]
                                     for k in ("C", "W", "own", "h")):
                raise RuntimeError(f"{name}: launch plan {plans[name]}, "
                                   f"ctc_variants.plan {mirror}")
        ref = got if ref is None else ref
        bad = [k for k, e in errs[name].items() if not e <= TOL]
        if (bad or not _same(got, again) or not _same(got, ref)
                or not torch.equal(got[0], got[3])):
            raise RuntimeError(
                f"{name} (B={b}, S={s}): errors {errs[name]} (tol {TOL}), "
                f"the same bits twice {_same(got, again)}, the same bits "
                f"as {names[0]} {_same(got, ref)}, loss-only ll equal "
                f"{torch.equal(got[0], got[3])}")
        del got, again
    return plans, errs


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="deepspeech_tpu_torch.ctc_variants")
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--parent", default="",
                        help="another tree's deepspeech_tpu_torch/csrc "
                        "directory: its ctc.cu is held and timed beside "
                        "these")
    parser.add_argument("--ablate", action="store_true",
                        help="also build ABLATIONS (held to the bits) and "
                        "TIMING_ONLY (timed only)")
    parser.add_argument("--full-length", action="store_true",
                        help="every utterance T' frames and L_MAX - 1 "
                        "labels")
    parser.add_argument("--batch", type=int, default=B,
                        help="time the first N utterances")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ctc_variants measures the card: no CUDA device")
    subs = builds(args.ablate)
    consts = {**VARIANTS, **(ABLATIONS if args.ablate else {})}
    timing_only = [n for n in subs if n not in consts]
    copies = ({"parent": os.path.join(args.parent, f"{SOURCE}.cu")}
              if args.parent else {})
    libs, ptxas = build_variants(SOURCE, subs, "ctc_variants", copies,
                                 entry="ctc_")
    calls = {n: parent_calls(path) for n, path in copies.items()}
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    logits, labels, lens, lab_lens = batch(gen)
    if args.full_length:
        lens.fill_(T)
        lab_lens.fill_(L_MAX - 1)
        labels = torch.randint(1, V, labels.shape, generator=gen,
                               device=labels.device).int()
    logits, labels, lens, lab_lens = (x[:args.batch].contiguous() for x in
                                      (logits, labels, lens, lab_lens))
    prep = operands(logits, labels, lens, lab_lens)
    s = prep[1].shape[1]
    ll_p, tape_p = ctc.ctc_alpha_plain(*prep, tape=True)
    plain = (ll_p, tape_p, ctc.ctc_beta_plain(*prep, tape_p, ll_p))
    plans, errs = _held([*copies, *consts], libs, prep, plain, consts, sm,
                        calls)
    del plain, ll_p, tape_p
    shapes = {}
    if args.parent:
        for name, *shape, pad in CHECKS:
            p = operands(*batch(gen, *shape), pad)
            a_p, t_p = ctc.ctc_alpha_plain(*p, tape=True)
            shape_plans, shape_errs = _held(
                ["parent", "as_built"], libs, p,
                (a_p, t_p, ctc.ctc_beta_plain(*p, t_p, a_p)), {}, sm, calls)
            shapes[name] = {"plan": shape_plans["as_built"],
                            "max_err": shape_errs}
            del p, a_p, t_p
    _build._loaded[SOURCE] = libs["as_built"]
    ll, tape = ctc.ctc_alpha(*prep, tape=True)
    lp_tbv = prep[0].transpose(0, 1).detach().requires_grad_()
    targets, in_l, tg_l = labels.long(), lens.long(), lab_lens.long()

    def torch_fwd_bwd():
        torch.nn.functional.ctc_loss(lp_tbv, targets, in_l, tg_l,
                                     reduction="sum").backward()

    names = [*copies, *consts, *timing_only, "F.ctc_loss"]
    runs: Dict[str, list] = {n: [] for n in names}
    for name in names + names[::-1]:
        if name == "F.ctc_loss":
            runs[name].append({"fwd_bwd": _time_ms(torch_fwd_bwd, args.reps)})
            continue
        _build._loaded[SOURCE] = libs[name]
        alpha, beta = calls.get(name) or _wrappers()
        runs[name].append({
            "alpha": _time_ms(lambda: alpha(*prep, tape=True), args.reps),
            "loss_only": _time_ms(lambda: alpha(*prep, tape=False),
                                  args.reps),
            "beta": _time_ms(lambda: beta(*prep, tape, ll), args.reps)})
    _build._loaded[SOURCE] = libs["as_built"]
    ns = {n: {k: 1e6 * sum(r[k] for r in rs) / len(rs) / T for k in rs[0]}
          for n, rs in runs.items()}
    ratio = {}
    if args.parent:
        ratio = {k: sum(r[k] for r in runs["as_built"])
                 / sum(r[k] for r in runs["parent"])
                 for k in ("alpha", "loss_only", "beta")}
    card, clock = (subprocess.run(
        ["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.splitlines()[0]
        for q in ("name,power.limit", "clocks.sm,clocks.max.sm"))
    print(json.dumps({"card": card, "sm_clock_after": clock,
                      "shape": {"B": prep[1].shape[0], "T": T, "V": V,
                                "S": s, "full_length": args.full_length},
                      "built": built(), "plan": plans, "tol": TOL,
                      "max_err": errs, "held_to_parent": shapes,
                      "ptxas": ptxas, "variants": runs, "ns_per_step": ns,
                      "ms_ratio_to_parent": ratio}))


if __name__ == "__main__":
    main()
