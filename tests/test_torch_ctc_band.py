"""The decomposition of ``csrc/ctc.cu`` (K1-K3), mirrored in torch on the
CPU and held to ``ctc_alpha_plain``/``ctc_beta_plain`` bit for bit, and
``ctc_variants.plan``, the launch's plan, against the source.

The mirror does what a warp of the kernels does: the band cut into
segments of ``own`` states, a warp's span of 32 * k slots (a lane's k
consecutive states, or strided by 32), a ghost zone of 2h states on the
upstream side recomputed as its owner does and refreshed every h steps,
the band trim (alpha above min(2L, 2t+1), beta below 2L-1-2(len-1-t):
a span wholly there computes nothing), the two-term sum at blank slots,
and the frames past len written after the loop. If the kernels' bits
depend on none of C, k or h, the mirror equals the plain version under
``torch.equal`` at every plan. The CUDA kernels themselves are held to
the plain version and to the parent's source on the card
(chip_smoke.py, ``ctc_variants --parent``).
"""

import re

import numpy as np
import pytest
import torch

from deepspeech_tpu_torch import ctc_variants
from deepspeech_tpu_torch.ops import ctc

torch.set_num_threads(1)

NEG = ctc.NEG
SM = 132  # an H100 SXM's SMs


def _neg(x):
    return torch.full_like(x, NEG)


def _lse3_blank(a, b):
    """The kernel's ``lse3_blank``: lse3(a, b, NEG) without its third
    term."""
    m = torch.maximum(torch.maximum(a, b), _neg(a))
    out = m + torch.log(torch.exp(a - m) + torch.exp(b - m))
    return torch.where(m <= NEG / 2, _neg(m), out)


def _lse2(a, b):
    m = torch.maximum(a, b)
    out = m + torch.log(torch.exp(a - m) + torch.exp(b - m))
    return torch.where(m <= NEG / 2, _neg(m), out)


def _slots(k: int, strided: bool) -> torch.Tensor:
    """Each slot's offset in a warp's span, in the order lane-major then
    slot (the flat index is lane * k + r)."""
    lane = torch.arange(32)[:, None]
    r = torch.arange(k)[None, :]
    return (32 * r + lane if strided else k * lane + r).reshape(-1)


def _blank_slots(k: int, strided: bool) -> torch.Tensor:
    """Slots whose state is a blank at every step (the kernel's PARITY:
    consecutive states, k even, an even first state)."""
    r = torch.arange(k).repeat(32)
    if strided or k % 2:
        return torch.zeros(32 * k, dtype=torch.bool)
    return r % 2 == 0


class _Warp:
    """One segment: its span's states and per-state constants."""

    def __init__(self, b, i, p, s_max, ext, skip, sl, ghost_below, slots):
        g = 2 * p["h"]
        self.lo = i * p["own"]
        self.hi = min(self.lo + p["own"], s_max)
        self.first = ((0 if i == 0 else self.lo - g) if ghost_below
                      else self.lo)
        self.s = self.first + slots
        inside = (self.s >= 0) & (self.s < s_max)
        sc = self.s.clamp(0, s_max - 1)
        self.e = torch.where(inside, ext[b, sc].long(), 0)
        self.sk = inside & (self.s >= 2) & skip[b, sc]
        s2 = (self.s + 2).clamp(0, s_max - 1)
        self.sk2 = (self.s + 2 < s_max) & skip[b, s2]
        self.live = inside & (self.s <= sl)
        self.mine = (self.s >= self.lo) & (self.s < self.hi)
        self.order = torch.argsort(self.s)


def _shift(x, n, up: bool):
    """x at s-n (``up``: from the slot below) or s+n, NEG past the
    span; x in state order."""
    pad = x.new_full((n,), NEG)
    return torch.cat([pad, x[:-n]]) if up else torch.cat([x[n:], pad])


def _neighbours(w: _Warp, x, up: bool):
    """x at s-1 and s-2 (``up``) or s+1 and s+2 for each slot: what the
    shuffles bring."""
    xs = x[w.order]
    n1, n2 = torch.empty_like(x), torch.empty_like(x)
    n1[w.order] = _shift(xs, 1, up)
    n2[w.order] = _shift(xs, 2, up)
    return n1, n2


def _exchange(warps, x, p, alpha: bool, s_max: int):
    """Each segment's edge into its neighbour's ghost zone."""
    g = 2 * p["h"]
    sent = []
    for i, w in enumerate(warps):
        to = i + 1 if alpha else i - 1
        if not 0 <= to < len(warps):
            continue
        base = to * p["own"] - g if alpha else w.lo
        q = w.s - base
        sel = (q >= 0) & (q < g)
        sent.append((to, base, w.s[sel], x[i][sel].clone()))
    for to, base, states, vals in sent:
        w = warps[to]
        gbase = w.first if alpha else w.hi
        if alpha and to == 0 or not alpha and w.hi >= s_max:
            continue
        for st, v in zip(states.tolist(), vals):
            hit = ((w.s == st) & (w.s - gbase >= 0) & (w.s - gbase < g)
                   & (w.s < s_max))
            x[to][hit] = v


def mirror_alpha(lp, ext, skip, lens, s_last, tape, p, strided=False):
    """``ctc_alpha`` as the kernel computes it, at plan ``p``."""
    bsz, t_max, _ = lp.shape
    s_max = ext.shape[1]
    k = p["k"]
    slots, blank = _slots(k, strided), _blank_slots(k, strided)
    ll = torch.empty(bsz)
    out = torch.empty(bsz, t_max, s_max) if tape else None
    for b in range(bsz):
        sl = int(s_last[b])
        n = min(max(int(lens[b]), 0), t_max)
        warps = [_Warp(b, i, p, s_max, ext, skip, sl, True, slots)
                 for i in range(p["nseg"])]
        a = [torch.where(w.live & ((w.s == 0) | ((w.s == 1) & (sl > 0))),
                         lp[b, 0, w.e], torch.tensor(NEG)) for w in warps]

        def store(t):
            if tape:
                for w, x in zip(warps, a):
                    out[b, t, w.s[w.mine]] = x[w.mine]

        store(0)
        until = p["h"]
        for t in range(1, n):
            for i, w in enumerate(warps):
                if w.first > min(sl, 2 * t + 1):
                    continue
                l1, l2 = _neighbours(w, a[i], up=True)
                lt = torch.where(w.live, lp[b, t, w.e], torch.tensor(0.0))
                three = lt + ctc._lse3(a[i], l1,
                                       torch.where(w.sk, l2, _neg(l2)))
                two = lt + _lse3_blank(a[i], l1)
                a[i] = torch.where(w.live, torch.where(blank, two, three),
                                   _neg(three))
            store(t)
            until -= 1
            if len(warps) > 1 and until == 0:
                until = p["h"]
                _exchange(warps, a, p, True, s_max)
        if len(warps) > 1 and until != p["h"]:
            _exchange(warps, a, p, True, s_max)
        ll[b] = float("nan") if not 0 <= sl < s_max else 0.0
        for i, w in enumerate(warps):
            l1, _ = _neighbours(w, a[i], up=True)
            hit = w.mine & (w.s == sl)
            if bool(hit.any()):
                prev = l1[hit] if sl > 0 else torch.tensor([NEG])
                ll[b] = _lse2(a[i][hit], prev)[0]
        for t in range(max(n, 1), t_max):
            store(t)
    return ll, out


def mirror_beta(lp, ext, skip, lens, s_last, alphas, loglik, p,
                strided=False):
    """``ctc_beta`` as the kernel computes it, at plan ``p``."""
    bsz, t_max, _ = lp.shape
    s_max = ext.shape[1]
    k = p["k"]
    slots, blank = _slots(k, strided), _blank_slots(k, strided)
    gamma = torch.empty(bsz, t_max, s_max)
    for b in range(bsz):
        sl = int(s_last[b])
        n = min(max(int(lens[b]), 0), t_max)
        llb = loglik[b]
        warps = [_Warp(b, i, p, s_max, ext, skip, sl, False, slots)
                 for i in range(p["nseg"])]
        gamma[b, n:] = 0.0
        if n == 0:
            continue
        terms = [torch.where((w.s == sl) | ((w.s == sl - 1) & (sl > 0)),
                             torch.tensor(0.0), torch.tensor(NEG))
                 for w in warps]

        def store(t, betas):
            for w, beta in zip(warps, betas):
                s = w.s[w.mine].clamp(max=s_max - 1)
                occ = torch.exp(torch.clamp(alphas[b, t, s] + beta[w.mine]
                                            - llb, max=0.0))
                gamma[b, t, w.s[w.mine]] = torch.where(
                    w.live[w.mine], occ, torch.zeros_like(occ))

        store(n - 1, terms)
        c = [torch.where(w.live, term + lp[b, n - 1, w.e], _neg(term))
             for w, term in zip(warps, terms)]
        until = p["h"]
        for t in range(n - 2, -1, -1):
            betas = []
            for i, w in enumerate(warps):
                if w.first + 32 * k - 1 < sl - 1 - 2 * (n - 1 - t):
                    betas.append(_neg(c[i]))
                    continue
                r1, r2 = _neighbours(w, c[i], up=False)
                three = ctc._lse3(c[i], r1, torch.where(w.sk2, r2, _neg(r2)))
                two = _lse3_blank(c[i], r1)
                betas.append(torch.where(
                    w.live, torch.where(blank, two, three), _neg(three)))
            store(t, betas)
            c = [torch.where(w.live, beta + lp[b, t, w.e], _neg(beta))
                 for w, beta in zip(warps, betas)]
            until -= 1
            if len(warps) > 1 and until == 0:
                until = p["h"]
                _exchange(warps, c, p, False, s_max)
    return gamma


def _inputs(seed, b, t, v, l_max, pad=0):
    """``ctc.prepare``'s operands from numpy, with the edge rows fixed:
    row 0 without labels, row 1 with ``len`` 0, row 2 with ``len`` 1,
    row 3 at the full length with the most labels; ext padded by ``pad``
    blank columns."""
    rng = np.random.default_rng(seed)
    logits = torch.from_numpy(
        (rng.normal(size=(b, t, v)) * 2).astype(np.float32))
    labels = torch.from_numpy(rng.integers(1, v, size=(b, l_max)))
    lab_lens = torch.from_numpy(rng.integers(0, l_max + 1, size=b))
    lens = torch.from_numpy(rng.integers(0, t + 1, size=b))
    if b >= 4:
        lab_lens[0] = 0
        lens[1], lens[2] = 0, 1
        lens[3], lab_lens[3] = t, l_max
    labels = labels * (torch.arange(l_max)[None] < lab_lens[:, None])
    lp, ext, skip, il, sl = ctc.prepare(logits, labels, lens.int(),
                                        lab_lens.int())
    if pad:
        ext = torch.cat([ext, ext.new_zeros(b, pad)], 1)
        skip = torch.cat([skip, skip.new_zeros(b, pad)], 1)
    return lp, ext, skip, il, sl


def _plan(b, s, c, k, h):
    """``ctc_variants.plan`` with KS=k, GHOST_H=h and at most c CTAs, C
    taken as large as it goes (MAX_W=0)."""
    p = ctc_variants.plan(b, s, 10 ** 6, {"KS": k, "GHOST_H": h,
                                          "MAX_C": c, "MAX_W": 0})
    assert p is not None, (b, s, c, k, h)
    return p


# (name, B, T, V, L_MAX, ext padding): S = 2 * L_MAX + 1 + padding.
SHAPES = {
    "s1": (4, 9, 29, 0, 0),
    "s3": (4, 9, 29, 1, 0),
    "s141": (4, 24, 29, 70, 0),      # odd, no multiple of 32k
    "s201": (4, 48, 29, 100, 0),     # many warps under both trims
    "s1024": (4, 5, 29, 511, 1),     # the kernels' limit, at small T
    "t1": (4, 1, 29, 40, 0),
    "v4336": (4, 12, 4336, 30, 0),   # the aishell preset's vocab
}
PLANS = [(1, 1, 1), (1, 2, 4), (2, 3, 8), (4, 4, 8), (4, 5, 4), (2, 4, 1),
         (4, 2, 8), (1, 4, 8)]
CASES = [(name, plan) for name in SHAPES for plan in PLANS
         if not (name == "s1024" and plan[:2] == (1, 1))]


@pytest.mark.parametrize("name,plan", CASES,
                         ids=[f"{n}-C{c}k{k}h{h}" for n, (c, k, h) in CASES])
def test_mirror_equals_plain_bit_for_bit(name, plan):
    b, t, v, l_max, pad = SHAPES[name]
    c, k, h = plan
    prep = _inputs(len(name) + 7 * k + h, b, t, v, l_max, pad)
    p = _plan(b, prep[1].shape[1], c, k, h)
    ll_p, tape_p = ctc.ctc_alpha_plain(*prep, tape=True)
    gamma_p = ctc.ctc_beta_plain(*prep, tape_p, ll_p)
    ll_m, tape_m = mirror_alpha(*prep, True, p)
    assert torch.equal(ll_m, ll_p)
    assert torch.equal(tape_m, tape_p)
    assert torch.equal(mirror_beta(*prep, tape_p, ll_p, p), gamma_p)


@pytest.mark.parametrize("l_max,k", [(71, 2), (111, 4)])
def test_mirror_with_full_segments(l_max, k):
    """Segments of exactly 32k - 2h states (S = 143 at k=2 and 223 at
    k=4, one CTA): no spare slot above beta's ghost zone, so a trim or a
    ghost one state off shows in the owned states."""
    prep = _inputs(13, 4, 48, 29, l_max)
    p = _plan(4, prep[1].shape[1], 1, k, 8)
    assert p["own"] == 32 * k - 16 and p["nseg"] > 1
    ll_p, tape_p = ctc.ctc_alpha_plain(*prep, tape=True)
    ll_m, tape_m = mirror_alpha(*prep, True, p)
    assert torch.equal(ll_m, ll_p) and torch.equal(tape_m, tape_p)
    gamma = mirror_beta(*prep, tape_p, ll_p, p)
    assert torch.equal(gamma, ctc.ctc_beta_plain(*prep, tape_p, ll_p))


@pytest.mark.parametrize("k", [2, 3])
def test_strided_mirror_equals_plain(k):
    """Lanes holding states strided by 32 (no fixed parity: three terms
    at every state) give the same bits."""
    prep = _inputs(11, 4, 20, 29, 90)
    p = _plan(4, prep[1].shape[1], 2, k, 4)
    ll_p, tape_p = ctc.ctc_alpha_plain(*prep, tape=True)
    ll_m, tape_m = mirror_alpha(*prep, True, p, strided=True)
    assert torch.equal(ll_m, ll_p) and torch.equal(tape_m, tape_p)
    gamma = mirror_beta(*prep, tape_p, ll_p, p, strided=True)
    assert torch.equal(gamma, ctc.ctc_beta_plain(*prep, tape_p, ll_p))


def test_loss_only_mirror_equals_taped():
    prep = _inputs(3, 4, 16, 29, 20)
    p = _plan(4, prep[1].shape[1], 4, 4, 8)
    assert torch.equal(mirror_alpha(*prep, False, p)[0],
                       mirror_alpha(*prep, True, p)[0])


def test_blank_sum_and_band_trim_are_exact():
    """What the kernels leave out changes no bit: the third term at a
    blank state, and the states the trim skips (NEG in the plain
    version)."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.normal(size=4096).astype(np.float32) * 300)
    b = torch.from_numpy(rng.normal(size=4096).astype(np.float32) * 300)
    a[::7], b[::5] = NEG, NEG
    assert torch.equal(_lse3_blank(a, b), ctc._lse3(a, b, _neg(a)))
    lp, ext, skip, il, sl = _inputs(5, 4, 30, 29, 40)
    _, tape = ctc.ctc_alpha_plain(lp, ext, skip, il, sl, tape=True)
    s_idx = torch.arange(ext.shape[1])
    for t in range(30):
        lim = torch.minimum(sl, torch.tensor(2 * t + 1))
        above = s_idx[None] > lim[:, None]
        assert bool((tape[:, t][above] == NEG).all())


# The plan: one wave, every state owned exactly once, no empty segment.
@pytest.mark.parametrize("b", [1, 8, 32, 33, 45, 64, 128, 200])
@pytest.mark.parametrize("s", [1, 65, 513, 1024])
def test_plan_one_wave_and_every_state_once(b, s):
    p = ctc_variants.plan(b, s, SM)
    assert p is not None
    # One wave wherever one CTA an utterance holds the band.
    assert (p["C"] == 1 or b * p["C"] <= SM
            or ctc_variants.plan(b, s, SM, {"MAX_C": 1}) is None)
    assert p["nseg"] <= p["C"] * p["W"] and 1 <= p["W"] <= 32
    segs = ctc_variants.segments(p, s)
    owned = [st for lo, hi in segs for st in range(lo, hi)]
    assert owned == list(range(s))
    assert all(hi > lo for lo, hi in segs)
    g = 2 * p["h"]
    if p["nseg"] > 1:
        assert all(hi - lo >= g for lo, hi in segs[:-1])
    assert p["own"] + g <= 32 * p["k"]


@pytest.mark.parametrize("b", [1, 32, 200])
def test_plan_exists_at_every_s(b):
    for s in range(1, ctc.MAX_S + 1):
        p = ctc_variants.plan(b, s, SM)
        assert p is not None and (p["nseg"] - 1) * p["own"] < s, s
        assert p["nseg"] == 1 or p["own"] >= 2 * p["h"] >= 2, s


def test_plan_at_the_main_shape():
    """B=32, S=513 on 132 SMs: four CTAs an utterance (128 SMs), seven
    warps each, 26 segments of 20 states (two warps idle), an exchange
    every 6 steps, as the card printed (chip_smoke's ctc check)."""
    p = ctc_variants.plan(32, 513, SM)
    assert ((p["C"], p["W"], p["own"], p["h"], p["nseg"])
            == (4, 7, 20, 6, 26))


def test_plan_constants_match_the_source():
    text = ctc_variants.source_text()
    for name, value in ctc_variants.built().items():
        assert re.findall(rf"^constexpr int {name} = (\d+);", text,
                          re.M) == [str(value)]
    # The rule's derived constants, as the mirror computes them.
    assert ("constexpr int H_EFF = GHOST_H < 8 * KS ? GHOST_H : 8 * KS;"
            in text)
    assert "constexpr int CAP = 32 * KS - 2 * H_EFF;" in text
    assert ctc.MAX_S == 1024 and "constexpr int MAX_S = 1024;" in text


@pytest.mark.parametrize("name", sorted(ctc_variants.builds(True)))
def test_variants_are_substitutions_of_the_source(name):
    """Each build of ctc_variants applies to the source, once each, and
    those held to the bits have a plan at the main shape."""
    text = ctc_variants.source_text()
    for old, _ in ctc_variants.builds(True)[name]:
        assert text.count(old) == 1, old
    values = {**ctc_variants.VARIANTS, **ctc_variants.ABLATIONS}
    if name in values:
        assert ctc_variants.plan(32, 513, SM, values[name]) is not None


def test_no_fast_math_or_atomics_in_the_source():
    text = ctc_variants.source_text()
    code = re.sub(r"//.*", "", text)
    for word in ("__expf", "__logf", "ex2.approx", "lg2.approx", "atomic",
                 "use_fast_math", "__fdividef"):
        assert word not in code, word
