"""A chunk of the CTC recursion with its carried band (K1 ``ctc_alpha``'s
``alpha0``, K2 ``ctc_beta``'s ``c_in``/``c_out``, ``t_off``) and the
sequence-parallel loss ``sp_ctc_loss`` built on them, on the CPU through
the plain versions, against the unchunked recursion and the JAX
package's ``ctc_loss_ref`` (whose gradient is autodiff's through the
plain scan, the one JAX ``seqpar._ctc_alpha_relay`` relays;
tests/test_torch_seqpar_train.py holds the relay through ``sp_loss``).

The chunks run the unchunked recursion's steps in its order, so the
log-likelihood, every tape row and every gamma row are its bits
(``torch.equal``). Against JAX (f32): the loss within 1e-5, the
gradient within rtol 1e-4 (tests/test_torch_ctc.py's bound) and atol 5e-5:
over T=48 frames JAX's autodiff through the log-space scan lands up to
4e-5 from the closed form ``softmax - gamma`` at small entries. The
kernels are held to the plain versions, chunked against unchunked, on
the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeech_tpu.ops.ctc import ctc_loss_ref as jax_ctc_loss_ref
from deepspeech_tpu_torch.ops import ctc

# One CPU thread for torch: parallel test workers share the machine's
# cores, and a thread pool in each worker oversubscribes them.
torch.set_num_threads(1)

B, T, V, L = 6, 48, 7, 9
TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 5e-5


def _batch(seed):
    """Logits and labels with the edge rows: row 0 without labels, row 1
    with ``len`` 0, row 2 ending in the first quarter (an earlier chunk
    of every split), row 3 at the full length with the most labels, the
    others ragged."""
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(B, T, V)) * 2).astype(np.float32)
    labels = rng.integers(1, V, size=(B, L))
    lab_lens = np.array([0, 3, 2, L, 5, 4])
    lens = np.array([T - 5, 0, 9, T, 30, 21])
    labels = labels * (np.arange(L)[None] < lab_lens[:, None])
    return logits, labels, lens, lab_lens


def _operands(seed):
    logits, labels, lens, lab_lens = _batch(seed)
    return ctc.prepare(torch.from_numpy(logits), torch.from_numpy(labels),
                       torch.from_numpy(lens).int(),
                       torch.from_numpy(lab_lens).int())


def _chunked(prep, n):
    """The recursion over ``n`` chunks of T/n frames: alpha 0 -> n-1 with
    each chunk's tape's last row as the next one's ``alpha0``, the last
    chunk's log-likelihood, then beta n-1 -> 0 with each chunk's
    ``c_out`` as the one before's ``c_in``. Returns (ll, tape, gamma)
    with the chunks' rows concatenated."""
    lp, ext, skip, lens, s_last = prep
    tl = T // n
    tapes, band = [], None
    for k in range(n):
        ll, tape = ctc.ctc_alpha(lp[:, k * tl:(k + 1) * tl].contiguous(), ext,
                                 skip, lens, s_last, True, alpha0=band,
                                 t_off=k * tl)
        band = tape[:, -1].contiguous()
        tapes.append(tape)
    gammas, c = [None] * n, None
    for k in range(n - 1, -1, -1):
        gammas[k], c = ctc.ctc_beta(
            lp[:, k * tl:(k + 1) * tl].contiguous(), ext, skip, lens, s_last,
            tapes[k], ll, c_in=c, t_off=k * tl, return_carry=True)
    return ll, torch.cat(tapes, 1), torch.cat(gammas, 1)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_chunked_plain_recursion_is_the_unchunked_bits(n, seed):
    prep = _operands(seed)
    ll, tape = ctc.ctc_alpha_plain(*prep, tape=True)
    gamma = ctc.ctc_beta_plain(*prep, tape, ll)
    got = _chunked(prep, n)
    for g, r in zip(got, (ll, tape, gamma)):
        assert g.shape == r.shape
        assert torch.equal(g, r)
    assert bool(torch.isfinite(ll).all())
    # The len-0 row holds its init and has no gamma; the row that ends
    # in the first quarter has none past its end.
    assert torch.count_nonzero(gamma[1]) == 0
    assert torch.count_nonzero(gamma[2, 9:]) == 0
    assert torch.count_nonzero(gamma[2, :9]) > 0


def test_null_carries_are_the_unchunked_calls():
    """``alpha0=None``, ``c_in=None`` and ``t_off=0`` are the calls
    without them, bit for bit (loss-only too); ``c_out`` is ``beta +
    log_prob`` at frame 0, NEG where the row has no frame."""
    prep = _operands(2)
    ll, tape = ctc.ctc_alpha(*prep, tape=True)
    ll0, tape0 = ctc.ctc_alpha(*prep, tape=True, alpha0=None, t_off=0)
    lo, _ = ctc.ctc_alpha(*prep, tape=False)
    lo0, none = ctc.ctc_alpha(*prep, tape=False, alpha0=None, t_off=0)
    assert torch.equal(ll, ll0) and torch.equal(tape, tape0)
    assert torch.equal(lo, lo0) and torch.equal(lo, ll) and none is None
    gamma = ctc.ctc_beta(*prep, tape, ll)
    gamma0, c_out = ctc.ctc_beta(*prep, tape, ll, c_in=None, t_off=0,
                                 return_carry=True)
    assert torch.equal(gamma, gamma0)
    assert c_out.shape == (B, prep[1].shape[1])
    assert bool((c_out[1] == ctc.NEG).all())
    # gamma's states sum to 1 at a frame of a row that has it, up to the
    # rounding of alpha + beta - ll, terms of magnitude ~1e2 (1e-4).
    np.testing.assert_allclose(gamma[[0, 2, 3, 4, 5], 0].sum(-1).numpy(),
                               1.0, rtol=1e-4)


def test_an_offset_needs_the_carried_band():
    prep = _operands(3)
    with pytest.raises(ValueError, match="alpha0"):
        ctc.ctc_alpha(*prep, tape=True, t_off=8)
    with pytest.raises(ValueError, match=">= 0"):
        ctc.ctc_beta(*prep, *reversed(ctc.ctc_alpha(*prep, tape=True)),
                     t_off=-1)
    with pytest.raises(ValueError, match="alpha0 must be"):
        ctc.ctc_alpha(*prep, tape=True, alpha0=torch.zeros(B, 3), t_off=8)


def _jax_ref(logits, labels, lens, lab_lens):
    """JAX ``ctc_loss_ref``'s per-utterance loss and the gradient of its
    sum with respect to the logits."""
    def total(lg):
        per = jax_ctc_loss_ref(lg, jnp.asarray(labels), jnp.asarray(lens),
                               jnp.asarray(lab_lens))
        return per.sum(), per

    (_, per), grad = jax.value_and_grad(total, has_aux=True)(
        jnp.asarray(logits))
    return np.asarray(per), np.asarray(grad)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_sp_ctc_loss_matches_ctc_loss_and_jax(n):
    """``sp_ctc_loss`` over ``n`` shards: the loss and ``dlogits`` of
    ``ctc_loss`` on the whole logits, bit for bit, and JAX
    ``ctc_loss_ref``'s loss and gradient (module docstring's bounds)."""
    logits, labels, lens, lab_lens = _batch(4)
    rows = [0, 2, 3, 4, 5]  # JAX's reference has no len-0 row
    logits, labels, lens, lab_lens = (x[rows] for x in
                                      (logits, labels, lens, lab_lens))
    lab = torch.from_numpy(labels)
    il, ll_ = torch.from_numpy(lens), torch.from_numpy(lab_lens)
    whole = torch.from_numpy(logits).requires_grad_()
    ref = ctc.ctc_loss(whole, lab, il, ll_)
    (g_ref,) = torch.autograd.grad(ref.sum(), whole)
    x = torch.from_numpy(logits).requires_grad_()
    got = ctc.sp_ctc_loss(list(x.split(T // n, dim=1)), lab, il, ll_)
    (g_got,) = torch.autograd.grad(got.sum(), x)
    assert torch.equal(got, ref) and torch.equal(g_got, g_ref)
    per, grad = _jax_ref(logits, labels, lens, lab_lens)
    np.testing.assert_allclose(got.detach().numpy(), per, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(g_got.numpy(), grad, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)


def test_sp_ctc_loss_checks_the_labels_once():
    logits, labels, lens, lab_lens = _batch(5)
    bad = labels.copy()
    bad[3, 0] = V  # outside the vocabulary
    chunks = list(torch.from_numpy(logits).split(T // 4, dim=1))
    with pytest.raises(ValueError, match="labels must lie"):
        ctc.sp_ctc_loss(chunks, torch.from_numpy(bad),
                        torch.from_numpy(lens), torch.from_numpy(lab_lens))
    # Frame counts are the global ones: past a shard's, within T.
    with pytest.raises(ValueError, match="input_lens"):
        ctc.sp_ctc_loss(chunks, torch.from_numpy(labels),
                        torch.from_numpy(lens) + T,
                        torch.from_numpy(lab_lens))


# ---------------------------------------------------------------------------
# The kernels' decomposition with the carried band, mirrored as
# tests/test_torch_ctc_band.py mirrors the unchunked kernels: segments,
# ghost zones refreshed every h steps, the trims. A chunk's first step
# from the carried band reads NEG past a span's top as every step does,
# so it counts toward the next exchange; the mirror of chunks must equal
# the plain unchunked recursion bit for bit at every plan.
# ---------------------------------------------------------------------------

def mirror_alpha_chunk(lp, ext, skip, lens, s_last, p, alpha0, t_off):
    """``ctc_alpha`` with a tape as the kernel computes a chunk at plan
    ``p`` (``alpha0`` None: the recursion's first chunk)."""
    from test_torch_ctc_band import (_Warp, _blank_slots, _exchange, _lse2,
                                     _lse3_blank, _neg, _neighbours, _slots)

    bsz, t_max, _ = lp.shape
    s_max = ext.shape[1]
    slots, blank = _slots(p["k"], False), _blank_slots(p["k"], False)
    ll = torch.empty(bsz)
    out = torch.empty(bsz, t_max, s_max)
    neg = torch.tensor(ctc.NEG)
    for b in range(bsz):
        sl = int(s_last[b])
        n = min(max(int(lens[b]) - t_off, 0), t_max)
        warps = [_Warp(b, i, p, s_max, ext, skip, sl, True, slots)
                 for i in range(p["nseg"])]
        if alpha0 is None:
            start = 1
            a = [torch.where(w.live & ((w.s == 0) | ((w.s == 1) & (sl > 0))),
                             lp[b, 0, w.e], neg) for w in warps]
        else:
            start = 0
            a = [torch.where(w.live, alpha0[b, w.s.clamp(0, s_max - 1)], neg)
                 for w in warps]

        def store(t):
            for w, x in zip(warps, a):
                out[b, t, w.s[w.mine]] = x[w.mine]

        if start:
            store(0)
        until = p["h"]
        for t in range(start, n):
            for i, w in enumerate(warps):
                if w.first > min(sl, 2 * (t_off + t) + 1):
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
        for i, w in enumerate(warps):
            l1, _ = _neighbours(w, a[i], up=True)
            hit = w.mine & (w.s == sl)
            if bool(hit.any()):
                prev = l1[hit] if sl > 0 else torch.tensor([ctc.NEG])
                ll[b] = _lse2(a[i][hit], prev)[0]
        for t in range(max(n, start), t_max):
            store(t)
    return ll, out


def mirror_beta_chunk(lp, ext, skip, lens, s_last, alphas, loglik, p, c_in,
                      t_off):
    """``ctc_beta`` with ``return_carry`` as the kernel computes a chunk
    at plan ``p``: (gamma, c_out)."""
    from test_torch_ctc_band import (_Warp, _blank_slots, _exchange,
                                     _lse3_blank, _neg, _neighbours, _slots)

    bsz, t_max, _ = lp.shape
    s_max = ext.shape[1]
    k = p["k"]
    slots, blank = _slots(k, False), _blank_slots(k, False)
    gamma = torch.empty(bsz, t_max, s_max)
    c_out = torch.empty(bsz, s_max)
    for b in range(bsz):
        sl = int(s_last[b])
        n = min(max(int(lens[b]) - t_off, 0), t_max)
        past = c_in is not None and int(lens[b]) - t_off > t_max
        end = int(lens[b]) - t_off if past else n
        llb = loglik[b]
        warps = [_Warp(b, i, p, s_max, ext, skip, sl, False, slots)
                 for i in range(p["nseg"])]
        gamma[b, n:] = 0.0
        if n == 0:
            c_out[b] = ctc.NEG
            continue

        def store(t, betas):
            for w, beta in zip(warps, betas):
                s = w.s[w.mine].clamp(max=s_max - 1)
                occ = torch.exp(torch.clamp(alphas[b, t, s] + beta[w.mine]
                                            - llb, max=0.0))
                gamma[b, t, w.s[w.mine]] = torch.where(
                    w.live[w.mine], occ, torch.zeros_like(occ))

        def step(c):
            betas = []
            for i, w in enumerate(warps):
                r1, r2 = _neighbours(w, c[i], up=False)
                three = ctc._lse3(c[i], r1, torch.where(w.sk2, r2, _neg(r2)))
                two = _lse3_blank(c[i], r1)
                betas.append(torch.where(
                    w.live, torch.where(blank, two, three), _neg(three)))
            return betas

        until = p["h"]
        if past:
            top = step([torch.where(w.live,
                                    c_in[b, w.s.clamp(max=s_max - 1)],
                                    torch.tensor(ctc.NEG)) for w in warps])
        else:
            top = [torch.where((w.s == sl) | ((w.s == sl - 1) & (sl > 0)),
                               torch.tensor(0.0), torch.tensor(ctc.NEG))
                   for w in warps]
        store(n - 1, top)
        c = [torch.where(w.live, beta + lp[b, n - 1, w.e], _neg(beta))
             for w, beta in zip(warps, top)]
        if past and len(warps) > 1:
            until -= 1
            if until == 0:
                until = p["h"]
                _exchange(warps, c, p, False, s_max)
        for t in range(n - 2, -1, -1):
            betas = step(c)
            for i, w in enumerate(warps):
                if w.first + 32 * k - 1 < sl - 1 - 2 * (end - 1 - t):
                    betas[i] = _neg(c[i])
            store(t, betas)
            c = [torch.where(w.live, beta + lp[b, t, w.e], _neg(beta))
                 for w, beta in zip(warps, betas)]
            until -= 1
            if len(warps) > 1 and until == 0:
                until = p["h"]
                _exchange(warps, c, p, False, s_max)
        for w, x in zip(warps, c):
            c_out[b, w.s[w.mine]] = x[w.mine]
    return gamma, c_out


# (labels, C, KS, h): S = 35 with spare slots above beta's ghost zone;
# S = 47 and 143 in segments of exactly 32k - 2h states, where a ghost
# stale one step too long reaches the owned states (a chunk's first step
# not counted toward the exchange shows there).
MIRROR_PLANS = [(17, 1, 1, 1), (17, 2, 1, 6), (17, 4, 1, 4), (17, 1, 2, 8),
                (17, 2, 1, 2), (23, 1, 1, 8), (23, 1, 1, 4), (71, 1, 2, 8)]


@pytest.mark.parametrize("l_max,c,k,h", MIRROR_PLANS)
@pytest.mark.parametrize("n", [2, 4])
def test_chunked_kernel_mirror_is_the_unchunked_bits(n, l_max, c, k, h):
    """The kernels' segments and ghost zones over ``n`` chunks give the
    plain unchunked recursion's ll, tape and gamma bit for bit, and each
    chunk's ``c_out`` the plain chunk's, at plans of one or more CTAs,
    one or two states a lane and exchanges every 1 to 8 steps, with rows
    ending in every chunk."""
    from test_torch_ctc_band import _inputs as band_inputs
    from test_torch_ctc_band import _plan

    t = 40
    prep = band_inputs(50 + n + h, 6, t, 7, l_max)
    lp, ext, skip, lens, s_last = prep
    lens[4:] = torch.tensor([t // n - 1, t - 3], dtype=lens.dtype)
    p = _plan(6, ext.shape[1], c, k, h)
    if l_max > 17:
        assert p["own"] == 32 * k - 2 * h and p["nseg"] > 1
    ll_p, tape_p = ctc.ctc_alpha_plain(*prep, tape=True)
    gamma_p = ctc.ctc_beta_plain(*prep, tape_p, ll_p)
    tl = t // n
    tapes, band = [], None
    for i in range(n):
        ll, tape = mirror_alpha_chunk(lp[:, i * tl:(i + 1) * tl], ext, skip,
                                      lens, s_last, p, band, i * tl)
        band = tape[:, -1]
        tapes.append(tape)
    assert torch.equal(ll, ll_p) and torch.equal(torch.cat(tapes, 1), tape_p)
    gammas, cc = [None] * n, None
    for i in range(n - 1, -1, -1):
        chunk = lp[:, i * tl:(i + 1) * tl].contiguous()
        gammas[i], c_m = mirror_beta_chunk(chunk, ext, skip, lens, s_last,
                                           tapes[i], ll, p, cc, i * tl)
        _, c_p = ctc.ctc_beta_plain(chunk, ext, skip, lens, s_last, tapes[i],
                                    ll, cc, i * tl, return_carry=True)
        assert torch.equal(c_m, c_p)
        cc = c_m
    assert torch.equal(torch.cat(gammas, 1), gamma_p)
