"""The LSTM backward with a carried state (K13 ``lstm_bwd`` and K15
``lstm_bwd_stream``'s ``hc0 = (h0, c0)`` and ``dcfin`` in, ``(dh0,
dc0)`` out) and ``LSTMFunction``'s gradient through its carry, on the
CPU through the plain versions.

- ``lstm_bwd_plain`` with ``hc0``, ``dcfin`` and ``return_dhc0`` against
  autograd through the JAX package's ``lstm_scan(..., hc0=...,
  return_final=True)`` (a reverse direction as a forward scan of the
  flipped frames, since JAX carries only forward scans) and through the
  port's own ``lstm_fwd_plain`` from the carry: dgates (the gradient of
  the gate pre-activations, the input projection's), dW, db, dh0 and dc0
  within 1e-5 (f32). The loss reads the outputs and both final carries:
  the final h's gradient joins ``dy`` at the scan's last row, the final
  c's is ``dcfin``.
- A zero carry and a zero ``dcfin`` give no carry's bits.
- Chunked relays, 1, 2 and 4 chunks, forward and reverse, f32 and bf16
  dots: each chunk's forward from the carry the chunk before handed over
  and its backward with the next chunk's ``dh0`` folded into ``dy``'s
  last scan row and its ``dc0`` as ``dcfin``, against one unsplit call
  with the same carry in and ``dcfin``: ``ys``, ``dgates``, ``dh0`` and
  ``dc0`` bit for bit. The same through ``LSTMFunction`` under
  autograd: ``ys`` and ``dxp`` bit for bit; dW and db sum the chunks'
  products in another order (1e-5 of their largest magnitude).
- ``LSTMFunction`` with a carry under ``torch.autograd.gradcheck`` in
  f64 (its own tolerances: eps 1e-6, atol 1e-5, rtol 1e-3). The
  wrappers take the kernels' dtypes, bf16 and f32, so the check routes
  ``LSTMFunction`` through the plain versions, which compute in f64 for
  f64 inputs.

chip_smoke.py holds the kernels to the plain versions, and their chunked
relays to one call, on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeech_tpu.models.rnn import lstm_scan as jax_lstm_scan
from deepspeech_tpu_torch.ops import gru, lstm
from deepspeech_tpu_torch.ops.lstm import LSTMFunction

# One CPU thread for torch: parallel test workers share the machine's
# cores, and a thread pool in each worker oversubscribes them.
torch.set_num_threads(1)

T, B, H = 12, 5, 8
TOL = 1e-5
LENS = np.array([T, T - 4, 1, 7, T - 1])  # rows ending in every chunk


def _inputs(seed, d, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)
    a = {"xp": f(T, B, 4 * H), "w": f(d, H, 4 * H) / np.sqrt(H),
         "b": f(d, 4 * H) * 0.1, "h0": f(d, B, H) * 0.5,
         "c0": f(d, B, H) * 0.5,
         "mask": (np.arange(T)[:, None] < LENS[None]).astype(np.float32),
         "r_ys": f(d, T, B, H), "r_h": f(d, B, H), "r_c": f(d, B, H)}
    a = {k: torch.from_numpy(v) for k, v in a.items()}
    a["xp"] = a["xp"].to(dtype)
    a["wd"] = a["w"].to(dtype)
    return a


def _last(reverse):
    return [0 if rev else -1 for rev in reverse]


def _dy(a, reverse):
    """``r_ys`` with the final h's gradient ``r_h`` at each direction's
    last scan row: the carry out is ``ys`` there."""
    dy = a["r_ys"].clone()
    for di, last in enumerate(_last(reverse)):
        dy[di, last] += a["r_h"][di]
    return dy


def _dw_db(ys, dgates, reverse, h0):
    d = ys.shape[0]
    hp = gru._h_prev(ys, reverse, h0).reshape(d, T * B, H)
    return (torch.bmm(hp.transpose(1, 2), dgates.reshape(d, T * B, 4 * H)),
            dgates.sum((1, 2)))


def _jax_direction(a, di, rev):
    """JAX autograd of ``sum(r_ys * ys) + sum(r_h * h) + sum(r_c * c)``
    through ``lstm_scan`` from ``(h0, c0)`` for direction ``di``:
    (dxp [T,B,4H], dW, db, dh0, dc0). A reverse direction is the forward
    scan of the flipped frames."""
    flip = (lambda x: x[::-1]) if rev else (lambda x: x)
    xp = jnp.asarray(flip(a["xp"].float().numpy()).transpose(1, 0, 2))
    mask = jnp.asarray(flip(a["mask"].numpy()).T)
    r_ys = jnp.asarray(flip(a["r_ys"][di].numpy()).transpose(1, 0, 2))

    def loss(xp, w, b, h0, c0):
        ys, (h, c) = jax_lstm_scan(xp, mask, w, b, hc0=(h0, c0),
                                   return_final=True)
        return (jnp.sum(ys * r_ys) + jnp.sum(h * a["r_h"][di].numpy())
                + jnp.sum(c * a["r_c"][di].numpy()))

    g = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        xp, *(jnp.asarray(a[k][di].numpy()) for k in ("w", "b", "h0", "c0")))
    dxp = flip(np.asarray(g[0]).transpose(1, 0, 2))
    return (dxp, *(np.asarray(x) for x in g[1:]))


def _port_plain(a, reverse):
    """``lstm_bwd_plain`` from the carry with ``dcfin``: (dgates, dW, db,
    dh0, dc0)."""
    hc0 = (a["h0"], a["c0"])
    ys, cs, (hf, cf) = lstm.lstm_fwd_plain(
        a["xp"], a["mask"], a["wd"], a["b"], reverse, True, hc0=hc0,
        return_final=True)
    for di, last in enumerate(_last(reverse)):
        assert torch.equal(hf[di], ys[di, last])
        assert torch.equal(cf[di], cs[di, last])
    dgates, (dh0, dc0) = lstm.lstm_bwd_plain(
        a["xp"], a["mask"], a["wd"], a["b"], ys, cs, _dy(a, reverse),
        reverse, hc0=hc0, dcfin=a["r_c"], return_dhc0=True)
    return (dgates, *_dw_db(ys, dgates, reverse, a["h0"]), dh0, dc0)


@pytest.mark.parametrize("d", [1, 2])
def test_bwd_plain_with_carry_matches_jax_autograd(d):
    a = _inputs(10 + d, d)
    reverse = (False, True)[:d]
    got = _port_plain(a, reverse)
    for di, rev in enumerate(reverse):
        ref = _jax_direction(a, di, rev)
        for name, g, r in zip(("dgates", "dW", "db", "dh0", "dc0"), got,
                              ref):
            np.testing.assert_allclose(g[di].numpy(), r, rtol=TOL, atol=TOL,
                                       err_msg=name)
    assert min(float(got[3].abs().max()), float(got[4].abs().max())) > 0.1


@pytest.mark.parametrize("reverse", [(False,), (True,), (False, True)])
def test_bwd_plain_with_carry_matches_torch_autograd(reverse):
    """The same against autograd through ``lstm_fwd_plain`` started
    from the carry (f32 dots: its rounding is the identity)."""
    d = len(reverse)
    a = _inputs(20 + d + reverse[0], d)
    leaves = {k: a[k].clone().requires_grad_() for k in
              ("xp", "w", "b", "h0", "c0")}
    ys, _, (h, c) = lstm.lstm_fwd_plain(
        leaves["xp"], a["mask"], leaves["w"], leaves["b"], reverse, True,
        hc0=(leaves["h0"], leaves["c0"]), return_final=True)
    ((ys * a["r_ys"]).sum() + (h * a["r_h"]).sum()
     + (c * a["r_c"]).sum()).backward()
    dgates, dw, db, dh0, dc0 = _port_plain(a, reverse)
    for name, g, r in (("dxp", dgates.sum(0), leaves["xp"].grad),
                       ("dW", dw, leaves["w"].grad),
                       ("db", db, leaves["b"].grad),
                       ("dh0", dh0, leaves["h0"].grad),
                       ("dc0", dc0, leaves["c0"].grad)):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=TOL, atol=TOL,
                                   err_msg=name)


@pytest.mark.parametrize("fn", ["lstm_bwd", "lstm_bwd_stream"])
@pytest.mark.parametrize("d", [1, 2])
def test_zero_carry_is_no_carry(d, fn):
    """A zero ``(h0, c0)`` and a zero ``dcfin`` give the bits of the
    call without them, with and without ``(dh0, dc0)``; the wrappers on
    CPU tensors are the plain version."""
    a = _inputs(30 + d, d)
    reverse = (False, True)[:d]
    ys, cs = lstm.lstm_fwd_plain(a["xp"], a["mask"], a["wd"], a["b"],
                                 reverse, True)
    args = (a["xp"], a["mask"], a["wd"], a["b"], ys, cs, a["r_ys"], reverse)
    wrapper = getattr(lstm, fn)
    none = wrapper(*args)
    zeros = torch.zeros(d, B, H)
    zero, (dh0, dc0) = wrapper(*args, hc0=(zeros, zeros.clone()),
                               dcfin=zeros.clone(), return_dhc0=True)
    also, dhc0 = wrapper(*args, return_dhc0=True)
    assert torch.equal(none, zero) and torch.equal(none, also)
    assert torch.equal(dh0, dhc0[0]) and torch.equal(dc0, dhc0[1])
    assert torch.equal(none, lstm.lstm_bwd_plain(*args))
    assert dh0.shape == dc0.shape == (d, B, H)


def _cuts(n):
    return [k * T // n for k in range(n + 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rev", [False, True])
@pytest.mark.parametrize("chunks", [1, 2, 4])
def test_chunked_bwd_relay_is_one_call(chunks, rev, dtype):
    """``chunks`` chunks in relay order, forward from the carry the chunk
    before handed over, backward with the next chunk's ``(dh0, dc0)``
    folded in, against one unsplit call with the same carry in and
    ``dcfin``: ys, dgates, dh0 and dc0 bit for bit."""
    a = _inputs(40 + chunks, 1, dtype)
    reverse, last = (rev,), 0 if rev else -1
    x, m, w, b = a["xp"], a["mask"], a["wd"], a["b"]
    hc0 = (a["h0"], a["c0"])
    ys1, cs1 = lstm.lstm_fwd(x, m, w, b, reverse, True, hc0=hc0)
    ref, ref_dhc0 = lstm.lstm_bwd(x, m, w, b, ys1, cs1, a["r_ys"], reverse,
                                  hc0=hc0, dcfin=a["r_c"], return_dhc0=True)
    cuts = _cuts(chunks)
    order = list(range(chunks))[::-1 if rev else 1]
    ys, cs, carries, carry = {}, {}, {}, hc0
    for k in order:
        sl = slice(cuts[k], cuts[k + 1])
        carries[k] = carry
        ys[k], cs[k], carry = lstm.lstm_fwd(
            x[sl], m[sl].contiguous(), w, b, reverse, True, hc0=carry,
            return_final=True)
    dg, fold = {}, (None, a["r_c"])
    for k in order[::-1]:
        sl = slice(cuts[k], cuts[k + 1])
        dy = a["r_ys"][:, sl].clone()
        if fold[0] is not None:
            dy[:, last] += fold[0]
        dg[k], fold = lstm.lstm_bwd(
            x[sl], m[sl].contiguous(), w, b, ys[k], cs[k], dy, reverse,
            hc0=carries[k], dcfin=fold[1], return_dhc0=True)
    assert torch.equal(torch.cat([ys[k] for k in range(chunks)], 1), ys1)
    assert torch.equal(torch.cat([dg[k] for k in range(chunks)], 1), ref)
    assert torch.equal(fold[0], ref_dhc0[0])
    assert torch.equal(fold[1], ref_dhc0[1])


def _relay(a, rev, chunks, dtype, w, b):
    """One direction through ``LSTMFunction`` over ``chunks`` chunks,
    each from the carry the one before handed over (``ys``'s last scan
    row and the final c), the first from ``(h0, c0)``; the gradients of
    ``sum(r_ys * ys) + sum(r_c * c)`` with c the last chunk's."""
    xp = a["xp"].to(dtype).detach().requires_grad_()
    h0 = a["h0"].clone().requires_grad_()
    c0 = a["c0"].clone().requires_grad_()
    cuts = _cuts(chunks)
    order = range(chunks - 1, -1, -1) if rev else range(chunks)
    ys, carry = [None] * chunks, (h0, c0)
    for k in order:
        sl = slice(cuts[k], cuts[k + 1])
        y, c = LSTMFunction.apply(xp[sl], a["mask"][sl].contiguous(), w, b,
                                  *carry, (rev,))
        ys[k], carry = y, (y[:, 0 if rev else -1], c)
    out = torch.cat(ys, 1)
    ((out * a["r_ys"]).sum() + (carry[1] * a["r_c"]).sum()).backward()
    return out.detach(), xp.grad, h0.grad, c0.grad


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rev", [False, True])
@pytest.mark.parametrize("chunks", [2, 4])
def test_chunked_lstm_function_relay_matches_one_call(chunks, rev, dtype):
    a = _inputs(50 + chunks, 1, dtype)
    got, ref = {}, {}
    for n, out in ((chunks, got), (1, ref)):
        w = a["w"].clone().requires_grad_()
        b = a["b"].clone().requires_grad_()
        out["ys"], out["dxp"], out["dh0"], out["dc0"] = _relay(
            a, rev, n, dtype, w, b)
        out["dw"], out["db"] = w.grad, b.grad
    for k in ("ys", "dxp", "dh0", "dc0"):
        assert torch.equal(got[k], ref[k]), k
    for k in ("dw", "db"):
        scale = float(ref[k].abs().max())
        assert float((got[k] - ref[k]).abs().max()) <= TOL * scale, k
    assert float(ref["dc0"].abs().max()) > 0.1


def test_lstm_function_carry_gradients_are_the_bwd_call():
    """``LSTMFunction``'s ``h0`` and ``c0`` gradients are ``lstm_bwd``'s
    ``(dh0, dc0)`` with the gradient on its final c as ``dcfin``, and
    dW's first row takes ``h0`` as its h_prev, at D=2."""
    a = _inputs(60, 2)
    reverse = (False, True)
    leaves = {k: a[k].clone().requires_grad_() for k in ("w", "h0", "c0")}
    ys, c = LSTMFunction.apply(a["xp"], a["mask"], leaves["w"], a["b"],
                               leaves["h0"], leaves["c0"], reverse)
    ((ys * a["r_ys"]).sum() + (c * a["r_c"]).sum()).backward()
    ys_p, cs_p = lstm.lstm_fwd_plain(a["xp"], a["mask"], a["w"], a["b"],
                                     reverse, True, hc0=(a["h0"], a["c0"]))
    dgates, (dh0, dc0) = lstm.lstm_bwd_plain(
        a["xp"], a["mask"], a["w"], a["b"], ys_p, cs_p, a["r_ys"], reverse,
        hc0=(a["h0"], a["c0"]), dcfin=a["r_c"], return_dhc0=True)
    assert torch.equal(leaves["h0"].grad, dh0)
    assert torch.equal(leaves["c0"].grad, dc0)
    dw, _ = _dw_db(ys_p, dgates, reverse, a["h0"])
    assert torch.equal(leaves["w"].grad, dw)


@pytest.mark.parametrize("reverse", [(False,), (True,), (False, True)])
def test_lstm_function_gradcheck_f64(reverse, monkeypatch):
    monkeypatch.setattr(lstm, "lstm_fwd", lstm.lstm_fwd_plain)
    monkeypatch.setattr(lstm, "lstm_bwd", lstm.lstm_bwd_plain)
    d, t, bsz, h = len(reverse), 4, 2, 3
    rng = np.random.default_rng(70 + d + reverse[0])
    f = lambda *shape: torch.from_numpy(rng.normal(size=shape)).requires_grad_()
    xp, w, b = f(t, bsz, 4 * h), f(d, h, 4 * h), f(d, 4 * h)
    h0, c0 = f(d, bsz, h), f(d, bsz, h)
    mask = torch.tensor([[1.0, 1.0], [1.0, 1.0], [1.0, 0.0], [1.0, 0.0]],
                        dtype=torch.float64)

    def fn(xp, w, b, h0, c0):
        return LSTMFunction.apply(xp, mask, w, b, h0, c0, reverse)

    assert torch.autograd.gradcheck(fn, (xp, w, b, h0, c0), eps=1e-6,
                                    atol=1e-5, rtol=1e-3)
