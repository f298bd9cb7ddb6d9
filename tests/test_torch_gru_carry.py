"""The GRU backward with a carried state (K7/K5 ``gru_bwd`` and K9
``gru_bwd_stream``'s ``h0`` in and ``dh0`` out) and ``GRUFunction``'s
gradient through its ``h0``, on the CPU through the plain versions.

- ``gru_bwd_plain`` with ``h0`` and ``return_dh0`` against autograd
  through the JAX package's ``gru_scan(..., h0=..., return_final=True)``
  (a reverse direction as a forward scan of the flipped frames, since JAX
  carries only forward scans): dxp, dW, db and dh0 within 1e-5 (f32; the
  loss reads both the outputs and the final carry, whose gradient the
  port passes through ``dy`` at the scan's last row).
- A chunked ``GRUFunction`` relay (each chunk's ``h0`` the chunk
  before's last ``ys`` row, the sequence-parallel relay's call) against
  one unchunked call: the same steps in the same order, so ``dxp`` and
  the outputs are its bits; dW and db sum the chunks' products in
  another order (1e-5 relative).
- ``GRUFunction`` with an ``h0`` that needs a gradient returns it, and a
  zero ``h0`` gives the gradients of none, bit for bit.

The kernels are held to the plain versions, and a chunked relay to an
unchunked call, on the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeech_tpu.models.rnn import gru_scan as jax_gru_scan
from deepspeech_tpu_torch.ops import gru
from deepspeech_tpu_torch.ops.gru import GRUFunction

# One CPU thread for torch: parallel test workers share the machine's
# cores, and a thread pool in each worker oversubscribes them.
torch.set_num_threads(1)

T, B, H = 12, 5, 8
TOL = 1e-5
LENS = np.array([T, T - 4, 1, 7, T - 1])  # rows ending in every chunk


def _inputs(seed, d, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    xp = rng.normal(size=(T, B, 3 * H)).astype(np.float32)
    w = (rng.normal(size=(d, H, 3 * H)) / np.sqrt(H)).astype(np.float32)
    b = (rng.normal(size=(d, 3 * H)) * 0.1).astype(np.float32)
    h0 = (rng.normal(size=(d, B, H)) * 0.5).astype(np.float32)
    mask = (np.arange(T)[:, None] < LENS[None]).astype(np.float32)
    r_ys = rng.normal(size=(d, T, B, H)).astype(np.float32)
    r_fin = rng.normal(size=(d, B, H)).astype(np.float32)
    return {"xp": torch.from_numpy(xp).to(dtype), "w": torch.from_numpy(w),
            "b": torch.from_numpy(b), "h0": torch.from_numpy(h0),
            "mask": torch.from_numpy(mask), "r_ys": torch.from_numpy(r_ys),
            "r_fin": torch.from_numpy(r_fin)}


def _jax_direction(a, di, rev):
    """JAX autograd of ``sum(r_ys * ys) + sum(r_fin * hfin)`` through
    ``gru_scan`` from ``h0`` for direction ``di``: (dxp [T,B,3H], dW, db,
    dh0). A reverse direction is the forward scan of the flipped
    frames."""
    flip = (lambda x: x[::-1]) if rev else (lambda x: x)
    xp = jnp.asarray(flip(a["xp"].float().numpy()).transpose(1, 0, 2))
    mask = jnp.asarray(flip(a["mask"].numpy()).T)
    r_ys = jnp.asarray(flip(a["r_ys"][di].numpy()).transpose(1, 0, 2))
    r_fin = jnp.asarray(a["r_fin"][di].numpy())

    def loss(xp, w, b, h0):
        ys, fin = jax_gru_scan(xp, mask, w, b, h0=h0, return_final=True)
        return jnp.sum(ys * r_ys) + jnp.sum(fin * r_fin)

    g = jax.grad(loss, argnums=(0, 1, 2, 3))(
        xp, jnp.asarray(a["w"][di].numpy()), jnp.asarray(a["b"][di].numpy()),
        jnp.asarray(a["h0"][di].numpy()))
    dxp = flip(np.asarray(g[0]).transpose(1, 0, 2))
    return dxp, np.asarray(g[1]), np.asarray(g[2]), np.asarray(g[3])


@pytest.mark.parametrize("d", [1, 2])
def test_bwd_plain_with_h0_matches_jax_autograd(d):
    a = _inputs(10 + d, d)
    reverse = (False, True)[:d]
    ys, hfin = gru.gru_fwd_plain(a["xp"], a["mask"], a["w"], a["b"], a["h0"],
                                 reverse)
    # The final carry is ys at the scan's last row: its gradient joins dy.
    dy = a["r_ys"].clone()
    for di, rev in enumerate(reverse):
        assert torch.equal(hfin[di], ys[di, 0 if rev else -1])
        dy[di, 0 if rev else -1] += a["r_fin"][di]
    dxp, dgates, dh0 = gru.gru_bwd_plain(a["xp"], a["mask"], a["w"], a["b"],
                                         ys, dy, reverse, a["h0"], True)
    hp = gru._h_prev(ys, reverse, a["h0"]).reshape(d, T * B, H)
    dw = torch.bmm(hp.transpose(1, 2), dgates.reshape(d, T * B, 3 * H))
    db = dgates.sum((1, 2))
    for di, rev in enumerate(reverse):
        ref = _jax_direction(a, di, rev)
        for got, want in zip((dxp[di], dw[di], db[di], dh0[di]), ref):
            np.testing.assert_allclose(got.numpy(), want, rtol=TOL,
                                       atol=TOL)
    assert float(dh0.abs().max()) > 0.1


@pytest.mark.parametrize("d", [1, 2])
def test_bwd_without_h0_is_the_bptt_from_zeros(d):
    """No ``h0`` and a zero one give the same bits, with and without
    ``dh0``; the wrappers on CPU tensors are the plain version."""
    a = _inputs(20 + d, d)
    reverse = (False, True)[:d]
    ys, _ = gru.gru_fwd_plain(a["xp"], a["mask"], a["w"], a["b"], None,
                              reverse)
    args = (a["xp"], a["mask"], a["w"], a["b"], ys, a["r_ys"], reverse)
    none = gru.gru_bwd(*args)
    zero = gru.gru_bwd(*args, h0=torch.zeros(d, B, H), return_dh0=True)
    stream = gru.gru_bwd_stream(*args, h0=None, return_dh0=True)
    for x, y, z in zip(none, zero, stream):
        assert torch.equal(x, y) and torch.equal(x, z)
    assert torch.equal(zero[2], stream[2])
    assert zero[2].shape == (d, B, H)


def _relay(a, rev, chunks, dtype, w, b):
    """One direction through ``GRUFunction`` over ``chunks`` chunks of
    T/chunks frames, each from the carry the one before handed over
    (``ys``'s last scan row), and ``sum(r_ys * ys)``'s gradients; the
    chunk order is the scan's (reversed for ``rev``)."""
    xp = a["xp"].to(dtype).detach().requires_grad_()
    tl = T // chunks
    order = range(chunks - 1, -1, -1) if rev else range(chunks)
    ys, carry = [None] * chunks, None
    for k in order:
        sl = slice(k * tl, (k + 1) * tl)
        y = GRUFunction.apply(xp[sl], a["mask"][sl].contiguous(), w, b,
                              None if carry is None else carry[None],
                              (rev,))[0]
        ys[k], carry = y, y[0 if rev else -1]
    out = torch.cat(ys, 0)
    (out * a["r_ys"][0]).sum().backward()
    return out.detach(), xp.grad


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rev", [False, True])
@pytest.mark.parametrize("chunks", [2, 4])
def test_chunked_relay_matches_one_call(chunks, rev, dtype):
    a = _inputs(30 + chunks, 1, dtype)
    got, ref = {}, {}
    for n, out in ((chunks, got), (1, ref)):
        w = a["w"].clone().requires_grad_()
        b = a["b"].clone().requires_grad_()
        out["ys"], out["dxp"] = _relay(a, rev, n, dtype, w, b)
        out["dw"], out["db"] = w.grad, b.grad
    assert torch.equal(got["ys"], ref["ys"])
    assert torch.equal(got["dxp"], ref["dxp"])
    for k in ("dw", "db"):
        scale = float(ref[k].abs().max())
        assert float((got[k] - ref[k]).abs().max()) <= TOL * scale, k


def test_gru_function_returns_dh0():
    """``GRUFunction``'s ``h0`` gradient is ``gru_bwd``'s ``dh0``; its
    input projection's and weights' gradients are those of the call with
    the same h0 made without a gradient on it."""
    a = _inputs(40, 2)
    reverse = (False, True)
    h0 = a["h0"].clone().requires_grad_()
    w = a["w"].clone().requires_grad_()
    ys = GRUFunction.apply(a["xp"], a["mask"], w, a["b"], h0, reverse)
    (ys * a["r_ys"]).sum().backward()
    ys_p, _ = gru.gru_fwd_plain(a["xp"], a["mask"], a["w"], a["b"], a["h0"],
                                reverse)
    _, _, dh0 = gru.gru_bwd_plain(a["xp"], a["mask"], a["w"], a["b"], ys_p,
                                  a["r_ys"], reverse, a["h0"], True)
    assert torch.equal(h0.grad, dh0)
    w2 = a["w"].clone().requires_grad_()
    GRUFunction.apply(a["xp"], a["mask"], w2, a["b"], a["h0"],
                      reverse).mul(a["r_ys"]).sum().backward()
    assert torch.equal(w.grad, w2.grad)
