"""The port's GRU backward (ops/gru.py: ``gru_bwd`` through
``GRUFunction``) against the JAX package's Pallas VJPs run in interpret
mode, as tests/test_pallas.py runs them, and against autograd through
the port's plain forward.

On the CPU ``gru_bwd`` runs its plain version; chip_smoke.py holds the
CUDA kernel to that plain version on the card. Tolerances: 1e-4
(relative and absolute) in float32, the JAX Pallas gradient tests'
own; with bf16 dots 3e-2 of the largest reference value, the JAX bf16
forward test's tolerance, since the port returns dxp in the bf16 of its
input while the JAX VJP keeps it f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeech_tpu.ops.rnn_pallas import bigru_scan_pallas, gru_scan_pallas
from deepspeech_tpu_torch.ops.gru import GRUFunction, gru_bwd, gru_fwd_plain

# One CPU thread for torch: parallel test workers share the machine's
# cores, and a thread pool in each worker oversubscribes them.
torch.set_num_threads(1)

H, B, T = 24, 3, 20


def _inputs(seed, d, bf16):
    """xproj [B,T,3H] (bf16 values when bf16), mask [B,T], weights and
    biases per direction, dy [B,T,H], from numpy."""
    rng = np.random.default_rng(seed)
    xproj = rng.normal(size=(B, T, 3 * H)).astype(np.float32)
    if bf16:
        xproj = torch.from_numpy(xproj).bfloat16().float().numpy()
    ws = [(rng.normal(size=(H, 3 * H)) / np.sqrt(H)).astype(np.float32)
          for _ in range(d)]
    bs = [(rng.normal(size=(3 * H,)) * 0.1).astype(np.float32)
          for _ in range(d)]
    lens = np.array([T, T // 2 + 3, 1])
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    dy = rng.normal(size=(B, T, H)).astype(np.float32)
    return xproj, mask, ws, bs, dy


def _port_grads(xproj, mask, ws, bs, dy, reverse, bf16):
    """Gradients of sum(dy * sum_d ys_d) through GRUFunction:
    (dxproj [B,T,3H], [dW_d], [db_d]) as numpy f32."""
    dd = torch.bfloat16 if bf16 else torch.float32
    xp = torch.from_numpy(xproj).transpose(0, 1).contiguous().to(dd)
    xp.requires_grad_()
    w = torch.stack([torch.from_numpy(x) for x in ws]).requires_grad_()
    b = torch.stack([torch.from_numpy(x) for x in bs]).requires_grad_()
    m = torch.from_numpy(mask).t().contiguous()
    ys = GRUFunction.apply(xp, m, w, b, None, reverse)
    assert ys.shape == (len(ws), T, B, H)
    out = ys.sum(0).transpose(0, 1)
    (out * torch.from_numpy(dy)).sum().backward()
    assert xp.grad.dtype == dd and w.grad.dtype == torch.float32
    return (xp.grad.float().transpose(0, 1).numpy(),
            list(w.grad.numpy()), list(b.grad.numpy()))


def _close(got, ref, bf16, name):
    ref = np.asarray(ref)
    if bf16:
        tol = 3e-2 * max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(got, ref, atol=tol, rtol=0, err_msg=name)
    else:
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("bf16", [False, True])
def test_bigru_grads_match_pallas_bigru_vjp(bf16):
    """D=2 (K5): both directions in one call, outputs summed."""
    xproj, mask, (wf, wb), (bf, bb), dy = _inputs(1, 2, bf16)
    dot = "bfloat16" if bf16 else None
    f = lambda xp, wf_, bf_, wb_, bb_: bigru_scan_pallas(
        xp, jnp.asarray(mask), wf_, bf_, wb_, bb_, True, dot)
    _, vjp = jax.vjp(f, *map(jnp.asarray, (xproj, wf, bf, wb, bb)))
    dxp, dwf, dbf, dwb, dbb = vjp(jnp.asarray(dy))
    got_dxp, got_dw, got_db = _port_grads(xproj, mask, [wf, wb], [bf, bb],
                                          dy, (False, True), bf16)
    _close(got_dxp, dxp, bf16, "dxproj")
    for got, ref, name in zip(got_dw + got_db, (dwf, dwb, dbf, dbb),
                              ("dw_fw", "dw_bw", "db_fw", "db_bw")):
        _close(got, ref, bf16, name)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("bf16", [False, True])
def test_gru_grads_match_pallas_gru_vjp(reverse, bf16):
    """D=1 (K7), either direction."""
    xproj, mask, ws, bs, dy = _inputs(2, 1, bf16)
    dot = "bfloat16" if bf16 else None
    f = lambda xp, w, b: gru_scan_pallas(xp, jnp.asarray(mask), w, b,
                                         reverse, True, dot)
    _, vjp = jax.vjp(f, *map(jnp.asarray, (xproj, ws[0], bs[0])))
    dxp, dw, db = vjp(jnp.asarray(dy))
    got_dxp, got_dw, got_db = _port_grads(xproj, mask, ws, bs, dy,
                                          (reverse,), bf16)
    _close(got_dxp, dxp, bf16, "dxproj")
    _close(got_dw[0], dw, bf16, "dw")
    _close(got_db[0], db, bf16, "db")


@pytest.mark.parametrize("reverse", [(False,), (True,), (False, True)])
def test_grads_match_autograd_through_plain_forward(reverse):
    """An independent oracle: autograd through gru_fwd_plain's loop, in
    f32, where the closed-form BPTT must agree to rounding."""
    xproj, mask, ws, bs, dy = _inputs(3, len(reverse), False)
    got = _port_grads(xproj, mask, ws, bs, dy, reverse, False)
    xp = torch.from_numpy(xproj).transpose(0, 1).contiguous()
    xp.requires_grad_()
    w = torch.stack([torch.from_numpy(x) for x in ws]).requires_grad_()
    b = torch.stack([torch.from_numpy(x) for x in bs]).requires_grad_()
    ys, _ = gru_fwd_plain(xp, torch.from_numpy(mask).t().contiguous(), w, b,
                          None, reverse)
    (ys.sum(0).transpose(0, 1) * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_allclose(got[0], xp.grad.transpose(0, 1).numpy(),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(np.stack(got[1]), w.grad.numpy(), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(np.stack(got[2]), b.grad.numpy(), atol=1e-5,
                               rtol=1e-5)


def test_masked_rows_pass_dh_through():
    """A frame with mask 0 gives zero dxp/dgates, and its dh carries to
    the step before unchanged: a row of length 1 gets gradient at t=0
    only, in both directions."""
    xproj, mask, ws, bs, dy = _inputs(4, 2, False)
    xp = torch.from_numpy(xproj).transpose(0, 1).contiguous()
    m = torch.from_numpy(mask).t().contiguous()
    w = torch.stack([torch.from_numpy(x) for x in ws])
    b = torch.stack([torch.from_numpy(x) for x in bs])
    ys, _ = gru_fwd_plain(xp, m, w, b, None, (False, True))
    dys = torch.from_numpy(dy).transpose(0, 1).contiguous()
    dxp, dgates = gru_bwd(xp, m, w, b, ys, torch.stack([dys, dys]),
                          (False, True))
    assert dxp.shape == dgates.shape == (2, T, B, 3 * H)
    short = dxp[:, :, 2]  # the row of length 1
    assert torch.count_nonzero(short[:, 1:]) == 0
    assert torch.count_nonzero(short[:, 0]) > 0
    # dgates differs from dxp only in the n block (dg_n = da_n * r).
    np.testing.assert_array_equal(dxp[..., :2 * H].numpy(),
                                  dgates[..., :2 * H].numpy())


def test_h0_with_a_gradient_raises():
    """A carried h0 under a gradient was refused until the BPTT took h0
    and gave dh0 (the sequence-parallel relay's need); it now trains:
    h0 gets its gradient, and a zero h0 gives the gradients of none, bit
    for bit (tests/test_torch_gru_carry.py holds dh0 to JAX)."""
    xproj, mask, ws, bs, _ = _inputs(5, 1, False)
    xp = torch.from_numpy(xproj).transpose(0, 1).contiguous()
    w = torch.from_numpy(ws[0])[None].requires_grad_()
    args = (xp, torch.from_numpy(mask).t().contiguous(), w,
            torch.from_numpy(bs[0])[None])
    h0 = torch.zeros(1, B, H, requires_grad=True)
    GRUFunction.apply(*args, h0, (False,)).sum().backward()
    assert h0.grad.shape == (1, B, H)
    assert bool(torch.isfinite(h0.grad).all())
    assert torch.count_nonzero(h0.grad) > 0
    dw_h0, w.grad = w.grad, None
    GRUFunction.apply(*args, None, (False,)).sum().backward()
    assert torch.equal(w.grad, dw_h0)
    w.requires_grad_(False)  # no gradient asked: h0 is fine
    ys = GRUFunction.apply(*args, torch.zeros(1, B, H), (False,))
    assert ys.shape == (1, T, B, H)


@pytest.mark.parametrize("bad", ["ys_shape", "dy_dtype", "noncontig",
                                 "meta_device"])
def test_gru_bwd_rejects_malformed_input(bad):
    xproj, mask, ws, bs, dy = _inputs(6, 1, False)
    xp = torch.from_numpy(xproj).transpose(0, 1).contiguous()
    m = torch.from_numpy(mask).t().contiguous()
    w, b = torch.from_numpy(ws[0])[None], torch.from_numpy(bs[0])[None]
    ys = torch.zeros(1, T, B, H)
    d = torch.zeros(1, T, B, H)
    if bad == "ys_shape":
        ys = ys[:, :-1]
    elif bad == "dy_dtype":
        d = d.double()
    elif bad == "noncontig":
        d = d.transpose(1, 2).contiguous().transpose(1, 2)
    else:
        xp, m, w, b, ys, d = (x.to("meta") for x in (xp, m, w, b, ys, d))
        with pytest.raises(ValueError, match="cpu or cuda"):
            gru_bwd(xp, m, w, b, ys, d, (False,))
        return
    with pytest.raises(ValueError):
        gru_bwd(xp, m, w, b, ys, d, (False,))
