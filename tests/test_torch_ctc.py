"""The port's CTC (ops/ctc.py) against the JAX package's: the kernels'
contract through ``ctc_loss`` against ``ctc_loss_pallas`` in interpret
mode (its primal, the loss-only kernel K3, and ``jax.grad``, the taped
alpha K1 and beta K2), as tests/test_pallas.py runs them; the plain
recursions against ``ops/ctc.py``'s; and the loss and gradient against
``torch.nn.functional.ctc_loss`` as an independent oracle.

On the CPU ``ctc_alpha``/``ctc_beta`` run their plain versions;
chip_smoke.py holds the CUDA kernels to them on the card. Tolerances
are the JAX Pallas CTC tests': loss 1e-5, gradient 1e-4 relative and
1e-5 absolute, all in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deepspeech_tpu.ops import ctc as jax_ctc
from deepspeech_tpu.ops.ctc_pallas import ctc_loss_pallas
from deepspeech_tpu_torch.ops import ctc

# One CPU thread for torch: parallel test workers share the machine's
# cores, and a thread pool in each worker oversubscribes them.
torch.set_num_threads(1)

B, T, V, L = 5, 24, 7, 6


def _batch(seed, b=B, t=T, v=V, lmax=L):
    """Logits and labels from numpy, with the edge cases in fixed rows:
    row 0 has no label (L=0); row 1 exactly 2L+1 frames; row 2 one
    label repeated (every skip illegal); row 3 fewer frames than T."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(b, t, v)).astype(np.float32) * 2
    labels = rng.integers(1, v, size=(b, lmax)).astype(np.int32)
    label_lens = rng.integers(1, lmax + 1, size=b).astype(np.int32)
    label_lens[0] = 0
    label_lens[1] = lmax
    labels[2] = 3
    label_lens[2] = lmax
    labels = labels * (np.arange(lmax)[None] < label_lens[:, None])
    input_lens = np.array([
        int(rng.integers(2 * n + 1, t + 1)) for n in label_lens], np.int32)
    input_lens[1] = 2 * lmax + 1
    input_lens[3] = min(input_lens[3], t - 5)
    input_lens[2] = t
    return logits, labels.astype(np.int32), input_lens, label_lens


def _torch(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _port_loss_and_grad(logits, labels, input_lens, label_lens):
    lg, lb, il, ll = _torch(logits, labels, input_lens, label_lens)
    lg.requires_grad_()
    loss = ctc.ctc_loss(lg, lb, il, ll)
    loss.sum().backward()
    return loss.detach().numpy(), lg.grad.numpy()


def _close_loss(got, ref):
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-5)


def _close_grad(got, ref):
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("seed,b,t,v,lmax", [
    (0, B, T, V, L),
    (1, 4, 28, 29, 8),   # the English vocab
    (2, 5, 13, 5, 6),    # long labels against short time (tight 2L+1)
])
def test_loss_and_grad_match_pallas_ctc(seed, b, t, v, lmax):
    args = _batch(seed, b, t, v, lmax)
    jargs = [jnp.asarray(a) for a in args]
    ref_loss = ctc_loss_pallas(*jargs, True)  # primal: the loss-only kernel
    ref_grad = jax.grad(lambda lg: jnp.sum(
        ctc_loss_pallas(lg, *jargs[1:], True)))(jargs[0])  # taped + beta
    loss, grad = _port_loss_and_grad(*args)
    _close_loss(loss, ref_loss)
    _close_grad(grad, ref_grad)
    with torch.no_grad():
        _close_loss(ctc.ctc_loss(*_torch(*args)).numpy(), ref_loss)


def test_matches_torch_ctc_loss():
    """torch's own CTC (an independent implementation) on the same
    log-probs: per-utterance loss and the gradient w.r.t. the logits."""
    logits, labels, input_lens, label_lens = _batch(3)
    loss, grad = _port_loss_and_grad(logits, labels, input_lens, label_lens)
    lg = torch.from_numpy(logits).requires_grad_()
    ref = F.ctc_loss(torch.log_softmax(lg, -1).transpose(0, 1),
                     torch.from_numpy(labels).long(),
                     torch.from_numpy(input_lens).long(),
                     torch.from_numpy(label_lens).long(), blank=0,
                     reduction="none")
    ref.sum().backward()
    _close_loss(loss, ref.detach().numpy())
    _close_grad(grad, lg.grad.numpy())


def test_closed_form_matches_autograd_and_jax_oracle():
    """ctc_grad (alpha/beta closed form) against autograd through the
    plain loop (ctc_loss_ref), and both against the JAX ops/ctc.py."""
    args = _batch(4)
    lg, lb, il, ll = _torch(*args)
    loss_cf, grad_cf = ctc.ctc_grad(lg, lb, il, ll)
    lg.requires_grad_()
    loss_ref = ctc.ctc_loss_ref(lg, lb, il, ll)
    loss_ref.sum().backward()
    jl, jg = jax_ctc.ctc_grad(*[jnp.asarray(a) for a in args])
    _close_loss(loss_cf.numpy(), loss_ref.detach().numpy())
    _close_loss(loss_cf.numpy(), jl)
    _close_grad(grad_cf.numpy(), lg.grad.numpy())
    _close_grad(grad_cf.numpy(), jg)


def test_plain_recursions_match_jax():
    """forward_alphas / backward_betas against ops/ctc.py's, and the
    kernels' plain versions (tape, occupancy) against them."""
    args = _batch(5)
    lp = torch.log_softmax(torch.from_numpy(args[0]), -1)
    _, lb, il, ll = _torch(*args)
    jlp = jax.nn.log_softmax(jnp.asarray(args[0]), -1)
    jargs = [jnp.asarray(a) for a in args[1:]]
    ref_alphas, ref_ll = jax_ctc.forward_alphas(jlp, *jargs)
    ref_betas = jax_ctc.backward_betas(jlp, *jargs)
    alphas, loglik = ctc.forward_alphas(lp, lb, il, ll)
    betas = ctc.backward_betas(lp, lb, il, ll)
    # NEG-held states differ by rounding of -1e30; compare log-space
    # values above -1e29 only, and exp() of all.
    for got, ref in ((alphas, ref_alphas), (betas, ref_betas)):
        ref = np.asarray(ref)
        live = ref > -1e29
        np.testing.assert_allclose(got.numpy()[live], ref[live], rtol=1e-5,
                                   atol=1e-4)
        assert np.array_equal(got.numpy() > -1e29, live)
    _close_loss(loglik.numpy(), ref_ll)

    prep = ctc.prepare(*_torch(*args))
    ll_k, tape = ctc.ctc_alpha(*prep, tape=True)
    _close_loss(ll_k.numpy(), ref_ll)
    live = alphas.transpose(0, 1) > -1e29
    np.testing.assert_allclose(tape[live].numpy(),
                               alphas.transpose(0, 1)[live].numpy(),
                               rtol=1e-5, atol=1e-4)
    gamma = ctc.ctc_beta(*prep, tape, ll_k)
    occ = torch.exp(torch.clamp(alphas + betas - loglik[None, :, None],
                                max=0.0)).transpose(0, 1)
    valid = prep[3][:, None, None] > torch.arange(T)[None, :, None]
    _close_grad(gamma.numpy(), (occ * valid).numpy())
    ll_lo, none = ctc.ctc_alpha(*prep, tape=False)
    assert none is None
    np.testing.assert_array_equal(ll_lo.numpy(), ll_k.numpy())


def test_edge_cases_are_finite_and_exact():
    """L=0: the loss is -sum of the blank log-probs. T=2L+1 and a
    repeated label (a blank forced between repeats): finite losses."""
    logits, labels, input_lens, label_lens = _batch(6)
    loss, grad = _port_loss_and_grad(logits, labels, input_lens, label_lens)
    assert np.isfinite(loss).all() and np.isfinite(grad).all()
    lp = torch.log_softmax(torch.from_numpy(logits), -1).numpy()
    n0 = input_lens[0]
    np.testing.assert_allclose(loss[0], -lp[0, :n0, 0].sum(), rtol=1e-5)
    assert loss[1] > 0 and loss[2] > 0
    # Frames past input_len get no gradient.
    assert np.count_nonzero(grad[3, input_lens[3]:]) == 0


def test_fold_and_gradient_are_bit_stable():
    """The fold into vocab bins (a one-hot product, no atomics) and the
    whole gradient: two runs give the same bits."""
    args = _batch(7)
    _, g1 = _port_loss_and_grad(*args)
    _, g2 = _port_loss_and_grad(*args)
    np.testing.assert_array_equal(g1, g2)
    rng = np.random.default_rng(8)
    vals = torch.from_numpy(rng.random((B, T, 2 * L + 1)).astype(np.float32))
    ext = ctc.transition_masks(torch.from_numpy(args[1]).long(),
                               torch.from_numpy(args[3]).long())[0]
    a = ctc.scatter_ext_to_vocab(vals, ext, V)
    np.testing.assert_array_equal(a.numpy(),
                                  ctc.scatter_ext_to_vocab(vals, ext,
                                                           V).numpy())
    ref = torch.zeros(B, T, V).scatter_add_(
        2, ext[:, None, :].expand(B, T, -1), vals)
    np.testing.assert_allclose(a.numpy(), ref.numpy(), rtol=1e-6, atol=1e-6)


def test_grad_path_tapes_and_eval_path_does_not(monkeypatch):
    """With a gradient asked: one taped alpha and one beta; without: one
    loss-only alpha and no beta (the eval loss)."""
    calls = []
    real_alpha, real_beta = ctc.ctc_alpha, ctc.ctc_beta
    monkeypatch.setattr(ctc, "ctc_alpha", lambda *a, tape: (
        calls.append(("alpha", tape)), real_alpha(*a, tape=tape))[1])
    monkeypatch.setattr(ctc, "ctc_beta", lambda *a: (
        calls.append(("beta",)), real_beta(*a))[1])
    args = _batch(9)
    _port_loss_and_grad(*args)
    assert calls == [("alpha", True), ("beta",)]
    calls.clear()
    with torch.no_grad():
        ctc.ctc_loss(*_torch(*args))
    assert calls == [("alpha", False)]


@pytest.mark.parametrize("bad", ["label_range", "label_len", "input_len"])
def test_ctc_loss_rejects_out_of_range_inputs(bad):
    logits, labels, input_lens, label_lens = _batch(10)
    if bad == "label_range":
        labels[1, 0] = V
    elif bad == "label_len":
        label_lens[1] = L + 1
    else:
        input_lens[0] = T + 1
    with pytest.raises(ValueError, match="ctc_loss"):
        ctc.ctc_loss(*_torch(logits, labels, input_lens, label_lens))


@pytest.mark.parametrize("bad", ["lp_dtype", "ext_dtype", "skip_shape",
                                 "too_wide", "meta_device"])
def test_kernel_wrappers_reject_malformed_input(bad):
    lp, ext, skip, il, sl = ctc.prepare(*_torch(*_batch(11)))
    if bad == "lp_dtype":
        lp = lp.double()
    elif bad == "ext_dtype":
        ext = ext.long()
    elif bad == "skip_shape":
        skip = skip[:, :-1]
    elif bad == "too_wide":
        ext = torch.zeros(B, ctc.MAX_S + 1, dtype=torch.int32)
        skip = torch.zeros(B, ctc.MAX_S + 1, dtype=torch.bool)
    else:
        lp, ext, skip, il, sl = (x.to("meta") for x in (lp, ext, skip, il,
                                                        sl))
    with pytest.raises(ValueError):
        ctc.ctc_alpha(lp, ext, skip, il, sl, tape=False)
