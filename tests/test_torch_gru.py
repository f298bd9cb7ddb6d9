"""The port's GRU recurrence (ops/gru.py) against the JAX package's Pallas
GRU kernels run in interpret mode, as tests/test_pallas.py runs them.

On the CPU ``gru_fwd`` runs its plain version; the CUDA kernel is held
to that same plain version on the card by chip_smoke.py. Tolerances are
the JAX test's: 1e-5 in float32, 3e-2 with bf16 dots.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeech_tpu.models.rnn import gru_scan as jax_gru_scan
from deepspeech_tpu.ops.rnn_pallas import (bigru_scan_pallas,
                                           gru_scan_pallas,
                                           gru_scan_pallas_stream)
from deepspeech_tpu_torch.models.rnn import gru_scan
from deepspeech_tpu_torch.ops.gru import gru_fwd, gru_fwd_plain

# One CPU thread for torch: parallel test workers share the machine's
# cores, and a thread pool in each worker oversubscribes them.
torch.set_num_threads(1)

H, B, T = 48, 3, 40


def _inputs(seed, d=1, dot_dtype=None):
    """With bf16 dots, xproj holds bf16 values, as a bf16 model's
    projection does: the port takes it as bf16 and the JAX side as the
    same values in f32."""
    rng = np.random.default_rng(seed)
    xproj = rng.normal(size=(B, T, 3 * H)).astype(np.float32)
    if dot_dtype is not None:
        xproj = torch.from_numpy(xproj).bfloat16().float().numpy()
    ws = [(rng.normal(size=(H, 3 * H)) / np.sqrt(H)).astype(np.float32)
          for _ in range(d)]
    bs = [(rng.normal(size=(3 * H,)) * 0.1).astype(np.float32)
          for _ in range(d)]
    lens = np.array([T, T // 2 + 3, 1])
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    return xproj, mask, ws, bs


def _torch_args(xproj, mask, ws, bs, dot_dtype):
    dd = torch.float32 if dot_dtype is None else torch.bfloat16
    xp = torch.from_numpy(xproj).transpose(0, 1).contiguous().to(dd)
    return (xp, torch.from_numpy(mask).t().contiguous(),
            torch.stack([torch.from_numpy(w) for w in ws]).to(dd),
            torch.stack([torch.from_numpy(b) for b in bs]))


def _tol(dot_dtype):
    return 1e-5 if dot_dtype is None else 3e-2


@pytest.mark.parametrize("dot_dtype", [None, "bfloat16"])
def test_bigru_matches_pallas_bigru(dot_dtype):
    xproj, mask, (wf, wb), (bf, bb) = _inputs(7, 2, dot_dtype)
    ref = bigru_scan_pallas(jnp.asarray(xproj), jnp.asarray(mask),
                            jnp.asarray(wf), jnp.asarray(bf),
                            jnp.asarray(wb), jnp.asarray(bb), True,
                            dot_dtype)
    ys, _ = gru_fwd(*_torch_args(xproj, mask, [wf, wb], [bf, bb],
                                 dot_dtype), None, (False, True))
    got = (ys[0] + ys[1]).transpose(0, 1).numpy()
    tol = _tol(dot_dtype)
    np.testing.assert_allclose(got, np.asarray(ref), atol=tol, rtol=tol)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dot_dtype", [None, "bfloat16"])
def test_gru_matches_pallas_gru(reverse, dot_dtype):
    xproj, mask, ws, bs = _inputs(3, 1, dot_dtype)
    ref = gru_scan_pallas(jnp.asarray(xproj), jnp.asarray(mask),
                          jnp.asarray(ws[0]), jnp.asarray(bs[0]), reverse,
                          True, dot_dtype)
    ys, hfin = gru_fwd(*_torch_args(xproj, mask, ws, bs, dot_dtype), None,
                       (reverse,))
    tol = _tol(dot_dtype)
    np.testing.assert_allclose(ys[0].transpose(0, 1).numpy(),
                               np.asarray(ref), atol=tol, rtol=tol)
    # The final carry is the state after the scan's last step.
    last = 0 if reverse else T - 1
    np.testing.assert_array_equal(hfin[0].numpy(), ys[0, last].numpy())


@pytest.mark.parametrize("dot_dtype", [None, "bfloat16"])
def test_gru_stream_carry_matches_pallas_stream(dot_dtype):
    """h0 in, hfin out, over two chunks: the second chunk starts from
    the first chunk's hfin, as chunked streaming does."""
    xproj, mask, ws, bs = _inputs(11, 1, dot_dtype)
    h0 = np.random.default_rng(12).normal(size=(B, H)).astype(np.float32)
    tol = _tol(dot_dtype)
    h_jax, h_t = jnp.asarray(h0), torch.from_numpy(h0)[None]
    for sl in (slice(0, T // 2), slice(T // 2, T)):
        ref_ys, h_jax = gru_scan_pallas_stream(
            jnp.asarray(xproj[:, sl]), jnp.asarray(mask[:, sl]),
            jnp.asarray(ws[0]), jnp.asarray(bs[0]), h_jax, True, dot_dtype)
        ys, h_t = gru_fwd(*_torch_args(xproj[:, sl], mask[:, sl], ws, bs,
                                       dot_dtype), h_t, (False,))
        np.testing.assert_allclose(ys[0].transpose(0, 1).numpy(),
                                   np.asarray(ref_ys), atol=tol, rtol=tol)
        np.testing.assert_allclose(h_t[0].numpy(), np.asarray(h_jax),
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("dot_dtype", [None, torch.bfloat16])
def test_gru_scan_oracle_matches_jax_oracle(dot_dtype):
    xproj, mask, ws, bs = _inputs(9)
    h0 = np.random.default_rng(1).normal(size=(B, H)).astype(np.float32)
    ref_ys, ref_h = jax_gru_scan(
        jnp.asarray(xproj), jnp.asarray(mask), jnp.asarray(ws[0]),
        jnp.asarray(bs[0]), dot_dtype=None if dot_dtype is None
        else jnp.bfloat16, h0=jnp.asarray(h0), return_final=True)
    ys, h = gru_scan(torch.from_numpy(xproj), torch.from_numpy(mask),
                     torch.from_numpy(ws[0]), torch.from_numpy(bs[0]),
                     dot_dtype=dot_dtype, h0=torch.from_numpy(h0),
                     return_final=True)
    tol = 1e-5 if dot_dtype is None else 3e-2
    np.testing.assert_allclose(ys.numpy(), np.asarray(ref_ys), atol=tol,
                               rtol=tol)
    np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), atol=tol,
                               rtol=tol)
    with pytest.raises(ValueError, match="forward scans"):
        gru_scan(torch.from_numpy(xproj), torch.from_numpy(mask),
                 torch.from_numpy(ws[0]), torch.from_numpy(bs[0]),
                 reverse=True, return_final=True)


def test_masked_frames_hold_state():
    """A frame with mask 0 leaves h unchanged, in both directions: the
    reverse direction of a short row starts from 0 at len-1."""
    xproj, mask, ws, bs = _inputs(2, d=2)
    ys, _ = gru_fwd_plain(*_torch_args(xproj, mask, ws, bs, None), None,
                          (False, True))
    n = int(mask[1].sum())
    fw, bw = ys[0, :, 1].numpy(), ys[1, :, 1].numpy()
    np.testing.assert_array_equal(fw[n:], np.broadcast_to(fw[n - 1],
                                                          fw[n:].shape))
    np.testing.assert_array_equal(bw[n:], 0.0)


@pytest.mark.parametrize("bad", ["mask_dtype", "h0_shape", "reverse_len",
                                 "w_shape", "noncontig", "dtype_mismatch"])
def test_gru_fwd_rejects_malformed_input(bad):
    xproj, mask, ws, bs = _inputs(4)
    xp, m, w, b = _torch_args(xproj, mask, ws, bs, None)
    h0, rev = None, (False,)
    if bad == "mask_dtype":
        m = m.double()
    elif bad == "h0_shape":
        h0 = torch.zeros(1, B, H + 1)
    elif bad == "reverse_len":
        rev = (False, True)
    elif bad == "w_shape":
        w = w[:, :, :-3]
    elif bad == "dtype_mismatch":
        w = w.bfloat16()
    else:
        xp = xp.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError):
        gru_fwd(xp, m, w, b, h0, rev)
