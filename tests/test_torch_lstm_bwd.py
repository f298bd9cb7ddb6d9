"""The port's LSTM backward (``ops/lstm.py``: ``lstm_bwd_plain``,
``lstm_bwd``/``lstm_bwd_stream`` and ``LSTMFunction``) against the JAX
package's Pallas VJP of ``lstm_scan_pallas`` run in interpret mode,
resident (``_lstm_bwd_kernel``, K13) and forced blocked
(``_lstm_bwd_kernel_blocked``, K15: ``rnn_pallas._VMEM_WEIGHT_BUDGET``
monkeypatched to 0, as tests/test_pallas.py does); against autograd
through the port's plain forward; and the residency rule of the resident
backward kernel.

H=16 is one padded block of the JAX blocked kernel, H=176 two with a
padded tail (4H=704 -> 512 + 192). Tolerances: 1e-4 relative and
absolute in f32 (tests/test_pallas.py:497's); with bf16 dots 3e-2 of
the largest reference value (the JAX bf16 forward test's: both sides
round h_prev and dgates to bf16 at the same places but sum in other
orders, and a flipped rounding moves the steps after it; the port also
returns dxp in the bf16 of its input, where the JAX VJP keeps f32).

On the CPU the wrappers run the plain version; chip_smoke.py holds the
CUDA kernels (csrc/lstm_bwd.cu, csrc/lstm_bwd_stream.cu) to it on the
card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeech_tpu.ops import rnn_pallas
from deepspeech_tpu.ops.lstm_pallas import (_lstm_bwd, _lstm_fwd,
                                            lstm_scan_pallas)
from deepspeech_tpu_torch import bridge, k15_ablation
from deepspeech_tpu_torch.config import apply_overrides, get_config
from deepspeech_tpu_torch.models import DeepSpeech2
from deepspeech_tpu_torch.ops import gru, lstm
from deepspeech_tpu_torch.utils import quantize

# One CPU thread for torch: parallel test workers share the machine's
# cores, and a thread pool in each worker oversubscribes them.
torch.set_num_threads(1)

B, T = 3, 9


def _inputs(seed, h, d, bf16=False):
    """xproj [B,T,4H] (bf16 values when bf16), a ragged mask [B,T],
    W [D,H,4H], biases [D,4H] and dy [B,T,H], from numpy."""
    rng = np.random.default_rng(seed)
    xproj = rng.normal(size=(B, T, 4 * h)).astype(np.float32)
    if bf16:
        xproj = torch.from_numpy(xproj).bfloat16().float().numpy()
    w = (rng.normal(size=(d, h, 4 * h)) / np.sqrt(h)).astype(np.float32)
    bias = (rng.normal(size=(d, 4 * h)) * 0.1).astype(np.float32)
    lens = np.array([T, T - 3, 1])
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    dy = rng.normal(size=(B, T, h)).astype(np.float32)
    return xproj, mask, w, bias, dy


def _close(got, ref, bf16, name):
    ref = np.asarray(ref)
    if bf16:
        tol = 3e-2 * max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(got, ref, atol=tol, rtol=0, err_msg=name)
    else:
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4,
                                   err_msg=name)


def _force(monkeypatch, blocked, h):
    if blocked:
        monkeypatch.setattr(rnn_pallas, "_VMEM_WEIGHT_BUDGET", 0)
    assert rnn_pallas._use_blocked(h, jnp.float32, n_gates=4) is blocked


def _port_grads(xproj, mask, w, bias, dy, reverse, bf16):
    """Gradients of sum(dy * sum_d ys_d) through ``LSTMFunction``:
    (dxproj [B,T,4H], dW [D,H,4H], db [D,4H]) as numpy f32."""
    dd = torch.bfloat16 if bf16 else torch.float32
    xp = torch.from_numpy(xproj).transpose(0, 1).contiguous().to(dd)
    xp.requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    bt = torch.from_numpy(bias).requires_grad_()
    m = torch.from_numpy(mask).t().contiguous()
    ys, _ = lstm.LSTMFunction.apply(xp, m, wt, bt, None, None, reverse)
    assert ys.shape == (len(reverse), T, B, w.shape[1])
    (ys.sum(0).transpose(0, 1) * torch.from_numpy(dy)).sum().backward()
    assert xp.grad.dtype == dd and wt.grad.dtype == torch.float32
    return (xp.grad.float().transpose(0, 1).numpy(), wt.grad.numpy(),
            bt.grad.numpy())


# ---------------------------------------------------------------------------
# The plain BPTT against the Pallas backward kernels.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("h", [16, 176])
@pytest.mark.parametrize("dot", [None, "bfloat16"])
@pytest.mark.parametrize("reverse", [False, True])
def test_plain_dgates_are_both_pallas_outputs(monkeypatch, reverse, dot, h,
                                              blocked):
    """``lstm_bwd_plain`` on the JAX forward's own residuals (ys and the
    cs tape): its one dgates tensor is the Pallas kernel's ``dxp``, and
    formed into dW and db as ``_lstm_bwd`` forms them it gives that
    function's, which come from the kernel's second output ``dgates``."""
    _force(monkeypatch, blocked, h)
    bf16 = dot is not None
    xproj, mask, w, bias, dy = _inputs(10 + h, h, 1, bf16)
    _, res = _lstm_fwd(jnp.asarray(xproj), jnp.asarray(mask),
                       jnp.asarray(w[0]), jnp.asarray(bias[0]), reverse,
                       True, dot)
    ref_dxp, _, ref_dw, ref_db = _lstm_bwd(reverse, True, dot, res,
                                           jnp.asarray(dy))
    xp_t, mask_t, _, _, ys, cs = (np.array(x) for x in res)
    dd = torch.bfloat16 if bf16 else torch.float32
    dy_t = torch.from_numpy(dy).transpose(0, 1).contiguous()
    ys_t, cs_t = torch.from_numpy(ys), torch.from_numpy(cs)
    dgates = lstm.lstm_bwd_plain(
        torch.from_numpy(xp_t).to(dd), torch.from_numpy(mask_t[..., 0]),
        torch.from_numpy(w).to(dd), torch.from_numpy(bias), ys_t[None],
        cs_t[None], dy_t[None], (reverse,))
    assert dgates.shape == (1, T, B, 4 * h) and dgates.dtype == torch.float32
    _close(dgates[0].transpose(0, 1).numpy(), ref_dxp, bf16, "dxp")
    hp = gru._h_prev(ys_t[None], (reverse,))[0].reshape(T * B, h)
    dw = hp.double().t() @ dgates[0].reshape(T * B, 4 * h).double()
    _close(dw.float().numpy(), ref_dw, bf16, "dW from dgates")
    _close(dgates[0].sum((0, 1)).numpy(), ref_db, bf16, "db from dgates")


@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("dot", [None, "bfloat16"])
@pytest.mark.parametrize("reverse", [(False,), (True,), (False, True)])
def test_lstm_function_grads_match_pallas_vjp(monkeypatch, reverse, dot,
                                              blocked):
    """``LSTMFunction``'s (dxp, dW, db) against ``jax.vjp`` of
    ``lstm_scan_pallas``: one direction either way, and D=2 in one call
    against the JAX model's sum of a forward and a reverse call
    (models/rnn.py:288-290)."""
    h = 176
    _force(monkeypatch, blocked, h)
    bf16 = dot is not None
    xproj, mask, w, bias, dy = _inputs(20 + len(reverse) + reverse[0], h,
                                       len(reverse), bf16)

    def f(xp, ws, bs):
        return sum(lstm_scan_pallas(xp, jnp.asarray(mask), ws[i], bs[i],
                                    rev, True, dot)
                   for i, rev in enumerate(reverse))

    _, vjp = jax.vjp(f, *map(jnp.asarray, (xproj, w, bias)))
    ref_dxp, ref_dw, ref_db = vjp(jnp.asarray(dy))
    got_dxp, got_dw, got_db = _port_grads(xproj, mask, w, bias, dy, reverse,
                                          bf16)
    _close(got_dxp, ref_dxp, bf16, "dxproj")
    _close(got_dw, ref_dw, bf16, "dW")
    _close(got_db, ref_db, bf16, "db")


@pytest.mark.parametrize("reverse", [(False,), (True,), (False, True)])
def test_grads_match_autograd_through_plain_forward(reverse):
    """An independent oracle: autograd through ``lstm_fwd_plain``'s loop,
    in f32, where the closed-form BPTT must agree to rounding."""
    xproj, mask, w, bias, dy = _inputs(30, 24, len(reverse))
    got = _port_grads(xproj, mask, w, bias, dy, reverse, False)
    xp = torch.from_numpy(xproj).transpose(0, 1).contiguous()
    xp.requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    bt = torch.from_numpy(bias).requires_grad_()
    ys = lstm.lstm_fwd_plain(xp, torch.from_numpy(mask).t().contiguous(),
                             wt, bt, reverse)
    (ys.sum(0).transpose(0, 1) * torch.from_numpy(dy)).sum().backward()
    for g, r in zip(got, (xp.grad.transpose(0, 1), wt.grad, bt.grad)):
        np.testing.assert_allclose(g, r.numpy(), atol=1e-5, rtol=1e-5)


def test_masked_rows_pass_dh_and_dc_through():
    """A frame with mask 0 gives zero dgates, and dh and dc carry past it
    unchanged: a row of length 1 gets gradient at t=0 only, in both
    directions. The forward direction holds h on the frames after the
    row's end, so their dy reaches t=0; the reverse direction holds its
    zero state there, so theirs does not."""
    xproj, mask, w, bias, dy = _inputs(31, 24, 2)
    xp = torch.from_numpy(xproj).transpose(0, 1).contiguous()
    m = torch.from_numpy(mask).t().contiguous()
    wt, bt = torch.from_numpy(w), torch.from_numpy(bias)
    ys, cs = lstm.lstm_fwd_plain(xp, m, wt, bt, (False, True), tape=True)
    dys = torch.from_numpy(dy).transpose(0, 1).contiguous()
    dgates = lstm.lstm_bwd(xp, m, wt, bt, ys, cs, torch.stack([dys, dys]),
                           (False, True))
    short = dgates[:, :, 2]  # the row of length 1
    assert torch.count_nonzero(short[:, 1:]) == 0
    assert torch.count_nonzero(short[:, 0]) > 0
    dys2 = dys.clone()
    dys2[1:, 2] = 0.0
    again = lstm.lstm_bwd(xp, m, wt, bt, ys, cs, torch.stack([dys2, dys2]),
                          (False, True))
    assert not torch.equal(again[0, 0, 2], dgates[0, 0, 2])
    assert torch.equal(again[1, 0, 2], dgates[1, 0, 2])


# ---------------------------------------------------------------------------
# The wrappers and the guards.
# ---------------------------------------------------------------------------

def _port_bwd_args(seed=40, h=40, d=2, dot=torch.bfloat16):
    xproj, mask, w, bias, dy = _inputs(seed, h, d, dot == torch.bfloat16)
    xp = torch.from_numpy(xproj).transpose(0, 1).contiguous().to(dot)
    m = torch.from_numpy(mask).t().contiguous()
    wt, bt = torch.from_numpy(w).to(dot), torch.from_numpy(bias)
    rev = (False, True)[:d]
    ys, cs = lstm.lstm_fwd(xp, m, wt, bt, rev, tape=True)
    dys = torch.from_numpy(dy).transpose(0, 1).contiguous()
    return (xp, m, wt, bt, ys, cs, torch.stack([dys] * d), rev)


@pytest.mark.parametrize("dot", [torch.bfloat16, torch.float32])
def test_wrappers_run_the_plain_version_on_cpu(dot):
    """On CPU tensors ``lstm_bwd`` and ``lstm_bwd_stream`` are the plain
    version, bit for bit, and count no launch."""
    args = _port_bwd_args(dot=dot)
    counts = (lstm.lstm_bwd.launches, lstm.lstm_bwd_stream.launches)
    ref = lstm.lstm_bwd_plain(*args)
    assert torch.equal(lstm.lstm_bwd(*args), ref)
    assert torch.equal(lstm.lstm_bwd_stream(*args), ref)
    assert (lstm.lstm_bwd.launches, lstm.lstm_bwd_stream.launches) == counts


@pytest.mark.parametrize("bad", ["cs_shape", "dy_dtype", "ys_noncontig",
                                 "gates", "meta_device"])
def test_lstm_bwd_rejects_malformed_input(bad):
    """A tensor on another device never reaches the plain version, and
    the argument rules hold for both wrappers."""
    xp, m, w, b, ys, cs, dy, rev = _port_bwd_args(41, h=16, d=1,
                                                  dot=torch.float32)
    if bad == "cs_shape":
        cs = cs[:, :-1].contiguous()
    elif bad == "dy_dtype":
        dy = dy.double()
    elif bad == "ys_noncontig":
        ys = ys.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "gates":
        xp = xp[..., :3 * 16].contiguous()
    for fn in (lstm.lstm_bwd, lstm.lstm_bwd_stream):
        if bad == "meta_device":
            with pytest.raises(ValueError, match="cpu or cuda"):
                fn(*[x.to("meta") for x in (xp, m, w, b, ys, cs, dy)], rev)
        else:
            with pytest.raises(ValueError):
                fn(xp, m, w, b, ys, cs, dy, rev)


@pytest.mark.parametrize("needs_grad", [True, False])
def test_carried_state_raises(needs_grad):
    """``LSTMFunction`` takes a carried state whole: ``h0`` without
    ``c0``, or ``c0`` without ``h0``, raises, with or without a
    gradient; both together run, and a zero carry gives no carry's
    outputs bit for bit (the plain versions on the CPU)."""
    xproj, mask, w, bias, _ = _inputs(42, 16, 1)
    wt = torch.from_numpy(w).requires_grad_(needs_grad)
    args = (torch.from_numpy(xproj).transpose(0, 1).contiguous(),
            torch.from_numpy(mask).t().contiguous(), wt,
            torch.from_numpy(bias))
    zero = torch.zeros(1, B, 16)
    for h0, c0 in ((zero, None), (None, zero)):
        with pytest.raises(ValueError, match="both h0 and c0"):
            lstm.LSTMFunction.apply(*args, h0, c0, (False,))
    got = lstm.LSTMFunction.apply(*args, zero, zero.clone(), (False,))
    ref = lstm.LSTMFunction.apply(*args, None, None, (False,))
    assert all(torch.equal(g, r) for g, r in zip(got, ref))


def test_int8_lstm_under_grad_raises():
    """An int8 LSTM layer under a gradient raises through the int8 guard,
    which now stands ahead of both cell types (``lstm_scan_pallas_q`` has
    no VJP); without a gradient it serves."""
    cfg = apply_overrides(get_config("ds2_small"), {
        "model.rnn_type": "lstm", "model.rnn_hidden": "16",
        "model.rnn_layers": "2", "model.conv_channels": "4,4"})
    params, stats = bridge.init_params(cfg, torch.Generator().manual_seed(1))
    qtree, _ = quantize.quantize_params(params)
    model = DeepSpeech2(cfg.model, quantized=True)
    model.load_state_dict(bridge.from_flax(qtree, stats))
    feats, lens = torch.randn(2, 24, 161, requires_grad=True), \
        torch.tensor([24, 17])
    with pytest.raises(RuntimeError, match="inference only"):
        model.eval()(feats, lens)
    with torch.no_grad():
        logits, _ = model(feats, lens)
    assert torch.isfinite(logits).all()


# ---------------------------------------------------------------------------
# The residency rule of the resident backward kernel.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d,h,b,resident", [
    (2, 800, 32, True),     # ds2_small-lstm: 222 KB, 100 blocks
    (1, 800, 32, True),     # ds2_streaming-lstm: 50 blocks
    (2, 1760, 32, False),   # ds2_full-lstm: a 460 KB slice
    (2, 832, 32, True),     # h_pad 832: the widest H of that slice
    (2, 833, 32, False),    # h_pad 896
    (2, 800, 76, True),     # dh and dc grow with B: 232,448 bytes
    (2, 800, 77, False),    # 232,576 bytes
])
def test_residency_rule_of_the_lstm_backward(dtype, d, h, b, resident):
    """``resident`` is the answer of the CUDA-core kernel's layout, which
    stages the slice as f32 and which f32 and bf16 off the tensor-core
    rule (H % 8 != 0, as H=833) take; the JAX rule streams an f32 H=800
    LSTM (``fits_vmem(800, 4, 4)`` is false) and holds a bf16 one. bf16
    on the rule takes the tensor-core loop's layout, which gives the same
    answers at these sizes except that it does not grow with B: at
    B=77 it still holds W (``test_residency_rule_of_the_lstm_backward_in_
    bf16``)."""
    want = resident or (dtype == torch.bfloat16 and (d, h, b) == (2, 800, 77))
    assert gru.resident_fits("lstm_bwd", d, h, b, dtype) is want


@pytest.mark.parametrize("d,h,b,resident", [
    (2, 800, 32, True),     # ds2_small-lstm: 100 groups of 16, 168 KB
    (1, 800, 32, True),     # ds2_streaming-lstm: 100 groups of 8, 148 KB
    (2, 800, 1024, True),   # dh and dc live in the scratch: any B
    (2, 1056, 32, True),    # 132 groups of 16 on 132 SMs
    (2, 1064, 32, False),   # 134 groups
    (1, 1280, 32, True),    # 229,376 bytes a block
    (1, 1288, 32, False),   # 237,568 bytes
    (2, 1760, 32, False),   # ds2_full-lstm
    (2, 836, 32, False),    # off the rule: the f32 layout's answer
])
def test_residency_rule_of_the_lstm_backward_in_bf16(d, h, b, resident):
    """bf16 with H % 8 == 0 runs the tensor-core loop, whose block holds
    its group's rows of W in bf16 beside the rings
    (``resident_smem_bytes(..., torch.bfloat16, units)``), one block an
    SM; the width is 8 where D x ceil(H/8) groups fit the SMs, else 16.
    The answers at the presets are the f32 ones."""
    assert gru.resident_fits("lstm_bwd", d, h, b, torch.bfloat16) is resident
    units = gru.lstm_bwd_mma_width(d, h)
    assert units == (8 if d * -(-h // 8) <= gru.H100_SMS else 16)
    if h % 8 == 0:
        assert gru.resident_smem_bytes("lstm_bwd", h, b, torch.bfloat16,
                                       units) == \
            gru.lstm_bwd_mma_smem_bytes(units, h)


def test_lstm_backward_layout_and_the_other_answers_unchanged():
    """``resident_smem_bytes("lstm_bwd")`` repeats csrc/lstm_bwd.cu's
    layout byte for byte: the [832, 64] f32 slice, one [32, 68] tile for
    the h_prev chunk and the dgates tile, dh and dc; the GRU and LSTM
    forward kinds answer as before."""
    assert gru.resident_smem_bytes("lstm_bwd", 800, 32) == \
        4 * (64 * (832 + 4) + 32 * 68 + 2 * 32 * 16) == 226816
    assert gru.resident_smem_bytes("lstm_bwd", 800, 64) == \
        226816 + 4 * 2 * 32 * 16
    assert gru.resident_smem_bytes("lstm_fwd", 800, 32) == 224768
    assert gru.resident_smem_bytes("bwd", 800, 32) == \
        4 * (48 * (832 + 4) + 32 * 68 + 32 * 52 + 2 * 32 * 16)
    assert gru.resident_fits("bwd", 2, 800, 32, torch.bfloat16)
    assert gru.resident_fits("lstm_fwd", 2, 800, 32, torch.bfloat16)
    assert not gru.resident_fits("bwd", 2, 1760, 32, torch.bfloat16)
    assert not gru.resident_fits("lstm_bwd", 2, 800, 32, torch.bfloat16,
                                 sms=99)


@pytest.mark.parametrize("variant", [n for n, subs in
                                     k15_ablation.VARIANTS.items() if subs])
def test_k15_ablation_variants_match_the_source(variant):
    """Each ablation that ``deepspeech_tpu_torch.k15_ablation`` builds
    replaces text that ``csrc/lstm_bwd_stream.cu``, with the loop's
    header ``csrc/lstm_bwd_mma.cuh`` pasted in, holds exactly once, so
    the script measures the part it names."""
    src = k15_ablation.with_header("lstm_bwd_stream")
    for old, new in k15_ablation.VARIANTS[variant]:
        assert src.count(old) == 1
        assert new != old
