"""The streamed GRU regime of the port (ops/gru.py): the residency rule
that picks the resident or the streamed kernel, and ``GRUFunction`` in
the sizes that take the streamed kernels against the JAX package's
blocked Pallas kernels (``_gru_kernel_blocked``, ``_gru_bwd_kernel_blocked``)
run in interpret mode, as tests/test_pallas.py runs them: the residency
budget is forced to 0 inside the test only, so H=176 (3H=528, two
512-column blocks) takes the blocked path.

On the CPU the wrappers run their plain versions; chip_smoke.py holds
the CUDA kernels to those plain versions on the card. Tolerances: 1e-4
in float32 (the JAX Pallas gradient tests' own), 3e-2 of the largest
reference value with bf16 dots (the JAX bf16 test's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeech_tpu.ops import rnn_pallas
from deepspeech_tpu.ops.rnn_pallas import gru_scan_pallas
from deepspeech_tpu_torch.config import get_config
from deepspeech_tpu_torch.ops import gru
from test_torch_gru_bwd import _close

H, B, T = 176, 3, 9


@pytest.fixture
def force_blocked(monkeypatch):
    monkeypatch.setattr(rnn_pallas, "_VMEM_WEIGHT_BUDGET", 0)
    assert rnn_pallas._use_blocked(H, jnp.float32)
    assert rnn_pallas._block_layout(3 * H) == (2, 512)


# ---------------------------------------------------------------------------
# The residency rule.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["fwd", "bwd"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d,h,resident", [
    (1, 800, True), (2, 800, True),        # ds2_streaming, ds2_small
    (2, 1760, False), (1, 1760, False),    # ds2_full, one direction
    (2, 1056, True), (2, 1072, False),     # 132 vs 134 blocks on 132 SMs
])
def test_residency_rule_at_the_sizes_that_matter(kind, dtype, d, h,
                                                 resident):
    assert gru.resident_fits(kind, d, h, 32, dtype) is resident


@pytest.mark.parametrize("preset,resident", [
    ("ds2_small", True), ("ds2_streaming", True), ("ds2_full", False)])
def test_presets_take_their_kernels(preset, resident):
    """At the main paths' batch (32) each preset's layers run the kernel
    that holds them: ds2_small and ds2_streaming stay on the resident
    kernels, ds2_full streams, forward and backward."""
    m = get_config(preset).model
    d = 2 if m.bidirectional else 1
    for kind in ("fwd", "bwd"):
        assert gru.resident_fits(kind, d, m.rnn_hidden, 32,
                                 torch.bfloat16) is resident


def test_residency_rule_reads_the_card():
    """The card's limits are parameters: a card with half the SMs cannot
    hold ds2_small's 100 blocks; one with less shared memory per block
    cannot hold its 169 KB slice; the backward's carried dh grows with
    the batch until the slice no longer fits."""
    args = ("fwd", 2, 800, 32, torch.bfloat16)
    assert gru.resident_fits(*args)
    assert not gru.resident_fits(*args, sms=66)
    assert not gru.resident_fits(*args, smem_per_block=160 * 1024)
    smem = gru.resident_smem_bytes("fwd", 800, 32)
    assert smem == 4 * (48 * (832 + 4) + 32 * 68)
    assert gru.resident_smem_bytes("bwd", 800, 64) > \
        gru.resident_smem_bytes("bwd", 800, 32) > smem
    assert not gru.resident_fits("bwd", 1, 800, 2048, torch.float32)
    with pytest.raises(ValueError):
        gru.resident_fits("fwd", 1, 800, 32, torch.float16)
    with pytest.raises(ValueError):
        gru.resident_smem_bytes("both", 800, 32)


# ---------------------------------------------------------------------------
# GRUFunction against the blocked Pallas kernels.
# ---------------------------------------------------------------------------

def _inputs(seed, d, bf16):
    """xproj [B,T,3H] (bf16 values when bf16), ragged mask [B,T],
    weights and biases per direction, dy [B,T,H], from numpy."""
    rng = np.random.default_rng(seed)
    xproj = rng.normal(size=(B, T, 3 * H)).astype(np.float32)
    if bf16:
        xproj = torch.from_numpy(xproj).bfloat16().float().numpy()
    ws = [(rng.normal(size=(H, 3 * H)) / np.sqrt(H)).astype(np.float32)
          for _ in range(d)]
    bs = [(rng.normal(size=(3 * H,)) * 0.1).astype(np.float32)
          for _ in range(d)]
    lens = np.array([T, T - 3, 2])
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    dy = rng.normal(size=(B, T, H)).astype(np.float32)
    return xproj, mask, ws, bs, dy


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("reverse", [(False,), (True,), (False, True)])
def test_gru_function_matches_blocked_pallas(force_blocked, reverse, bf16):
    """The summed outputs of D directions and the gradients of
    sum(dy * out) with respect to xproj, each W and each b, against one
    blocked ``gru_scan_pallas`` per direction (the JAX model's
    composition when a BiGRU misses the budget, models/rnn.py:287)."""
    d = len(reverse)
    xproj, mask, ws, bs, dy = _inputs(10 + d, d, bf16)
    dot = "bfloat16" if bf16 else None
    m = jnp.asarray(mask)

    def jax_out(xp, ws_, bs_):
        return sum(gru_scan_pallas(xp, m, w, b, rev, True, dot)
                   for w, b, rev in zip(ws_, bs_, reverse))

    primals = (jnp.asarray(xproj), [jnp.asarray(w) for w in ws],
               [jnp.asarray(b) for b in bs])
    ref, vjp = jax.vjp(jax_out, *primals)
    dxp_ref, dws_ref, dbs_ref = vjp(jnp.asarray(dy))

    dd = torch.bfloat16 if bf16 else torch.float32
    xp = torch.from_numpy(xproj).transpose(0, 1).contiguous().to(dd)
    xp.requires_grad_()
    w = torch.stack([torch.from_numpy(x) for x in ws]).requires_grad_()
    b = torch.stack([torch.from_numpy(x) for x in bs]).requires_grad_()
    ys = gru.GRUFunction.apply(xp, torch.from_numpy(mask).t().contiguous(),
                               w, b, None, reverse)
    out = ys.sum(0).transpose(0, 1)
    _close(out.detach().numpy(), ref, bf16, "ys")
    (out * torch.from_numpy(dy)).sum().backward()
    _close(xp.grad.float().transpose(0, 1).numpy(), dxp_ref, bf16, "dxproj")
    for di in range(d):
        _close(w.grad[di].numpy(), dws_ref[di], bf16, f"dw[{di}]")
        _close(b.grad[di].numpy(), dbs_ref[di], bf16, f"db[{di}]")


@pytest.mark.parametrize("h0", [False, True])
def test_stream_wrappers_run_the_plain_versions_on_cpu(h0):
    """On CPU tensors ``gru_fwd_stream`` and ``gru_bwd_stream`` are their
    plain versions, bit for bit, and count no launch."""
    xproj, mask, ws, bs, dy = _inputs(3, 2, False)
    xp = torch.from_numpy(xproj).transpose(0, 1).contiguous()
    m = torch.from_numpy(mask).t().contiguous()
    w = torch.stack([torch.from_numpy(x) for x in ws])
    b = torch.stack([torch.from_numpy(x) for x in bs])
    hh = torch.full((2, B, H), 0.25) if h0 else None
    launches = (gru.gru_fwd_stream.launches, gru.gru_bwd_stream.launches)
    ys, hfin = gru.gru_fwd_stream(xp, m, w, b, hh, (False, True))
    ys_p, hfin_p = gru.gru_fwd_plain(xp, m, w, b, hh, (False, True))
    assert torch.equal(ys, ys_p) and torch.equal(hfin, hfin_p)
    dys = torch.from_numpy(dy).transpose(0, 1).contiguous()
    dys = torch.stack([dys, 0.5 * dys])
    got = gru.gru_bwd_stream(xp, m, w, b, ys, dys, (False, True))
    ref = gru.gru_bwd_plain(xp, m, w, b, ys, dys, (False, True))
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert (gru.gru_fwd_stream.launches,
            gru.gru_bwd_stream.launches) == launches


@pytest.mark.parametrize("fn", ["gru_fwd_stream", "gru_bwd_stream"])
def test_stream_wrappers_reject_other_devices_and_bad_shapes(fn):
    xproj, mask, ws, bs, _ = _inputs(4, 1, False)
    xp = torch.from_numpy(xproj).transpose(0, 1).contiguous()
    m = torch.from_numpy(mask).t().contiguous()
    w, b = torch.from_numpy(ws[0])[None], torch.from_numpy(bs[0])[None]
    extra = (None,) if fn == "gru_fwd_stream" else (
        torch.zeros(1, T, B, H), torch.zeros(1, T, B, H))
    meta = [x.to("meta") if x is not None else None
            for x in (xp, m, w, b, *extra)]
    with pytest.raises(ValueError, match="cpu or cuda"):
        getattr(gru, fn)(*meta, (False,))
    with pytest.raises(ValueError):
        getattr(gru, fn)(xp[:, :, :-1].contiguous(), m, w, b, *extra,
                         (False,))
