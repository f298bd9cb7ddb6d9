"""The tensor-core path of the GRU backward (``csrc/gru_bwd_mma.cuh``,
which ``csrc/gru_bwd.cu`` (K5 at D=2, K7 at D=1, W held in shared
memory) and ``csrc/gru_bwd_stream.cu`` (K9, W partly streamed) run in
bf16), mirrored in torch in its order of summation, against
``gru_bwd_plain`` and the JAX package's resident ``_gru_bwd_kernel``
(K7) and ``_bigru_bwd_kernel`` (K5) in interpret mode; the rule that
picks K5/K7's C path and sizes its scratch; ``k7_variants.plan``
against the residency rule; and the variants' and ablations'
substitutions.

The loop cannot run here (no card, no nvcc): chip_smoke.py holds the
kernels to ``gru_bwd_plain`` on the card. What the mirror checks is
that the order the header describes computes the contract's function:
the gate pre-pass ``round(h_prev) @ W + bias`` for every row first; then
at each step the 3H-deep sum ``round(dg_{i-1}) @ W^T`` cut into 32-deep
chunks, chunk c taken by warp c % 8, each chunk two k16 steps whose
depths are the lanes' 16-byte pieces (k = 8l..8l+3, then 8l+4..8l+7),
each warp summing its chunks in turn and the warps' partial sums added
in warp order to dh's elementwise part; dy joins after. Tolerances:
1e-6 against the plain version with f32 dots and 1e-5 with bf16 (f32
sums in another order; the plain version adds the product to the
elementwise part in one expression), 1e-4 against the JAX kernels with
f32 dots (the JAX Pallas gradient tests' own).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeech_tpu.ops import rnn_pallas
from deepspeech_tpu_torch import k7_variants, k9_variants
from deepspeech_tpu_torch.k17_variants import built_value
from deepspeech_tpu_torch.ops import _build, gru

# One CPU thread for torch: parallel test workers share the machine's
# cores, and a thread pool in each worker oversubscribes them.
torch.set_num_threads(1)

T, B = 9, 5


def _args(seed, h, d, dtype, reverse=(False, True)):
    """``gru_bwd``'s arguments from numpy: xp [T,B,3H] and W [D,H,3H] in
    ``dtype``, a ragged mask, biases, the outputs of the plain forward
    and dy."""
    rng = np.random.default_rng(seed)
    xp = torch.from_numpy(
        rng.normal(size=(T, B, 3 * h)).astype(np.float32)).to(dtype)
    w = torch.from_numpy(
        (rng.normal(size=(d, h, 3 * h)) / np.sqrt(h)).astype(np.float32)
    ).to(dtype)
    bias = torch.from_numpy((rng.normal(size=(d, 3 * h)) * 0.1)
                            .astype(np.float32))
    lens = np.array([T, T - 3, 1, T - 1, 5])
    mask = torch.from_numpy(
        (np.arange(T)[:, None] < lens[None]).astype(np.float32))
    reverse = tuple(reverse[:d])
    ys, _ = gru.gru_fwd_plain(xp, mask, w, bias, None, reverse)
    dy = torch.from_numpy(
        (rng.normal(size=(d, T, B, h)) * 0.5).astype(np.float32))
    return xp, mask, w, bias, ys, dy, reverse


def _mirror(xp, mask, w, b, ys, dy, reverse, h0=None):
    """The header's loop in its order of summation (see the module
    docstring); the chunking and the warps, read from the header. With
    ``h0`` the pre-pass reads it as the first step's h_prev and one pass
    more forms ``dh0`` (returned third)."""
    head = k7_variants.header_text()
    warps, kc = built_value(head, "M_WARPS"), built_value(head, "MKC")
    t, bsz, n = xp.shape
    d, h = w.shape[0], w.shape[1]
    w32 = w.float()
    hp = gru._h_prev(ys, reverse, h0)
    steps = [[8 * lane + 4 * s + e for lane in range(4) for e in range(4)]
             for s in range(2)]
    dxp = torch.empty((d, t, bsz, n))
    dgates = torch.empty((d, t, bsz, n))
    dh0 = torch.empty((d, bsz, h))

    def product(di, g_prev):
        parts = torch.zeros(warps, bsz, h)
        for c in range(-(-n // kc)):
            for step in steps:
                p = [c * kc + x for x in step if c * kc + x < n]
                parts[c % warps] = (parts[c % warps]
                                    + g_prev[:, p] @ w32[di][:, p].t())
        s = torch.zeros(bsz, h)
        for ww in range(warps):
            s = s + parts[ww]
        return s

    for di in range(d):
        pre = (hp[di].to(w.dtype).float().reshape(t * bsz, h) @ w32[di]
               + b[di]).reshape(t, bsz, n)
        de = torch.zeros(bsz, h)
        g_prev = None
        for i in range(t):
            row = i if reverse[di] else t - 1 - i
            carry = de
            if i > 0:
                carry = carry + product(di, g_prev)
            x = xp[row].float()
            g = pre[row]
            gn = g[:, 2 * h:]
            r = torch.sigmoid(x[:, :h] + g[:, :h])
            z = torch.sigmoid(x[:, h:2 * h] + g[:, h:2 * h])
            nn_ = torch.tanh(x[:, 2 * h:] + r * gn)
            m = mask[row][:, None]
            dhc = carry + dy[di, row]
            dh_mid = m * dhc
            da_n = dh_mid * (1.0 - z) * (1.0 - nn_ * nn_)
            da_z = dh_mid * (hp[di, row] - nn_) * z * (1.0 - z)
            da_r = da_n * gn * r * (1.0 - r)
            dg = torch.cat([da_r, da_z, da_n * r], 1)
            dxp[di, row] = torch.cat([da_r, da_z, da_n], 1)
            dgates[di, row] = dg
            de = dh_mid * z + (1.0 - m) * dhc
            g_prev = dg.to(w.dtype).float()
        dh0[di] = de + product(di, g_prev)  # the tail pass
    return (dxp, dgates) if h0 is None else (dxp, dgates, dh0)


# ---------------------------------------------------------------------------
# The loop's order of summation.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.bfloat16, 1e-5)])
@pytest.mark.parametrize("reverse", [(False, True), (True, False)])
@pytest.mark.parametrize("d,h", [(2, 40), (1, 40), (2, 200), (1, 200)])
def test_loop_order_matches_plain(d, h, reverse, dtype, tol):
    """The mirror of the loop against ``gru_bwd_plain``: both round
    h_prev and dgates to the dot dtype at the same places and sum in f32
    in other orders. H=40 is 120 deep, four chunks (warps 4-7 hold
    none); H=200 is 600 deep, 19 chunks, warps 0-2 holding three."""
    args = _args(100 + h + d, h, d, dtype, reverse)
    got = _mirror(*args)
    ref = gru.gru_bwd_plain(*args)
    for g, r in zip(got, ref):
        assert g.shape == r.shape == (d, T, B, 3 * h)
        err = float((g - r).abs().max())
        assert err <= tol, err
    assert float(ref[1].abs().max()) > 0.1


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.bfloat16, 1e-5)])
@pytest.mark.parametrize("d,h", [(2, 40), (1, 200)])
def test_loop_order_with_h0_matches_plain(d, h, dtype, tol):
    """The mirror with a carried ``h0`` (the pre-pass's first rows read
    it) and the tail pass that forms ``dh0`` against ``gru_bwd_plain``
    with ``h0`` and ``return_dh0``."""
    xp, mask, w, bias, _, dy, reverse = _args(300 + h + d, h, d, dtype)
    h0 = torch.from_numpy((np.random.default_rng(h).normal(size=(d, B, h))
                           * 0.5).astype(np.float32))
    ys, _ = gru.gru_fwd_plain(xp, mask, w, bias, h0, reverse)
    args = (xp, mask, w, bias, ys, dy, reverse)
    got = _mirror(*args, h0=h0)
    ref = gru.gru_bwd_plain(*args, h0=h0, return_dh0=True)
    for g, r in zip(got, ref):
        err = float((g - r).abs().max())
        assert err <= tol, err
    assert float(ref[2].abs().max()) > 0.1


@pytest.mark.parametrize("h", [40, 200])
@pytest.mark.parametrize("reverse", [False, True])
def test_loop_order_matches_the_k7_pallas_kernel(reverse, h):
    """The mirror on the JAX forward's own outputs against ``_gru_bwd``'s
    ``dxp`` from the resident ``_gru_bwd_kernel`` (K7) in interpret mode,
    and dW and db formed from the mirror's dgates as ``_gru_bwd`` forms
    them, f32 dots."""
    assert not rnn_pallas._use_blocked(h, jnp.float32)
    xp, mask, w, bias, _, dy, _ = _args(200 + h, h, 1, torch.float32)
    xproj = xp.transpose(0, 1).contiguous().numpy()
    mask_bt = mask.t().contiguous().numpy()
    _, res = rnn_pallas._gru_fwd(
        jnp.asarray(xproj), jnp.asarray(mask_bt), jnp.asarray(w[0].numpy()),
        jnp.asarray(bias[0].numpy()), reverse, True, None)
    dxp_ref, _, dw_ref, db_ref = rnn_pallas._gru_bwd(
        reverse, True, None, res, jnp.asarray(dy[0].transpose(0, 1).numpy()))
    ys = torch.from_numpy(np.array(res[4]))[None]
    dxp, dgates = _mirror(xp, mask, w, bias, ys, dy, (reverse,))
    np.testing.assert_allclose(dxp[0].transpose(0, 1).numpy(),
                               np.asarray(dxp_ref), atol=1e-4, rtol=1e-4)
    hp = gru._h_prev(ys, (reverse,))[0].reshape(T * B, h).double()
    dw = hp.t() @ dgates[0].reshape(T * B, 3 * h).double()
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_ref), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(dgates[0].sum((0, 1)).numpy(),
                               np.asarray(db_ref), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("h", [40, 200])
def test_loop_order_matches_the_k5_pallas_kernel(h):
    """Both directions of the mirror at once (D=2, the second reversed)
    on the JAX forward's own outputs against ``_bigru_bwd``, the VJP of
    the fused ``_bigru_bwd_kernel`` (K5) in interpret mode: ``dxp``
    summed over the directions, and each direction's dW and db formed
    from the mirror's dgates, f32 dots."""
    assert rnn_pallas.bigru_fits_vmem(h)
    xp, mask, w, bias, _, dy, reverse = _args(300 + h, h, 2, torch.float32)
    xproj = jnp.asarray(xp.transpose(0, 1).contiguous().numpy())
    mask_bt = jnp.asarray(mask.t().contiguous().numpy())
    ws = [jnp.asarray(w[di].numpy()) for di in range(2)]
    bs = [jnp.asarray(bias[di].numpy()) for di in range(2)]
    _, res = rnn_pallas._bigru_fwd(xproj, mask_bt, ws[0], bs[0], ws[1],
                                   bs[1], True, None)
    # The layer's output is the sum of the directions: one dy for both.
    dy = dy[:1].expand(2, -1, -1, -1).contiguous()
    ref = rnn_pallas._bigru_bwd(True, None, res,
                                jnp.asarray(dy[0].transpose(0, 1).numpy()))
    ys = torch.stack([torch.from_numpy(np.array(res[6])),
                      torch.from_numpy(np.array(res[7]))])
    dxp, dgates = _mirror(xp, mask, w, bias, ys, dy, reverse)
    np.testing.assert_allclose(dxp.sum(0).transpose(0, 1).numpy(),
                               np.asarray(ref[0]), atol=1e-4, rtol=1e-4)
    hp = gru._h_prev(ys, reverse).reshape(2, T * B, h).double()
    for di in range(2):
        dw = hp[di].t() @ dgates[di].reshape(T * B, 3 * h).double()
        np.testing.assert_allclose(dw.numpy(), np.asarray(ref[2 + 2 * di]),
                                   atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(dgates[di].sum((0, 1)).numpy(),
                                   np.asarray(ref[3 + 2 * di]), atol=1e-4,
                                   rtol=1e-4)


# ---------------------------------------------------------------------------
# The C path rule, the scratch, and the launch's plan.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,h,mma", [
    (torch.bfloat16, 800, True),     # ds2_small, ds2_streaming
    (torch.bfloat16, 104, True),     # a multiple of 8, not of the groups
    (torch.bfloat16, 804, False),    # H % 8 != 0: the CUDA-core kernel
    (torch.bfloat16, 100, False),
    (torch.float32, 800, False),     # f32: the CUDA-core kernel
])
def test_path_rule_and_scratch(dtype, h, mma):
    """``_bwd_mma`` repeats ``gru_bwd_launch``'s rule: bf16, H % 8 == 0,
    w and ys 16-byte aligned (a view that starts 2 bytes in takes the
    CUDA-core kernel). The tensor-core path's scratch, dh's elementwise
    part [D,B,H] f32 and the two bf16 rounded dgates rows [2,D,B,3H], is
    the 4*D*B*H floats the C source's ``gru_bwd_mma_scratch_floats``
    returns, and the bf16 rows start 16-byte aligned."""
    d, bsz = 2, 5
    w = torch.zeros(d, h, 3 * h, dtype=dtype)
    ys = torch.zeros(d, 3, bsz, h)
    assert gru.gru_bwd_mma(dtype, h) is mma
    assert gru._bwd_mma(w, ys) is mma
    if mma:
        flat = torch.zeros(w.numel() + 8, dtype=dtype)
        assert not gru._bwd_mma(flat[1:1 + w.numel()].view(w.shape), ys)
        floats = d * bsz * h + 2 * d * bsz * 3 * h // 2
        assert floats == 4 * d * bsz * h
        assert (d * bsz * h * 4) % 16 == 0
    with open(os.path.join(_build.CSRC_DIR, "gru_bwd.cu")) as f:
        src = f.read()
    body = src[src.index("long long gru_bwd_mma_scratch_floats"):]
    assert body[:body.index("}")].rstrip().endswith(
        "return 4LL * D * B * H;")


@pytest.mark.parametrize("d,h,units,smem", [
    (2, 800, 16, 147456),    # ds2_small: 100 groups of 16
    (1, 800, 8, 139264),     # ds2_streaming: 100 groups of 8
    (2, 528, 8, 126976),     # 132 groups of 8 on 132 SMs
    (2, 536, 16, 122880),    # 134 would not: 68 groups of 16
    (2, 1056, 16, 172032),   # the D=2 edge: 132 groups of 16
    (1, 1056, 8, 151552),    # the widest D=1 H in groups of 8
    (1, 1704, 16, 229376),   # the D=1 edge: 224 KB of the 227 a block
])
def test_launch_plan(d, h, units, smem):
    """``k7_variants.plan`` with the source's constants, the launch's
    choice: the width, the block's shared memory (the rings, 64 KB at 4
    stages for groups of 16 and 96 KB at 6 for groups of 8, then every
    warp's chunks of the group's rows of W), and that it launches on an
    H100; ``ops/gru.py`` repeats both numbers."""
    values = {n: built_value(k7_variants.source_text(), n)
              for n in k7_variants.CONSTANTS}
    assert k7_variants.plan(values, d, h) == (units, smem, True)
    assert gru.gru_bwd_mma_width(d, h) == units
    assert gru.gru_bwd_mma_smem_bytes(units, h) == smem


def test_plan_agrees_with_the_residency_rule_at_every_size():
    """For every (D, H), H a multiple of 8 up to ds2_full's 1760, the
    residency rule admits bf16 exactly where the launch's plan launches,
    at the same width and bytes: the rule, the C launch and the variants
    script cannot part ways. ds2_full's H=1760 at D=2 stays on K9."""
    values = {n: built_value(k7_variants.source_text(), n)
              for n in k7_variants.CONSTANTS}
    admitted = 0
    for d in (1, 2):
        for h in range(8, 1768, 8):
            units, smem, launches = k7_variants.plan(values, d, h)
            fits = gru.resident_fits("bwd", d, h, 32, torch.bfloat16)
            assert fits is launches, (d, h)
            assert units == gru.gru_bwd_mma_width(d, h)
            assert smem == gru.resident_smem_bytes(
                "bwd", h, 32, torch.bfloat16, units)
            admitted += fits
    assert admitted == 1056 // 8 + 1704 // 8
    assert not gru.resident_fits("bwd", 2, 1760, 32, torch.bfloat16)


@pytest.mark.parametrize("dtype,d,h,b,aligned,resident", [
    (torch.bfloat16, 2, 800, 32, True, True),     # ds2_small
    (torch.bfloat16, 2, 800, 32, False, True),    # the CUDA-core block
    (torch.bfloat16, 2, 800, 512, True, True),    # any B on the mma path
    (torch.bfloat16, 2, 800, 512, False, False),  # 245,504 bytes a block
    (torch.bfloat16, 1, 1200, 8, True, True),     # 75 groups of 16
    (torch.bfloat16, 1, 1200, 8, False, False),   # a [1216, 48] f32 slice
    (torch.bfloat16, 1, 1704, 8, True, True),     # the D=1 edge
    (torch.bfloat16, 1, 1712, 8, True, False),    # 232 KB: K9
    (torch.float32, 2, 800, 32, True, True),
    (torch.float32, 2, 800, 512, True, False),
])
def test_residency_follows_the_c_path(dtype, d, h, b, aligned, resident):
    """``gru_bwd`` decides between K5/K7 and K9 on the layout of the
    kernel its C call will run: a bf16 W that is not 16-byte aligned
    runs the CUDA-core kernel (``_bwd_mma``), so it is sized as that
    kernel's block, which grows with B and holds W's slice as f32, and
    goes to K9 where that block does not fit, even where the tensor-core
    layout would."""
    w = torch.zeros(d * h * 3 * h + 8, dtype=dtype)
    w = w[:-8] if aligned else w[1:-7]
    w = w.view(d, h, 3 * h)
    ys = torch.zeros(d, 2, b, h)
    assert gru._bwd_mma(w, ys) is (aligned and dtype == torch.bfloat16)
    assert gru._bwd_resident(w, ys) is resident


# ---------------------------------------------------------------------------
# The variants script, the ablations and the build.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", list(k7_variants.VARIANTS))
def test_k7_variants_match_the_source(variant):
    """Each constant a ``k7_variants`` variant sets is held exactly once
    by ``csrc/gru_bwd.cu``, each substitution finds its text, and every
    variant launches at ds2_small's and ds2_streaming's shapes on an
    H100."""
    text = k7_variants.source_text()
    built = {n: built_value(text, n) for n in k7_variants.CONSTANTS}
    values = k7_variants.VARIANTS[variant]
    for old, new in k7_variants.substitutions(text, values):
        assert text.count(old) == 1 and new != old
    for d in (1, 2):
        assert k7_variants.plan({**built, **values}, d, 800)[2]


@pytest.mark.parametrize("name", list(k7_variants.ABLATIONS))
def test_k7_ablations_match_the_header(name):
    """Each ``k7_variants`` ablation finds the header text it replaces
    exactly once, and ``csrc/gru_bwd.cu`` the ``#include`` it pastes the
    header into, so the script times the loop it names."""
    [(old, new)] = k7_variants.ablation(k7_variants.ABLATIONS[name])
    assert k7_variants.source_text().count(old) == 1
    assert new != k7_variants.header_text()
    assert set(k7_variants.MUST_FAIL) <= set(k7_variants.ABLATIONS)


def test_both_sources_share_the_header_and_its_hash(tmp_path, monkeypatch):
    """K5/K7 and K9 include ``gru_bwd_mma.cuh`` once each, K9 instances
    its loop with its own constants (the 32-unit groups, 2 ring stages
    and 10 resident chunks ``k9_variants`` substitutes) and K5/K7 with
    all of W held, and an edit of the header rebuilds both: each
    library's name hashes the headers its source includes."""
    include = '#include "gru_bwd_mma.cuh"\n'
    texts = {}
    for name in ("gru_bwd", "gru_bwd_stream"):
        with open(os.path.join(_build.CSRC_DIR, f"{name}.cu")) as f:
            texts[name] = f.read()
        assert texts[name].count(include) == 1
    k9 = texts["gru_bwd_stream"]
    assert [built_value(k9, n) for n in ("MU", "MS", "W_RES")] == [32, 2, 10]
    assert "gru_bwd_mma::loop<MU, MS, W_RES>(" in k9
    assert "gru_bwd_mma::loop<MU, MS, gru_bwd_mma::W_ALL>(" in \
        texts["gru_bwd"]
    for subs in k9_variants.VARIANTS.values():
        for old, _ in subs:
            assert k9.count(old) == 1
    for name, text in texts.items():
        (tmp_path / f"{name}.cu").write_text(text)
    (tmp_path / "gru_bwd_mma.cuh").write_text(k7_variants.header_text())
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    before = {n: _build._target(n) for n in texts}
    (tmp_path / "gru_bwd_mma.cuh").write_text(
        k7_variants.header_text().replace("// ---- 1.", "// ---- one."))
    after = {n: _build._target(n) for n in texts}
    assert all(before[n] != after[n] for n in texts)
