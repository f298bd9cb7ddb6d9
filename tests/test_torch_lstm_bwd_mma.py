"""The tensor-core path of the LSTM backward (``csrc/lstm_bwd_mma.cuh``,
which ``csrc/lstm_bwd.cu`` (K13, W held in shared memory) and
``csrc/lstm_bwd_stream.cu`` (K15, W streamed) run in bf16), mirrored in
torch in its order of summation, against ``lstm_bwd_plain`` and the JAX
package's resident ``_lstm_bwd_kernel`` in interpret mode; the rule
that picks K13's C path and sizes its scratch; ``k13_variants.plan``
against the residency rule; and the variants' and ablations'
substitutions.

The loop cannot run here (no card, no nvcc): chip_smoke.py holds the
kernels to ``lstm_bwd_plain`` on the card. What the mirror checks is
that the order the header describes computes the contract's function:
the gate pre-pass ``round(h_prev) @ W + bias`` for every row first; then
at each step the 4H-deep sum ``round(dg_{i-1}) @ W^T`` cut into 32-deep
chunks, chunk c taken by warp c % 8, each chunk two k16 steps whose
depths are the lanes' 16-byte pieces (k = 8l..8l+3, then 8l+4..8l+7),
each warp summing its chunks in turn and the warps' partial sums added
in warp order to dh's elementwise part; dy joins after. With a carry the
pre-pass reads ``h0`` as the first step's h_prev, that step takes ``c0``
as c_prev, dc starts from ``dcfin``, and one pass more (the product
alone) forms ``dh0``; ``dc0`` is the first step's dc_prev. Tolerances:
1e-6 against the plain version with f32 dots and 1e-5 with bf16 (f32
sums in another order), 1e-4 against the JAX kernel with f32 dots.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeech_tpu.ops import rnn_pallas
from deepspeech_tpu.ops.lstm_pallas import _lstm_bwd, _lstm_fwd
from deepspeech_tpu_torch import k13_variants, k15_ablation
from deepspeech_tpu_torch.k17_variants import built_value
from deepspeech_tpu_torch.ops import _build, gru, lstm

# One CPU thread for torch: parallel test workers share the machine's
# cores, and a thread pool in each worker oversubscribes them.
torch.set_num_threads(1)

T, B = 9, 5


def _args(seed, h, d, dtype, reverse=(False, True)):
    """``lstm_bwd``'s arguments from numpy: xp [T,B,4H] and W [D,H,4H] in
    ``dtype``, a ragged mask, biases, the tape of the plain forward and
    dy."""
    rng = np.random.default_rng(seed)
    xp = torch.from_numpy(
        rng.normal(size=(T, B, 4 * h)).astype(np.float32)).to(dtype)
    w = torch.from_numpy(
        (rng.normal(size=(d, h, 4 * h)) / np.sqrt(h)).astype(np.float32)
    ).to(dtype)
    bias = torch.from_numpy((rng.normal(size=(d, 4 * h)) * 0.1)
                            .astype(np.float32))
    lens = np.array([T, T - 3, 1, T - 1, 5])
    mask = torch.from_numpy(
        (np.arange(T)[:, None] < lens[None]).astype(np.float32))
    reverse = tuple(reverse[:d])
    ys, cs = lstm.lstm_fwd_plain(xp, mask, w, bias, reverse, tape=True)
    dy = torch.from_numpy(
        (rng.normal(size=(d, T, B, h)) * 0.5).astype(np.float32))
    return xp, mask, w, bias, ys, cs, dy, reverse


def _mirror(xp, mask, w, b, ys, cs, dy, reverse, hc0=None, dcfin=None):
    """The header's loop in its order of summation (see the module
    docstring); the chunking and the warps, read from the header. With
    ``hc0`` (and ``dcfin``) it also returns ``(dh0, dc0)``."""
    head = k13_variants.header_text()
    warps, kc = built_value(head, "M_WARPS"), built_value(head, "MKC")
    t, bsz, n = xp.shape
    d, h = w.shape[0], w.shape[1]
    w32 = w.float()
    hp = gru._h_prev(ys, reverse, None if hc0 is None else hc0[0])
    steps = [[8 * lane + 4 * s + e for lane in range(4) for e in range(4)]
             for s in range(2)]
    dgates = torch.empty((d, t, bsz, n))
    dh0, dc0 = torch.empty((d, bsz, h)), torch.empty((d, bsz, h))

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
        dh = torch.zeros(bsz, h)
        dc = torch.zeros(bsz, h) if dcfin is None else dcfin[di].clone()
        g_prev = None
        for i in range(t):
            row = i if reverse[di] else t - 1 - i
            if i == t - 1:
                c_prev = torch.zeros(bsz, h) if hc0 is None else hc0[1][di]
            else:
                c_prev = cs[di, row + 1 if reverse[di] else row - 1]
            carry = dh
            if i > 0:
                carry = carry + product(di, g_prev)
            x = xp[row].float()
            g = pre[row]
            ig = torch.sigmoid(x[:, :h] + g[:, :h])
            fg = torch.sigmoid((x[:, h:2 * h] + g[:, h:2 * h]) + 1.0)
            gg = torch.tanh(x[:, 2 * h:3 * h] + g[:, 2 * h:3 * h])
            og = torch.sigmoid(x[:, 3 * h:] + g[:, 3 * h:])
            tc = torch.tanh(fg * c_prev + ig * gg)
            m = mask[row][:, None]
            dhc = carry + dy[di, row]
            dh_mid = m * dhc
            dc_pre = m * dc + dh_mid * og * (1.0 - tc * tc)
            da = torch.cat([dc_pre * gg * ig * (1.0 - ig),
                            dc_pre * c_prev * fg * (1.0 - fg),
                            dc_pre * ig * (1.0 - gg * gg),
                            dh_mid * tc * og * (1.0 - og)], 1)
            dgates[di, row] = da
            dh = (1.0 - m) * dhc
            dc = dc_pre * fg + (1.0 - m) * dc
            g_prev = da.to(w.dtype).float()
        dh0[di], dc0[di] = dh + product(di, g_prev), dc  # the tail pass
    return dgates if hc0 is None else (dgates, (dh0, dc0))


# ---------------------------------------------------------------------------
# The loop's order of summation.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.bfloat16, 1e-5)])
@pytest.mark.parametrize("reverse", [(False, True), (True, False)])
@pytest.mark.parametrize("d,h", [(2, 40), (1, 40), (2, 200), (1, 200)])
def test_loop_order_matches_plain(d, h, reverse, dtype, tol):
    """The mirror of the loop against ``lstm_bwd_plain``: both round
    h_prev and dgates to the dot dtype at the same places and sum in f32
    in other orders. H=40 is 160 deep, five chunks (warps 5-7 hold
    none); H=200 is 800 deep, 25 chunks, warp 0 holding four."""
    args = _args(100 + h + d, h, d, dtype, reverse)
    got = _mirror(*args)
    ref = lstm.lstm_bwd_plain(*args)
    assert got.shape == ref.shape == (d, T, B, 4 * h)
    err = float((got - ref).abs().max())
    assert err <= tol, err
    assert float(ref.abs().max()) > 0.1


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.bfloat16, 1e-5)])
@pytest.mark.parametrize("d,h", [(2, 40), (1, 200)])
def test_loop_order_with_carry_matches_plain(d, h, dtype, tol):
    """The mirror with a carried ``(h0, c0)`` (the pre-pass's first rows
    read h0, the first step's c_prev is c0), dc starting from ``dcfin``,
    and the tail pass that forms ``dh0`` against ``lstm_bwd_plain`` with
    ``hc0``, ``dcfin`` and ``return_dhc0``."""
    xp, mask, w, bias, _, _, dy, reverse = _args(300 + h + d, h, d, dtype)
    rng = np.random.default_rng(h + d)
    h0, c0, dcfin = (torch.from_numpy((rng.normal(size=(d, B, h)) * 0.5)
                                      .astype(np.float32)) for _ in range(3))
    ys, cs = lstm.lstm_fwd_plain(xp, mask, w, bias, reverse, tape=True,
                                 hc0=(h0, c0))
    args = (xp, mask, w, bias, ys, cs, dy, reverse)
    got, (dh0, dc0) = _mirror(*args, hc0=(h0, c0), dcfin=dcfin)
    ref, (rh0, rc0) = lstm.lstm_bwd_plain(*args, hc0=(h0, c0), dcfin=dcfin,
                                          return_dhc0=True)
    for g, r in ((got, ref), (dh0, rh0), (dc0, rc0)):
        err = float((g - r).abs().max())
        assert err <= tol, err
    assert min(float(rh0.abs().max()), float(rc0.abs().max())) > 0.1


@pytest.mark.parametrize("h", [40, 200])
@pytest.mark.parametrize("reverse", [False, True])
def test_loop_order_matches_the_pallas_kernel(reverse, h):
    """The mirror on the JAX forward's own residuals (ys and the cs
    tape) against ``_lstm_bwd``'s ``dxp`` from the resident
    ``_lstm_bwd_kernel`` (K13) in interpret mode, f32 dots."""
    assert not rnn_pallas._use_blocked(h, jnp.float32, n_gates=4)
    xp, mask, w, bias, _, _, dy, _ = _args(200 + h, h, 1, torch.float32)
    xproj = xp.transpose(0, 1).numpy()
    mask_bt = mask.t().contiguous().numpy()
    _, res = _lstm_fwd(jnp.asarray(xproj), jnp.asarray(mask_bt),
                       jnp.asarray(w[0].numpy()), jnp.asarray(bias[0].numpy()),
                       reverse, True, None)
    ref_dxp = _lstm_bwd(reverse, True, None, res,
                        jnp.asarray(dy[0].transpose(0, 1).numpy()))[0]
    xp_t, mask_t, _, _, ys, cs = (np.array(x) for x in res)
    got = _mirror(torch.from_numpy(xp_t), torch.from_numpy(mask_t[..., 0]),
                  w, bias, torch.from_numpy(ys)[None],
                  torch.from_numpy(cs)[None], dy, (reverse,))
    np.testing.assert_allclose(got[0].transpose(0, 1).numpy(),
                               np.asarray(ref_dxp), atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# The C path rule, the scratch, and the launch's plan.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,h,mma", [
    (torch.bfloat16, 800, True),     # ds2_small-lstm, ds2_streaming-lstm
    (torch.bfloat16, 104, True),     # a multiple of 8, not of the groups
    (torch.bfloat16, 804, False),    # H % 8 != 0: the CUDA-core kernel
    (torch.bfloat16, 100, False),
    (torch.float32, 800, False),     # f32: the CUDA-core kernel
])
def test_path_rule_and_scratch(dtype, h, mma):
    """``gru._bwd_mma`` repeats ``lstm_bwd_launch``'s rule: bf16,
    H % 8 == 0, w and ys 16-byte aligned (a view that starts 2 bytes in
    takes the CUDA-core kernel). The tensor-core path's scratch, dh and
    dc [D,B,H] f32 and the two bf16 rounded dgates rows [2,D,B,4H], is
    the 6*D*B*H floats ``lstm_bwd_mma_scratch_floats`` returns, and the
    bf16 rows start 16-byte aligned."""
    d, bsz = 2, 5
    w = torch.zeros(d, h, 4 * h, dtype=dtype)
    ys = torch.zeros(d, 3, bsz, h)
    assert gru.lstm_bwd_mma(dtype, h) is mma
    assert gru._bwd_mma(w, ys) is mma
    if mma:
        flat = torch.zeros(w.numel() + 8, dtype=dtype)
        assert not gru._bwd_mma(flat[1:1 + w.numel()].view(w.shape), ys)
        floats = 2 * d * bsz * h + 2 * d * bsz * 4 * h // 2
        assert floats == 6 * d * bsz * h
        assert (2 * d * bsz * h * 4) % 16 == 0
    with open(os.path.join(_build.CSRC_DIR, "lstm_bwd.cu")) as f:
        src = f.read()
    body = src[src.index("long long lstm_bwd_mma_scratch_floats"):]
    assert body[:body.index("}")].rstrip().endswith(
        "return 6LL * D * B * H;")


@pytest.mark.parametrize("d,h,units,smem", [
    (2, 800, 16, 172032),    # ds2_small-lstm: 100 groups of 16
    (1, 800, 8, 151552),     # ds2_streaming-lstm: 100 groups of 8
    (2, 528, 8, 135168),     # 132 groups of 8 on 132 SMs
    (2, 536, 16, 139264),    # 134 would not: 68 groups of 16
    (2, 1056, 16, 204800),   # the D=2 edge: 132 groups of 16
    (1, 1056, 8, 167936),    # the widest D=1 H in groups of 8
    (1, 1280, 16, 229376),   # the D=1 edge: 227 KB of the 227 a block
])
def test_launch_plan(d, h, units, smem):
    """``k13_variants.plan`` with the source's constants, the launch's
    choice: the width, the block's shared memory (the rings, 64 KB at 4
    stages for groups of 16 and 96 KB at 6 for groups of 8, then every
    warp's chunks of the group's rows of W), and that it launches on an
    H100; ``ops/gru.py`` repeats both numbers."""
    values = {n: built_value(k13_variants.source_text(), n)
              for n in k13_variants.CONSTANTS}
    assert k13_variants.plan(values, d, h) == (units, smem, True)
    assert gru.lstm_bwd_mma_width(d, h) == units
    assert gru.lstm_bwd_mma_smem_bytes(units, h) == smem


def test_plan_agrees_with_the_residency_rule_at_every_size():
    """For every (D, H), H a multiple of 8 up to ds2_full's 1760, the
    residency rule admits bf16 exactly where the launch's plan launches,
    at the same width and bytes: the rule, the C launch and the variants
    script cannot part ways."""
    values = {n: built_value(k13_variants.source_text(), n)
              for n in k13_variants.CONSTANTS}
    admitted = 0
    for d in (1, 2):
        for h in range(8, 1768, 8):
            units, smem, launches = k13_variants.plan(values, d, h)
            fits = gru.resident_fits("lstm_bwd", d, h, 32, torch.bfloat16)
            assert fits is launches, (d, h)
            assert units == gru.lstm_bwd_mma_width(d, h)
            assert smem == gru.resident_smem_bytes(
                "lstm_bwd", h, 32, torch.bfloat16, units)
            admitted += fits
    assert admitted == 1056 // 8 + 1280 // 8


@pytest.mark.parametrize("dtype,d,h,b,aligned,resident", [
    (torch.bfloat16, 2, 800, 32, True, True),     # ds2_small-lstm
    (torch.bfloat16, 2, 800, 32, False, True),    # the CUDA-core block
    (torch.bfloat16, 2, 800, 77, True, True),     # any B on the mma path
    (torch.bfloat16, 2, 800, 77, False, False),   # 232,576 bytes a block
    (torch.bfloat16, 2, 1056, 8, True, True),     # 132 groups of 16
    (torch.bfloat16, 2, 1056, 8, False, False),   # a [1088, 64] f32 slice
    (torch.bfloat16, 1, 1280, 8, False, False),
    (torch.float32, 2, 800, 32, True, True),
    (torch.float32, 2, 800, 77, True, False),
])
def test_residency_follows_the_c_path(dtype, d, h, b, aligned, resident):
    """``lstm_bwd`` decides between K13 and K15 on the layout of the
    kernel its C call will run: a bf16 W that is not 16-byte aligned
    runs the CUDA-core kernel (``gru._bwd_mma``), so it is sized as that
    kernel's block, which grows with B and holds W's slice as f32, and
    goes to K15 where that block does not fit, even where the
    tensor-core layout would."""
    w = torch.zeros(d * h * 4 * h + 8, dtype=dtype)
    w = w[:-8] if aligned else w[1:-7]
    w = w.view(d, h, 4 * h)
    ys = torch.zeros(d, 2, b, h)
    assert gru._bwd_mma(w, ys) is (aligned and dtype == torch.bfloat16)
    assert gru._bwd_resident(w, ys, kind="lstm_bwd") is resident


# ---------------------------------------------------------------------------
# The variants script, the ablations and the build.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", list(k13_variants.VARIANTS))
def test_k13_variants_match_the_source(variant):
    """Each constant a ``k13_variants`` variant sets is held exactly once
    by ``csrc/lstm_bwd.cu``, each substitution finds its text, and every
    variant launches at ds2_small-lstm's and ds2_streaming-lstm's shapes
    on an H100."""
    text = k13_variants.source_text()
    built = {n: built_value(text, n) for n in k13_variants.CONSTANTS}
    values = k13_variants.VARIANTS[variant]
    for old, new in k13_variants.substitutions(text, values):
        assert text.count(old) == 1 and new != old
    for d in (1, 2):
        assert k13_variants.plan({**built, **values}, d, 800)[2]


@pytest.mark.parametrize("name", list(k13_variants.ABLATIONS))
def test_k13_ablations_match_the_header(name):
    """Each ``k13_variants`` ablation finds the header text it replaces
    exactly once, and ``csrc/lstm_bwd.cu`` the ``#include`` it pastes the
    header into, so the script times the loop it names."""
    [(old, new)] = k13_variants.ablation(k13_variants.ABLATIONS[name])
    assert k13_variants.source_text().count(old) == 1
    assert new != k13_variants.header_text()
    assert set(k13_variants.MUST_FAIL) <= set(k13_variants.ABLATIONS)


def test_both_sources_share_the_header_and_its_hash(tmp_path, monkeypatch):
    """K13 and K15 include ``lstm_bwd_mma.cuh`` once each, K15's ablations
    reach the loop through it, and an edit of the header rebuilds both:
    each library's name hashes the headers its source includes."""
    for name in ("lstm_bwd", "lstm_bwd_stream"):
        text = k15_ablation.with_header(name)
        assert '#include "lstm_bwd_mma.cuh"' not in text
        assert "namespace lstm_bwd_mma" in text
    for subs in k15_ablation.VARIANTS.values():
        for old, _ in subs:
            assert k13_variants.header_text().count(old) == 1
    for name in ("lstm_bwd", "lstm_bwd_stream"):
        (tmp_path / f"{name}.cu").write_text(
            k13_variants.source_text() if name == "lstm_bwd" else
            open(os.path.join(_build.CSRC_DIR, f"{name}.cu")).read())
    (tmp_path / "lstm_bwd_mma.cuh").write_text(k13_variants.header_text())
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    before = {n: _build._target(n) for n in ("lstm_bwd", "lstm_bwd_stream")}
    (tmp_path / "lstm_bwd_mma.cuh").write_text(
        k13_variants.header_text().replace("// ---- 1.", "// ---- one."))
    after = {n: _build._target(n) for n in before}
    assert all(before[n] != after[n] for n in before)


# ---------------------------------------------------------------------------
# The C entries' carry arguments and the parent shim.
# ---------------------------------------------------------------------------

ENTRY_AFTER_W = ["bias", "h0", "c0", "ys", "cs", "dy", "dcfin", "dgates",
                 "dh0", "dc0", "scratch"]


def _entry_params(source):
    with open(os.path.join(_build.CSRC_DIR, f"{source}.cu")) as f:
        text = f.read()
    entry = text[text.index(f"int {source}_launch("):]
    entry = entry[entry.index("(") + 1:entry.index(")")]
    return [p.split()[-1].lstrip("*") for p in entry.split(",")]


@pytest.mark.parametrize("source", ["lstm_bwd", "lstm_bwd_stream"])
def test_c_entry_takes_the_carry_in_the_wrappers_order(source, monkeypatch):
    """Both C entries take ``(bf16, xp, mask, w, bias, h0, c0, ys, cs, dy,
    dcfin, dgates, dh0, dc0, scratch, D, T, B, H, reverse_bits, device,
    stream)``, and ``_bwd_launch`` hands its tensors in that order: the
    carry's where given, None (NULL) where not."""
    params = _entry_params(source)
    assert params[:4] == ["bf16", "xp", "mask", "w"]
    assert params[4:4 + len(ENTRY_AFTER_W)] == ENTRY_AFTER_W
    assert params[4 + len(ENTRY_AFTER_W):] == [
        "D", "T", "B", "H", "reverse_bits", "device", "stream"]
    seen = {}

    class Lib:
        def __getattr__(self, name):
            return lambda d, b, h: 6 * d * b * h

    monkeypatch.setattr(gru, "_lib", lambda name: Lib())
    monkeypatch.setattr(gru, "_launch", lambda name, xp, mask, w, tensors,
                        reverse: seen.update(name=name, tensors=tensors))
    xp, mask, w, bias, ys, cs, dy, reverse = _args(7, 16, 1, torch.bfloat16)
    h0, c0, dcfin = (torch.randn(1, B, 16) for _ in range(3))
    dgates, (dh0, dc0), launched = lstm._bwd_launch(
        source, xp, mask, w, bias, ys, cs, dy, reverse, hc0=(h0, c0),
        dcfin=dcfin, return_dhc0=True)
    assert launched and seen["name"] == source
    named = dict(zip(ENTRY_AFTER_W, seen["tensors"]))
    for name, x in (("bias", bias), ("h0", h0), ("c0", c0), ("ys", ys),
                    ("cs", cs), ("dy", dy), ("dcfin", dcfin),
                    ("dgates", dgates), ("dh0", dh0), ("dc0", dc0)):
        assert named[name] is x, name
    lstm._bwd_launch(source, xp, mask, w, bias, ys, cs, dy, reverse)
    named = dict(zip(ENTRY_AFTER_W, seen["tensors"]))
    assert all(named[n] is None for n in ("h0", "c0", "dcfin", "dh0", "dc0"))


def test_parent_call_shims_an_older_entry(tmp_path):
    """``k13_variants.parent_call`` returns the wrapper for a tree whose
    entry takes the carry and a shim for one whose entry does not."""
    for source in ("lstm_bwd", "lstm_bwd_stream"):
        path = os.path.join(_build.CSRC_DIR, f"{source}.cu")
        assert k13_variants.parent_call(source, path) is getattr(lstm,
                                                                 source)
        old = tmp_path / f"{source}.cu"
        old.write_text(f"int {source}_launch(int bf16, const void* xp, "
                       "const float* mask, const void* w, const float* "
                       "bias, const float* ys, const float* cs, const "
                       "float* dy, float* dgates, float* scratch, int D, "
                       "int T, int B, int H, int reverse_bits, int device, "
                       "void* stream) {}")
        shim = k13_variants.parent_call(source, str(old))
        assert callable(shim) and shim is not getattr(lstm, source)
