"""The tensor-core path of the LSTM forward (``csrc/lstm_fwd_mma.cuh``,
which ``csrc/lstm_fwd.cu`` (K12 at D=2 and D=1, all of W^T held in
shared memory) and ``csrc/lstm_fwd_stream.cu`` (K14, W^T partly
streamed) run in bf16), mirrored in torch in its order of summation,
against ``lstm_fwd_plain`` and the JAX package's resident ``_lstm_kernel``
(K12) in interpret mode, outputs and the cell-state tape; the rule that
picks K12's C path and sizes its scratch; ``k12_variants.plan`` against
the residency rule; and the variants' and ablations' substitutions.

The loop cannot run here (no card, no nvcc): chip_smoke.py holds the
kernels to ``lstm_fwd_plain`` on the card. What the mirror checks is that
the order the header describes computes the contract's function: at
each step the H-deep sum ``round(h_prev) @ W`` cut into 32-deep chunks,
chunk c taken by the depth split c % NW_K (8 for groups under 32 units,
whose one warp holds all the group's 4*MU columns: MU=16 at D=2, 8 at
D=1; 4 for K14's 32 units in two column splits), each chunk two k16
steps whose depths are the lanes' 16-byte pieces (k = 8l..8l+3, then
8l+4..8l+7), each depth split summing its chunks in turn, the splits'
partial sums added in order, then the bias. Tolerances: 1e-6 against the
plain version with f32 dots (f32 sums in another order), 3e-2 with bf16
dots (the repo's bf16 tolerance: a last-bit difference of a sum can flip
a rounding of h), 1e-5 against the JAX kernel with f32 dots (the JAX
Pallas tests' own).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeech_tpu.ops.lstm_pallas import _lstm_pallas_raw, lstm_scan_pallas
from deepspeech_tpu_torch import k12_variants, k14_variants
from deepspeech_tpu_torch.config import get_config
from deepspeech_tpu_torch.k17_variants import built_value
from deepspeech_tpu_torch.ops import _build, gru, lstm

# One CPU thread for torch: parallel test workers share the machine's
# cores, and a thread pool in each worker oversubscribes them.
torch.set_num_threads(1)

T, B = 9, 5


def _args(seed, h, d, dtype, reverse=(False, True)):
    """``lstm_fwd``'s arguments from numpy: xp [T,B,4H] and W [D,H,4H] in
    ``dtype``, a ragged mask, biases."""
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
    return xp, mask, w, bias, tuple(reverse[:d])


def _nw_k(units):
    """The warps over the depth for groups of ``units``: the header's
    M_WARPS over its column splits (``Plan``'s NW_N, 1 under 32 units;
    K14's own NW_N at 32)."""
    warps = built_value(k12_variants.header_text(), "M_WARPS")
    if units < 32:
        return warps
    with open(os.path.join(_build.CSRC_DIR, "lstm_fwd_stream.cu")) as f:
        return warps // built_value(f.read(), "NW_N")


def _mirror(xp, mask, w, b, reverse, units, tape=False):
    """``lstm_fwd`` with the header's loop's gates in its order of
    summation (see the module docstring) for groups of ``units``; the
    chunk depth and the warps read from the header (and K14's source).
    Returns ``(ys, cs)``, ``cs`` None without ``tape``."""
    kc = built_value(k12_variants.header_text(), "MKC")
    nw_k = _nw_k(units)
    h = w.shape[1]
    w32 = w.float()
    steps = [[8 * lane + 4 * s + e for lane in range(4) for e in range(4)]
             for s in range(2)]

    def gates(di, hc):
        hr = hc.to(w.dtype).float()
        parts = torch.zeros(nw_k, hc.shape[0], 4 * h)
        for c in range(-(-h // kc)):
            for step in steps:
                p = [c * kc + x for x in step if c * kc + x < h]
                parts[c % nw_k] = parts[c % nw_k] + hr[:, p] @ w32[di][p]
        total = torch.zeros(hc.shape[0], 4 * h)
        for kk in range(nw_k):
            total = total + parts[kk]
        return total + b[di]
    ys, cs, _, _ = lstm.lstm_plain_loop(xp, mask, reverse, h, gates,
                                        tape=tape)
    return ys, cs


# ---------------------------------------------------------------------------
# The loop's order of summation.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("units,d", [(16, 2), (8, 1), (32, 2)],
                         ids=["k12-d2-mu16", "k12-d1-mu8", "k14-mu32"])
@pytest.mark.parametrize("h", [40, 296])
def test_loop_order_matches_plain(h, units, d, dtype, tol):
    """The mirror against ``lstm_fwd_plain``, ys and the tape cs: both
    round h_prev to the dot dtype at the same place and sum in f32 in
    other orders. H=40 is one whole and one partial chunk; H=296 ten
    chunks, depth splits 0 and 1 holding two (K14's: 0 and 1 three)."""
    args = _args(100 + h + d + units, h, d, dtype)
    got = _mirror(*args, units, tape=True)
    ref = lstm.lstm_fwd_plain(*args, tape=True)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        err = float((g - r).abs().max())
        assert err <= tol, err
    assert float(ref[0].abs().max()) > 0.3
    assert float(ref[1].abs().max()) > 0.5


@pytest.mark.parametrize("units", [16, 8])
@pytest.mark.parametrize("h", [40, 296])
def test_loop_order_matches_the_k12_pallas_kernel(h, units):
    """Both directions of the mirror (D=2, the second reversed) against
    ``lstm_scan_pallas`` (``_lstm_kernel``, K12) in interpret mode, one
    call a direction as the JAX model makes them, f32 dots; and the tape
    against ``_lstm_pallas_raw(..., want_cs=True)``'s cell state."""
    xp, mask, w, bias, reverse = _args(300 + h + units, h, 2,
                                       torch.float32)
    ys, cs = _mirror(xp, mask, w, bias, reverse, units, tape=True)
    xproj = jnp.asarray(xp.transpose(0, 1).contiguous().numpy())
    mask_bt = jnp.asarray(mask.t().contiguous().numpy())
    for di, rev in enumerate(reverse):
        ref = lstm_scan_pallas(xproj, mask_bt, jnp.asarray(w[di].numpy()),
                               jnp.asarray(bias[di].numpy()), rev, True,
                               None)
        np.testing.assert_allclose(ys[di].transpose(0, 1).numpy(),
                                   np.asarray(ref), atol=1e-5, rtol=1e-5)
        ref_ys, ref_cs, _, _ = _lstm_pallas_raw(
            xproj, mask_bt, jnp.asarray(w[di].numpy()),
            jnp.asarray(bias[di].numpy()), rev, True, None, want_cs=True)
        np.testing.assert_allclose(ys[di].numpy(), np.asarray(ref_ys),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(cs[di].numpy(), np.asarray(ref_cs),
                                   atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# The C path rule, the scratch, and the launch's plan.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,h,mma", [
    (torch.bfloat16, 800, True),     # ds2_small-lstm, ds2_streaming-lstm
    (torch.bfloat16, 104, True),     # a multiple of 8, not of the chunks
    (torch.bfloat16, 804, False),    # H % 8 != 0: the CUDA-core kernel
    (torch.bfloat16, 100, False),
    (torch.float32, 800, False),     # f32: the CUDA-core kernel
])
def test_path_rule_and_scratch(dtype, h, mma):
    """``_fwd_mma`` repeats ``lstm_fwd_launch``'s rule (bf16, H % 8 ==
    0), which ``lstm_fwd_stream_launch`` shares; the tensor-core path's
    scratch holds c [D,B,H] f32, the two rounded h rows [2,D,B,H] and
    W^T [D,4H,H], both bf16, each starting 16-byte aligned; K12's
    CUDA-core kernel takes none (c stays in shared memory), K14's keeps
    c alone."""
    d, t, bsz = 2, 3, 5
    xp = torch.zeros(t, bsz, 4 * h, dtype=dtype)
    w = torch.zeros(d, h, 4 * h, dtype=dtype)
    assert gru.lstm_fwd_mma(dtype, h) is mma
    assert lstm._fwd_mma(w) is mma
    scratch = lstm._fwd_scratch(xp, w)
    assert scratch.dtype == torch.float32
    c, rows, wt = 4 * d * bsz * h, 2 * (2 * d * bsz * h), 2 * (d * 4 * h * h)
    assert scratch.numel() * 4 == (c + rows + wt if mma else 0)
    stream = lstm._fwd_stream_scratch(xp, w)
    assert stream.numel() * 4 == (c + rows + wt if mma else c)
    if mma:
        assert c % 16 == 0 and (c + rows) % 16 == 0


def _built():
    return {n: built_value(k12_variants.source_text(), n)
            for n in k12_variants.CONSTANTS}


@pytest.mark.parametrize("d,h,units,smem", [
    (2, 800, 16, 176128),    # ds2_small-lstm: 100 groups of 16
    (1, 800, 8, 116736),     # ds2_streaming-lstm: 100 groups of 8
    (2, 528, 8, 100352),     # 132 groups of 8 on 132 SMs
    (2, 536, 16, 143360),    # 134 would not: 34 groups of 16 a direction
    (2, 808, 16, 180224),    # 51 groups of 16 a direction, the last half
    (2, 1056, 16, 208896),   # the D=2 edge: 132 groups of 16
    (1, 1056, 8, 133120),    # the widest D=1 H in groups of 8
    (1, 1064, 16, 212992),   # the first D=1 H in groups of 16
    (1, 1216, 16, 229376),   # the D=1 edge: 224 KB of the 227 a block
])
def test_launch_plan(d, h, units, smem):
    """``k12_variants.plan`` with the source's constants, the launch's
    choice: the width, the block's shared memory (the rings, 64 KB at 4
    stages, which the partial sums alias (72 KB of them at 16 units),
    then every 32-deep chunk of the group's W^T rows), and that it
    launches on an H100; ``ops/gru.py`` repeats both numbers."""
    assert k12_variants.plan(_built(), d, h) == (units, smem, True)
    assert gru.lstm_fwd_mma_width(d, h) == units
    assert gru.lstm_fwd_mma_smem_bytes(units, h) == smem


def test_plan_agrees_with_the_residency_rule_at_every_size():
    """For every (D, H), H a multiple of 8 up to ds2_full's 1760, the
    residency rule admits bf16 exactly where the launch's plan launches,
    at the same width and bytes: the rule, the C launch and the variants
    script cannot part ways. The rule admits H up to 1056 at D=2 and
    1216 at D=1, whatever B."""
    values = _built()
    admitted = {1: [], 2: []}
    for d in (1, 2):
        for h in range(8, 1768, 8):
            units, smem, launches = k12_variants.plan(values, d, h)
            for b in (1, 32, 4096):
                fits = gru.resident_fits("lstm_fwd", d, h, b,
                                         torch.bfloat16)
                assert fits is launches, (d, h, b)
            assert units == gru.lstm_fwd_mma_width(d, h)
            assert smem == gru.resident_smem_bytes(
                "lstm_fwd", h, 32, torch.bfloat16, units)
            if launches:
                admitted[d].append(h)
    assert admitted[2] == list(range(8, 1064, 8))
    assert admitted[1] == list(range(8, 1224, 8))


def test_ds2_full_lstm_still_streams():
    """ds2_full's H=1760 (D=2, 220 groups of 16 on 132 SMs) stays on the
    streamed kernel K14 in bf16, as in f32; ds2_small's and
    ds2_streaming's H=800 are resident in both."""
    h = get_config("ds2_full").model.rnn_hidden
    assert h == 1760
    for dtype in (torch.bfloat16, torch.float32):
        assert not gru.resident_fits("lstm_fwd", 2, h, 32, dtype)
        for preset in ("ds2_small", "ds2_streaming"):
            h_small = get_config(preset).model.rnn_hidden
            for d in (1, 2):
                assert gru.resident_fits("lstm_fwd", d, h_small, 32, dtype)


@pytest.mark.parametrize("dtype,d,h,b,resident", [
    (torch.bfloat16, 2, 800, 256, True),     # whatever B on the mma path
    (torch.float32, 2, 800, 256, False),     # the f32 block holds c
    (torch.bfloat16, 2, 1056, 32, True),     # past the f32 slice's 832
    (torch.float32, 2, 1056, 32, False),
    (torch.float32, 2, 832, 32, True),       # the f32 edge, as before
    (torch.bfloat16, 2, 804, 45, True),      # H % 8 != 0: the f32 slice
    (torch.bfloat16, 1, 833, 32, False),
    (torch.bfloat16, 1, 1224, 32, False),    # 228 KB: K14
    (torch.bfloat16, 2, 1064, 32, False),    # 134 groups of 16
])
def test_forward_residency_follows_the_c_path(dtype, d, h, b, resident):
    """``lstm_fwd`` decides between K12 and K14 on the layout of the
    kernel its C call will run: in bf16 with H % 8 == 0 the tensor-core
    loop's block (W^T rows in bf16, c in the scratch, nothing that grows
    with B); in f32 and in bf16 off that rule the CUDA-core kernel's
    [H, 64] f32 slice and its cell state, whose answer is the one before
    the tensor-core path."""
    assert gru.resident_fits("lstm_fwd", d, h, b, dtype) is resident


# ---------------------------------------------------------------------------
# The variants script, the ablations and the build.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", list(k12_variants.VARIANTS))
def test_k12_variants_match_the_source(variant):
    """Each constant a ``k12_variants`` variant sets is held exactly once
    by ``csrc/lstm_fwd.cu``, each substitution finds its text, and every
    variant launches at ds2_small-lstm's and ds2_streaming-lstm's shapes
    on an H100."""
    text = k12_variants.source_text()
    values = k12_variants.VARIANTS[variant]
    for old, new in k12_variants.substitutions(text, values):
        assert text.count(old) == 1 and new != old
    for d in (1, 2):
        assert k12_variants.plan({**_built(), **values}, d, 800)[2]


@pytest.mark.parametrize("name", list(k12_variants.ABLATIONS))
def test_k12_ablations_match_the_header(name):
    """Each ``k12_variants`` ablation finds the header text it replaces
    exactly once, and ``csrc/lstm_fwd.cu`` the ``#include`` it pastes the
    header into, so the script times the loop it names."""
    [(old, new)] = k12_variants.ablation(k12_variants.ABLATIONS[name])
    assert k12_variants.source_text().count(old) == 1
    assert new != k12_variants.header_text()
    assert set(k12_variants.MUST_FAIL) <= set(k12_variants.ABLATIONS)


def test_both_sources_share_the_header_and_its_hash(tmp_path, monkeypatch):
    """K12 and K14 include ``lstm_fwd_mma.cuh`` once each, K14 instances
    its loop with its own constants (the 32-unit groups, 2 ring stages,
    2 column splits and 4 resident chunks ``k14_variants`` substitutes)
    and K12 with all of W^T held, and an edit of the header rebuilds
    both: each library's name hashes the headers its source includes."""
    include = '#include "lstm_fwd_mma.cuh"\n'
    texts = {}
    for name in ("lstm_fwd", "lstm_fwd_stream"):
        with open(os.path.join(_build.CSRC_DIR, f"{name}.cu")) as f:
            texts[name] = f.read()
        assert texts[name].count(include) == 1
    k14 = texts["lstm_fwd_stream"]
    assert [built_value(k14, n) for n in ("MU", "MS", "NW_N", "W_RES")] == \
        [32, 2, 2, 4]
    assert "lstm_fwd_mma::loop<MU, MS, W_RES, NW_N>(" in k14
    assert "lstm_fwd_mma::loop<MU, MS, lstm_fwd_mma::W_ALL>(" in \
        texts["lstm_fwd"]
    for subs in k14_variants.VARIANTS.values():
        for old, _ in subs:
            assert k14.count(old) == 1
    for name, text in texts.items():
        (tmp_path / f"{name}.cu").write_text(text)
    (tmp_path / "lstm_fwd_mma.cuh").write_text(k12_variants.header_text())
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    before = {n: _build._target(n) for n in texts}
    (tmp_path / "lstm_fwd_mma.cuh").write_text(
        k12_variants.header_text().replace("// ---- 1.", "// ---- one."))
    after = {n: _build._target(n) for n in texts}
    assert all(before[n] != after[n] for n in texts)
