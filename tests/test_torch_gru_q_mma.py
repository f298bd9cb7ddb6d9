"""The tensor-core loop of the int8 GRU forward (``csrc/gru_fwd_q_mma.cuh``,
which ``csrc/gru_fwd_q.cu`` (K10) and ``csrc/gru_fwd_q_stream.cu`` (K11)
run with bf16 dots and H % 8 == 0), mirrored in torch in its data layout
and order of summation, against ``gru_fwd_q_plain`` and the JAX
package's ``gru_scan_pallas_q`` in interpret mode, resident
(``_gru_kernel_q``) and forced blocked (``_gru_kernel_blocked_q``); the
rule that picks the C path and sizes its scratch; the residency plan of
the launch; and ``k10_variants``' substitutions.

The loop cannot run here (no card, no nvcc): chip_smoke.py holds the
kernels to ``gru_fwd_q_plain`` on the card. What the mirror checks is
that the layout the source describes (biased s8 bytes, ``q_pos``, the
three gates' 96 columns a group split into NW_N column blocks, the
depth split over NW_K warps, the k16 steps of each chunk, the partial
sums added in warp order, the scale on the finished sum, ``b_n`` before
``r``, step 0 reading ``round(h0)``) computes the contract's function.
Tolerances: 1e-5 against the plain version (f32 sums in another
order), 1e-4 against the JAX kernels with f32 dots.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeech_tpu.ops.rnn_pallas import gru_scan_pallas_q
from deepspeech_tpu_torch import k10_variants
from deepspeech_tpu_torch.k17_variants import built_value
from deepspeech_tpu_torch.ops import _build, gru

# One CPU thread for torch: parallel test workers share the machine's
# cores, and a thread pool in each worker oversubscribes them.
torch.set_num_threads(1)

T, B = 9, 5


def _inputs(seed, h, d):
    """xproj [B,T,3H], a ragged mask [B,T], int8 W [D,H,3H] with
    per-column scales [D,3H] in utils/quantize.py's layout, biases [D,3H]
    and h0 [D,B,H], from numpy."""
    rng = np.random.default_rng(seed)
    xproj = rng.normal(size=(B, T, 3 * h)).astype(np.float32)
    xproj = torch.from_numpy(xproj).bfloat16().float().numpy()
    w = rng.normal(size=(d, h, 3 * h)) / np.sqrt(h)
    scale = (np.abs(w).max(axis=1) / 127.0).astype(np.float32)
    q = np.clip(np.rint(w / scale[:, None]), -127, 127).astype(np.int8)
    bias = (rng.normal(size=(d, 3 * h)) * 0.1).astype(np.float32)
    lens = np.array([T, T - 3, 2, T - 1, 5])
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    h0 = (rng.normal(size=(d, B, h)) * 0.5).astype(np.float32)
    return xproj, mask, q, scale, bias, h0


def _port_args(xproj, mask, q, scale, bias, dtype):
    return (torch.from_numpy(xproj).transpose(0, 1).contiguous().to(dtype),
            torch.from_numpy(mask).t().contiguous(), torch.from_numpy(q),
            torch.from_numpy(scale), torch.from_numpy(bias))


def _q_pos():
    """The header's ``q_pos`` (where the transpose puts depth k in a row
    of Q^T), evaluated from its own text, and its MKC."""
    text = k10_variants.header_text()
    mkc = built_value(text, "MKC")
    expr = re.search(r"constexpr int q_pos\(int k\) \{\s*return (.*?);",
                     text, re.S).group(1)
    return eval("lambda k: " + expr.replace("/", "//"), {"MKC": mkc}), mkc


def _widen(u8: torch.Tensor) -> torch.Tensor:
    """The header's ``widen4`` bit route on biased bytes ``u = q + 128``:
    u into the low byte of the f32 ``2^23 + u``, minus ``2^23 + 128``,
    the upper half kept as bf16 bits."""
    f = (u8.to(torch.int32) | 0x4B000000).view(torch.float32)
    f = f - 8388736.0
    return (f.view(torch.int32) >> 16).to(torch.int16).view(
        torch.bfloat16).float()


def _loop_gates(q, scale, bias, dtype, source="gru_fwd_q"):
    """The gates of the tensor-core loop with ``source``'s constants, in
    its data layout and order of summation. Q^T as the transpose writes
    it: bytes biased, rows padded to whole MKC-deep chunks (padding
    biased zeros), k at ``q_pos(k)``, widened by ``widen4``'s route. For
    each group of MU units, warp (wn, kw) takes the group's columns
    wn*NCOL.. (gate c // MU, unit j0 + c % MU) and chunks kw, kw + NW_K,
    ...; a chunk is four k16 steps, step j the positions 16l + 4j ..
    16l + 4j + 3 of the lanes l = 0..3 (the h pieces taking the same k);
    each warp sums its chunks in turn, the warps' partial sums are added
    in warp order, and the scale multiplies the finished sum before the
    bias joins it (``_fwd_plain_loop`` then multiplies the n column by r,
    b_n in it). h is rounded to the dot dtype: at step 0 that is
    ``round(h0)``, the row the transpose launch writes."""
    pos, mkc = _q_pos()
    text, head = (k10_variants.source_text(source),
                  k10_variants.header_text())
    mu, warps = built_value(head, "MU"), built_value(head, "M_WARPS")
    nw_n = built_value(text, "NW_N")
    nw_k, ncol = warps // nw_n, 3 * mu // nw_n
    d, h = q.shape[0], q.shape[1]
    n_chunks = -(-h // mkc)
    hp = n_chunks * mkc
    where = [pos(k) for k in range(h)]
    qt = torch.full((d, 3 * h, hp), 0x80, dtype=torch.uint8)
    qt[:, :, where] = (q.transpose(1, 2).view(torch.uint8) ^ 0x80)
    qt = _widen(qt)
    depth = torch.full((hp,), -1, dtype=torch.long)  # position -> k
    depth[where] = torch.arange(h)
    steps = [[16 * lane + 4 * j + e for lane in range(4) for e in range(4)]
             for j in range(4)]

    def gates(di, hc):
        hr = torch.zeros(hc.shape[0], hp + 1)  # column hp: a zero
        hr[:, :h] = hc.to(dtype).float()
        hr = hr[:, torch.where(depth >= 0, depth, hp)]  # by position
        total = torch.zeros(hc.shape[0], 3 * h)
        for j0 in range(0, h, mu):
            for wn in range(nw_n):
                cols = [(c // mu) * h + j0 + c % mu
                        for c in range(wn * ncol, (wn + 1) * ncol)
                        if j0 + c % mu < h]
                acc = torch.zeros(hc.shape[0], len(cols))
                for kw in range(nw_k):
                    part = torch.zeros(hc.shape[0], len(cols))
                    for c in range(kw, n_chunks, nw_k):
                        for step in steps:
                            p = [c * mkc + x for x in step]
                            part = part + hr[:, p] @ qt[di][cols][:, p].t()
                    acc = acc + part
                total[:, cols] = acc
        return total * scale[di] + bias[di]
    return gates


def test_widening_route_is_exact_for_every_byte():
    """All 256 biased bytes widen to the bf16 of q = u - 128 (-128
    included), and the padding's biased zero to +0."""
    u = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    want = (torch.arange(256) - 128).to(torch.bfloat16).float()
    assert torch.equal(_widen(u), want)
    assert _widen(torch.tensor([0x80], dtype=torch.uint8))[0].item() == 0.0


def test_q_pos_permutes_each_chunk():
    """``q_pos`` maps each MKC-deep chunk onto itself, one to one, and a
    lane's 16 positions hold the k of its two 8-wide h pieces."""
    pos, mkc = _q_pos()
    for c in range(3):
        got = sorted(pos(k) for k in range(c * mkc, (c + 1) * mkc))
        assert got == list(range(c * mkc, (c + 1) * mkc))
    for lane in range(4):
        ks = {k for k in range(mkc) if pos(k) // 16 == lane}
        assert ks == set(range(8 * lane, 8 * lane + 8)) | set(
            range(32 + 8 * lane, 40 + 8 * lane))


@pytest.mark.parametrize("source", k10_variants.SOURCES)
@pytest.mark.parametrize("dot", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("d,h", [(2, 40), (1, 40), (2, 200), (1, 200)])
def test_loop_order_matches_plain(d, h, with_h0, dot, source):
    """The mirror of the loop within 1e-5 of ``gru_fwd_q_plain``, ys and
    hfin, at T=9, B=5 with ragged lengths. H=40 is one padded chunk and a
    partial second group (units 32..39); H=200 four chunks, one per depth
    split, and a partial seventh group; both multiples of 8 and not of 32
    or 64. With bf16 dots h is rounded before each product, at step 0
    ``round(h0)``."""
    dtype = getattr(torch, dot)
    xproj, mask, q, scale, bias, h0 = _inputs(90 + h + d, h, d)
    args = _port_args(xproj, mask, q, scale, bias, dtype)
    hh = torch.from_numpy(h0) if with_h0 else None
    reverse = (False, True)[:d]
    ys, hfin = gru._fwd_plain_loop(
        args[0], args[1], hh, reverse, d, h,
        _loop_gates(args[2], args[3], args[4], dtype, source))
    ys_p, hfin_p = gru.gru_fwd_q_plain(*args, hh, reverse)
    torch.testing.assert_close(ys, ys_p, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(hfin, hfin_p, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("blocked,with_h0", [(False, False), (False, True),
                                             (True, False)])
@pytest.mark.parametrize("h", [40, 200])
def test_loop_order_matches_the_pallas_kernels(h, blocked, with_h0):
    """The mirror, f32 dots, a direction at a time within 1e-4 of the JAX
    resident (K10) and forced blocked (K11) kernels in interpret mode;
    the carried-state form (h0 in, the final carry out) is resident-only
    in the JAX package."""
    xproj, mask, q, scale, bias, h0 = _inputs(60 + h, h, 2)
    args = _port_args(xproj, mask, q, scale, bias, torch.float32)
    hh = torch.from_numpy(h0) if with_h0 else None
    reverse = (False, True)
    ys, hfin = gru._fwd_plain_loop(
        args[0], args[1], hh, reverse, 2, h,
        _loop_gates(args[2], args[3], args[4], torch.float32))
    for di, rev in enumerate(reverse):
        kw = {"h0": jnp.asarray(h0[di])} if with_h0 else {}
        ref = gru_scan_pallas_q(jnp.asarray(xproj), jnp.asarray(mask),
                                jnp.asarray(q[di]), jnp.asarray(scale[di]),
                                jnp.asarray(bias[di]), rev, True, None,
                                blocked=blocked, **kw)
        ref_ys = ref[0] if with_h0 else ref
        np.testing.assert_allclose(ys[di].transpose(0, 1).numpy(),
                                   np.asarray(ref_ys), atol=1e-4, rtol=1e-4)
        if with_h0:
            np.testing.assert_allclose(hfin[di].numpy(), np.asarray(ref[1]),
                                       atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# The C path rule, the scratch and the residency plan.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,d,h,mma", [
    (torch.bfloat16, 2, 1760, True),    # ds2_full: rows padded to 1792
    (torch.bfloat16, 2, 1920, True),    # the residency rule's D=2 edge
    (torch.bfloat16, 1, 2112, True),    # its D=1 edge
    (torch.bfloat16, 2, 104, True),     # a multiple of 8, not of 32 or 64
    (torch.bfloat16, 2, 2176, True),    # more groups than an H100's SMs
    (torch.bfloat16, 2, 100, False),    # not a multiple of 8
    (torch.bfloat16, 2, 108, False),
    (torch.float32, 2, 1760, False),    # f32 dots: the CUDA-core kernels
])
def test_path_rule_and_scratch(dtype, d, h, mma):
    """Both int8 wrappers pick their C path before the launch, as
    ``gru_fwd_q_launch`` and ``gru_fwd_q_stream_launch`` do: the dot
    dtype is ``xp``'s (Q is always int8), and bf16 with H % 8 == 0 runs
    the transpose and the tensor-core loop, whose scratch holds two
    rounded h rows (bf16) and Q^T (bytes, rows padded to a multiple of
    64), Q^T starting 16-byte aligned; any other call the CUDA-core
    kernel, which takes no scratch."""
    bsz = 5
    xp = torch.zeros(3, bsz, 3 * h, dtype=dtype)
    wq = torch.zeros(d, h, 3 * h, dtype=torch.int8)
    assert gru._fwd_q_mma(xp, wq) is mma
    scratch = gru._fwd_q_scratch(xp, wq)
    assert scratch.dtype == torch.float32
    hp = (h + 63) // 64 * 64
    rows, qt = 2 * (2 * d * bsz * h), d * 3 * h * hp
    assert scratch.numel() * 4 == (rows + qt if mma else 0)
    if mma:
        assert rows % 16 == 0


@pytest.mark.parametrize("source,d,h,resident,smem", [
    # ds2_full: K10 holds all 7 of a warp's chunks (172 KB) beside the
    # 52 KB of partial sums, K11 its fixed 6 and streams one.
    ("gru_fwd_q", 2, 1760, 7, 225280),
    ("gru_fwd_q_stream", 2, 1760, 6, 229376),
    # The residency rule's edges: K10 holds 6 of 8 (D=2) or 9 (D=1).
    ("gru_fwd_q", 2, 1920, 6, 229376),
    ("gru_fwd_q", 1, 2112, 6, 229376),
    # 136 groups on 132 SMs: blocks walk two groups and hold none.
    ("gru_fwd_q_stream", 2, 2176, 0, 81920),
    ("gru_fwd_q", 2, 104, 1, 77824),
])
def test_residency_plan(source, d, h, resident, smem):
    """What the launch holds resident at the sizes that matter, with the
    source's constants, on an H100's 227 KB a block and 132 SMs."""
    text = k10_variants.source_text(source)
    values = {n: built_value(text, n) for n in k10_variants.CONSTANTS}
    assert k10_variants.plan(values, d, h) == (resident, smem)


def test_every_rule_admitted_size_runs_the_loop():
    """Every (D, H) that ``resident_fits("fwd_q")`` admits in bf16 on an
    H100, H a multiple of 8, has its groups on SMs of their own (the loop
    holds chunks there) and a block within 227 KB; K10 holds all of a
    warp's chunks up to D=2 H=1792."""
    text = k10_variants.source_text("gru_fwd_q")
    values = {n: built_value(text, n) for n in k10_variants.CONSTANTS}
    for d in (1, 2):
        for h in range(8, 2400, 8):
            if not gru.resident_fits("fwd_q", d, h, 32, torch.bfloat16):
                continue
            assert d * -(-h // 32) <= k10_variants.SMS
            res, smem = k10_variants.plan(values, d, h)
            assert 0 < res and smem <= k10_variants.SMEM_OPTIN
            if d == 2 and h <= 1792:  # every chunk of warp kw = 0
                n_chunks = -(-h // 64)
                assert res == -(-n_chunks // 4)


@pytest.mark.parametrize("source,variant", [
    (s, v) for s in k10_variants.SOURCES for v in k10_variants.VARIANTS[s]])
def test_k10_variants_match_the_source(source, variant):
    """Each constant a ``k10_variants`` variant sets is held exactly once
    by its source, each substitution finds its text, and every variant
    fits a block's shared memory at ds2_full."""
    text = k10_variants.source_text(source)
    built = {n: built_value(text, n) for n in k10_variants.CONSTANTS}
    values = k10_variants.VARIANTS[source][variant]
    for name in values:
        built_value(text, name)
    for old, new in k10_variants.substitutions(text, values):
        assert text.count(old) == 1 and new != old
    _, smem = k10_variants.plan({**built, **values}, 2, 1760)
    assert smem <= k10_variants.SMEM_OPTIN


def test_header_is_part_of_the_build_hash(tmp_path, monkeypatch):
    """An edit of the shared header rebuilds both int8 sources: the
    library's name hashes the headers a source includes."""
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    for name in ("a", "b"):
        (tmp_path / f"{name}.cu").write_text(
            f'#include "common.cuh"\nint {name};\n')
    (tmp_path / "common.cuh").write_text("// one\n")
    before = {n: _build._target(n) for n in ("a", "b")}
    (tmp_path / "common.cuh").write_text("// two\n")
    after = {n: _build._target(n) for n in ("a", "b")}
    assert all(before[n] != after[n] for n in before)
    assert os.path.basename(before["a"]).startswith("liba-")


@pytest.mark.parametrize("source,name", [
    (s, n) for s in k10_variants.SOURCES for n in k10_variants.ABLATIONS])
def test_k10_ablations_match_the_header(source, name):
    """Each ``k10_variants`` ablation finds the header text it replaces
    exactly once, and the source the ``#include`` it pastes the header
    into, so the script times the loop it names."""
    text = k10_variants.source_text(source)
    [(old, new)] = k10_variants.ablation(text, k10_variants.ABLATIONS[name])
    assert text.count(old) == 1
    assert new != k10_variants.header_text()
