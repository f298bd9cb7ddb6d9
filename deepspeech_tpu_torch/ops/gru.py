"""The GRU recurrence and its backward: hand-written Hopper kernels and
their plain PyTorch versions.

``gru_fwd`` replaces two TPU kernels of ``deepspeech_tpu/ops/rnn_pallas.py``:
``_gru_kernel`` (:85, one direction, with the carried ``h0`` in and the
final carry out of ``gru_scan_pallas_stream``) at D=1, and
``_bigru_kernel`` (:155, both directions of a bidirectional layer in one
launch) at D=2. The kernel is ``csrc/gru_fwd.cu``; in bf16 with H % 8 == 0
it transposes W once a call and runs its serial loop on ``mma.sync`` with
each group's rows of W^T in shared memory (``csrc/gru_fwd_mma.cuh``,
which K8 shares).

``gru_bwd`` replaces their backward kernels: ``_gru_bwd_kernel`` (:113,
K7) at D=1 and ``_bigru_bwd_kernel`` (:211, K5) at D=2, the BPTT with
the gates recomputed from the stored outputs. The kernel is
``csrc/gru_bwd.cu``. ``GRUFunction`` wraps the pair for autograd and
forms dW and db outside the kernel by one f32 product, as
``_gru_bwd``/``_bigru_bwd`` do with one einsum.

What bounds them on the H100: each step's ``[B,H] x [H,3H]`` product
needs the step before, so the T steps are serial and the time is T
times one step's latency, far above the FLOP roofline (2*T*D*B*H*3H
per product over 989 TFLOP/s in bf16) and the byte roofline (the
inputs and outputs once over 3.35 TB/s). The kernels therefore keep W
out of device memory for the whole sequence: one cooperative launch per
layer, a group of hidden units a block, each holding its slice of W in
shared memory, a grid-wide barrier between steps: on the CUDA cores
(f32, and bf16 with H % 8 != 0) D x ceil(H/16) blocks with a ``[H, 48]``
f32 slice each; in bf16 with H % 8 == 0 a serial loop on ``mma.sync``
with each group's rows of W (W^T for the forward) in bf16, the backward
after recomputing every step's gates as one tensor-core GEMM
(``csrc/gru_fwd_mma.cuh``, ``csrc/gru_bwd_mma.cuh``). See the sources
for the layouts.

Where W does not fit that way (ds2_full's H=1760: a 345 KB slice per
block, 220 blocks at D=2 on 132 SMs), ``gru_fwd`` and ``gru_bwd`` launch
the streamed kernels instead, ``gru_fwd_stream`` (``csrc/
gru_fwd_stream.cu``, replacing ``_gru_kernel_blocked``, rnn_pallas.py:260,
K8) and ``gru_bwd_stream`` (``csrc/gru_bwd_stream.cu``, replacing
``_gru_bwd_kernel_blocked``, :312, K9), which stream W from global memory
every step; in bf16 with H % 8 == 0 both run a serial loop on the tensor
cores (``mma.sync``) with part of W held in shared memory for the call,
else a CUDA-core kernel that stages W through shared memory as f32.
``resident_fits`` makes the choice on the host before the launch, from
the shapes and the card's SM count and shared memory, as the TPU
package's ``_use_blocked`` and ``bigru_fits_vmem`` make it from the VMEM
budget (rnn_pallas.py:455, :709). Each kernel counts its own launches.

``gru_fwd_q`` is the forward with weight-only int8 recurrent weights
(``utils/quantize.py``'s layout: int8 ``Q [H,3H]`` and an f32 scale per
output channel), for inference: ``(h @ Q) * scale + b``. It launches
``csrc/gru_fwd_q.cu``, replacing ``_gru_kernel_q`` (:581, K10): ds2_full's
H=1760, streamed in bf16, is resident in int8. Where the int8 slices do
not fit, or when the caller forces it, it launches ``gru_fwd_q_stream``
(``csrc/gru_fwd_q_stream.cu``, replacing ``_gru_kernel_blocked_q``, :282,
K11). With bf16 dots and H % 8 == 0 both run one serial loop on the
tensor cores (``csrc/gru_fwd_q_mma.cuh``: Q^T written once as s8, widened
to bf16 in registers for ``mma.sync``), K10 with as much of Q^T held in
shared memory as fits, K11 with a fixed share; else a CUDA-core kernel.

On a CPU tensor a wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises. There is no fallback between the two,
nor between the resident and the streamed kernel.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Optional, Sequence, Tuple

import torch

from . import _build
from .precision import full_f32_matmul

_DTYPES = (torch.bfloat16, torch.float32)

# An H100 SXM's limits, the defaults of ``resident_fits``: SMs, the
# shared memory one block may opt into, and the shared memory of one SM
# (the runtime keeps 1 KB of it per resident block).
H100_SMS = 132
H100_SMEM_PER_BLOCK = 232448
H100_SMEM_PER_SM = 233472
_SMEM_RESERVED_PER_BLOCK = 1024
# The resident kernels' tile (csrc/gru_fwd.cu, csrc/gru_bwd.cu): hidden
# units per block, h_prev columns per chunk, batch rows per pass, threads.
_U, _KC, _ROWS, _THREADS = 16, 64, 32, 256
_MAX_THREADS_PER_SM = 2048
# The resident kernels the rule below knows: the GRU's and the LSTM's.
_KINDS = ("fwd", "bwd", "fwd_q", "lstm_fwd", "lstm_fwd_q", "lstm_bwd")
# The backward tensor-core loops with W resident (csrc/lstm_bwd.cu and
# csrc/gru_bwd.cu in bf16 with H % 8 == 0, on csrc/lstm_bwd_mma.cuh and
# csrc/gru_bwd_mma.cuh): their warps, the depth of a chunk of the
# 4H- or 3H-deep product, and the group widths both launches take, the
# narrow one where every group gets an SM, else the wide, each with the
# stages of a warp's ring of 16-byte dgates-row pieces (4 a lane a
# chunk) that both sources give it.
_MMA_WARPS, _MMA_KC = 8, 32
_MMA_NARROW, _MMA_WIDE = 8, 16
_MMA_STAGES = {_MMA_NARROW: 6, _MMA_WIDE: 4}
# The forwards' loops with all of W^T resident (csrc/gru_fwd.cu and
# csrc/lstm_fwd.cu in bf16 with H % 8 == 0, on csrc/gru_fwd_mma.cuh and
# csrc/lstm_fwd_mma.cuh) take the same widths, with these stages of a
# warp's ring of 16-byte h-row pieces, which both sources give them.
_FWD_MMA_STAGES = {_MMA_NARROW: 4, _MMA_WIDE: 4}


def _mma_smem_bytes(gates: int, units: int, h: int) -> int:
    """Shared memory of one block of a backward tensor-core loop with W
    resident (``Plan::smem`` of csrc/lstm_bwd_mma.cuh and csrc/
    gru_bwd_mma.cuh): the warps' rings (the width's stages of 4 pieces a
    lane; the partial sums alias them) and every warp's chunks of the
    group's ``[units, gates*H]`` rows of W in bf16, ``units/8`` pieces a
    lane a chunk."""
    ring = _MMA_WARPS * _MMA_STAGES[units] * 4 * 32
    red = _MMA_WARPS * _ROWS * (units + 8) // 4
    chunks = -(-(-(-gates * h // _MMA_KC)) // _MMA_WARPS)
    return 16 * (max(ring, red) + _MMA_WARPS * chunks * (units // 8) * 32)


def lstm_bwd_mma(dtype: torch.dtype, h: int) -> bool:
    """Whether ``csrc/lstm_bwd.cu`` runs its tensor-core path for this
    dot dtype and H: bf16 with H a multiple of 8 (a 16-byte piece of a
    row holds 8 values). The C entry point also needs w, ys and the
    scratch 16-byte aligned, which the port's own tensors are; ops/
    lstm.py's ``_bwd_mma`` checks that too."""
    return dtype == torch.bfloat16 and h % 8 == 0


def lstm_bwd_mma_width(d: int, h: int, sms: int = H100_SMS) -> int:
    """The group width ``csrc/lstm_bwd.cu``'s launch takes for the
    tensor-core loop: 8 units where D x ceil(H/8) groups get an SM each
    (D=1 at H=800: 100 groups), else 16 (D=2 at H=800: 100 groups)."""
    return (_MMA_NARROW if d * -(-h // _MMA_NARROW) <= sms
            else _MMA_WIDE)


def lstm_bwd_mma_smem_bytes(units: int, h: int) -> int:
    """Shared memory of one block of the tensor-core loop (csrc/
    lstm_bwd_mma.cuh ``Plan``) for groups of ``units``: the warps' rings
    (the width's stages of 4 pieces a lane; the partial sums alias them)
    and every warp's chunks of the group's ``[units, 4H]`` rows of W in
    bf16, ``units/8`` pieces a lane a chunk."""
    return _mma_smem_bytes(4, units, h)


# csrc/gru_bwd.cu (K5/K7) runs its tensor-core path by the LSTM's rule
# (bf16, H % 8 == 0; csrc/gru_bwd_stream.cu's K9 too) and its launch
# takes the same group widths.
gru_bwd_mma = lstm_bwd_mma
gru_bwd_mma_width = lstm_bwd_mma_width


def gru_bwd_mma_smem_bytes(units: int, h: int) -> int:
    """Shared memory of one block of ``csrc/gru_bwd.cu``'s tensor-core
    loop (csrc/gru_bwd_mma.cuh ``Plan`` with ``W_ALL``) for groups of
    ``units``: the rings and every warp's chunks of the group's
    ``[units, 3H]`` rows of W in bf16."""
    return _mma_smem_bytes(3, units, h)


# csrc/gru_fwd.cu (K4/K6) runs its tensor-core path by the same rule and
# its launch takes the same group widths.
gru_fwd_mma = lstm_bwd_mma
gru_fwd_mma_width = lstm_bwd_mma_width


def _fwd_mma_smem_bytes(gates: int, units: int, h: int) -> int:
    """Shared memory of one block of a forward tensor-core loop with all
    of W^T resident (``Plan::smem`` of csrc/gru_fwd_mma.cuh and csrc/
    lstm_fwd_mma.cuh with ``W_ALL``) for groups of ``units``: the warps'
    rings (the width's stages of 4 h-row pieces a lane), which the warps'
    partial sums alias (rows of ``gates*units`` f32 padded to 8 mod 16),
    then every 32-deep chunk of the group's ``[gates*units, H]`` rows of
    W^T in bf16."""
    gcol = gates * units
    red_s = gcol + 8 + (8 if (gcol + 8) % 16 == 0 else 0)
    ring = _MMA_WARPS * _FWD_MMA_STAGES[units] * 4 * 32
    red = _MMA_WARPS * _ROWS * red_s // 4
    return 16 * (max(ring, red) + -(-h // _MMA_KC) * (gcol // 8) * 32)


def gru_fwd_mma_smem_bytes(units: int, h: int) -> int:
    """Shared memory of one block of ``csrc/gru_fwd.cu``'s tensor-core
    loop for groups of ``units``: ``_fwd_mma_smem_bytes`` with three
    gates, the group's ``[3*units, H]`` rows of W^T."""
    return _fwd_mma_smem_bytes(3, units, h)


# csrc/lstm_fwd.cu (K12) runs its tensor-core path by the same rule and
# its launch takes the same group widths; so does csrc/lstm_fwd_q.cu
# (K16) with bf16 dots, on Q^T widened to bf16.
lstm_fwd_mma = lstm_bwd_mma
lstm_fwd_mma_width = lstm_bwd_mma_width


def lstm_fwd_mma_smem_bytes(units: int, h: int) -> int:
    """Shared memory of one block of ``csrc/lstm_fwd.cu``'s (and
    ``csrc/lstm_fwd_q.cu``'s) tensor-core loop for groups of ``units``:
    ``_fwd_mma_smem_bytes`` with four gates, the group's ``[4*units, H]``
    rows of W^T in bf16 (the cell state lives in the scratch, not in the
    block)."""
    return _fwd_mma_smem_bytes(4, units, h)


def resident_smem_bytes(kind: str, h: int, b: int,
                        dtype: torch.dtype = torch.float32,
                        units: int = _MMA_WIDE) -> int:
    """Shared memory one block of the resident kernel takes: W's
    ``[H, 48]`` slice and the staged h_prev chunk as f32 (whatever the
    dot dtype), and for ``kind="bwd"`` the dgates tile and the carried
    dh of the block's units for ``b`` batch rows; in bf16 on
    ``gru_bwd_mma``'s rule the GRU backward runs the tensor-core loop,
    whose block holds its group's ``[units, 3H]`` rows of W in bf16
    beside the rings, whatever ``b`` (``gru_bwd_mma_smem_bytes``), and
    on ``gru_fwd_mma``'s the forward's holds its group's ``[3*units, H]``
    rows of W^T (``gru_fwd_mma_smem_bytes``). For
    ``kind="fwd_q"`` (``csrc/gru_fwd_q.cu``) the slice is int8, 16 bytes
    of padding a column, beside the chunk of it widened to f32 and the
    h_prev chunk.
    The LSTM kernels (``"lstm_fwd"``: ``csrc/lstm_fwd.cu``,
    ``"lstm_fwd_q"``: ``csrc/lstm_fwd_q.cu``) lay out the same with four
    gates, a ``[H, 64]`` slice, and add the cell state of the block's
    units for ``b`` batch rows as f32; in bf16 on ``lstm_fwd_mma``'s
    rule the forward runs the tensor-core loop, whose block holds its
    group's ``[4*units, H]`` rows of W^T beside the rings and keeps the
    cell state in the scratch, whatever ``b``
    (``lstm_fwd_mma_smem_bytes``); so does ``"lstm_fwd_q"`` with bf16
    dots, its W^T the int8 Q widened to bf16. The LSTM backward (``"lstm_bwd"``:
    ``csrc/lstm_bwd.cu``) in f32, or in bf16 off ``lstm_bwd_mma``'s
    rule, keeps the slice and one ``[32, 68]`` tile, which holds the
    h_prev chunk during the gate recompute and the dgates tile after it
    (four gates of 16 units are the chunk's 64 columns), and adds dh and
    dc of the block's units for ``b`` rows; in bf16 on that rule it runs
    the tensor-core loop, whose block holds its group's ``[units, 4H]``
    rows of W in bf16 beside the rings, whatever ``b``
    (``lstm_bwd_mma_smem_bytes``)."""
    if kind not in _KINDS:
        raise ValueError(f"kind must be one of {_KINDS}, not {kind!r}")
    if kind == "lstm_bwd" and lstm_bwd_mma(dtype, h):
        return lstm_bwd_mma_smem_bytes(units, h)
    if kind == "bwd" and gru_bwd_mma(dtype, h):
        return gru_bwd_mma_smem_bytes(units, h)
    if kind == "fwd" and gru_fwd_mma(dtype, h):
        return gru_fwd_mma_smem_bytes(units, h)
    if kind in ("lstm_fwd", "lstm_fwd_q") and lstm_fwd_mma(dtype, h):
        return lstm_fwd_mma_smem_bytes(units, h)
    h_pad = -(-h // _KC) * _KC
    gc = (4 if kind.startswith("lstm") else 3) * _U  # gate columns
    if kind.endswith("fwd_q"):
        nbytes = gc * (h_pad + 16) + 4 * (gc + _ROWS) * (_KC + 4)
        return nbytes + (4 * b * _U if kind == "lstm_fwd_q" else 0)
    floats = gc * (h_pad + 4) + _ROWS * (_KC + 4)
    if kind == "bwd":
        floats += _ROWS * (3 * _U + 4) + 2 * b * _U
    elif kind == "lstm_bwd":
        floats += 2 * b * _U
    elif kind == "lstm_fwd":
        floats += b * _U
    return 4 * floats


def resident_fits(kind: str, d: int, h: int, b: int, dtype: torch.dtype,
                  sms: int = H100_SMS,
                  smem_per_block: int = H100_SMEM_PER_BLOCK,
                  smem_per_sm: int = H100_SMEM_PER_SM) -> bool:
    """Whether the resident kernel (``csrc/gru_fwd.cu`` for ``kind=
    "fwd"``, ``csrc/gru_bwd.cu`` for ``"bwd"``, ``csrc/gru_fwd_q.cu``
    for ``"fwd_q"``, ``csrc/lstm_fwd.cu`` for ``"lstm_fwd"``,
    ``csrc/lstm_fwd_q.cu`` for ``"lstm_fwd_q"``, ``csrc/lstm_bwd.cu`` for
    ``"lstm_bwd"``) can run D directions of H units at batch ``b`` on a
    card with these limits: its shared memory per block within what a
    block may have, and its D * ceil(H/16) blocks all resident at once,
    as the grid barrier needs. When not, ``gru_fwd``/``gru_bwd``/
    ``gru_fwd_q`` and ``ops/lstm.py``'s ``lstm_fwd``/``lstm_fwd_q``/
    ``lstm_bwd`` launch the streamed kernel. The card's values default
    to an H100's, so the rule runs without a card.

    The Hopper counterpart of the TPU package's ``fits_vmem``,
    ``_use_blocked`` and ``bigru_fits_vmem`` (rnn_pallas.py:66, :455,
    :709). The resident kernels stage W as f32 (int8 for the ``_q``
    kinds) whatever the dot dtype, so ``dtype`` (bf16 or f32) does not
    move their answer, except for ``"fwd"``, ``"bwd"``, ``"lstm_fwd"``,
    ``"lstm_fwd_q"`` and ``"lstm_bwd"``: in bf16 with H % 8 == 0
    (``gru_fwd_mma``, ``gru_bwd_mma``, ``lstm_fwd_mma``,
    ``lstm_bwd_mma``) their tensor-core loops hold W's rows (the
    forwards' W^T; for ``"lstm_fwd_q"`` the int8 Q^T widened to bf16) in
    bf16, one block an SM for each group of ``gru_fwd_mma_width``
    (``gru_bwd_mma_width``, ``lstm_fwd_mma_width``,
    ``lstm_bwd_mma_width``) units, and do not depend on ``b``. ``"fwd"``
    fits at ds2_small's and ds2_streaming's H=800 (f32: 165 KB, 100 or
    50 blocks; bf16: 139 KB in 100 groups of 16 units at D=2, 102 KB in
    100 groups of 8 at D=1); in bf16 it admits H up to 1056 at D=2 and
    1728 at D=1. ``"bwd"`` fits at ds2_small's and ds2_streaming's
    H=800 (f32: 176 KB at b=32, 100 or 50 blocks; bf16: 144 KB in 100
    groups of 16 units at D=2, 136 KB in 100 groups of 8 at D=1) and
    misses at ds2_full's H=1760 in both dtypes; in bf16 it admits H up to
    1056 at D=2 and 1704 at D=1. ds2_full (D=2, H=1760) misses for
    ``"fwd"`` and fits for ``"fwd_q"``: 106 KB a block, two blocks an SM;
    with four gates it misses for both LSTM kinds (140 KB of int8 slice
    and staging a block, one an SM, 220 blocks), and ds2_small's H=800
    fits for both (``"lstm_fwd"``: f32 220 KB a block at b=32, one an SM,
    100 blocks; bf16 172 KB in 100 groups of 16 units at D=2, 114 KB in
    100 groups of 8 at D=1, whatever b). In bf16 ``"lstm_fwd"`` and
    ``"lstm_fwd_q"`` admit H up to 1056 at D=2 and 1216 at D=1, whatever
    b; ds2_full's H=1760 streams. In f32 (and in bf16 off the H % 8
    rule) ``"lstm_fwd_q"`` keeps the CUDA-core kernel's int8 slice, 80 KB
    at H=800, which admits H up to 1344 at D=2 (b=32, two blocks an SM)
    and 2112 at D=1.
    ``"lstm_bwd"`` fits at ds2_small's and ds2_streaming's H=800 (f32:
    222 KB at b=32, 100 or 50 blocks; bf16: 168 KB in 100 groups of 16
    units at D=2, 148 KB in 100 groups of 8 at D=1) and misses at
    ds2_full's H=1760 in both dtypes; in bf16 it admits H up to 1056 at
    D=2 and 1280 at D=1."""
    if dtype not in _DTYPES:
        raise ValueError(f"dtype must be bf16 or f32, not {dtype}")
    units, most = _U, _MAX_THREADS_PER_SM // _THREADS
    if kind == "lstm_bwd" and lstm_bwd_mma(dtype, h):
        units, most = lstm_bwd_mma_width(d, h, sms), 1
    elif kind == "bwd" and gru_bwd_mma(dtype, h):
        units, most = gru_bwd_mma_width(d, h, sms), 1
    elif kind == "fwd" and gru_fwd_mma(dtype, h):
        units, most = gru_fwd_mma_width(d, h, sms), 1
    elif kind in ("lstm_fwd", "lstm_fwd_q") and lstm_fwd_mma(dtype, h):
        units, most = lstm_fwd_mma_width(d, h, sms), 1
    smem = resident_smem_bytes(kind, h, b, dtype, units)
    if smem > smem_per_block:
        return False
    per_sm = min(smem_per_sm // (smem + _SMEM_RESERVED_PER_BLOCK), most)
    return d * -(-h // units) <= sms * per_sm


def card_limits(device: torch.device) -> Tuple[int, int, int]:
    """``(sms, smem_per_block, smem_per_sm)`` of a CUDA device, in the
    order ``resident_fits`` takes them after its first five arguments."""
    p = torch.cuda.get_device_properties(device)
    return (p.multi_processor_count, p.shared_memory_per_block_optin,
            p.shared_memory_per_multiprocessor)


def _check(xp, mask, w, b, h0, reverse, scale=None, gates: int = 3) -> None:
    """The forward kernels' argument rules, for ``gates`` gates (3: the
    GRU, 4: ``ops/lstm.py``'s LSTM); with ``scale`` (the int8 kernels)
    ``w`` is int8 and ``scale`` f32 ``[D,GH]``, else ``w`` has xp's
    dtype."""
    g = f"{gates}H"
    if xp.dim() != 3 or w.dim() != 3:
        raise ValueError(f"xp must be [T,B,{g}] and w [D,H,{g}]; got "
                         f"{tuple(xp.shape)} and {tuple(w.shape)}")
    t, bsz, gh = xp.shape
    d, h = w.shape[0], w.shape[1]
    if gh != gates * h or w.shape[2] != gates * h:
        raise ValueError(f"xp [T,B,{gh}] and w {tuple(w.shape)} disagree "
                         f"on {g}")
    if len(reverse) != d:
        raise ValueError(f"reverse has {len(reverse)} flags for D={d}")
    w_dtype = xp.dtype if scale is None else torch.int8
    if xp.dtype not in _DTYPES or w.dtype != w_dtype:
        raise ValueError(f"xp must be bf16 or f32 and w {w_dtype}; got "
                         f"{xp.dtype}, {w.dtype}")
    want = {"mask": (mask, (t, bsz)), "b": (b, (d, gh))}
    if h0 is not None:
        want["h0"] = (h0, (d, bsz, h))
    if scale is not None:
        want["scale"] = (scale, (d, gh))
    for name, (x, shape) in want.items():
        if tuple(x.shape) != shape or x.dtype != torch.float32:
            raise ValueError(f"{name} must be f32 {list(shape)}; got "
                             f"{x.dtype} {list(x.shape)}")
    for name, x in (("xp", xp), ("mask", mask), ("w", w), ("b", b),
                    ("h0", h0), ("scale", scale)):
        if x is None:
            continue
        if x.device != xp.device:
            raise ValueError(f"{name} is on {x.device}, xp on {xp.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _fwd_plain_loop(xp, mask, h0, reverse, d: int, h: int, gates
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward recurrence as an eager time loop; ``gates(di, hc)``
    gives direction ``di``'s recurrent gates ``[B,3H]`` f32 from the f32
    carry."""
    t, bsz, _ = xp.shape
    ys = torch.empty((d, t, bsz, h), dtype=torch.float32, device=xp.device)
    hfin = torch.empty((d, bsz, h), dtype=torch.float32, device=xp.device)
    for di in range(d):
        hc = (torch.zeros((bsz, h), dtype=torch.float32, device=xp.device)
              if h0 is None else h0[di].float())
        for s in range(t):
            row = t - 1 - s if reverse[di] else s
            g = gates(di, hc)
            x = xp[row].float()
            r = torch.sigmoid(x[:, :h] + g[:, :h])
            z = torch.sigmoid(x[:, h:2 * h] + g[:, h:2 * h])
            n = torch.tanh(x[:, 2 * h:] + r * g[:, 2 * h:])
            hnew = (1.0 - z) * n + z * hc
            m = mask[row][:, None]
            hc = m * hnew + (1.0 - m) * hc
            ys[di, row] = hc
        hfin[di] = hc
    return ys, hfin


def gru_fwd_plain(xp: torch.Tensor, mask: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor, h0: Optional[torch.Tensor] = None,
                  reverse: Sequence[bool] = (False,)
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of ``gru_fwd``: an eager time loop with
    the same arithmetic (h_prev rounded to ``w.dtype`` for the product,
    the product and the carry in f32)."""
    w32 = w.float()
    return _fwd_plain_loop(
        xp, mask, h0, reverse, w.shape[0], w.shape[1],
        lambda di, hc: hc.to(w.dtype).float() @ w32[di] + b[di])


def gru_fwd_q_plain(xp: torch.Tensor, mask: torch.Tensor, wq: torch.Tensor,
                    scale: torch.Tensor, b: torch.Tensor,
                    h0: Optional[torch.Tensor] = None,
                    reverse: Sequence[bool] = (False,)
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of ``gru_fwd_q``: ``gru_fwd_plain``'s
    loop with the gates ``(round(h) @ Q) * scale + b``, h rounded to the
    dot dtype ``xp.dtype`` (int8 widens to bf16 and f32 exactly), the
    product in f32 and the scale on the finished column sums, as
    ``_gru_kernel_q`` computes them (rnn_pallas.py:601-603)."""
    q32 = wq.float()
    return _fwd_plain_loop(
        xp, mask, h0, reverse, wq.shape[0], wq.shape[1],
        lambda di, hc: (hc.to(xp.dtype).float() @ q32[di]) * scale[di]
        + b[di])


# Types each loaded library's functions once (``_lib``, ``_launcher``):
# the gateway's worker threads launch kernels concurrently, and a ctypes
# function must not be re-typed while another thread calls it. The
# types live on the library object, so a library put into
# ``_build._loaded`` by hand (a source variant) is typed afresh.
_type_lock = threading.Lock()


def _lib(name: str) -> ctypes.CDLL:
    """``csrc/<name>.cu`` loaded, with its error-string function (and a
    backward kernel's scratch sizes) typed; ``_launcher`` types the
    launch function."""
    lib = _build.load(name)
    if getattr(lib, "_ds2_launchers", None) is not None:
        return lib
    with _type_lock:
        if getattr(lib, "_ds2_launchers", None) is not None:
            return lib
        i = ctypes.c_int
        if name.startswith(("gru_bwd", "lstm_bwd")):
            sizes = ["scratch_floats"] + (["mma_scratch_floats"]
                                          if name in ("gru_bwd", "lstm_bwd")
                                          else [])
            for size in sizes:
                scratch = getattr(lib, f"{name}_{size}")
                scratch.argtypes = [i, i, i]
                scratch.restype = ctypes.c_longlong
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [i]
        err.restype = ctypes.c_char_p
        lib._ds2_launchers = {}
    return lib


def _launcher(name: str, n_ptrs: int):
    """``<name>_launch`` of the loaded library, typed for ``n_ptrs``
    pointer arguments after ``w``."""
    lib = _lib(name)
    launch = lib._ds2_launchers.get(n_ptrs)
    if launch is None:
        with _type_lock:
            launch = lib._ds2_launchers.get(n_ptrs)
            if launch is None:
                p, i = ctypes.c_void_p, ctypes.c_int
                # A function object of its own for each typing: a
                # parent tree's source takes fewer pointers.
                launch = lib[f"{name}_launch"]
                launch.argtypes = [i, p, p, p, *[p] * n_ptrs,
                                   i, i, i, i, i, i, p]
                launch.restype = i
                lib._ds2_launchers[n_ptrs] = launch
    return lib, launch


# The calling thread's open ``launch_tally``: (counts, captured) or None.
_tally = threading.local()


@contextlib.contextmanager
def launch_tally(captured: bool = False):
    """Count the kernel launches this thread's wrappers make inside the
    block, as ``{wrapper name: calls}`` (other threads' launches are not
    in it). ``captured=True`` is for a CUDA graph capture
    (``utils/rung_graph.py``): the launches are recorded into the graph,
    not run, so they go to the tally instead of the wrappers'
    ``launches``; each replay of the graph runs them."""
    prev = getattr(_tally, "open", None)
    counts: dict = {}
    _tally.open = (counts, captured)
    try:
        yield counts
    finally:
        _tally.open = prev


def _counted(fn) -> None:
    """Add one to a wrapper's ``launches`` (and to this thread's open
    ``launch_tally``); the gateway's worker threads launch concurrently,
    and ``+=`` on an attribute is not atomic."""
    tally = getattr(_tally, "open", None)
    if tally is not None:
        counts, captured = tally
        counts[fn.__name__] = counts.get(fn.__name__, 0) + 1
        if captured:
            return
    with _type_lock:
        fn.launches += 1


def _require_cuda(xp: torch.Tensor, name: str) -> None:
    if xp.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {xp.device}")


def require_current(t: torch.Tensor, name: str) -> None:
    """Refuse a CUDA tensor that is not on the current device: the
    kernels launch through ``ctypes`` on the current device, so one on
    another card would run on the wrong card (a process group's rank
    sets its device at ``initialize_distributed``). Never moved
    quietly."""
    index = t.device.index
    if index is not None and index != torch.cuda.current_device():
        raise ValueError(
            f"{name}: the tensor is on {t.device}, the current device is "
            f"cuda:{torch.cuda.current_device()}; call "
            "torch.cuda.set_device first")


def current_device(device: torch.device):
    """The context a shard's work runs in: its card current (the kernels
    launch on the current device), nothing on the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _launch(name: str, xp: torch.Tensor, mask: torch.Tensor,
            w: torch.Tensor, tensors: Sequence[Optional[torch.Tensor]],
            reverse: Tuple[bool, ...]) -> None:
    """Launch ``csrc/<name>.cu`` on PyTorch's current stream, or raise if
    the launch is refused. Every kernel's C function takes ``(bf16, xp,
    mask, w, *tensors, D, T, B, H, reverse_bits, device, stream)``;
    ``tensors`` are the pointer arguments after ``w`` in the C order
    (None for a null pointer)."""
    require_current(xp, name)
    lib, launch = _launcher(name, len(tensors))
    t, bsz, _ = xp.shape
    d, h = w.shape[0], w.shape[1]
    rc = launch(
        int(xp.dtype == torch.bfloat16), xp.data_ptr(), mask.data_ptr(),
        w.data_ptr(), *(None if x is None else x.data_ptr() for x in tensors),
        d, t, bsz, h, sum(1 << i for i, r in enumerate(reverse) if r),
        xp.device.index, torch.cuda.current_stream(xp.device).cuda_stream)
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(
            f"{name} kernel launch failed (D={d}, T={t}, B={bsz}, H={h}, "
            f"xp {xp.dtype}, w {w.dtype}): {msg} [cudaError {rc}]")


def gru_fwd(xp: torch.Tensor, mask: torch.Tensor, w: torch.Tensor,
            b: torch.Tensor, h0: Optional[torch.Tensor] = None,
            reverse: Sequence[bool] = (False,)
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GRU forward over D directions that share one input projection.

    ``xp [T,B,3H]`` (includes the input bias) and ``w [D,H,3H]`` in one
    dtype, bf16|f32, the dot dtype; ``mask [T,B]`` f32 (1 = valid),
    ``b [D,3H]`` f32 recurrent bias, ``h0 [D,B,H]`` f32 or None (zeros),
    ``reverse[d]`` True for a direction that runs t = T-1..0.
    Returns ``ys [D,T,B,H]`` f32 (a masked frame holds the previous h)
    and ``hfin [D,B,H]`` f32, the carry after the last step.

    Gates r, z, n: ``n = tanh(xp_n + r * (h W_n + b_n))``,
    ``h' = (1-z) n + z h``. The product rounds h_prev to ``w.dtype`` and
    sums in f32; the carry and outputs stay f32.

    A CPU tensor runs ``gru_fwd_plain``. A CUDA tensor calls the
    resident kernel's C entry point ``csrc/gru_fwd.cu`` once (counted in
    ``gru_fwd.launches``) where ``resident_fits`` says it can hold W,
    and ``gru_fwd_stream`` otherwise; a refused launch raises. Where
    ``_fwd_mma`` holds (bf16, H % 8 == 0) that call is two launches,
    W^T written into the scratch (and ``h0`` rounded into the h row step
    0 reads), then the serial ``mma.sync`` loop with each group's rows of
    W^T held in shared memory (``csrc/gru_fwd_mma.cuh``); f32 and other
    bf16 calls run the CUDA-core kernel.
    """
    reverse = tuple(bool(r) for r in reverse)
    _check(xp, mask, w, b, h0, reverse)
    if xp.device.type == "cpu":
        return gru_fwd_plain(xp, mask, w, b, h0, reverse)
    _require_cuda(xp, "gru_fwd")
    if not resident_fits("fwd", w.shape[0], w.shape[1], xp.shape[1],
                         w.dtype, *card_limits(xp.device)):
        return gru_fwd_stream(xp, mask, w, b, h0, reverse)
    ys, hfin = _fwd_outputs(xp, w, h0)
    if ys.numel():
        _launch("gru_fwd", xp, mask, w,
                (b, h0, ys, hfin, _fwd_scratch(xp, w)), reverse)
        _counted(gru_fwd)
    return ys, hfin


gru_fwd.launches = 0


def _fwd_outputs(xp, w, h0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Empty ``ys [D,T,B,H]`` and ``hfin [D,B,H]`` f32 on xp's device;
    with no step or no row to run, ``hfin`` is already the carry in."""
    t, bsz, _ = xp.shape
    d, h = w.shape[0], w.shape[1]
    ys = torch.empty((d, t, bsz, h), dtype=torch.float32, device=xp.device)
    hfin = torch.empty((d, bsz, h), dtype=torch.float32, device=xp.device)
    if not ys.numel():
        hfin.copy_(h0 if h0 is not None else torch.zeros_like(hfin))
    return ys, hfin


def _fwd_mma(w: torch.Tensor) -> bool:
    """Whether the C call of ``gru_fwd`` or ``gru_fwd_stream`` runs its
    tensor-core path (csrc/gru_fwd_mma.cuh's transpose and loop):
    ``gru_fwd_mma`` (bf16 with H a multiple of 8: a 16-byte piece of a
    row holds 8 values), the rule ``gru_fwd_launch`` and
    ``gru_fwd_stream_launch`` apply before any launch (they also need
    the scratch 16-byte aligned, which ``torch.empty`` is). Else the
    CUDA-core kernel runs."""
    return gru_fwd_mma(w.dtype, w.shape[1])


def _fwd_scratch(xp, w) -> torch.Tensor:
    """The scratch of both forward kernels' C calls, f32: on the
    tensor-core path the rounded h rows ``[2,D,B,H]`` and ``Wt = W^T
    [D,3H,H]``, both in bf16 (``D*B*H + 3*D*H*H/2`` floats); none for
    the CUDA-core kernels."""
    d, bsz, h = w.shape[0], xp.shape[1], w.shape[1]
    floats = d * bsz * h + 3 * d * h * h // 2 if _fwd_mma(w) else 0
    return torch.empty((floats,), dtype=torch.float32, device=xp.device)


def gru_fwd_stream(xp: torch.Tensor, mask: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor, h0: Optional[torch.Tensor] = None,
                   reverse: Sequence[bool] = (False,)
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``gru_fwd`` through the streamed kernel ``csrc/gru_fwd_stream.cu``
    (K8), whatever the sizes: W stays in global memory and crosses L2
    once a step. Where ``_fwd_mma`` holds (bf16, H % 8 == 0) the
    C call transposes W into the scratch (and rounds ``h0`` into the h
    row step 0 reads) and runs the serial loop on the tensor cores, two
    launches, with part of W^T held in shared memory for the call; else
    one launch of the CUDA-core kernel (see the source). The same
    contract and arithmetic as ``gru_fwd``. A CPU tensor runs
    ``gru_fwd_plain``; a CUDA tensor calls the kernel's C entry point
    once (counted in ``gru_fwd_stream.launches``) or raises."""
    reverse = tuple(bool(r) for r in reverse)
    _check(xp, mask, w, b, h0, reverse)
    if xp.device.type == "cpu":
        return gru_fwd_plain(xp, mask, w, b, h0, reverse)
    _require_cuda(xp, "gru_fwd_stream")
    ys, hfin = _fwd_outputs(xp, w, h0)
    if ys.numel():
        _launch("gru_fwd_stream", xp, mask, w,
                (b, h0, ys, hfin, _fwd_scratch(xp, w)), reverse)
        _counted(gru_fwd_stream)
    return ys, hfin


gru_fwd_stream.launches = 0


def gru_fwd_q(xp: torch.Tensor, mask: torch.Tensor, wq: torch.Tensor,
              scale: torch.Tensor, b: torch.Tensor,
              h0: Optional[torch.Tensor] = None,
              reverse: Sequence[bool] = (False,),
              blocked: Optional[bool] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GRU forward over D directions with weight-only int8 recurrent
    weights, for inference (no gradient).

    ``xp [T,B,3H]`` bf16|f32 (the dot dtype; includes the input bias),
    ``mask [T,B]`` f32, ``wq [D,H,3H]`` int8 and ``scale [D,3H]`` f32
    (one per output channel, ``utils/quantize.py``'s layout), ``b [D,3H]``
    f32, ``h0 [D,B,H]`` f32 or None, ``reverse`` as ``gru_fwd`` takes
    them. Returns ``ys [D,T,B,H]`` and ``hfin [D,B,H]`` f32. The gates are
    ``(round(h) @ Q) * scale + b``: h_prev rounded to the dot dtype, the
    sum in f32, the scale applied to the finished column sums; then
    ``gru_fwd``'s update.

    A CPU tensor runs ``gru_fwd_q_plain``. A CUDA tensor calls the
    resident kernel's C entry point ``csrc/gru_fwd_q.cu`` once (counted
    in ``gru_fwd_q.launches``) where ``resident_fits("fwd_q", ...)``
    holds on this card, and ``gru_fwd_q_stream`` otherwise. Where
    ``_fwd_q_mma`` holds (bf16 dots, H % 8 == 0) the C call transposes Q
    into the scratch (and rounds ``h0`` into the h row step 0 reads) and
    runs the serial loop on the tensor cores, two launches, with as much
    of Q^T held in shared memory as fits; else one launch of the
    CUDA-core kernel. ``blocked`` forces the choice, as
    ``gru_scan_pallas_q``'s does (rnn_pallas.py:619): True the streamed
    kernel, False the resident one, which raises where it does not fit
    (judged on an H100's limits for a CPU tensor). Both kernels take
    ``h0``. A refused launch raises.
    """
    reverse = tuple(bool(r) for r in reverse)
    _check(xp, mask, wq, b, h0, reverse, scale)
    if xp.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gru_fwd_q runs on cpu or cuda, not {xp.device}")
    d, h, bsz = wq.shape[0], wq.shape[1], xp.shape[1]
    card = card_limits(xp.device) if xp.device.type == "cuda" else ()
    fits = resident_fits("fwd_q", d, h, bsz, xp.dtype, *card)
    if blocked is False and not fits:
        raise ValueError(
            f"gru_fwd_q forced resident (blocked=False), but D={d} x H={h} "
            f"int8 slices do not fit the card's shared memory and SMs")
    if xp.device.type == "cpu":
        return gru_fwd_q_plain(xp, mask, wq, scale, b, h0, reverse)
    if (not fits) if blocked is None else blocked:
        return gru_fwd_q_stream(xp, mask, wq, scale, b, h0, reverse)
    ys, hfin = _fwd_outputs(xp, wq, h0)
    if ys.numel():
        _launch("gru_fwd_q", xp, mask, wq,
                (scale, b, h0, ys, hfin, _fwd_q_scratch(xp, wq)), reverse)
        _counted(gru_fwd_q)
    return ys, hfin


gru_fwd_q.launches = 0


def _fwd_q_mma(xp: torch.Tensor, wq: torch.Tensor) -> bool:
    """Whether the C call of ``gru_fwd_q`` or ``gru_fwd_q_stream`` runs
    its tensor-core path: bf16 dots (``xp``'s dtype; Q is always int8)
    with H a multiple of 8 (a 16-byte piece of the h row holds 8
    values), the rule ``gru_fwd_q_launch`` and ``gru_fwd_q_stream_launch``
    apply before any launch (they also need the scratch 16-byte aligned,
    which ``torch.empty`` is). Else the CUDA-core kernel runs."""
    return xp.dtype == torch.bfloat16 and wq.shape[1] % 8 == 0


def _fwd_q_scratch(xp, wq) -> torch.Tensor:
    """The scratch of both int8 kernels' C calls, f32: on the tensor-core
    path the rounded h rows ``[2,D,B,H]`` in bf16, then ``Qt = Q^T
    [D,3H,Hp]`` as bytes, rows padded to Hp = H rounded up to 64
    (``D*B*H + 3*D*H*Hp/4`` floats, 18.9 MB of Qt at ds2_full); none for
    the CUDA-core kernels."""
    d, bsz, h = wq.shape[0], xp.shape[1], wq.shape[1]
    hp = -(-h // 64) * 64
    floats = d * bsz * h + 3 * d * h * hp // 4 if _fwd_q_mma(xp, wq) else 0
    return torch.empty((floats,), dtype=torch.float32, device=xp.device)


def gru_fwd_q_stream(xp: torch.Tensor, mask: torch.Tensor,
                     wq: torch.Tensor, scale: torch.Tensor, b: torch.Tensor,
                     h0: Optional[torch.Tensor] = None,
                     reverse: Sequence[bool] = (False,)
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``gru_fwd_q`` through the streamed kernel ``csrc/gru_fwd_q_stream.cu``
    (K11), whatever the sizes: Q stays in global memory and the part of
    it a block does not hold crosses L2 as int8 once a step. Where
    ``_fwd_q_mma`` holds the C call transposes Q into the scratch and runs
    ``gru_fwd_q``'s tensor-core loop with a fixed share of Q^T resident,
    two launches; else one launch of the CUDA-core kernel. The same
    contract and arithmetic as ``gru_fwd_q``. A CPU tensor runs
    ``gru_fwd_q_plain``; a CUDA tensor calls the kernel's C entry point
    once (counted in ``gru_fwd_q_stream.launches``) or raises."""
    reverse = tuple(bool(r) for r in reverse)
    _check(xp, mask, wq, b, h0, reverse, scale)
    if xp.device.type == "cpu":
        return gru_fwd_q_plain(xp, mask, wq, scale, b, h0, reverse)
    _require_cuda(xp, "gru_fwd_q_stream")
    ys, hfin = _fwd_outputs(xp, wq, h0)
    if ys.numel():
        _launch("gru_fwd_q_stream", xp, mask, wq,
                (scale, b, h0, ys, hfin, _fwd_q_scratch(xp, wq)), reverse)
        _counted(gru_fwd_q_stream)
    return ys, hfin


gru_fwd_q_stream.launches = 0


def gru_bwd_plain(xp: torch.Tensor, mask: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor, ys: torch.Tensor, dy: torch.Tensor,
                  reverse: Sequence[bool] = (False,),
                  h0: Optional[torch.Tensor] = None,
                  return_dh0: bool = False):
    """The plain PyTorch version of ``gru_bwd``: an eager reverse time
    loop with ``_gru_bwd_elt``'s per-step math (rnn_pallas.py:189)."""
    t, bsz, _ = xp.shape
    d, h = w.shape[0], w.shape[1]
    dxp = torch.empty((d, t, bsz, 3 * h), dtype=torch.float32,
                      device=xp.device)
    dgates = torch.empty_like(dxp)
    dh0 = torch.zeros((d, bsz, h), dtype=torch.float32, device=xp.device)
    for di in range(d):
        w32 = w[di].float()
        dh = torch.zeros((bsz, h), dtype=torch.float32, device=xp.device)
        for i in range(t):
            row = i if reverse[di] else t - 1 - i
            if i == t - 1:  # the forward's first step
                h_prev = torch.zeros_like(dh) if h0 is None else h0[di]
            else:
                h_prev = ys[di, row + 1 if reverse[di] else row - 1]
            gates = h_prev.to(w.dtype).float() @ w32 + b[di]
            x = xp[row].float()
            g_n = gates[:, 2 * h:]
            r = torch.sigmoid(x[:, :h] + gates[:, :h])
            z = torch.sigmoid(x[:, h:2 * h] + gates[:, h:2 * h])
            n = torch.tanh(x[:, 2 * h:] + r * g_n)
            m = mask[row][:, None]
            dhc = dh + dy[di, row]
            dh_mid = m * dhc
            dn = dh_mid * (1.0 - z)
            dz = dh_mid * (h_prev - n)
            da_n = dn * (1.0 - n * n)
            dr = da_n * g_n
            dg_n = da_n * r
            da_z = dz * z * (1.0 - z)
            da_r = dr * r * (1.0 - r)
            dxp[di, row] = torch.cat([da_r, da_z, da_n], 1)
            dg = torch.cat([da_r, da_z, dg_n], 1)
            dgates[di, row] = dg
            dh = (dh_mid * z + (1.0 - m) * dhc
                  + dg.to(w.dtype).float() @ w32.t())
        dh0[di] = dh  # the first step's dh_prev
    return (dxp, dgates, dh0) if return_dh0 else (dxp, dgates)


def _check_bwd(xp, mask, w, b, reverse, gates: int = 3, h0=None,
               **tapes) -> None:
    """The backward kernels' argument rules: the forward's for ``gates``
    gates (with its ``h0``), and each of ``tapes`` (``ys``, ``dy``; the
    LSTM's ``cs``) contiguous f32 ``[D,T,B,H]`` on xp's device."""
    _check(xp, mask, w, b, h0, reverse, gates=gates)
    d, t, bsz, h = w.shape[0], xp.shape[0], xp.shape[1], w.shape[1]
    for name, x in tapes.items():
        if (tuple(x.shape) != (d, t, bsz, h) or x.dtype != torch.float32
                or x.device != xp.device or not x.is_contiguous()):
            raise ValueError(f"{name} must be contiguous f32 "
                             f"{[d, t, bsz, h]} on {xp.device}; got "
                             f"{x.dtype} {list(x.shape)} on {x.device}")


def _bwd_mma(w: torch.Tensor, ys: torch.Tensor,
             h0: Optional[torch.Tensor] = None) -> bool:
    """Whether the C call of a backward kernel runs its tensor-core path,
    the gate pre-pass GEMM and then the ``mma.sync`` loop: ``gru_bwd``
    (``csrc/gru_bwd.cu``), ``gru_bwd_stream`` (``csrc/gru_bwd_stream.cu``)
    and ``ops/lstm.py``'s ``lstm_bwd`` (``csrc/lstm_bwd.cu``) apply the
    same rule before any launch: ``gru_bwd_mma`` (bf16, H % 8 == 0) with
    ``w``, ``ys`` and the GRU's ``h0`` (when given) 16-byte aligned (they
    also need the scratch aligned, which ``torch.empty`` is). Else the
    CUDA-core kernel runs: K5/K7's ``gru_bwd_kernel``, K9's two-phase
    ``gru_bwd_stream_kernel``, K13's ``lstm_bwd_kernel``."""
    return (gru_bwd_mma(w.dtype, w.shape[1])
            and w.data_ptr() % 16 == 0 and ys.data_ptr() % 16 == 0
            and (h0 is None or h0.data_ptr() % 16 == 0))


def _bwd_resident(w: torch.Tensor, ys: torch.Tensor,
                  limits: Tuple[int, int, int] = (
                      H100_SMS, H100_SMEM_PER_BLOCK, H100_SMEM_PER_SM),
                  kind: str = "bwd",
                  h0: Optional[torch.Tensor] = None) -> bool:
    """Whether the backward of ``kind`` keeps W resident (``"bwd"``:
    ``gru_bwd``, K5/K7; ``"lstm_bwd"``: ``ops/lstm.py``'s ``lstm_bwd``,
    K13) on a card with these ``card_limits``, for the kernel
    ``_bwd_mma`` says its C call runs: ``resident_fits`` with ``w``'s
    dtype on the tensor-core path, and with f32 otherwise, since the
    CUDA-core kernel stages W as f32 whatever the dot dtype (a bf16 view
    of W that is not 16-byte aligned is sized as that kernel's block,
    which grows with B)."""
    dtype = w.dtype if _bwd_mma(w, ys, h0) else torch.float32
    return resident_fits(kind, w.shape[0], w.shape[1], ys.shape[2], dtype,
                         *limits)


def _bwd_launch(name, xp, mask, w, b, ys, dy, reverse, h0, return_dh0):
    """Allocate ``dxp``/``dgates`` (and ``dh0`` when ``return_dh0``) and
    ``csrc/<name>.cu``'s scratch and launch it; returns ``(dxp, dgates,
    dh0 or None, launched)``. ``gru_bwd``'s tensor-core path
    (``_bwd_mma``) takes ``gru_bwd_mma_scratch_floats`` (dh's elementwise
    part, the two bf16 dgates rows), its CUDA-core kernel
    ``gru_bwd_scratch_floats`` (the blocks' partial sums);
    ``gru_bwd_stream`` one size for both of its paths."""
    d, t, bsz, h = w.shape[0], xp.shape[0], xp.shape[1], w.shape[1]
    dxp = torch.empty((d, t, bsz, 3 * h), dtype=torch.float32,
                      device=xp.device)
    dgates = torch.empty_like(dxp)
    # With no step to run, h0 reaches nothing the loss reads.
    dh0 = ((torch.empty if dxp.numel() else torch.zeros)(
        (d, bsz, h), dtype=torch.float32, device=xp.device)
        if return_dh0 else None)
    if not dxp.numel():
        return dxp, dgates, dh0, False
    size = (f"{name}_mma_scratch_floats"
            if name == "gru_bwd" and _bwd_mma(w, ys, h0)
            else f"{name}_scratch_floats")
    floats = getattr(_lib(name), size)(d, bsz, h)
    scratch = torch.empty((floats,), dtype=torch.float32, device=xp.device)
    _launch(name, xp, mask, w, (b, h0, ys, dy, dxp, dgates, dh0, scratch),
            reverse)
    return dxp, dgates, dh0, True


def gru_bwd(xp: torch.Tensor, mask: torch.Tensor, w: torch.Tensor,
            b: torch.Tensor, ys: torch.Tensor, dy: torch.Tensor,
            reverse: Sequence[bool] = (False,),
            h0: Optional[torch.Tensor] = None, return_dh0: bool = False):
    """GRU backpropagation through time over D directions.

    ``xp``, ``mask``, ``w``, ``b``, ``h0`` and ``reverse`` as ``gru_fwd``
    took them (``h0 [D,B,H]`` f32, None: zeros); ``ys [D,T,B,H]`` f32, the
    outputs ``gru_fwd`` returned; ``dy [D,T,B,H]`` f32, the gradient of
    the loss with respect to them. Each direction runs against its
    forward order, carrying dh; a step recomputes the gates from h_prev
    (``h0`` at the forward's first step) rounded to ``w.dtype`` and adds
    ``round(dgates) @ W^T`` to dh in f32. Returns ``(dxp, dgates)``,
    each ``[D,T,B,3H]`` f32: ``dxp`` the gradient of the input
    projection ``(da_r, da_z, da_n)``, ``dgates`` that of the recurrent
    gates ``h W + b``, ``(da_r, da_z, dg_n)``; with ``return_dh0`` also
    ``dh0 [D,B,H]`` f32, the gradient of ``h0``: the first step's
    dh_prev, formed as every other step's. The gradient on the final
    state takes no argument: the carry after the last step is ``ys`` at
    the scan's last row (a masked frame holds h), so it arrives in ``dy``
    there. Without ``h0`` and ``return_dh0`` the call is the BPTT from
    h0 = 0, bit for bit.

    A CPU tensor runs ``gru_bwd_plain``. A CUDA tensor calls the
    resident kernel's C entry point ``csrc/gru_bwd.cu`` once (counted in
    ``gru_bwd.launches``) where ``_bwd_resident`` says it can hold W,
    and ``gru_bwd_stream`` otherwise; a refused launch raises. Where
    ``_bwd_mma`` holds (bf16, H % 8 == 0) that call is two launches, the
    gate pre-pass GEMM on the tensor cores and the serial ``mma.sync``
    loop with each group's rows of W held in shared memory
    (``csrc/gru_bwd_mma.cuh``); f32 and other bf16 calls run the
    CUDA-core kernel.
    """
    reverse = tuple(bool(r) for r in reverse)
    _check_bwd(xp, mask, w, b, reverse, h0=h0, ys=ys, dy=dy)
    if xp.device.type == "cpu":
        return gru_bwd_plain(xp, mask, w, b, ys, dy, reverse, h0, return_dh0)
    _require_cuda(xp, "gru_bwd")
    if not _bwd_resident(w, ys, card_limits(xp.device), h0=h0):
        return gru_bwd_stream(xp, mask, w, b, ys, dy, reverse, h0, return_dh0)
    dxp, dgates, dh0, launched = _bwd_launch("gru_bwd", xp, mask, w, b, ys,
                                             dy, reverse, h0, return_dh0)
    gru_bwd.launches += launched
    return (dxp, dgates, dh0) if return_dh0 else (dxp, dgates)


gru_bwd.launches = 0


def _bwd_stream_scratch_floats(d: int, bsz: int, h: int) -> int:
    """``gru_bwd_stream_scratch_floats``: the f32 scratch either path of
    ``csrc/gru_bwd_stream.cu`` takes, ``8*D*B*H``. The two-phase kernel
    keeps dh and its elementwise part ``[2,D,B,H]`` f32, then two
    ``round(dgates)`` rows ``[2,D,B,3H]`` in the dot dtype (f32 room);
    the tensor-core loop keeps the elementwise part in the first
    ``D*B*H`` and its two bf16 rows right after it, as
    ``gru_bwd_mma_scratch_floats`` lays out K5/K7's."""
    return 8 * d * bsz * h


def gru_bwd_stream(xp: torch.Tensor, mask: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor, ys: torch.Tensor, dy: torch.Tensor,
                   reverse: Sequence[bool] = (False,),
                   h0: Optional[torch.Tensor] = None,
                   return_dh0: bool = False):
    """``gru_bwd`` through the streamed kernel ``csrc/gru_bwd_stream.cu``
    (K9), whatever the sizes. Where ``_bwd_mma`` holds (bf16,
    H % 8 == 0) the gate recompute, which reads h_prev from the ``ys``
    tape and not from the carried dh, runs first for every step at once
    as a tensor-core GEMM written into ``dgates``; then a serial kernel
    streams W's rows once a step to form ``round(dgates) @ W^T`` on the
    tensor cores (part of W held in shared memory for the call), one grid
    barrier a step, and overwrites each step's gates with its ``dgates``.
    f32 and other bf16 calls run the two-phase CUDA-core kernel, a
    column and a row phase a step (see the source). The same contract and
    arithmetic as ``gru_bwd``. A CPU tensor runs ``gru_bwd_plain``; a
    CUDA tensor calls the kernel's C entry point once (counted in
    ``gru_bwd_stream.launches``) or raises."""
    reverse = tuple(bool(r) for r in reverse)
    _check_bwd(xp, mask, w, b, reverse, h0=h0, ys=ys, dy=dy)
    if xp.device.type == "cpu":
        return gru_bwd_plain(xp, mask, w, b, ys, dy, reverse, h0, return_dh0)
    _require_cuda(xp, "gru_bwd_stream")
    dxp, dgates, dh0, launched = _bwd_launch("gru_bwd_stream", xp, mask, w,
                                             b, ys, dy, reverse, h0,
                                             return_dh0)
    gru_bwd_stream.launches += launched
    return (dxp, dgates, dh0) if return_dh0 else (dxp, dgates)


gru_bwd_stream.launches = 0


def _h_prev(ys: torch.Tensor, reverse: Tuple[bool, ...],
            h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[D,T,B,H]`` h_prev of every row in data order: ys shifted one
    step against each direction's scan, ``h0`` (None: 0) at the scan's
    first row."""
    first = [torch.zeros_like(ys[0, :1]) if h0 is None else h0[di][None]
             for di in range(len(reverse))]
    return torch.stack([
        torch.cat([ys[di, 1:], first[di]]) if rev
        else torch.cat([first[di], ys[di, :-1]])
        for di, rev in enumerate(reverse)])


class GRUFunction(torch.autograd.Function):
    """``gru_fwd`` with ``gru_bwd`` as its backward.

    ``apply(xp [T,B,3H], mask [T,B], w [D,H,3H] f32, b [D,3H] f32, h0,
    reverse)`` -> ``ys [D,T,B,H]`` f32. ``w`` is rounded to ``xp.dtype``
    (the dot dtype) inside, so its gradient stays f32, as the JAX
    kernels cast the f32 weights inside. The backward returns ``dxp``
    summed over directions (``xp.dtype``), ``dW = sum_t h_prev^T dgates``
    as one f32 product with TF32 off, and ``db = sum dgates``. ``h0
    [D,B,H]`` f32 (None: zeros) is the carried state the scan starts
    from, as in the sequence-parallel relay; its gradient ``dh0`` is
    ``gru_bwd``'s, and dW's first row takes h0 as its h_prev. The
    gradient on the final carry reaches the backward through ``ys``:
    the carry is ``ys`` at the scan's last row. Without ``h0`` the
    backward makes the call it made before h0 had a gradient, bit for
    bit.
    """

    @staticmethod
    def forward(ctx, xp, mask, w, b, h0, reverse):
        reverse = tuple(bool(r) for r in reverse)
        wd = w.to(xp.dtype).contiguous()
        ys, _ = gru_fwd(xp, mask, wd, b, h0, reverse)
        ctx.save_for_backward(xp, mask, wd, b, h0, ys)
        ctx.reverse = reverse
        return ys

    @staticmethod
    def backward(ctx, dys):
        xp, mask, wd, b, h0, ys = ctx.saved_tensors
        dys = dys.float().contiguous()
        dh0 = None
        if h0 is None:
            dxp, dgates = gru_bwd(xp, mask, wd, b, ys, dys, ctx.reverse)
        else:
            dxp, dgates, dh0 = gru_bwd(xp, mask, wd, b, ys, dys, ctx.reverse,
                                       h0=h0, return_dh0=True)
        d, t, bsz, h = ys.shape
        hp = _h_prev(ys, ctx.reverse, h0).reshape(d, t * bsz, h)
        with full_f32_matmul():
            dw = torch.bmm(hp.transpose(1, 2),
                           dgates.reshape(d, t * bsz, 3 * h))
        db = dgates.sum((1, 2))
        return dxp.sum(0).to(xp.dtype), None, dw, db, dh0, None
