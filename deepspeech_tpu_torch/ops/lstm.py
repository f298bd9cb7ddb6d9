"""The LSTM recurrence and its backward: hand-written Hopper kernels and
their plain PyTorch versions.

Gates i, f, g, o (``deepspeech_tpu/ops/lstm_pallas.py``'s order and
arithmetic, ``_lstm_elementwise_fwd`` :41):
  gates = h_prev W + b           (h_prev rounded to the dot dtype, f32 sum)
  i = sigmoid(xp_i + gates_i)    f = sigmoid(xp_f + gates_f + 1)
  g = tanh(xp_g + gates_g)       o = sigmoid(xp_o + gates_o)
  c' = f c + i g                 h' = o tanh(c')
A masked frame holds both h and c. Each direction starts from h = c = 0
(the TPU kernels take no carried state) or, in ``lstm_fwd`` and
``lstm_fwd_stream`` (K12, K14), from a carried ``hc0 = (h0, c0)``, and
can return its final ``(h, c)``: the sequence-parallel relay
(``parallel/seqpar.py``) runs each shard's chunk from the carry the shard
before it handed over, as the JAX relay runs ``lstm_scan(..., hc0,
return_final=True)`` (seqpar.py:192-244); a reverse direction runs
t = T-1..0. The backward (K13, K15) takes the same carry and the
gradient on the final cell state ``dcfin`` and returns ``(dh0, dc0)``,
which the relay's backward hands to the shard before.

``lstm_fwd`` replaces ``_lstm_kernel`` (lstm_pallas.py:89, K12; W held
on chip, the cell-state tape ``cs`` written only when asked) with
``csrc/lstm_fwd.cu``: one C call for D directions (the JAX model
launches one kernel per direction, models/rnn.py:242-251; summed, the
two compute the same function), a cooperative grid of groups of hidden
units (gate columns j, H+j, 2H+j, 3H+j), each holding its slice of W in
shared memory for the call, a grid barrier per step. In bf16 with H a
multiple of 8 (``_fwd_mma``) it transposes W into its scratch once a
call and runs the serial loop on the tensor cores (``mma.sync``, each
group's rows of W^T resident, c in the scratch, touched only by its
owning thread; ``csrc/lstm_fwd_mma.cuh``); f32 and other H run D x
ceil(H/16) blocks on the CUDA cores, each holding the ``[H, 64]`` f32
column slice of W for 16 units and their cell state. Where W does not
fit (``gru.resident_fits("lstm_fwd", ...)``; ds2_full's H=1760), it
launches ``lstm_fwd_stream`` (``csrc/lstm_fwd_stream.cu``, replacing
``_lstm_kernel_blocked``, :116, K14), which streams W from global
memory every step and keeps c in a scratch row. In bf16 with H a
multiple of 8 that is the same header's loop with part of each group's
W^T held in shared memory for the call and the rest streamed once a
step; f32 and other H stage W through shared memory as f32 for the
CUDA cores.

``lstm_fwd_q`` is the forward with weight-only int8 recurrent weights
(``utils/quantize.py``'s layout: int8 ``Q [H,4H]``, an f32 scale per
output channel): ``(round(h) @ Q) * scale + b``. It launches
``csrc/lstm_fwd_q.cu`` (replacing ``_lstm_kernel_q``, :292, K16). With
bf16 dots and H a multiple of 8 (``_fwd_q_mma``) that is K12's two
launches on Q: ``bf16(Q^T)`` written into its scratch once a call (exact:
every int8 value is a bf16 value), then K12's ``mma.sync`` loop with
each group's rows of it resident and the scale applied to the finished
sums; f32 and other H hold the slice as int8 and widen it 64 rows at a
time beside the h_prev chunk for the CUDA cores. Where the resident
kernel does not fit (ds2_full's H=1760; in bf16 H above 1056 at D=2 and
1216 at D=1), or when the caller forces it, ``lstm_fwd_q`` launches
``lstm_fwd_q_stream`` (``csrc/lstm_fwd_q_stream.cu``, replacing
``_lstm_kernel_blocked_q``, :315, K17). In bf16 with H a multiple of 8
(``_fwd_q_stream_mma``) that is K14's tensor-core loop with s8 weights:
Q^T written into its scratch once a call, its s8 pieces streamed (part
held in shared memory) and widened to bf16 in registers for
``mma.sync``; f32 and other H stage Q through shared memory as f32 for
the CUDA cores. Neither int8 kernel writes a tape: the TPU kernels have
none.

``lstm_bwd`` is the BPTT, with the gates recomputed from the stored
outputs and the cell-state tape: ``csrc/lstm_bwd.cu`` (replacing
``_lstm_bwd_kernel``, :147, K13), or where ``gru.resident_fits(
"lstm_bwd", ...)`` says no, ``lstm_bwd_stream`` (``csrc/
lstm_bwd_stream.cu``, replacing ``_lstm_bwd_kernel_blocked``, :174,
K15). In bf16 both run ``csrc/lstm_bwd_mma.cuh``: a tensor-core GEMM
recomputes every step's gates first, then a serial loop runs
``round(dgates) @ W^T`` on the tensor cores, K13 with each group's rows
of W held in shared memory for the call, K15 with W streamed once a
step. In f32 both run on the CUDA cores: K13 K12's tile, with
``csrc/gru_bwd.cu``'s dgates @ W^T partial sums added in block order
after the barrier, K15 two phases a step. ``LSTMFunction`` wraps
``lstm_fwd(..., tape=True)`` and ``lstm_bwd`` for autograd, with an
optional carry ``(h0, c0)`` in and the final cell state out, and forms
dW and db outside the kernel by one f32 product, as ``_lstm_bwd`` does
(:492-503).

What bounds them on the H100 is what bounds the GRU kernels
(``ops/gru.py``): T serial steps of a fixed latency, far above the FLOP
roofline (2*T*D*B*H*4H over the peak, twice that for the backward) and
the byte roofline.

On a CPU tensor a wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises. There is no fallback between the two,
nor between the resident and the streamed kernel. Each kernel counts
its own launches.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import torch

from . import gru
from .precision import full_f32_matmul

_Out = Union[torch.Tensor, Tuple[torch.Tensor, ...]]
_HC = Optional[Tuple[torch.Tensor, torch.Tensor]]


def _acc(x: torch.Tensor) -> torch.dtype:
    """The plain versions' arithmetic dtype: f32 for the kernels' dtypes
    (bf16, f32), f64 for f64 inputs (a CPU gradient check; the wrappers
    refuse f64)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def lstm_plain_loop(xp: torch.Tensor, mask: torch.Tensor,
                    reverse: Sequence[bool], h: int,
                    gates: Callable[[int, torch.Tensor], torch.Tensor],
                    hc0: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    tape: bool = False):
    """The LSTM recurrence as an eager time loop over ``len(reverse)``
    directions; ``gates(di, hc)`` gives direction ``di``'s recurrent
    gates ``h W + b`` ``[B,4H]`` f32 from the f32 carry. ``hc0`` is
    ``(h0, c0)``, each ``[D,B,H]`` (zeros when None). Returns ``(ys,
    cs, hfin, cfin)``: ``ys [D,T,B,H]`` f32, ``cs`` the same shape when
    ``tape`` (else None), the carries after the last step ``[D,B,H]``
    (f64 throughout for f64 inputs, ``_acc``)."""
    t, bsz, _ = xp.shape
    d = len(reverse)
    acc = _acc(xp)
    f32 = dict(dtype=acc, device=xp.device)
    ys = torch.empty((d, t, bsz, h), **f32)
    cs = torch.empty((d, t, bsz, h), **f32) if tape else None
    hfin = torch.empty((d, bsz, h), **f32)
    cfin = torch.empty((d, bsz, h), **f32)
    for di in range(d):
        if hc0 is None:
            hc = torch.zeros((bsz, h), **f32)
            cc = torch.zeros((bsz, h), **f32)
        else:
            hc, cc = hc0[0][di].to(acc), hc0[1][di].to(acc)
        for s in range(t):
            row = t - 1 - s if reverse[di] else s
            g = gates(di, hc)
            x = xp[row].to(acc)
            i = torch.sigmoid(x[:, :h] + g[:, :h])
            f = torch.sigmoid(x[:, h:2 * h] + g[:, h:2 * h] + 1.0)
            gg = torch.tanh(x[:, 2 * h:3 * h] + g[:, 2 * h:3 * h])
            o = torch.sigmoid(x[:, 3 * h:] + g[:, 3 * h:])
            cnew = f * cc + i * gg
            hnew = o * torch.tanh(cnew)
            m = mask[row][:, None]
            hc = m * hnew + (1.0 - m) * hc
            cc = m * cnew + (1.0 - m) * cc
            ys[di, row] = hc
            if tape:
                cs[di, row] = cc
        hfin[di], cfin[di] = hc, cc
    return ys, cs, hfin, cfin


def _result(ys, cs, tape: bool, fin=None) -> _Out:
    """``lstm_fwd``'s return: ``ys``, then ``cs`` with the tape, then the
    final ``(h, c)`` when ``fin`` is given."""
    out = (ys, cs) if tape else (ys,)
    if fin is not None:
        out += (fin,)
    return out if len(out) > 1 else ys


def lstm_fwd_plain(xp: torch.Tensor, mask: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor, reverse: Sequence[bool] = (False,),
                   tape: bool = False, *, hc0: _HC = None,
                   return_final: bool = False) -> _Out:
    """The plain PyTorch version of ``lstm_fwd``: an eager time loop with
    the same arithmetic (h_prev rounded to ``w.dtype`` for the product,
    the product, c and h in f32), from ``hc0`` (zeros when None)."""
    acc = _acc(xp)
    w32 = w.to(acc)
    ys, cs, hfin, cfin = lstm_plain_loop(
        xp, mask, reverse, w.shape[1],
        lambda di, hc: hc.to(w.dtype).to(acc) @ w32[di] + b[di], hc0=hc0,
        tape=tape)
    return _result(ys, cs, tape, (hfin, cfin) if return_final else None)


def lstm_fwd_q_plain(xp: torch.Tensor, mask: torch.Tensor,
                     wq: torch.Tensor, scale: torch.Tensor, b: torch.Tensor,
                     reverse: Sequence[bool] = (False,)) -> torch.Tensor:
    """The plain PyTorch version of ``lstm_fwd_q``: ``lstm_fwd_plain``'s
    loop with the gates ``(round(h) @ Q) * scale + b``, h rounded to the
    dot dtype ``xp.dtype`` (int8 widens to bf16 and f32 exactly), the
    product in f32 and the scale on the finished column sums, as
    ``_lstm_kernel_q`` computes them (lstm_pallas.py:305-307)."""
    q32 = wq.float()
    ys, _, _, _ = lstm_plain_loop(
        xp, mask, reverse, wq.shape[1],
        lambda di, hc: (hc.to(xp.dtype).float() @ q32[di]) * scale[di]
        + b[di])
    return ys


def _outputs(xp, w, tape: bool):
    """Empty ``ys`` and (with ``tape``) ``cs``, ``[D,T,B,H]`` f32."""
    t, bsz, _ = xp.shape
    shape = (w.shape[0], t, bsz, w.shape[1])
    ys = torch.empty(shape, dtype=torch.float32, device=xp.device)
    cs = torch.empty_like(ys) if tape else None
    return ys, cs


def _check_hc0(xp, w, hc0: _HC, dcfin: Optional[torch.Tensor] = None
               ) -> None:
    """``hc0``: None, or ``(h0, c0)``, each f32 ``[D,B,H]``, contiguous,
    on xp's device (the rule ``gru._check`` holds the GRU's h0 to); the
    backward's ``dcfin`` (None, or a tensor) to the same rule."""
    named = [] if dcfin is None else [("dcfin", dcfin)]
    if hc0 is not None:
        if len(hc0) != 2 or any(x is None for x in hc0):
            raise ValueError("hc0 must be None or a pair (h0, c0) of "
                             "tensors")
        named = [("h0", hc0[0]), ("c0", hc0[1])] + named
    shape = (w.shape[0], xp.shape[1], w.shape[1])
    for name, x in named:
        if tuple(x.shape) != shape or x.dtype != torch.float32:
            raise ValueError(f"{name} must be f32 {list(shape)}; got "
                             f"{x.dtype} {list(x.shape)}")
        if x.device != xp.device:
            raise ValueError(f"{name} is on {x.device}, xp on {xp.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _fwd_launch(name: str, fn, xp, mask, w, b, reverse, tape: bool,
                hc0: _HC, return_final: bool, scratch) -> _Out:
    """Launch ``csrc/<name>.cu`` (K12 or K14) and count it in
    ``fn.launches`` (the wrapper's module-level name, which a test or a
    script may patch). ``<name>_launch`` takes ``(h0, c0)`` and the
    buffers of the final ``(h, c)``, which the kernel's last step writes;
    each may be NULL (a carry of zeros, no final state). With no step or
    no row to run, the final state is the carry in."""
    ys, cs = _outputs(xp, w, tape)
    fin = None
    if return_final:
        fin = tuple(torch.empty((w.shape[0], xp.shape[1], w.shape[1]),
                                dtype=torch.float32, device=xp.device)
                    for _ in range(2))
        if not ys.numel():
            for f, x in zip(fin, hc0 or (None, None)):
                f.copy_(x if x is not None else torch.zeros_like(f))
    if ys.numel():
        h0, c0 = hc0 if hc0 is not None else (None, None)
        hfin, cfin = fin if fin is not None else (None, None)
        gru._launch(name, xp, mask, w,
                    (b, h0, c0, ys, cs, hfin, cfin, scratch), reverse)
        gru._counted(fn)
    return _result(ys, cs, tape, fin)


def _fwd_mma(w: torch.Tensor) -> bool:
    """Whether the C call of ``lstm_fwd`` or ``lstm_fwd_stream`` runs its
    tensor-core path (csrc/lstm_fwd_mma.cuh's transpose and loop):
    ``gru.lstm_fwd_mma`` (bf16 with H a multiple of 8: a 16-byte piece
    of a row holds 8 values), the rule ``lstm_fwd_launch`` and
    ``lstm_fwd_stream_launch`` apply before any launch (they also need
    the scratch 16-byte aligned, which ``torch.empty`` is). Else the
    CUDA-core kernel runs."""
    return gru.lstm_fwd_mma(w.dtype, w.shape[1])


def _fwd_scratch(xp, w) -> torch.Tensor:
    """``lstm_fwd``'s scratch, f32: on the tensor-core path the cell
    state ``[D,B,H]`` in f32, then the rounded h rows ``[2,D,B,H]`` and
    ``Wt = W^T [D,4H,H]``, both in bf16 (``2*D*B*H + 2*D*H*H`` floats);
    none for the CUDA-core kernel, which keeps c in shared memory."""
    d, bsz, h = w.shape[0], xp.shape[1], w.shape[1]
    floats = 2 * d * bsz * h + 2 * d * h * h if _fwd_mma(w) else 0
    return torch.empty((floats,), dtype=torch.float32, device=xp.device)


def _fwd_stream_scratch(xp, w) -> torch.Tensor:
    """``lstm_fwd_stream``'s scratch, f32: on the tensor-core path
    ``_fwd_scratch``'s layout; its CUDA-core kernel keeps the cell state
    ``[D,B,H]`` there alone."""
    if _fwd_mma(w):
        return _fwd_scratch(xp, w)
    d, bsz, h = w.shape[0], xp.shape[1], w.shape[1]
    return torch.empty((d * bsz * h,), dtype=torch.float32, device=xp.device)


def _fwd_q_mma(xp: torch.Tensor, wq: torch.Tensor) -> bool:
    """Whether ``lstm_fwd_q``'s C call runs its tensor-core path
    (csrc/lstm_fwd_mma.cuh's widening transpose and loop): the rule of
    ``gru.lstm_fwd_mma`` on the dot dtype ``xp.dtype`` (``wq`` is always
    int8), bf16 with H a multiple of 8, which ``lstm_fwd_q_launch``
    applies before any launch (it also needs the scratch 16-byte
    aligned, which ``torch.empty`` is). Else the CUDA-core kernel
    runs."""
    return gru.lstm_fwd_mma(xp.dtype, wq.shape[1])


def _fwd_q_scratch(xp, wq) -> torch.Tensor:
    """``lstm_fwd_q``'s scratch, f32: on the tensor-core path
    ``_fwd_scratch``'s layout, the cell state ``[D,B,H]`` in f32, then
    the rounded h rows ``[2,D,B,H]`` and ``Wt = bf16(Q^T) [D,4H,H]``,
    both in bf16 (``2*D*B*H + 2*D*H*H`` floats, 10.24 MB of Wt at D=2,
    H=800); none for the CUDA-core kernel."""
    d, bsz, h = wq.shape[0], xp.shape[1], wq.shape[1]
    floats = 2 * d * bsz * h + 2 * d * h * h if _fwd_q_mma(xp, wq) else 0
    return torch.empty((floats,), dtype=torch.float32, device=xp.device)


def _fwd_q_stream_mma(xp: torch.Tensor, wq: torch.Tensor) -> bool:
    """Whether ``lstm_fwd_q_stream``'s C call runs its tensor-core path:
    a bf16 dot dtype (``xp``'s; ``wq`` is always int8) with H a multiple
    of 8 (a 16-byte piece of an h row holds 8 values; the rows of Q^T
    are padded to a multiple of 64), the rule ``lstm_fwd_q_stream_launch``
    applies before any launch (it also needs the scratch 16-byte
    aligned, which ``torch.empty`` is). Else the CUDA-core kernel
    runs."""
    return xp.dtype == torch.bfloat16 and wq.shape[1] % 8 == 0


def _fwd_q_stream_scratch(xp, wq) -> torch.Tensor:
    """``lstm_fwd_q_stream``'s scratch, f32: the cell state ``[D,B,H]``
    (each entry read and written by the one thread that owns its unit
    and row) and, on the tensor-core path, the rounded h rows
    ``[2,D,B,H]`` bf16 and ``Qt = Q^T [D,4H,Hp]`` int8, its rows padded
    to ``Hp``, H rounded up to 64 (``D*B*H + D*H*Hp`` floats)."""
    d, bsz, h = wq.shape[0], xp.shape[1], wq.shape[1]
    floats = d * bsz * h
    if _fwd_q_stream_mma(xp, wq):
        floats += d * bsz * h + d * h * (-(-h // 64) * 64)
    return torch.empty((floats,), dtype=torch.float32, device=xp.device)


def lstm_fwd(xp: torch.Tensor, mask: torch.Tensor, w: torch.Tensor,
             b: torch.Tensor, reverse: Sequence[bool] = (False,),
             tape: bool = False, *, hc0: _HC = None,
             return_final: bool = False) -> _Out:
    """LSTM forward over D directions that share one input projection.

    ``xp [T,B,4H]`` (includes the input bias) and ``w [D,H,4H]`` in one
    dtype, bf16|f32, the dot dtype; ``mask [T,B]`` f32 (1 = valid),
    ``b [D,4H]`` f32 recurrent bias, ``reverse[d]`` True for a direction
    that runs t = T-1..0. Returns ``ys [D,T,B,H]`` f32 (a masked frame
    holds the previous h), and with ``tape`` also ``cs [D,T,B,H]`` f32,
    the cell state of every row (held on masked frames), which
    ``lstm_bwd`` reads. The product rounds h_prev to ``w.dtype`` and
    sums in f32; c and h stay f32. ``hc0 = (h0, c0)``, each ``[D,B,H]``
    f32, seeds each direction's carry (zeros when None; a reverse
    direction takes it at t = T-1); with ``return_final`` the result ends
    with the carry after the last step, ``(h, c)`` each ``[D,B,H]`` f32:
    ``(ys, (h, c))``, or ``(ys, cs, (h, c))`` with the tape.

    A CPU tensor runs ``lstm_fwd_plain``. A CUDA tensor calls the
    resident kernel's C entry point ``csrc/lstm_fwd.cu`` once (counted
    in ``lstm_fwd.launches``) where ``gru.resident_fits("lstm_fwd",
    ...)`` says it can hold W, and ``lstm_fwd_stream`` otherwise; a
    refused launch raises. Where ``_fwd_mma`` holds (bf16, H % 8 == 0)
    that call is two launches, W^T written into the scratch, then the
    serial ``mma.sync`` loop with each group's rows of W^T held in shared
    memory (``csrc/lstm_fwd_mma.cuh``); f32 and other bf16 calls run the
    CUDA-core kernel.
    """
    reverse = tuple(bool(r) for r in reverse)
    gru._check(xp, mask, w, b, None, reverse, gates=4)
    _check_hc0(xp, w, hc0)
    if xp.device.type == "cpu":
        return lstm_fwd_plain(xp, mask, w, b, reverse, tape, hc0=hc0,
                              return_final=return_final)
    gru._require_cuda(xp, "lstm_fwd")
    if not gru.resident_fits("lstm_fwd", w.shape[0], w.shape[1],
                             xp.shape[1], w.dtype,
                             *gru.card_limits(xp.device)):
        return lstm_fwd_stream(xp, mask, w, b, reverse, tape, hc0=hc0,
                               return_final=return_final)
    return _fwd_launch("lstm_fwd", lstm_fwd, xp, mask, w, b, reverse, tape,
                       hc0, return_final, _fwd_scratch(xp, w))


lstm_fwd.launches = 0


def lstm_fwd_stream(xp: torch.Tensor, mask: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor, reverse: Sequence[bool] = (False,),
                    tape: bool = False, *, hc0: _HC = None,
                    return_final: bool = False) -> _Out:
    """``lstm_fwd`` through the streamed kernel ``csrc/lstm_fwd_stream.cu``
    (K14), whatever the sizes: W stays in global memory and crosses L2
    once a step. Where ``_fwd_mma`` holds (bf16, H % 8 == 0) the
    C call transposes W into the scratch and runs the serial loop on the
    tensor cores, two launches, with part of W^T held in shared memory
    for the call; else one launch of the CUDA-core kernel (see the
    source). The same contract and arithmetic as ``lstm_fwd``, carry
    included. A CPU tensor runs ``lstm_fwd_plain``; a CUDA tensor calls
    the kernel's C entry point once (counted in
    ``lstm_fwd_stream.launches``) or raises."""
    reverse = tuple(bool(r) for r in reverse)
    gru._check(xp, mask, w, b, None, reverse, gates=4)
    _check_hc0(xp, w, hc0)
    if xp.device.type == "cpu":
        return lstm_fwd_plain(xp, mask, w, b, reverse, tape, hc0=hc0,
                              return_final=return_final)
    gru._require_cuda(xp, "lstm_fwd_stream")
    return _fwd_launch("lstm_fwd_stream", lstm_fwd_stream, xp, mask, w, b,
                       reverse, tape, hc0, return_final,
                       _fwd_stream_scratch(xp, w))


lstm_fwd_stream.launches = 0


def lstm_fwd_q(xp: torch.Tensor, mask: torch.Tensor, wq: torch.Tensor,
               scale: torch.Tensor, b: torch.Tensor,
               reverse: Sequence[bool] = (False,),
               blocked: Optional[bool] = None) -> torch.Tensor:
    """LSTM forward over D directions with weight-only int8 recurrent
    weights, for inference (no gradient, no tape).

    ``xp [T,B,4H]`` bf16|f32 (the dot dtype; includes the input bias),
    ``mask [T,B]`` f32, ``wq [D,H,4H]`` int8 and ``scale [D,4H]`` f32
    (one per output channel, ``utils/quantize.py``'s layout), ``b [D,4H]``
    f32, ``reverse`` as ``lstm_fwd`` takes them. Returns ``ys [D,T,B,H]``
    f32. The gates are ``(round(h) @ Q) * scale + b``: h_prev rounded to
    the dot dtype, the sum in f32, the scale applied to the finished
    column sums; then ``lstm_fwd``'s update.

    A CPU tensor runs ``lstm_fwd_q_plain``. A CUDA tensor calls the
    resident kernel's C entry point ``csrc/lstm_fwd_q.cu`` once (counted
    in ``lstm_fwd_q.launches``) where ``gru.resident_fits("lstm_fwd_q",
    ...)`` holds on this card, and ``lstm_fwd_q_stream`` otherwise.
    Where ``_fwd_q_mma`` holds (bf16 dots, H % 8 == 0) that call is two
    launches, ``bf16(Q^T)`` written into the scratch, then K12's serial
    ``mma.sync`` loop with each group's rows of it held in shared memory
    and the scale on the finished sums (``csrc/lstm_fwd_mma.cuh``); f32
    and other bf16 calls run the CUDA-core kernel. ``blocked`` forces
    the choice, as ``lstm_scan_pallas_q``'s does (lstm_pallas.py:350):
    True the streamed kernel, False the resident one, which raises where
    it does not fit (judged on an H100's limits for a CPU tensor). A
    refused launch raises.
    """
    reverse = tuple(bool(r) for r in reverse)
    gru._check(xp, mask, wq, b, None, reverse, scale, gates=4)
    if xp.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lstm_fwd_q runs on cpu or cuda, not {xp.device}")
    d, h, bsz = wq.shape[0], wq.shape[1], xp.shape[1]
    card = gru.card_limits(xp.device) if xp.device.type == "cuda" else ()
    fits = gru.resident_fits("lstm_fwd_q", d, h, bsz, xp.dtype, *card)
    if blocked is False and not fits:
        raise ValueError(
            f"lstm_fwd_q forced resident (blocked=False), but D={d} x H={h} "
            f"does not fit the resident kernel's shared memory and SMs")
    if xp.device.type == "cpu":
        return lstm_fwd_q_plain(xp, mask, wq, scale, b, reverse)
    if (not fits) if blocked is None else blocked:
        return lstm_fwd_q_stream(xp, mask, wq, scale, b, reverse)
    ys, _ = _outputs(xp, wq, False)
    if ys.numel():
        gru._launch("lstm_fwd_q", xp, mask, wq,
                    (scale, b, ys, _fwd_q_scratch(xp, wq)), reverse)
        gru._counted(lstm_fwd_q)
    return ys


lstm_fwd_q.launches = 0


def lstm_fwd_q_stream(xp: torch.Tensor, mask: torch.Tensor,
                      wq: torch.Tensor, scale: torch.Tensor, b: torch.Tensor,
                      reverse: Sequence[bool] = (False,)) -> torch.Tensor:
    """``lstm_fwd_q`` through the streamed kernel
    ``csrc/lstm_fwd_q_stream.cu`` (K17), whatever the sizes: Q stays in
    global memory and crosses L2 as int8 once a step. Where
    ``_fwd_q_stream_mma`` holds (bf16 ``xp``, H % 8 == 0) the C call
    transposes Q into the scratch and runs the serial loop on the tensor
    cores, two launches, with part of Q^T held in shared memory for the
    call and every s8 piece widened to bf16 in registers; else one launch
    of the CUDA-core kernel (see the source). The same contract and
    arithmetic as ``lstm_fwd_q``. A CPU tensor runs ``lstm_fwd_q_plain``;
    a CUDA tensor calls the kernel's C entry point once (counted in
    ``lstm_fwd_q_stream.launches``) or raises."""
    reverse = tuple(bool(r) for r in reverse)
    gru._check(xp, mask, wq, b, None, reverse, scale, gates=4)
    if xp.device.type == "cpu":
        return lstm_fwd_q_plain(xp, mask, wq, scale, b, reverse)
    gru._require_cuda(xp, "lstm_fwd_q_stream")
    ys, _ = _outputs(xp, wq, False)
    if ys.numel():
        gru._launch("lstm_fwd_q_stream", xp, mask, wq,
                    (scale, b, ys, _fwd_q_stream_scratch(xp, wq)), reverse)
        gru._counted(lstm_fwd_q_stream)
    return ys


lstm_fwd_q_stream.launches = 0


def lstm_bwd_plain(xp: torch.Tensor, mask: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor, ys: torch.Tensor, cs: torch.Tensor,
                   dy: torch.Tensor, reverse: Sequence[bool] = (False,), *,
                   hc0: _HC = None, dcfin: Optional[torch.Tensor] = None,
                   return_dhc0: bool = False):
    """The plain PyTorch version of ``lstm_bwd``: an eager reverse time
    loop with ``_lstm_elementwise_bwd``'s per-step math
    (lstm_pallas.py:54), h_prev rounded to ``w.dtype`` for the gate
    recompute and ``round(dgates)`` in ``w.dtype`` into ``@ W^T``, the
    rest in f32; from ``hc0`` at the forward's first step and ``dcfin``
    on the final cell state (zeros when None), with ``(dh0, dc0)`` after
    the first step when ``return_dhc0``."""
    t, bsz, _ = xp.shape
    d, h = w.shape[0], w.shape[1]
    acc = _acc(xp)
    f32 = dict(dtype=acc, device=xp.device)
    dgates = torch.empty((d, t, bsz, 4 * h), **f32)
    dh0 = torch.empty((d, bsz, h), **f32)
    dc0 = torch.empty((d, bsz, h), **f32)
    for di in range(d):
        w32 = w[di].to(acc)
        dh = torch.zeros((bsz, h), **f32)
        dc = (torch.zeros((bsz, h), **f32) if dcfin is None
              else dcfin[di].clone())
        for i in range(t):
            row = i if reverse[di] else t - 1 - i
            if i == t - 1:  # the forward's first step
                if hc0 is None:
                    h_prev = c_prev = torch.zeros_like(dh)
                else:
                    h_prev, c_prev = hc0[0][di], hc0[1][di]
            else:
                prev = row + 1 if reverse[di] else row - 1
                h_prev, c_prev = ys[di, prev], cs[di, prev]
            g = h_prev.to(w.dtype).to(acc) @ w32 + b[di]
            x = xp[row].to(acc)
            ig = torch.sigmoid(x[:, :h] + g[:, :h])
            fg = torch.sigmoid(x[:, h:2 * h] + g[:, h:2 * h] + 1.0)
            gg = torch.tanh(x[:, 2 * h:3 * h] + g[:, 2 * h:3 * h])
            og = torch.sigmoid(x[:, 3 * h:] + g[:, 3 * h:])
            tc = torch.tanh(fg * c_prev + ig * gg)
            m = mask[row][:, None]
            dhc = dh + dy[di, row]
            dh_mid = m * dhc
            dc_pre = m * dc + dh_mid * og * (1.0 - tc * tc)
            da = torch.cat([dc_pre * gg * ig * (1.0 - ig),
                            dc_pre * c_prev * fg * (1.0 - fg),
                            dc_pre * ig * (1.0 - gg * gg),
                            dh_mid * tc * og * (1.0 - og)], 1)
            dgates[di, row] = da
            dh = (1.0 - m) * dhc + da.to(w.dtype).to(acc) @ w32.t()
            dc = dc_pre * fg + (1.0 - m) * dc
        dh0[di], dc0[di] = dh, dc  # the first step's dh_prev and dc_prev
    return (dgates, (dh0, dc0)) if return_dhc0 else dgates


def _bwd_launch(name, xp, mask, w, b, ys, cs, dy, reverse, hc0: _HC = None,
                dcfin: Optional[torch.Tensor] = None,
                return_dhc0: bool = False):
    """Allocate ``dgates`` (and ``(dh0, dc0)`` when ``return_dhc0``) and
    ``csrc/<name>.cu``'s scratch and launch it; returns ``(dgates, (dh0,
    dc0) or None, launched)``. ``lstm_bwd``'s tensor-core path
    (``gru._bwd_mma``) takes ``lstm_bwd_mma_scratch_floats`` (dh and dc,
    the two bf16 dgates rows), its CUDA-core kernel
    ``lstm_bwd_scratch_floats`` (the blocks' partial sums). The C entry
    takes ``h0``, ``c0``, ``dcfin``, ``dh0`` and ``dc0``, each NULL where
    absent: with all five NULL it is the call from zeros."""
    d, t, bsz, h = w.shape[0], xp.shape[0], xp.shape[1], w.shape[1]
    f32 = dict(dtype=torch.float32, device=xp.device)
    dgates = torch.empty((d, t, bsz, 4 * h), **f32)
    h0, c0 = hc0 if hc0 is not None else (None, None)
    dhc0 = None
    if return_dhc0:
        dhc0 = tuple(torch.empty((d, bsz, h), **f32) for _ in range(2))
        if not dgates.numel():
            # With no step to run, h0 reaches nothing the loss reads and
            # the gradient on the final c is c0's.
            dhc0[0].zero_()
            dhc0[1].copy_(dcfin if dcfin is not None else
                          torch.zeros_like(dhc0[1]))
    if not dgates.numel():
        return dgates, dhc0, False
    size = (f"{name}_mma_scratch_floats"
            if name == "lstm_bwd" and gru._bwd_mma(w, ys, h0)
            else f"{name}_scratch_floats")
    floats = getattr(gru._lib(name), size)(d, bsz, h)
    scratch = torch.empty((floats,), **f32)
    dh0, dc0 = dhc0 if dhc0 is not None else (None, None)
    gru._launch(name, xp, mask, w,
                (b, h0, c0, ys, cs, dy, dcfin, dgates, dh0, dc0, scratch),
                reverse)
    return dgates, dhc0, True


def _bwd_result(dgates, dhc0, return_dhc0: bool):
    return (dgates, dhc0) if return_dhc0 else dgates


def lstm_bwd(xp: torch.Tensor, mask: torch.Tensor, w: torch.Tensor,
             b: torch.Tensor, ys: torch.Tensor, cs: torch.Tensor,
             dy: torch.Tensor, reverse: Sequence[bool] = (False,), *,
             hc0: _HC = None, dcfin: Optional[torch.Tensor] = None,
             return_dhc0: bool = False):
    """LSTM backpropagation through time over D directions.

    ``xp``, ``mask``, ``w``, ``b``, ``hc0`` and ``reverse`` as
    ``lstm_fwd`` took them (``hc0 = (h0, c0)``, each ``[D,B,H]`` f32;
    None: zeros); ``ys`` and ``cs [D,T,B,H]`` f32, the outputs and the
    cell-state tape ``lstm_fwd(..., tape=True)`` returned; ``dy
    [D,T,B,H]`` f32, the gradient of the loss with respect to ``ys``;
    ``dcfin [D,B,H]`` f32 (None: zeros), that with respect to the cell
    state after each direction's last step. Each direction runs against
    its forward order, carrying dh and dc (from ``dcfin``); a step
    recomputes the gates from h_prev rounded to ``w.dtype`` (``h0`` at
    the forward's first step; c_prev from the tape, ``c0`` there) and
    adds ``round(dgates) @ W^T`` to dh in f32. Returns ``dgates
    [D,T,B,4H]`` f32, the gradient of the gate pre-activations
    ``(da_i, da_f, da_g, da_o)``: both that of the input projection and
    that of the recurrent gates ``h W + b``. The JAX kernels write these
    same values twice, as ``dxp`` and ``dgates`` (lstm_pallas.py:166-167,
    :211-212); the port writes them once. With ``return_dhc0`` it
    returns ``(dgates, (dh0, dc0))``, the gradients of ``h0`` and ``c0``:
    the first step's dh_prev, formed as every other step's, and its
    dc_prev. The gradient on the final h takes no argument: the carry
    after the last step is ``ys`` at the scan's last row (a masked frame
    holds h and c), so it arrives in ``dy`` there. Without ``hc0``,
    ``dcfin`` and ``return_dhc0`` the call is the BPTT from zeros, bit
    for bit.

    A CPU tensor runs ``lstm_bwd_plain``. A CUDA tensor calls the
    resident kernel's C entry point ``csrc/lstm_bwd.cu`` once (counted in
    ``lstm_bwd.launches``) where ``gru._bwd_resident`` says it can hold
    W, and ``lstm_bwd_stream`` otherwise; a refused launch raises. Where
    ``gru._bwd_mma`` holds (bf16, H % 8 == 0) that call is two launches,
    the gate pre-pass GEMM on the tensor cores and the serial
    ``mma.sync`` loop with each group's rows of W held in shared memory;
    f32 and other bf16 calls run the CUDA-core kernel.
    """
    reverse = tuple(bool(r) for r in reverse)
    gru._check_bwd(xp, mask, w, b, reverse, gates=4, ys=ys, cs=cs, dy=dy)
    _check_hc0(xp, w, hc0, dcfin)
    carry = dict(hc0=hc0, dcfin=dcfin, return_dhc0=return_dhc0)
    if xp.device.type == "cpu":
        return lstm_bwd_plain(xp, mask, w, b, ys, cs, dy, reverse, **carry)
    gru._require_cuda(xp, "lstm_bwd")
    h0 = None if hc0 is None else hc0[0]
    if not gru._bwd_resident(w, ys, gru.card_limits(xp.device),
                             "lstm_bwd", h0=h0):
        return lstm_bwd_stream(xp, mask, w, b, ys, cs, dy, reverse, **carry)
    dgates, dhc0, launched = _bwd_launch("lstm_bwd", xp, mask, w, b, ys, cs,
                                         dy, reverse, **carry)
    lstm_bwd.launches += launched
    return _bwd_result(dgates, dhc0, return_dhc0)


lstm_bwd.launches = 0


def lstm_bwd_stream(xp: torch.Tensor, mask: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor, ys: torch.Tensor, cs: torch.Tensor,
                    dy: torch.Tensor, reverse: Sequence[bool] = (False,), *,
                    hc0: _HC = None, dcfin: Optional[torch.Tensor] = None,
                    return_dhc0: bool = False):
    """``lstm_bwd`` through the streamed kernel ``csrc/lstm_bwd_stream.cu``
    (K15), whatever the sizes. In bf16 the gate recompute, which reads
    h_prev from the ``ys`` tape and not from the carried dh, runs first
    for every step at once as a tensor-core GEMM written into ``dgates``;
    then a serial kernel streams W's rows once a step to form
    ``round(dgates) @ W^T`` on the tensor cores, one grid barrier a step,
    and overwrites each step's gates with its ``dgates`` (see the
    source). f32 (and bf16 where H is not a multiple of 4) runs the
    two-phase CUDA-core kernel, a column and a row phase a step. The same
    contract and arithmetic as ``lstm_bwd``, carry included. A CPU
    tensor runs ``lstm_bwd_plain``; a CUDA tensor calls the kernel's C
    entry point once (counted in ``lstm_bwd_stream.launches``) or
    raises."""
    reverse = tuple(bool(r) for r in reverse)
    gru._check_bwd(xp, mask, w, b, reverse, gates=4, ys=ys, cs=cs, dy=dy)
    _check_hc0(xp, w, hc0, dcfin)
    carry = dict(hc0=hc0, dcfin=dcfin, return_dhc0=return_dhc0)
    if xp.device.type == "cpu":
        return lstm_bwd_plain(xp, mask, w, b, ys, cs, dy, reverse, **carry)
    gru._require_cuda(xp, "lstm_bwd_stream")
    dgates, dhc0, launched = _bwd_launch("lstm_bwd_stream", xp, mask, w, b,
                                         ys, cs, dy, reverse, **carry)
    lstm_bwd_stream.launches += launched
    return _bwd_result(dgates, dhc0, return_dhc0)


lstm_bwd_stream.launches = 0


def _last_rows(x: torch.Tensor, reverse: Tuple[bool, ...],
               first: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[D,B,H]``: each direction's row of ``x [D,T,B,H]`` at its scan's
    last step (t = 0 for a reverse direction); ``first`` (None: zeros)
    where there is no step."""
    if not x.shape[1]:
        return (first.clone() if first is not None
                else x.new_zeros((x.shape[0], *x.shape[2:])))
    return torch.stack([x[di, 0 if rev else -1]
                        for di, rev in enumerate(reverse)])


class LSTMFunction(torch.autograd.Function):
    """``lstm_fwd(..., tape=True)`` with ``lstm_bwd`` as its backward.

    ``apply(xp [T,B,4H], mask [T,B], w [D,H,4H] f32, b [D,4H] f32, h0,
    c0, reverse)`` -> ``(ys [D,T,B,H] f32, c [D,B,H] f32)``: the outputs
    and each direction's cell state after its last step (the tape's row
    there: a masked frame holds c). ``h0`` and ``c0`` (``[D,B,H]`` f32,
    both or neither; None: zeros) are the carried state the scan starts
    from, as in the sequence-parallel relay; their gradients are
    ``lstm_bwd``'s ``(dh0, dc0)``, and the gradient on ``c`` enters it
    as ``dcfin``. The final h needs no output of its own: it is ``ys``
    at the scan's last row. ``w`` is rounded to ``xp.dtype`` (the dot
    dtype) inside, so its gradient stays f32, as the JAX kernels cast
    the f32 weights inside. The backward returns ``dgates`` summed over
    directions as ``dxp`` (``xp.dtype``), ``dW = sum_t h_prev^T dgates``
    as one f32 product with TF32 off (``_lstm_bwd``'s HIGHEST einsum,
    lstm_pallas.py:501-502), dW's first row taking ``h0`` as its h_prev,
    and ``db = sum dgates``. Without a carry and with ``c`` unused, the
    backward makes the call it made before the carry, bit for bit.
    """

    @staticmethod
    def forward(ctx, xp, mask, w, b, h0, c0, reverse):
        if (h0 is None) != (c0 is None):
            raise ValueError("LSTMFunction: give both h0 and c0, or neither")
        reverse = tuple(bool(r) for r in reverse)
        wd = w.to(xp.dtype).contiguous()
        carry = {} if h0 is None else {"hc0": (h0, c0)}
        ys, cs = lstm_fwd(xp, mask, wd, b, reverse, tape=True, **carry)
        ctx.save_for_backward(xp, mask, wd, b, h0, c0, ys, cs)
        ctx.reverse = reverse
        # An unused output's gradient stays None: no dcfin, the old call.
        ctx.set_materialize_grads(False)
        return ys, _last_rows(cs, reverse, c0)

    @staticmethod
    def backward(ctx, dys, dc):
        xp, mask, wd, b, h0, c0, ys, cs = ctx.saved_tensors
        dys = (torch.zeros_like(ys) if dys is None
               else dys.to(ys.dtype).contiguous())
        dcfin = None if dc is None else dc.to(ys.dtype).contiguous()
        # Without a carry or a gradient on c, the call made before both.
        carry = {}
        if h0 is not None or dcfin is not None:
            carry = {"hc0": None if h0 is None else (h0, c0),
                     "dcfin": dcfin, "return_dhc0": h0 is not None}
        dgates = lstm_bwd(xp, mask, wd, b, ys, cs, dys, ctx.reverse, **carry)
        dh0 = dc0 = None
        if h0 is not None:
            dgates, (dh0, dc0) = dgates
        d, t, bsz, h = ys.shape
        hp = gru._h_prev(ys, ctx.reverse, h0).reshape(d, t * bsz, h)
        with full_f32_matmul():
            dw = torch.bmm(hp.transpose(1, 2),
                           dgates.reshape(d, t * bsz, 4 * h))
        db = dgates.sum((1, 2))
        return dgates.sum(0).to(xp.dtype), None, dw, db, dh0, dc0, None
