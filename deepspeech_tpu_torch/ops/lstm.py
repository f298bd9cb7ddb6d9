"""The LSTM forward recurrence: hand-written Hopper kernels and their
plain PyTorch versions, for inference.

Gates i, f, g, o (``deepspeech_tpu/ops/lstm_pallas.py``'s order and
arithmetic, ``_lstm_elementwise_fwd`` :41):
  gates = h_prev W + b           (h_prev rounded to the dot dtype, f32 sum)
  i = sigmoid(xp_i + gates_i)    f = sigmoid(xp_f + gates_f + 1)
  g = tanh(xp_g + gates_g)       o = sigmoid(xp_o + gates_o)
  c' = f c + i g                 h' = o tanh(c')
A masked frame holds both h and c. Each direction starts from h = c = 0
(the TPU kernels take no carried state); a reverse one runs t = T-1..0.

``lstm_fwd`` replaces ``_lstm_kernel`` (lstm_pallas.py:89, K12; W held
on chip, the cell-state tape ``cs`` written only when asked) with
``csrc/lstm_fwd.cu``: one cooperative launch for D directions (the JAX
model launches one kernel per direction, models/rnn.py:242-251; summed,
the two compute the same function), D x ceil(H/16) blocks each holding
the ``[H, 64]`` f32 column slice of W for 16 hidden units (gate columns
j, H+j, 2H+j, 3H+j) in shared memory, their cell state beside it, a
grid barrier per step. Where that does not fit (``gru.resident_fits(
"lstm_fwd", ...)``; ds2_full's H=1760), it launches ``lstm_fwd_stream``
(``csrc/lstm_fwd_stream.cu``, replacing ``_lstm_kernel_blocked``,
:116, K14), which stages W through shared memory from global memory
every step and keeps c in a scratch row that only its owning thread
touches.

``lstm_fwd_q`` is the forward with weight-only int8 recurrent weights
(``utils/quantize.py``'s layout: int8 ``Q [H,4H]``, an f32 scale per
output channel): ``(round(h) @ Q) * scale + b``. It launches
``csrc/lstm_fwd_q.cu`` (replacing ``_lstm_kernel_q``, :292, K16), the
slice held as int8 and widened 64 rows at a time beside the h_prev
chunk, or where that does not fit (ds2_full's H=1760: 220 blocks of one
an SM), or when the caller forces it, ``lstm_fwd_q_stream``
(``csrc/lstm_fwd_q_stream.cu``, replacing ``_lstm_kernel_blocked_q``,
:315, K17), K14 with s8 tiles. Neither int8 kernel writes a tape: the
TPU kernels have none.

What bounds them on the H100 is what bounds the GRU kernels
(``ops/gru.py``): T serial steps of a fixed latency, far above the FLOP
roofline (2*T*D*B*H*4H over the peak) and the byte roofline.

On a CPU tensor a wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises. There is no fallback between the two,
nor between the resident and the streamed kernel. Each kernel counts
its own launches. The backward kernels K13/K15 and LSTM training come
with the next slice of the port.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import torch

from . import gru

_Out = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


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
    ``tape`` (else None), the carries after the last step ``[D,B,H]``."""
    t, bsz, _ = xp.shape
    d = len(reverse)
    f32 = dict(dtype=torch.float32, device=xp.device)
    ys = torch.empty((d, t, bsz, h), **f32)
    cs = torch.empty((d, t, bsz, h), **f32) if tape else None
    hfin = torch.empty((d, bsz, h), **f32)
    cfin = torch.empty((d, bsz, h), **f32)
    for di in range(d):
        if hc0 is None:
            hc = torch.zeros((bsz, h), **f32)
            cc = torch.zeros((bsz, h), **f32)
        else:
            hc, cc = hc0[0][di].float(), hc0[1][di].float()
        for s in range(t):
            row = t - 1 - s if reverse[di] else s
            g = gates(di, hc)
            x = xp[row].float()
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


def _result(ys, cs, tape: bool) -> _Out:
    return (ys, cs) if tape else ys


def lstm_fwd_plain(xp: torch.Tensor, mask: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor, reverse: Sequence[bool] = (False,),
                   tape: bool = False) -> _Out:
    """The plain PyTorch version of ``lstm_fwd``: an eager time loop with
    the same arithmetic (h_prev rounded to ``w.dtype`` for the product,
    the product, c and h in f32)."""
    w32 = w.float()
    ys, cs, _, _ = lstm_plain_loop(
        xp, mask, reverse, w.shape[1],
        lambda di, hc: hc.to(w.dtype).float() @ w32[di] + b[di], tape=tape)
    return _result(ys, cs, tape)


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


def _c_scratch(xp, w) -> torch.Tensor:
    """The streamed kernels' cell state ``[D,B,H]`` f32: each entry is
    read and written by the one thread that owns its unit and row, and
    the kernel writes it before it reads it."""
    return torch.empty((w.shape[0], xp.shape[1], w.shape[1]),
                       dtype=torch.float32, device=xp.device)


def lstm_fwd(xp: torch.Tensor, mask: torch.Tensor, w: torch.Tensor,
             b: torch.Tensor, reverse: Sequence[bool] = (False,),
             tape: bool = False) -> _Out:
    """LSTM forward over D directions that share one input projection.

    ``xp [T,B,4H]`` (includes the input bias) and ``w [D,H,4H]`` in one
    dtype, bf16|f32, the dot dtype; ``mask [T,B]`` f32 (1 = valid),
    ``b [D,4H]`` f32 recurrent bias, ``reverse[d]`` True for a direction
    that runs t = T-1..0. Returns ``ys [D,T,B,H]`` f32 (a masked frame
    holds the previous h), and with ``tape`` also ``cs [D,T,B,H]`` f32,
    the cell state of every row (held on masked frames), which the BPTT
    of the next slice reads. The product rounds h_prev to ``w.dtype``
    and sums in f32; c and h stay f32.

    A CPU tensor runs ``lstm_fwd_plain``. A CUDA tensor launches the
    resident kernel ``csrc/lstm_fwd.cu`` (one launch, counted in
    ``lstm_fwd.launches``) where ``gru.resident_fits("lstm_fwd", ...)``
    says it can hold W, and ``lstm_fwd_stream`` otherwise; a refused
    launch raises.
    """
    reverse = tuple(bool(r) for r in reverse)
    gru._check(xp, mask, w, b, None, reverse, gates=4)
    if xp.device.type == "cpu":
        return lstm_fwd_plain(xp, mask, w, b, reverse, tape)
    gru._require_cuda(xp, "lstm_fwd")
    if not gru.resident_fits("lstm_fwd", w.shape[0], w.shape[1],
                             xp.shape[1], w.dtype,
                             *gru.card_limits(xp.device)):
        return lstm_fwd_stream(xp, mask, w, b, reverse, tape)
    ys, cs = _outputs(xp, w, tape)
    if ys.numel():
        gru._launch("lstm_fwd", xp, mask, w, (b, ys, cs), reverse)
        lstm_fwd.launches += 1
    return _result(ys, cs, tape)


lstm_fwd.launches = 0


def lstm_fwd_stream(xp: torch.Tensor, mask: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor, reverse: Sequence[bool] = (False,),
                    tape: bool = False) -> _Out:
    """``lstm_fwd`` through the streamed kernel ``csrc/lstm_fwd_stream.cu``
    (K14), whatever the sizes: W stays in global memory and crosses L2
    once a step. The same contract and arithmetic as ``lstm_fwd``. A CPU
    tensor runs ``lstm_fwd_plain``; a CUDA tensor launches the kernel
    (one launch, counted in ``lstm_fwd_stream.launches``) or raises."""
    reverse = tuple(bool(r) for r in reverse)
    gru._check(xp, mask, w, b, None, reverse, gates=4)
    if xp.device.type == "cpu":
        return lstm_fwd_plain(xp, mask, w, b, reverse, tape)
    gru._require_cuda(xp, "lstm_fwd_stream")
    ys, cs = _outputs(xp, w, tape)
    if ys.numel():
        gru._launch("lstm_fwd_stream", xp, mask, w,
                    (b, ys, cs, _c_scratch(xp, w)), reverse)
        lstm_fwd_stream.launches += 1
    return _result(ys, cs, tape)


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

    A CPU tensor runs ``lstm_fwd_q_plain``. A CUDA tensor launches the
    resident kernel ``csrc/lstm_fwd_q.cu`` (one launch, counted in
    ``lstm_fwd_q.launches``) where ``gru.resident_fits("lstm_fwd_q",
    ...)`` holds on this card, and ``lstm_fwd_q_stream`` otherwise.
    ``blocked`` forces the choice, as ``lstm_scan_pallas_q``'s does
    (lstm_pallas.py:350): True the streamed kernel, False the resident
    one, which raises where it does not fit (judged on an H100's limits
    for a CPU tensor). A refused launch raises.
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
            f"int8 slices do not fit the card's shared memory and SMs")
    if xp.device.type == "cpu":
        return lstm_fwd_q_plain(xp, mask, wq, scale, b, reverse)
    if (not fits) if blocked is None else blocked:
        return lstm_fwd_q_stream(xp, mask, wq, scale, b, reverse)
    ys, _ = _outputs(xp, wq, False)
    if ys.numel():
        gru._launch("lstm_fwd_q", xp, mask, wq, (scale, b, ys), reverse)
        lstm_fwd_q.launches += 1
    return ys


lstm_fwd_q.launches = 0


def lstm_fwd_q_stream(xp: torch.Tensor, mask: torch.Tensor,
                      wq: torch.Tensor, scale: torch.Tensor, b: torch.Tensor,
                      reverse: Sequence[bool] = (False,)) -> torch.Tensor:
    """``lstm_fwd_q`` through the streamed kernel
    ``csrc/lstm_fwd_q_stream.cu`` (K17), whatever the sizes: Q stays in
    global memory and crosses L2 as int8 once a step. The same contract
    and arithmetic as ``lstm_fwd_q``. A CPU tensor runs
    ``lstm_fwd_q_plain``; a CUDA tensor launches the kernel (one launch,
    counted in ``lstm_fwd_q_stream.launches``) or raises."""
    reverse = tuple(bool(r) for r in reverse)
    gru._check(xp, mask, wq, b, None, reverse, scale, gates=4)
    if xp.device.type == "cpu":
        return lstm_fwd_q_plain(xp, mask, wq, scale, b, reverse)
    gru._require_cuda(xp, "lstm_fwd_q_stream")
    ys, _ = _outputs(xp, wq, False)
    if ys.numel():
        gru._launch("lstm_fwd_q_stream", xp, mask, wq,
                    (scale, b, ys, _c_scratch(xp, wq)), reverse)
        lstm_fwd_q_stream.launches += 1
    return ys


lstm_fwd_q_stream.launches = 0
