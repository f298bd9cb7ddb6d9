"""Tier-aware rung-ladder sizing: device-memory headroom -> batch height.

The port's copy of ``deepspeech_tpu/serving/ladder.py``. A replica's
tallest B rung is bounded by what it holds on the device: the parameter
tree (constant per replica) plus per-row activation and state buffers
(linear in B). Weight-only int8 PTQ (``utils/quantize.py``) shrinks the
parameter term, and every byte it frees is budget for more rows.
``max_batch_for_budget`` and ``tier_max_batches`` are the JAX
package's, verbatim.

``recurrent_stream_bytes`` prices the recurrent weights a forward
streams every step: 0 where a resident kernel holds them, the matrix at
its stored width where the streamed kernel re-reads it, for the GRU
(3 gates) and the LSTM (4). The port decides residency by the Hopper
rule (``ops/gru.py`` ``resident_fits``: the grid's shared memory and
SMs, which depend on the directions D), not by the TPU's 10 MB VMEM
budget, so the two answers differ at some sizes: int8 GRU at H=1888,
D=2 is resident here and streams on the TPU; bf16 at H=1280 streams
here and is resident on the TPU.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from ..ops import gru

_FP_DTYPES = {2: torch.bfloat16, 4: torch.float32}
# The resident kernels' kinds in ops/gru.py's rule, by gate count: the
# GRU's (csrc/gru_fwd.cu, csrc/gru_fwd_q.cu) and the LSTM's
# (csrc/lstm_fwd.cu, csrc/lstm_fwd_q.cu), fp and int8.
_KINDS = {3: ("fwd", "fwd_q"), 4: ("lstm_fwd", "lstm_fwd_q")}


def max_batch_for_budget(param_bytes: int, per_row_bytes: int,
                         budget_bytes: int, *,
                         ceiling: int = 1024) -> int:
    """Tallest power-of-two ``B <= ceiling`` with
    ``param_bytes + B * per_row_bytes <= budget_bytes``; 0 when even
    a single row does not fit (the tier cannot be hosted at all)."""
    if param_bytes < 0 or per_row_bytes <= 0 or ceiling < 1:
        raise ValueError("need param_bytes >= 0, per_row_bytes > 0, "
                         "ceiling >= 1")
    if param_bytes + per_row_bytes > budget_bytes:
        return 0
    b = 1
    while (b * 2 <= ceiling
           and param_bytes + 2 * b * per_row_bytes <= budget_bytes):
        b *= 2
    return b


def recurrent_stream_bytes(hidden: int, n_gates: int, weight_bytes: int,
                           *, layers: int = 1, directions: int = 1,
                           card: Tuple[int, ...] = ()) -> int:
    """Per-timestep recurrent weight-stream bytes for one forward.

    0 where the resident kernel holds the matrices of ``directions``
    directions on a card with ``card``'s (sms, smem_per_block,
    smem_per_sm), an H100's by default: ``csrc/gru_fwd_q.cu`` (GRU,
    ``n_gates`` 3) or ``csrc/lstm_fwd_q.cu`` (LSTM, 4) for the int8
    weights (``weight_bytes`` 1), ``csrc/gru_fwd.cu`` or
    ``csrc/lstm_fwd.cu`` for bf16 (2) or f32 (4), judged at one batch
    row. Else the full matrices at their stored width, which the
    streamed kernels re-read every step: ``n_gates * H^2 *
    weight_bytes * layers * directions``.
    """
    if hidden < 1 or n_gates < 1 or weight_bytes < 1:
        raise ValueError("need hidden, n_gates, weight_bytes >= 1")
    if n_gates not in _KINDS:
        raise ValueError(f"n_gates must be 3 (GRU) or 4 (LSTM), not "
                         f"{n_gates}")
    fp_kind, q_kind = _KINDS[n_gates]
    if weight_bytes == 1:
        kind, dtype = q_kind, torch.float32
    elif weight_bytes in _FP_DTYPES:
        kind, dtype = fp_kind, _FP_DTYPES[weight_bytes]
    else:
        raise ValueError(f"weight_bytes must be 1, 2 or 4, not "
                         f"{weight_bytes}")
    if gru.resident_fits(kind, directions, hidden, 1, dtype, *card):
        return 0
    return n_gates * hidden * hidden * weight_bytes * layers * directions


def tier_max_batches(report: Mapping[str, int], per_row_bytes: int,
                     budget_bytes: int, *, ceiling: int = 1024,
                     premium: str = "premium",
                     bulk: str = "bulk",
                     stream_bytes: Optional[Mapping[str, int]] = None,
                     ) -> Dict[str, int]:
    """Per-tier ladder heights from a PTQ report's measured footprints.

    ``report`` is ``quantize_params``'s report dict: ``bytes_before``
    is the full-precision parameter footprint (the premium/bf16
    tier), ``bytes_after`` the quantized one (the bulk/int8 tier).
    ``stream_bytes`` optionally maps tier -> per-replica streamed-
    working-bytes reservation (:func:`recurrent_stream_bytes`), a
    B-independent term charged alongside the parameter footprint.
    Returns ``{premium: B, bulk: B}``; a tier that does not fit at all
    maps to 0 (caller decides whether to host it).
    """
    stream = stream_bytes or {}
    return {
        premium: max_batch_for_budget(
            int(report["bytes_before"]) + int(stream.get(premium, 0)),
            per_row_bytes, budget_bytes, ceiling=ceiling),
        bulk: max_batch_for_budget(
            int(report["bytes_after"]) + int(stream.get(bulk, 0)),
            per_row_bytes, budget_bytes, ceiling=ceiling),
    }
